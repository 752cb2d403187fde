// K4: fused identity bottleneck block of the serving fast path.
//
// Replaces uemda_tpu/ops/pallas_resblock.py:bottleneck_identity_pallas
// (_kernel): relu(conv1x1) -> relu(conv3x3, dilated, SAME) -> conv1x1 + bias
// + identity -> relu, BN folded, one launch. Every conv accumulates in f32,
// its sum is rounded to the storage type before the bias (itself rounded
// to that type) is added, and that sum is rounded again -- the epilogue of
// infer/fastpath._conv (pallas_resblock.py:100-104,151,155-161). The
// residual add is relu(round(y3 + b3) + x) in the storage type.
//
// Bound on the H100: bytes at layers 1-2 (one read of x and the weights,
// one write of the output, at 3.35 TB/s), operations at layers 3-4 (2 x
// MACs at 989 TFLOP/s bf16). This first kernel reaches neither: every warp
// reads its weight fragments straight from L2 (L1 catches what the warps
// of a block share) and runs mma.sync, not wgmma/TMA; a block-wide
// cp.async staging of weight chunks, two stages deep, measured slower
// (PERF.md, K4 findings).
//
// Design: one block computes an output tile of TH x TW pixels of one sample
// for all channels (the tile is picked at launch so that it fits shared
// memory at the block's width and still gives the card enough blocks; where
// the grid outnumbers the SMs and two blocks fit an SM, a variant capped at
// 128 registers runs two a SM).
// conv1 runs over the haloed tile ((TH + 2 dil) x (TW + 2 dil) pixels),
// streaming Cin from global memory 16 channels at a time into f32
// accumulators; its rounded, biased, ReLU'd result y1 goes to shared
// memory, 0 at pixels outside the image (the 3x3's zero padding applies
// after conv1, pallas_resblock.py:106-114). conv2 is nine taps read from y1
// in shared memory; its result y2 goes to shared memory. conv3 runs by
// 64-channel chunks of the output; its epilogue reads the identity from
// global memory and writes the output, which is a separate tensor (x is
// never overwritten). Each warp computes 32 x 64 sub-tiles of a conv, rows
// first, so that the warps of a block read the same weight columns at about
// the same time: bf16 through mma.sync m16n8k16 (bf16 in, f32 accumulate)
// with 8-byte fragment loads; f32 with FMAs on the CUDA cores (no TF32).
//
// Layout: x and out (B, H, W, Cin) NHWC in memory; w1 (Cmid, Cin), w2
// (Cmid, 3, 3, Cmid) and w3 (Cin, Cmid) -- the OIHW weights in
// channels_last memory, i.e. each output channel's input channels
// contiguous, which is mma's "col" B operand; biases f32. Cin and Cmid are
// multiples of 16.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int MT = 2;            // 16-row m-tiles in a warp's sub-tile
constexpr int NT = 8;            // 8-column n-tiles in a warp's sub-tile
constexpr int SUB_M = 16 * MT;
constexpr int SUB_N = 8 * NT;

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared rows padded by 32 bytes (bf16: the 8-byte fragment loads of a
// half-warp, four rows of 32 bytes, fall in distinct banks) or 16 bytes
// (f32: the scalar loads of eight rows do).
template <typename T> __host__ __device__ constexpr int row_ld(int cmid) {
  return cmid + (sizeof(T) == 2 ? 16 : 4);
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// One k-step of 16 of a warp's sub-tile: acc[mt][nt] += A @ B over it.
// ar[mt][h] points at the step's first element of the A row g (h = 0) or
// g + 8 (h = 1) of m-tile mt, or is null for a row of zeros. bt points at
// the step's first element of row 0 of B^T (N x ldb); n0 is the sub-tile's
// first column, N the number of columns. C fragment: acc[mt][nt][2h + e] is
// row mt*16 + h*8 + g, column n0 + nt*8 + 2t + e.
template <typename T> struct Core;

// bf16: the k-step's 16 products are summed in a permuted order, the same
// for A and B: the fragment slots of k = (2t, 2t+1, 2t+8, 2t+9) hold
// k = 4t .. 4t+3, so each lane reads 8 contiguous bytes of a row and four
// lanes a whole 32-byte sector.
template <> struct Core<__nv_bfloat16> {
  static __device__ __forceinline__ void step(
      float (&acc)[MT][NT][4], const __nv_bfloat16* (&ar)[MT][2],
      const __nv_bfloat16* bt, int ldb, int n0, int N, int lane) {
    const int g = lane >> 2, t = lane & 3;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat16* p = ar[mt][h];
        const uint2 v = p ? *reinterpret_cast<const uint2*>(p + 4 * t)
                          : make_uint2(0u, 0u);
        a[mt][h] = v.x;
        a[mt][2 + h] = v.y;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (n0 + nt * 8 < N) {
        const __nv_bfloat16* bp =
            bt + static_cast<size_t>(n0 + nt * 8 + g) * ldb + 4 * t;
        const uint2 bv = __ldg(reinterpret_cast<const uint2*>(bp));
        const uint32_t b0 = bv.x, b1 = bv.y;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* c = acc[mt][nt];
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
                "r"(b0), "r"(b1));
        }
      }
    }
  }
};

template <> struct Core<float> {
  static __device__ __forceinline__ void step(
      float (&acc)[MT][NT][4], const float* (&ar)[MT][2],
      const float* bt, int ldb, int n0, int N, int lane) {
    const int t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (n0 + nt * 8 < N) {
        const float* b0p = bt + static_cast<size_t>(n0 + nt * 8 + 2 * t) * ldb;
        const float* b1p = b0p + ldb;
#pragma unroll 4
        for (int k = 0; k < 16; ++k) {
          const float bv0 = __ldg(b0p + k), bv1 = __ldg(b1p + k);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float av = ar[mt][h] ? ar[mt][h][k] : 0.f;
              acc[mt][nt][2 * h] = fmaf(av, bv0, acc[mt][nt][2 * h]);
              acc[mt][nt][2 * h + 1] = fmaf(av, bv1, acc[mt][nt][2 * h + 1]);
            }
          }
        }
      }
    }
  }
};

__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// A k-loop over one run of K: ar at the run's first element, B^T rows of
// ldb elements at bt, K a multiple of 16.
template <typename T>
__device__ __forceinline__ void k_loop(float (&acc)[MT][NT][4],
                                       const T* (&ar)[MT][2], const T* bt,
                                       int ldb, int K, int n0, int N, int lane) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    const T* ak[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) ak[mt][h] = ar[mt][h] ? ar[mt][h] + k0 : nullptr;
    Core<T>::step(acc, ak, bt + k0, ldb, n0, N, lane);
  }
}

// MINB 2 caps the registers so that two blocks share an SM; launched only
// where the grid has more blocks than the card has SMs (layer1 widths).
template <typename T, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const float* __restrict__ b2, const T* __restrict__ w3,
                  const float* __restrict__ b3, T* __restrict__ out, int H,
                  int W, int Cin, int Cmid, int dil, int TH, int TW) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = row_ld<T>(Cmid);
  const int PW = TW + 2 * dil;
  const int P1 = (TH + 2 * dil) * PW;  // haloed tile pixels
  const int P2 = TH * TW;              // output tile pixels
  T* y1 = reinterpret_cast<T*>(smem_raw);
  T* y2 = y1 + static_cast<size_t>(round_up(P1, 16)) * LD;

  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* xb = x + static_cast<size_t>(b) * H * W * Cin;
  T* ob = out + static_cast<size_t>(b) * H * W * Cin;
  float acc[MT][NT][4];

  // conv1 (1x1) over the haloed tile -> y1
  {
    const int nsm = (P1 + SUB_M - 1) / SUB_M;
    const int n_sub = nsm * ((Cmid + SUB_N - 1) / SUB_N);
    for (int s = warp; s < n_sub; s += kWarps) {
      const int m0 = s % nsm * SUB_M, n0 = s / nsm * SUB_N;
      const T* ar[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + h * 8 + g;
          const T* p = nullptr;
          if (m < P1) {
            const int r = r0 - dil + m / PW, c = c0 - dil + m % PW;
            if (r >= 0 && r < H && c >= 0 && c < W)
              p = xb + (static_cast<size_t>(r) * W + c) * Cin;
          }
          ar[mt][h] = p;
        }
      zero(acc);
      k_loop<T>(acc, ar, w1, Cin, Cin, n0, Cmid, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + h * 8 + g;
          if (m >= P1) continue;
          const bool inside = ar[mt][h] != nullptr;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = n0 + nt * 8 + 2 * t;
            if (n >= Cmid) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = round_to<T>(round_to<T>(acc[mt][nt][2 * h + e]) +
                                          round_to<T>(b1[n + e]));
              y1[m * LD + n + e] = from_f32<T>(inside ? relu(v) : 0.f);
            }
          }
        }
    }
  }
  __syncthreads();

  // conv2 (3x3, dilation dil) from y1 -> y2
  {
    const int nsm = (P2 + SUB_M - 1) / SUB_M;
    const int n_sub = nsm * ((Cmid + SUB_N - 1) / SUB_N);
    for (int s = warp; s < n_sub; s += kWarps) {
      const int m0 = s % nsm * SUB_M, n0 = s / nsm * SUB_N;
      int base[MT][2];  // y1 row of tap (0, 0), or -1 past the tile
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + h * 8 + g;
          base[mt][h] = m < P2 ? (m / TW) * PW + m % TW : -1;
        }
      zero(acc);
      for (int ky = 0; ky < 3; ++ky)
        for (int kx = 0; kx < 3; ++kx) {
          const int off = ky * dil * PW + kx * dil;
          const T* ar[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              ar[mt][h] = base[mt][h] >= 0
                              ? y1 + static_cast<size_t>(base[mt][h] + off) * LD
                              : nullptr;
          k_loop<T>(acc, ar, w2 + (ky * 3 + kx) * Cmid, 9 * Cmid, Cmid, n0,
                    Cmid, lane);
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + h * 8 + g;
          if (m >= P2) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = n0 + nt * 8 + 2 * t;
            if (n >= Cmid) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = round_to<T>(round_to<T>(acc[mt][nt][2 * h + e]) +
                                          round_to<T>(b2[n + e]));
              y2[m * LD + n + e] = from_f32<T>(relu(v));
            }
          }
        }
    }
  }
  __syncthreads();

  // conv3 (1x1) from y2, + bias, + identity, relu -> out
  {
    const int nsm = (P2 + SUB_M - 1) / SUB_M;
    const int n_sub = nsm * ((Cin + SUB_N - 1) / SUB_N);
    for (int s = warp; s < n_sub; s += kWarps) {
      const int m0 = s % nsm * SUB_M, n0 = s / nsm * SUB_N;
      const T* ar[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + h * 8 + g;
          ar[mt][h] = m < P2 ? y2 + static_cast<size_t>(m) * LD : nullptr;
        }
      zero(acc);
      k_loop<T>(acc, ar, w3, Cmid, Cmid, n0, Cin, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + h * 8 + g;
          if (m >= P2) continue;
          const int r = r0 + m / TW, c = c0 + m % TW;
          if (r >= H || c >= W) continue;
          const size_t pix = (static_cast<size_t>(r) * W + c) * Cin;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = n0 + nt * 8 + 2 * t;
            if (n >= Cin) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float y = round_to<T>(round_to<T>(acc[mt][nt][2 * h + e]) +
                                          round_to<T>(b3[n + e]));
              const float o = round_to<T>(y + to_f32(xb[pix + n + e]));
              ob[pix + n + e] = from_f32<T>(relu(o));
            }
          }
        }
    }
  }
}

template <typename T>
size_t smem_bytes(int cmid, int dil, int th, int tw) {
  const int p1 = (th + 2 * dil) * (tw + 2 * dil);
  return static_cast<size_t>(round_up(p1, 16) + round_up(th * tw, 16)) *
         row_ld<T>(cmid) * sizeof(T);
}

// Output tiles, largest first. The first that fits shared memory and gives
// at least half as many blocks as the card has SMs is taken; below 4 x 4
// only when nothing larger fits.
constexpr int kTiles[][2] = {{16, 16}, {8, 16}, {8, 8}, {4, 8}, {4, 4},
                             {2, 4},   {2, 2},  {1, 2}, {1, 1}};

template <typename T>
cudaError_t launch(const void* x, const void* w1, const float* b1,
                   const void* w2, const float* b2, const void* w3,
                   const float* b3, void* out, int B, int H, int W, int Cin,
                   int Cmid, int dil, cudaStream_t stream, int* tile) {
  int dev = 0, max_smem = 0, sm_smem = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sm_smem,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int th = 0, tw = 0;
  for (const auto& c : kTiles) {
    if (smem_bytes<T>(Cmid, dil, c[0], c[1]) > static_cast<size_t>(max_smem))
      continue;
    if (th && c[0] * c[1] < 16) break;
    th = c[0];
    tw = c[1];
    const long blocks =
        static_cast<long>(B) * ((H + th - 1) / th) * ((W + tw - 1) / tw);
    if (blocks >= n_sm / 2) break;
  }
  if (!th) return cudaErrorInvalidValue;  // no tile fits shared memory
  if (tile) {
    tile[0] = th;
    tile[1] = tw;
  }
  const size_t smem = smem_bytes<T>(Cmid, dil, th, tw);
  const long blocks =
      static_cast<long>(B) * ((H + th - 1) / th) * ((W + tw - 1) / tw);
  auto k = bottleneck_kernel<T, 1>;
  if constexpr (sizeof(T) == 2) {  // the f32 variant would spill under the cap
    if (blocks > n_sm && 2 * (smem + 1024) <= static_cast<size_t>(sm_smem))
      k = bottleneck_kernel<T, 2>;
  }
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  k<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<const T*>(w3), b3,
      static_cast<T*>(out), H, W, Cin, Cmid, dil, th, tw);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, H, W, Cin); w1 (Cmid, Cin), w2 (Cmid, 3, 3, Cmid), w3 (Cin,
// Cmid) in x's type; b1, b2 (Cmid,) and b3 (Cin,) f32. tile (host, may be
// null) receives the output tile (TH, TW) the launch used.
extern "C" int uemda_bottleneck_identity(const void* x, const void* w1,
                                         const void* b1, const void* w2,
                                         const void* b2, const void* w3,
                                         const void* b3, void* out, int B,
                                         int H, int W, int Cin, int Cmid,
                                         int dil, int is_bf16, void* stream,
                                         int* tile) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cmid <= 0 || Cin % 16 ||
      Cmid % 16 || dil < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* fb3 = static_cast<const float*>(b3);
  return is_bf16
             ? launch<__nv_bfloat16>(x, w1, fb1, w2, fb2, w3, fb3, out, B, H,
                                     W, Cin, Cmid, dil, s, tile)
             : launch<float>(x, w1, fb1, w2, fb2, w3, fb3, out, B, H, W, Cin,
                             Cmid, dil, s, tile);
}
