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
// MACs at 989 TFLOP/s bf16). What holds this kernel back is the stream of
// operands through each block's ring, not the tensor cores: every block
// reads all three weights (0.14 / 0.56 / 2.2 / 8.9 MB at layers 1-4) and,
// at layer4, x's haloed chunks four times (11 MB a block, 64 output
// pixels, since y1 of a larger tile does not fit). With the products
// switched off the kernel keeps ~90% of its time; at batch 1 (16 blocks) a
// block takes ~85% of its time at batch 8, so the limit is each SM's TMA
// stream, not L2 bandwidth, and the epilogues, which stall the ring while
// they run (about a quarter of layer4's time).
//
// bf16 design (tensor cores, Hopper). One block computes an output tile of
// TH x TW pixels of one sample for all channels, in three phases: conv1
// over the haloed tile ((TH + 2 dil) x (TW + 2 dil) pixels, P1) into y1,
// conv2 (nine taps of y1) into y2, conv3 from y2 plus the identity into
// the output. y1 and y2 live in shared memory; only the output is written.
// - Products: wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate) by two
//   consumer warpgroups, each taking NW columns of every m-tile of a pass.
//   conv1 and conv3 read A from shared memory through descriptors (x's
//   haloed chunk as TMA lands it, y2 as the conv2 epilogue writes it);
//   conv2 gathers A from y1 with ldmatrix (each output pixel's tap is
//   another y1 row) and feeds it from registers, double-buffered.
// - Weight ring: a producer warpgroup (one thread issues; setmaxnreg hands
//   its registers to the consumers) streams every operand that comes from
//   global memory -- conv1's x chunk with its w1 chunk, then the w2 and w3
//   chunks -- through a ring of 2-4 stages of shared memory with TMA
//   (cp.async.bulk.tensor, tensor maps built on the host per launch), each
//   stage behind a full and an empty mbarrier (expect-tx / one arrive per
//   consumer warp once its wgmma group retired). A consumer keeps one group
//   in flight (wgmma.wait_group 1), so two stages are busy and the rest
//   load ahead; the producer runs on across phase boundaries, so conv2's
//   first weights land while conv1's epilogue runs. TMA zero-fills every
//   box past the image or past C / Cm, which gives the 3x3's zero padding
//   of x for free (y1 itself is written 0 at halo pixels outside the image,
//   pallas_resblock.py:106-114) and makes any multiple of 16 a valid width.
// - Layout: every shared operand is K-major in KC-wide chunks with the
//   swizzle wgmma and TMA share (KC 64: 128-byte rows, 128-byte swizzle;
//   KC 16: 32-byte rows, 32-byte swizzle), so no row padding is needed.
// - Epilogues: conv1 and conv2 round, bias and ReLU their accumulators into
//   y1 / y2 in that layout; conv3's exchanges pairs within each quad of
//   lanes so that x is read and the output written 16 bytes at a time.
// - Configurations (ops/resblock.py WGMMA_CONFIGS, chosen by Cm): conv2
//   covers Cm in one pass wherever Cm <= 512, so y2 overlays y1. Layers 1-2
//   take 8 x 16 tiles, layer3 8 x 8, all KC 64 with rings of 3-4. Layer4
//   (Cm 512, 8 x 8 tile at dilation 2): y1 is 144 px x 512 x 2 B = 144 KB,
//   which leaves ~80 KB; a 64-wide chunk of 512 weight rows is 64 KB, so
//   layer4 takes KC 16 and a ring of four 16 KB stages (two of them loading
//   while two are busy), measured faster than two 32 KB stages.
// - Clusters, built and measured on the card, not kept: two blocks with
//   TMA multicast of the weights (half the L2 traffic) were slower, a
//   stage being free only once both released it; two blocks sharing an
//   8 x 16 tile at layer4, each holding half of Cm and reading the peer's
//   half of y1 / y2 through distributed shared memory (half the weight
//   bytes a pixel), were within a few percent of one block alone. Both
//   cut L2 traffic, which is not the limit (above), so every launch is
//   one block a tile with no cluster.
// - Each phase keeps its own accumulator array: one array shared by the
//   phases' different wgmma widths made ptxas serialize the wgmmas.
//
// f32 design (CUDA cores, no TF32, so the 1e-5 gates hold): one block of
// 256 threads per output tile; conv1 streams Cin from global memory 16
// channels at a time into f32 accumulators, y1 and y2 in shared memory in
// rows padded by 4 elements, each warp 32 x 64 sub-tiles of FMAs.
//
// Layout: x and out (B, H, W, Cin) NHWC in memory; w1 (Cmid, Cin), w2
// (Cmid, 3, 3, Cmid) and w3 (Cin, Cmid) -- the OIHW weights in
// channels_last memory, i.e. each output channel's input channels
// contiguous (K-major B); biases f32. Cin and Cmid are multiples of 16.
// The launch plan (tile, configuration, ring depth and the shared-memory
// layout: y2's offset, the ring's offset and stage size) comes from
// ops/resblock.py: bottleneck_plan, the layout's one owner; the launcher
// checks its bounds.

#include <cuda.h>
#include <dlfcn.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return cdiv(v, m) * m;
}
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// f(std::integral_constant<int, i>) for i = I .. N-1: a loop whose index
// is a compile-time constant (an accumulator offset of a wgmma).
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// ===================== f32: CUDA cores =====================================

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int MT = 2;            // 16-row m-tiles in a warp's sub-tile
constexpr int NT = 8;            // 8-column n-tiles in a warp's sub-tile
constexpr int SUB_M = 16 * MT;
constexpr int SUB_N = 8 * NT;

__host__ __device__ constexpr int row_ld(int cmid) { return cmid + 4; }

// One k-step of 16 of a warp's 32 x 64 sub-tile: acc[mt][nt][2h + e] is row
// mt*16 + h*8 + g, column n0 + nt*8 + 2t + e. ar[mt][h] points at the
// step's first element of row g (h = 0) or g + 8 (h = 1), or is null for a
// row of zeros; bt at row 0 of B^T (N x ldb).
__device__ __forceinline__ void fma_step(float (&acc)[MT][NT][4],
                                         const float* (&ar)[MT][2],
                                         const float* bt, int ldb, int n0,
                                         int N, int lane) {
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
__device__ __forceinline__ void k_loop(float (&acc)[MT][NT][4],
                                       const float* (&ar)[MT][2],
                                       const float* bt, int ldb, int K,
                                       int n0, int N, int lane) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    const float* ak[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) ak[mt][h] = ar[mt][h] ? ar[mt][h] + k0 : nullptr;
    fma_step(acc, ak, bt + k0, ldb, n0, N, lane);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bottleneck_fma(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ w3,
               const float* __restrict__ b3, float* __restrict__ out, int H,
               int W, int Cin, int Cmid, int dil, int TH, int TW,
               int y2_off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = row_ld(Cmid);
  const int PW = TW + 2 * dil;
  const int P1 = (TH + 2 * dil) * PW;  // haloed tile pixels
  const int P2 = TH * TW;              // output tile pixels
  float* y1 = reinterpret_cast<float*>(smem_raw);
  float* y2 = reinterpret_cast<float*>(smem_raw + y2_off);

  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* xb = x + static_cast<size_t>(b) * H * W * Cin;
  float* ob = out + static_cast<size_t>(b) * H * W * Cin;
  float acc[MT][NT][4];

  // conv1 (1x1) over the haloed tile -> y1
  {
    const int nsm = (P1 + SUB_M - 1) / SUB_M;
    const int n_sub = nsm * ((Cmid + SUB_N - 1) / SUB_N);
    for (int s = warp; s < n_sub; s += kWarps) {
      const int m0 = s % nsm * SUB_M, n0 = s / nsm * SUB_N;
      const float* ar[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + h * 8 + g;
          const float* p = nullptr;
          if (m < P1) {
            const int r = r0 - dil + m / PW, c = c0 - dil + m % PW;
            if (r >= 0 && r < H && c >= 0 && c < W)
              p = xb + (static_cast<size_t>(r) * W + c) * Cin;
          }
          ar[mt][h] = p;
        }
      zero(acc);
      k_loop(acc, ar, w1, Cin, Cin, n0, Cmid, lane);
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
              const float v = acc[mt][nt][2 * h + e] + b1[n + e];
              y1[m * LD + n + e] = inside ? relu(v) : 0.f;
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
          const float* ar[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              ar[mt][h] = base[mt][h] >= 0
                              ? y1 + static_cast<size_t>(base[mt][h] + off) * LD
                              : nullptr;
          k_loop(acc, ar, w2 + (ky * 3 + kx) * Cmid, 9 * Cmid, Cmid, n0,
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
            for (int e = 0; e < 2; ++e)
              y2[m * LD + n + e] = relu(acc[mt][nt][2 * h + e] + b2[n + e]);
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
      const float* ar[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + h * 8 + g;
          ar[mt][h] = m < P2 ? y2 + static_cast<size_t>(m) * LD : nullptr;
        }
      zero(acc);
      k_loop(acc, ar, w3, Cmid, Cmid, n0, Cin, lane);
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
              const float y = acc[mt][nt][2 * h + e] + b3[n + e];
              ob[pix + n + e] = relu(y + xb[pix + n + e]);
            }
          }
        }
    }
  }
}

// ===================== bf16: wgmma + TMA weight ring =======================

constexpr int kConsumers = 256;                 // two consumer warpgroups
constexpr int kThreadsW = kConsumers + 128;     // + the producer warpgroup

// The configurations of ops/resblock.py WGMMA_CONFIGS, in its order:
// (KC, MT1, NW1, MT2, NW2, NW3).
constexpr int kConfigs[][6] = {{64, 3, 32, 2, 32, 128},
                               {64, 3, 64, 2, 64, 128},
                               {64, 2, 128, 1, 128, 128},
                               {16, 3, 64, 1, 256, 256}};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

struct WParams {
  const __nv_bfloat16* x;
  const float *b1, *b2, *b3;
  __nv_bfloat16* out;
  int H, W, C, Cm, dil, TH, TW, stages;
  int y2_off, region, stage;  // the plan's layout (y2_off 0: y2 on y1)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Spins on the phase; traps after ~2^26 polls (seconds) so that a ring
// that can no longer advance ends the launch with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// No memory clobber: the epilogue's global loads may move across it; the
// named barriers and the volatile ldmatrix / wgmma keep it ordered with the
// reads of y1 and y2.
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The K-major operand layout of a KC-wide chunk: row r at r * 2 KC bytes,
// its 16-byte pieces XOR-ed with the row's place in the swizzle atom (the
// pattern TMA writes with SWIZZLE_128B / SWIZZLE_64B and wgmma reads).
template <int KC>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  constexpr uint32_t m = KC / 8 - 1;
  return off ^ (((off >> 7) & m) << 4);
}

// wgmma descriptor of a K-major swizzled tile at shared address a: 8-row
// groups 8 * 2 KC bytes apart (SBO), layout 1 (128-byte swizzle) or 2 (64).
template <int KC>
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  constexpr uint64_t layout = KC == 64 ? 1 : KC == 32 ? 2 : 3;
  constexpr uint64_t sbo = (8 * 2 * KC) >> 4;
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (sbo << 32) | (layout << 62);
}

// The ring: stage s at ring + s * stage; full[s] and empty[s] mbarriers.
// Producer and consumers walk the same sequence of stages, counted by it.
struct Ring {
  uint32_t ring, bars;
  int stage, n;
  __device__ uint32_t buf(int s) const { return ring + s * stage; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (n + s); }
  // one consumer warp (lane 0) is done with stage s
  __device__ void release(int s) const { mbar_arrive(empty(s)); }
};

template <int KC, int MT1, int NW1, int MT2, int NW2, int NW3>
struct Block {
  static constexpr int RB = 2 * KC;      // bytes of an operand row
  static constexpr int KS = KC / 16;     // k16 steps of a chunk
  static constexpr int A1 = MT1 * 64 * RB;  // conv1's x chunk in a stage

  // The swizzle of row m's 16-byte pieces: swz(m * RB + cb) is
  // m * RB + (cb ^ row_xor(m)) for any cb < RB.
  static __device__ __forceinline__ uint32_t row_xor(int m) {
    return ((static_cast<uint32_t>(m * RB) >> 7) & (KC / 8 - 1)) << 4;
  }

  // A pass's accumulators, rounded, biased and ReLU'd, into a K-major
  // operand region (y1 or y2): column n of row m at region + (n / KC) *
  // chunk + m * RB + ((n % KC) * 2 ^ rx). ok: the row exists; live: its
  // value is kept (else 0: y1 at halo pixels outside the image). Columns in
  // [Cm, cm_pad) are written 0 (Cm is a multiple of 16, n is even).
  template <int NW, int MTN, int ACC>
  static __device__ __forceinline__ void to_smem(
      const float (&acc)[ACC], uint32_t region, int chunk, int nb, int Cm,
      int cm_pad, const float* __restrict__ bias, const bool (&ok)[MTN][2],
      const bool (&live)[MTN][2], const uint32_t (&roff)[MTN][2],
      const uint32_t (&rx)[MTN][2], int t) {
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int n = nb + 8 * j + 2 * t;
      if (n >= cm_pad) continue;
      const bool has = n < Cm;
      const float2 bv = has ? __ldg(reinterpret_cast<const float2*>(bias + n))
                            : make_float2(0.f, 0.f);
      const float bb0 = round_to<__nv_bfloat16>(bv.x);
      const float bb1 = round_to<__nv_bfloat16>(bv.y);
      const uint32_t col = region + (n / KC) * chunk, cb = (n % KC) * 2;
#pragma unroll
      for (int mi = 0; mi < MTN; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!ok[mi][h]) continue;
          const float* c = acc + mi * NW / 2 + 4 * j + 2 * h;
          const float v0 = relu(round_to<__nv_bfloat16>(
              round_to<__nv_bfloat16>(c[0]) + bb0));
          const float v1 = relu(round_to<__nv_bfloat16>(
              round_to<__nv_bfloat16>(c[1]) + bb1));
          st_shared_u32(col + roff[mi][h] + (cb ^ rx[mi][h]),
                        live[mi][h] && has ? pack_bf16(v0, v1) : 0u);
        }
    }
  }

  // conv3's epilogue: relu(round(round(acc) + b3) + x) to the output. A
  // quad of lanes holds 8 consecutive channels of a row as four pairs; a
  // 4 x 4 exchange within the quad gives each lane one whole 8-channel
  // block of four, so x is read and the output written 16 bytes at a time.
  template <int NW, int MTN, int ACC>
  static __device__ __forceinline__ void to_global(
      const float (&acc)[ACC], int nb, int C, const float* __restrict__ bias,
      const bool (&ok)[MTN][2], const size_t (&pix)[MTN][2],
      const __nv_bfloat16* __restrict__ xb, __nv_bfloat16* __restrict__ ob,
      int t) {
    static_assert(NW % 32 == 0, "conv3 columns per warpgroup");
#pragma unroll
    for (int jj = 0; jj < NW / 32; ++jj) {
      uint32_t pr[4][MTN][2];  // pair of block 4 jj + k, row (mi, h)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = nb + 32 * jj + 8 * k + 2 * t;
        const float2 bv = n < C
                              ? __ldg(reinterpret_cast<const float2*>(bias + n))
                              : make_float2(0.f, 0.f);
        const float bb0 = round_to<__nv_bfloat16>(bv.x);
        const float bb1 = round_to<__nv_bfloat16>(bv.y);
#pragma unroll
        for (int mi = 0; mi < MTN; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* c = acc + mi * NW / 2 + 4 * (4 * jj + k) + 2 * h;
            pr[k][mi][h] = pack_bf16(
                round_to<__nv_bfloat16>(c[0]) + bb0,
                round_to<__nv_bfloat16>(c[1]) + bb1);
          }
      }
      const int n0 = nb + 32 * jj + 8 * t;  // this lane's 8 channels
#pragma unroll
      for (int mi = 0; mi < MTN; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // v[p]: the pair lane p of the quad holds of block 4 jj + t
          uint32_t recv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int k = t ^ r;
            const uint32_t send = k == 0   ? pr[0][mi][h]
                                  : k == 1 ? pr[1][mi][h]
                                  : k == 2 ? pr[2][mi][h]
                                           : pr[3][mi][h];
            recv[r] = r ? __shfl_xor_sync(0xffffffffu, send, r) : send;
          }
          uint32_t v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = q ^ t;
            v[q] = r == 0 ? recv[0] : r == 1 ? recv[1] : r == 2 ? recv[2]
                                                                : recv[3];
          }
          if (!ok[mi][h] || n0 >= C) continue;
          const uint4 xv =
              __ldg(reinterpret_cast<const uint4*>(xb + pix[mi][h] + n0));
          const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
          uint32_t o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const __nv_bfloat162 yv =
                *reinterpret_cast<const __nv_bfloat162*>(&v[q]);
            const __nv_bfloat162 xq =
                *reinterpret_cast<const __nv_bfloat162*>(&xw[q]);
            // y is bf16 already: round(y + x) in f32, then ReLU
            o[q] = pack_bf16(
                relu(round_to<__nv_bfloat16>(__low2float(yv) + __low2float(xq))),
                relu(round_to<__nv_bfloat16>(__high2float(yv) +
                                             __high2float(xq))));
          }
          *reinterpret_cast<uint4*>(ob + pix[mi][h] + n0) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
    }
  }

  // conv1 and conv3: A and B from shared memory. One pass of NW columns
  // per warpgroup over nk chunks; stage it0 + j holds chunk j.
  template <int NW, int MTN, int ACC>
  static __device__ __forceinline__ void ss_pass(
      float (&acc)[ACC], const Ring& R, int& it, int nk, uint32_t a_fixed,
      int a_chunk, int b_off, int lane) {
    int prev = -1;
    for (int kc = 0; kc < nk; ++kc) {
      const int s = it % R.n;
      mbar_wait(R.full(s), (it / R.n) & 1);
      // a_fixed == 0: A is the stage's x chunk; else chunk kc of y2
      const uint32_t a = a_fixed ? a_fixed + kc * a_chunk : R.buf(s);
      const uint32_t bb = R.buf(s) + b_off;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        static_for<0, MTN>([&](auto mi_c) {
          constexpr int mi = decltype(mi_c)::value;
          wgmma_ss<NW, mi * NW / 2>(acc, desc<KC>(a + mi * 64 * RB + kk * 32),
                                    desc<KC>(bb + kk * 32), kc | kk);
        });
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        if (lane == 0) R.release(prev);
      }
      prev = s;
      ++it;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MTN * NW / 2; ++i) reg_fence(acc[i]);
    if (lane == 0 && prev >= 0) R.release(prev);
  }

  // One conv2 k-chunk: A gathered from y1 into registers a[BUF], B the
  // stage's w2 chunk.
  template <int BUF, int ACC>
  static __device__ __forceinline__ void rs_step(
      float (&acc)[ACC], uint32_t (&a)[2][MT2][KS][4], const Ring& R, int it,
      int& prev, uint32_t y1c, const int (&row)[MT2], int toff, int b_off,
      int koff, bool first, int lane) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int mi = 0; mi < MT2; ++mi) {
        const int r = row[mi] >= 0 ? row[mi] + toff : 0;
        ldmatrix_x4(a[BUF][mi][kk], y1c + swz<KC>(r * RB + kk * 32 + koff));
      }
    const int s = it % R.n;
    mbar_wait(R.full(s), (it / R.n) & 1);
    const uint32_t bb = R.buf(s) + b_off;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      static_for<0, MT2>([&](auto mi_c) {
        constexpr int mi = decltype(mi_c)::value;
        wgmma_rs<NW2, mi * NW2 / 2>(acc, a[BUF][mi][kk],
                                    desc<KC>(bb + kk * 32),
                                    first && kk == 0 ? 0 : 1);
      });
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
#pragma unroll
      for (int mi = 0; mi < MT2; ++mi)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) reg_fence(a[1 - BUF][mi][kk][q]);
      if (lane == 0) R.release(prev);
    }
    prev = s;
  }
};

template <int KC, int MT1, int NW1, int MT2, int NW2, int NW3>
__global__ void __launch_bounds__(kThreadsW, 1)
bottleneck_wgmma(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw1,
                 const __grid_constant__ CUtensorMap tw2,
                 const __grid_constant__ CUtensorMap tw3, const WParams p) {
  using Blk = Block<KC, MT1, NW1, MT2, NW2, NW3>;
  constexpr int RB = Blk::RB, KS = Blk::KS, A1 = Blk::A1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int dil = p.dil, TH = p.TH, TW = p.TW;
  const int PW = TW + 2 * dil, PH = TH + 2 * dil, P1 = PH * PW, M2 = TH * TW;
  const int ncm = cdiv(p.Cm, KC), nkc = cdiv(p.C, KC);
  const int cm_pad = ncm * KC;
  const int chunk1 = round_up(P1, 8) * RB;     // y1 bytes of a KC chunk
  const int chunk2 = MT2 * 64 * RB;            // y2 bytes of a KC chunk
  const uint32_t y1 = base, y2 = base + p.y2_off;
  Ring R{base + p.region, 0, p.stage, p.stages};
  R.bars = R.ring + p.stages * p.stage;

  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int np1 = cdiv(p.Cm, 2 * NW1), np2 = cdiv(p.Cm, 2 * NW2),
            np3 = cdiv(p.C, 2 * NW3);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(R.full(s), 1);
      mbar_init(R.empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---- producer: one thread walks every chunk of the three convs; its
    // warpgroup hands registers to the consumers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != kConsumers) return;
    int it = 0;
    auto acquire = [&](uint32_t bytes) {
      const int s = it % R.n;
      mbar_wait(R.empty(s), ((it / R.n) & 1) ^ 1);
      mbar_expect_tx(R.full(s), bytes);
      ++it;
      return s;
    };
    for (int q = 0; q < np1; ++q)
      for (int kc = 0; kc < nkc; ++kc) {
        const int s = acquire(P1 * RB + 2 * NW1 * RB);
        tma_4d(R.buf(s), &tx, R.full(s), kc * KC, c0 - dil, r0 - dil, b);
        for (int w = 0; w < 2; ++w)
          tma_2d(R.buf(s) + A1 + w * NW1 * RB, &tw1, R.full(s), kc * KC,
                 q * 2 * NW1 + w * NW1);
      }
    for (int q = 0; q < np2; ++q)
      for (int tap = 0; tap < 9; ++tap)
        for (int kc = 0; kc < ncm; ++kc) {
          const int s = acquire(2 * NW2 * RB);
          for (int w = 0; w < 2; ++w)
            tma_3d(R.buf(s) + w * NW2 * RB, &tw2, R.full(s), kc * KC, tap,
                   q * 2 * NW2 + w * NW2);
        }
    for (int q = 0; q < np3; ++q)
      for (int kc = 0; kc < ncm; ++kc) {
        const int s = acquire(2 * NW3 * RB);
        for (int w = 0; w < 2; ++w)
          tma_2d(R.buf(s) + w * NW3 * RB, &tw3, R.full(s), kc * KC,
                 q * 2 * NW3 + w * NW3);
      }
    return;
  }

  // ---- consumers: warpgroup wg, warp wq of it ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* __restrict__ xb =
      p.x + static_cast<size_t>(b) * p.H * p.W * p.C;
  __nv_bfloat16* __restrict__ ob =
      p.out + static_cast<size_t>(b) * p.H * p.W * p.C;
  const float* __restrict__ b1 = p.b1;
  const float* __restrict__ b2 = p.b2;
  const float* __restrict__ b3 = p.b3;
  int it = 0;  // ring stages consumed, as the producer counts them

  // conv1 (1x1) over the haloed tile -> y1 (0 outside the image)
  {
    bool ok[MT1][2], live[MT1][2];
    uint32_t roff[MT1][2], rx[MT1][2];
#pragma unroll
    for (int mi = 0; mi < MT1; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mi * 64 + wq * 16 + g + 8 * h;
        const int r = r0 - dil + m / PW, c = c0 - dil + m % PW;
        ok[mi][h] = m < P1;
        live[mi][h] = r >= 0 && r < p.H && c >= 0 && c < p.W;
        roff[mi][h] = m * RB;
        rx[mi][h] = Blk::row_xor(m);
      }
    float acc[MT1 * NW1 / 2];  // each phase its own accumulators
    for (int q = 0; q < np1; ++q) {
      Blk::template ss_pass<NW1, MT1>(acc, R, it, nkc, 0u, 0,
                                      A1 + wg * NW1 * RB, lane);
      Blk::template to_smem<NW1, MT1>(acc, y1, chunk1, q * 2 * NW1 + wg * NW1,
                                      p.Cm, cm_pad, b1, ok, live, roff, rx, t);
    }
  }
  consumer_sync();

  // conv2 (3x3, dilation dil) from y1 -> y2
  {
    int row[MT2];  // y1 row of tap (0, 0) of this lane's ldmatrix row
#pragma unroll
    for (int mi = 0; mi < MT2; ++mi) {
      const int m = mi * 64 + wq * 16 + (lane & 15);
      row[mi] = m < M2 ? (m / TW) * PW + m % TW : -1;
    }
    bool ok[MT2][2], live[MT2][2];
    uint32_t roff[MT2][2], rx[MT2][2];
#pragma unroll
    for (int mi = 0; mi < MT2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mi * 64 + wq * 16 + g + 8 * h;
        ok[mi][h] = m < M2;
        live[mi][h] = true;
        roff[mi][h] = m * RB;
        rx[mi][h] = Blk::row_xor(m);
      }
    const int koff = (lane >> 4) * 16;
    uint32_t a[2][MT2][KS][4];
    float acc[MT2 * NW2 / 2];
    for (int q = 0; q < np2; ++q) {
      int prev = -1, odd = 0;
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * dil * PW + (tap % 3) * dil;
        for (int kc = 0; kc < ncm; ++kc) {
          const bool first = tap == 0 && kc == 0;
          if (odd)
            Blk::template rs_step<1>(acc, a, R, it, prev, y1 + kc * chunk1,
                                     row, toff, wg * NW2 * RB, koff, first,
                                     lane);
          else
            Blk::template rs_step<0>(acc, a, R, it, prev, y1 + kc * chunk1,
                                     row, toff, wg * NW2 * RB, koff, first,
                                     lane);
          odd ^= 1;
          ++it;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < MT2 * NW2 / 2; ++i) reg_fence(acc[i]);
#pragma unroll
      for (int bb = 0; bb < 2; ++bb)
#pragma unroll
        for (int mi = 0; mi < MT2; ++mi)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) reg_fence(a[bb][mi][kk][e]);
      if (lane == 0 && prev >= 0) R.release(prev);
      if (p.y2_off == 0) consumer_sync();  // every read of y1 is over
      Blk::template to_smem<NW2, MT2>(acc, y2, chunk2, q * 2 * NW2 + wg * NW2,
                                      p.Cm, cm_pad, b2, ok, live, roff, rx, t);
    }
  }
  fence_async_shared();  // y2's generic stores, before wgmma reads them
  consumer_sync();

  // conv3 (1x1) from y2, + bias, + identity, relu -> out
  {
    bool ok[MT2][2];
    size_t pix[MT2][2];
#pragma unroll
    for (int mi = 0; mi < MT2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mi * 64 + wq * 16 + g + 8 * h;
        const int r = r0 + m / TW, c = c0 + m % TW;
        ok[mi][h] = m < M2 && r < p.H && c < p.W;
        pix[mi][h] = (static_cast<size_t>(r) * p.W + c) * p.C;
      }
    float acc[MT2 * NW3 / 2];
    for (int q = 0; q < np3; ++q) {
      Blk::template ss_pass<NW3, MT2>(acc, R, it, ncm, y2, chunk2,
                                      wg * NW3 * RB, lane);
      Blk::template to_global<NW3, MT2>(acc, q * 2 * NW3 + wg * NW3, p.C, b3,
                                        ok, pix, xb, ob, t);
    }
  }
}

// ---- host: tensor maps and the launcher ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process already runs on.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// A bf16 tensor map of rank r over dims (innermost first) with byte strides
// of dims 1.., box dims box; KC 64 -> 128-byte swizzle, 32 -> 64-byte.
bool make_map(CUtensorMap* m, const void* ptr, int r, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box, int kc) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, r, const_cast<void*>(ptr),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             kc == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
             : kc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CFG>
cudaError_t launch_wgmma(const void* x, const void* w1, const float* b1,
                         const void* w2, const float* b2, const void* w3,
                         const float* b3, void* out, int B, int H, int W,
                         int C, int Cm, int dil, int th, int tw, int stages,
                         int smem, int y2_off, int region, int stage,
                         dim3 grid, cudaStream_t stream) {
  constexpr int KC = kConfigs[CFG][0], MT1 = kConfigs[CFG][1],
                NW1 = kConfigs[CFG][2], MT2 = kConfigs[CFG][3],
                NW2 = kConfigs[CFG][4], NW3 = kConfigs[CFG][5];
  const cuuint64_t e = 2;  // bytes of a bf16
  CUtensorMap tx, tw1, tw2, tw3;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {C * e, (cuuint64_t)W * C * e,
                            (cuuint64_t)H * W * C * e};
  const cuuint32_t xbox[4] = {KC, (cuuint32_t)(tw + 2 * dil),
                              (cuuint32_t)(th + 2 * dil), 1};
  const cuuint64_t w1d[2] = {(cuuint64_t)C, (cuuint64_t)Cm};
  const cuuint64_t w1s[1] = {C * e};
  const cuuint32_t w1box[2] = {KC, NW1};
  const cuuint64_t w2d[3] = {(cuuint64_t)Cm, 9, (cuuint64_t)Cm};
  const cuuint64_t w2s[2] = {Cm * e, 9 * Cm * e};
  const cuuint32_t w2box[3] = {KC, 1, NW2};
  const cuuint64_t w3d[2] = {(cuuint64_t)Cm, (cuuint64_t)C};
  const cuuint64_t w3s[1] = {Cm * e};
  const cuuint32_t w3box[2] = {KC, NW3};
  if (!make_map(&tx, x, 4, xd, xs, xbox, KC) ||
      !make_map(&tw1, w1, 2, w1d, w1s, w1box, KC) ||
      !make_map(&tw2, w2, 3, w2d, w2s, w2box, KC) ||
      !make_map(&tw3, w3, 2, w3d, w3s, w3box, KC))
    return cudaErrorInvalidValue;
  WParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.b1 = b1;
  p.b2 = b2;
  p.b3 = b3;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.H = H;
  p.W = W;
  p.C = C;
  p.Cm = Cm;
  p.dil = dil;
  p.TH = th;
  p.TW = tw;
  p.stages = stages;
  p.y2_off = y2_off;
  p.region = region;
  p.stage = stage;
  auto k = bottleneck_wgmma<KC, MT1, NW1, MT2, NW2, NW3>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreadsW, smem, stream>>>(tx, tw1, tw2, tw3, p);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, H, W, Cin); w1 (Cmid, Cin), w2 (Cmid, 3, 3, Cmid), w3 (Cin,
// Cmid) in x's type; b1, b2 (Cmid,) and b3 (Cin,) f32. plan: the n ints of
// ops/resblock.py BottleneckPlan.as_ints() -- design (1 wgmma, bf16; 0 fma,
// f32), config, TH, TW, stages, shared-memory bytes, y2_off, region, stage
// (the layout, which the plan owns), grid x, y, z. The launcher checks the
// plan's bounds -- the grid, the m-tiles of the configuration, alignment,
// the layout adding up to the bytes asked for and those within the card's
// opt-in limit -- and returns cudaErrorInvalidValue on a plan it cannot run.
extern "C" int uemda_bottleneck_identity(const void* x, const void* w1,
                                         const void* b1, const void* w2,
                                         const void* b2, const void* w3,
                                         const void* b3, void* out, int B,
                                         int H, int W, int Cin, int Cmid,
                                         int dil, const int* plan, int n,
                                         void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cmid <= 0 || Cin % 16 ||
      Cmid % 16 || dil < 1 || !plan || n != 12)
    return cudaErrorInvalidValue;
  const int design = plan[0], cfg = plan[1], th = plan[2], tw = plan[3],
            stages = plan[4], smem = plan[5], y2_off = plan[6],
            region = plan[7], stage = plan[8];
  const dim3 grid(plan[9], plan[10], plan[11]);
  if (th < 1 || tw < 1 || smem < 1 || y2_off < 0 ||
      static_cast<int>(grid.x) != cdiv(W, tw) ||
      static_cast<int>(grid.y) != cdiv(H, th) || static_cast<int>(grid.z) != B)
    return cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > max_smem) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* fb3 = static_cast<const float*>(b3);
  if (design == 0) {  // f32 on the CUDA cores
    if (cfg != -1 || stages != 0 || region != 0 || stage != 0 ||
        y2_off % 16 || y2_off >= smem)
      return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(bottleneck_fma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    bottleneck_fma<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), fb1,
        static_cast<const float*>(w2), fb2, static_cast<const float*>(w3),
        fb3, static_cast<float*>(out), H, W, Cin, Cmid, dil, th, tw, y2_off);
    return cudaGetLastError();
  }
  if (design != 1 || cfg < 0 || cfg >= kNumConfigs || stages < 2 ||
      stages > 8 || y2_off % 1024 || region % 1024 || stage % 1024 ||
      y2_off >= region || stage < 1024 ||
      1024 + region + stages * (stage + 16) != smem)
    return cudaErrorInvalidValue;
  const int* c = kConfigs[cfg];
  if ((th + 2 * dil) * (tw + 2 * dil) > 64 * c[1] || th * tw > 64 * c[3] ||
      tw + 2 * dil > 256 || th + 2 * dil > 256)
    return cudaErrorInvalidValue;
  switch (cfg) {
    case 0:
      return launch_wgmma<0>(x, w1, fb1, w2, fb2, w3, fb3, out, B, H, W, Cin,
                             Cmid, dil, th, tw, stages, smem, y2_off, region,
                             stage, grid, s);
    case 1:
      return launch_wgmma<1>(x, w1, fb1, w2, fb2, w3, fb3, out, B, H, W, Cin,
                             Cmid, dil, th, tw, stages, smem, y2_off, region,
                             stage, grid, s);
    case 2:
      return launch_wgmma<2>(x, w1, fb1, w2, fb2, w3, fb3, out, B, H, W, Cin,
                             Cmid, dil, th, tw, stages, smem, y2_off, region,
                             stage, grid, s);
    default:
      return launch_wgmma<3>(x, w1, fb1, w2, fb2, w3, fb3, out, B, H, W, Cin,
                             Cmid, dil, th, tw, stages, smem, y2_off, region,
                             stage, grid, s);
  }
}
