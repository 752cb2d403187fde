// K3: eval tail -- bilinear upsample (align_corners=True) of the stacked
// head logits, f32 softmax per head, mean over the heads.
//
// Replaces uemda_tpu/ops/pallas_tail.py:tail_upsample_softmax_mean
// (_tail_kernel), the eval tail of infer/fastpath.serving_forward and of
// models/deeplabv2.DeeplabV2 in eval mode (reference Encoder.py:152-155).
//
// Bound on the H100: bytes. At the serving shape (B 8, g*nc = 12 logits at
// 32 x 32 -> nc = 6 classes at 512 x 512, bf16) the input is 24 KiB and the
// (B, Ho, Wo, nc) probabilities, written once, are 25.2 MB: 7.5 us at
// 3.35 TB/s. The second floor is the SFU: 12 exponentials a pixel are
// 25.2 M MUFU.EX2 for the batch of 8 (not per tile), at 16 a clock per SM
// ~6.8 us at 1.755 GHz on 132 SMs, and one reciprocal per head and pixel
// adds ~1.1 us -- about the bytes bound, so the kernel has to keep both
// the SFU and the stores busy at once. A third floor of the same size is
// instruction issue: the pixel loop issues ~110 instructions a pixel
// (W-lerps, maxima, exponentials, sums, staging), ~8 us on 132 SMs.
//
// Design. The grid is (row blocks, B, column chunks): a CTA owns `rows`
// consecutive output rows and `cols` consecutive output columns of one
// sample (blockIdx.y), so no index is divided per pixel and no 64-bit
// integer is divided anywhere. In shared memory, in three phases:
//   1. the input window those outputs read (its rows and columns, bounded
//      by the plan) is staged as f32, and each output column's source
//      offset and weight (x0, lx) computed once per CTA;
//   2. every output row of the CTA is interpolated along H once, all rows
//      at the same time (a thread 4 logits of a row's input column and
//      head) -- "along H first, then W", as the reference's separable
//      resize -- into a row of [x][head][logits, steps to the next
//      column][nc padded to 4] f32, so a pixel reads a head's logits of
//      one column with 16-byte loads; one barrier;
//   3. each warp then takes chunks of 32 * ppt consecutive pixels of a row
//      (warp w chunks w, w + 8, ... of each row), a lane ppt consecutive
//      pixels: per head one W-lerp per logit (one FFMA), a max-subtracted
//      softmax with the max folded into one FFMA per exponential
//      (ex2.approx of v*log2e - m*log2e) and one reciprocal per head
//      (times 1/g, so the mean over the heads is one FFMA per class). The
//      lanes stage the chunk's 32 * ppt * nc outputs in the warp's own
//      buffer at the chunk's offset within 16 bytes of its destination,
//      with the widest shared stores their alignment allows, and after a
//      __syncwarp write it with 16-byte stores, a lane each (the head and
//      tail under 16 bytes one element a lane), as K7 aligns its stores.
//      No barrier of the CTA between chunks: each warp computes and stores
//      at its own pace, and the SM's other warps hide its stores.
// The plan (ops/tail.py: tail_plan) fixes rows, cols, ppt, the staged
// window's bounds and the shared-memory bytes; the launcher checks them
// against the align_corners scales it works out from the shapes.
// Compile-time nc and g, 2 pixels a thread, for the dual head's 2 x 6
// (ISPRS) and 2 x 7 (LoveDA) logits; any other nc up to 16 and any g on a
// generic instantiation, 1 pixel a thread.
//
// Error budget against the plain f32 version (the gates stay 1e-5 absolute
// in f32, 8e-3 in bf16): ex2.approx.ftz has a relative error of ~2^-22 and
// rcp.approx.ftz ~2^-23; the rounding of m*log2e is shared by a head's
// exponentials and cancels in the normalization, what remains is the
// rounding of each argument, |v - m| * log2e * 2^-24; 1/g folded into the
// reciprocal adds one rounding. Together well under 1e-6 of a probability
// (<= 1). Results below 2^-126 flush to 0 (plain: a denormal). In bf16 the
// output's own rounding (<= 2^-9 relative) dominates; such a difference can
// move it by one unit, <= 3.9e-3.
//
// Layout: cat (B, Hi, Wi, g*nc) and out (B, Ho, Wo, nc), NHWC in memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNC = 16;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// align_corners=True source index of output o: floor(o * scale) clamped to
// the input, with o * scale rounded to f32 first (the host's bound and the
// plan assume exactly this product)
__device__ __forceinline__ int src_lo(int o, float scale, int n, float* w) {
  const float f = __fmul_rn(static_cast<float>(o), scale);
  const int i = min(static_cast<int>(f), n - 1);
  *w = f - static_cast<float>(i);
  return i;
}

// Bytes of each shared-memory part, in order: the CTA's rows H-interpolated
// (each the logits and their steps to the next column), the staged input
// window, the column table (8 bytes a column) and each warp's staged chunk
// (32 * ppt pixels of nc values and up to 15 bytes of alignment shift, to
// 16 bytes). The plan (ops/tail.py: tail_smem) computes the same.
struct SmemLayout {
  long long h, in, col, out, chunk_elems;
  __host__ __device__ SmemLayout(int rows, int cols, int ppt, int in_rows,
                                 int in_cols, int g, int nc, int elt) {
    const long long ncp = (nc + 3) & ~3;
    const long long v = 16 / elt;  // elements in 16 bytes
    h = 4LL * rows * in_cols * (2 * g * ncp + 4);
    in = (4LL * in_rows * in_cols * g * nc + 15) & ~15LL;
    col = (8LL * cols + 15) & ~15LL;
    chunk_elems = (32LL * ppt * nc + v - 1 + v - 1) / v * v;
    out = chunk_elems * elt * kWarps;
  }
  __host__ __device__ long long total() const { return h + in + col + out; }
};

// NB words to dst (4-byte aligned), 16 or 8 bytes a store where dst's
// alignment allows
template <int NB>
__device__ __forceinline__ void store_words(unsigned char* dst,
                                            const uint32_t (&w)[NB]) {
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(dst));
  if (NB % 4 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < NB / 4; ++i)
      reinterpret_cast<uint4*>(dst)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else if (NB % 2 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < NB / 2; ++i)
      reinterpret_cast<uint2*>(dst)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < NB; ++i) reinterpret_cast<uint32_t*>(dst)[i] = w[i];
  }
}

__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

// One CTA: output rows [blockIdx.x * rows, + rows) and columns
// [blockIdx.z * cols, + cols) of sample blockIdx.y. NC and NH: the classes
// and heads, 0 for a runtime nc (<= kMaxNC) and g (ppt 1); P: pixels a
// thread.
template <typename T, int NC, int NH, int P>
__global__ void __launch_bounds__(kThreads)
tail_kernel(const T* __restrict__ cat, T* __restrict__ out, int Hi, int Wi,
            int Ho, int Wo, int g, int nc, float sh, float sw, int rows,
            int cols, int in_rows, int in_cols, float inv_g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int M = NC ? NC : kMaxNC;        // classes held in registers
  constexpr int MP = (M + 3) & ~3;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (NC) nc = NC;
  if (NH) g = NH;
  const int ncp = (nc + 3) & ~3;
  const int G = g * nc;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows, c0 = blockIdx.z * cols;
  const int nr = min(rows, Ho - r0), ncol = min(cols, Wo - c0);

  // the input window of these outputs
  float unused;
  const int ylo = src_lo(r0, sh, Hi, &unused);
  const int yhi = min(src_lo(r0 + nr - 1, sh, Hi, &unused) + 1, Hi - 1);
  const int xlo = src_lo(c0, sw, Wi, &unused);
  const int xhi = min(src_lo(c0 + ncol - 1, sw, Wi, &unused) + 1, Wi - 1);
  const int nin = yhi - ylo + 1, nx = xhi - xlo + 1;
  if (nin > in_rows || nx > in_cols) __trap();  // the plan's bound, proven

  const SmemLayout lay(rows, cols, P, in_rows, in_cols, g, nc, sizeof(T));
  float* s_h = reinterpret_cast<float*>(smem);
  float* s_in = reinterpret_cast<float*>(smem + lay.h);
  float2* s_col = reinterpret_cast<float2*>(smem + lay.h + lay.in);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* wbuf = reinterpret_cast<T*>(smem + lay.h + lay.in + lay.col) +
            warp * lay.chunk_elems;

  // 1. the input window, as f32: per input row one contiguous run; each
  // thread issues up to kLoads loads before it stores any
  const int run = nx * G;
  constexpr int kLoads = 8;
  for (int i0 = threadIdx.x; i0 < nin * run; i0 += kThreads * kLoads) {
    float f[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = i0 + k * kThreads;
      const int yy = i / run;  // 32-bit, once an input value
      f[k] = i < nin * run
                 ? to_f32(cat[(static_cast<size_t>(b) * Hi + ylo + yy) * Wi * G +
                              static_cast<size_t>(xlo) * G + (i - yy * run)])
                 : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (i0 + k * kThreads < nin * run) s_in[i0 + k * kThreads] = f[k];
  }
  // and the column table: x0's offset in an H-row, and lx; an H-row
  // column holds 4 floats more than its logits and steps, so neighbouring
  // columns start on other banks
  const int hx = 2 * g * ncp + 4;
  for (int i = threadIdx.x; i < ncol; i += kThreads) {
    float lx;
    const int x0 = src_lo(c0 + i, sw, Wi, &lx);
    s_col[i] = make_float2(__int_as_float((x0 - xlo) * hx), lx);
  }
  __syncthreads();

  // 2. every output row along H, a thread 4 logits of an (output row,
  // input column, head): the logits L[x] and their steps to the next
  // column, D[x] = L[x + 1] - L[x] (0 at the window's last column: no
  // pixel has its x0 there but where x1 = x0, at the input's last column),
  // zero-padded to ncp: a pixel's W-lerp is then one FFMA a logit,
  // L + lx * D. Two 16-byte shared stores an item.
  const int hrow = nx * hx;
  const int nq = ncp >> 2, per_row = nx * g * nq;
  for (int i = threadIdx.x; i < nr * per_row; i += kThreads) {
    const int r = i / per_row;  // 32-bit, once an item
    int rem = i - r * per_row;
    const int xx = rem / (g * nq);
    rem -= xx * g * nq;
    const int h = rem / nq, q4 = 4 * (rem - h * nq);
    float ly;
    const int y0 = src_lo(r0 + r, sh, Hi, &ly);
    const int y1 = min(y0 + 1, Hi - 1);
    const float* a = s_in + (y0 - ylo) * run + xx * G + h * nc;
    const float* c = s_in + (y1 - ylo) * run + xx * G + h * nc;
    const int d1 = xx + 1 < nx ? G : 0;  // x1's logits
    float l[4], d[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      l[j] = d[j] = 0.f;
      if (q4 + j < nc) {
        l[j] = (1.f - ly) * a[q4 + j] + ly * c[q4 + j];
        d[j] = (1.f - ly) * a[q4 + j + d1] + ly * c[q4 + j + d1] - l[j];
      }
    }
    float* dst = s_h + r * hrow + xx * hx + 2 * h * ncp + q4;
    *reinterpret_cast<float4*>(dst) = make_float4(l[0], l[1], l[2], l[3]);
    *reinterpret_cast<float4*>(dst + ncp) = make_float4(d[0], d[1], d[2], d[3]);
  }
  __syncthreads();

  // 3. warp by warp, chunks of 32 * ppt pixels of a row, ppt pixels a
  // lane, staged in the warp's buffer at the chunk's offset within 16 bytes
  // of its destination, then stored 16 bytes a lane
  constexpr int kChunk = 32 * P;
  for (int r = 0; r < nr; ++r) {
    const float* hr = s_h + r * hrow;
    T* drow = out + ((static_cast<size_t>(b) * Ho + r0 + r) * Wo + c0) * nc;
    for (int xc = warp * kChunk; xc < ncol; xc += kWarps * kChunk) {
      T* dst = drow + static_cast<size_t>(xc) * nc;
      const int shift =
          static_cast<int>((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T));
      T* st = wbuf + shift + lane * P * nc;
      float acc[P][M];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int c = 0; c < M; ++c) acc[p][c] = 0.f;
        const int xi = xc + lane * P + p;
        if (xi >= ncol) continue;
        const float2 col = s_col[xi];
        const float* hc = hr + __float_as_int(col.x);
        const float lx = col.y;
#pragma unroll
        for (int h = 0; h < (NH ? NH : g); ++h) {
          float v[MP];
          const float4* lh = reinterpret_cast<const float4*>(hc + 2 * h * ncp);
          const float4* dh = reinterpret_cast<const float4*>(hc + (2 * h + 1) * ncp);
#pragma unroll
          for (int q = 0; q < MP / 4; ++q) {
            if (!NC && 4 * q >= ncp) break;
            const float4 l = lh[q], d = dh[q];
            v[4 * q] = fmaf(lx, d.x, l.x);
            v[4 * q + 1] = fmaf(lx, d.y, l.y);
            v[4 * q + 2] = fmaf(lx, d.z, l.z);
            v[4 * q + 3] = fmaf(lx, d.w, l.w);
          }
          float m = v[0];
#pragma unroll
          for (int c = 1; c < M; ++c)
            if (NC || c < nc) m = fmaxf(m, v[c]);
          const float ml = m * kLog2e;
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < M; ++c) {
            if (NC || c < nc) {
              v[c] = ex2(fmaf(v[c], kLog2e, -ml));
              s += v[c];
            }
          }
          const float rg = rcp(s) * inv_g;
#pragma unroll
          for (int c = 0; c < M; ++c)
            if (NC || c < nc) acc[p][c] = fmaf(v[c], rg, acc[p][c]);
        }
      }
      // stage the lane's outputs, in words where they are whole
      bool staged = false;
      constexpr int kBytes = P * M * static_cast<int>(sizeof(T));
      if constexpr (NC > 0 && kBytes % 4 == 0) {
        if (xc + lane * P + P <= ncol &&
            (reinterpret_cast<uintptr_t>(st) & 3) == 0) {
          uint32_t w[kBytes / 4];
#pragma unroll
          for (int i = 0; i < kBytes / 4; ++i) {
            if (sizeof(T) == 4) {
              w[i] = bits_of(from_f32<T>(acc[i / M][i % M]));
            } else {  // one cvt.rn.bf16x2.f32 a pair
              const int e = 2 * i;
              const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                  acc[e / M][e % M], acc[(e + 1) / M][(e + 1) % M]);
              w[i] = bits_of(v2.x) | (bits_of(v2.y) << 16);
            }
          }
          store_words(reinterpret_cast<unsigned char*>(st), w);
          staged = true;
        }
      }
      if (!staged) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (xc + lane * P + p >= ncol) break;
#pragma unroll
          for (int c = 0; c < M; ++c)
            if (NC || c < nc) st[p * nc + c] = from_f32<T>(acc[p][c]);
        }
      }
      // the chunk's run, 16 bytes a lane, from 16-byte boundaries of both
      // the buffer and the output; its head and tail one element a lane
      __syncwarp();
      const int n = min(kChunk, ncol - xc) * nc;
      const int head = min(n, (V - shift) % V);
      const int nv = (n - head) / V;
      const int tail = head + nv * V;
      const uint4* src16 = reinterpret_cast<const uint4*>(wbuf + shift + head);
      uint4* dst16 = reinterpret_cast<uint4*>(dst + head);
#pragma unroll 1
      for (int i = lane; i < nv; i += 32) dst16[i] = src16[i];
      if (lane < head) dst[lane] = wbuf[shift + lane];
      if (lane < n - tail) dst[tail + lane] = wbuf[shift + tail + lane];
      __syncwarp();  // the buffer is read before the next chunk stages
    }
  }
}

// rows (or columns) of the input window of `count` consecutive outputs at
// scale `scale` (align_corners), at most: floor(o * scale) of the first and
// floor(o * scale) + 1 of the last, each product rounded to f32 once, span
// at most floor((count - 1) * scale) + 4 inputs; and never more than `n`
int window_bound(int count, float scale, int n) {
  const long long b =
      static_cast<long long>((count - 1) * static_cast<double>(scale)) + 4;
  return static_cast<int>(b < n ? b : n);
}

template <typename T, int NC, int NH, int P>
cudaError_t launch(const void* cat, void* out, int Hi, int Wi, int Ho, int Wo,
                   int g, int nc, float sh, float sw, int rows, int cols,
                   int in_rows, int in_cols, int smem, dim3 grid,
                   cudaStream_t s) {
  auto k = tail_kernel<T, NC, NH, P>;
  static int smem_set = 48 * 1024;  // the largest size allowed so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  k<<<grid, kThreads, smem, s>>>(static_cast<const T*>(cat),
                                 static_cast<T*>(out), Hi, Wi, Ho, Wo, g, nc,
                                 sh, sw, rows, cols, in_rows, in_cols,
                                 1.f / static_cast<float>(g));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nc(const void* cat, void* out, int Hi, int Wi, int Ho,
                      int Wo, int g, int nc, float sh, float sw, int rows,
                      int cols, int ppt, int in_rows, int in_cols, int smem,
                      dim3 grid, cudaStream_t s) {
#define UEMDA_TAIL(NC, NH, P)                                                 \
  if ((NC == 0 || (nc == NC && g == NH)) && ppt == P)                         \
    return launch<T, NC, NH, P>(cat, out, Hi, Wi, Ho, Wo, g, nc, sh, sw,      \
                                rows, cols, in_rows, in_cols, smem, grid, s);
  UEMDA_TAIL(6, 2, 2) UEMDA_TAIL(7, 2, 2) UEMDA_TAIL(0, 0, 1)
#undef UEMDA_TAIL
  return cudaErrorInvalidValue;
}

}  // namespace

// cat: (B, Hi, Wi, g*nc); out: (B, Ho, Wo, nc); nc <= 16. plan (n = 9
// ints, from ops/tail.py: tail_plan): rows and columns a CTA, pixels a
// thread (2 for nc 6 or 7 and g 2, else 1), the staged window's rows and
// columns (window_bound's at the align_corners=True scales (in - 1) /
// (out - 1) rounded to f32, 0 for an output of 1), dynamic shared-memory
// bytes (SmemLayout's), grid x (ceil(Ho / rows)), y (B), z (ceil(Wo /
// cols)). Anything else is refused.
extern "C" int uemda_tail(const void* cat, void* out, int B, int Hi, int Wi,
                          int Ho, int Wo, int g, int nc, int is_bf16,
                          const int* plan, int n, void* stream) {
  if (nc <= 0 || nc > kMaxNC || g <= 0 || B <= 0 || B > 65535 || Hi <= 0 ||
      Wi <= 0 || Ho <= 0 || Wo <= 0 || !plan || n != 9)
    return cudaErrorInvalidValue;
  // the quotient rounded once to double, then to f32, as the plan's
  const auto scale = [](int in, int out) {
    return out > 1 ? static_cast<float>(static_cast<double>(in - 1) / (out - 1))
                   : 0.f;
  };
  const float sh = scale(Hi, Ho), sw = scale(Wi, Wo);
  const int rows = plan[0], cols = plan[1], ppt = plan[2];
  const int in_rows = plan[3], in_cols = plan[4], smem = plan[5];
  const dim3 grid(plan[6], plan[7], plan[8]);
  if (rows < 1 || cols < 1 || rows > Ho || cols > Wo ||
      ppt != ((nc == 6 || nc == 7) && g == 2 ? 2 : 1) ||
      in_rows != window_bound(rows, sh, Hi) ||
      in_cols != window_bound(cols, sw, Wi) ||
      smem != SmemLayout(rows, cols, ppt, in_rows, in_cols, g, nc,
                         is_bf16 ? 2 : 4)
                  .total() ||
      static_cast<long long>(grid.x) * rows < Ho ||
      static_cast<long long>(grid.x - 1) * rows >= Ho ||
      static_cast<int>(grid.y) != B ||
      static_cast<long long>(grid.z) * cols < Wo ||
      static_cast<long long>(grid.z - 1) * cols >= Wo || grid.z > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_nc<__nv_bfloat16>(cat, out, Hi, Wi, Ho, Wo, g, nc,
                                            sh, sw, rows, cols, ppt, in_rows,
                                            in_cols, smem, grid, s)
                 : launch_nc<float>(cat, out, Hi, Wi, Ho, Wo, g, nc, sh, sw,
                                    rows, cols, ppt, in_rows, in_cols, smem,
                                    grid, s);
}
