// K2: fused stem conv + bias + ReLU + 3x3/s2 max-pool of the serving path.
//
// Replaces uemda_tpu/ops/pallas_stem.py:stem_pool_pallas (_kernel). The
// BN-folded 7x7/s2 stem arrives re-indexed by infer/fastpath._s2d_stem_kernel
// as a 4x4/s1 conv on the 2x2 space-to-depth input (12 channels), padding
// (2, 1) per axis. Only the pooled map is written.
//
// Bound on the H100: operations. At a 512x512 tile the conv is
// 256*256*64*192*2 = 1.61 GFLOP against ~1.5 MiB in and 2 MiB out; this
// kernel runs those FMAs on the CUDA cores in f32 (67 TFLOP/s peak), so the
// f32 rate, not memory, is its floor. Tensor cores (wgmma) are later work.
//
// Design: one block per (sample, 8x8 tile of pooled outputs, all 64
// channels). A pooled tile needs 17x17 conv outputs (pool rows/cols 2t-1 ..
// 2t+1), which need a 20x20 input tile: 3 conv rows above and 1 below, as in
// pallas_stem.py:30-33. The block loads that tile (zero outside the image =
// the conv's zero padding) and the whole weight into shared memory, computes
// the 17x17x64 conv tile with f32 accumulation, rounds it to the storage
// type, adds the bias in that type and applies ReLU, matching
// fastpath._conv (:204-214), then max-pools from shared memory. Conv rows or
// columns outside the image (the pool's padding) hold 0: after the ReLU
// every value is >= 0, so zero padding equals the -inf padding of
// models/resnet._max_pool_3x3_s2 (pallas_stem.py:35-36).
//
// Layout: x (B, H2, W2, 12) and out (B, ceil(H2/2), ceil(W2/2), 64) NHWC in
// memory (the pooled size of max_pool2d(3, 2, 1), odd H2 or W2 included); the
// weight (4, 4, 12, 64) HWIO contiguous; the bias (64,) f32.

#include "common.cuh"

namespace {

constexpr int TP = 8;           // pooled rows per block
constexpr int TQ = 8;           // pooled cols per block
constexpr int CR = 2 * TP + 1;  // conv rows per block
constexpr int CC = 2 * TQ + 1;  // conv cols per block
constexpr int IR = CR + 3;      // input rows incl. halo
constexpr int IC = CC + 3;      // input cols incl. halo
constexpr int CIN = 12;
constexpr int COUT = 64;
constexpr int KS = 4;
constexpr int kThreads = 256;
constexpr int GROUPS = kThreads / COUT;       // conv columns handled in turn
constexpr int NJ = (CC + GROUPS - 1) / GROUPS;  // conv columns per thread
constexpr size_t kSmemBytes =
    sizeof(float) * (IR * IC * CIN + KS * KS * CIN * COUT + CR * CC * COUT);

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out, int H2,
                 int W2, int H4, int W4) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [IR][IC][CIN]
  float* ws = xs + IR * IC * CIN;            // [KS*KS*CIN][COUT]
  float* cv = ws + KS * KS * CIN * COUT;     // [CR][CC][COUT]

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * TP;
  const int s0 = blockIdx.x * TQ;
  // tile conv row i is conv row 2*t0-1+i; it reads input rows
  // (2*t0-1+i)-2 .. +1, i.e. tile input rows i .. i+3 from r_in0
  const int r_in0 = 2 * t0 - 3;
  const int c_in0 = 2 * s0 - 3;

  for (int i = threadIdx.x; i < IR * IC * CIN; i += kThreads) {
    const int ci = i % CIN;
    const int cc = (i / CIN) % IC;
    const int rr = i / (CIN * IC);
    const int r = r_in0 + rr, c = c_in0 + cc;
    float v = 0.f;
    if (r >= 0 && r < H2 && c >= 0 && c < W2)
      v = to_f32(x[((static_cast<size_t>(b) * H2 + r) * W2 + c) * CIN + ci]);
    xs[i] = v;
  }
  for (int i = threadIdx.x; i < KS * KS * CIN * COUT; i += kThreads)
    ws[i] = to_f32(w[i]);
  __syncthreads();

  const int o = threadIdx.x % COUT;
  const int g = threadIdx.x / COUT;
  const float bo = round_to<T>(bias[o]);

  for (int i = 0; i < CR; ++i) {
    float acc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
    for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
        const float* xrow = xs + ((i + ky) * IC + kx) * CIN;
        const float* wk = ws + (ky * KS + kx) * CIN * COUT + o;
#pragma unroll
        for (int c4 = 0; c4 < CIN / 4; ++c4) {
          const float w0 = wk[(4 * c4 + 0) * COUT];
          const float w1 = wk[(4 * c4 + 1) * COUT];
          const float w2 = wk[(4 * c4 + 2) * COUT];
          const float w3 = wk[(4 * c4 + 3) * COUT];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int jj = g + j * GROUPS;
            if (jj < CC) {
              const float4 xv =
                  *reinterpret_cast<const float4*>(xrow + jj * CIN + 4 * c4);
              acc[j] += xv.x * w0;
              acc[j] += xv.y * w1;
              acc[j] += xv.z * w2;
              acc[j] += xv.w * w3;
            }
          }
        }
      }
    }
    const int r = 2 * t0 - 1 + i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int jj = g + j * GROUPS;
      if (jj < CC) {
        const int c = 2 * s0 - 1 + jj;
        float v = 0.f;
        if (r >= 0 && r < H2 && c >= 0 && c < W2)
          v = fmaxf(round_to<T>(round_to<T>(acc[j]) + bo), 0.f);
        cv[(i * CC + jj) * COUT + o] = v;
      }
    }
  }
  __syncthreads();

  for (int q = g; q < TP * TQ; q += GROUPS) {
    const int tp = q / TQ, tq = q % TQ;
    const int t = t0 + tp, s = s0 + tq;
    if (t >= H4 || s >= W4) continue;
    float m = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, cv[((2 * tp + dy) * CC + 2 * tq + dx) * COUT + o]);
    out[((static_cast<size_t>(b) * H4 + t) * W4 + s) * COUT + o] = from_f32<T>(m);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out,
                   int B, int H2, int W2, cudaStream_t stream) {
  const int H4 = (H2 + 1) / 2, W4 = (W2 + 1) / 2;
  auto k = stem_pool_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((W4 + TQ - 1) / TQ, (H4 + TP - 1) / TP, B);
  k<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(out), H2, W2, H4, W4);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H2, W2, 12); w: (4, 4, 12, 64) in x's type; bias: (64,) f32;
// out: (B, ceil(H2/2), ceil(W2/2), 64).
extern "C" int uemda_stem_pool(const void* x, const void* w, const void* bias,
                               void* out, int B, int H2, int W2, int is_bf16,
                               void* stream) {
  if (B <= 0 || H2 <= 0 || W2 <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, b, out, B, H2, W2, s)
                 : launch<float>(x, w, b, out, B, H2, W2, s);
}
