// K8: fused uncertainty mining of stage 3 -- per-pixel entropy, the UVEM
// valuable-example weight and the strict-threshold single-class pseudo label
// in one pass over the soft label.
//
// Replaces uemda_tpu/ops/pallas_kernels.py:uvem_mine_pallas
// (_uvem_mine_kernel). From (B, C, H, W) f32 probabilities, read through
// their strides, and the (B, C) f32 thresholds thr = max(cutoff_top * class
// max, cutoff_low) (the class max is a reduction over all pixels and stays
// outside the kernel, as it stays in XLA outside the Pallas body), writes
// per pixel, each (B, H, W):
//   u     = -sum_c p * log(max(p, 1e-30))                          f32
//   label = the one class with p > thr[b, c], else ignore_label    int32
//   w     = the UVEM parabola of u with m, t and gamma             f32
// with the plain version's (ops/uncertainty.py, ops/pseudo.py) order of
// operations: every product and sum is rounded on its own (__fmul_rn and
// __fadd_rn, which nvcc never contracts into an FMA), logf and powf are the
// accurate library functions (no --use_fast_math), and the f32 constants
// -1/m^2, -1/(t-m)^2 and 1/gamma come from the host, rounded once from
// double as the plain version's Python scalars are. A NaN probability makes
// its pixel's u NaN; its weight is then the right branch at x = 0, because
// every comparison with NaN is false, as in the plain version.
//
// Bound on the H100: bytes. At the flagship stage-3 shape (B 8, C 7,
// 512^2) it reads 58.7 MB of probabilities and writes 25.2 MB, ~0.025 ms
// at 3.35 TB/s; per value one log and a few flops, per pixel one pow.
//
// Design: one thread per pixel, a block of kThreads pixels of one sample.
// The thread walks its C probabilities; the address of (b, c, y, x) comes
// from the four strides, so the wrapper hands over any layout without a
// copy: NCHW planes (consecutive threads read consecutive addresses for
// each class) or the channels_last memory a rotated, refined soft label
// arrives in (a warp reads one contiguous run of 32 * C values). The
// block's C thresholds sit in shared memory. Outputs are written once,
// coalesced.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Weights {
  float m, t;       // the branch points, as f32
  float cl, cr;     // -1/m^2 and -1/(t-m)^2, as f32
  float e;          // 1/gamma, as f32
  int has_left;     // m > 0
  int has_right;    // m < t
};

// clip(c * (x - m)^2 + 1, 0, 1) ^ e, each operation rounded on its own
__device__ __forceinline__ float parabola(float x, float m, float c, float e) {
  const float d = __fsub_rn(x, m);
  float v = __fadd_rn(__fmul_rn(c, __fmul_rn(d, d)), 1.0f);
  v = fminf(fmaxf(v, 0.0f), 1.0f);
  return powf(v, e);
}

__global__ void __launch_bounds__(kThreads)
uvem_mine_kernel(const float* __restrict__ probs, const float* __restrict__ thr,
                 int* __restrict__ label, float* __restrict__ wgt,
                 float* __restrict__ unc, int C, int H, int W, long long sB,
                 long long sC, long long sH, long long sW, Weights k,
                 int ignore_label) {
  extern __shared__ float s_thr[];
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += kThreads) s_thr[c] = thr[b * C + c];
  __syncthreads();

  const long long HW = static_cast<long long>(H) * W;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<long long>(y) * W);
  const float* src = probs + b * sB + y * sH + x * sW;

  float acc = 0.0f;
  int count = 0, index = 0;
  for (int c = 0; c < C; ++c) {
    const float v = __ldg(src + c * sC);
    // max(v, 1e-30) keeping NaN, as torch.clamp_min and jnp.maximum do
    const float g = v < 1e-30f ? 1e-30f : v;
    acc = __fadd_rn(acc, __fmul_rn(v, logf(g)));
    if (v > s_thr[c]) {  // strict, pseudo_generation.py:83
      ++count;
      index = c;
    }
  }
  const float u = -acc;

  const float left = k.has_left ? parabola(u, k.m, k.cl, k.e) : 1.0f;
  float right = 0.0f;
  if (k.has_right) {
    const float xr = (u > k.m && u <= k.t) ? u : 0.0f;
    right = parabola(xr, k.m, k.cr, k.e);
  }
  float w = u <= k.m ? left : right;
  if (u >= k.t) w = 0.0f;

  const long long o = b * HW + p;
  label[o] = count == 1 ? index : ignore_label;
  wgt[o] = w;
  unc[o] = u;
}

}  // namespace

// probs: f32 on the device, element (b, c, y, x) at b*sB + c*sC + y*sH +
// x*sW (any layout); thr: (B, C) f32 contiguous on the device; label (int32),
// w and u (f32): (B, H, W) contiguous on the device. m, t, cl, cr, e as the
// Weights fields above.
extern "C" int uemda_uvem_mine(const void* probs, const void* thr, void* label,
                               void* w, void* u, int B, int C, int H, int W,
                               long long sB, long long sC, long long sH,
                               long long sW, float m, float t, float cl,
                               float cr, float e, int has_left, int has_right,
                               int ignore_label, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || B > 65535 || C > 4096)
    return cudaErrorInvalidValue;
  const long long HW = static_cast<long long>(H) * W;
  const long long blocks = (HW + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Weights k{m, t, cl, cr, e, has_left, has_right};
  const dim3 grid(static_cast<unsigned>(blocks), B);
  uvem_mine_kernel<<<grid, kThreads, C * sizeof(float), s>>>(
      static_cast<const float*>(probs), static_cast<const float*>(thr),
      static_cast<int*>(label), static_cast<float*>(w), static_cast<float*>(u),
      C, H, W, sB, sC, sH, sW, k, ignore_label);
  return cudaGetLastError();
}
