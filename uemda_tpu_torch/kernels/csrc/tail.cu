// K3: eval tail -- bilinear upsample (align_corners=True) of the stacked
// head logits, f32 softmax per head, mean over the heads.
//
// Replaces uemda_tpu/ops/pallas_tail.py:tail_upsample_softmax_mean
// (_tail_kernel), the eval tail of infer/fastpath.serving_forward and of
// models/deeplabv2.DeeplabV2 in eval mode (reference Encoder.py:152-155).
//
// Bound on the H100: bytes. The input is small (B x 32 x 32 x g*nc at a
// 512x512 tile, 24 KiB in bf16); the floor is writing the (B, Ho, Wo, nc)
// probabilities once (3 MiB in bf16 per tile). The ~3.1 M exponentials per
// tile are ~6 us of the SFU's rate on the whole card -- below the write.
//
// Design: one thread per output pixel. It samples the four neighbouring
// low-resolution logits of every channel straight from global memory (they
// stay in L1/L2), interpolates in f32, takes a max-subtracted softmax per
// head in unrounded f32, averages the heads and rounds once at the store --
// the Pallas kernel's math (pallas_tail.py:21-24). Full-resolution logits
// never exist in global memory; there is no interpolation matrix and no
// H-expansion pass (the TPU kernel's two stages were shaped by its MXU).
//
// Layout: cat (B, Hi, Wi, g*nc) and out (B, Ho, Wo, nc), NHWC in memory.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNC = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_kernel(const T* __restrict__ cat, T* __restrict__ out, int B, int Hi,
            int Wi, int Ho, int Wo, int g, int nc, float sh, float sw) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * Ho * Wo) return;
  const int xo = static_cast<int>(idx % Wo);
  const int yo = static_cast<int>((idx / Wo) % Ho);
  const int b = static_cast<int>(idx / (static_cast<size_t>(Wo) * Ho));

  // align_corners=True source coordinate: o * (in - 1) / (out - 1)
  const float fy = yo * sh, fx = xo * sw;
  const int y0 = min(static_cast<int>(fy), Hi - 1);
  const int x0 = min(static_cast<int>(fx), Wi - 1);
  const int y1 = min(y0 + 1, Hi - 1), x1 = min(x0 + 1, Wi - 1);
  const float ly = fy - y0, lx = fx - x0;

  const int C = g * nc;
  const T* p00 = cat + ((static_cast<size_t>(b) * Hi + y0) * Wi + x0) * C;
  const T* p01 = cat + ((static_cast<size_t>(b) * Hi + y0) * Wi + x1) * C;
  const T* p10 = cat + ((static_cast<size_t>(b) * Hi + y1) * Wi + x0) * C;
  const T* p11 = cat + ((static_cast<size_t>(b) * Hi + y1) * Wi + x1) * C;

  float acc[kMaxNC];
#pragma unroll
  for (int c = 0; c < kMaxNC; ++c) acc[c] = 0.f;
  for (int h = 0; h < g; ++h) {
    float v[kMaxNC];
    float m = -FLT_MAX;
#pragma unroll
    for (int c = 0; c < kMaxNC; ++c) {
      if (c < nc) {
        const int k = h * nc + c;
        // along H first, then W, as the reference's separable resize
        const float left = (1.f - ly) * to_f32(p00[k]) + ly * to_f32(p10[k]);
        const float right = (1.f - ly) * to_f32(p01[k]) + ly * to_f32(p11[k]);
        v[c] = (1.f - lx) * left + lx * right;
        m = fmaxf(m, v[c]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxNC; ++c) {
      if (c < nc) {
        v[c] = expf(v[c] - m);
        s += v[c];
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxNC; ++c)
      if (c < nc) acc[c] += v[c] / s;
  }
  T* o = out + idx * nc;
#pragma unroll
  for (int c = 0; c < kMaxNC; ++c)
    if (c < nc) o[c] = from_f32<T>(acc[c] / g);
}

template <typename T>
cudaError_t launch(const void* cat, void* out, int B, int Hi, int Wi, int Ho,
                   int Wo, int g, int nc, float sh, float sw,
                   cudaStream_t stream) {
  const size_t n = static_cast<size_t>(B) * Ho * Wo;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  tail_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(cat), static_cast<T*>(out), B, Hi, Wi, Ho, Wo, g,
      nc, sh, sw);
  return cudaGetLastError();
}

}  // namespace

// cat: (B, Hi, Wi, g*nc); out: (B, Ho, Wo, nc); nc <= 16. sh, sw are the
// align_corners=True scales (in - 1) / (out - 1), 0 for an output of 1.
extern "C" int uemda_tail(const void* cat, void* out, int B, int Hi, int Wi,
                          int Ho, int Wo, int g, int nc, float sh, float sw,
                          int is_bf16, void* stream) {
  if (nc <= 0 || nc > kMaxNC || g <= 0 || B <= 0 || Ho <= 0 || Wo <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(cat, out, B, Hi, Wi, Ho, Wo, g, nc,
                                         sh, sw, s)
                 : launch<float>(cat, out, B, Hi, Wi, Ho, Wo, g, nc, sh, sw, s);
}
