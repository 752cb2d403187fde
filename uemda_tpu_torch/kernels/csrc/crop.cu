// K9: per-sample window crop + per-channel normalize of raw RGB tiles.
//
// Replaces uemda_tpu/ops/pallas_kernels.py:crop_normalize_pallas
// (_crop_norm_kernel): from (B, H, W, 3) raw images (uint8, as the loader
// ships them, or f32) and (B, 2) int32 (y, x) offsets, writes the
// (B, th, tw, 3) f32 tile (x - mean[c]) * inv_std[c], inv_std = 1/std in f32,
// and with `clamp` min(that, 1.0): the stage-3 target Normalize of the ISPRS
// configs (uemda_tpu/datasets/augment.py:25-31), fused into the epilogue.
// The (B, th, tw, 3) output is the NHWC memory of the channels_last
// (B, 3, th, tw) tensor the model takes.
//
// Bound on the H100: bytes. One subtract and one multiply per element
// against 1 (uint8) or 4 (f32) bytes read and 4 written; at the training
// shape (8 crops of 512^2 from 1024^2 uint8 tiles) the floor is
// 8*512^2*3 B read + 8*512^2*3*4 B written = 31.5 MB, ~9.4 us at 3.35 TB/s.
//
// Design: the Pallas kernel's aligned superset DMA and its roll are Mosaic
// workarounds (the TPU's DMA wants 8/128-aligned windows) and are not carried
// over. One block per (output row, sample): a crop row is one contiguous run
// of tw*3 elements in the source, so neighbouring threads read neighbouring
// bytes (coalesced). Where the row's source and destination addresses are
// 16-byte aligned, each thread loads 16 bytes (16 uint8 or 4 f32 values) and
// stores the matching f32 values as float4s; otherwise one element a thread.
// The window origins are read from a (B, 2) int32 array in device memory
// (the TPU kernel's scalar prefetch), so a CUDA graph that captured the
// launch replays it with whatever origins the step wrote there. The host
// checks the windows before it uploads them; a window outside the image
// that reaches the kernel all the same writes NaN rows and reads nothing.

#include "common.cuh"

// beside common.cuh's float and bf16 overloads (a declaration inside the
// anonymous namespace would hide them from the kernel)
__device__ __forceinline__ float to_f32(unsigned char v) {
  return static_cast<float>(v);
}

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float pick(int c, float a, float b, float d) {
  return c == 0 ? a : (c == 1 ? b : d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
crop_normalize_kernel(const T* __restrict__ img, const int* __restrict__ off,
                      float* __restrict__ out, int H, int W, int th, int tw,
                      float m0, float m1, float m2, float s0, float s1,
                      float s2, bool clamp) {
  constexpr int V = 16 / sizeof(T);  // elements in one 16-byte load
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const int y0 = off[2 * b];
  const int x0 = off[2 * b + 1];
  const int y = y0 + r;
  float* dst = out + (static_cast<size_t>(b) * th + r) * tw * 3;
  const int n = tw * 3;
  if (y0 < 0 || x0 < 0 || y0 > H - th || x0 > W - tw) {
    for (int i = threadIdx.x; i < n; i += kThreads)
      dst[i] = __int_as_float(0x7fc00000);
    return;
  }
  const T* src = img + (static_cast<size_t>(b) * H + y) * W * 3 +
                 static_cast<size_t>(x0) * 3;

  const bool vec = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(dst) % 16 == 0) && (n % V == 0);
  if (vec) {
    for (int v = threadIdx.x; v < n / V; v += kThreads) {
      const uint4 q = reinterpret_cast<const uint4*>(src)[v];
      const T* e = reinterpret_cast<const T*>(&q);
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = (v * V + j) % 3;
        o[j] = (to_f32(e[j]) - pick(c, m0, m1, m2)) * pick(c, s0, s1, s2);
        if (clamp) o[j] = fminf(o[j], 1.0f);
      }
#pragma unroll
      for (int j = 0; j < V / 4; ++j)
        reinterpret_cast<float4*>(dst)[v * (V / 4) + j] =
            make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int c = i % 3;
      const float o = (to_f32(src[i]) - pick(c, m0, m1, m2)) * pick(c, s0, s1, s2);
      dst[i] = clamp ? fminf(o, 1.0f) : o;
    }
  }
}

}  // namespace

// img: (B, H, W, 3) contiguous uint8 (is_u8) or f32 on the device;
// off: (B, 2) int32 (y, x) origins, contiguous, on the device, each window
// inside the image (the host checks them before their upload); out:
// (B, th, tw, 3) f32 contiguous on the device; clamp != 0 caps every output
// at 1.0.
extern "C" int uemda_crop_normalize(const void* img, const void* off,
                                    void* out, int B, int H, int W, int th,
                                    int tw, int is_u8, float m0, float m1,
                                    float m2, float s0, float s1, float s2,
                                    int clamp, void* stream) {
  if (B <= 0 || B > 65535 || th <= 0 || tw <= 0 || th > H || tw > W)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(th, B);
  const int* o = static_cast<const int*>(off);
  float* dst = static_cast<float*>(out);
  if (is_u8)
    crop_normalize_kernel<unsigned char><<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(img), o, dst, H, W, th, tw, m0, m1,
        m2, s0, s1, s2, clamp != 0);
  else
    crop_normalize_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(img), o, dst, H, W, th, tw, m0, m1, m2, s0,
        s1, s2, clamp != 0);
  return cudaGetLastError();
}
