// K1: affine-free instance norm, one read and one write of the activation.
//
// Replaces uemda_tpu/ops/pallas_insnorm.py:instance_norm_1read (_in_kernel),
// the drop-in for models/deeplabv2.py:instance_norm (torch InstanceNorm2d
// defaults: per (sample, channel) over H x W, eps 1e-5, no affine).
//
// Bound on the H100: bytes. The work is ~4 flops per element against 2-4
// bytes read and written, far below the card's ~295 flop/byte ridge, so the
// floor is one read plus one write of (B, H, W, C) at 3.35 TB/s.
//
// Design: one block per (sample, chunk of CB channels). The block stages
// the whole (H*W, CB) slab in shared memory (32x32 px x 64 bf16 channels =
// 128 KB of the 227 KB a block may use) while it sums for the mean, takes the
// mean of squared deviations from shared memory (two-pass f32 statistics --
// never E[x^2]-E[x]^2, which cancels catastrophically for high-mean,
// low-variance channels, models/deeplabv2.py:35-37), and writes the
// normalized slab once, rounded once to the storage type. When the slab does
// not fit (large maps), the same kernel reads global memory again for each
// pass instead (SMEM=false): three reads, still no library call.
//
// Layout: NHWC in memory (a channels_last tensor). Thread t handles channel
// t % CB of the chunk for pixels t / CB, t / CB + GROUPS, ...; neighbouring
// threads read neighbouring channels of one pixel.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int CB, bool SMEM>
__global__ void __launch_bounds__(kThreads)
instance_norm_kernel(const T* __restrict__ x, T* __restrict__ y, int HW,
                     int C, float eps) {
  constexpr int GROUPS = kThreads / CB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);  // [HW][CB], used when SMEM
  __shared__ float red[GROUPS][CB];
  __shared__ float stat[CB];

  const int nchunk = C / CB;
  const int b = blockIdx.x / nchunk;
  const int c0 = (blockIdx.x % nchunk) * CB;
  const int lc = threadIdx.x % CB;
  const int g = threadIdx.x / CB;
  const size_t base = static_cast<size_t>(b) * HW * C + c0 + lc;

  float s = 0.f;
  for (int p = g; p < HW; p += GROUPS) {
    const T v = x[base + static_cast<size_t>(p) * C];
    if (SMEM) slab[p * CB + lc] = v;
    s += to_f32(v);
  }
  red[g][lc] = s;
  __syncthreads();
  if (g == 0) {
    float t = 0.f;
    for (int i = 0; i < GROUPS; ++i) t += red[i][lc];
    stat[lc] = t / HW;
  }
  __syncthreads();
  const float mean = stat[lc];

  float q = 0.f;
  for (int p = g; p < HW; p += GROUPS) {
    const float d = to_f32(SMEM ? slab[p * CB + lc]
                                : x[base + static_cast<size_t>(p) * C]) - mean;
    q += d * d;
  }
  red[g][lc] = q;
  __syncthreads();
  if (g == 0) {
    float t = 0.f;
    for (int i = 0; i < GROUPS; ++i) t += red[i][lc];
    stat[lc] = rsqrtf(t / HW + eps);
  }
  __syncthreads();
  const float rs = stat[lc];

  for (int p = g; p < HW; p += GROUPS) {
    const size_t i = base + static_cast<size_t>(p) * C;
    const float v = to_f32(SMEM ? slab[p * CB + lc] : x[i]);
    y[i] = from_f32<T>((v - mean) * rs);
  }
}

constexpr size_t kSmemLimit = 200 * 1024;

template <typename T, int CB>
cudaError_t launch_cb(const void* x, void* y, int B, int HW, int C, float eps,
                      cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(HW) * CB * sizeof(T);
  const dim3 grid(B * (C / CB));
  if (bytes <= kSmemLimit) {
    auto k = instance_norm_kernel<T, CB, true>;
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    k<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x),
                                         static_cast<T*>(y), HW, C, eps);
  } else {
    instance_norm_kernel<T, CB, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), HW, C, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* y, int B, int HW, int C, float eps,
                   cudaStream_t stream) {
  // widest chunk whose slab fits in shared memory; 32 otherwise
  if (C % 64 == 0 && static_cast<size_t>(HW) * 64 * sizeof(T) <= kSmemLimit)
    return launch_cb<T, 64>(x, y, B, HW, C, eps, stream);
  return launch_cb<T, 32>(x, y, B, HW, C, eps, stream);
}

}  // namespace

// x, y: (B, H*W, C) contiguous (a channels_last NCHW tensor); C % 32 == 0.
extern "C" int uemda_instance_norm(const void* x, void* y, int B, int HW,
                                   int C, int is_bf16, float eps,
                                   void* stream) {
  if (C % 32 != 0 || B <= 0 || HW <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, y, B, HW, C, eps, s)
                 : launch<float>(x, y, B, HW, C, eps, s);
}
