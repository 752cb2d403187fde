// K1: affine-free instance norm, one read and one write of the activation,
// and its backward.
//
// Replaces uemda_tpu/ops/pallas_insnorm.py:instance_norm_1read (_in_kernel),
// the drop-in for models/deeplabv2.py:instance_norm (torch InstanceNorm2d
// defaults: per (sample, channel) over H x W, eps 1e-5, no affine). The
// Pallas kernel is forward-only; the backward computes the cotangent that
// jax.grad of deeplabv2.py:26-43 gives:
//   dx = rstd * (dy - mean(dy) - xhat * mean(dy * xhat)),  xhat = (x - mean) * rstd
// with f32 statistics over H x W and dx rounded once to x's dtype.
//
// Bound on the H100: bytes, for both. The forward does ~4 flops per element
// against 2-4 bytes read and written, the backward ~10 against 6-12 bytes,
// far below the card's ~295 flop/byte ridge: the floor is one read of each
// input and one write of the output at 3.35 TB/s.
//
// Forward design: one block per (sample, chunk of CB channels). The block
// stages the whole (H*W, CB) slab in shared memory (32x32 px x 64 bf16
// channels = 128 KB of the 227 KB a block may use) while it sums for the
// mean, takes the mean of squared deviations from shared memory (two-pass f32
// statistics -- never E[x^2]-E[x]^2, which cancels catastrophically for
// high-mean, low-variance channels, models/deeplabv2.py:35-37), and writes
// the normalized slab once, rounded once to the storage type. When the slab
// does not fit (large maps), the same kernel reads global memory again for
// each pass instead (SMEM=false): three reads, still no library call. It
// also writes the f32 mean and rstd of every (sample, channel), 8 bytes per
// channel, which the backward reads instead of recomputing them: its xhat is
// then bit for bit the forward's.
//
// Backward design: the same block shape with CB = 32. Pass 1 reads x and dy
// once, stages both slabs in shared memory (2 x 32x32 px x 32 bf16 channels
// = 128 KB) and sums dy and dy * xhat; pass 2 writes dx from shared memory.
// The global-memory route (SMEM=false) serves slabs that do not fit, f32 at
// 32x32 among them (256 KB).
//
// Layout: NHWC in memory (a channels_last tensor). Thread t handles channel
// t % CB of the chunk for pixels t / CB, t / CB + GROUPS, ...; neighbouring
// threads read neighbouring channels of one pixel.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 200 * 1024;

template <typename T, int CB, bool SMEM>
__global__ void __launch_bounds__(kThreads)
instance_norm_kernel(const T* __restrict__ x, T* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out,
                     int HW, int C, float eps) {
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
    const float rs = rsqrtf(t / HW + eps);
    stat[lc] = rs;
    mean_out[static_cast<size_t>(b) * C + c0 + lc] = mean;
    rstd_out[static_cast<size_t>(b) * C + c0 + lc] = rs;
  }
  __syncthreads();
  const float rs = stat[lc];

  for (int p = g; p < HW; p += GROUPS) {
    const size_t i = base + static_cast<size_t>(p) * C;
    const float v = to_f32(SMEM ? slab[p * CB + lc] : x[i]);
    y[i] = from_f32<T>((v - mean) * rs);
  }
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(kThreads)
instance_norm_backward_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              T* __restrict__ dx, int HW, int C) {
  constexpr int CB = 32;
  constexpr int GROUPS = kThreads / CB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);     // [HW][CB], used when SMEM
  T* ds = xs + static_cast<size_t>(HW) * CB;  // [HW][CB], used when SMEM
  __shared__ float red[2][GROUPS][CB];
  __shared__ float stat[2][CB];

  const int nchunk = C / CB;
  const int b = blockIdx.x / nchunk;
  const int c0 = (blockIdx.x % nchunk) * CB;
  const int lc = threadIdx.x % CB;
  const int g = threadIdx.x / CB;
  const size_t base = static_cast<size_t>(b) * HW * C + c0 + lc;
  const float mu = mean[static_cast<size_t>(b) * C + c0 + lc];
  const float rs = rstd[static_cast<size_t>(b) * C + c0 + lc];

  float s1 = 0.f, s2 = 0.f;
  for (int p = g; p < HW; p += GROUPS) {
    const size_t i = base + static_cast<size_t>(p) * C;
    const T xv = x[i];
    const T dv = dy[i];
    if (SMEM) {
      xs[p * CB + lc] = xv;
      ds[p * CB + lc] = dv;
    }
    const float d = to_f32(dv);
    s1 += d;
    s2 += d * ((to_f32(xv) - mu) * rs);
  }
  red[0][g][lc] = s1;
  red[1][g][lc] = s2;
  __syncthreads();
  if (g == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < GROUPS; ++i) {
      t1 += red[0][i][lc];
      t2 += red[1][i][lc];
    }
    stat[0][lc] = t1 / HW;
    stat[1][lc] = t2 / HW;
  }
  __syncthreads();
  const float m1 = stat[0][lc];
  const float m2 = stat[1][lc];

  for (int p = g; p < HW; p += GROUPS) {
    const size_t i = base + static_cast<size_t>(p) * C;
    const float xv = to_f32(SMEM ? xs[p * CB + lc] : x[i]);
    const float d = to_f32(SMEM ? ds[p * CB + lc] : dy[i]);
    const float xh = (xv - mu) * rs;
    dx[i] = from_f32<T>(rs * (d - m1 - xh * m2));
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int CB>
cudaError_t launch_cb(const void* x, void* y, float* mean, float* rstd, int B,
                      int HW, int C, float eps, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(HW) * CB * sizeof(T);
  const dim3 grid(B * (C / CB));
  if (bytes <= kSmemLimit) {
    auto k = instance_norm_kernel<T, CB, true>;
    cudaError_t e = allow_smem(k, bytes);
    if (e != cudaSuccess) return e;
    k<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x),
                                         static_cast<T*>(y), mean, rstd, HW, C,
                                         eps);
  } else {
    instance_norm_kernel<T, CB, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), mean, rstd, HW, C, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* y, float* mean, float* rstd, int B,
                   int HW, int C, float eps, cudaStream_t stream) {
  // widest chunk whose slab fits in shared memory; 32 otherwise
  if (C % 64 == 0 && static_cast<size_t>(HW) * 64 * sizeof(T) <= kSmemLimit)
    return launch_cb<T, 64>(x, y, mean, rstd, B, HW, C, eps, stream);
  return launch_cb<T, 32>(x, y, mean, rstd, B, HW, C, eps, stream);
}

template <typename T>
cudaError_t launch_backward(const void* x, const void* dy, const float* mean,
                            const float* rstd, void* dx, int B, int HW, int C,
                            cudaStream_t stream) {
  const size_t bytes = 2 * static_cast<size_t>(HW) * 32 * sizeof(T);
  const dim3 grid(B * (C / 32));
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  T* out = static_cast<T*>(dx);
  if (bytes <= kSmemLimit) {
    auto k = instance_norm_backward_kernel<T, true>;
    cudaError_t e = allow_smem(k, bytes);
    if (e != cudaSuccess) return e;
    k<<<grid, kThreads, bytes, stream>>>(xt, dt, mean, rstd, out, HW, C);
  } else {
    instance_norm_backward_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, dt, mean, rstd, out, HW, C);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, H*W, C) contiguous (a channels_last NCHW tensor); C % 32 == 0.
// mean, rstd: (B, C) f32 outputs.
extern "C" int uemda_instance_norm(const void* x, void* y, void* mean,
                                   void* rstd, int B, int HW, int C,
                                   int is_bf16, float eps, void* stream) {
  if (C % 32 != 0 || B <= 0 || HW <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  return is_bf16 ? launch<__nv_bfloat16>(x, y, m, r, B, HW, C, eps, s)
                 : launch<float>(x, y, m, r, B, HW, C, eps, s);
}

// x, dy, dx: (B, H*W, C) contiguous; mean, rstd: (B, C) f32 from the
// forward; C % 32 == 0.
extern "C" int uemda_instance_norm_backward(const void* x, const void* dy,
                                            const void* mean, const void* rstd,
                                            void* dx, int B, int HW, int C,
                                            int is_bf16, void* stream) {
  if (C % 32 != 0 || B <= 0 || HW <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  return is_bf16
             ? launch_backward<__nv_bfloat16>(x, dy, m, r, dx, B, HW, C, s)
             : launch_backward<float>(x, dy, m, r, dx, B, HW, C, s);
}
