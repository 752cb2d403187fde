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
// Backward design. Each (sample, chunk of CB channels) needs two f32 sums
// over all of H x W before it can write any of dx, and x and dy should come
// from device memory once each. The slab's H x W is split across a thread
// block cluster of `cluster` CTAs (at most 8, the portable size), each
// taking ppc = ceil(H*W / cluster) consecutive pixels (the last may hold
// fewer, or none). A CTA copies its part of x and dy into shared memory with
// 16-byte cp.async copies, all issued before the first wait (32-64 KB in
// flight a CTA, where one CTA a slab with 2-byte loads kept ~1 KB in flight
// a SM), and forms its partial sum(dy) and sum(dy * xhat) per channel: 16
// bytes a thread a step, a warp shuffle, then the warps through shared
// memory. The CTAs exchange
// the partial sums through distributed shared memory (2 floats a channel,
// map_shared_rank between two cluster barriers), each adding them in rank
// order, so every CTA of the cluster holds the same sums. Each CTA then
// writes its part of dx from shared memory with 16-byte stores. A part too
// large for shared memory even split 8 ways takes the global-memory route
// of the same kernel (SMEM=false): the same cluster split, with x and dy
// read from device memory again for dx. The launch plan (grid, cluster,
// CB, ppc, shared-memory bytes, route) is computed in Python
// (ops/insnorm.py: instance_norm_backward_plan); the launcher checks it.
// Rounding contract, unchanged: xhat from the forward's f32 mean and rstd,
// bit for bit; f32 sums (in another order than a single CTA's); dx
// rounded once to x's dtype.
//
// Layout: NHWC in memory (a channels_last tensor). In the forward, thread t
// handles channel t % CB of the chunk for pixels t / CB, t / CB + GROUPS,
// ...; in the backward, the 16-byte column t % VPR of a pixel's chunk (VPR
// = CB * sizeof(T) / 16) for pixels t / VPR, + G, ...; either way,
// neighbouring threads read neighbouring channels of one pixel.

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

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

// 16 bytes of T: 8 bf16 or 4 f32 values, unpacked to f32 and packed back
// (bf16 rounded to nearest even, as from_f32)
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static unsigned pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One CTA: sample blockIdx.y, channels [c0, c0 + CB) of chunk blockIdx.x /
// cluster, pixels [rank * ppc, min(HW, (rank + 1) * ppc)) of the slab.
// Thread t takes the 16-byte column t % VPR of pixels t / VPR, + G, ...
template <typename T, int CB, bool SMEM>
__global__ void __launch_bounds__(kThreads)
instance_norm_backward_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              T* __restrict__ dx, int HW, int C, int cluster,
                              int ppc) {
  using V = Vec16<T>;
  constexpr int EPV = V::N;                // values a 16-byte vector
  constexpr int VPR = CB / EPV;            // vectors a pixel's chunk
  constexpr int G = kThreads / VPR;        // pixel groups of the CTA
  constexpr int WARPS = kThreads / 32;
  static_assert(VPR <= 32 && 32 % VPR == 0, "a warp holds whole rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* xs = reinterpret_cast<uint4*>(smem_raw);  // [ppc][VPR], if SMEM
  uint4* ds = xs + static_cast<size_t>(ppc) * VPR;  // [ppc][VPR], if SMEM
  __shared__ float red[2][WARPS][CB];
  __shared__ float part[2][CB];  // this CTA's sums, read by the cluster
  __shared__ float stat[2][CB];  // the slab's mean(dy), mean(dy * xhat)

  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int b = blockIdx.y;
  const int c0 = (blockIdx.x / cluster) * CB;
  const int p0 = rank * ppc;
  const int np = max(0, min(ppc, HW - p0));
  const size_t base = (static_cast<size_t>(b) * HW + p0) * C + c0;
  const T* xb = x + base;
  const T* db = dy + base;
  const int j = threadIdx.x % VPR;
  const int g = threadIdx.x / VPR;

  if (SMEM) {
    for (int v = threadIdx.x; v < np * VPR; v += kThreads) {
      const size_t off = static_cast<size_t>(v / VPR) * C + (v % VPR) * EPV;
      cp_async16(xs + v, xb + off);
      cp_async16(ds + v, db + off);
    }
  }
  float mu[EPV], rs[EPV];
  {
    const size_t sb = static_cast<size_t>(b) * C + c0 + j * EPV;
#pragma unroll
    for (int e = 0; e < EPV; e += 4) {
      const float4 m = __ldg(reinterpret_cast<const float4*>(mean + sb + e));
      const float4 r = __ldg(reinterpret_cast<const float4*>(rstd + sb + e));
      mu[e] = m.x; mu[e + 1] = m.y; mu[e + 2] = m.z; mu[e + 3] = m.w;
      rs[e] = r.x; rs[e + 1] = r.y; rs[e + 2] = r.z; rs[e + 3] = r.w;
    }
  }
  if (SMEM) {
    cp_async_wait_all();
    __syncthreads();
  }
  auto load = [&](int p, float* xf, float* df) {
    uint4 xv, dv;
    if (SMEM) {
      xv = xs[p * VPR + j];
      dv = ds[p * VPR + j];
    } else {
      const size_t off = static_cast<size_t>(p) * C + j * EPV;
      xv = __ldg(reinterpret_cast<const uint4*>(xb + off));
      dv = __ldg(reinterpret_cast<const uint4*>(db + off));
    }
    V::unpack(xv, xf);
    V::unpack(dv, df);
  };

  float s1[EPV], s2[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) s1[e] = s2[e] = 0.f;
  for (int p = g; p < np; p += G) {
    float xf[EPV], df[EPV];
    load(p, xf, df);
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      s1[e] += df[e];
      s2[e] += df[e] * ((xf[e] - mu[e]) * rs[e]);
    }
  }
  // lanes j, j + VPR, ... of a warp hold the same channels
#pragma unroll
  for (int o = VPR; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
      s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < VPR) {
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      red[0][warp][j * EPV + e] = s1[e];
      red[1][warp][j * EPV + e] = s2[e];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * CB) {
    const int k = threadIdx.x / CB, c = threadIdx.x % CB;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += red[k][w][c];
    part[k][c] = t;
  }
  cl.sync();  // every CTA's partial sums are in its shared memory
  if (threadIdx.x < 2 * CB) {
    const int k = threadIdx.x / CB, c = threadIdx.x % CB;
    float t = 0.f;
    for (int r = 0; r < cluster; ++r) t += cl.map_shared_rank(&part[k][0], r)[c];
    stat[k][c] = t / HW;
  }
  cl.sync();  // no CTA leaves while another reads its sums; stat is visible

  float m1[EPV], m2[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    m1[e] = stat[0][j * EPV + e];
    m2[e] = stat[1][j * EPV + e];
  }
  T* ob = dx + base;
  for (int p = g; p < np; p += G) {
    float xf[EPV], df[EPV], o[EPV];
    load(p, xf, df);
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const float xh = (xf[e] - mu[e]) * rs[e];
      o[e] = rs[e] * (df[e] - m1[e] - xh * m2[e]);
    }
    *reinterpret_cast<uint4*>(ob + static_cast<size_t>(p) * C + j * EPV) =
        V::pack(o);
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

template <typename T, int CB, bool SMEM>
cudaError_t launch_backward(const void* x, const void* dy, const float* mean,
                            const float* rstd, void* dx, int HW, int C,
                            int cluster, int ppc, int smem, dim3 grid,
                            cudaStream_t stream) {
  auto k = instance_norm_backward_kernel<T, CB, SMEM>;
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, k, &cfg);
  if (e != cudaSuccess) return e;
  if (active == 0) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&cfg, k, static_cast<const T*>(x),
                            static_cast<const T*>(dy), mean, rstd,
                            static_cast<T*>(dx), HW, C, cluster, ppc);
}

template <typename T>
cudaError_t launch_backward_plan(const void* x, const void* dy,
                                 const float* mean, const float* rstd,
                                 void* dx, int HW, int C, int cb, int cluster,
                                 int ppc, int smem, bool shared, dim3 grid,
                                 cudaStream_t s) {
  if (cb == 64)
    return shared ? launch_backward<T, 64, true>(x, dy, mean, rstd, dx, HW, C,
                                                 cluster, ppc, smem, grid, s)
                  : launch_backward<T, 64, false>(x, dy, mean, rstd, dx, HW,
                                                  C, cluster, ppc, smem, grid,
                                                  s);
  return shared ? launch_backward<T, 32, true>(x, dy, mean, rstd, dx, HW, C,
                                               cluster, ppc, smem, grid, s)
                : launch_backward<T, 32, false>(x, dy, mean, rstd, dx, HW, C,
                                                cluster, ppc, smem, grid, s);
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
// forward. plan (n = 7 ints, from ops/insnorm.py: instance_norm_backward_plan):
// CB (32 or 64, dividing C), cluster (1-8), pixels a CTA (ceil(HW /
// cluster)), dynamic shared-memory bytes (2 * ppc * CB * sizeof(T) on the
// shared-memory route, 0 on the global one), route (1 shared, 0 global),
// grid x (cluster * C / CB), grid y (B). Anything else is refused.
extern "C" int uemda_instance_norm_backward(const void* x, const void* dy,
                                            const void* mean, const void* rstd,
                                            void* dx, int B, int HW, int C,
                                            int is_bf16, const int* plan,
                                            int n, void* stream) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || !plan || n != 7)
    return cudaErrorInvalidValue;
  const int cb = plan[0], cluster = plan[1], ppc = plan[2], smem = plan[3];
  const int route = plan[4];
  const dim3 grid(plan[5], plan[6]);
  const long long esz = is_bf16 ? 2 : 4;
  if ((cb != 32 && cb != 64) || C % cb != 0 || cluster < 1 || cluster > 8 ||
      ppc != (HW + cluster - 1) / cluster || (route != 0 && route != 1) ||
      smem != (route ? 2LL * ppc * cb * esz : 0LL) ||
      static_cast<long long>(grid.x) != static_cast<long long>(cluster) * (C / cb) ||
      static_cast<int>(grid.y) != B)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  return is_bf16 ? launch_backward_plan<__nv_bfloat16>(
                       x, dy, m, r, dx, HW, C, cb, cluster, ppc, smem,
                       route == 1, grid, s)
                 : launch_backward_plan<float>(x, dy, m, r, dx, HW, C, cb,
                                               cluster, ppc, smem, route == 1,
                                               grid, s);
}
