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
// Design, the same for both. Each (sample, chunk of CB channels) slab needs
// sums over all of H x W before it can write any output, and each input
// should come from device memory once. The slab's H x W is split across a
// thread block cluster of `cluster` CTAs (at most 8, the portable size),
// each taking ppc = ceil(H*W / cluster) consecutive pixels (the last may
// hold fewer, or none, and still joins every barrier). A CTA copies its part
// of the inputs into shared memory with 16-byte cp.async copies, all issued
// before the first wait (tens of KB in flight a CTA, where one CTA a slab
// with 2-byte loads kept ~1 KB in flight a SM; the bf16 forward waits for
// them in four groups and sums each as it lands), and forms its partial
// per-channel sums: 16 bytes a thread a step, a warp shuffle, then the warps
// through shared memory (cta_sums). The CTAs exchange the partial sums
// through distributed shared memory (cluster_sums: map_shared_rank after a
// cluster barrier), each adding them in rank order, so every CTA of the
// cluster holds the same sums. Each CTA then writes its part of the output
// from shared memory with 16-byte stores. A part too large for shared
// memory even split 8 ways takes the global-memory route of the same kernel
// (SMEM=false): the same cluster split, with the inputs read from device
// memory again for each pass. The launch plans (grid, cluster, CB, ppc,
// shared-memory bytes, route) are computed in Python (ops/insnorm.py:
// instance_norm_forward_plan, instance_norm_backward_plan); the launchers
// check them.
//
// Forward: x only is staged. Sum of x, exchanged: the mean; then the sum of
// squared deviations about that mean from shared memory, exchanged: the
// variance. Two-pass f32 statistics -- never E[x^2]-E[x]^2, which cancels
// catastrophically for high-mean, low-variance channels
// (models/deeplabv2.py:35-37) -- in another summation order than one CTA's;
// y rounded once to the storage type. Rank 0 also writes the f32 mean and
// rstd of every (sample, channel), 8 bytes per channel, which the backward
// reads instead of recomputing them: its xhat is then bit for bit the
// forward's.
//
// Backward: x and dy are staged; sum(dy) and sum(dy * xhat) are formed and
// exchanged together, with xhat from the forward's f32 mean and rstd; dx
// rounded once to x's dtype.
//
// Layout: NHWC in memory (a channels_last tensor). Thread t takes the
// 16-byte column t % VPR of a pixel's chunk (VPR = CB * sizeof(T) / 16) for
// pixels t / VPR, + G, ...: neighbouring threads read neighbouring channels
// of one pixel.

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int WARPS = kThreads / 32;  // warps a CTA

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n (0-3, a constant after unrolling) of this thread's
// committed copy groups are still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Copies pixels [p0, p1) x CB channels of a CTA's part at src (row stride C
// values) into dst[p][VPR] with 16-byte cp.async copies, none waited for.
template <typename T, int CB>
__device__ __forceinline__ void stage_part(uint4* dst, const T* src, int p0,
                                           int p1, int C) {
  constexpr int EPV = Vec16<T>::N;
  constexpr int VPR = CB / EPV;
  for (int v = p0 * VPR + threadIdx.x; v < p1 * VPR; v += kThreads)
    cp_async16(dst + v,
               src + static_cast<size_t>(v / VPR) * C + (v % VPR) * EPV);
}

// The CTA's sums of K per-thread partial sums s[k][e] (channel j * EPV + e
// of the chunk, thread column j = t % VPR): a warp shuffle over the lanes
// j, j + VPR, ... that hold the same channels, then the warps through red;
// threads < K * CB write them to part[k][c]. Ends with every thread's red
// reads not yet done: the caller's next barrier orders them.
template <int K, int CB, int EPV>
__device__ __forceinline__ void cta_sums(float (&s)[K][EPV],
                                         float (*red)[WARPS][CB],
                                         float (*part)[CB]) {
  constexpr int VPR = CB / EPV;
  static_assert(VPR <= 32 && 32 % VPR == 0, "a warp holds whole rows");
#pragma unroll
  for (int o = VPR; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        s[k][e] += __shfl_xor_sync(0xffffffffu, s[k][e], o);
  }
  const int warp = threadIdx.x / 32;
  const int j = threadIdx.x % VPR;
  if (threadIdx.x % 32 < VPR) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < EPV; ++e) red[k][warp][j * EPV + e] = s[k][e];
  }
  __syncthreads();
  if (threadIdx.x < K * CB) {
    const int k = threadIdx.x / CB, c = threadIdx.x % CB;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += red[k][w][c];
    part[k][c] = t;
  }
}

// The slab's sums: every CTA's part[k][c], read through distributed shared
// memory after a cluster barrier that makes them visible and added in rank
// order, so every CTA of the cluster gets the same stat[k][c] = sum / HW.
// The caller's next cluster barrier keeps each CTA's part alive until every
// CTA has read it (and makes stat visible to the CTA).
template <int K, int CB>
__device__ __forceinline__ void cluster_sums(cg::cluster_group& cl,
                                             float (*part)[CB],
                                             float (*stat)[CB], int cluster,
                                             int HW) {
  cl.sync();
  if (threadIdx.x < K * CB) {
    const int k = threadIdx.x / CB, c = threadIdx.x % CB;
    float t = 0.f;
    for (int r = 0; r < cluster; ++r)
      t += cl.map_shared_rank(&part[k][0], r)[c];
    stat[k][c] = t / HW;
  }
}

// Forward. One CTA: sample blockIdx.y, channels [c0, c0 + CB) of chunk
// blockIdx.x / cluster, pixels [rank * ppc, min(HW, (rank + 1) * ppc)) of
// the slab. Thread t takes the 16-byte column t % VPR of pixels t / VPR,
// + G, ...
template <typename T, int CB, bool SMEM>
__global__ void __launch_bounds__(kThreads)
instance_norm_kernel(const T* __restrict__ x, T* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out,
                     int HW, int C, int cluster, int ppc, float eps) {
  using V = Vec16<T>;
  constexpr int EPV = V::N;                // values a 16-byte vector
  constexpr int VPR = CB / EPV;            // vectors a pixel's chunk
  constexpr int G = kThreads / VPR;        // pixel groups of the CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* xs = reinterpret_cast<uint4*>(smem_raw);  // [ppc][VPR], if SMEM
  __shared__ float red[1][WARPS][CB];
  __shared__ float part[2][CB];  // this CTA's sums of x, of (x - mean)^2
  __shared__ float stat[2][CB];  // the slab's mean, variance

  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int b = blockIdx.y;
  const int c0 = (blockIdx.x / cluster) * CB;
  const int p0 = rank * ppc;
  const int np = max(0, min(ppc, HW - p0));
  const size_t base = (static_cast<size_t>(b) * HW + p0) * C + c0;
  const T* xb = x + base;
  const int j = threadIdx.x % VPR;
  const int g = threadIdx.x / VPR;

  // the part's pixels in kGroups copy groups, all issued at once; the sum
  // of x takes each group as it lands (bf16: 4% faster at the flagship
  // shape; f32, whose rows take 16 threads, 4% slower, so one group)
  constexpr int kGroups = SMEM && sizeof(T) == 2 ? 4 : 1;
  const int pg = (np + kGroups - 1) / kGroups;
  if (SMEM) {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      stage_part<T, CB>(xs, xb, min(np, k * pg), min(np, (k + 1) * pg), C);
      cp_async_commit();
    }
  }
  auto load = [&](int p, float* xf) {
    V::unpack(SMEM ? xs[p * VPR + j]
                   : __ldg(reinterpret_cast<const uint4*>(
                         xb + static_cast<size_t>(p) * C + j * EPV)),
              xf);
  };

  float s[1][EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) s[0][e] = 0.f;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    if (SMEM) {
      cp_async_wait_pending(kGroups - 1 - k);
      __syncthreads();
    }
    for (int p = k * pg + g; p < min(np, (k + 1) * pg); p += G) {
      float xf[EPV];
      load(p, xf);
#pragma unroll
      for (int e = 0; e < EPV; ++e) s[0][e] += xf[e];
    }
  }
  cta_sums<1, CB, EPV>(s, red, &part[0]);
  cluster_sums<1, CB>(cl, &part[0], &stat[0], cluster, HW);
  __syncthreads();  // the mean is visible; part[0] stays until the next
                    // cluster barrier, which every CTA reaches after reading

  float mu[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    mu[e] = stat[0][j * EPV + e];
    s[0][e] = 0.f;
  }
  for (int p = g; p < np; p += G) {
    float xf[EPV];
    load(p, xf);
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const float d = xf[e] - mu[e];
      s[0][e] += d * d;
    }
  }
  cta_sums<1, CB, EPV>(s, red, &part[1]);
  cluster_sums<1, CB>(cl, &part[1], &stat[1], cluster, HW);
  cl.sync();  // no CTA leaves while another reads its sums; stat is visible

  float rs[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) rs[e] = rsqrtf(stat[1][j * EPV + e] + eps);
  if (rank == 0 && threadIdx.x < CB) {
    const size_t sb = static_cast<size_t>(b) * C + c0 + threadIdx.x;
    mean_out[sb] = stat[0][threadIdx.x];
    rstd_out[sb] = rsqrtf(stat[1][threadIdx.x] + eps);
  }
  T* ob = y + base;
  for (int p = g; p < np; p += G) {
    float xf[EPV], o[EPV];
    load(p, xf);
#pragma unroll
    for (int e = 0; e < EPV; ++e) o[e] = (xf[e] - mu[e]) * rs[e];
    *reinterpret_cast<uint4*>(ob + static_cast<size_t>(p) * C + j * EPV) =
        V::pack(o);
  }
}

// Backward. The CTAs and threads map as in the forward.
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
    stage_part<T, CB>(xs, xb, 0, np, C);
    stage_part<T, CB>(ds, db, 0, np, C);
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

  float s[2][EPV];  // sum(dy), sum(dy * xhat)
#pragma unroll
  for (int e = 0; e < EPV; ++e) s[0][e] = s[1][e] = 0.f;
  for (int p = g; p < np; p += G) {
    float xf[EPV], df[EPV];
    load(p, xf, df);
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      s[0][e] += df[e];
      s[1][e] += df[e] * ((xf[e] - mu[e]) * rs[e]);
    }
  }
  cta_sums<2, CB, EPV>(s, red, part);
  cluster_sums<2, CB>(cl, part, stat, cluster, HW);
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
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Launches kernel(args...) on grid in clusters of `cluster` CTAs along x,
// with smem bytes of dynamic shared memory; refused if the card cannot hold
// one such cluster.
template <typename... KArgs, typename... Args>
cudaError_t launch_clusters(void (*kernel)(KArgs...), dim3 grid, int cluster,
                            int smem, cudaStream_t stream, Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
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
  e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (active == 0) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// A launch plan of either kernel (n = 7 ints, from ops/insnorm.py): CB (32
// or 64, dividing C), cluster (1-8), pixels a CTA (ceil(HW / cluster)),
// dynamic shared-memory bytes (inputs * ppc * CB * sizeof(T) on the
// shared-memory route, 0 on the global one), route (1 shared, 0 global),
// grid x (cluster * C / CB), grid y (B).
struct Plan {
  int cb, cluster, ppc, smem;
  bool shared;
  dim3 grid;
};

bool read_plan(const int* plan, int n, int B, int HW, int C, long long esz,
               int inputs, Plan* p) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || !plan || n != 7)
    return false;
  const int cb = plan[0], cluster = plan[1], ppc = plan[2], smem = plan[3];
  const int route = plan[4];
  if ((cb != 32 && cb != 64) || C % cb != 0 || cluster < 1 || cluster > 8 ||
      ppc != (HW + cluster - 1) / cluster || (route != 0 && route != 1) ||
      smem != (route ? inputs * static_cast<long long>(ppc) * cb * esz : 0LL) ||
      static_cast<long long>(plan[5]) != static_cast<long long>(cluster) * (C / cb) ||
      plan[6] != B)
    return false;
  *p = {cb, cluster, ppc, smem, route == 1, dim3(plan[5], plan[6])};
  return true;
}

template <typename T, int CB>
cudaError_t launch_forward(const Plan& p, const void* x, void* y, float* mean,
                           float* rstd, int HW, int C, float eps,
                           cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  return p.shared
             ? launch_clusters(instance_norm_kernel<T, CB, true>, p.grid,
                               p.cluster, p.smem, s, xt, yt, mean, rstd, HW, C,
                               p.cluster, p.ppc, eps)
             : launch_clusters(instance_norm_kernel<T, CB, false>, p.grid,
                               p.cluster, p.smem, s, xt, yt, mean, rstd, HW, C,
                               p.cluster, p.ppc, eps);
}

template <typename T, int CB>
cudaError_t launch_backward(const Plan& p, const void* x, const void* dy,
                            const float* mean, const float* rstd, void* dx,
                            int HW, int C, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  T* ot = static_cast<T*>(dx);
  return p.shared
             ? launch_clusters(instance_norm_backward_kernel<T, CB, true>,
                               p.grid, p.cluster, p.smem, s, xt, dt, mean,
                               rstd, ot, HW, C, p.cluster, p.ppc)
             : launch_clusters(instance_norm_backward_kernel<T, CB, false>,
                               p.grid, p.cluster, p.smem, s, xt, dt, mean,
                               rstd, ot, HW, C, p.cluster, p.ppc);
}

}  // namespace

// x, y: (B, H*W, C) contiguous (a channels_last NCHW tensor), 16-byte
// aligned; mean, rstd: (B, C) f32 outputs. plan (n = 7 ints, from
// ops/insnorm.py: instance_norm_forward_plan, read_plan's layout, one input
// staged). Anything else is refused.
extern "C" int uemda_instance_norm(const void* x, void* y, void* mean,
                                   void* rstd, int B, int HW, int C,
                                   int is_bf16, float eps, const int* plan,
                                   int n, void* stream) {
  Plan p;
  if (!read_plan(plan, n, B, HW, C, is_bf16 ? 2 : 4, 1, &p))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (is_bf16)
    return p.cb == 64
               ? launch_forward<__nv_bfloat16, 64>(p, x, y, m, r, HW, C, eps, s)
               : launch_forward<__nv_bfloat16, 32>(p, x, y, m, r, HW, C, eps, s);
  return p.cb == 64 ? launch_forward<float, 64>(p, x, y, m, r, HW, C, eps, s)
                    : launch_forward<float, 32>(p, x, y, m, r, HW, C, eps, s);
}

// x, dy, dx: (B, H*W, C) contiguous, 16-byte aligned; mean, rstd: (B, C) f32
// from the forward. plan (n = 7 ints, from ops/insnorm.py:
// instance_norm_backward_plan, read_plan's layout, two inputs staged).
// Anything else is refused.
extern "C" int uemda_instance_norm_backward(const void* x, const void* dy,
                                            const void* mean, const void* rstd,
                                            void* dx, int B, int HW, int C,
                                            int is_bf16, const int* plan,
                                            int n, void* stream) {
  Plan p;
  if (!read_plan(plan, n, B, HW, C, is_bf16 ? 2 : 4, 2, &p))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  if (is_bf16)
    return p.cb == 64 ? launch_backward<__nv_bfloat16, 64>(p, x, dy, m, r, dx,
                                                           HW, C, s)
                      : launch_backward<__nv_bfloat16, 32>(p, x, dy, m, r, dx,
                                                           HW, C, s);
  return p.cb == 64
             ? launch_backward<float, 64>(p, x, dy, m, r, dx, HW, C, s)
             : launch_backward<float, 32>(p, x, dy, m, r, dx, HW, C, s);
}
