// K5 segment max, K6 segment sum, K7 segment gather: the superpixel
// reductions of stage-2/3 label refinement.
//
// Replace uemda_tpu/ops/pallas_kernels.py:segment_max_pallas and
// segment_sum_pallas (_seg_max_kernel, _seg_sum_kernel, one call at :94)
// and segment_gather_pallas (_seg_gather_kernel). From (B, N, C) f32 values
// and (B, N) int32/int64 segment ids:
//   K5  out[b, s, c] = max over {p : ids[b, p] == s} of val[b, p, c]
//   K6  out[b, s, c] = sum over the same set
//   K7  out[b, p, c] = seg[b, ids[b, p], c]              (exact)
// The semantics are the JAX package's default route (jax.ops.segment_max /
// segment_sum, take_along_axis in fill mode), not the Pallas kernels': an
// empty segment holds -inf (max) or 0 (sum); an id outside [0, S) is left
// out of both reductions, and K7 writes NaN for it. No id is ever used as
// an address before it is checked.
//
// Bound on the H100: bytes. At the 2urban stage-2 shape (B 8, N 512^2,
// C 7, S 4128) K5/K6 read 58.7 MB of values and 8.4 MB of ids and write
// 0.9 MB, ~0.020 ms at 3.35 TB/s; K7 reads 8.4 MB of ids (+0.9 MB of table)
// and writes 58.7 MB, ~0.020 ms. One compare (or add) per value; K7 none.
//
// Design. The TPU kernel revisits one (S, C) accumulator across a
// sequential grid of pixel tiles, masking every pixel against all S ids.
// Blocks on Hopper run in no order, so each block -- one (pixel tile,
// sample) -- keeps a private (S, C) table in dynamic shared memory
// (4128 x 7 x 4 B = 113 KB at 2urban, two blocks per SM), reduces its tile
// into it, and merges the occupied entries into the output with global
// atomics. Each thread walks a run of kRun consecutive pixels, whose C
// values are contiguous (channels_last), and folds a run of equal ids in
// registers before one shared atomic: superpixels are spatially coherent,
// so a run rarely holds more than two ids. The float max is an integer
// atomic (atomicMax on the int pattern for a clear sign bit, atomicMin on
// the unsigned pattern otherwise), which orders every non-NaN float; max is
// order-free, so K5 is exact and deterministic. K6's atomicAdd order varies
// from run to run: exact for integer values below 2^24 (one-hot counts).
// A table over the card's shared-memory limit takes the same loop with the
// atomics aimed at the output in global memory.
//
// K7 design. A CTA of 256 threads writes the output rows of ppc pixels of
// one sample: the sample is blockIdx.y, so no index is divided per element
// and the only 64-bit arithmetic is the CTA's base offsets. Each pixel has
// `lanes` threads (1 for C <= 8, more for wider rows, ppc = 256 / lanes):
// they read its id once, check its range once, and read the C floats of the
// id's table row with __ldg (one sample's (S, C) table, 115 KB at 2urban,
// stays in L1/L2; a superpixel's pixels are neighbours, so a warp's rows
// mostly coincide), or write NaN. A pixel's row of C floats (28 bytes at
// C = 7) is not 16-byte aligned, so the rows go to shared memory first, at
// the offset that makes the CTA's contiguous run of ppc * C floats line up
// with 16-byte boundaries of the output; the CTA then stores the run with
// 16-byte stores, its first and last few floats one at a time. A row wider
// than 2048 floats (route "direct", one pixel a CTA) is stored straight
// from the lanes: a warp's stores are then contiguous already. The launch
// plan (lanes, ppc, grid, shared-memory bytes, route) is computed in Python
// (ops/segment.py: segment_gather_plan); the launcher checks it.

#include "common.cuh"

#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;   // consecutive pixels per thread
constexpr int kCh = 8;    // channels per pass, held in registers

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

template <bool kMax>
__device__ __forceinline__ void combine(float* acc, float v) {
  if (kMax) atomic_max_f32(acc, v);
  else atomicAdd(acc, v);
}

template <bool kMax>
__global__ void fill_kernel(float* __restrict__ out, long long n) {
  const float empty = kMax ? -INFINITY : 0.f;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = empty;
}

template <typename Id, bool kMax, bool kShared>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ val, const Id* __restrict__ ids,
                      float* __restrict__ out, int N, int C, int S, int tile) {
  extern __shared__ float table[];
  const float empty = kMax ? -INFINITY : 0.f;
  const int b = blockIdx.y;
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;
  const long long p1 = min(static_cast<long long>(N), p0 + tile);
  const int SC = S * C;
  float* out_b = out + static_cast<size_t>(b) * SC;
  float* acc = kShared ? table : out_b;
  if (kShared) {
    for (int i = threadIdx.x; i < SC; i += kThreads) table[i] = empty;
    __syncthreads();
  }
  const Id* id_b = ids + static_cast<size_t>(b) * N;
  const float* v_b = val + static_cast<size_t>(b) * N * C;

  for (long long r0 = p0 + static_cast<long long>(threadIdx.x) * kRun; r0 < p1;
       r0 += static_cast<long long>(kThreads) * kRun) {
    const long long r1 = min(p1, r0 + kRun);
    for (int c0 = 0; c0 < C; c0 += kCh) {
      const int nc = min(kCh, C - c0);
      long long cur = -1;   // the run's segment, -1 for none
      float run[kCh];
      for (long long p = r0; p < r1; ++p) {
        const long long id = static_cast<long long>(id_b[p]);
        const float* v = v_b + p * C + c0;
        if (id == cur) {
#pragma unroll
          for (int j = 0; j < kCh; ++j)
            if (j < nc) run[j] = kMax ? fmaxf(run[j], v[j]) : run[j] + v[j];
          continue;
        }
        if (cur >= 0) {
          float* a = acc + cur * C + c0;
#pragma unroll
          for (int j = 0; j < kCh; ++j)
            if (j < nc) combine<kMax>(a + j, run[j]);
        }
        cur = (id >= 0 && id < S) ? id : -1;
        if (cur >= 0) {
#pragma unroll
          for (int j = 0; j < kCh; ++j)
            if (j < nc) run[j] = v[j];
        }
      }
      if (cur >= 0) {
        float* a = acc + cur * C + c0;
#pragma unroll
        for (int j = 0; j < kCh; ++j)
          if (j < nc) combine<kMax>(a + j, run[j]);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < SC; i += kThreads) {
      const float v = table[i];
      if (v != empty) combine<kMax>(out_b + i, v);
    }
  }
}

// K7: one CTA writes pixels [blockIdx.x * ppc, + ppc) of sample blockIdx.y;
// thread t is lane t % lanes of the CTA's pixel t / lanes
template <typename Id, bool kStaged>
__global__ void __launch_bounds__(kThreads)
segment_gather_kernel(const float* __restrict__ seg, const Id* __restrict__ ids,
                      float* __restrict__ out, int N, int C, int S,
                      int lanes_log2, int ppc) {
  extern __shared__ __align__(16) float stage[];  // ppc * C + 4, if kStaged
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * ppc;
  const int np = min(ppc, N - p0);
  const int q = threadIdx.x >> lanes_log2;
  const int lanes = 1 << lanes_log2;
  const size_t g0 = (static_cast<size_t>(b) * N + p0) * C;
  float* out_b = out + g0;
  // stage[shift + i] holds out_b[i]; out_b - shift is 16-byte aligned
  const int shift = kStaged ? static_cast<int>(g0 & 3) : 0;
  if (q < np) {
    const long long id =
        static_cast<long long>(ids[static_cast<size_t>(b) * N + p0 + q]);
    const bool ok = id >= 0 && id < S;
    const float* row =
        seg + (static_cast<size_t>(b) * S + (ok ? id : 0)) * C;
    float* dst = kStaged ? stage + shift + q * C
                         : out_b + static_cast<size_t>(q) * C;
    for (int c = threadIdx.x & (lanes - 1); c < C; c += lanes)
      dst[c] = ok ? __ldg(row + c) : NAN;
  }
  if (!kStaged) return;
  __syncthreads();
  const int n = np * C;
  const int head = min(n, (4 - shift) & 3);
  const int nv = (n - head) >> 2;
  const int tail = head + 4 * nv;
  if (static_cast<int>(threadIdx.x) < head)
    out_b[threadIdx.x] = stage[shift + threadIdx.x];
  const float4* sv = reinterpret_cast<const float4*>(stage + shift + head);
  float4* ov = reinterpret_cast<float4*>(out_b + head);
  for (int v = threadIdx.x; v < nv; v += kThreads) ov[v] = sv[v];
  if (static_cast<int>(threadIdx.x) < n - tail)
    out_b[tail + threadIdx.x] = stage[shift + tail + threadIdx.x];
}

int sm_count() {
  int dev = 0, n = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <typename Id, bool kMax>
cudaError_t launch_reduce(const float* val, const Id* ids, float* out, int B,
                          int N, int C, int S, cudaStream_t s, int* route) {
  const long long n_out = static_cast<long long>(B) * S * C;
  if (kMax) {
    const int blocks = static_cast<int>(
        std::min<long long>((n_out + kThreads - 1) / kThreads, 4096));
    fill_kernel<true><<<blocks, kThreads, 0, s>>>(out, n_out);
  } else {
    cudaError_t e = cudaMemsetAsync(out, 0, n_out * sizeof(float), s);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t smem = static_cast<size_t>(S) * C * sizeof(float);
  const bool shared = smem <= static_cast<size_t>(smem_max);
  // about two blocks per SM over the whole batch, whole runs per tile
  const long long per = static_cast<long long>(kThreads) * kRun;
  const long long want = (static_cast<long long>(N) * B + 2LL * sm_count() - 1) /
                         (2LL * sm_count());
  const long long tile = std::max<long long>(per, (want + per - 1) / per * per);
  const dim3 grid(static_cast<unsigned>((N + tile - 1) / tile), B);
  *route = shared ? 1 : 0;
  if (shared) {
    cudaError_t e = cudaFuncSetAttribute(
        segment_reduce_kernel<Id, kMax, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    segment_reduce_kernel<Id, kMax, true><<<grid, kThreads, smem, s>>>(
        val, ids, out, N, C, S, static_cast<int>(tile));
  } else {
    segment_reduce_kernel<Id, kMax, false><<<grid, kThreads, 0, s>>>(
        val, ids, out, N, C, S, static_cast<int>(tile));
  }
  return cudaGetLastError();
}

}  // namespace

// val: (B, N, C) f32 contiguous; ids: (B, N) int32 (ids64 = 0) or int64
// contiguous; out: (B, S, C) f32 contiguous, all on the device. is_max
// selects K5 (max, empty -inf) or K6 (sum, empty 0). *route (host memory)
// is set to 1 for the shared-memory table, 0 for global atomics.
extern "C" int uemda_segment_reduce(const void* val, const void* ids, int ids64,
                                    void* out, int B, int N, int C, int S,
                                    int is_max, int* route, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || S <= 0 || B > 65535 ||
      static_cast<long long>(S) * C > (1LL << 30))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(val);
  float* o = static_cast<float*>(out);
  if (ids64) {
    const long long* i = static_cast<const long long*>(ids);
    return is_max ? launch_reduce<long long, true>(v, i, o, B, N, C, S, s, route)
                  : launch_reduce<long long, false>(v, i, o, B, N, C, S, s, route);
  }
  const int* i = static_cast<const int*>(ids);
  return is_max ? launch_reduce<int, true>(v, i, o, B, N, C, S, s, route)
                : launch_reduce<int, false>(v, i, o, B, N, C, S, s, route);
}

// seg: (B, S, C) f32; ids: (B, N) int32/int64; out: (B, N, C) f32; all
// contiguous on the device, out 16-byte aligned. out[b, p, :] =
// seg[b, ids[b, p], :], NaN for an id outside [0, S). plan (n = 6 ints, from
// ops/segment.py: segment_gather_plan): lanes (a power of two, lanes * ppc
// = 256), pixels a CTA, dynamic shared-memory bytes (4 * (ppc * C + 4) when
// staged, at most 48 KB; 0 direct, with ppc 1), route (1 staged, 0
// direct), grid x (ceil(N / ppc)), grid y (B). Anything else is refused.
extern "C" int uemda_segment_gather(const void* seg, const void* ids, int ids64,
                                    void* out, int B, int N, int C, int S,
                                    const int* plan, int n, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || C <= 0 || S <= 0 || !plan || n != 6)
    return cudaErrorInvalidValue;
  const int lanes = plan[0], ppc = plan[1], smem = plan[2], staged = plan[3];
  const dim3 grid(plan[4], plan[5]);
  int lg = 0;
  while (lg < 8 && (1 << lg) < lanes) ++lg;
  if (lanes != (1 << lg) || lanes * ppc != kThreads ||
      (staged != 0 && staged != 1) ||
      (staged ? smem != 4LL * (static_cast<long long>(ppc) * C + 4) ||
                    smem > 48 * 1024
              : smem != 0 || ppc != 1) ||
      static_cast<long long>(grid.x) * ppc < N ||
      static_cast<long long>(grid.x - 1) * ppc >= N ||
      static_cast<int>(grid.y) != B)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(seg);
  float* o = static_cast<float*>(out);
  if (ids64) {
    const long long* i = static_cast<const long long*>(ids);
    if (staged)
      segment_gather_kernel<long long, true><<<grid, kThreads, smem, s>>>(
          sg, i, o, N, C, S, lg, ppc);
    else
      segment_gather_kernel<long long, false><<<grid, kThreads, 0, s>>>(
          sg, i, o, N, C, S, lg, ppc);
  } else {
    const int* i = static_cast<const int*>(ids);
    if (staged)
      segment_gather_kernel<int, true><<<grid, kThreads, smem, s>>>(
          sg, i, o, N, C, S, lg, ppc);
    else
      segment_gather_kernel<int, false><<<grid, kThreads, 0, s>>>(
          sg, i, o, N, C, S, lg, ppc);
  }
  return cudaGetLastError();
}
