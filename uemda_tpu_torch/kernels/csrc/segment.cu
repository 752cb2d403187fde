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
// K5/K6 design. The TPU kernel revisits one (S, C) accumulator across a
// sequential grid of pixel tiles, masking every pixel against all S ids.
// Blocks on Hopper run in no order, so each block -- one tile of `tile`
// pixels of one sample (blockIdx.y) -- reduces its tile into a private
// table in shared memory and merges the occupied entries into the output
// with global atomics (after a fill pass that writes -inf, or a memset to 0
// for the sum). The tile's ids and values are contiguous in memory; the
// CTA copies both into shared memory with cp.async, 16 bytes a copy where
// the 16-byte boundaries of source and destination coincide (the head and
// tail 4 bytes at a time), all issued before the first wait, so
// neighbouring lanes read neighbouring bytes and a CTA keeps its whole
// tile (~32 KB) in flight; several CTAs a SM overlap one's loads with
// another's work. The table covers only the ids the tile touches: a block
// min and max over the staged ids give its lowest id lo and its top id top
// (the shrunk-boundary label of superpixels.py, which every tile holds),
// and a second max the highest id hi below top. Rows [0, hi - lo] hold ids
// lo..hi and row hi - lo + 1 holds top. Superpixel ids are spatially
// coherent and numbered in scan order, so at 2urban a tile of 1024 pixels
// (two image rows) needs ~100 rows of the 4128. Only those rows are set up
// and merged. The plan (ops/segment.py: segment_reduce_plan) sizes the
// table: route "full" gives it S rows (every tile fits), route "window"
// fewer, and a tile whose rows do not fit (ids not spatially coherent)
// reduces straight into the output with global atomics, as route "global"
// does for every tile. Each thread walks runs of kRun consecutive staged
// pixels (an odd run, so the lanes' reads of a 7-float row fall on distinct
// banks) and folds a run of equal ids in registers before one atomic:
// superpixels are spatially coherent, so a run rarely holds more than two
// ids. The float max is an integer atomic (atomicMax on the int pattern
// for a clear sign bit, atomicMin on the unsigned pattern otherwise), which
// orders every non-NaN float; max is order-free, so K5 is exact and
// deterministic on every route. K6's atomicAdd order varies from run to
// run: exact for integer values below 2^24 (one-hot counts).
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

#include <limits.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int WARPS = kThreads / 32;  // warps a CTA
constexpr int kRun = 7;   // consecutive pixels per thread (odd: no bank
                          // conflicts on an odd row of floats)
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Issues the copy of the n bytes at src (n and src multiples of 4) to dst +
// src % 16 (dst 16-byte aligned), so the 16-byte pieces of both coincide:
// the head up to src's first 16-byte boundary and the tail 4 bytes a copy,
// the rest 16. Returns the offset src % 16.
__device__ __forceinline__ int stage_bytes(unsigned char* dst,
                                           const unsigned char* src, int n) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min(n, (16 - shift) & 15);
  const int nv = (n - head) >> 4;
  const int tail = head + 16 * nv;
  unsigned char* d = dst + shift;
  for (int i = 4 * threadIdx.x; i < head; i += 4 * kThreads)
    cp_async4(d + i, src + i);
  for (int v = threadIdx.x; v < nv; v += kThreads)
    cp_async16(d + head + 16 * v, src + head + 16 * v);
  for (int i = tail + 4 * threadIdx.x; i < n; i += 4 * kThreads)
    cp_async4(d + i, src + i);
  return shift;
}

// The staged tile's np pixels (ids, and C values a pixel) reduced into acc:
// the table in shared memory (kTable: row id - lo for an id below top, row
// top_row for top) or the sample's output rows in device memory (row id).
// Ids outside [0, S) are left out.
template <typename Id, bool kMax, bool kTable>
__device__ __forceinline__ void reduce_tile(const Id* ids, const float* vals,
                                            int np, int C, int S, float* acc,
                                            int lo, int top, int top_row) {
  const int nruns = (np + kRun - 1) / kRun;
  for (int r = threadIdx.x; r < nruns; r += kThreads) {
    const int q0 = r * kRun, q1 = min(np, q0 + kRun);
    for (int c0 = 0; c0 < C; c0 += kCh) {
      const int nc = min(kCh, C - c0);
      int cur = -1;   // the run's segment, -1 for none
      float run[kCh];
      auto flush = [&]() {
        const int row = !kTable ? cur : cur < top ? cur - lo : top_row;
        float* a = acc + static_cast<size_t>(row) * C + c0;
#pragma unroll
        for (int j = 0; j < kCh; ++j)
          if (j < nc) combine<kMax>(a + j, run[j]);
      };
      for (int q = q0; q < q1; ++q) {
        const long long id = static_cast<long long>(ids[q]);
        const float* v = vals + q * C + c0;
        if (cur >= 0 && id == cur) {
#pragma unroll
          for (int j = 0; j < kCh; ++j)
            if (j < nc) run[j] = kMax ? fmaxf(run[j], v[j]) : run[j] + v[j];
          continue;
        }
        if (cur >= 0) flush();
        cur = (id >= 0 && id < S) ? static_cast<int>(id) : -1;
        if (cur >= 0) {
#pragma unroll
          for (int j = 0; j < kCh; ++j)
            if (j < nc) run[j] = v[j];
        }
      }
      if (cur >= 0) flush();
    }
  }
}

// The block's min (kMin) or max of v; every thread gets it. red: WARPS ints.
template <bool kMin>
__device__ __forceinline__ int block_reduce(int v, int* red) {
  v = kMin ? __reduce_min_sync(0xffffffffu, v)
           : __reduce_max_sync(0xffffffffu, v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  int r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = kMin ? min(r, red[w]) : max(r, red[w]);
  __syncthreads();  // red may be written again
  return r;
}

// One CTA: pixels [blockIdx.x * tile, + tile) of sample blockIdx.y. Dynamic
// shared memory: the staged ids (tile * sizeof(Id) + 16 bytes), the staged
// values (tile * C * 4 + 16), each from a 16-byte boundary, then the table
// of `rows` rows of C floats (kTable).
template <typename Id, bool kMax, bool kTable>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ val, const Id* __restrict__ ids,
                      float* __restrict__ out, int N, int C, int S, int tile,
                      int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int red[WARPS];
  const float empty = kMax ? -INFINITY : 0.f;
  const int b = blockIdx.y;
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;
  const int np = static_cast<int>(min(static_cast<long long>(tile), N - p0));
  const size_t g0 = static_cast<size_t>(b) * N + p0;
  const int ids_bytes = (tile * static_cast<int>(sizeof(Id)) + 16 + 15) & ~15;
  const int val_bytes = (tile * C * 4 + 16 + 15) & ~15;
  unsigned char* ids_s = smem_raw;
  unsigned char* val_s = smem_raw + ids_bytes;
  float* table = reinterpret_cast<float*>(val_s + val_bytes);
  const int id_shift = stage_bytes(
      ids_s, reinterpret_cast<const unsigned char*>(ids + g0),
      np * static_cast<int>(sizeof(Id)));
  const int val_shift = stage_bytes(
      val_s, reinterpret_cast<const unsigned char*>(val + g0 * C), np * C * 4);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const Id* ti = reinterpret_cast<const Id*>(ids_s + id_shift);
  const float* tv = reinterpret_cast<const float*>(val_s + val_shift);
  float* out_b = out + static_cast<size_t>(b) * S * C;

  if (kTable) {
    // lo, top: the least and greatest valid id; hi: the greatest below top
    int lo = INT_MAX, top = -1;
    for (int q = threadIdx.x; q < np; q += kThreads) {
      const long long id = static_cast<long long>(ti[q]);
      if (id >= 0 && id < S) {
        lo = min(lo, static_cast<int>(id));
        top = max(top, static_cast<int>(id));
      }
    }
    lo = block_reduce<true>(lo, red);
    top = block_reduce<false>(top, red);
    if (top < 0) return;  // no valid id in the tile (uniform)
    int hi = lo - 1;
    for (int q = threadIdx.x; q < np; q += kThreads) {
      const long long id = static_cast<long long>(ti[q]);
      if (id >= 0 && id < top) hi = max(hi, static_cast<int>(id));
    }
    hi = block_reduce<false>(hi, red);
    const int need = hi - lo + 2;  // rows lo..hi and top's
    if (need <= rows) {
      for (int i = threadIdx.x; i < need * C; i += kThreads) table[i] = empty;
      __syncthreads();
      reduce_tile<Id, kMax, true>(ti, tv, np, C, S, table, lo, top, need - 1);
      __syncthreads();
      for (int i = threadIdx.x; i < need * C; i += kThreads) {
        const float v = table[i];
        if (v == empty) continue;
        const int row = i / C;
        const int id = row < need - 1 ? lo + row : top;
        combine<kMax>(out_b + static_cast<size_t>(id) * C + (i - row * C), v);
      }
      return;
    }
  }
  reduce_tile<Id, kMax, false>(ti, tv, np, C, S, out_b, 0, 0, 0);
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

// The dynamic shared memory of segment_reduce_kernel: the staged ids and
// values, each rounded up to 16 bytes, and the table.
long long reduce_smem(int tile, int C, int id_bytes, int rows) {
  const long long ids = (static_cast<long long>(tile) * id_bytes + 31) & ~15LL;
  const long long vals = (static_cast<long long>(tile) * C * 4 + 31) & ~15LL;
  return ids + vals + static_cast<long long>(rows) * C * 4;
}

template <typename Id, bool kMax, bool kTable>
cudaError_t launch_reduce(const float* val, const Id* ids, float* out, int B,
                          int N, int C, int S, int tile, int rows, int smem,
                          dim3 grid, cudaStream_t s) {
  const long long n_out = static_cast<long long>(B) * S * C;
  if (kMax) {
    const int blocks = static_cast<int>(
        std::min<long long>((n_out + kThreads - 1) / kThreads, 4096));
    fill_kernel<true><<<blocks, kThreads, 0, s>>>(out, n_out);
  } else {
    cudaError_t e = cudaMemsetAsync(out, 0, n_out * sizeof(float), s);
    if (e != cudaSuccess) return e;
  }
  auto k = segment_reduce_kernel<Id, kMax, kTable>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;  // over the card's limit: refused here
  k<<<grid, kThreads, smem, s>>>(val, ids, out, N, C, S, tile, rows);
  return cudaGetLastError();
}

template <typename Id>
cudaError_t launch_reduce_plan(const float* val, const Id* ids, float* out,
                               int B, int N, int C, int S, bool is_max,
                               int tile, int rows, int smem, dim3 grid,
                               cudaStream_t s) {
  if (rows > 0)
    return is_max ? launch_reduce<Id, true, true>(val, ids, out, B, N, C, S,
                                                  tile, rows, smem, grid, s)
                  : launch_reduce<Id, false, true>(val, ids, out, B, N, C, S,
                                                   tile, rows, smem, grid, s);
  return is_max ? launch_reduce<Id, true, false>(val, ids, out, B, N, C, S,
                                                 tile, 0, smem, grid, s)
                : launch_reduce<Id, false, false>(val, ids, out, B, N, C, S,
                                                  tile, 0, smem, grid, s);
}

}  // namespace

// val: (B, N, C) f32 contiguous; ids: (B, N) int32 (ids64 = 0) or int64
// contiguous; out: (B, S, C) f32 contiguous, all on the device. is_max
// selects K5 (max, empty -inf) or K6 (sum, empty 0). plan (n = 6 ints, from
// ops/segment.py: segment_reduce_plan): route (2 full table, 1 window, 0
// global), pixels a tile, table rows (S on route 2, 1 to S - 1 on route 1,
// 0 on route 0), dynamic shared-memory bytes (reduce_smem's; over the
// card's per-block limit, the runtime refuses them), grid x (ceil(N /
// tile)), grid y (B). Anything else is refused.
extern "C" int uemda_segment_reduce(const void* val, const void* ids, int ids64,
                                    void* out, int B, int N, int C, int S,
                                    int is_max, const int* plan, int n,
                                    void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || S <= 0 || B > 65535 ||
      static_cast<long long>(S) * C > (1LL << 30) || !plan || n != 6)
    return cudaErrorInvalidValue;
  const int route = plan[0], tile = plan[1], rows = plan[2], smem = plan[3];
  const dim3 grid(plan[4], plan[5]);
  if (route < 0 || route > 2 || tile < 1 ||
      (route == 2 ? rows != S : route == 1 ? rows < 1 || rows >= S : rows != 0) ||
      smem != reduce_smem(tile, C, ids64 ? 8 : 4, rows) ||
      static_cast<long long>(grid.x) * tile < N ||
      static_cast<long long>(grid.x - 1) * tile >= N ||
      static_cast<int>(grid.y) != B)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(val);
  float* o = static_cast<float*>(out);
  if (ids64)
    return launch_reduce_plan(v, static_cast<const long long*>(ids), o, B, N,
                              C, S, is_max != 0, tile, rows, smem, grid, s);
  return launch_reduce_plan(v, static_cast<const int*>(ids), o, B, N, C, S,
                            is_max != 0, tile, rows, smem, grid, s);
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
