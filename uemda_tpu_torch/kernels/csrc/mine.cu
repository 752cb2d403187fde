// K8: fused uncertainty mining of stage 3 -- per-pixel entropy, the UVEM
// valuable-example weight and the strict-threshold single-class pseudo label,
// the per-class maximum included, in two passes over the soft label.
//
// Replaces uemda_tpu/ops/pallas_kernels.py:uvem_mine_pallas
// (_uvem_mine_kernel, and the XLA class max outside its body). From (B, C,
// H, W) f32 probabilities, read through their strides, writes per pixel,
// each (B, H, W):
//   u     = -sum_c p * log(max(p, 1e-30))                          f32
//   label = the one class with p > thr[b, c], else ignore_label    int32
//   w     = the UVEM parabola of u with m, t and gamma             f32
// where thr[b, c] = max(f32(class max * f32(cutoff_top)), f32(cutoff_low)),
// NaN where the class max is NaN (the plain version's torch.amax, multiply
// and clamp, ops/pseudo.py:class_thresholds), so no pixel selects a class
// holding a NaN. The plain version's (ops/uncertainty.py, ops/pseudo.py)
// order of operations: every product and sum is rounded on its own
// (__fmul_rn and __fadd_rn, which nvcc never contracts into an FMA), logf
// and powf are the accurate library functions (no --use_fast_math), and the
// f32 constants -1/m^2, -1/(t-m)^2 and 1/gamma come from the host, rounded
// once from double as the plain version's Python scalars are. The labels
// and w are bit-equal to the plain version's on the card.
//
// Bound on the H100: bytes. At the flagship stage-3 shape (B 8, C 7, 512^2)
// the function must read 58.7 MB of probabilities and write 25.2 MB (label,
// w, u): 84 MB, ~0.025 ms at 3.35 TB/s. The thresholds need every pixel's
// probabilities before the first label, so without a grid-wide barrier the
// labels wait for a second pass. Reading the probabilities twice is 142.6
// MB, ~0.043 ms, unless the second read finds them in the 50 MB L2, which
// holds under half of them (and pass 1's other writes). This design instead
// carries each pixel's candidate forward, 5 bytes, so the second pass reads
// 10.5 MB instead of 58.7 MB: ~95 MB of memory traffic in all, ~0.028 ms.
// The second floor is instruction issue: per value one accurate logf (~24
// instructions) and a few more, per pixel one powf (~60): ~1000 instructions
// a group of 4 pixels, ~18 us of issue on 132 SMs at 1.755 GHz, next to pass
// 1's ~25 us of memory time; the two overlap only in part.
//
// Design: two kernels launched back to back by one call, no atomics, no
// memset, no torch operation between them, deterministic.
//   Pass 1 (uvem_mine_stats): a CTA of 256 threads takes ppt (4, 8 or 16)
//   pixels a thread of one sample (blockIdx.y), in groups of 4 consecutive
//   pixels: in channels_last memory a group's 4*C floats are C aligned
//   16-byte loads, as NCHW planes one 16-byte load a class, with the L2 hint
//   evict_first (~5% faster than without in chip_smoke.py's K8 time); all of
//   a group's loads are issued before its math. Per pixel u, then w with one
//   powf (the branch is picked first, then only its parabola evaluated), and
//   its candidate: the classes not at or under cutoff_low -- only they can
//   pass a threshold, which is max(class max * cutoff_top, cutoff_low) or
//   NaN. u and w leave in streaming 16-byte stores; the candidate's value in
//   the label's place (16 bytes a group) and a code byte a pixel (the one
//   candidate class, none, or several) in a scratch array. Each CTA writes
//   its per-class maximum (NaN-propagating max.NaN, warp shuffles, then
//   across warps in shared memory) to a (B, blocks, C) scratch table.
//   Pass 2 (uvem_mine_select): each CTA first reduces its sample's partial
//   maxima (blocks * C floats, from L2) into the thresholds, then per
//   group of 4 pixels reads the candidates and codes and writes the int32
//   labels in 16-byte stores: the one candidate if over its threshold;
//   with several candidates (none at the flagship's cutoff 0.6 on softmax
//   probabilities, where at most one class can pass 0.5) the pixel's C
//   probabilities are read again and counted. Pass 2 walks the grid in
//   pass 1's order: walking it backwards, to meet the candidates pass 1
//   wrote last while they are still in L2, timed the same on the H100.
//   The C of the vector routes (2..16) is a template parameter: the loads
//   and per-class maxima stay in registers. Any other C (up to 4096), H*W
//   not a multiple of 4, a base not 16-byte aligned and other layouts (a
//   rot90 view) take the strided route: 4 pixels a thread, a runtime class
//   loop reading through the four strides, and a pass 2 that reads every
//   probability again. The plan (ops/mine.py: uvem_mine_plan) picks the
//   route; the launcher checks it.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 4096;
constexpr unsigned kFull = 0xffffffffu;

struct Weights {
  float m, t;       // the branch points, as f32
  float cl, cr;     // -1/m^2 and -1/(t-m)^2, as f32
  float e;          // 1/gamma, as f32
  int has_left;     // m > 0
  int has_right;    // m < t
};

struct Select {
  float top, low;   // cutoff_top and cutoff_low, as f32
  int ignore;       // ignore_label
};

// a 16-byte read-only load with the L2 hint evict_first: pass 1 is the
// probabilities' last read (but for pixels with several candidates), and
// its candidate writes should stay in L2 for pass 2
__device__ __forceinline__ float4 ldg_last_use(const float4* p) {
  uint64_t pol;  // the same policy each call: the compiler keeps one
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  float4 r;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(p), "l"(pol));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// one class's term of -u: p * log(max(p, 1e-30)), max keeping NaN as
// torch.clamp_min and jnp.maximum do
__device__ __forceinline__ float ent_term(float v) {
  // fmaxf turns a NaN into 1e-30 where the clamp keeps it, but the product
  // with v is NaN all the same
  return __fmul_rn(v, logf(fmaxf(v, 1e-30f)));
}

// w of u with one powf: u >= t gives 0; u <= m the left parabola (1 where
// m <= 0); m < u < t the right parabola at u; a NaN u (every comparison
// false) the right parabola at 0 (0 where m >= t). The parabola is
// clip(c * (x - m)^2 + 1, 0, 1) ^ e, each operation rounded on its own.
__device__ __forceinline__ float uvem_w(float u, const Weights& k) {
  float x = u, c = k.cr, fixed = -1.f;  // fixed >= 0: w without a parabola
  if (u >= k.t) {
    fixed = 0.f;
  } else if (u <= k.m) {
    c = k.cl;
    if (!k.has_left) fixed = 1.f;
  } else if (!(u > k.m)) {  // NaN
    x = 0.f;
    if (!k.has_right) fixed = 0.f;
  }
  const float d = __fsub_rn(x, k.m);
  float v = __fadd_rn(__fmul_rn(c, __fmul_rn(d, d)), 1.0f);
  v = fminf(fmaxf(v, 0.0f), 1.0f);
  const float p = powf(v, k.e);
  return fixed >= 0.f ? fixed : p;
}

// group q's 4 consecutive pixels of one sample (src), all C classes:
// v[k][c]. NCHW planes: one 16-byte load a class; channels_last: the
// group's 4*C floats in C 16-byte loads.
template <int C>
__device__ __forceinline__ void load_group(const float* src, int q,
                                           long long sC, bool nchw,
                                           float (&v)[4][C]) {
  if (nchw) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 f =
          ldg_last_use(reinterpret_cast<const float4*>(src + c * sC) + q);
      v[0][c] = f.x;
      v[1][c] = f.y;
      v[2][c] = f.z;
      v[3][c] = f.w;
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(src) +
                      static_cast<long long>(q) * C;
    float4 f[C];
#pragma unroll
    for (int j = 0; j < C; ++j) f[j] = ldg_last_use(p + j);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float e[4] = {f[j].x, f[j].y, f[j].z, f[j].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) v[(4 * j + i) / C][(4 * j + i) % C] = e[i];
    }
  }
}

// fn(q, v) on the groups q0, q0 + 256, ... (at most iters, below groups)
// with their values v
template <int C, typename Fn>
__device__ __forceinline__ void for_groups(const float* src, int q0,
                                           int iters, int groups,
                                           long long sC, bool nchw, Fn fn) {
  for (int i = 0, q = q0; i < iters && q < groups; ++i, q += kThreads) {
    float v[4][C];
    load_group<C>(src, q, sC, nchw, v);
    fn(q, v);
  }
}

// the block's per-class maxima m[c] (every thread's) -> out[c]
template <int C>
__device__ __forceinline__ void block_max(float (&m)[C], float (*red)[C],
                                          float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float r = warp_max(m[c]);
    if (lane == 0) red[warp][c] = r;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float r = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) r = nan_max(r, red[w][threadIdx.x]);
    out[threadIdx.x] = r;
  }
}

// A pixel's candidate code: the one class over cutoff_low, or none, or
// several (pass 2 then reads the pixel's probabilities again)
constexpr unsigned kNone = 255, kSeveral = 254;

// Pass 1, vector routes: groups [blockIdx.x * iters * 256, + iters * 256)
// of sample blockIdx.y, thread t on groups t, t + 256, ...
template <int C>
__global__ void __launch_bounds__(kThreads, 3)
uvem_mine_stats(const float* __restrict__ probs, float* __restrict__ part,
                float* __restrict__ wgt, float* __restrict__ unc,
                float* __restrict__ cand, unsigned* __restrict__ code,
                int HW, long long sB, long long sC, int nchw, int iters,
                Weights k, float low) {
  __shared__ float red[kWarps][C];
  const int b = blockIdx.y;
  const float* src = probs + b * sB;
  float cmax[C];
#pragma unroll
  for (int c = 0; c < C; ++c) cmax[c] = -INFINITY;
  for_groups<C>(src, blockIdx.x * iters * kThreads + threadIdx.x, iters,
                HW >> 2, sC, nchw != 0, [&](int q, const float (&v)[4][C]) {
    float u[4], w[4], val[4];
    unsigned codes = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float acc = 0.f;
      int count = 0, index = 0;
      val[p] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc = __fadd_rn(acc, ent_term(v[p][c]));
        cmax[c] = nan_max(cmax[c], v[p][c]);
        // a candidate: not at or under cutoff_low (a NaN too, never
        // selected; a NaN cutoff makes every class one)
        if (!(v[p][c] <= low)) {
          ++count;
          index = c;
          val[p] = v[p][c];
        }
      }
      u[p] = -acc;
      w[p] = uvem_w(u[p], k);
      codes |= (count == 0 ? kNone : count == 1 ? index : kSeveral) << (8 * p);
    }
    // u and w streamed out (evict first); the candidates stay cached
    const long long o = static_cast<long long>(b) * HW + 4LL * q;
    __stcs(reinterpret_cast<float4*>(unc + o), make_float4(u[0], u[1], u[2], u[3]));
    __stcs(reinterpret_cast<float4*>(wgt + o), make_float4(w[0], w[1], w[2], w[3]));
    reinterpret_cast<float4*>(cand + o)[0] = make_float4(val[0], val[1], val[2], val[3]);
    code[o >> 2] = codes;
  });
  block_max<C>(cmax, red,
               part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * C);
}

// Pass 2, vector routes: the same CTA tiling.
// A pixel with one candidate class k takes k if its value is over thr[k]
// (strict, pseudo_generation.py:83), else the ignore label; a pixel with
// none the ignore label; a pixel with several reads its C probabilities
// again and counts the classes over their thresholds. Exact: thr[c] is at
// least cutoff_low or NaN, so no class at or under cutoff_low is ever over
// its threshold. The label of a pixel overwrites its candidate value.
template <int C>
__global__ void __launch_bounds__(kThreads)
uvem_mine_select(const float* __restrict__ probs,
                 const float* __restrict__ part, int* __restrict__ label,
                 const unsigned* __restrict__ code, int HW, long long sB,
                 long long sC, int nchw, int iters, Select s) {
  __shared__ float red[kWarps][C];
  __shared__ float s_thr[C];
  const int bx = blockIdx.x, b = blockIdx.y;
  const int nblk = gridDim.x;
  // the sample's class maxima from pass 1's rows, then the thresholds
  float cmax[C];
#pragma unroll
  for (int c = 0; c < C; ++c) cmax[c] = -INFINITY;
  for (int r = threadIdx.x; r < nblk; r += kThreads) {
    const float* row = part + (static_cast<size_t>(b) * nblk + r) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) cmax[c] = nan_max(cmax[c], __ldg(row + c));
  }
  block_max<C>(cmax, red, s_thr);
  __syncthreads();
  if (threadIdx.x < C) {
    const float x = __fmul_rn(s_thr[threadIdx.x], s.top);
    s_thr[threadIdx.x] = isnan(x) ? x : fmaxf(x, s.low);
  }
  __syncthreads();

  const int groups = HW >> 2;
  const float* src = probs + b * sB;
  const long long base = static_cast<long long>(b) * HW;
  const float* cand = reinterpret_cast<const float*>(label);
  for (int i = 0, q = bx * iters * kThreads + threadIdx.x;
       i < iters && q < groups; ++i, q += kThreads) {
    const long long o = base + 4LL * q;
    const float4 c4 = *reinterpret_cast<const float4*>(cand + o);
    const unsigned codes = code[o >> 2];
    const float val[4] = {c4.x, c4.y, c4.z, c4.w};
    int lab[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const unsigned k = (codes >> (8 * p)) & 255u;
      lab[p] = s.ignore;
      if (k < static_cast<unsigned>(C)) {
        if (val[p] > s_thr[k]) lab[p] = static_cast<int>(k);
      } else if (k == kSeveral) {
        const int px = 4 * q + p;
        int count = 0, index = 0;
        for (int c = 0; c < C; ++c) {
          const float x = __ldg(nchw ? src + c * sC + px
                                     : src + static_cast<long long>(px) * C + c);
          if (x > s_thr[c]) {
            ++count;
            index = c;
          }
        }
        if (count == 1) lab[p] = index;
      }
    }
    __stcs(reinterpret_cast<int4*>(label + o),
           make_int4(lab[0], lab[1], lab[2], lab[3]));
  }
}

// The strided route's 4 pixels [4q, 4q + 4) of a sample: element offsets
// y * sH + x * sW and whether each lies inside H * W
struct Pixels {
  long long off[4];
  bool ok[4];
  __device__ Pixels(int q, int H, int W, long long sH, long long sW) {
    const int p0 = 4 * q;
    int y = static_cast<int>(static_cast<unsigned>(p0) / static_cast<unsigned>(W));
    int x = p0 - y * W;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ok[k] = y < H;
      off[k] = y * sH + x * sW;
      if (++x == W) {
        x = 0;
        ++y;
      }
    }
  }
};

// Pass 1, strided route: 4 pixels a thread, a runtime class loop; each
// class's block maximum goes through red, 32 classes between barriers
__global__ void __launch_bounds__(kThreads)
uvem_mine_stats_strided(const float* __restrict__ probs,
                        float* __restrict__ part, float* __restrict__ wgt,
                        float* __restrict__ unc, int C, int H, int W,
                        long long sB, long long sC, long long sH,
                        long long sW, Weights k) {
  __shared__ float red[kWarps][32];
  const int b = blockIdx.y;
  const int HW = H * W;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const Pixels px(q, H, W, sH, sW);
  const float* src = probs + b * sB;
  float* out = part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < C; ++c) {
    float m = -INFINITY;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (!px.ok[p]) continue;
      const float v = __ldg(src + px.off[p] + c * sC);
      acc[p] = __fadd_rn(acc[p], ent_term(v));
      m = nan_max(m, v);
    }
    m = warp_max(m);
    if (lane == 0) red[warp][c & 31] = m;
    if ((c & 31) == 31 || c == C - 1) {
      __syncthreads();
      const int c0 = c & ~31;
      if (static_cast<int>(threadIdx.x) <= c - c0) {
        float r = red[0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) r = nan_max(r, red[w][threadIdx.x]);
        out[c0 + threadIdx.x] = r;
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if (!px.ok[p]) continue;
    const long long o = static_cast<long long>(b) * HW + 4LL * q + p;
    unc[o] = -acc[p];
    wgt[o] = uvem_w(-acc[p], k);
  }
}

// Pass 2, strided route: the thresholds in dynamic shared memory (C
// floats, a warp a class), then 4 pixels a thread
__global__ void __launch_bounds__(kThreads)
uvem_mine_select_strided(const float* __restrict__ probs,
                         const float* __restrict__ part,
                         int* __restrict__ label, int C, int H, int W,
                         long long sB, long long sC, long long sH,
                         long long sW, Select s) {
  extern __shared__ float s_thr[];
  const int bx = blockIdx.x, b = blockIdx.y;
  const int nblk = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < C; c += kWarps) {
    float m = -INFINITY;
    for (int r = lane; r < nblk; r += 32)
      m = nan_max(m, __ldg(part + (static_cast<size_t>(b) * nblk + r) * C + c));
    m = warp_max(m);
    if (lane == 0) {
      const float x = __fmul_rn(m, s.top);
      s_thr[c] = isnan(x) ? x : fmaxf(x, s.low);
    }
  }
  __syncthreads();
  const int HW = H * W;
  const int q = bx * kThreads + threadIdx.x;
  const Pixels px(q, H, W, sH, sW);
  const float* src = probs + b * sB;
  int count[4] = {0, 0, 0, 0}, index[4] = {0, 0, 0, 0};
  for (int c = 0; c < C; ++c) {
    const float t = s_thr[c];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (px.ok[p] && __ldg(src + px.off[p] + c * sC) > t) {
        ++count[p];
        index[p] = c;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
    if (px.ok[p])
      label[static_cast<long long>(b) * HW + 4LL * q + p] =
          count[p] == 1 ? index[p] : s.ignore;
}

template <int C>
cudaError_t launch_vec(const float* probs, float* part, int* label,
                       float* wgt, float* unc, unsigned* code, int HW,
                       long long sB, long long sC, int nchw, int iters,
                       const Weights& k, const Select& s,
                       dim3 grid, cudaStream_t st) {
  uvem_mine_stats<C><<<grid, kThreads, 0, st>>>(
      probs, part, wgt, unc, reinterpret_cast<float*>(label), code, HW, sB,
      sC, nchw, iters, k, s.low);
  uvem_mine_select<C><<<grid, kThreads, 0, st>>>(
      probs, part, label, code, HW, sB, sC, nchw, iters, s);
  return cudaGetLastError();
}

}  // namespace

// probs: f32 on the device, element (b, c, y, x) at b*sB + c*sC + y*sH +
// x*sW; part: B * blocks * C f32 of scratch; code: B * H * W bytes of
// scratch (4-byte aligned; unused on the strided route); label (int32), w
// and u (f32):
// (B, H, W) contiguous on the device, 16-byte aligned on the vector routes.
// m, t, cl, cr, e as the Weights fields above; top, low, ignore_label as
// Select's. plan (n = 5 ints, from ops/mine.py: uvem_mine_plan): route (0
// channels_last, 1 NCHW: C 2..16, H*W a multiple of 4, probs 16-byte
// aligned, the layout's strides; 2 strided: any), pixels a thread (4, 8 or
// 16; 4 on the strided route), blocks a sample (ceil(H*W / (256 * ppt))),
// grid y (B), dynamic shared memory of pass 2 (4*C bytes on the strided
// route, else 0). Anything else
// is refused. Launches pass 1 and pass 2 on the stream.
extern "C" int uemda_uvem_mine(const void* probs, void* part, void* code,
                               void* label, void* w, void* u, int B, int C,
                               int H, int W,
                               long long sB, long long sC, long long sH,
                               long long sW, float m, float t, float cl,
                               float cr, float e, int has_left, int has_right,
                               float top, float low, int ignore_label,
                               const int* plan, int n, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || B > 65535 || C > kMaxC ||
      static_cast<long long>(H) * W > 0x7ffffff0LL || !plan || n != 5)
    return cudaErrorInvalidValue;
  const int route = plan[0], ppt = plan[1], blocks = plan[2];
  const int smem = plan[4];
  const int HW = H * W;
  const bool vec = route == 0 || route == 1;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  if (route < 0 || route > 2 || plan[3] != B ||
      (vec ? !(ppt == 4 || ppt == 8 || ppt == 16) || C < 2 || C > 16 ||
                 HW % 4 || sB % 4 || !aligned(probs) || !aligned(label) ||
                 !aligned(w) || !aligned(u) || !code ||
                 (reinterpret_cast<uintptr_t>(code) & 3) || smem != 0
           : ppt != 4 || smem != 4 * C) ||
      (route == 0 && (sC != 1 || sW != C || sH != static_cast<long long>(W) * C)) ||
      (route == 1 && (sW != 1 || sH != W || sC % 4)) ||
      static_cast<long long>(blocks) * kThreads * ppt < HW ||
      static_cast<long long>(blocks - 1) * kThreads * ppt >= HW)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights k{m, t, cl, cr, e, has_left, has_right};
  const Select s{top, low, ignore_label};
  const dim3 grid(blocks, B);
  const float* p = static_cast<const float*>(probs);
  float* pt = static_cast<float*>(part);
  int* lab = static_cast<int*>(label);
  float* wg = static_cast<float*>(w);
  float* un = static_cast<float*>(u);
  if (!vec) {
    uvem_mine_stats_strided<<<grid, kThreads, 0, st>>>(p, pt, wg, un, C, H, W,
                                                       sB, sC, sH, sW, k);
    uvem_mine_select_strided<<<grid, kThreads, smem, st>>>(
        p, pt, lab, C, H, W, sB, sC, sH, sW, s);
    return cudaGetLastError();
  }
  const int iters = ppt / 4;
  const int nchw = route == 1;
  switch (C) {
#define UEMDA_MINE(CC)                                                       \
  case CC:                                                                   \
    return launch_vec<CC>(p, pt, lab, wg, un, static_cast<unsigned*>(code),  \
                          HW, sB, sC, nchw, iters, k, s, grid, st);
    UEMDA_MINE(2) UEMDA_MINE(3) UEMDA_MINE(4) UEMDA_MINE(5) UEMDA_MINE(6)
    UEMDA_MINE(7) UEMDA_MINE(8) UEMDA_MINE(9) UEMDA_MINE(10) UEMDA_MINE(11)
    UEMDA_MINE(12) UEMDA_MINE(13) UEMDA_MINE(14) UEMDA_MINE(15)
    UEMDA_MINE(16)
#undef UEMDA_MINE
  }
  return cudaErrorInvalidValue;
}
