// The eval-mode BatchNorm epilogue of the standard forward in one pass:
// y = x * scale + shift (+ identity | + r * scale_r + shift_r), then ReLU,
// rounded once to the storage type.
//
// Replaces, for every BatchNorm that uses its running statistics while no
// gradient is wanted (uemda_tpu_torch/models/resnet.py: bn_act), the chain
// the library runs: cast the bf16 conv output to f32, f32 BatchNorm, cast
// back, then the residual add and the ReLU as two more passes -- about 24
// bytes moved per element where the math needs 4 (x in, y out) or 6 (and
// the residual). The per-channel scale = weight / sqrt(var + eps) and shift
// = bias - mean * scale are computed by every block from the module's own
// tensors (f32 or bf16) into shared memory before it streams, so nothing
// derived from the weights is cached outside the launch.
//
// Layout: x, the residual and y are channels_last (N, C, H, W), i.e. a flat
// NHWC buffer of n = N*H*W*C elements whose element e has channel e % C.
// Where C is a multiple of the 16-byte vector's elements (8 bf16 or 4 f32)
// and every pointer is 16-byte aligned, each thread moves 16-byte vectors,
// kUnroll of them in flight per loop trip, over a grid-stride loop; the
// vector's channels are consecutive and its scale and shift come from shared
// memory as float4s. Otherwise one element at a time (odd C). A thread's
// channel is carried from trip to trip by adding the grid stride's channel
// step (stride % C, one subtraction to wrap), so the loop does no division.
//
// Bound on the H100: bytes. At the sweep's largest BatchNorm (288 views of
// 256 x 128^2, bf16, identity residual) a launch reads 2 x 2.4 GB and
// writes 2.4 GB: ~2.2 ms at 3.35 TB/s.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // 16-byte vectors a thread has in flight
constexpr int kMinBlocks = 4;  // resident blocks an SM: at most 64 registers

// One BatchNorm's tensors on the device: running mean and variance, weight
// and bias, each C values of f32 or bf16 (bit i of the launch's mask set:
// tensor i is bf16, in the order mean, var, weight, bias).
struct Norm {
  const void* t[4];
  int bf16_mask;
  float eps;
};

__device__ __forceinline__ float param(const Norm& p, int i, int c) {
  return (p.bf16_mask >> i) & 1
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.t[i])[c])
             : static_cast<const float*>(p.t[i])[c];
}

// scale and shift of channel c: y = x * scale + shift is the BatchNorm
// (x - mean) / sqrt(var + eps) * weight + bias
__device__ __forceinline__ void affine(const Norm& p, int c, float& scale,
                                       float& shift) {
  scale = param(p, 2, c) / sqrtf(param(p, 1, c) + p.eps);
  shift = param(p, 3, c) - param(p, 0, c) * scale;
}

__device__ __forceinline__ float act(float v, bool relu) {
  return relu && v < 0.0f ? 0.0f : v;  // NaN passes, as clamp_min
}

// RES: 0 none, 1 identity (y += r), 2 BatchNorm'd residual
// (y += r * scale_r, its shift folded into the shift). VEC: the 16-byte
// route.
template <typename T, int RES, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bnact_kernel(const T* __restrict__ x, const T* __restrict__ r,
             T* __restrict__ y, long long n, int C, Norm p, Norm q,
             bool relu) {
  extern __shared__ float table[];  // scale[C], shift[C] (, scale_r[C])
  float* s_scale = table;
  float* s_shift = table + C;
  float* s_rscale = table + 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float sc, sh;
    affine(p, c, sc, sh);
    if (RES == 2) {
      float sr, hr;
      affine(q, c, sr, hr);
      s_rscale[c] = sr;
      sh += hr;
    }
    s_scale[c] = sc;
    s_shift[c] = sh;
  }
  __syncthreads();

  const unsigned gid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const long long nv = n / V;
    // channel of vector i is (i * V) % C, a multiple of V (C % V == 0)
    int c = static_cast<int>((gid % C) * V % C);
    const int step = static_cast<int>((stride % C) * V % C);
    for (long long base = gid; base < nv;
         base += static_cast<long long>(kUnroll) * stride) {
      uint4 xv[kUnroll], rv[kUnroll];
      int cc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + static_cast<long long>(u) * stride;
        cc[u] = c;
        c += step;
        if (c >= C) c -= C;
        if (i < nv) {
          xv[u] = __ldg(reinterpret_cast<const uint4*>(x) + i);
          if (RES) rv[u] = __ldg(reinterpret_cast<const uint4*>(r) + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + static_cast<long long>(u) * stride;
        if (i >= nv) break;
        const T* xe = reinterpret_cast<const T*>(&xv[u]);
        const T* re = reinterpret_cast<const T*>(&rv[u]);
        uint4 ov;
        T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const float4 sc = *reinterpret_cast<const float4*>(s_scale + cc[u] + j);
          const float4 sh = *reinterpret_cast<const float4*>(s_shift + cc[u] + j);
          float v[4] = {fmaf(to_f32(xe[j]), sc.x, sh.x),
                        fmaf(to_f32(xe[j + 1]), sc.y, sh.y),
                        fmaf(to_f32(xe[j + 2]), sc.z, sh.z),
                        fmaf(to_f32(xe[j + 3]), sc.w, sh.w)};
          if (RES == 1) {
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] += to_f32(re[j + k]);
          } else if (RES == 2) {
            const float4 sr =
                *reinterpret_cast<const float4*>(s_rscale + cc[u] + j);
            v[0] = fmaf(to_f32(re[j]), sr.x, v[0]);
            v[1] = fmaf(to_f32(re[j + 1]), sr.y, v[1]);
            v[2] = fmaf(to_f32(re[j + 2]), sr.z, v[2]);
            v[3] = fmaf(to_f32(re[j + 3]), sr.w, v[3]);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) oe[j + k] = from_f32<T>(act(v[k], relu));
        }
        reinterpret_cast<uint4*>(y)[i] = ov;
      }
    }
  } else {
    int c = static_cast<int>(gid % C);
    const int step = static_cast<int>(stride % C);
    for (long long i = gid; i < n; i += stride) {
      float v = fmaf(to_f32(x[i]), s_scale[c], s_shift[c]);
      if (RES == 1) v += to_f32(r[i]);
      if (RES == 2) v = fmaf(to_f32(r[i]), s_rscale[c], v);
      y[i] = from_f32<T>(act(v, relu));
      c += step;
      if (c >= C) c -= C;
    }
  }
}

template <typename T, int RES>
cudaError_t launch(const void* x, const void* r, void* y, long long n, int C,
                   bool vec, const Norm& p, const Norm& q, bool relu,
                   int grid, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(RES == 2 ? 3 : 2) * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vec ? bnact_kernel<T, RES, true> : bnact_kernel<T, RES, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  T* yt = static_cast<T*>(y);
  if (vec)
    bnact_kernel<T, RES, true><<<grid, kThreads, smem, s>>>(xt, rt, yt, n, C,
                                                            p, q, relu);
  else
    bnact_kernel<T, RES, false><<<grid, kThreads, smem, s>>>(xt, rt, yt, n, C,
                                                             p, q, relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int res, const void* x, const void* r, void* y,
                     long long n, int C, bool vec, const Norm& p,
                     const Norm& q, bool relu, int grid, cudaStream_t s) {
  switch (res) {
    case 0: return launch<T, 0>(x, r, y, n, C, vec, p, q, relu, grid, s);
    case 1: return launch<T, 1>(x, r, y, n, C, vec, p, q, relu, grid, s);
    default: return launch<T, 2>(x, r, y, n, C, vec, p, q, relu, grid, s);
  }
}

}  // namespace

// x, r (res_mode 1 or 2; else unused), y: n elements of the flat NHWC
// buffer of a channels_last (N, C, H, W) tensor, bf16 (is_bf16) or f32,
// one dtype; vec != 0: C % (16 / element size) == 0 and all three 16-byte
// aligned. norm / norm_r: {mean, var, weight, bias} device pointers of C
// values each, with their bf16 masks and eps; norm_r is read only at
// res_mode 2. grid: blocks of 256 threads, at most 2^31 - 1.
extern "C" int uemda_bnact(const void* x, const void* r, void* y,
                           long long n, int C, int is_bf16, int vec,
                           int res_mode, int relu, const void* const* norm,
                           int mask, float eps, const void* const* norm_r,
                           int mask_r, float eps_r, int grid, void* stream) {
  if (n <= 0 || C <= 0 || n % C || grid <= 0 || res_mode < 0 || res_mode > 2)
    return cudaErrorInvalidValue;
  if (static_cast<size_t>(res_mode == 2 ? 3 : 2) * C * sizeof(float) >
      227 * 1024)
    return cudaErrorInvalidValue;
  Norm p{{norm[0], norm[1], norm[2], norm[3]}, mask, eps};
  Norm q = p;
  if (res_mode == 2)
    q = Norm{{norm_r[0], norm_r[1], norm_r[2], norm_r[3]}, mask_r, eps_r};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(res_mode, x, r, y, n, C, vec != 0, p, q,
                                   relu != 0, grid, s);
  return dispatch<float>(res_mode, x, r, y, n, C, vec != 0, p, q, relu != 0,
                         grid, s);
}
