// K2: fused stem conv + bias + ReLU + 3x3/s2 max-pool of the serving path.
//
// Replaces uemda_tpu/ops/pallas_stem.py:stem_pool_pallas (_kernel). The
// BN-folded 7x7/s2 stem arrives re-indexed by infer/fastpath._s2d_stem_kernel
// as a 4x4/s1 conv on the 2x2 space-to-depth input (12 channels), padding
// (2, 1) per axis. Only the pooled map is written.
//
// Bound on the H100: bytes, nearly. At batch 8 and 512^2 tiles the conv is
// 8 * 256 * 256 * 64 * 192 * 2 = 12.9 GFLOP (0.013 ms on the bf16 tensor
// cores) against 12.6 MB in and 16.8 MB out (0.0088 ms at 3.35 TB/s). Run
// as f32 FMAs on the CUDA cores (67 TFLOP/s) the same conv takes 0.19 ms at
// best, so the bf16 kernel puts it on the tensor cores.
//
// bf16 design: an implicit GEMM with M the conv pixels of a tile, N = 64,
// K = 192, on mma.sync m16n8k16 (bf16 in, f32 accumulate). With the HWIO
// weight flattened as K = ky * 48 + kx * 12 + ci, every ky contributes 48
// contiguous values of one row of the NHWC input tile (4 neighbouring
// pixels x 12 channels), so each A fragment is read straight from the bf16
// input tile in shared memory, no im2col copy. mma.sync and not wgmma: a
// pixel's row starts every 24 bytes, which neither ldmatrix (16-byte rows)
// nor a wgmma descriptor (8-row core matrices of 16-byte rows) can address
// without that copy; the whole 24 KB weight sits in shared memory once per
// block (transposed to N x K, rows padded to spread the banks), and the
// conv of a tile is ~27 MFLOP, which mma.sync runs in a few microseconds.
// A persistent grid (one block a SM) walks the tiles, so the weight is
// staged once per SM. A tile is 16 x 16 pooled pixels: 33 x 33 conv pixels
// (pool rows/cols 2t-1 .. 2t+1) from a 36 x 36 input tile (3 conv rows
// above and 1 below, pallas_stem.py:30-33), zero outside the image (the
// conv's zero padding). Each warp takes two m16 tiles of conv pixels at a
// time against all 64 channels. Epilogue: the f32 sum is rounded to bf16,
// the bf16 bias added and rounded again, ReLU (fastpath._conv, :204-214),
// and the conv tile is stored in bf16 in shared memory -- exact, every value
// is bf16 already. Conv pixels outside the image (the pool's padding) hold
// 0: after the ReLU every value is >= 0, so zero padding equals the -inf
// padding of models/resnet._max_pool_3x3_s2 (pallas_stem.py:35-36). The
// pool reads 16-byte channel groups and writes the pooled map with 16-byte
// stores.
//
// f32 design (CUDA cores, no TF32): one block per 8 x 8 pooled tile, input
// tile, weight and conv tile in f32 shared memory, FMAs.
//
// Layout: x (B, H2, W2, 12) and out (B, ceil(H2/2), ceil(W2/2), 64) NHWC in
// memory (the pooled size of max_pool2d(3, 2, 1), odd H2 or W2 included); the
// weight (4, 4, 12, 64) HWIO contiguous; the bias (64,) f32. The launch plan
// (tile, grid, shared memory) comes from ops/stem.py: stem_plan; the
// launcher checks it.

#include "common.cuh"

namespace {

constexpr int CIN = 12;
constexpr int COUT = 64;
constexpr int KS = 4;
constexpr int KDIM = KS * KS * CIN;  // 192
constexpr int kThreads = 256;

// ===================== f32: CUDA cores =====================================

constexpr int TP = 8;           // pooled rows per block
constexpr int TQ = 8;           // pooled cols per block
constexpr int CR = 2 * TP + 1;  // conv rows per block
constexpr int CC = 2 * TQ + 1;  // conv cols per block
constexpr int IR = CR + 3;      // input rows incl. halo
constexpr int IC = CC + 3;      // input cols incl. halo
constexpr int GROUPS = kThreads / COUT;       // conv columns handled in turn
constexpr int NJ = (CC + GROUPS - 1) / GROUPS;  // conv columns per thread
constexpr int kSmemF32 =
    sizeof(float) * (IR * IC * CIN + KDIM * COUT + CR * CC * COUT);

__global__ void __launch_bounds__(kThreads)
stem_pool_fma(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out, int H2,
              int W2, int H4, int W4) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [IR][IC][CIN]
  float* ws = xs + IR * IC * CIN;            // [KS*KS*CIN][COUT]
  float* cv = ws + KDIM * COUT;              // [CR][CC][COUT]

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * TP;
  const int s0 = blockIdx.x * TQ;
  // tile conv row i is conv row 2*t0-1+i; it reads input rows
  // (2*t0-1+i)-2 .. +1, i.e. tile input rows i .. i+3 from r_in0
  const int r_in0 = 2 * t0 - 3;
  const int c_in0 = 2 * s0 - 3;

  for (int i = threadIdx.x; i < IR * IC * CIN; i += kThreads) {
    const int ci = i % CIN;
    const int cc = (i / CIN) % IC;
    const int rr = i / (CIN * IC);
    const int r = r_in0 + rr, c = c_in0 + cc;
    float v = 0.f;
    if (r >= 0 && r < H2 && c >= 0 && c < W2)
      v = x[((static_cast<size_t>(b) * H2 + r) * W2 + c) * CIN + ci];
    xs[i] = v;
  }
  for (int i = threadIdx.x; i < KDIM * COUT; i += kThreads) ws[i] = w[i];
  __syncthreads();

  const int o = threadIdx.x % COUT;
  const int g = threadIdx.x / COUT;
  const float bo = bias[o];

  for (int i = 0; i < CR; ++i) {
    float acc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
    for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
        const float* xrow = xs + ((i + ky) * IC + kx) * CIN;
        const float* wk = ws + (ky * KS + kx) * CIN * COUT + o;
#pragma unroll
        for (int c4 = 0; c4 < CIN / 4; ++c4) {
          const float w0 = wk[(4 * c4 + 0) * COUT];
          const float w1 = wk[(4 * c4 + 1) * COUT];
          const float w2 = wk[(4 * c4 + 2) * COUT];
          const float w3 = wk[(4 * c4 + 3) * COUT];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int jj = g + j * GROUPS;
            if (jj < CC) {
              const float4 xv =
                  *reinterpret_cast<const float4*>(xrow + jj * CIN + 4 * c4);
              acc[j] += xv.x * w0;
              acc[j] += xv.y * w1;
              acc[j] += xv.z * w2;
              acc[j] += xv.w * w3;
            }
          }
        }
      }
    }
    const int r = 2 * t0 - 1 + i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int jj = g + j * GROUPS;
      if (jj < CC) {
        const int c = 2 * s0 - 1 + jj;
        float v = 0.f;
        if (r >= 0 && r < H2 && c >= 0 && c < W2) v = fmaxf(acc[j] + bo, 0.f);
        cv[(i * CC + jj) * COUT + o] = v;
      }
    }
  }
  __syncthreads();

  for (int q = g; q < TP * TQ; q += GROUPS) {
    const int tp = q / TQ, tq = q % TQ;
    const int t = t0 + tp, s = s0 + tq;
    if (t >= H4 || s >= W4) continue;
    float m = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, cv[((2 * tp + dy) * CC + 2 * tq + dx) * COUT + o]);
    out[((static_cast<size_t>(b) * H4 + t) * W4 + s) * COUT + o] = m;
  }
}

// ===================== bf16: tensor cores (mma.sync) =======================

constexpr int BP = 16;            // pooled rows and cols of a tile
constexpr int BC = 2 * BP + 1;    // conv rows and cols: 33
constexpr int BI = BC + 3;        // input rows and cols: 36
constexpr int NPIX = BC * BC;     // conv pixels of a tile: 1089
constexpr int NMT = (NPIX + 15) / 16;  // m16 tiles: 69
constexpr int WLD = KDIM + 8;     // weight row (bf16), N x K
constexpr int CLD = COUT + 8;     // conv-tile row (bf16)
constexpr int kXsBytes = BI * BI * CIN * 2;         // 31,104
constexpr int kWsBytes = COUT * WLD * 2;            // 25,600
constexpr int kCvBytes = NPIX * CLD * 2;            // 156,816
constexpr int kSmemBf16 = kXsBytes + kWsBytes + kCvBytes;

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1)
stem_pool_mma(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w,
              const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
              int B, int H2, int W2, int H4, int W4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BI][BI][CIN]
  __nv_bfloat16* ws = xs + BI * BI * CIN;                          // [COUT][WLD]
  __nv_bfloat16* cv = ws + COUT * WLD;                             // [NPIX][CLD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // the weight, once per block: HWIO (K x N) -> N x K
  for (int i = threadIdx.x; i < KDIM * COUT; i += kThreads)
    ws[(i % COUT) * WLD + i / COUT] = w[i];

  const int tiles_x = (W4 + BP - 1) / BP, tiles_y = (H4 + BP - 1) / BP;
  const int n_tiles = B * tiles_x * tiles_y;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / (tiles_x * tiles_y);
    const int t0 = (tile / tiles_x) % tiles_y * BP, s0 = tile % tiles_x * BP;
    const int r_in0 = 2 * t0 - 3, c_in0 = 2 * s0 - 3;
    __syncthreads();  // the previous tile's conv tile and input are done
    // input tile: 36 x 36 pixels of 24 bytes, three 8-byte pieces each
    for (int i = threadIdx.x; i < BI * BI * 3; i += kThreads) {
      const int px = i / 3, part = i % 3;
      const int r = r_in0 + px / BI, c = c_in0 + px % BI;
      uint2 v = make_uint2(0u, 0u);
      if (r >= 0 && r < H2 && c >= 0 && c < W2)
        v = __ldg(reinterpret_cast<const uint2*>(
                x + ((static_cast<size_t>(b) * H2 + r) * W2 + c) * CIN) +
            part);
      reinterpret_cast<uint2*>(xs + px * CIN)[part] = v;
    }
    __syncthreads();

    // conv: pairs of m16 tiles per warp, all 64 channels
    for (int mp = warp * 2; mp < NMT; mp += 2 * (kThreads / 32)) {
      float acc[2][8][4];
      int base[2][2];  // element offset of the row's input pixel (ky = 0)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int p = (mp + u) * 16 + g + 8 * h;
          if (p >= NPIX) p = 0;  // padding rows: any pixel, discarded
          base[u][h] = ((p / BC) * BI + p % BC) * CIN;
        }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KDIM / 16; ++ks) {
        const int ky = ks / 3, kof = (ks % 3) * 16 + 2 * t;
        uint32_t a[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const __nv_bfloat16* r0p = xs + base[u][0] + ky * BI * CIN + kof;
          const __nv_bfloat16* r1p = xs + base[u][1] + ky * BI * CIN + kof;
          a[u][0] = lds32(r0p);
          a[u][1] = lds32(r1p);
          a[u][2] = lds32(r0p + 8);
          a[u][3] = lds32(r1p + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const __nv_bfloat16* bp = ws + (nt * 8 + g) * WLD + ks * 16 + 2 * t;
          const uint32_t b0 = lds32(bp), b1 = lds32(bp + 8);
          mma_bf16(acc[0][nt], a[0], b0, b1);
          mma_bf16(acc[1][nt], a[1], b0, b1);
        }
      }
      // epilogue: round, bias, round, ReLU; 0 outside the image
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (mp + u) * 16 + g + 8 * h;
          if (p >= NPIX) continue;
          const int r = 2 * t0 - 1 + p / BC, c = 2 * s0 - 1 + p % BC;
          const bool inside = r >= 0 && r < H2 && c >= 0 && c < W2;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int n = nt * 8 + 2 * t;
            const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + n));
            const float v0 = fmaxf(
                round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(acc[u][nt][2 * h]) +
                                        round_to<__nv_bfloat16>(bv.x)),
                0.f);
            const float v1 = fmaxf(
                round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(acc[u][nt][2 * h + 1]) +
                                        round_to<__nv_bfloat16>(bv.y)),
                0.f);
            *reinterpret_cast<__nv_bfloat162*>(cv + p * CLD + n) =
                inside ? __floats2bfloat162_rn(v0, v1)
                       : __floats2bfloat162_rn(0.f, 0.f);
          }
        }
    }
    __syncthreads();

    // 3x3/s2 pool, 8 channels (16 bytes) per item
    for (int i = threadIdx.x; i < BP * BP * (COUT / 8); i += kThreads) {
      const int cg = i % (COUT / 8), q = i / (COUT / 8);
      const int tp = q / BP, tq = q % BP;
      const int tt = t0 + tp, ss = s0 + tq;
      if (tt >= H4 || ss >= W4) continue;
      __nv_bfloat162 m[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) m[k] = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              cv + ((2 * tp + dy) * BC + 2 * tq + dx) * CLD + cg * 8);
          const __nv_bfloat162* vv = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int k = 0; k < 4; ++k) m[k] = __hmax2(m[k], vv[k]);
        }
      *reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(b) * H4 + tt) * W4 + ss) * COUT + cg * 8) =
          *reinterpret_cast<const uint4*>(m);
    }
  }
}

}  // namespace

// x: (B, H2, W2, 12); w: (4, 4, 12, 64) in x's type; bias: (64,) f32;
// out: (B, ceil(H2/2), ceil(W2/2), 64). plan: the n ints of ops/stem.py
// StemPlan.as_ints() -- design (1 mma, bf16; 0 fma, f32), pooled tile rows
// and cols, shared-memory bytes, grid x, y, z. A plan this launcher cannot
// run returns cudaErrorInvalidValue.
extern "C" int uemda_stem_pool(const void* x, const void* w, const void* bias,
                               void* out, int B, int H2, int W2,
                               const int* plan, int n, void* stream) {
  if (B <= 0 || H2 <= 0 || W2 <= 0 || !plan || n != 7)
    return cudaErrorInvalidValue;
  const int H4 = (H2 + 1) / 2, W4 = (W2 + 1) / 2;
  const int design = plan[0], tp = plan[1], tq = plan[2], smem = plan[3];
  const dim3 grid(plan[4], plan[5], plan[6]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bs = static_cast<const float*>(bias);
  cudaError_t e;
  if (design == 1) {
    const long tiles =
        static_cast<long>(B) * ((H4 + BP - 1) / BP) * ((W4 + BP - 1) / BP);
    if (tp != BP || tq != BP || smem != kSmemBf16 || grid.y != 1 ||
        grid.z != 1 || grid.x < 1 || grid.x > tiles)
      return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(stem_pool_mma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    stem_pool_mma<<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), bs,
        static_cast<__nv_bfloat16*>(out), B, H2, W2, H4, W4);
    return cudaGetLastError();
  }
  if (design != 0 || tp != TP || tq != TQ || smem != kSmemF32 ||
      static_cast<int>(grid.x) != (W4 + TQ - 1) / TQ ||
      static_cast<int>(grid.y) != (H4 + TP - 1) / TP ||
      static_cast<int>(grid.z) != B)
    return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(stem_pool_fma,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  stem_pool_fma<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bs,
      static_cast<float*>(out), H2, W2, H4, W4);
  return cudaGetLastError();
}
