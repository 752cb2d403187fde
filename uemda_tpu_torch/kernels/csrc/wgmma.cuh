// wgmma.mma_async wrappers, m64nNk16, bf16 in, f32 accumulate (sm_90a).
//
// acc holds the warpgroup's m64 x N f32 tile as wgmma lays it out: for the
// n8 block j, acc[OFF + 4j + 2h + e] is row 16 * (warp % 4) + g + 8h,
// column 8j + 2t + e (g = lane / 4, t = lane % 4). B is always a shared-
// memory descriptor of an N x 16 K-major (weight) tile; A is either a
// descriptor of a 64 x 16 K-major tile (ss) or four registers holding the
// warp's 16 rows exactly as mma.sync m16n8k16's A fragment (rs). scale_d 0
// ignores the accumulator (the first k-step of a sum). The registers of an
// rs A must stay unchanged until the wgmma group that reads them retires.
#pragma once

#include <stdint.h>

template <int OFF, int ACC>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[ACC], uint64_t da,
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 16 <= ACC, "accumulator overflow");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int OFF, int ACC>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[ACC],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 16 <= ACC, "accumulator overflow");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int OFF, int ACC>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[ACC], uint64_t da,
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 32 <= ACC, "accumulator overflow");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int OFF, int ACC>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[ACC],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 32 <= ACC, "accumulator overflow");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int OFF, int ACC>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[ACC], uint64_t da,
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 64 <= ACC, "accumulator overflow");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]), "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int OFF, int ACC>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[ACC],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 64 <= ACC, "accumulator overflow");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]), "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int OFF, int ACC>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[ACC], uint64_t da,
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 128 <= ACC, "accumulator overflow");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]), "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]), "+f"(d[OFF + 64]), "+f"(d[OFF + 65]), "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71]), "+f"(d[OFF + 72]), "+f"(d[OFF + 73]), "+f"(d[OFF + 74]), "+f"(d[OFF + 75]), "+f"(d[OFF + 76]), "+f"(d[OFF + 77]), "+f"(d[OFF + 78]), "+f"(d[OFF + 79]), "+f"(d[OFF + 80]), "+f"(d[OFF + 81]), "+f"(d[OFF + 82]), "+f"(d[OFF + 83]), "+f"(d[OFF + 84]), "+f"(d[OFF + 85]), "+f"(d[OFF + 86]), "+f"(d[OFF + 87]), "+f"(d[OFF + 88]), "+f"(d[OFF + 89]), "+f"(d[OFF + 90]), "+f"(d[OFF + 91]), "+f"(d[OFF + 92]), "+f"(d[OFF + 93]), "+f"(d[OFF + 94]), "+f"(d[OFF + 95]), "+f"(d[OFF + 96]), "+f"(d[OFF + 97]), "+f"(d[OFF + 98]), "+f"(d[OFF + 99]), "+f"(d[OFF + 100]), "+f"(d[OFF + 101]), "+f"(d[OFF + 102]), "+f"(d[OFF + 103]), "+f"(d[OFF + 104]), "+f"(d[OFF + 105]), "+f"(d[OFF + 106]), "+f"(d[OFF + 107]), "+f"(d[OFF + 108]), "+f"(d[OFF + 109]), "+f"(d[OFF + 110]), "+f"(d[OFF + 111]), "+f"(d[OFF + 112]), "+f"(d[OFF + 113]), "+f"(d[OFF + 114]), "+f"(d[OFF + 115]), "+f"(d[OFF + 116]), "+f"(d[OFF + 117]), "+f"(d[OFF + 118]), "+f"(d[OFF + 119]), "+f"(d[OFF + 120]), "+f"(d[OFF + 121]), "+f"(d[OFF + 122]), "+f"(d[OFF + 123]), "+f"(d[OFF + 124]), "+f"(d[OFF + 125]), "+f"(d[OFF + 126]), "+f"(d[OFF + 127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int OFF, int ACC>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[ACC],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 128 <= ACC, "accumulator overflow");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]), "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]), "+f"(d[OFF + 64]), "+f"(d[OFF + 65]), "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71]), "+f"(d[OFF + 72]), "+f"(d[OFF + 73]), "+f"(d[OFF + 74]), "+f"(d[OFF + 75]), "+f"(d[OFF + 76]), "+f"(d[OFF + 77]), "+f"(d[OFF + 78]), "+f"(d[OFF + 79]), "+f"(d[OFF + 80]), "+f"(d[OFF + 81]), "+f"(d[OFF + 82]), "+f"(d[OFF + 83]), "+f"(d[OFF + 84]), "+f"(d[OFF + 85]), "+f"(d[OFF + 86]), "+f"(d[OFF + 87]), "+f"(d[OFF + 88]), "+f"(d[OFF + 89]), "+f"(d[OFF + 90]), "+f"(d[OFF + 91]), "+f"(d[OFF + 92]), "+f"(d[OFF + 93]), "+f"(d[OFF + 94]), "+f"(d[OFF + 95]), "+f"(d[OFF + 96]), "+f"(d[OFF + 97]), "+f"(d[OFF + 98]), "+f"(d[OFF + 99]), "+f"(d[OFF + 100]), "+f"(d[OFF + 101]), "+f"(d[OFF + 102]), "+f"(d[OFF + 103]), "+f"(d[OFF + 104]), "+f"(d[OFF + 105]), "+f"(d[OFF + 106]), "+f"(d[OFF + 107]), "+f"(d[OFF + 108]), "+f"(d[OFF + 109]), "+f"(d[OFF + 110]), "+f"(d[OFF + 111]), "+f"(d[OFF + 112]), "+f"(d[OFF + 113]), "+f"(d[OFF + 114]), "+f"(d[OFF + 115]), "+f"(d[OFF + 116]), "+f"(d[OFF + 117]), "+f"(d[OFF + 118]), "+f"(d[OFF + 119]), "+f"(d[OFF + 120]), "+f"(d[OFF + 121]), "+f"(d[OFF + 122]), "+f"(d[OFF + 123]), "+f"(d[OFF + 124]), "+f"(d[OFF + 125]), "+f"(d[OFF + 126]), "+f"(d[OFF + 127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// wgmma_ss<N, OFF> / wgmma_rs<N, OFF>: the wrapper of width N.
template <int N, int OFF, int ACC>
__device__ __forceinline__ void wgmma_ss(float (&d)[ACC], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32<OFF>(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64<OFF>(d, da, db, scale_d);
  else if constexpr (N == 128) wgmma_ss_n128<OFF>(d, da, db, scale_d);
  else if constexpr (N == 256) wgmma_ss_n256<OFF>(d, da, db, scale_d);
  else static_assert(N == 32, "wgmma width");
}

template <int N, int OFF, int ACC>
__device__ __forceinline__ void wgmma_rs(float (&d)[ACC],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_rs_n32<OFF>(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_rs_n64<OFF>(d, a, db, scale_d);
  else if constexpr (N == 128) wgmma_rs_n128<OFF>(d, a, db, scale_d);
  else if constexpr (N == 256) wgmma_rs_n256<OFF>(d, a, db, scale_d);
  else static_assert(N == 32, "wgmma width");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep a register's value where it is until this point (an rs A operand
// or an accumulator in flight).
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
