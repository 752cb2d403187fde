// Shared helpers of the port's kernels: f32 <-> storage-type conversion and
// the error string the Python wrappers report. Each .cu includes this once
// and is built into its own shared library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Round an f32 value to the storage type T and back.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

extern "C" const char* uemda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
