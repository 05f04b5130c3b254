// Shared by every CUDA source of the port: the error string the Python
// wrappers report, one block's shared-memory limit, and the element
// conversions (inputs go to f32, results come back once).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Largest dynamic shared memory one block can ask for on sm_90.
#define REPRO_SMEM_LIMIT_BYTES 232448

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ inline T from_f32(float v);
template <> __device__ inline float from_f32<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
