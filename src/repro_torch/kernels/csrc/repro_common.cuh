// Shared by every CUDA source of the port: the error string the Python
// wrappers report, one block's shared-memory limit, the element
// conversions (inputs go to f32, results come back once), and the 16-byte
// asynchronous copy into shared memory with its group commit and wait.
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

// 16 bytes from device memory to shared memory, both 16-byte aligned,
// bypassing L1 (cp.async.cg); completes at a later repro_cp_async_wait.
__device__ inline void repro_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

__device__ inline void repro_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ inline void repro_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
