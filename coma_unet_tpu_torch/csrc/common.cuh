// Helpers shared by the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (bound from Python with ctypes):
// pointers arrive as void*, sizes as int64_t, the CUDA stream last, and the
// return value is cudaGetLastError() after the launches, so a refused launch
// surfaces in the Python wrapper instead of being lost.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define COMA_API extern "C" __attribute__((visibility("default")))

namespace coma {

using bf16 = __nv_bfloat16;

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace coma

COMA_API const char* coma_error_string(int code);
