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

// Copies the conv weights of input channels [ci0, ci0 + cc) and output
// channels [co0, co0 + Q) into shared memory as f32, laid out [ci][tap][q]
// with q innermost, so that a thread reads Q weights of one tap as float4s.
// `w` points at one [Cout, Cin, TAPS] weight (OIDHW with the taps flattened);
// channels past Cout or Cin read as zero.
template <int Q, int TAPS>
__device__ inline void load_weights(float* s_w, const bf16* __restrict__ w,
                                    int64_t cout, int64_t cin, int64_t co0,
                                    int64_t ci0, int cc, int tid, int nthreads) {
  for (int i = tid; i < cc * TAPS * Q; i += nthreads) {
    const int q = i % Q;
    const int tap = (i / Q) % TAPS;
    const int ci = i / (Q * TAPS);
    const int64_t co = co0 + q;
    const int64_t c = ci0 + ci;
    float v = 0.f;
    if (co < cout && c < cin) v = __bfloat162float(w[(co * cin + c) * TAPS + tap]);
    s_w[i] = v;
  }
}

// acc[q] += v * w[q] for the Q weights at s_w (16-byte aligned, Q % 4 == 0).
template <int Q>
__device__ __forceinline__ void fma_q(float* acc, float v, const float* s_w) {
#pragma unroll
  for (int q = 0; q < Q; q += 4) {
    const float4 wv = *reinterpret_cast<const float4*>(s_w + q);
    acc[q + 0] = fmaf(v, wv.x, acc[q + 0]);
    acc[q + 1] = fmaf(v, wv.y, acc[q + 1]);
    acc[q + 2] = fmaf(v, wv.z, acc[q + 2]);
    acc[q + 3] = fmaf(v, wv.w, acc[q + 3]);
  }
}

}  // namespace coma

COMA_API const char* coma_error_string(int code);
