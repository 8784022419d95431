// The second pass of the weight-gradient kernels (KB1, KB2): the partial
// sums that each split of the reduction over positions wrote to the f32
// workspace, summed in a fixed order, so results are identical from run to
// run (no float atomics).
#pragma once

#include "common.cuh"

namespace {

constexpr int RED_E = 32;   // outputs per block, one per lane
constexpr int RED_CH = 16;  // runs of splits per output, one per warp

// out[o, e] = sum_{s < nsum} ws[o * nsum + s, e]: warp w sums splits
// [w * n, (w + 1) * n) in order, then warp 0 adds the RED_CH runs in order.
__global__ void __launch_bounds__(RED_E * RED_CH)
dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int64_t AN,
                 int64_t nsum) {
  __shared__ float part[RED_CH][RED_E];
  const int lane = threadIdx.x % RED_E, run = threadIdx.x / RED_E;
  const int64_t e = (int64_t)blockIdx.x * RED_E + lane, o = blockIdx.y;
  const int64_t n = coma::cdiv(nsum, RED_CH), s0 = run * n;
  const int64_t s1 = s0 + n < nsum ? s0 + n : nsum;
  float s = 0.f;
  if (e < AN) {
    const float* p = ws + o * nsum * AN + e;
#pragma unroll 4
    for (int64_t i = s0; i < s1; ++i) s += p[i * AN];
  }
  part[run][lane] = s;
  __syncthreads();
  if (run == 0 && e < AN) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < RED_CH; ++r) t += part[r][lane];
    out[o * AN + e] = t;
  }
}

// Sums the workspace of `splits` = B * sps partials of AN floats each into
// out: per sample ([B, AN], sps partials each) or over the batch ([AN]).
inline cudaError_t launch_dw_reduce(const float* ws, float* out, int64_t AN, int64_t B,
                                    int64_t sps, int64_t per_sample, cudaStream_t stream) {
  const dim3 grid((unsigned)coma::cdiv(AN, RED_E), (unsigned)(per_sample ? B : 1));
  dw_reduce_kernel<<<grid, RED_E * RED_CH, 0, stream>>>(ws, out, AN, per_sample ? sps : B * sps);
  return cudaGetLastError();
}

}  // namespace
