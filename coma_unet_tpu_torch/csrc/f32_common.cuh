// Pieces of the float32 SIMT kernel FB1 (conv3d_dw_f32.cu): 4-byte cp.async
// with zero fill, and the staging of a box of an NCDHW tensor into shared
// memory.
#pragma once

#include "common.cuh"

namespace coma {
namespace f32 {

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies channels [c0, c0 + nc) of one sample's box of BD x BH x BW positions
// with its origin at (d0, h0, w0) (which may lie outside the volume) of
// src [C, D, H, W] into dst[c][dz][hy][col], col = wx, or with SPLIT the
// even positions along W first and then the odd ones (col = (wx & 1) *
// ((BW + 1) / 2) + wx / 2). A row takes ROW floats, a channel CSTRIDE.
// Values outside the volume or past channel C are zero. Consecutive threads
// take consecutive positions along W, so the global reads coalesce.
template <int BD, int BH, int BW, int ROW, bool SPLIT>
__device__ __forceinline__ void stage_box(float* dst, int cstride, const float* src, int64_t C,
                                          int D, int H, int W, int64_t c0, int nc, int d0,
                                          int h0, int w0, int tid, int nthreads) {
  const int total = nc * BD * BH * BW;
  for (int e = tid; e < total; e += nthreads) {
    const int wx = e % BW;
    int r = e / BW;
    const int hy = r % BH;
    r /= BH;
    const int dz = r % BD;
    const int c = r / BD;
    const int gd = d0 + dz, gh = h0 + hy, gw = w0 + wx;
    const bool ok = c0 + c < C && (unsigned)gd < (unsigned)D && (unsigned)gh < (unsigned)H &&
                    (unsigned)gw < (unsigned)W;
    const float* s = ok ? src + (((c0 + c) * D + gd) * (int64_t)H + gh) * W + gw : src;
    const int col = SPLIT ? (wx & 1) * ((BW + 1) / 2) + (wx >> 1) : wx;
    cp_async4(dst + c * cstride + (dz * BH + hy) * ROW + col, s, ok);
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

}  // namespace f32
}  // namespace coma
