// Pieces of the float32 tensor-core kernels (F1: conv3d_s1_f32_tc.cu; F2:
// conv3d_s2_f32_tc.cu and conv3d_t2_f32_tc.cu; FB1: conv3d_dw_f32_tc.cu):
// f32 products to f32 accuracy from three TF32 mma.sync (3xTF32), the
// weight packing that splits w into its TF32 hi and lo planes, the swizzled
// W tile and the f32 global loads.
//
// 3xTF32: an operand a is split as hi = tf32(a), lo = tf32(a - hi), both
// rounded to nearest with ties away from zero (round_tf32); a b is then
// lo_a hi_b + hi_a lo_b + hi_a hi_b, in that order, into the same f32 sums.
// What it drops (lo_a lo_b and the rounding of lo) is near 2^-22 of a
// product, against 2^-11 for one TF32 product, so the sums keep f32's
// accuracy at a third of the TF32 rate (495 / 3 = 165 TFLOP/s on the H100
// against 67 for f32 FMAs).
//
// The f32 tiles keep the bf16 kernels' bytes: a chunk of CT = 8 f32
// channels is 32 bytes, as 16 bf16 are, so an X row of a chunk padded to 48
// bytes (XS = 12 floats: the 8 rows of one ldmatrix phase in distinct
// banks) and a W row of 32 bytes whose 16-byte units swap when bit 2 of the
// row is set read with the bf16 kernels' ldmatrix addressing; an 8 x 8 b16
// matrix of ldmatrix is an 8 x 4 f32 one, and the four of an x4 load are
// the m16n8k8 TF32 A fragment (rows 0-7 and 8-15 x channels 0-3, then 4-7)
// or the B fragments of two n-tiles.
#pragma once

#include "tc_common.cuh"

namespace coma {
namespace tf32 {

constexpr int CT = 8;   // input channels a chunk: one k8 step of the TF32 mma
constexpr int XS = 12;  // floats an X row: 8 channels padded to 3 16-byte units

// a rounded to TF32 (10 explicit mantissa bits), to nearest, ties away
// from zero: the f32 bit pattern with half a TF32 unit added to its
// magnitude and the low 13 bits cleared. For every finite a this is
// cvt.rna.tf32.f32, on the integer pipes (an add and a mask) instead of
// the conversion unit, whose lower rate the per-fragment splits would meet.
__device__ __forceinline__ uint32_t round_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// The raw f32 fragment a as its TF32 hi and lo parts.
__device__ __forceinline__ void split_frag(const uint32_t (&a)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = __uint_as_float(a[i]);
    hi[i] = round_tf32(v);
    lo[i] = round_tf32(v - __uint_as_float(hi[i]));
  }
}

// c += a (16 x 8, row-major) * b (8 x 8, column-major), TF32 in, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m][n] += a[m] b[n] in 3xTF32 over MT x NT tiles: lo_a hi_b, then
// hi_a lo_b, then hi_a hi_b, each term one pass over all the tiles, so that
// the three products into one tile stand MT NT mma apart.
template <int MT, int NT>
__device__ __forceinline__ void mma3(float (&acc)[MT][NT][4], const uint32_t (&ahi)[MT][4],
                                     const uint32_t (&alo)[MT][4], const uint32_t (&bh)[NT][2],
                                     const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], alo[m], bh[n][0], bh[n][1]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ahi[m], bl[n][0], bl[n][1]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ahi[m], bh[n][0], bh[n][1]);
}

// Float offset of 16-byte unit u of row r in a swizzled W tile of 32-byte
// rows (the bytes of tc_common.cuh:swz).
__device__ __forceinline__ int swz4(int r, int u) { return r * CT + ((u ^ ((r >> 2) & 1)) << 2); }

// N floats of the packed weights at src (contiguous) into the swizzled
// tile sw by 16-byte cp.async. Thread tid copies pieces tid + k THREADS:
// row tid / 2 + k THREADS / 2, unit tid % 2, and (THREADS / 2 a multiple of
// 8) the row's swizzle bit that of tid / 2, so its addresses step by a
// constant.
template <int N, int THREADS>
__device__ __forceinline__ void load_w32(float* sw, const float* src, int tid) {
  static_assert(THREADS % 16 == 0, "the swizzle bit of a thread's rows");
  constexpr int P = N / 4, K = P / THREADS;
  const uint32_t dst = smem_u32(sw) + swz4(tid >> 1, tid & 1) * 4;
  const float* const s = src + tid * 4;
#pragma unroll
  for (int k = 0; k < K; ++k) cp_async16(dst + k * THREADS * 16, s + k * THREADS * 4, true);
  if constexpr (P % THREADS != 0) {
    if (tid + K * THREADS < P) cp_async16(dst + K * THREADS * 16, s + K * THREADS * 4, true);
  }
}

// The B fragments of NT n-tiles of one W tile row block: hi from the plane
// at wt, lo from the plane AT rows after it (b_lane: the lane's byte offset,
// as tc_common.cuh:load_frags reads a tile); two n-tiles an ldmatrix.x4, an
// odd last one by ldmatrix.x2 (lanes 0-15 address it).
template <int NT, int AT>
__device__ __forceinline__ void load_b32(uint32_t (&bh)[NT][2], uint32_t (&bl)[NT][2],
                                         uint32_t wt) {
#pragma unroll
  for (int n = 0; n + 1 < NT; n += 2) {
    ldsm_x4(bh[n][0], bh[n][1], bh[n + 1][0], bh[n + 1][1], wt + n * 8 * CT * 4);
    ldsm_x4(bl[n][0], bl[n][1], bl[n + 1][0], bl[n + 1][1], wt + (AT + n * 8) * CT * 4);
  }
  if constexpr (NT % 2 == 1) {
    constexpr int n = NT - 1;
    ldsm_x2(bh[n][0], bh[n][1], wt + n * 8 * CT * 4);
    ldsm_x2(bl[n][0], bl[n][1], wt + (AT + n * 8) * CT * 4);
  }
}

// Read-only f32 global loads as volatile asm: issued where they stand,
// ahead of the products of the step before.
__device__ __forceinline__ float4 ldg_f4(const float* p) {
  float4 r;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ float ldg_f(const float* p) {
  float r;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(r) : "l"(p));
  return r;
}

// The 8 values row[w .. w + 8), zero at W and past it (w % 8 == 0; with
// VX = 4, W % 4 == 0 and row 16-byte aligned).
template <int VX>
__device__ __forceinline__ void ldg_row8(float4 (&v)[2], const float* row, int w, int W) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int wj = w + 4 * j;
    if constexpr (VX == 4) {
      v[j] = wj < W ? ldg_f4(row + wj) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      v[j].x = wj < W ? ldg_f(row + wj) : 0.f;
      v[j].y = wj + 1 < W ? ldg_f(row + wj + 1) : 0.f;
      v[j].z = wj + 2 < W ? ldg_f(row + wj + 2) : 0.f;
      v[j].w = wj + 3 < W ? ldg_f(row + wj + 3) : 0.f;
    }
  }
}

__device__ __forceinline__ float elem(const float4 (&v)[2], int e) {
  const float4& q = v[e / 4];
  return e % 4 == 0 ? q.x : e % 4 == 1 ? q.y : e % 4 == 2 ? q.z : q.w;
}

// wp[bw][at][ch][t][plane][o][cc] = the TF32 hi (plane 0) or lo (plane 1)
// part of w[bw][a][c][t], a = at * AT + o < A, c = ch * CT + cc < C, else
// zero; with flip, w is read as flip_t of the forward layer's
// [nw][C][A][T]. A chunk's W tile is then one contiguous run, and so is
// any run of its taps.
template <int T>
__global__ void __launch_bounds__(256)
    tf32_pack_weights(const float* __restrict__ w, float* __restrict__ wp, int A, int C, int AT,
                      int nat, int nch, int flip, int64_t total) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int cc = (int)(e % CT), o = (int)(e / CT % AT), plane = (int)(e / (CT * AT) % 2);
    const int t = (int)(e / (2 * CT * AT) % T);
    const int64_t r = e / ((int64_t)2 * CT * AT * T);
    const int ch = (int)(r % nch), at = (int)(r / nch % nat);
    const int64_t bw = r / ((int64_t)nch * nat);
    const int a = at * AT + o, c = ch * CT + cc;
    const int64_t src = flip ? ((bw * C + c) * A + a) * T + (T - 1 - t)
                             : ((bw * A + a) * C + c) * T + t;
    const float v = a < A && c < C ? w[src] : 0.f;
    const float hi = __uint_as_float(round_tf32(v));
    wp[e] = plane ? __uint_as_float(round_tf32(v - hi)) : hi;
  }
}

// Launches the packing of nw weight sets on `stream`; returns
// cudaGetLastError().
template <int T>
inline cudaError_t pack_weights_tf32(const float* w, float* wp, int A, int C, int AT, int nat,
                                     int nch, bool flip, int64_t nw, cudaStream_t stream) {
  const int64_t total = nw * nat * nch * (int64_t)T * 2 * AT * CT;
  const int64_t blocks = cdiv(total, 256) < 4096 ? cdiv(total, 256) : 4096;
  tf32_pack_weights<T><<<(unsigned)blocks, 256, 0, stream>>>(w, wp, A, C, AT, nat, nch, flip,
                                                             total);
  return cudaGetLastError();
}

}  // namespace tf32
}  // namespace coma
