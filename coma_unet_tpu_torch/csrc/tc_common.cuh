// Pieces shared by the tensor-core kernels K1 (conv3d_s1_tc.cu), K2
// (conv3d_s2_tc.cu) and KB1 (conv3d_dw_tc.cu): shared-memory and cp.async
// wrappers, ldmatrix and the bf16 mma.sync, the read-only global loads
// issued as volatile asm, the staging of an X halo brick from NCDHW into
// channels-last shared memory, and the implicit GEMM per tap of K1 and K2
// with K1's weight packing.
#pragma once

#include "common.cuh"

namespace coma {

// Row length in bf16 padded to an odd number of 16-byte units.
constexpr int padded(int n) { return (n / 8) % 2 == 0 ? n + 8 : n; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Read-only global loads as volatile asm: issued where they stand, ahead of
// the products of the brick before.
__device__ __forceinline__ uint4 ldg_v4(const bf16* p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ uint2 ldg_v2(const bf16* p) {
  uint2 r;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n" : "=r"(r.x), "=r"(r.y) : "l"(p));
  return r;
}

__device__ __forceinline__ uint32_t ld_u16(const bf16* p) {
  unsigned short r;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(r) : "l"(p));
  return r;
}

// The 8 values row[w .. w + 8), zero at W and past it (w >= 0, w % VW == 0,
// W % VW == 0 for VW > 1).
template <int VW>
__device__ __forceinline__ uint4 ld_row8(const bf16* row, int w, int W) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (VW == 8) {
    if (w < W) r = ldg_v4(row + w);
  } else if constexpr (VW == 4) {
    if (w < W) {
      const uint2 lo = ldg_v2(row + w);
      r.x = lo.x;
      r.y = lo.y;
    }
    if (w + 4 < W) {
      const uint2 hi = ldg_v2(row + w + 4);
      r.z = hi.x;
      r.w = hi.y;
    }
  } else {
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = w + 2 * i < W ? ld_u16(row + w + 2 * i) : 0u;
      const uint32_t hi = w + 2 * i + 1 < W ? ld_u16(row + w + 2 * i + 1) : 0u;
      v[i] = lo | (hi << 16);
    }
    r = make_uint4(v[0], v[1], v[2], v[3]);
  }
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One X halo brick held in registers between its loads and its stores: per
// item, the 8-wide row piece of channels (c, c + 1) and their W-halo pair.
template <class Cf>
struct XRegs {
  uint4 v[Cf::NX][2];
  uint32_t e[Cf::NX];
};

// The share of an X halo brick [(BD+2R)(BH+2R)(BW+2R) positions][XS] that
// one thread stages, fixed for the block: channel pair t % (CTILE/2), row
// piece t / (CTILE/2) % 2 (w 0-7 or 8-15 of the brick, and the W-halo
// element on that side) of halo (d, h) rows t / CTILE + i * HRSTEP. Cf gives
// the brick (R, HH, HW, HROWS, BWID = 16), the row length XS (padded) and
// the map (CTILE, HRSTEP, NX); Args the sizes (C, D, H, W, plane).
template <class Cf>
struct XStager {
  const bf16* xc;   // channel c = c0 + 2 cp of this sample (clamped to a valid one)
  bool c0ok, c1ok;  // c < C, c + 1 < C
  int cp, v, hr0;   // channel pair, row piece, first halo row

  template <class Args>
  __device__ __forceinline__ XStager(const Args& p, const bf16* xb, int c0, int tid) {
    cp = tid % (Cf::CTILE / 2);
    v = tid / (Cf::CTILE / 2) % 2;
    hr0 = tid / Cf::CTILE;
    const int c = c0 + 2 * cp;
    c0ok = c < p.C;
    c1ok = c + 1 < p.C;
    xc = xb + (c0ok ? c : 0) * p.plane;
  }

  // X of the brick at (d0, h0, w0) into registers.
  template <int VW, class Args>
  __device__ __forceinline__ void load_x(XRegs<Cf>& r, const Args& p, int d0, int h0,
                                         int w0) const {
#pragma unroll
    for (int i = 0; i < Cf::NX; ++i) {
      r.v[i][0] = r.v[i][1] = make_uint4(0u, 0u, 0u, 0u);
      r.e[i] = 0u;
      const int hr = hr0 + i * Cf::HRSTEP;
      const int d = d0 - Cf::R + hr / Cf::HH, h = h0 - Cf::R + hr % Cf::HH;
      if (hr < Cf::HROWS && (unsigned)d < (unsigned)p.D && (unsigned)h < (unsigned)p.H) {
        const bf16* row = xc + (d * p.H + h) * p.W;
        const int w = w0 + 8 * v, we = v ? w0 + Cf::BWID : w0 - 1;
        const bool eok = Cf::R > 0 && (unsigned)we < (unsigned)p.W;
        if (c0ok) {
          r.v[i][0] = ld_row8<VW>(row, w, p.W);
          if (eok) r.e[i] = ld_u16(row + we);
        }
        if (c1ok) {
          r.v[i][1] = ld_row8<VW>(row + p.plane, w, p.W);
          if (eok) r.e[i] |= ld_u16(row + p.plane + we) << 16;
        }
      }
    }
  }

  // Registers -> the channels-last halo brick sx [XROWS][XS]: element e of
  // the row piece goes to halo position (hr, R + 8 v + e), channels
  // (2 cp, 2 cp + 1); the halo element to (hr, v ? HW - 1 : 0).
  __device__ __forceinline__ void store_x(const XRegs<Cf>& r, bf16* sx) const {
#pragma unroll
    for (int i = 0; i < Cf::NX; ++i) {
      const int hr = hr0 + i * Cf::HRSTEP;
      if (hr < Cf::HROWS) {
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(sx + (hr * Cf::HW + Cf::R + 8 * v) * Cf::XS) + cp;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e * (Cf::XS / 2)] = __byte_perm(word(r.v[i][0], e / 2), word(r.v[i][1], e / 2),
                                              (e & 1) ? 0x7632 : 0x5410);
        if constexpr (Cf::R > 0) {
          const int hw = v ? Cf::HW - 1 : 0;
          reinterpret_cast<uint32_t*>(sx + (hr * Cf::HW + hw) * Cf::XS)[cp] = r.e[i];
        }
      }
    }
  }
};

// The implicit GEMM per tap of K1 and K2: a chunk of KSTEP input channels
// is staged as X rows [positions][XS] (channels-last, XS = padded(16)) and a
// W tile [taps][ATILE output channels][16], copied from the packed weights,
// whose 32-byte rows swap their two 16-byte units when bit 2 of the row is
// set, which keeps ldmatrix free of bank conflicts with no padding.
constexpr int KSTEP = 16;

// Element offset of 16-byte unit u of row r in the swizzled W tile.
__device__ __forceinline__ int swz(int r, int u) {
  return r * KSTEP + ((u ^ ((r >> 2) & 1)) << 3);
}

// One chunk's W tile of WELEMS bf16 (contiguous in the packed copy) into sw
// by cp.async.
template <int WELEMS, int THREADS>
__device__ __forceinline__ void load_w(bf16* sw, const bf16* src, int tid) {
  const uint32_t base = smem_u32(sw);
#pragma unroll 4
  for (int i = tid; i < WELEMS / 8; i += THREADS)
    cp_async16(base + swz(i >> 1, i & 1) * 2, src + i * 8, true);
}

// The fragments of tap t: A for the warp's MT m-tiles (the lane's address
// a_lane[m] at tap 0, moved by the tap's row offset Cf::toff(t): one
// immediate), B for its NT n-tiles (b_lane: the lane's address in the tile
// of tap 0).
template <class Cf>
__device__ __forceinline__ void load_frags(int t, uint32_t (&af)[Cf::MT][4],
                                           uint32_t (&bfr)[Cf::NT][2], uint32_t sw,
                                           const uint32_t (&a_lane)[Cf::MT], uint32_t b_lane) {
  const int toff = Cf::toff(t);
#pragma unroll
  for (int m = 0; m < Cf::MT; ++m)
    ldsm_x4(af[m][0], af[m][1], af[m][2], af[m][3], a_lane[m] + toff * Cf::XS * 2);
  const uint32_t wt = sw + b_lane + t * Cf::ATILE * KSTEP * 2;
#pragma unroll
  for (int n = 0; n + 1 < Cf::NT; n += 2)
    ldsm_x4(bfr[n][0], bfr[n][1], bfr[n + 1][0], bfr[n + 1][1], wt + n * 8 * KSTEP * 2);
  if constexpr (Cf::NT % 2 == 1)
    ldsm_x2(bfr[Cf::NT - 1][0], bfr[Cf::NT - 1][1], wt + (Cf::NT - 1) * 8 * KSTEP * 2);
}

// The products of one staged chunk, tap by tap over Cf::T taps; tap t+1's
// fragments are loaded before tap t's products.
template <class Cf>
__device__ __forceinline__ void mma_taps(float (&acc)[Cf::MT][Cf::NT][4], uint32_t sw,
                                         const uint32_t (&a_lane)[Cf::MT], uint32_t b_lane) {
  uint32_t af[2][Cf::MT][4], bfr[2][Cf::NT][2];
  load_frags<Cf>(0, af[0], bfr[0], sw, a_lane, b_lane);
#pragma unroll
  for (int t = 0; t < Cf::T; ++t) {
    if (t + 1 < Cf::T)
      load_frags<Cf>(t + 1, af[(t + 1) & 1], bfr[(t + 1) & 1], sw, a_lane, b_lane);
#pragma unroll
    for (int m = 0; m < Cf::MT; ++m)
#pragma unroll
      for (int n = 0; n < Cf::NT; ++n)
        mma_bf16(acc[m][n], af[t & 1][m], bfr[t & 1][n][0], bfr[t & 1][n][1]);
  }
}

// Launches K1's weight packing (conv3d_s1_tc.cu) on `stream`: wp[bw][at][ch]
// [t][o][cc] = w[bw][a][c][t] for bw < nw, a = at * AT + o < A and c = ch *
// 16 + cc < C, else zero; with flip, w is read as flip_t of the forward
// layer's [nw][C][A][T]. Returns cudaGetLastError().
cudaError_t pack_weights(const bf16* w, bf16* wp, int A, int C, int T, int AT, int nat, int nch,
                         bool flip, int64_t nw, cudaStream_t stream);

}  // namespace coma
