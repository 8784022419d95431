// Pieces shared by the tensor-core kernels K1 (conv3d_s1_tc.cu), K2
// (conv3d_s2_tc.cu), KB1 (conv3d_dw_tc.cu) and KB2 (conv3d_dw_s2_tc.cu):
// shared-memory and cp.async wrappers, ldmatrix and the bf16 mma.sync, the
// read-only global loads issued as volatile asm, the staging of an X halo
// brick (K1, KB1) and of a parity-split stride-2 halo box (K2, KB2) from
// NCDHW into channels-last shared memory, the weight gradients' G tile and
// per-brick products (KB1, KB2), and the implicit GEMM per tap of K1 and K2
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

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Waits for all but the most recent group.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// The share of a weight gradient's G tile sg [ATILE][GS] that one thread
// stages by cp.async (KB1, KB2): the brick's positions (dd, hh, ww) at
// (dd * BHGT + hh) * BWID + ww of row a (BWID = 16: a k16 step is one brick
// row), zero past the volume and past A. Thread t copies 16-byte piece
// t % 2 of k16 step t / 2 % STEPS of channels t / (2 STEPS) + j * (THREADS /
// (2 STEPS)). Cf gives STEPS, BHGT, BWID, THREADS, NG, ATILE and GS; Dims the G
// tensor's sizes (A, D, H, W, plane).
template <class Cf>
struct GStager {
  int gv, gq, ga;  // 16-byte piece, k16 step, first channel of the tile

  __device__ __forceinline__ explicit GStager(int tid) {
    gv = tid % 2;
    gq = tid / 2 % Cf::STEPS;
    ga = tid / (2 * Cf::STEPS);
  }

  // The tile of the brick at (d0, h0, w0) of one sample's G (gb), channels
  // from a0, loaded VW elements at a time along W.
  template <int VW, class Dims>
  __device__ __forceinline__ void load_g(bf16* sg, const Dims& p, const bf16* gb, int a0, int d0,
                                         int h0, int w0) const {
    const int d = d0 + gq / Cf::BHGT, h = h0 + gq % Cf::BHGT, w = w0 + 8 * gv;
    const bool in = d < p.D && h < p.H;
    const int off = (d * p.H + h) * p.W + w;
#pragma unroll
    for (int j = 0; j < Cf::NG; ++j) {
      const int a = ga + j * (Cf::THREADS / (2 * Cf::STEPS));
      if (a < Cf::ATILE) {
        const bool ok = in && a0 + a < p.A;
        const bf16* src = gb + (ok ? a0 + a : 0) * p.plane + (ok ? off : 0);
        bf16* dst = sg + a * Cf::GS + gq * Cf::BWID + 8 * gv;
        if constexpr (VW == 8) {
          cp_async16(smem_u32(dst), src, ok && w < p.W);
        } else if constexpr (VW == 4) {
          cp_async8(smem_u32(dst), src, ok && w < p.W);
          cp_async8(smem_u32(dst + 4), ok && w + 4 < p.W ? src + 4 : src, ok && w + 4 < p.W);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            reinterpret_cast<unsigned short*>(dst)[e] =
                ok && w + e < p.W ? (unsigned short)ld_u16(src + e) : (unsigned short)0;
        }
      }
    }
  }
};

// The products of one staged brick of a weight gradient (KB1, KB2): 27 (or
// 1) GEMMs D_t[c, a] += sum_p X[c, p + s_t] * G[a, p] with X the
// channels-last halo rows at sx and G the tile [ATILE][GS] at sg.
// Warp (td, th, jw) takes k16 steps jw, jw + J, ... and, per step, taps
// (td, th, 0 .. K-1); td and th arrive as the row offsets of their taps in
// the halo (the tap index itself for KB1's brick, its parity-split shift
// for KB2's box), and Cf::kwoff(tw) gives the offset of kw tap tw. A step's
// fragments are all loaded before its products, so one ldmatrix latency
// covers them.
template <class Cf, int K>
__device__ __forceinline__ void mma_brick(float (&acc)[K][Cf::MT][Cf::NT][4], uint32_t sx,
                                          uint32_t sg, uint32_t a_lane, uint32_t b_lane,
                                          uint32_t b_lane2, int td, int th, int jw) {
#pragma unroll 2
  for (int q = jw; q < Cf::STEPS; q += Cf::J) {
    const int dd = q / Cf::BHGT, hh = q % Cf::BHGT;
    uint32_t bfr[Cf::NT][2];
#pragma unroll
    for (int n = 0; n + 1 < Cf::NT; n += 2)
      ldsm_x4(bfr[n][0], bfr[n][1], bfr[n + 1][0], bfr[n + 1][1],
              sg + b_lane + (n * 8 * Cf::GS + q * Cf::BWID) * 2);
    if constexpr (Cf::NT % 2 == 1)
      ldsm_x2(bfr[Cf::NT - 1][0], bfr[Cf::NT - 1][1],
              sg + b_lane2 + ((Cf::NT - 1) * 8 * Cf::GS + q * Cf::BWID) * 2);
    const int row0 = ((dd + td) * Cf::HH + hh + th) * Cf::HW;
    uint32_t afr[K][Cf::MT][4];
#pragma unroll
    for (int tw = 0; tw < K; ++tw)
#pragma unroll
      for (int mt = 0; mt < Cf::MT; ++mt)
        ldsm_x4_trans(afr[tw][mt],
                      sx + a_lane + ((row0 + Cf::kwoff(tw)) * Cf::XS + mt * 16) * 2);
#pragma unroll
    for (int tw = 0; tw < K; ++tw)
#pragma unroll
      for (int mt = 0; mt < Cf::MT; ++mt)
#pragma unroll
        for (int n = 0; n < Cf::NT; ++n)
          mma_bf16(acc[tw][mt][n], afr[tw][mt], bfr[n][0], bfr[n][1]);
  }
}

// The same with the G tile right behind the halo rows (KB1's stages).
template <class Cf, int K>
__device__ __forceinline__ void mma_brick(float (&acc)[K][Cf::MT][Cf::NT][4], uint32_t sx,
                                          uint32_t a_lane, uint32_t b_lane, uint32_t b_lane2,
                                          int td, int th, int jw) {
  mma_brick<Cf, K>(acc, sx, sx + Cf::XELEMS * 2, a_lane, b_lane, b_lane2, td, th, jw);
}

// The stride-2 halo box of a brick of BD x BH x BW (BW = 16) positions of a
// stride-2 grid (K2's outputs, KB2's half-resolution positions): the
// (2BD+1)(2BH+1)(2BW+1) input positions 2q + s - 1 (s in {0, 1, 2}) that its
// 27 taps read, x 16 channels, channels-last, zero outside the volume. Each
// axis is stored split by parity (its n + 1 even positions, then its n odd
// ones), so tap offset s along an axis reads position q + shift(s, n) for
// brick position q: unit stride, and a tap moves a lane's ldmatrix row by
// an immediate. Rows are padded to 3 16-byte units, so the 8 rows of one
// ldmatrix phase fall in distinct banks (an unsplit box read at stride 2
// would be a 2-way conflict at any padding). Staged by THREADS threads: a
// thread holds channel pair t % 8 of row piece t / 8 % 4 (input w 8 v ..
// 8 v + 7 of the box's W extent after its first position) of box rows
// t / 32 + i * HRSTEP; the pieces' first thread also holds the box's first
// position.
//
// Where box position j (0 <= j <= 2n) along an axis of n outputs is stored.
__host__ __device__ constexpr int split(int j, int n) { return j % 2 == 0 ? j / 2 : n + 1 + j / 2; }
// Tap offset s (0, 1, 2) of output q reads box position 2q + s: stored at q + shift(s, n).
__host__ __device__ constexpr int shift(int s, int n) { return s == 0 ? 0 : s == 1 ? n + 1 : 1; }

template <int BD_, int BH_, int THREADS_>
struct Box2 {
  static constexpr int BD = BD_, BH = BH_, BW = 16, CT = 16, THREADS = THREADS_;
  static constexpr int HD = 2 * BD + 1, HH = 2 * BH + 1, HW = 2 * BW + 1;
  static constexpr int HROWS = HD * HH, XROWS = HROWS * HW;  // box (d, h) rows, positions
  static constexpr int XS = padded(CT), XELEMS = XROWS * XS;  // row: 16 channels in 3 units
  static constexpr int PIECES = 2 * BW / 8;
  static constexpr int HRSTEP = THREADS / (CT / 2 * PIECES), NX = (HROWS + HRSTEP - 1) / HRSTEP;
};

// One box in registers between its loads and its stores.
template <class Box>
struct BoxRegs {
  uint4 v[Box::NX][2];  // the 8-wide row piece of channels (c, c + 1)
  uint32_t e[Box::NX];  // the box's first position along W, channels (c, c + 1)
};

// The share of one 16-channel chunk's box that a thread stages (see Box2);
// Args gives the input's sizes (C, D, H, W, plane).
template <class Box>
struct BoxStager {
  const bf16* xc;   // channel c = c0 + 2 cp of this sample (clamped to a valid one)
  bool c0ok, c1ok;  // c < C, c + 1 < C
  int cp, v, hr0;

  template <class Args>
  __device__ __forceinline__ BoxStager(const Args& p, const bf16* xb, int c0, int tid) {
    cp = tid % (Box::CT / 2);
    v = tid / (Box::CT / 2) % Box::PIECES;
    hr0 = tid / (Box::CT / 2 * Box::PIECES);
    const int c = c0 + 2 * cp;
    c0ok = c < p.C;
    c1ok = c + 1 < p.C;
    xc = xb + (c0ok ? c : 0) * p.plane;
  }

  // The box whose first input position is (d0, h0, w0) = 2 x the brick's
  // origin - 1, into registers; w0 + 1 is a multiple of 32.
  template <int VX, class Args>
  __device__ __forceinline__ void load_x(BoxRegs<Box>& r, const Args& p, int d0, int h0,
                                         int w0) const {
#pragma unroll
    for (int i = 0; i < Box::NX; ++i) {
      r.v[i][0] = r.v[i][1] = make_uint4(0u, 0u, 0u, 0u);
      r.e[i] = 0u;
      const int hr = hr0 + i * Box::HRSTEP;
      const int d = d0 + hr / Box::HH, h = h0 + hr % Box::HH;
      if (hr < Box::HROWS && (unsigned)d < (unsigned)p.D && (unsigned)h < (unsigned)p.H) {
        const bf16* row = xc + (d * p.H + h) * p.W;
        const int w = w0 + 1 + 8 * v;
        const bool eok = v == 0 && w0 >= 0;
        if (c0ok) {
          r.v[i][0] = ld_row8<VX>(row, w, p.W);
          if (eok) r.e[i] = ld_u16(row + w0);
        }
        if (c1ok) {
          r.v[i][1] = ld_row8<VX>(row + p.plane, w, p.W);
          if (eok) r.e[i] |= ld_u16(row + p.plane + w0) << 16;
        }
      }
    }
  }

  // Box row hr of the thread's channel pair -> the parity-split box sx
  // [XROWS][XS]: element e of the row piece (a: channel 2 cp, b: 2 cp + 1)
  // is box position j = 1 + 8 v + e along W; e0 holds position 0 of both.
  __device__ __forceinline__ void store_row(int hr, const uint4& a, const uint4& b, uint32_t e0,
                                            bf16* sx) const {
    const int srow =
        (split(hr / Box::HH, Box::BD) * Box::HH + split(hr % Box::HH, Box::BH)) * Box::HW;
    uint32_t* dst = reinterpret_cast<uint32_t*>(sx + srow * Box::XS) + cp;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // split(1 + 8 v + e, BW): odd positions for even e
      const int s = e % 2 == 0 ? Box::BW + 1 + 4 * v + e / 2 : 4 * v + (e + 1) / 2;
      dst[s * (Box::XS / 2)] =
          __byte_perm(word(a, e / 2), word(b, e / 2), (e & 1) ? 0x7632 : 0x5410);
    }
    if (v == 0) dst[0] = e0;  // position 0 is stored first
  }

  // Registers -> the parity-split box sx [XROWS][XS].
  __device__ __forceinline__ void store_x(const BoxRegs<Box>& r, bf16* sx) const {
#pragma unroll
    for (int i = 0; i < Box::NX; ++i) {
      const int hr = hr0 + i * Box::HRSTEP;
      if (hr < Box::HROWS) store_row(hr, r.v[i][0], r.v[i][1], r.e[i], sx);
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
