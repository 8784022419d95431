// FB1 on the tensor cores in float32: the weight gradients of the stride-1
// SAME conv (k in {1, 3}) and of the stride-2 conv and its transpose (k = 3).
// One kernel template computes two index maps, summed in f32 over the
// positions p of G's grid:
//   S1, the stride-1 map:  dW[a, c, t] = sum_p G[a, p] * X[c, p + s_t]
//   S2, the strided map:   M[a, c, t]  = sum_p G[a, p] * X[c, 2p + s_t - 1]
// with s_t the offset of tap t (3-D, kd major; S1 centred, S2 in {0, 1,
// 2}^3) and X zero outside its volume. S1: X = x [B, C, D, H, W], G = the
// output cotangent g [B, A, D, H, W]. S2 (ops/conv3d_strided.py:
// conv3d_strided_dw): X = full [B, C, D, H, W], G = half [B, A, (D-1)/2+1,
// ...]; the stride-2 conv passes full = x, half = g, the transposed conv
// full = g, half = x (its channel swap and tap flip stay in Python). All f32
// NCDHW; the result is f32 [A, C, k^3], or [B, A, C, k^3] per sample (the
// CondConv sites). Every product is three TF32 mma.sync (tf32_common.cuh:
// 3xTF32), so the sums keep f32's accuracy.
//
// Replaces, in float32, from coma_unet_tpu/ops/pallas/ (rows #4, #5, #7,
// #9, #16 and #17 of the kernel table in PERF.md): conv3d.py
// `_pallas_conv3d_dw` and `_pallas_conv3d_dw_htiled`, conv3d_p1.py `_p1_dw`,
// conv3d_packed.py `_packed_dw` (S1) and conv3d_strided.py `_dw_dil_v1` and
// `_dw_v2` (S2). ops/conv3d.py:fb1_plan gives the cut.
//
// What bounds it on the H100: at the wide k = 3 sites operations: head.conv1
// [2,32,128^3] -> 32 takes 232 GFLOP, 1.406 ms at the 3xTF32 rate (165
// TFLOP/s), against 537 MB of x and g, 0.160 ms at 3.35 TB/s; the strided
// map at [2,32,128^3] with 64 half channels 58.0 GFLOP, 0.351 ms. At the
// narrow sites (Cin = 1, Cout = 1, k = 1) bytes.
//
// Design: KB1's per-tap GEMM over positions (conv3d_dw_tc.cu) and KB2's
// parity-split stride-2 box (conv3d_dw_s2_tc.cu), in f32 with F1's 3xTF32
// pieces,
//   D_t[m, n] += sum_{p in brick} A[m, p] B[p, n]
// on mma.sync m16n8k8 TF32, K = 8 positions a step. Both operands are
// activations, so there is no packing: each fragment is split into its TF32
// hi and lo parts in registers (round_tf32: integer rounding) and the three
// products go lo_A hi_B, hi_A lo_B, hi_A hi_B (tf32_common.cuh:mma3). By
// default M = channels of X and N = channels of G (A = X at the tap's
// shift, B = G); a layer of fewer than 8 channels of X swaps them (SW: M =
// channels of G, N = X's padded to 8), so Cin = 1 pads to 8 and not 16.
// A block is 8 warps. For k = 3 warp w owns taps w, w + 8, w + 16 (and
// w + 24 for w < 3) over every step of the brick: a G fragment (one
// ldmatrix per two n-tiles, or per m-tile with SW) serves all its taps, an
// X fragment every n-tile of its tap. (Nine warps, one per (kd, kh) row of
// taps, put three warps on one of the SM's four sub-partitions: 168
// registers a thread at most and a third of the block's mma on one tensor
// core; 8 warps hold 255 and load the sub-partitions 7:7:7:6 taps.) The
// taps go in passes of two (all of them where a tap holds fewer than 4
// tiles), each pass's three terms over all its tiles in turn, so the mma
// into one register stand at least 8 apart. For k = 1 the 8 warps share a
// brick's k8 steps (step q to warp q % 8) and sum their tiles through
// shared memory in warp order at the end.
//
// A block owns XC channels of X (16 MT, or 8 NT with SW) x GC of G (8 NT,
// or 16 MT) x k^3 taps and walks a run of bricks of G's grid of one sample:
// BD x 4 x 16 positions (S1 k = 3: BD = 4; S1 k = 1: 2; S2: 1), each W row
// two k8 steps. Per brick it stages in shared memory, by cp.async with zero
// fill (outside the volume, past the channels), two bricks in flight:
//  - X's box: the positions the brick's taps read (S1: the brick with a
//    halo of k / 2; S2: the (2BD+1)(2BH+1)(2BW+1) positions 2p + s - 1,
//    each axis stored split by parity, even positions first, as KB2's box:
//    tap offset s along an axis of n brick positions reads stored position
//    q + shift(s, n), tc_common.cuh), channels-last: a position's XC
//    channels in a row of RS floats. ldmatrix.trans moves 16-bit pieces and
//    cannot transpose f32, so X's fragments are read by 32-bit shared loads:
//    lane (g, t) = (lane / 4, lane % 4) of a load reads channel g (+ 8) at
//    position t (+ 4), word t RS + g of the box, and RS = XC + 8 (XC = 16:
//    24 floats; XC = 8 with SW: RS = 8) makes RS = 8 or 24 mod 32, so t RS
//    takes 4 distinct multiples of 8 and a fragment's 32 loads fall in 32
//    distinct banks. The box is written by 4-byte cp.async, a warp one
//    stored (d, h) row of 8 channels, 8 channels x 4 positions a step (4 RS
//    + 8 channels: distinct banks again).
//  - G's tile [GC][P + 4], positions contiguous (16-byte cp.async where G's
//    rows allow it, else 4-byte): the B fragments (A with SW) by ldmatrix
//    as F1 reads its W tile; an 8 x 8 b16 matrix is an 8 x 4 f32 one, the
//    row of P + 4 floats an odd number of 16-byte units (no bank conflicts).
// Two stages: S1 k = 3 at XC = 16, GC = 32, a 6 x 6 x 18 box (62,208 B) and
// a 33,280 B tile, 190,976 B; S2 a 3 x 9 x 33 box (85,536 B), 188,480 B;
// one block an SM; k = 1 58,368 B at most, two. Each fragment is split as
// it is read: the box's values are read about 8 times each at S1 k = 3,
// but splitting each staged value once instead, into lo planes beside the
// stages, needed 2 x 4 x 16 bricks to fit and ran slower on an H100.
// Accuracy: the tensor cores' f32 accumulation is not rounded to nearest,
// and its error grows with the mma summed into one register (in F1, 27 a
// register passed chip_smoke.py's phase 5, 648-1,296 did not). So a warp's
// products go into registers zeroed at the start of each run of at most
// RUN = 8 of its k8 steps (64 positions, 24 mma a register: S1 k = 3 four
// runs a brick, S2 one, k = 1 one of 2 steps), and each run's partial is
// added to running sums, also in registers, by f32 adds in step order.
//
// Split-K: the bricks of each sample are cut into runs (a split never
// straddles two samples); each split writes its partial to the f32
// workspace and dw_reduce.cuh sums the partials in split order. No float
// atomics: two calls give the same bits. In-plane offsets are 32-bit (the
// entry checks D * H * W < 2^31), sample and channel offsets 64-bit.
#include "dw_reduce.cuh"
#include "tf32_common.cuh"

namespace {

using namespace coma;
using namespace coma::tf32;

enum Mode { S1 = 0, S2 = 1 };

constexpr int BH = 4, BW = 16;  // a brick's extent along H and W; a W row is two k8 steps
constexpr int RUN = 8;          // k8 steps a partial at most

// Box coordinate of stored index s along an axis of n brick positions (S2:
// the even coordinates 0 .. 2n at 0 .. n, the odd ones after them).
template <int MODE>
__host__ __device__ constexpr int unsplit(int s, int n) {
  return MODE == S2 ? (s <= n ? 2 * s : 2 * (s - n) - 1) : s;
}

// MODE, K taps per axis, SW (G on M), MT m-tiles and NT n-tiles a warp.
template <int MODE, int K, bool SW, int MT, int NT>
struct Fb1 {
  static constexpr int BD = MODE == S2 ? 1 : K == 3 ? 4 : 2;
  static constexpr int P = BD * BH * BW, KSTEPS = P / 8;  // positions, k8 steps a brick
  static constexpr int T = K * K * K;
  static constexpr int WARPS = 8, THREADS = 32 * WARPS;
  // k = 3: warp w owns taps w + 8 i < 27 (4 for w < 3, else 3) over every
  // step; k = 1: the warps share the steps (step q to warp q % 8)
  static constexpr int TW = K == 3 ? 4 : 1;   // taps a warp at most
  static constexpr int J = K == 3 ? 1 : WARPS;
  static constexpr int NQ = KSTEPS / J, RUNQ = NQ < RUN ? NQ : RUN;  // a warp's steps, a run's
  // taps a pass: two when a tap holds 4 or more tiles, so the mma into one
  // register stand at least 8 apart and one pass's X fragments stay few
  static constexpr int TG = MT * NT >= 4 && TW > 2 ? 2 : TW;
  static constexpr int XC = SW ? 8 * NT : 16 * MT;  // channels of X a block
  static constexpr int GC = SW ? 16 * MT : 8 * NT;  // channels of G a block
  static constexpr int RS = XC % 16 == 0 ? XC + 8 : XC;  // floats a box position
  static constexpr int R = MODE == S2 ? 0 : K / 2;
  static constexpr int HD = MODE == S2 ? 2 * BD + 1 : BD + 2 * R;
  static constexpr int HH = MODE == S2 ? 2 * BH + 1 : BH + 2 * R;
  static constexpr int HW = MODE == S2 ? 2 * BW + 1 : BW + 2 * R;
  static constexpr int NPOS = HD * HH * HW, XELEMS = NPOS * RS;  // box positions, floats
  static constexpr int GS = P + 4, GELEMS = GC * GS;              // G row, tile floats
  static constexpr int STAGE = XELEMS + GELEMS;
  // a warp's sums: X on M, rows i * MT + m for its tap i; G on M, columns
  // i * NT + n
  static constexpr int AM = SW ? MT : TW * MT, AN = SW ? TW * NT : NT;
  static constexpr int ACC = AM * AN * 4;                    // a thread's sums
  static constexpr int RED = J > 1 ? WARPS * ACC * 32 : 0;   // k = 1: the warps' sums
  static constexpr int SMEM = cmax(2 * STAGE, RED) * 4;
  // k = 1 (at most 32 sums a thread, 58 KB) fits two blocks an SM
  static constexpr int MINB = K == 1 ? 2 : 1;
  // box staging: a warp copies one stored (d, h) row of 8 channels, 8
  // channels x 4 positions a step
  static constexpr int XROWS = HD * HH * (XC / 8), WSTEPS = (HW + 3) / 4;
  static_assert(RS % 32 == 8 || RS % 32 == 24, "a fragment's loads in distinct banks");
  static_assert(KSTEPS % J == 0 && NQ % RUNQ == 0 && XC % 8 == 0 && TW % TG == 0, "steps");
  static_assert(XELEMS % 8 == 0 && GS % 8 == 4 && MINB * (SMEM + 1024) <= 228 * 1024,
                "tiles");
  // the stored box offset (in positions) of tap t = (kd, kh, kw)
  __host__ __device__ static constexpr int toff(int t) {
    return MODE == S2 ? (shift(t / 9, BD) * HH + shift(t / 3 % 3, BH)) * HW + shift(t % 3, BW)
                      : ((t / (K * K)) * HH + t / K % K) * HW + t % K;
  }
};

struct Fb1Args {
  const float* x;  // X: x (S1) or full (S2)
  const float* g;  // G: g (S1) or half (S2)
  float* ws;       // [B * sps][A][C][k^3] partials
  int C, A;        // channels of X and of G
  int D, H, W;     // X's volume
  int PD, PH, PW;  // G's grid
  int64_t xplane, gplane;
  int nbh, nbw;          // bricks along H and W
  int64_t nb, bps, sps;  // bricks a sample, a split; splits a sample
  int gvec;              // G's rows take 16-byte copies (PW % 4 == 0, g 16-byte aligned)
};

// The TF32 hi and lo parts of the raw f32 fragments a (F1's split_frag).
template <int N, int E>
__device__ __forceinline__ void split_tf32(const uint32_t (&a)[N][E], uint32_t (&hi)[N][E],
                                           uint32_t (&lo)[N][E]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float v = __uint_as_float(a[i][e]);
      hi[i][e] = round_tf32(v);
      lo[i][e] = round_tf32(v - __uint_as_float(hi[i][e]));
    }
}

// Brick j of the sample into the stage at st: X's box, then G's tile.
template <class Cf, int MODE>
__device__ __forceinline__ void stage(float* st, const Fb1Args& p, const float* xb,
                                      const float* gb, int c0, int a0, int64_t j, int tid) {
  const int64_t nbhw = (int64_t)p.nbh * p.nbw;
  const int pd0 = (int)(j / nbhw) * Cf::BD, ph0 = (int)(j % nbhw / p.nbw) * BH;
  const int pw0 = (int)(j % p.nbw) * BW;
  // the box's origin in X: S2 2 p0 - 1, S1 p0 - R
  const int d0 = MODE == S2 ? 2 * pd0 - 1 : pd0 - Cf::R;
  const int h0 = MODE == S2 ? 2 * ph0 - 1 : ph0 - Cf::R;
  const int w0 = MODE == S2 ? 2 * pw0 - 1 : pw0 - Cf::R;
  const uint32_t sx = smem_u32(st);
  const int lane = tid & 31, cl = lane & 7, pl = (lane >> 3) & 3;
  for (int item = tid >> 5; item < Cf::XROWS; item += Cf::WARPS) {
    const int c = item % (Cf::XC / 8) * 8 + cl, sr = item / (Cf::XC / 8);
    const int d = d0 + unsplit<MODE>(sr / Cf::HH, Cf::BD);
    const int h = h0 + unsplit<MODE>(sr % Cf::HH, BH);
    const bool rok = c0 + c < p.C && (unsigned)d < (unsigned)p.D && (unsigned)h < (unsigned)p.H;
    const float* const row =
        xb + (int64_t)(rok ? c0 + c : 0) * p.xplane + (rok ? d * p.H + h : 0) * p.W;
    uint32_t dst = sx + ((sr * Cf::HW + pl) * Cf::RS + c) * 4;
#pragma unroll
    for (int i = 0; i < Cf::WSTEPS; ++i, dst += 4 * Cf::RS * 4) {
      const int sw = 4 * i + pl;
      const int w = w0 + unsplit<MODE>(sw, BW);
      const bool ok = rok && (unsigned)w < (unsigned)p.W;
      if (sw < Cf::HW) cp_async4(dst, ok ? row + w : xb, ok);
    }
  }
  const uint32_t sg = sx + Cf::XELEMS * 4;
  if (p.gvec) {  // 16-byte pieces of 4 positions along W: all inside or all outside
    for (int e = tid; e < Cf::GC * (Cf::P / 4); e += Cf::THREADS) {
      const int a = e / (Cf::P / 4), pp = e % (Cf::P / 4) * 4;
      const int d = pd0 + pp / (BH * BW), h = ph0 + pp / BW % BH, w = pw0 + pp % BW;
      const bool ok = a0 + a < p.A && d < p.PD && h < p.PH && w < p.PW;
      const float* src = ok ? gb + (int64_t)(a0 + a) * p.gplane + (d * p.PH + h) * p.PW + w : gb;
      cp_async16(sg + (a * Cf::GS + pp) * 4, src, ok);
    }
  } else {
    for (int e = tid; e < Cf::GC * Cf::P; e += Cf::THREADS) {
      const int a = e / Cf::P, pp = e % Cf::P;
      const int d = pd0 + pp / (BH * BW), h = ph0 + pp / BW % BH, w = pw0 + pp % BW;
      const bool ok = a0 + a < p.A && d < p.PD && h < p.PH && w < p.PW;
      const float* src = ok ? gb + (int64_t)(a0 + a) * p.gplane + (d * p.PH + h) * p.PW + w : gb;
      cp_async4(sg + (a * Cf::GS + pp) * 4, src, ok);
    }
  }
}

// The products of k8 step q of a staged brick for the warp's taps (the
// last only where `all`), in passes of TG taps, each pass's three terms
// over all its tiles in turn (tf32_common.cuh:mma3's order): sx is the
// lane's box word at step 0 and no tap, xo[i] the box offset (floats) of
// its tap i, sg its G address (bytes) at step 0.
template <class Cf, bool SW, int MT, int NT>
__device__ __forceinline__ void kstep(float (&acc)[Cf::AM][Cf::AN][4], const float* sx,
                                      const int (&xo)[Cf::TW], bool all, uint32_t sg, int q) {
  constexpr int TW = Cf::TW, TG = Cf::TG;
  const int r = q >> 1;  // brick row (dz, hy); a row is two steps
  const float* const xq =
      sx + (((r / BH) * Cf::HH + r % BH) * Cf::HW + (q & 1) * 8) * Cf::RS;
  // G's fragments by ldmatrix: with SW A, rows m * 16 + (0-7, 8-15) x
  // positions (0-3, 4-7) of m-tile m; else B, b0 (positions 0-3) and b1
  // (4-7) of channel row n * 8 + lane / 4, two n-tiles an ldmatrix
  constexpr int GN = SW ? MT : NT, GE = SW ? 4 : 2;
  const uint32_t gq = sg + q * 8 * 4;
  uint32_t g[GN][GE], gh[GN][GE], gl[GN][GE];
  if constexpr (SW) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      ldsm_x4(g[m][0], g[m][1], g[m][2], g[m][3], gq + m * 16 * Cf::GS * 4);
  } else {
#pragma unroll
    for (int n = 0; n + 1 < NT; n += 2)
      ldsm_x4(g[n][0], g[n][1], g[n + 1][0], g[n + 1][1], gq + n * 8 * Cf::GS * 4);
    if constexpr (NT % 2 == 1)
      ldsm_x2(g[NT - 1][0], g[NT - 1][1], gq + (NT - 1) * 8 * Cf::GS * 4);
  }
  split_tf32(g, gh, gl);
  // X's fragments of a pass by 32-bit loads: A (X on M) a0 (channel g,
  // position t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of m-tile
  // m; or B (SW) b0 (position t, channel n * 8 + g), b1 (t + 4) of n-tile n
  constexpr int XN = SW ? NT : MT, XE = SW ? 2 : 4;
#pragma unroll
  for (int t0 = 0; t0 < TW; t0 += TG) {
    uint32_t x[TG * XN][XE], xh[TG * XN][XE], xl[TG * XN][XE];
#pragma unroll
    for (int i = 0; i < TG; ++i)
#pragma unroll
      for (int u = 0; u < XN; ++u) {
        const float* const xa = xq + xo[t0 + i] + u * (SW ? 8 : 16);
        const bool live = t0 + i < TW - 1 || all;
#pragma unroll
        for (int e = 0; e < XE; ++e) {
          const int off = SW ? e * 4 * Cf::RS : (e & 1) * 8 + (e >> 1) * 4 * Cf::RS;
          x[i * XN + u][e] = live ? __float_as_uint(xa[off]) : 0u;
        }
      }
    split_tf32(x, xh, xl);
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int i = 0; i < TG; ++i)
        if (t0 + i < TW - 1 || all)
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              if constexpr (SW) {  // A = G, B = X
                const uint32_t(&a)[4] = term == 0 ? gl[m] : gh[m];
                const uint32_t(&bb)[2] = term == 1 ? xl[i * NT + n] : xh[i * NT + n];
                mma_tf32(acc[m][(t0 + i) * NT + n], a, bb[0], bb[1]);
              } else {             // A = X, B = G
                const uint32_t(&a)[4] = term == 0 ? xl[i * MT + m] : xh[i * MT + m];
                const uint32_t(&bb)[2] = term == 1 ? gl[n] : gh[n];
                mma_tf32(acc[(t0 + i) * MT + m][n], a, bb[0], bb[1]);
              }
            }
  }
}

template <int MODE, int K, bool SW, int MT, int NT>
__global__ void __launch_bounds__(Fb1<MODE, K, SW, MT, NT>::THREADS,
                                  Fb1<MODE, K, SW, MT, NT>::MINB)
    conv3d_dw_f32_tc_kernel(const Fb1Args p) {
  using Cf = Fb1<MODE, K, SW, MT, NT>;
  constexpr int AM = Cf::AM, AN = Cf::AN, TW = Cf::TW;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.x * Cf::XC, a0 = blockIdx.y * Cf::GC;
  const int64_t split = blockIdx.z, b = split / p.sps;
  const int64_t j0 = split % p.sps * p.bps, j1 = j0 + p.bps < p.nb ? j0 + p.bps : p.nb;
  const float* const xb = p.x + b * p.C * p.xplane;
  const float* const gb = p.g + b * p.A * p.gplane;
  // the warp's share: k = 3 taps warp + 8 i (its last only where `all`),
  // every step; k = 1 steps jw, jw + J, ...
  const int jw = warp % Cf::J;
  const bool all = K == 1 || warp + 8 * (TW - 1) < Cf::T;
  int xo[TW];
#pragma unroll
  for (int i = 0; i < TW; ++i)
    xo[i] = K == 1 ? 0 : Cf::toff(warp + 8 * i < Cf::T ? warp + 8 * i : 0) * Cf::RS;
  const int x_lane = tig * Cf::RS + gid;
  // ldmatrix: lane l addresses row l % 8 of 8 x 4 f32 matrix l / 8; with SW
  // the matrices are (rows 0-7, positions 0-3), (8-15, 0-3), (0-7, 4-7),
  // (8-15, 4-7) of an m-tile, else (n-tile n, 0-3), (n, 4-7), (n + 1, 0-3),
  // (n + 1, 4-7)
  const uint32_t g_lane =
      (SW ? ((((lane >> 3) & 1) * 8 + (lane & 7)) * Cf::GS + (lane >> 4) * 4)
          : (((lane >> 4) * 8 + (lane & 7)) * Cf::GS + ((lane >> 3) & 1) * 4)) * 4;

  float acc[AM][AN][4], run[AM][AN][4];
#pragma unroll
  for (int i = 0; i < AM; ++i)
#pragma unroll
    for (int j = 0; j < AN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = run[i][j][e] = 0.f;

  stage<Cf, MODE>(smem, p, xb, gb, c0, a0, j0, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int64_t j = j0; j < j1; ++j) {
    const int buf = (int)((j - j0) & 1);
    if (j + 1 < j1) stage<Cf, MODE>(smem + (buf ^ 1) * Cf::STAGE, p, xb, gb, c0, a0, j + 1, tid);
    cp_async_commit();
    const float* const sx = smem + buf * Cf::STAGE + x_lane;
    const uint32_t sg = smem_u32(smem + buf * Cf::STAGE + Cf::XELEMS) + g_lane;
#pragma unroll 1
    for (int q0 = 0; q0 < Cf::NQ; q0 += Cf::RUNQ) {
#pragma unroll 2
      for (int i = 0; i < Cf::RUNQ; ++i)
        kstep<Cf, SW, MT, NT>(acc, sx, xo, all, sg, jw + Cf::J * (q0 + i));
      // the run's partial into the running sums
#pragma unroll
      for (int i = 0; i < AM; ++i)
#pragma unroll
        for (int jj = 0; jj < AN; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            run[i][jj][e] += acc[i][jj][e];
            acc[i][jj][e] = 0.f;
          }
    }
    cp_async_wait_all();
    __syncthreads();  // brick j + 1 staged; brick j's reads done
  }

  // c[e] of an m16n8 tile: row (M) lane / 4 + 8 (e / 2), column (N)
  // 2 (lane % 4) + e % 2; the warp's tap slot is row i / MT (X on M) or
  // column j / NT
  float* const part = p.ws + split * (int64_t)p.A * p.C * Cf::T;
  if constexpr (Cf::J == 1) {
#pragma unroll
    for (int i = 0; i < AM; ++i)
#pragma unroll
      for (int jj = 0; jj < AN; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = SW ? jj / NT : i / MT;
          const int row = (SW ? i : i % MT) * 16 + gid + (e >> 1) * 8;
          const int col = (SW ? jj % NT : jj) * 8 + 2 * tig + (e & 1);
          const int xc = c0 + (SW ? col : row), gc = a0 + (SW ? row : col);
          if ((slot < TW - 1 || all) && xc < p.C && gc < p.A)
            part[((int64_t)gc * p.C + xc) * Cf::T + warp + 8 * slot] = run[i][jj][e];
        }
  } else {  // k = 1: the J warps' sums through shared memory, in warp order
    static_assert(K == 1, "k = 3 keeps each tap's sums in one warp");
#pragma unroll
    for (int i = 0; i < AM; ++i)
#pragma unroll
      for (int jj = 0; jj < AN; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          smem[(warp * Cf::ACC + (i * AN + jj) * 4 + e) * 32 + lane] = run[i][jj][e];
    __syncthreads();
    for (int v = tid; v < Cf::ACC * 32; v += Cf::THREADS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < Cf::J; ++w) s += smem[w * Cf::ACC * 32 + v];
      const int ln = v % 32, id = v / 32, e = id % 4, jj = id / 4 % AN, i = id / (4 * AN);
      const int row = i * 16 + (ln >> 2) + (e >> 1) * 8, col = jj * 8 + 2 * (ln & 3) + (e & 1);
      const int xc = c0 + (SW ? col : row), gc = a0 + (SW ? row : col);
      if (xc < p.C && gc < p.A) part[(int64_t)gc * p.C + xc] = s;
    }
  }
}

template <int MODE, int K, bool SW, int MT, int NT>
cudaError_t launch(const Fb1Args& a, int64_t bd, int64_t B, int64_t per_sample, float* out,
                   cudaStream_t stream) {
  using Cf = Fb1<MODE, K, SW, MT, NT>;
  if (bd != Cf::BD || cdiv(a.A, Cf::GC) > 65535) return cudaErrorInvalidValue;
  const auto kernel = conv3d_dw_f32_tc_kernel<MODE, K, SW, MT, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)cdiv(a.C, Cf::XC), (unsigned)cdiv(a.A, Cf::GC),
                  (unsigned)(B * a.sps));
  kernel<<<grid, Cf::THREADS, Cf::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_reduce(a.ws, out, (int64_t)a.A * a.C * Cf::T, B, a.sps, per_sample, stream);
}

}  // namespace

// FB1. mode 0 (S1): x [B, C, D, H, W], g [B, A, D, H, W], k in {1, 3};
// mode 1 (S2): full [B, C, D, H, W], half [B, A, (D-1)/2+1, ...], k = 3.
// out receives f32 [A, C, k^3], or [B, A, C, k^3] with per_sample. The cut
// comes from ops/conv3d.py:fb1_plan: swap (G's channels on M), mt m-tiles
// and nt n-tiles a warp, the brick (bd, bh, bw) = (4 (S1 k = 3), 2 (S1
// k = 1) or 1 (S2), 4, 16) and bps bricks a split; ws holds B * ceil(bricks
// / bps) partials of A * C * k^3 floats.
COMA_API int coma_conv3d_dw_f32_tc(const void* x, const void* g, void* ws, void* out,
                                   int64_t mode, int64_t B, int64_t C, int64_t A, int64_t D,
                                   int64_t H, int64_t W, int64_t k, int64_t per_sample,
                                   int64_t swap, int64_t mt, int64_t nt, int64_t bd, int64_t bh,
                                   int64_t bw, int64_t bps, void* stream) {
  if ((mode != S1 && mode != S2) || (k != 3 && (mode != S1 || k != 1)) || B <= 0 || C <= 0 ||
      A <= 0 || C > 0x7fffffff || A > 0x7fffffff || D <= 0 || H <= 0 || W <= 0 ||
      D * H * W >= (int64_t(1) << 31) || bd <= 0 || bh != BH || bw != BW || bps <= 0)
    return cudaErrorInvalidValue;
  Fb1Args a{};
  a.x = static_cast<const float*>(x);
  a.g = static_cast<const float*>(g);
  a.ws = static_cast<float*>(ws);
  a.C = (int)C;
  a.A = (int)A;
  a.D = (int)D;
  a.H = (int)H;
  a.W = (int)W;
  if (mode == S2) {
    a.PD = (a.D - 1) / 2 + 1, a.PH = (a.H - 1) / 2 + 1, a.PW = (a.W - 1) / 2 + 1;
  } else {
    a.PD = a.D, a.PH = a.H, a.PW = a.W;
  }
  a.xplane = D * H * W;
  a.gplane = (int64_t)a.PD * a.PH * a.PW;
  a.nbh = (int)cdiv(a.PH, BH);
  a.nbw = (int)cdiv(a.PW, BW);
  a.nb = cdiv(a.PD, bd) * a.nbh * a.nbw;
  a.bps = bps;
  a.sps = cdiv(a.nb, bps);
  a.gvec = a.PW % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (B * a.sps > 65535) return cudaErrorInvalidValue;
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  // the tiles fb1_plan takes
#define COMA_FB1(MODE_, K_, SW_, MT_, NT_)                                   \
  if (mode == (MODE_) && k == (K_) && (swap != 0) == (SW_) && mt == (MT_) && \
      nt == (NT_))                                                           \
  return launch<MODE_, K_, SW_, MT_, NT_>(a, bd, B, per_sample, o, s)
  COMA_FB1(S1, 3, false, 1, 1);
  COMA_FB1(S1, 3, false, 1, 2);
  COMA_FB1(S1, 3, false, 1, 4);
  COMA_FB1(S1, 3, true, 1, 1);
  COMA_FB1(S1, 3, true, 2, 1);
  COMA_FB1(S1, 1, false, 1, 1);
  COMA_FB1(S1, 1, false, 1, 2);
  COMA_FB1(S1, 1, false, 1, 4);
  COMA_FB1(S1, 1, true, 1, 1);
  COMA_FB1(S2, 3, false, 1, 4);
#undef COMA_FB1
  return cudaErrorInvalidValue;
}
