// KB1: weight gradient of the stride-1 SAME 3-D convolution (k in {1, 3})
// on the tensor cores:
//
//   dW[a, c, t] = sum_p g[a, p] * x[c, p + s_t]
//
// with s_t the offset of tap t (3-D, kd major) and x zero outside the
// volume. x [B, Cin, D, H, W] and g [B, Cout, D, H, W] are bf16 NCDHW; dW is
// f32 [Cout, Cin, k^3], or [B, Cout, Cin, k^3] per sample (the CondConv
// sites), summed in f32.
//
// Replaces, from coma_unet_tpu/ops/pallas/ (rows #4, #5, #7 and #9 of the
// kernel table in PERF.md): conv3d.py `_pallas_conv3d_dw` (`_dw_kernel`,
// `_dw_k1_kernel`) and `_pallas_conv3d_dw_htiled`, conv3d_p1.py `_p1_dw` and
// conv3d_packed.py `_packed_dw`: one function on four TPU layouts, and the
// Cin = 1 route that the JAX package sends to phase_dot.shift_dot_dw.
//
// What bounds it on the H100: at the wide k = 3 sites (32-128 input
// channels) tensor-core operations (head.conv1 at 216^3 is 557 GFLOP on
// 1.3 GB of operands); at 16 channels or fewer, and at k = 1, bytes.
// Against the first, the products run on mma.sync and every staged value
// serves many of them; against the second, the operands are read from
// device memory about once (the halo re-reads of neighbouring bricks hit
// L2) and the staging of brick i+1 overlaps the products of brick i.
// Layers of fewer than 16 input or 8 output channels pad their tile with
// zeros: the tensor cores' spare rate pays for it.
//
// Design: 27 small GEMMs, one per tap, that share staged operands,
//   D_t[c, a] += sum_{p in brick} X[c, p + s_t] * G[a, p],
// on mma.sync m16n8k16 (bf16 operands, f32 sums): M = input channels,
// N = output channels, K = positions. A block owns CT input channels x AT
// output channels x k^3 taps in f32 registers and walks a run of bricks of
// BD x BH x BW = 4 x 4 x 16 positions of one sample (BW is one k16 step of
// mma, a brick 16 steps). Per brick it stages in shared memory
//  - the G tile [AT][positions], positions contiguous: mma's B operand, read
//    with ldmatrix; loaded with cp.async (16 bytes where W allows it),
//    zero-filled past the volume and past Cout;
//  - the X halo brick [(BD+2)(BH+2)(BW+2) positions][CT channels],
//    channels-last, zero outside the volume (the SAME padding, done here).
//    For tap t the A operand is this buffer read from row position + s_t
//    with ldmatrix.trans: a tap moves a row pointer by whole 16-byte rows,
//    so every staged X value serves all 27 taps and every staged G value
//    every (channel, tap). The transpose to channels-last happens once per
//    brick, global -> registers -> shared. Rows of both buffers are padded to
//    an odd number of 16-byte units, so the 8 rows that one ldmatrix phase
//    reads fall in distinct banks.
// Two stages: the G cp.asyncs and the X loads of brick i+1 are issued before
// the products of brick i (the loads are volatile asm, so the compiler keeps
// them there), and X is stored to shared memory after them. For k = 3 a
// block holds 16 input channels (one m-tile) and each of its 9 warps one
// (kd, kh) pair and its three kw taps, so a warp's G fragments serve 3
// taps; at under 113 registers a thread, two blocks share an SM, and one
// block's staging and barrier overlap the other's products. For k = 1 the
// 16 warps split a brick's 16 k16 steps and sum their tiles through shared
// memory in warp order. Bricks are walked in order, w fastest, with no
// division after the first; each thread's share of the staging (channel
// pair, row piece, halo rows) is fixed for the block.
//
// Split-K: the bricks of each sample are cut into runs (a split never
// straddles two samples); each split writes its partial dW to the f32
// workspace and dw_reduce.cuh sums the partials in split order: no float
// atomics, bit-identical results from run to run. Element offsets are
// 64-bit; bricks that cross the volume's edge (W = 216, 108) are masked at
// staging. The cut is chosen in Python (ops/conv3d.py:dw_plan).
#include "dw_reduce.cuh"
#include "tc_common.cuh"

namespace {

using namespace coma;

constexpr int BD = 4, BH = 4, BW = 16;  // brick of positions; BW is one k16 step

// K taps per axis, CT x AT channel tile, VW elements per vector load along W.
template <int K, int CT, int AT, int VW>
struct Tc {
  static constexpr int R = K / 2, T = K * K * K;
  static constexpr int HD = BD + 2 * R, HH = BH + 2 * R, HW = BW + 2 * R;
  static constexpr int HROWS = HD * HH, XROWS = HROWS * HW;  // halo (d, h) rows, positions
  static constexpr int XS = padded(CT), KB = BD * BH * BW, GS = padded(KB);
  static constexpr int STEPS = BD * BH;                // k16 steps per brick
  static constexpr int J = K == 3 ? 1 : STEPS;         // warps that split a brick's steps
  static constexpr int MT = CT / 16, NT = AT / 8, NACC = K * MT * NT * 4;  // sums per warp
  static constexpr int WARPS = K * K * J, THREADS = 32 * WARPS;
  // k = 3 holds one m-tile (CT = 16) and fits two blocks on an SM, so one
  // block's staging and barrier overlap the other's products
  static constexpr int MIN_BLOCKS = K == 3 ? 2 : 1;
  static constexpr int XELEMS = XROWS * XS, STAGE = XELEMS + AT * GS;  // bf16 per stage
  // X staging: thread t holds channel pair t % (CT/2), row piece t / (CT/2) % 2
  // (w 0-7 or 8-15, and the W-halo element on that side) of halo rows
  // t / CT + i * HRSTEP. G staging: 16-byte piece t % 2 of k16 step
  // t / 2 % STEPS of output channels t / 16 + j * (THREADS / 16).
  static constexpr int HRSTEP = THREADS / CT, NX = (HROWS + HRSTEP - 1) / HRSTEP;
  static constexpr int NG = (AT * 2 * STEPS + THREADS - 1) / THREADS;
  static constexpr int SMEM = cmax(2 * STAGE * 2, J > 1 ? WARPS * NACC * 32 * 4 : 0);
  static constexpr int CTILE = CT, ATILE = AT, BWID = BW;
  static_assert(BW == 16 && THREADS % CT == 0 && (THREADS / 2) % STEPS == 0, "staging map");
  static_assert(K == 1 || CT == 16, "k = 3 takes 16-channel tiles");
};

struct TcArgs {
  const bf16* x;
  const bf16* g;
  float* ws;
  int A, C, D, H, W;     // plane = D * H * W < 2^31: in-plane offsets are 32-bit
  int64_t plane;
  int nbh, nbw;          // bricks along H and W
  int64_t nb, bps, sps;  // bricks per sample, per split; splits per sample
};

// What one thread stages, fixed for the block (see Tc).
template <class Cf>
struct Stager : XStager<Cf> {
  int gv, gq, ga;  // G: 16-byte piece, k16 step, first output channel of the tile

  __device__ __forceinline__ Stager(const TcArgs& p, const bf16* xb, int c0, int tid)
      : XStager<Cf>(p, xb, c0, tid) {
    gv = tid % 2;
    gq = tid / 2 % Cf::STEPS;
    ga = tid / (2 * Cf::STEPS);
  }

  // The G tile sg [AT][GS] of the brick: row a holds positions (dd, hh, ww)
  // at (dd * BH + hh) * BW + ww, zero past the volume and past Cout.
  template <int VW>
  __device__ __forceinline__ void load_g(bf16* sg, const TcArgs& p, const bf16* gb, int a0,
                                         int d0, int h0, int w0) const {
    const int d = d0 + gq / BH, h = h0 + gq % BH, w = w0 + 8 * gv;
    const bool in = d < p.D && h < p.H;
    const int off = (d * p.H + h) * p.W + w;
#pragma unroll
    for (int j = 0; j < Cf::NG; ++j) {
      const int a = ga + j * (Cf::THREADS / (2 * Cf::STEPS));
      if (a < Cf::ATILE) {
        const bool ok = in && a0 + a < p.A;
        const bf16* src = gb + (ok ? a0 + a : 0) * p.plane + (ok ? off : 0);
        bf16* dst = sg + a * Cf::GS + gq * BW + 8 * gv;
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

// The products of one staged brick: warp (td, th, jw) takes k16 steps jw,
// jw + J, ... and, per step, taps (td, th, 0 .. K-1). A step's fragments
// are all loaded before its products, so one ldmatrix latency covers them.
template <class Cf, int K>
__device__ __forceinline__ void mma_brick(float (&acc)[K][Cf::MT][Cf::NT][4], uint32_t sx,
                                          uint32_t a_lane, uint32_t b_lane, uint32_t b_lane2,
                                          int td, int th, int jw) {
  const uint32_t sg = sx + Cf::XELEMS * 2;
#pragma unroll 2
  for (int q = jw; q < Cf::STEPS; q += Cf::J) {
    const int dd = q / BH, hh = q % BH;
    uint32_t bfr[Cf::NT][2];
#pragma unroll
    for (int n = 0; n + 1 < Cf::NT; n += 2)
      ldsm_x4(bfr[n][0], bfr[n][1], bfr[n + 1][0], bfr[n + 1][1],
              sg + b_lane + (n * 8 * Cf::GS + q * BW) * 2);
    if constexpr (Cf::NT % 2 == 1)
      ldsm_x2(bfr[Cf::NT - 1][0], bfr[Cf::NT - 1][1],
              sg + b_lane2 + ((Cf::NT - 1) * 8 * Cf::GS + q * BW) * 2);
    const int row0 = ((dd + td) * Cf::HH + hh + th) * Cf::HW;
    uint32_t afr[K][Cf::MT][4];
#pragma unroll
    for (int tw = 0; tw < K; ++tw)
#pragma unroll
      for (int mt = 0; mt < Cf::MT; ++mt)
        ldsm_x4_trans(afr[tw][mt], sx + a_lane + ((row0 + tw) * Cf::XS + mt * 16) * 2);
#pragma unroll
    for (int tw = 0; tw < K; ++tw)
#pragma unroll
      for (int mt = 0; mt < Cf::MT; ++mt)
#pragma unroll
        for (int n = 0; n < Cf::NT; ++n)
          mma_bf16(acc[tw][mt][n], afr[tw][mt], bfr[n][0], bfr[n][1]);
  }
}

template <int K, int CT, int AT, int VW>
__global__ void __launch_bounds__(Tc<K, CT, AT, VW>::THREADS, Tc<K, CT, AT, VW>::MIN_BLOCKS)
conv3d_dw_tc_kernel(const TcArgs p) {
  using Cf = Tc<K, CT, AT, VW>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const stages = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * CT, a0 = blockIdx.y * AT;
  const int64_t split = blockIdx.z, b = split / p.sps;
  const int64_t bi0 = split % p.sps * p.bps;
  const int64_t bi1 = bi0 + p.bps < p.nb ? bi0 + p.bps : p.nb;
  const bf16* const gb = p.g + b * p.A * p.plane;
  const Stager<Cf> st(p, p.x + b * p.C * p.plane, c0, tid);

  const int jw = warp % Cf::J, tg = warp / Cf::J, td = tg / K, th = tg % K;
  // ldmatrix: lane l addresses row l % 8 of 8 x 8 matrix l / 8; matrices 0-3
  // are (rows 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) of the
  // stored 16 x 16 tile. A is stored [position][channel] (read transposed),
  // B [out channel][position]; for x2 only lanes 0-15 count.
  const int lrow = ((lane >> 4) << 3) + (lane & 7), lcol = ((lane >> 3) & 1) * 8;
  const uint32_t a_lane = (lrow * Cf::XS + lcol) * 2;
  const uint32_t b_lane = (lrow * Cf::GS + lcol) * 2;
  const uint32_t b_lane2 = ((lane & 7) * Cf::GS + lcol) * 2;

  float acc[K][Cf::MT][Cf::NT][4];
#pragma unroll
  for (int tw = 0; tw < K; ++tw)
#pragma unroll
    for (int mt = 0; mt < Cf::MT; ++mt)
#pragma unroll
      for (int n = 0; n < Cf::NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[tw][mt][n][r] = 0.f;

  // the first brick's origin; then bricks in order, w fastest
  int w0 = (int)(bi0 % p.nbw) * BW, h0 = (int)(bi0 / p.nbw % p.nbh) * BH;
  int d0 = (int)(bi0 / ((int64_t)p.nbw * p.nbh)) * BD;
  XRegs<Cf> xr;
  if (bi0 < bi1) {
    st.template load_g<VW>(stages + Cf::XELEMS, p, gb, a0, d0, h0, w0);
    cp_async_commit();
    st.template load_x<VW>(xr, p, d0, h0, w0);
    st.store_x(xr, stages);
    cp_async_wait_all();
    __syncthreads();
  }
  int buf = 0;
  for (int64_t bi = bi0; bi < bi1; ++bi) {
    bf16* const cur = stages + buf * Cf::STAGE;
    bf16* const nxt = stages + (buf ^ 1) * Cf::STAGE;
    const bool more = bi + 1 < bi1;
    if (more) {  // brick i+1: G by cp.async, X into registers
      w0 += BW;
      if (w0 >= p.W) {
        w0 = 0;
        h0 += BH;
        if (h0 >= p.H) {
          h0 = 0;
          d0 += BD;
        }
      }
      st.template load_g<VW>(nxt + Cf::XELEMS, p, gb, a0, d0, h0, w0);
      cp_async_commit();
      st.template load_x<VW>(xr, p, d0, h0, w0);
    }
    mma_brick<Cf, K>(acc, smem_u32(cur), a_lane, b_lane, b_lane2, td, th, jw);
    if (more) st.store_x(xr, nxt);
    cp_async_wait_all();
    __syncthreads();  // brick i+1 staged; brick i's reads done
    buf ^= 1;
  }

  // c[0..1] of an m16n8 tile: row lane / 4, cols 2 (lane % 4) + {0, 1};
  // c[2..3]: row lane / 4 + 8.
  float* const out = p.ws + split * p.A * p.C * Cf::T;
  if constexpr (Cf::J == 1) {
#pragma unroll
    for (int tw = 0; tw < K; ++tw)
#pragma unroll
      for (int mt = 0; mt < Cf::MT; ++mt)
#pragma unroll
        for (int n = 0; n < Cf::NT; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int c = c0 + mt * 16 + (lane >> 2) + (r >> 1) * 8;
            const int a = a0 + n * 8 + (lane & 3) * 2 + (r & 1);
            if (c < p.C && a < p.A)
              out[((int64_t)a * p.C + c) * Cf::T + (td * K + th) * K + tw] = acc[tw][mt][n][r];
          }
  } else {  // k = 1: the J warps' tiles summed through shared memory in warp order
    static_assert(K == 1, "k = 3 keeps its sums in one warp each");
    float* const red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < Cf::MT; ++mt)
#pragma unroll
      for (int n = 0; n < Cf::NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          red[(warp * Cf::NACC + (mt * Cf::NT + n) * 4 + r) * 32 + lane] = acc[0][mt][n][r];
    __syncthreads();
    for (int e = tid; e < Cf::NACC * 32; e += Cf::THREADS) {
      float s = 0.f;
      for (int j = 0; j < Cf::J; ++j) s += red[j * Cf::NACC * 32 + e];
      const int ln = e % 32, id = e / 32, r = id % 4, n = id / 4 % Cf::NT, mt = id / (4 * Cf::NT);
      const int c = c0 + mt * 16 + (ln >> 2) + (r >> 1) * 8;
      const int a = a0 + n * 8 + (ln & 3) * 2 + (r & 1);
      if (c < p.C && a < p.A) out[(int64_t)a * p.C + c] = s;
    }
  }
}

template <int K, int CT, int AT, int VW>
cudaError_t launch_tc(const TcArgs& p, int64_t B, int64_t per_sample, float* out,
                      cudaStream_t stream) {
  using Cf = Tc<K, CT, AT, VW>;
  const auto kernel = conv3d_dw_tc_kernel<K, CT, AT, VW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)cdiv(p.C, CT), (unsigned)cdiv(p.A, AT), (unsigned)(B * p.sps));
  kernel<<<grid, Cf::THREADS, Cf::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_reduce(p.ws, out, (int64_t)p.A * p.C * Cf::T, B, p.sps, per_sample, stream);
}

template <int K, int VW>
cudaError_t dispatch_tc(const TcArgs& p, int64_t ct, int64_t at, int64_t B, int64_t ps,
                        float* out, cudaStream_t s) {
#define COMA_TC(CT, AT) \
  if (ct == CT && at == AT) return launch_tc<K, CT, AT, VW>(p, B, ps, out, s)
  COMA_TC(16, 8);
  COMA_TC(16, 16);
  COMA_TC(16, 32);
  if constexpr (K == 1) {
    COMA_TC(32, 8);
    COMA_TC(32, 16);
    COMA_TC(32, 32);
  }
#undef COMA_TC
  return cudaErrorInvalidValue;
}

template <int K>
cudaError_t dispatch_vw(const TcArgs& p, int vw, int64_t ct, int64_t at, int64_t B,
                        int64_t ps, float* out, cudaStream_t s) {
  if (vw == 8) return dispatch_tc<K, 8>(p, ct, at, B, ps, out, s);
  if (vw == 4) return dispatch_tc<K, 4>(p, ct, at, B, ps, out, s);
  return dispatch_tc<K, 1>(p, ct, at, B, ps, out, s);
}

}  // namespace

// KB1. x [B, Cin, D, H, W], g [B, Cout, D, H, W] bf16 (D * H * W < 2^31);
// out f32 [Cout, Cin, k^3] or, with per_sample, [B, Cout, Cin, k^3]. The cut
// comes from ops/conv3d.py:dw_plan: channel tiles ct in {16, 32} (16 for
// k = 3) and at in {8, 16, 32}, the brick (bd, bh, bw) = (4, 4, 16) and bps
// bricks per split; ws holds B * ceil(bricks / bps) * Cout * Cin * k^3
// floats. Loads along W take 16 or 8 bytes where W and the pointers allow
// it, else 2.
COMA_API int coma_conv3d_s1_dw(const void* x, const void* g, void* ws, void* out, int64_t B,
                               int64_t Cin, int64_t Cout, int64_t D, int64_t H, int64_t W,
                               int64_t k, int64_t per_sample, int64_t ct, int64_t at, int64_t bd,
                               int64_t bh, int64_t bw, int64_t bps, void* stream) {
  if (bd != BD || bh != BH || bw != BW || B <= 0 || Cin <= 0 || Cout <= 0 || D <= 0 || H <= 0 ||
      W <= 0 || D * H * W >= (int64_t(1) << 31) || Cin > 65535 * 32 || Cout > 65535 * 8 ||
      bps <= 0)
    return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g);
  const int vw = W % 8 == 0 && align % 16 == 0 ? 8 : W % 4 == 0 && align % 8 == 0 ? 4 : 1;
  TcArgs p;
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const bf16*>(g);
  p.ws = static_cast<float*>(ws);
  p.A = (int)Cout;
  p.C = (int)Cin;
  p.D = (int)D;
  p.H = (int)H;
  p.W = (int)W;
  p.plane = D * H * W;
  p.nbh = (int)cdiv(H, BH);
  p.nbw = (int)cdiv(W, BW);
  p.nb = cdiv(D, BD) * p.nbh * p.nbw;
  p.bps = bps;
  p.sps = cdiv(p.nb, bps);
  if (B * p.sps > 65535) return cudaErrorInvalidValue;
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (k == 3) return dispatch_vw<3>(p, vw, ct, at, B, per_sample, o, s);
  if (k == 1) return dispatch_vw<1>(p, vw, ct, at, B, per_sample, o, s);
  return cudaErrorInvalidValue;
}
