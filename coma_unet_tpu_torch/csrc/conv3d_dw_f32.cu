// FB1: the float32 form of KB1 and KB2, on the CUDA cores. One kernel
// template computes two index maps of a weight gradient, summed in f32 over
// the positions p of g's grid:
//   S1, the stride-1 SAME conv, k in {1, 3}:
//     dW[o, c, t] = sum_p g[o, p] * x[c, p + t - k / 2]
//   S2, the stride-2 SAME conv, k = 3 (ops/conv3d_strided.py:
//     conv3d_strided_dw; the transposed conv's dW swaps the roles in Python):
//     M[o, c, t] = sum_p half[o, p] * full[c, 2p + t - 1]
// with x (full) zero outside the volume. x, g are f32 NCDHW; dW is f32
// [Cout, Cin, k^3], or [B, Cout, Cin, k^3] per sample (the CondConv sites).
//
// Replaces, in float32, from coma_unet_tpu/ops/pallas/ (the kernel table in
// PERF.md): conv3d.py `_pallas_conv3d_dw` and `_pallas_conv3d_dw_htiled`,
// conv3d_p1.py `_p1_dw`, conv3d_packed.py `_packed_dw` (rows #4, #5, #7, #9;
// S1) and conv3d_strided.py `_dw_dil_v1`, `_dw_v2` (#16, #17; S2). No TF32.
//
// What bounds it on the H100: at the wide sites f32 operations, at the
// narrow ones bytes. Design: a block owns a tile of Tc = 4 CG channels of x
// x To = QO OG channels of g x k^3 taps of dW and walks a run of bricks of g's
// grid (1 x 4 x 32 positions for S1, 1 x 2 x 32 for S2) of one sample. A
// thread owns 4 channels of x x QO channels of g x the k taps along W of
// one (td, th) pair, in registers: the block is k^2 CG OG threads
// (ops/conv3d.py:fdw_plan). Per brick the block copies g's tile [To][brick]
// and x's box (the brick and its halo; for S2 the box of the stride-2
// footprint, stored with the even positions along W first) into shared
// memory by 4-byte cp.async, zero outside the volume and past the channels,
// two bricks in flight. A thread walks the brick 4 positions at a time: per
// x channel it loads the 4 + k - 1 values of its box row (S2: 5 even and 4
// odd ones) and the QO float4 of g, and does 4 k QO FMAs.
// Split-K: the bricks of each sample are cut into runs (a split never
// straddles two samples); each split writes its partial dW to the f32
// workspace and dw_reduce.cuh sums the partials in split order. No float
// atomics: two calls give the same bits. Element offsets are 64-bit.
#include "dw_reduce.cuh"
#include "f32_common.cuh"

namespace {

using coma::cdiv;
using namespace coma::f32;

constexpr int CC = 4;                 // x channels a thread owns
constexpr int VW = 4;                 // positions along W a thread takes at a time
constexpr int MAX_THREADS = 288;
constexpr int MAX_SMEM = 227 * 1024;

enum Mode { S1 = 0, S2 = 1 };

template <int MODE, int K>
struct DwGeo {
  static constexpr int BD = 1, BH = MODE == S2 ? 2 : 4, BW = 32;  // the brick of g's grid
  static constexpr int P = BD * BH * BW;
  static constexpr int GROW = P + 4;  // a g channel's floats: 16-byte rows, banks spread
  static constexpr int XD = MODE == S2 ? 2 * BD + 1 : BD + K - 1;
  static constexpr int XH = MODE == S2 ? 2 * BH + 1 : BH + K - 1;
  static constexpr int XW = MODE == S2 ? 2 * BW + 1 : BW + K - 1;
  static constexpr int ROW = XW;
  static constexpr int HALF = (XW + 1) / 2;
  static constexpr int XBOX = XD * XH * ROW;
};

struct DwArgs {
  const float* x;   // S2: full
  const float* g;   // S2: half
  float* ws;        // [B * sps, Cout, Cin, k^3] partials
  int64_t Cin, Cout;
  int D, H, W;      // x's volume
  int PD, PH, PW;   // g's grid
  int nbh, nbw;     // bricks along H and W
  int64_t nb;       // bricks a sample
  int64_t bps, sps;
  int cg, og;       // thread groups along x's and g's channels
};

template <int MODE, int K>
__host__ __device__ constexpr int stage_floats(int tc, int to) {
  return round4(tc * DwGeo<MODE, K>::XBOX) + to * DwGeo<MODE, K>::GROW;
}

template <int MODE, int K, int QO>
__global__ void __launch_bounds__(MAX_THREADS) conv3d_dw_f32_kernel(const DwArgs a) {
  using G = DwGeo<MODE, K>;
  extern __shared__ __align__(16) float smem[];
  const int tc = CC * a.cg, to = QO * a.og;
  const int stage_n = stage_floats<MODE, K>(tc, to);
  const int xs_n = round4(tc * G::XBOX);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int oi = tid % a.og;
  const int ci = (tid / a.og) % a.cg;
  const int tg = tid / (a.og * a.cg);
  const int kd = tg / K, kh = tg % K;
  const int64_t c0 = (int64_t)blockIdx.x * tc, o0 = (int64_t)blockIdx.y * to;
  const int64_t split = blockIdx.z;
  const int64_t b = split / a.sps, s = split % a.sps;
  const int64_t j0 = s * a.bps, j1 = j0 + a.bps < a.nb ? j0 + a.bps : a.nb;
  const float* const xb = a.x + b * a.Cin * a.D * a.H * (int64_t)a.W;
  const float* const gb = a.g + b * a.Cout * a.PD * a.PH * (int64_t)a.PW;

  const auto stage = [&](int64_t j, int buf) {
    float* const xs = smem + buf * stage_n;
    float* const gs = xs + xs_n;
    const int bw = (int)(j % a.nbw), bh = (int)((j / a.nbw) % a.nbh), bd = (int)(j / ((int64_t)a.nbw * a.nbh));
    const int pd0 = bd * G::BD, ph0 = bh * G::BH, pw0 = bw * G::BW;
    const int xd0 = MODE == S2 ? 2 * pd0 - 1 : pd0 - K / 2;
    const int xh0 = MODE == S2 ? 2 * ph0 - 1 : ph0 - K / 2;
    const int xw0 = MODE == S2 ? 2 * pw0 - 1 : pw0 - K / 2;
    stage_box<G::XD, G::XH, G::XW, G::ROW, MODE == S2>(xs, G::XBOX, xb, a.Cin, a.D, a.H, a.W, c0,
                                                       tc, xd0, xh0, xw0, tid, nthreads);
    for (int e = tid; e < to * G::P; e += nthreads) {
      const int p = e % G::P, o = e / G::P;
      const int wx = p % G::BW, hy = (p / G::BW) % G::BH, dz = p / (G::BW * G::BH);
      const int gd = pd0 + dz, gh = ph0 + hy, gw = pw0 + wx;
      const bool ok = o0 + o < a.Cout && gd < a.PD && gh < a.PH && gw < a.PW;
      const float* src = ok ? gb + (((o0 + o) * a.PD + gd) * (int64_t)a.PH + gh) * a.PW + gw : a.g;
      cp_async4(gs + o * G::GROW + p, src, ok);
    }
    cp_async_commit();
  };

  float acc[CC][QO][K];
#pragma unroll
  for (int c = 0; c < CC; ++c)
#pragma unroll
    for (int q = 0; q < QO; ++q)
#pragma unroll
      for (int t = 0; t < K; ++t) acc[c][q][t] = 0.f;

  if (j0 < j1) stage(j0, 0);
  for (int64_t j = j0; j < j1; ++j) {
    const int buf = (int)((j - j0) & 1);
    if (j + 1 < j1) {
      stage(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* const xs = smem + buf * stage_n;
    const float* const gs = xs + xs_n;
#pragma unroll 1
    for (int r = 0; r < G::BD * G::BH; ++r) {
      const int dz = r / G::BH, hy = r % G::BH;
#pragma unroll 1
      for (int wg = 0; wg < G::BW / VW; ++wg) {
        float gv[QO][VW];
#pragma unroll
        for (int q = 0; q < QO; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(gs + (oi * QO + q) * G::GROW +
                                                           r * G::BW + VW * wg);
          gv[q][0] = v.x, gv[q][1] = v.y, gv[q][2] = v.z, gv[q][3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const float* const xc = xs + (ci * CC + c) * G::XBOX;
          if constexpr (MODE == S1) {
            float xv[VW + K - 1];
            const float* row = xc + ((dz + kd) * G::XH + hy + kh) * G::ROW + VW * wg;
#pragma unroll
            for (int i = 0; i < VW + K - 1; ++i) xv[i] = row[i];
#pragma unroll
            for (int t = 0; t < K; ++t)
#pragma unroll
              for (int q = 0; q < QO; ++q)
#pragma unroll
                for (int i = 0; i < VW; ++i) acc[c][q][t] = fmaf(gv[q][i], xv[i + t], acc[c][q][t]);
          } else {
            // full position 2p + t - 1 is box column 2p' + t (p' local):
            // t = 0 even p', t = 1 odd p', t = 2 even p' + 1
            const float* row = xc + ((2 * dz + kd) * G::XH + 2 * hy + kh) * G::ROW + VW * wg;
            float xe[VW + 1], xo[VW];
#pragma unroll
            for (int i = 0; i <= VW; ++i) xe[i] = row[i];
#pragma unroll
            for (int i = 0; i < VW; ++i) xo[i] = row[G::HALF + i];
#pragma unroll
            for (int q = 0; q < QO; ++q)
#pragma unroll
              for (int i = 0; i < VW; ++i) {
                acc[c][q][0] = fmaf(gv[q][i], xe[i], acc[c][q][0]);
                acc[c][q][1] = fmaf(gv[q][i], xo[i], acc[c][q][1]);
                acc[c][q][2] = fmaf(gv[q][i], xe[i + 1], acc[c][q][2]);
              }
          }
        }
      }
    }
    __syncthreads();
  }

  // this split's partial of the block's tile
  constexpr int TAPS = K * K * K;
  float* const part = a.ws + split * a.Cout * a.Cin * TAPS;
#pragma unroll
  for (int q = 0; q < QO; ++q) {
    const int64_t o = o0 + oi * QO + q;
    if (o >= a.Cout) break;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const int64_t cc = c0 + ci * CC + c;
      if (cc >= a.Cin) break;
#pragma unroll
      for (int t = 0; t < K; ++t)
        part[(o * a.Cin + cc) * TAPS + (kd * K + kh) * K + t] = acc[c][q][t];
    }
  }
}

template <int MODE, int K, int QO>
cudaError_t launch(const DwArgs& a, int64_t smem, dim3 grid, int threads, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv3d_dw_f32_kernel<MODE, K, QO>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  conv3d_dw_f32_kernel<MODE, K, QO><<<grid, threads, (size_t)smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE, int K>
cudaError_t launch_qo(const DwArgs& a, int64_t qo, int64_t smem, dim3 grid, int threads,
                      cudaStream_t stream) {
  return qo == 1 ? launch<MODE, K, 1>(a, smem, grid, threads, stream)
                 : launch<MODE, K, 4>(a, smem, grid, threads, stream);
}

}  // namespace

// FB1 in f32. mode 0 (S1): x [B, Cin, D, H, W], g [B, Cout, D, H, W], k in
// {1, 3}; mode 1 (S2): full [B, Cin, D, H, W], half [B, Cout, (D-1)/2+1,
// ...], k = 3. out receives f32 [Cout, Cin, k^3], or [B, Cout, Cin, k^3]
// with per_sample; ws holds B * ceil(bricks / bps) partials of Cout * Cin *
// k^3 floats. The cut comes from ops/conv3d.py:fdw_plan: qo in {1, 4}
// channels of g a thread, cg x og thread groups along the channels (a block
// is k^2 cg og threads), the brick (bd, bh, bw) = (1, 4 or 2, 32), bps
// bricks a split, smem the bytes of two stages.
COMA_API int coma_conv3d_dw_f32(const void* x, const void* g, void* ws, void* out, int64_t mode,
                                int64_t B, int64_t Cin, int64_t Cout, int64_t D, int64_t H,
                                int64_t W, int64_t k, int64_t per_sample, int64_t qo, int64_t cg,
                                int64_t og, int64_t bd, int64_t bh, int64_t bw, int64_t bps,
                                int64_t smem, void* stream) {
  if ((mode != S1 && mode != S2) || (k != 3 && (mode != S1 || k != 1)) || B <= 0 || Cin <= 0 ||
      Cout <= 0 || D <= 0 || H <= 0 || W <= 0 || D * H * W >= (int64_t(1) << 31) ||
      (qo != 1 && qo != 4) || cg <= 0 || og <= 0 || k * k * cg * og > MAX_THREADS || bd != 1 ||
      bh != (mode == S2 ? 2 : 4) || bw != 32 || bps <= 0)
    return cudaErrorInvalidValue;
  const int64_t tc = CC * cg, to = qo * og;
  const int64_t want = 4 * 2 * (mode == S2 ? stage_floats<S2, 3>((int)tc, (int)to)
                                : k == 3   ? stage_floats<S1, 3>((int)tc, (int)to)
                                           : stage_floats<S1, 1>((int)tc, (int)to));
  if (smem != want || smem > MAX_SMEM) return cudaErrorInvalidValue;
  DwArgs a{};
  a.x = static_cast<const float*>(x);
  a.g = static_cast<const float*>(g);
  a.ws = static_cast<float*>(ws);
  a.Cin = Cin;
  a.Cout = Cout;
  a.D = (int)D;
  a.H = (int)H;
  a.W = (int)W;
  if (mode == S2) {
    a.PD = (a.D - 1) / 2 + 1, a.PH = (a.H - 1) / 2 + 1, a.PW = (a.W - 1) / 2 + 1;
  } else {
    a.PD = a.D, a.PH = a.H, a.PW = a.W;
  }
  a.nbh = (int)cdiv(a.PH, bh);
  a.nbw = (int)cdiv(a.PW, bw);
  a.nb = cdiv(a.PD, bd) * a.nbh * a.nbw;
  a.bps = bps;
  a.sps = cdiv(a.nb, bps);
  a.cg = (int)cg;
  a.og = (int)og;
  if (B * a.sps > 65535 || cdiv(Cin, tc) > 0x7fffffff || cdiv(Cout, to) > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)cdiv(Cin, tc), (unsigned)cdiv(Cout, to), (unsigned)(B * a.sps));
  const int threads = (int)(k * k * cg * og);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == S2)
    err = launch_qo<S2, 3>(a, qo, smem, grid, threads, s);
  else if (k == 3)
    err = launch_qo<S1, 3>(a, qo, smem, grid, threads, s);
  else
    err = launch_qo<S1, 1>(a, qo, smem, grid, threads, s);
  if (err != cudaSuccess) return err;
  const int64_t taps = k * k * k;
  return launch_dw_reduce(a.ws, static_cast<float*>(out), Cout * Cin * taps, B, a.sps, per_sample,
                          s);
}
