// K2 on the tensor cores: the stride-2 SAME 3-D convolution (k = 3, padding
// 1 on each side)
//
//   y[b, o, q] = sum_c sum_t w[(b,) o, c, t] * x[b, c, 2q + s_t - 1] (+ bias[o])
//
// with s_t in {0, 1, 2}^3 the offset of tap t (kd major) and x zero outside
// the volume; the output is (n - 1) / 2 + 1 per axis, so odd sizes are
// allowed. x [B, Cin, D, H, W] and y [B, Cout, Do, Ho, Wo] are bf16 NCDHW; w
// is bf16 [Cout, Cin, 27] shared or [B, Cout, Cin, 27] per sample (the
// CondConv sites); the sums are f32, bias (f32, may be absent) is added
// before the one rounding to bf16. The same kernel computes the input
// gradient of the transposed stride-2 conv (ops/conv3d_strided.py:
// conv3d_s2_dx: K2 on the cotangent with flipped, io-swapped weights, which
// the weight packing reads from w in place).
//
// Replaces, from coma_unet_tpu/ops/pallas/ (rows #10-#12 of the kernel table
// in PERF.md): conv3d_strided.py `_s2_fwd_v1` (`_s2_kernel`) and
// `_s2_fwd_v2` (`_s2_kernel_v2`), with the H/W parity split that feeds v2,
// phase_split.py `pallas_hwsplit`, done here in shared memory; and the input
// gradient of the transposed conv, `_t2_vjp_bwd` / `_t2_b_vjp_bwd` (which
// call `_s2_fwd` on the cotangent with flip_t(w)). ops/conv3d_strided.py:
// s2_plan gives the cut.
//
// What bounds it on the H100: bytes, barely. At the path's shape (32 -> 64
// channels, per sample) 216^3 b=1 reads 645 MB of x and writes 161 MB of y,
// 0.241 ms at 3.35 TB/s, against 139 GFLOP, 0.141 ms of bf16 tensor-core
// operations; each output takes 27 x Cin products, so a design that does
// them on the CUDA cores or stages x more than once is far from either.
// Against the operations, the products run on mma.sync and every staged X
// value serves the taps that read it x all AT output channels; against the
// bytes, x is staged once per brick (AT = Cout up to 64), the halo re-reads
// of neighbouring bricks hit L2, y is written once in 16-byte vectors, and
// the staging of the next chunk overlaps the products of this one.
//
// Design: K1's implicit GEMM per tap (csrc/conv3d_s1_tc.cu) with stride-2
// addressing,
//   Y[q, o] += sum_{c in chunk} X[2q + s_t - 1, c] * W_t[c, o],
// on mma.sync m16n8k16 (bf16 operands, f32 sums): M = output positions,
// N = output channels, K = a chunk of CT = 16 input channels. A block owns
// AT = 8, 16, 32 or 64 output channels of one sample in f32 registers and
// walks the bricks of BD x BH x BW = 2 x 4 x 16 output positions that
// s2_plan gives it (blockIdx.x, then gridDim.x apart), each brick chunk by
// chunk of Cin and, per chunk, the 27 taps. The whole reduction stays in
// the block: no split-K, no atomics, bit-identical results call to call.
// Per chunk it stages in shared memory
//  - the stride-2 halo box of the brick, (2BD+1)(2BH+1)(2BW+1) = 5 x 9 x 33
//    input positions x 16 channels, channels-last, zero outside the volume,
//    global -> registers -> shared as K1 stages its halo brick
//    (tc_common.cuh:Box2, BoxStager, shared with KB2). Each axis of
//    the box is stored split by parity (its n + 1 even positions, then its n
//    odd ones: the TPU's pallas_hwsplit, in shared memory), so tap offset
//    s along an axis reads position q + {0, n + 1, 1}[s] for output q: unit
//    stride again, and a tap moves the lane's ldmatrix row by an immediate.
//    Rows are padded to 3 16-byte units, so the 8 rows of one ldmatrix
//    phase fall in distinct banks (an unsplit box read at stride 2 would be
//    a 2-way conflict at any padding);
//  - the W tile [27 taps][AT][16 channels] by 16-byte cp.async from the
//    copy that K1's weight packing (coma::pack_weights) lays out per call,
//    reading flip_t(w) in place for the input gradient.
// X has one buffer (71,280 bytes) and W two (864 bytes an output channel
// each), 199,280 bytes with the epilogue's tile at AT = 64, one block an
// SM: the next step's W cp.asyncs and X loads (volatile asm, into
// registers) are issued before this step's products, across bricks too,
// and X is stored after them behind a barrier. At AT = 64 the 8 warps are
// 4 along M x 2 along N (2 m-tiles x 4 n-tiles each, 4 ldmatrix per 8
// products), below it 8 x 1. Epilogue: the f32 sums plus bias are rounded
// to bf16 once, staged as [o][positions] and written along W in 16-byte
// vectors (8 or 2 where Wo does not allow it; a warp writes whole 32-byte
// brick rows, which at Wo = 108 straddle sectors), masked at the volume's edge
// (bricks are ragged at Wo = 108 and at odd sizes). In-plane offsets are
// 32-bit (the entry checks D * H * W < 2^31), sample and channel offsets
// 64-bit.
#include "tc_common.cuh"

namespace {

using namespace coma;

constexpr int BD = 2, BH = 4, BW = 16;  // brick of output positions; BW is one m16 tile
constexpr int CT = 16;                  // input channels per chunk: one k16 step
constexpr int TAPS = 27;
constexpr int WARPS = 8, THREADS = 32 * WARPS;
// the stride-2 halo box (tc_common.cuh:Box2): 2n + 1 input positions along
// an axis of n outputs, stored split by parity
using Box = Box2<BD, BH, THREADS>;
constexpr int HH = Box::HH, HW = Box::HW;
constexpr int XROW = Box::XS;  // X row: 16 channels in 3 16-byte units
constexpr int XELEMS = Box::XELEMS;
constexpr int ROWS = BD * BH, POS = ROWS * BW;  // brick rows (m-tiles), positions

template <int AT>
struct S2 {
  static constexpr int WN = AT >= 64 ? 2 : 1, WM = WARPS / WN;  // warps along N and M
  static constexpr int MT = ROWS / WM, NT = AT / 8 / WN;         // m- and n-tiles per warp
  static constexpr int T = TAPS, XS = XROW, ATILE = AT;  // for mma_taps
  // the row offset of tap t in the parity-split box
  __host__ __device__ static constexpr int toff(int t) {
    return (shift(t / 9, BD) * HH + shift(t / 3 % 3, BH)) * HW + shift(t % 3, BW);
  }
  static constexpr int WELEMS = TAPS * AT * CT;                   // bf16 per W stage
  static constexpr int YS = POS + 8;  // epilogue row [o][positions], padded
  static constexpr int SMEM = (XELEMS + 2 * WELEMS + AT * YS) * 2;
  static_assert(MT * WM == ROWS && NT * WN * 8 == AT && SMEM <= 227 * 1024, "tiles");
};

struct S2Args {
  const bf16* x;
  const bf16* wp;     // packed weights [B?][nat][nch][T][AT][CT]
  const float* bias;  // [A] or null
  bf16* y;
  int C, A, D, H, W;  // plane = D * H * W < 2^31: in-plane offsets are 32-bit
  int Do, Ho, Wo;
  int64_t plane, oplane;
  int nbh, nbw, nb;   // output bricks along H and W; per sample
  int nch, nat;       // Cin chunks, Cout tiles
  int per_sample;
};

template <int AT, int VX, int VY>
__global__ void __launch_bounds__(THREADS, 1) conv3d_s2_tc_kernel(const S2Args p) {
  using Cf = S2<AT>;
  constexpr int MT = Cf::MT, NT = Cf::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const sx = reinterpret_cast<bf16*>(smem);  // [XROWS][XROW]
  bf16* const sw = sx + XELEMS;                    // two W stages
  bf16* const sy = sw + 2 * Cf::WELEMS;            // epilogue [AT][YS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % Cf::WM, n0 = warp / Cf::WM * NT;  // the warp's m-tiles, first n-tile
  const int a0 = blockIdx.y * AT;
  const int64_t b = blockIdx.z;
  const bf16* const xb = p.x + b * p.C * p.plane;
  const bf16* const wt =
      p.wp + ((p.per_sample ? b * p.nat : 0) + blockIdx.y) * p.nch * (int64_t)Cf::WELEMS;
  bf16* const yb = p.y + b * p.A * p.oplane;

  // ldmatrix: lane l addresses row l % 8 of 8 x 8 matrix l / 8 (as K1).
  const int aunit = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const uint32_t b_lane = (swz(brow, (lane >> 3) & 1) + n0 * 8 * CT) * 2;
  uint32_t a_lane[MT];  // the lane's box row at tap 0, per m-tile (brick row q)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int q = wm + m * Cf::WM;
    const int row = ((q / BH) * HH + q % BH) * HW + (lane & 15);
    a_lane[m] = smem_u32(sx) + (row * XROW + aunit * 8) * 2;
  }
  float bv[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int a = a0 + (n0 + n) * 8 + (lane & 3) * 2 + j;
      bv[n][j] = p.bias != nullptr && a < p.A ? p.bias[a] : 0.f;
    }
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;

  // step s: chunk s % nch of the block's brick s / nch, which is brick
  // blockIdx.x + (s / nch) gridDim.x of the sample (blockIdx.x < nb)
  const int steps = (p.nb - 1 - (int)blockIdx.x) / (int)gridDim.x * p.nch + p.nch;
  auto brick = [&](int s, int& d0, int& h0, int& w0) {
    const int bi = blockIdx.x + s / p.nch * gridDim.x;
    w0 = bi % p.nbw * BW;
    h0 = bi / p.nbw % p.nbh * BH;
    d0 = bi / (p.nbw * p.nbh) * BD;
  };
  // with two chunks or one, the W stages hold every chunk and are loaded
  // once: chunk ch stays in stage ch
  const bool resident = p.nch <= 2;
  auto wstage = [&](int s) { return sw + (resident ? s % p.nch : s & 1) * Cf::WELEMS; };
  BoxStager<Box> st(p, xb, 0, tid);
  BoxRegs<Box> xr;
  {
    int d0, h0, w0;
    brick(0, d0, h0, w0);
    load_w<Cf::WELEMS, THREADS>(sw, wt, tid);
    cp_async_commit();
    st.load_x<VX>(xr, p, 2 * d0 - 1, 2 * h0 - 1, 2 * w0 - 1);
    st.store_x(xr, sx);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) {  // step s + 1: W by cp.async, X into registers
      const int ch = (s + 1) % p.nch;
      int d0, h0, w0;
      brick(s + 1, d0, h0, w0);
      if (!resident || s + 1 < p.nch)
        load_w<Cf::WELEMS, THREADS>(wstage(s + 1), wt + ch * (int64_t)Cf::WELEMS, tid);
      cp_async_commit();
      st = BoxStager<Box>(p, xb, ch * CT, tid);
      st.load_x<VX>(xr, p, 2 * d0 - 1, 2 * h0 - 1, 2 * w0 - 1);
    }
    mma_taps<Cf>(acc, smem_u32(wstage(s)), a_lane, b_lane);
    const bool last = s % p.nch == p.nch - 1;  // the brick's sums are complete
    if (last) {
      // c[0..1] of an m16n8 tile: row (position) lane / 4, cols (output
      // channels) 2 (lane % 4) + {0, 1}; c[2..3]: row lane / 4 + 8.
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int o = (n0 + n) * 8 + (lane & 3) * 2 + (r & 1);
            const int pos = (wm + m * Cf::WM) * BW + (lane >> 2) + (r >> 1) * 8;
            sy[o * Cf::YS + pos] = __float2bfloat16(acc[m][n][r] + bv[n][r & 1]);
            acc[m][n][r] = 0.f;
          }
    }
    __syncthreads();  // the box's reads done; sy written
    if (last) {
      int d0, h0, w0;
      brick(s, d0, h0, w0);
      // y along W: piece i is VE positions (w VE k .. VE k + VE - 1) of brick
      // row q of output channel o; the pieces of a row go to neighbouring
      // threads, so a warp writes whole 32-byte rows
      constexpr int VE = VY == 4 ? 4 : 8, NPIECE = BW / VE;
      for (int i = tid; i < AT * ROWS * NPIECE; i += THREADS) {
        const int o = i / (ROWS * NPIECE), q = i / NPIECE % ROWS, k = i % NPIECE;
        const int d = d0 + q / BH, h = h0 + q % BH, w = w0 + VE * k;
        if (a0 + o < p.A && d < p.Do && h < p.Ho && w < p.Wo) {
          const bf16* src = sy + o * Cf::YS + q * BW + VE * k;
          bf16* dst = yb + (a0 + o) * p.oplane + (d * p.Ho + h) * p.Wo + w;
          if constexpr (VY == 8) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else if constexpr (VY == 4) {
            *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (w + e < p.Wo) dst[e] = src[e];
          }
        }
      }
    }
    if (more) st.store_x(xr, sx);
    cp_async_wait_all();
    __syncthreads();  // step s + 1 staged; sy read
  }
}

template <int AT, int VX, int VY>
cudaError_t launch(const S2Args& p, int64_t B, unsigned gx, cudaStream_t stream) {
  const auto kernel = conv3d_s2_tc_kernel<AT, VX, VY>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S2<AT>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(gx, (unsigned)p.nat, (unsigned)B), THREADS, S2<AT>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int VX, int VY>
cudaError_t dispatch_tile(const S2Args& p, int64_t at, int64_t B, unsigned gx, cudaStream_t s) {
  if (at == 64) return launch<64, VX, VY>(p, B, gx, s);
  if (at == 32) return launch<32, VX, VY>(p, B, gx, s);
  if (at == 16) return launch<16, VX, VY>(p, B, gx, s);
  if (at == 8) return launch<8, VX, VY>(p, B, gx, s);
  return cudaErrorInvalidValue;
}

template <int VX>
cudaError_t dispatch_vy(const S2Args& p, int vy, int64_t at, int64_t B, unsigned gx,
                        cudaStream_t s) {
  if (vy == 8) return dispatch_tile<VX, 8>(p, at, B, gx, s);
  if (vy == 4) return dispatch_tile<VX, 4>(p, at, B, gx, s);
  return dispatch_tile<VX, 1>(p, at, B, gx, s);
}

}  // namespace

// K2 on the tensor cores. x [B, Cin, D, H, W] bf16 (D * H * W < 2^31), y
// [B, Cout, (D-1)/2+1, (H-1)/2+1, (W-1)/2+1] bf16; w [Cout, Cin, 27] or, with
// per_sample, [B, Cout, Cin, 27], and with flip the transposed conv's
// [B?, Cin, Cout, 27], used as flip_t(w); bias f32 [Cout] or null. The cut
// comes from ops/conv3d_strided.py:s2_plan: the brick (bd, bh, bw) =
// (2, 4, 16) output positions, ct = 16, at in {8, 16, 32, 64}, gx blocks
// along the bricks (1 <= gx <= the bricks of a sample; each block walks
// bricks gx apart). wpack holds B? * ceil(Cout / at) * ceil(Cin / 16) * 27
// * at * 16 bf16 (B? = B with per_sample, else 1). Loads along W take 16
// bytes where W and x allow it, else 2; stores 16 or 8 where Wo and y
// allow it, else 2.
COMA_API int coma_conv3d_s2_tc(const void* x, const void* w, void* wpack, const void* bias,
                               void* y, int64_t B, int64_t Cin, int64_t Cout, int64_t D,
                               int64_t H, int64_t W, int64_t per_sample, int64_t flip,
                               int64_t bd, int64_t bh, int64_t bw, int64_t ct, int64_t at,
                               int64_t gx, void* stream) {
  if (B <= 0 || B > 65535 || Cin <= 0 || Cout <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      D * H * W >= (int64_t(1) << 31) || bd != BD || bh != BH || bw != BW || ct != CT ||
      (at != 8 && at != 16 && at != 32 && at != 64) || cdiv(Cout, at) > 65535)
    return cudaErrorInvalidValue;
  S2Args p;
  p.x = static_cast<const bf16*>(x);
  p.wp = static_cast<const bf16*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<bf16*>(y);
  p.C = (int)Cin;
  p.A = (int)Cout;
  p.D = (int)D;
  p.H = (int)H;
  p.W = (int)W;
  p.Do = (int)((D - 1) / 2 + 1);
  p.Ho = (int)((H - 1) / 2 + 1);
  p.Wo = (int)((W - 1) / 2 + 1);
  p.plane = D * H * W;
  p.oplane = (int64_t)p.Do * p.Ho * p.Wo;
  p.nbh = (int)cdiv(p.Ho, BH);
  p.nbw = (int)cdiv(p.Wo, BW);
  p.nb = (int)(cdiv(p.Do, BD) * p.nbh * p.nbw);
  p.nch = (int)cdiv(Cin, CT);
  p.nat = (int)cdiv(Cout, at);
  p.per_sample = per_sample != 0;
  if (gx <= 0 || gx > p.nb || gx > 65535) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      pack_weights(static_cast<const bf16*>(w), static_cast<bf16*>(wpack), p.A, p.C, TAPS, (int)at,
                   p.nat, p.nch, flip != 0, per_sample ? B : 1, s);
  if (err != cudaSuccess) return err;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), ya = reinterpret_cast<uintptr_t>(y);
  const int vy = p.Wo % 8 == 0 && ya % 16 == 0 ? 8 : p.Wo % 4 == 0 && ya % 8 == 0 ? 4 : 1;
  if (W % 8 == 0 && xa % 16 == 0) return dispatch_vy<8>(p, vy, at, B, (unsigned)gx, s);
  return dispatch_vy<1>(p, vy, at, B, (unsigned)gx, s);
}
