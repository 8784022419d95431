// K3 on the tensor cores: the transposed stride-2 3-D convolution (k = 3),
// the adjoint in x of K2's stride-2 SAME conv, in the JAX package's form (an
// lhs-dilated correlation): per axis
//
//   y[o] = sum_k xd[o + k - 1] * w[k],  xd = x dilated by 2, padded (1, 2),
//
// summed over Cin and the 27 taps t = (kd * 3 + kh) * 3 + kw, plus an f32
// bias before the one rounding to bf16. x [B, Cin, D, H, W] and y [B, Cout,
// 2D, 2H, 2W] are bf16 NCDHW; w is bf16 [Cout, Cin, 27] shared or [B, Cout,
// Cin, 27] per sample (the CondConv sites); the sums are f32. The same kernel
// computes the input gradient of the stride-2 conv (ops/conv3d_strided.py:
// conv3d_t2_dx: K3 on the cotangent with flipped, io-swapped weights, which
// K1's weight packing reads from w in place).
//
// Replaces, from coma_unet_tpu/ops/pallas/ (rows #14-#15 of the kernel table
// in PERF.md): conv3d_strided.py `_t2_fwd_v1` (`_t2_kernel`) and `_t2_fwd_v2`
// (`_t2_kernel_v2` + `_t2_phase_merge`); and the stride-2 conv's input
// gradient, `_s2_vjp_bwd` / `_s2_b_vjp_bwd` (`_t2_fwd` on the cotangent with
// flip_t(w)). ops/conv3d_strided.py:t2_plan gives the cut.
//
// The sub-pixel form: per axis, output 2i takes tap 1 from x[i], output
// 2i + 1 takes tap 0 from x[i] and tap 2 from x[i + 1] (x[n] reads zero). So
// each input position i owns the 2 x 2 x 2 cube of outputs 2i + parity, and
// each tap feeds exactly one of its 8 parity classes (tap_cls) from one of 8
// input offsets in {0, 1}^3 (tap_off): no zero-inserted input is formed.
//
// What bounds it on the H100: bytes, barely. At the path's shape (64 -> 32
// channels) 216^3 b=1 reads 161 MB of x and writes 645 MB of y, 0.241 ms at
// 3.35 TB/s, against 139 GFLOP, 0.141 ms of bf16 tensor-core operations.
// Against the operations the products run on mma.sync and each staged X
// fragment serves every tap that reads its offset; against the bytes x is
// staged once per brick (AT = 32 = Cout), the weights once per block,
// and y is written once, as whole 64-byte rows of the output in 16-byte
// vectors.
//
// Design: K1's implicit GEMM (csrc/conv3d_s1_tc.cu) on mma.sync m16n8k16
// (bf16 operands, f32 sums): M = input positions of a brick, N = output
// channels, K = a chunk of CT = 16 input channels,
//   Y_cls(t)[i, o] += sum_{c in chunk} X[i + off(t), c] * W_t[c, o].
// A block owns AT = 32 output channels of one sample (narrower layers pad
// with zeros, wider ones take tiles) and walks the
// bricks of BD x BH x BW = 2 x 4 x 16 input positions that t2_plan gives it
// (blockIdx.x, then gridDim.x apart), each brick chunk by chunk of Cin; its
// f32 sums are the 8 classes x 128 positions x 32 channels of one brick,
// 128 a thread. The whole reduction stays in the block: no
// split-K, no atomics, bit-identical results call to call. Per chunk it
// stages in shared memory
//  - the X box of the brick plus a halo of one on the high side of each
//    axis, (BD + 1)(BH + 1) rows of BW + 2 positions (the first, one below
//    the brick along W, is loaded and never read) x 16 channels,
//    channels-last, zero outside the volume: K1's halo brick layout and its
//    staging (tc_common.cuh:XStager, with the origin moved up one along D and
//    H), two buffers. An offset moves the lane's ldmatrix row by an
//    immediate; rows are padded to 3 16-byte units, so the 8 rows of one
//    ldmatrix phase fall in distinct banks;
//  - the W tile [27 taps][AT][16 channels] by 16-byte cp.async from the copy
//    that K1's weight packing (coma::pack_weights) lays out per call, reading
//    flip_t(w) in place for the input gradient. With Cin <= 64 every chunk
//    stays resident (four stages) and is loaded once per block, else two
//    stages take turns.
// The products take the taps in offset-major order (entry_tap): one A
// fragment per offset and m-tile serves all its taps (8, 4, 4, 4, 2, 2, 2,
// 1), so a chunk takes 8 ldmatrix per m-tile for 27 products, and the next
// entry's fragments are loaded before this one's products. The 8 warps are
// 4 along M x 2 along N (2 m-tiles x 2 n-tiles each). The next
// step's W cp.asyncs and X loads (volatile asm, into registers) are issued
// before this step's products, across bricks too, and X is stored after
// them into the other buffer. Epilogue: the f32 sums plus bias are rounded
// to bf16 once and stored interleaved into the brick's 4 x 8 x 32 output
// cube in shared memory ([o][rows][32], the two W parities of a class pair
// as one bf16x2), then written along W in 16-byte vectors (4 bytes where Wo
// or y does not allow it), each 64-byte output row by 4
// neighbouring threads, masked at the volume's edge (bricks are ragged at
// W = 108 and at odd sizes). 202,560 bytes of shared memory: one block an
// SM. In-plane offsets are 32-bit (the entry checks 8 D H W <
// 2^31), sample and channel offsets 64-bit.
#include "tc_common.cuh"

namespace {

using namespace coma;

constexpr int BD = 2, BH = 4, BW = 16;  // brick of input positions; BW is one m16 tile
constexpr int CT = 16;                  // input channels per chunk: one k16 step
constexpr int TAPS = 27, CLASSES = 8, OFFSETS = 8;
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int ROWS = BD * BH;              // brick rows (m-tiles)
constexpr int OROWS = 4 * ROWS, OW = 2 * BW;  // the output cube: (2BD)(2BH) rows of 2BW

// Per axis, tap k feeds output parity k != 1 from input offset k == 2; bit 2
// is D, bit 1 H, bit 0 W.
__host__ __device__ constexpr int tap_cls(int t) {
  return (t / 9 != 1) * 4 + (t / 3 % 3 != 1) * 2 + (t % 3 != 1);
}
__host__ __device__ constexpr int tap_off(int t) {
  return (t / 9 == 2) * 4 + (t / 3 % 3 == 2) * 2 + (t % 3 == 2);
}
// Entry i of the 27 taps in offset-major order, ascending within an offset.
__host__ __device__ constexpr int entry_tap(int i) {
  int n = 0;
  for (int d = 0; d < OFFSETS; ++d)
    for (int t = 0; t < TAPS; ++t)
      if (tap_off(t) == d) {
        if (n == i) return t;
        ++n;
      }
  return -1;
}

constexpr int AT = 32;                  // output channels per block
constexpr int WN = 2, WM = WARPS / WN;  // warps along N and M
constexpr int MT = ROWS / WM, NT = AT / 8 / WN;  // m- and n-tiles per warp: 2 x 2

// The X box as tc_common.cuh:XStager stages it: rows (d, h) of the brick and
// one above along each, of BW + 2 positions from one below the brick along W
// (R = 1 there; the caller moves the origin up one along D and H).
struct Box {
  static constexpr int R = 1, HH = BH + 1, HW = BW + 2, HROWS = (BD + 1) * HH;
  static constexpr int CTILE = CT, BWID = BW;
  static constexpr int HRSTEP = THREADS / CT, NX = (HROWS + HRSTEP - 1) / HRSTEP;
  static constexpr int XS = padded(CT), XELEMS = HROWS * HW * XS;  // bf16 per X buffer
};
constexpr int WELEMS = TAPS * AT * CT;  // bf16 per W stage
constexpr int WST = 4;                  // W stages: every chunk resident up to Cin = 64
constexpr int YS = OROWS * OW + 8;      // epilogue row [o][cube], padded: conflict-free
constexpr int SMEM = (2 * Box::XELEMS + WST * WELEMS + AT * YS) * 2;
static_assert(MT * WM == ROWS && NT == 2 && SMEM <= 227 * 1024, "tiles");

// The box row offset of input offset d.
__host__ __device__ constexpr int xoff(int d) {
  return ((d >> 2) * Box::HH + ((d >> 1) & 1)) * Box::HW + (d & 1);
}

struct T2Args {
  const bf16* x;
  const bf16* wp;     // packed weights [B?][nat][nch][27][AT][CT]
  const float* bias;  // [A] or null
  bf16* y;
  int C, A, D, H, W;  // 8 * plane < 2^31: in-plane offsets are 32-bit
  int Do, Ho, Wo;
  int64_t plane, oplane;
  int nbh, nbw, nb;   // bricks along H and W; per sample
  int nch, nat;       // Cin chunks, Cout tiles
  int per_sample;
};

struct Frags {
  uint32_t a[2][MT][4];  // by the parity of the offset's index
  uint32_t b[2][NT][2];  // by the parity of the entry
};

// The A fragments of offset d for the warp's m-tiles (a_lane: the lane's
// address at offset 0).
__device__ __forceinline__ void load_a(int d, uint32_t (&af)[MT][4],
                                       const uint32_t (&a_lane)[MT]) {
  const uint32_t off = xoff(d) * Box::XS * 2;
#pragma unroll
  for (int m = 0; m < MT; ++m) ldsm_x4(af[m][0], af[m][1], af[m][2], af[m][3], a_lane[m] + off);
}

// The B fragments of tap t for the warp's two n-tiles (b_lane: the lane's
// address in the tile of tap 0), as tc_common.cuh:load_frags reads them.
__device__ __forceinline__ void load_b(int t, uint32_t (&bfr)[NT][2], uint32_t sw,
                                       uint32_t b_lane) {
  ldsm_x4(bfr[0][0], bfr[0][1], bfr[1][0], bfr[1][1], sw + b_lane + t * AT * KSTEP * 2);
}

// Entry I of one staged chunk's products, then the rest: entry I + 1's
// fragments (its offset's A where the offset changes, its tap's B) are
// loaded before entry I's products into the other buffers.
template <int I>
__device__ __forceinline__ void mma_entries(float (&acc)[CLASSES][MT][NT][4], Frags& f,
                                            uint32_t sw, const uint32_t (&a_lane)[MT],
                                            uint32_t b_lane) {
  constexpr int t = entry_tap(I), d = tap_off(t), c = tap_cls(t);
  if constexpr (I + 1 < TAPS) {
    constexpr int t1 = entry_tap(I + 1), d1 = tap_off(t1);
    if constexpr (d1 != d) load_a(d1, f.a[d1 & 1], a_lane);
    load_b(t1, f.b[(I + 1) & 1], sw, b_lane);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_bf16(acc[c][m][n], f.a[d & 1][m], f.b[I & 1][n][0], f.b[I & 1][n][1]);
  if constexpr (I + 1 < TAPS) mma_entries<I + 1>(acc, f, sw, a_lane, b_lane);
}

template <int VX, int VY>
__global__ void __launch_bounds__(THREADS, 1) conv3d_t2_tc_kernel(const T2Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const sx = reinterpret_cast<bf16*>(smem);  // two X buffers [HROWS * HW][XS]
  bf16* const sw = sx + 2 * Box::XELEMS;           // WST W stages
  bf16* const sy = sw + WST * WELEMS;              // epilogue [AT][YS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, n0 = warp / WM * NT;  // the warp's m-tiles, first n-tile
  const int a0 = blockIdx.y * AT;
  const int64_t b = blockIdx.z;
  const bf16* const xb = p.x + b * p.C * p.plane;
  const bf16* const wt =
      p.wp + ((p.per_sample ? b * p.nat : 0) + blockIdx.y) * p.nch * (int64_t)WELEMS;
  bf16* const yb = p.y + b * p.A * p.oplane;

  // ldmatrix: lane l addresses row l % 8 of 8 x 8 matrix l / 8 (as K1).
  const int aunit = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const uint32_t b_lane = (swz(brow, (lane >> 3) & 1) + n0 * 8 * CT) * 2;
  uint32_t a_off[MT];  // the lane's byte offset in an X buffer at offset 0, per m-tile
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int q = wm + m * WM;  // brick row (q / BH, q % BH)
    const int row = ((q / BH) * Box::HH + q % BH) * Box::HW + 1 + (lane & 15);
    a_off[m] = (row * Box::XS + aunit * 8) * 2;
  }
  float bv[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int a = a0 + (n0 + n) * 8 + (lane & 3) * 2 + j;
      bv[n][j] = p.bias != nullptr && a < p.A ? p.bias[a] : 0.f;
    }
  float acc[CLASSES][MT][NT][4];
#pragma unroll
  for (int c = 0; c < CLASSES; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[c][m][n][r] = 0.f;

  // step s: chunk s % nch of the block's brick s / nch, which is brick
  // blockIdx.x + (s / nch) gridDim.x of the sample (blockIdx.x < nb)
  const int steps = (p.nb - 1 - (int)blockIdx.x) / (int)gridDim.x * p.nch + p.nch;
  auto brick = [&](int s, int& d0, int& h0, int& w0) {
    const int bi = blockIdx.x + s / p.nch * gridDim.x;
    w0 = bi % p.nbw * BW;
    h0 = bi / p.nbw % p.nbh * BH;
    d0 = bi / (p.nbw * p.nbh) * BD;
  };
  // with up to WST chunks the W stages hold every chunk and are loaded once:
  // chunk ch stays in stage ch
  const bool resident = p.nch <= WST;
  auto wstage = [&](int s) { return sw + (resident ? s % p.nch : s & 1) * WELEMS; };
  XStager<Box> st(p, xb, 0, tid);
  XRegs<Box> xr;
  {
    int d0, h0, w0;
    brick(0, d0, h0, w0);
    load_w<WELEMS, THREADS>(sw, wt, tid);
    cp_async_commit();
    st.template load_x<VX>(xr, p, d0 + 1, h0 + 1, w0);
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
        load_w<WELEMS, THREADS>(wstage(s + 1), wt + ch * (int64_t)WELEMS, tid);
      cp_async_commit();
      st = XStager<Box>(p, xb, ch * CT, tid);
      st.template load_x<VX>(xr, p, d0 + 1, h0 + 1, w0);
    }
    {
      const uint32_t cur = smem_u32(sx + (s & 1) * Box::XELEMS);
      uint32_t a_lane[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) a_lane[m] = cur + a_off[m];
      Frags f;
      const uint32_t wcur = smem_u32(wstage(s));
      load_a(0, f.a[0], a_lane);  // entry 0 reads offset 0
      load_b(entry_tap(0), f.b[0], wcur, b_lane);
      mma_entries<0>(acc, f, wcur, a_lane, b_lane);
    }
    const bool last = s % p.nch == p.nch - 1;  // the brick's sums are complete
    if (last) {
      // c[0..1] of an m16n8 tile: row (position ww) lane / 4, cols (output
      // channels) 2 (lane % 4) + {0, 1}; c[2..3]: row lane / 4 + 8. Class
      // (pd, ph, pw) of brick position (dd, hh, ww) is output (2 dd + pd,
      // 2 hh + ph, 2 ww + pw) of the cube; pw = 0, 1 go out as one bf16x2.
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int q = wm + m * WM, dd = q / BH, hh = q % BH;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int o = (n0 + n) * 8 + (lane & 3) * 2 + (r & 1);
            const int ww = (lane >> 2) + (r >> 1) * 8;
            const float bo = bv[n][r & 1];
#pragma unroll
            for (int c = 0; c < CLASSES; c += 2) {
              const int orow = (2 * dd + (c >> 2)) * (2 * BH) + 2 * hh + ((c >> 1) & 1);
              *reinterpret_cast<__nv_bfloat162*>(sy + o * YS + orow * OW + 2 * ww) =
                  __floats2bfloat162_rn(acc[c][m][n][r] + bo, acc[c + 1][m][n][r] + bo);
              acc[c][m][n][r] = 0.f;
              acc[c + 1][m][n][r] = 0.f;
            }
          }
      }
    }
    if (more) st.store_x(xr, sx + ((s + 1) & 1) * Box::XELEMS);
    cp_async_wait_all();
    __syncthreads();  // step s + 1 staged; step s's reads done; sy written
    if (last) {
      int d0, h0, w0;
      brick(s, d0, h0, w0);
      // y along W: piece i is VY outputs (w VY k .. VY k + VY - 1 of the
      // cube's row) of cube row orow of output channel o; the pieces of a
      // row go to neighbouring threads, so a warp writes whole 64-byte rows
      constexpr int NPIECE = OW / VY;
      for (int i = tid; i < AT * OROWS * NPIECE; i += THREADS) {
        const int o = i / (OROWS * NPIECE), orow = i / NPIECE % OROWS, k = i % NPIECE;
        const int od = 2 * d0 + orow / (2 * BH), oh = 2 * h0 + orow % (2 * BH);
        const int ow = 2 * w0 + VY * k;
        if (a0 + o < p.A && od < p.Do && oh < p.Ho && ow < p.Wo) {
          const bf16* src = sy + o * YS + orow * OW + VY * k;
          bf16* dst = yb + (a0 + o) * p.oplane + (od * p.Ho + oh) * p.Wo + ow;
          if constexpr (VY == 8) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
          }
        }
      }
      __syncthreads();  // sy read before the next brick's epilogue writes it
    }
  }
}

template <int VX, int VY>
cudaError_t launch(const T2Args& p, int64_t B, unsigned gx, cudaStream_t stream) {
  const auto kernel = conv3d_t2_tc_kernel<VX, VY>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(gx, (unsigned)p.nat, (unsigned)B), THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int VX>
cudaError_t dispatch_vy(const T2Args& p, bool vy8, int64_t B, unsigned gx, cudaStream_t s) {
  return vy8 ? launch<VX, 8>(p, B, gx, s) : launch<VX, 2>(p, B, gx, s);
}

}  // namespace

// K3 on the tensor cores. x [B, Cin, D, H, W] bf16 (8 D H W < 2^31), y
// [B, Cout, 2D, 2H, 2W] bf16; w [Cout, Cin, 27] or, with per_sample,
// [B, Cout, Cin, 27], and with flip the stride-2 conv's [B?, Cin, Cout, 27],
// used as flip_t(w); bias f32 [Cout] or null. The cut comes from
// ops/conv3d_strided.py:t2_plan: the brick (bd, bh, bw) = (2, 4, 16) input
// positions, ct = 16, at = 32, gx blocks along the bricks (1 <= gx
// <= the bricks of a sample; each block walks bricks gx apart). wpack holds
// B? * ceil(Cout / at) * ceil(Cin / 16) * 27 * at * 16 bf16 (B? = B with
// per_sample, else 1). Loads along W take 16 or 8 bytes where W and x allow
// it (W = 108 takes 8), else 2; stores 16 bytes where 2W and y allow it,
// else 4 (y 4-byte aligned).
COMA_API int coma_conv3d_t2(const void* x, const void* w, void* wpack, const void* bias, void* y,
                            int64_t B, int64_t Cin, int64_t Cout, int64_t D, int64_t H,
                            int64_t W, int64_t per_sample, int64_t flip, int64_t bd, int64_t bh,
                            int64_t bw, int64_t ct, int64_t at, int64_t gx, void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), ya = reinterpret_cast<uintptr_t>(y);
  if (B <= 0 || B > 65535 || Cin <= 0 || Cout <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      8 * D * H * W >= (int64_t(1) << 31) || bd != BD || bh != BH || bw != BW || ct != CT ||
      at != AT || cdiv(Cout, at) > 65535 || ya % 4 != 0)
    return cudaErrorInvalidValue;
  T2Args p;
  p.x = static_cast<const bf16*>(x);
  p.wp = static_cast<const bf16*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<bf16*>(y);
  p.C = (int)Cin;
  p.A = (int)Cout;
  p.D = (int)D;
  p.H = (int)H;
  p.W = (int)W;
  p.Do = (int)(2 * D);
  p.Ho = (int)(2 * H);
  p.Wo = (int)(2 * W);
  p.plane = D * H * W;
  p.oplane = 8 * p.plane;
  p.nbh = (int)cdiv(H, BH);
  p.nbw = (int)cdiv(W, BW);
  p.nb = (int)(cdiv(D, BD) * p.nbh * p.nbw);
  p.nch = (int)cdiv(Cin, CT);
  p.nat = (int)cdiv(Cout, AT);
  p.per_sample = per_sample != 0;
  if (gx <= 0 || gx > p.nb || gx > 65535) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      pack_weights(static_cast<const bf16*>(w), static_cast<bf16*>(wpack), p.A, p.C, TAPS, AT,
                   p.nat, p.nch, flip != 0, per_sample ? B : 1, s);
  if (err != cudaSuccess) return err;
  const bool vy8 = p.Wo % 8 == 0 && ya % 16 == 0;
  if (W % 8 == 0 && xa % 16 == 0) return dispatch_vy<8>(p, vy8, B, (unsigned)gx, s);
  if (W % 4 == 0 && xa % 8 == 0) return dispatch_vy<4>(p, vy8, B, (unsigned)gx, s);
  return dispatch_vy<1>(p, vy8, B, (unsigned)gx, s);
}
