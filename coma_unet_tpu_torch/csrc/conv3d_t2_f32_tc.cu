// F2's transposed map on the tensor cores in float32: the transposed
// stride-2 3-D convolution (k = 3), the adjoint in x of the stride-2 SAME
// conv, in the JAX package's form (an lhs-dilated correlation): per axis
//
//   y[o] = sum_k xd[o + k - 1] * w[k],  xd = x dilated by 2, padded (1, 2),
//
// summed over Cin and the 27 taps t = (kd * 3 + kh) * 3 + kw, plus an f32
// bias. x [B, Cin, D, H, W] and y [B, Cout, 2D, 2H, 2W] are f32 NCDHW; w is
// f32 [Cout, Cin, 27] shared or [B, Cout, Cin, 27] per sample (the CondConv
// sites). Every product is three TF32 mma.sync (tf32_common.cuh: 3xTF32),
// so the sums keep f32's accuracy (the reference's Precision.HIGHEST). The
// same kernel computes the input gradient of the stride-2 conv
// (ops/conv3d_strided.py:conv3d_t2_dx, on the cotangent with flip_t(w),
// which the weight packing reads from w in place).
//
// Replaces, in float32, from coma_unet_tpu/ops/pallas/ (rows #14-#15 of the
// kernel table in PERF.md): conv3d_strided.py `_t2_fwd_v1` and `_t2_fwd_v2`,
// and the stride-2 conv's input gradient `_s2_vjp_bwd` / `_s2_b_vjp_bwd`.
// ops/conv3d_strided.py:f2_plan gives the cut.
//
// The sub-pixel form (as K3, csrc/conv3d_t2_tc.cu): per axis, output 2i
// takes tap 1 from x[i], output 2i + 1 takes tap 0 from x[i] and tap 2 from
// x[i + 1] (x[n] reads zero). So each input position owns the 2 x 2 x 2
// cube of outputs 2i + parity, and each tap feeds one of its 8 parity
// classes (tap_cls) from one of 8 input offsets in {0, 1}^3 (tap_off): each
// class runs only its 1-8 taps, and no zero-inserted input is formed.
//
// What bounds it on the H100: operations. At the path's shape (64 -> 32
// channels) [2,64,64^3] takes 58.0 GFLOP, 0.352 ms at the 3xTF32 rate (165
// TFLOP/s), against 671 MB of x and y, 0.200 ms at 3.35 TB/s. So every
// product runs on the tensor cores, and each staged X fragment serves every
// tap that reads its offset.
//
// Design: K3's implicit GEMM in f32 on mma.sync m16n8k8 TF32, three per
// product: M = input positions of a brick, N = output channels, K = a chunk
// of CT = 8 input channels,
//   Y_cls(t)[i, o] += sum_{c in chunk} X[i + off(t), c] * W_t[c, o].
// A block owns AT = 32 output channels of one sample (all of Cout up to
// 32: x is staged once per brick; wider layers take tiles) and walks the
// bricks of BD x BH x BW = 2 x 4 x 16 input positions that f2_plan gives it
// (blockIdx.x, then gridDim.x apart), each brick chunk by chunk of Cin; its
// f32 sums are the 8 classes x 128 positions x 32 channels of one brick, 128
// a thread. The whole reduction stays in the block: no split-K, no atomics,
// bit-identical results call to call. Per chunk it stages in shared memory
//  - the X box of the brick plus a halo of one on the high side of each
//    axis, (BD + 1)(BH + 1) rows of BW + 2 positions (the first, one below
//    the brick along W, is loaded and never read) x 8 channels,
//    channels-last (48-byte rows), zero outside the volume and past Cin:
//    K3's box; global -> registers (16-byte loads where W % 4 == 0 and x
//    allows, else 4-byte) -> shared, two buffers;
//  - the W tile [27 taps][hi, lo][AT][8] by 16-byte cp.async from the copy
//    that the weight packing (tf32_common.cuh:pack_weights_tf32) splits
//    into TF32 hi and lo planes once per call, two buffers.
// X is held in shared memory as f32 once and split into hi and lo in
// registers after ldmatrix. The products take the taps in offset-major
// order (entry_tap): one A fragment per offset and m-tile, split once,
// serves all its taps (8, 4, 4, 4, 2, 2, 2, 1), and the next entry's
// fragments are loaded before this one's products. The 8 warps are 4 along
// M x 2 along N (2 m-tiles x 2 n-tiles each). The next step's W cp.asyncs
// and X loads (volatile asm, into registers) are issued before this step's
// products, across bricks too, and X is stored after them into the other
// buffer. 136,512 bytes of shared memory: one block an SM. Epilogue: the
// f32 sums plus bias go straight from the registers to y, the two W
// parities of a class pair as one float2 (a warp's store is 4 output
// channels x 16 consecutive outputs, whole 32-byte sectors), masked at the
// volume's edge. In-plane offsets are 32-bit (the entry checks 8 D H W <
// 2^31), sample and channel offsets 64-bit.
#include "tf32_common.cuh"

namespace {

using namespace coma;
using namespace coma::tf32;

constexpr int BD = 2, BH = 4, BW = 16;  // brick of input positions; BW is one m16 tile
constexpr int TAPS = 27, CLASSES = 8, OFFSETS = 8;
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int ROWS = BD * BH;  // brick rows (m-tiles)

// Per axis, tap k feeds output parity k != 1 from input offset k == 2; bit 2
// is D, bit 1 H, bit 0 W (K3's tables).
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
// the X box: rows (d, h) of the brick and one above along each, of BW + 2
// positions from one below the brick along W
constexpr int HH = BH + 1, HW = BW + 2, HROWS = (BD + 1) * HH;
constexpr int XELEMS = HROWS * HW * XS;  // floats per X buffer
// staging: thread t holds channel t % 8 of row piece t / 8 % 2 (w 0-7 or
// 8-15 of the brick, and the W-halo position on that side) of box rows
// t / 16 + i * HRSTEP
constexpr int HRSTEP = THREADS / (CT * 2), NX = (HROWS + HRSTEP - 1) / HRSTEP;
constexpr int WELEMS = TAPS * 2 * AT * CT;  // floats per W stage
constexpr int SMEM = (2 * XELEMS + 2 * WELEMS) * 4;
static_assert(MT * WM == ROWS && NT == 2 && SMEM <= 227 * 1024, "tiles");

// The box row offset of input offset d.
__host__ __device__ constexpr int xoff(int d) {
  return ((d >> 2) * HH + ((d >> 1) & 1)) * HW + (d & 1);
}

struct T2Args {
  const float* x;
  const float* wp;    // packed weights [B?][nat][nch][27][2][AT][8]
  const float* bias;  // [A] or null
  float* y;
  int C, A, D, H, W;  // 8 * plane < 2^31: in-plane offsets are 32-bit
  int Do, Ho, Wo;
  int64_t plane, oplane;
  int nbh, nbw, nb;   // bricks along H and W; per sample
  int nch, nat;       // Cin chunks, Cout tiles
  int per_sample;
  int vec;            // y takes float2 stores
};

struct Halo32Regs {
  float4 v[NX][2];  // the 8-wide row piece
  float e[NX];      // the W-halo position
};

// The share of one chunk's box that a thread stages.
struct Halo32Stager {
  const float* xc;  // channel c0 + c of this sample (clamped to a valid one)
  bool cok;         // c0 + c < C
  int c, v, hr0;

  __device__ __forceinline__ Halo32Stager(const T2Args& p, const float* xb, int c0, int tid) {
    c = tid % CT;
    v = tid / CT % 2;
    hr0 = tid / (2 * CT);
    cok = c0 + c < p.C;
    xc = xb + (cok ? c0 + c : 0) * p.plane;
  }

  // The box of the brick at (d0, h0, w0) into registers: rows d0 .. d0 +
  // BD, h0 .. h0 + BH, positions w0 - 1 .. w0 + BW.
  template <int VX>
  __device__ __forceinline__ void load_x(Halo32Regs& r, const T2Args& p, int d0, int h0,
                                         int w0) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      r.v[i][0] = r.v[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      r.e[i] = 0.f;
      const int hr = hr0 + i * HRSTEP;
      const int d = d0 + hr / HH, h = h0 + hr % HH;
      if (cok && hr < HROWS && d < p.D && h < p.H) {
        const float* row = xc + (d * p.H + h) * p.W;
        ldg_row8<VX>(r.v[i], row, w0 + 8 * v, p.W);
        const int we = v ? w0 + BW : w0 - 1;
        if ((unsigned)we < (unsigned)p.W) r.e[i] = ldg_f(row + we);
      }
    }
  }

  // Registers -> the box sx [rows][XS]: element e of the row piece goes to
  // box position 1 + 8 v + e, the halo position to v ? HW - 1 : 0.
  __device__ __forceinline__ void store_x(const Halo32Regs& r, float* sx) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int hr = hr0 + i * HRSTEP;
      if (hr < HROWS) {
        float* dst = sx + hr * HW * XS + c;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[(1 + 8 * v + e) * XS] = elem(r.v[i], e);
        dst[(v ? HW - 1 : 0) * XS] = r.e[i];
      }
    }
  }
};

struct Frags {
  uint32_t raw[2][MT][4];            // A of an offset, by the parity of its index
  uint32_t ahi[MT][4], alo[MT][4];   // the current offset's A, split
  uint32_t bh[2][NT][2], bl[2][NT][2];  // B, hi and lo, by the parity of the entry
};

// The raw A fragments of offset d for the warp's m-tiles (a_lane: the
// lane's address at offset 0).
__device__ __forceinline__ void load_a(int d, uint32_t (&af)[MT][4],
                                       const uint32_t (&a_lane)[MT]) {
  const uint32_t off = xoff(d) * XS * 4;
#pragma unroll
  for (int m = 0; m < MT; ++m) ldsm_x4(af[m][0], af[m][1], af[m][2], af[m][3], a_lane[m] + off);
}

// Entry I of one staged chunk's products, then the rest: an offset's A is
// split at its first entry; entry I + 1's fragments (its offset's A where
// the offset changes, its tap's B) are loaded before entry I's products.
template <int I>
__device__ __forceinline__ void mma_entries(float (&acc)[CLASSES][MT][NT][4], Frags& f,
                                            uint32_t sw, const uint32_t (&a_lane)[MT],
                                            uint32_t b_lane) {
  constexpr int t = entry_tap(I), d = tap_off(t), c = tap_cls(t);
  if constexpr (I == 0 || tap_off(entry_tap(I - 1)) != d) {
#pragma unroll
    for (int m = 0; m < MT; ++m) split_frag(f.raw[d & 1][m], f.ahi[m], f.alo[m]);
  }
  if constexpr (I + 1 < TAPS) {
    constexpr int t1 = entry_tap(I + 1), d1 = tap_off(t1);
    if constexpr (d1 != d) load_a(d1, f.raw[d1 & 1], a_lane);
    load_b32<NT, AT>(f.bh[(I + 1) & 1], f.bl[(I + 1) & 1], sw + b_lane + t1 * 2 * AT * CT * 4);
  }
  mma3(acc[c], f.ahi, f.alo, f.bh[I & 1], f.bl[I & 1]);
  if constexpr (I + 1 < TAPS) mma_entries<I + 1>(acc, f, sw, a_lane, b_lane);
}

template <int VX>
__global__ void __launch_bounds__(THREADS, 1) conv3d_t2_f32_tc_kernel(const T2Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const sx = reinterpret_cast<float*>(smem);  // two X buffers [rows][XS]
  float* const sw = sx + 2 * XELEMS;                 // two W stages
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, n0 = warp / WM * NT;  // the warp's m-tiles, first n-tile
  const int a0 = blockIdx.y * AT;
  const int64_t b = blockIdx.z;
  const float* const xb = p.x + b * p.C * p.plane;
  const float* const wt =
      p.wp + ((p.per_sample ? b * p.nat : 0) + blockIdx.y) * p.nch * (int64_t)WELEMS;
  float* const yb = p.y + b * p.A * p.oplane;

  // ldmatrix: lane l addresses row l % 8 of 8 x 8 matrix l / 8 (as K3).
  const int aunit = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const uint32_t b_lane = (swz4(brow, (lane >> 3) & 1) + n0 * 8 * CT) * 4;
  uint32_t a_off[MT];  // the lane's byte offset in an X buffer at offset 0, per m-tile
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int q = wm + m * WM;  // brick row (q / BH, q % BH)
    const int row = ((q / BH) * HH + q % BH) * HW + 1 + (lane & 15);
    a_off[m] = (row * XS + aunit * 4) * 4;
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
  const int steps = ((p.nb - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * p.nch;
  auto brick = [&](int s, int& d0, int& h0, int& w0) {
    const int bi = blockIdx.x + s / p.nch * gridDim.x;
    w0 = bi % p.nbw * BW;
    h0 = bi / p.nbw % p.nbh * BH;
    d0 = bi / (p.nbw * p.nbh) * BD;
  };
  Halo32Stager st(p, xb, 0, tid);
  Halo32Regs xr;
  {
    int d0, h0, w0;
    brick(0, d0, h0, w0);
    load_w32<WELEMS, THREADS>(sw, wt, tid);
    cp_async_commit();
    st.load_x<VX>(xr, p, d0, h0, w0);
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
      load_w32<WELEMS, THREADS>(sw + ((s + 1) & 1) * WELEMS, wt + ch * (int64_t)WELEMS, tid);
      st = Halo32Stager(p, xb, ch * CT, tid);
      st.load_x<VX>(xr, p, d0, h0, w0);
    }
    cp_async_commit();
    {
      const uint32_t cur = smem_u32(sx + (s & 1) * XELEMS);
      uint32_t a_lane[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) a_lane[m] = cur + a_off[m];
      Frags f;
      const uint32_t wcur = smem_u32(sw + (s & 1) * WELEMS);
      load_a(0, f.raw[0], a_lane);  // entry 0 reads offset 0
      load_b32<NT, AT>(f.bh[0], f.bl[0], wcur + b_lane + entry_tap(0) * 2 * AT * CT * 4);
      mma_entries<0>(acc, f, wcur, a_lane, b_lane);
    }
    if (s % p.nch == p.nch - 1) {  // the brick's sums are complete
      int d0, h0, w0;
      brick(s, d0, h0, w0);
      // c[0..1] of an m16n8 tile: row (position ww) lane / 4, cols (output
      // channels) 2 (lane % 4) + {0, 1}; c[2..3]: row lane / 4 + 8. Class
      // (pd, ph, pw) of brick position (dd, hh, ww) is output (2 (d0 + dd) +
      // pd, 2 (h0 + hh) + ph, 2 (w0 + ww) + pw); pw = 0, 1 go out together.
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int q = wm + m * WM, dd = q / BH, hh = q % BH;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int o = a0 + (n0 + n) * 8 + (lane & 3) * 2 + (r & 1);
            const int ow = 2 * (w0 + (lane >> 2) + (r >> 1) * 8);
            const float bo = bv[n][r & 1];
#pragma unroll
            for (int c = 0; c < CLASSES; c += 2) {
              const int od = 2 * (d0 + dd) + (c >> 2), oh = 2 * (h0 + hh) + ((c >> 1) & 1);
              if (o < p.A && od < p.Do && oh < p.Ho && ow < p.Wo) {
                float* dst = yb + o * p.oplane + (od * p.Ho + oh) * p.Wo + ow;
                const float lo = acc[c][m][n][r] + bo, hi = acc[c + 1][m][n][r] + bo;
                if (p.vec) {
                  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
                } else {
                  dst[0] = lo;
                  dst[1] = hi;
                }
              }
              acc[c][m][n][r] = 0.f;
              acc[c + 1][m][n][r] = 0.f;
            }
          }
      }
    }
    if (more) st.store_x(xr, sx + ((s + 1) & 1) * XELEMS);
    cp_async_wait_all();
    __syncthreads();  // step s + 1 staged; step s's reads done
  }
}

template <int VX>
cudaError_t launch(const T2Args& p, int64_t B, unsigned gx, cudaStream_t stream) {
  const auto kernel = conv3d_t2_f32_tc_kernel<VX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(gx, (unsigned)p.nat, (unsigned)B), THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// F2's transposed map on the tensor cores. x [B, Cin, D, H, W] f32 (8 D H W
// < 2^31), y [B, Cout, 2D, 2H, 2W] f32; w [Cout, Cin, 27] or, with
// per_sample, [B, Cout, Cin, 27], and with flip the stride-2 conv's [B?,
// Cin, Cout, 27], used as flip_t(w); bias f32 [Cout] or null. The cut comes
// from ops/conv3d_strided.py:f2_plan: the brick (bd, bh, bw) = (2, 4, 16)
// input positions, ct = 8, at = 32, gx blocks along the bricks (1 <= gx <=
// the bricks of a sample; each block walks bricks gx apart). wpack holds
// B? * ceil(Cout / 32) * ceil(Cin / 8) * 27 * 2 * 32 * 8 floats (B? = B
// with per_sample, else 1). Loads along W take 16 bytes where W % 4 == 0
// and x is 16-byte aligned, else 4; stores 8 bytes where y is 8-byte
// aligned, else 4.
COMA_API int coma_conv3d_t2_f32_tc(const void* x, const void* w, void* wpack, const void* bias,
                                   void* y, int64_t B, int64_t Cin, int64_t Cout, int64_t D,
                                   int64_t H, int64_t W, int64_t per_sample, int64_t flip,
                                   int64_t bd, int64_t bh, int64_t bw, int64_t ct, int64_t at,
                                   int64_t gx, void* stream) {
  if (B <= 0 || B > 65535 || Cin <= 0 || Cout <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      8 * D * H * W >= (int64_t(1) << 31) || bd != BD || bh != BH || bw != BW || ct != CT ||
      at != AT || cdiv(Cout, at) > 65535)
    return cudaErrorInvalidValue;
  T2Args p;
  p.x = static_cast<const float*>(x);
  p.wp = static_cast<const float*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
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
  p.vec = reinterpret_cast<uintptr_t>(y) % 8 == 0;
  if (gx <= 0 || gx > p.nb || gx > 65535) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      pack_weights_tf32<TAPS>(static_cast<const float*>(w), static_cast<float*>(wpack), p.A, p.C,
                              AT, p.nat, p.nch, flip != 0, per_sample ? B : 1, s);
  if (err != cudaSuccess) return err;
  if (W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<4>(p, B, (unsigned)gx, s);
  return launch<1>(p, B, (unsigned)gx, s);
}
