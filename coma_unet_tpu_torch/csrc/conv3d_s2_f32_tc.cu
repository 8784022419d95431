// F2's stride-2 map on the tensor cores in float32: the stride-2 SAME 3-D
// convolution (k = 3, padding 1 on each side)
//
//   y[b, o, q] = sum_c sum_t w[(b,) o, c, t] * x[b, c, 2q + s_t - 1] (+ bias[o])
//
// with s_t in {0, 1, 2}^3 the offset of tap t (kd major) and x zero outside
// the volume; the output is (n - 1) / 2 + 1 per axis. x [B, Cin, D, H, W]
// and y [B, Cout, Do, Ho, Wo] are f32 NCDHW; w is f32 [Cout, Cin, 27]
// shared or [B, Cout, Cin, 27] per sample (the CondConv sites); bias (f32,
// may be absent) is added to the f32 sums. Every product is three TF32
// mma.sync (tf32_common.cuh: 3xTF32), so the sums keep f32's accuracy (the
// reference's Precision.HIGHEST). The same kernel computes the input
// gradient of the transposed stride-2 conv (ops/conv3d_strided.py:
// conv3d_s2_dx, on the cotangent with flip_t(w), which the weight packing
// reads from w in place).
//
// Replaces, in float32, from coma_unet_tpu/ops/pallas/ (rows #10-#12 of the
// kernel table in PERF.md): conv3d_strided.py `_s2_fwd_v1` and `_s2_fwd_v2`,
// phase_split.py `pallas_hwsplit` (the parity split, done here in shared
// memory), and the transposed conv's input gradient `_t2_vjp_bwd` /
// `_t2_b_vjp_bwd`. ops/conv3d_strided.py:f2_plan gives the cut.
//
// What bounds it on the H100: operations. At the path's shape (32 -> 64
// channels, per sample) [2,32,128^3] takes 58.0 GFLOP, 0.352 ms at the
// 3xTF32 rate (165 TFLOP/s), against 671 MB of x and y, 0.200 ms at 3.35
// TB/s. So every product runs on the tensor cores, and each staged X value
// and W fragment serves as many of them as the registers allow.
//
// Design: K2's implicit GEMM per tap (csrc/conv3d_s2_tc.cu) in f32,
//   Y[q, o] += sum_{c in chunk} X[2q + s_t - 1, c] * W_t[c, o],
// on mma.sync m16n8k8 TF32, three per product: M = output positions, N =
// output channels, K = a chunk of CT = 8 input channels. A block owns AT =
// 32 or 64 output channels of one sample in f32 registers (all of Cout up
// to 64: x is staged once per brick) and walks the bricks of BD x BH x BW =
// 2 x 4 x 16 output positions that f2_plan gives it (blockIdx.x, then
// gridDim.x apart), each brick chunk by chunk of Cin and, per chunk, its
// taps in three groups of 9 (one kd each). The whole reduction stays in the
// block: no split-K, no atomics, bit-identical results call to call. It
// stages in shared memory
//  - per chunk, the stride-2 halo box of the brick, (2BD+1)(2BH+1)(2BW+1) =
//    5 x 9 x 33 input positions x 8 channels, channels-last (48-byte rows),
//    zero outside the volume and past Cin, each axis split by parity as
//    K2's box is (tc_common.cuh:Box2, split, shift: pallas_hwsplit's job),
//    so every tap reads it at unit stride and moves the lane's ldmatrix
//    row by an immediate; global -> registers (16-byte loads where W % 4
//    == 0 and x allows, else 4-byte) -> shared, one buffer;
//  - per tap group, its W tile [9 taps][hi, lo][AT][8] by 16-byte
//    cp.async from the copy that the weight packing (tf32_common.cuh:
//    pack_weights_tf32) splits into TF32 hi and lo planes once per call,
//    two buffers.
// X is held in shared memory as f32 once and split into hi and lo in
// registers after ldmatrix. The next group's W cp.asyncs, and at a chunk's
// last group the next chunk's X loads (volatile asm, into registers), are
// issued before this group's products, across bricks too; X is stored
// after them behind a barrier. 145,008 bytes of shared memory at AT = 64:
// one block an SM. At AT = 64 the 8 warps are 4 along M x 2 along N (2
// m-tiles x 4 n-tiles each: 2 A and 4 B ldmatrix per 24 mma), at AT = 32
// 8 x 1. Epilogue: the f32 sums plus bias go straight from the registers to
// y (a warp's store is 4 output channels x 8 consecutive positions, whole
// 32-byte sectors), masked at the volume's edge. In-plane offsets are
// 32-bit (the entry checks D * H * W < 2^31), sample and channel offsets
// 64-bit.
#include "tf32_common.cuh"

namespace {

using namespace coma;
using namespace coma::tf32;

constexpr int BD = 2, BH = 4, BW = 16;  // brick of output positions; BW is one m16 tile
constexpr int TAPS = 27, TG = 9;        // taps; taps a W stage (one kd)
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int ROWS = BD * BH;           // brick rows (m-tiles)
// the stride-2 halo box (tc_common.cuh:Box2's layout with 8 f32 channels a
// position): 2n + 1 input positions along an axis of n outputs
constexpr int HD = 2 * BD + 1, HH = 2 * BH + 1, HW = 2 * BW + 1;
constexpr int HROWS = HD * HH, XELEMS = HROWS * HW * XS;  // box (d, h) rows; floats
// staging: thread t holds channel t % 8 of row piece t / 8 % 4 (box
// positions 1 + 8 v .. 8 + 8 v along W) of box rows t / 32 + i * HRSTEP;
// the pieces' first (v = 0) also holds the box's first position
constexpr int PIECES = 2 * BW / 8;
constexpr int HRSTEP = THREADS / (CT * PIECES), NX = (HROWS + HRSTEP - 1) / HRSTEP;

template <int AT>
struct S2 {
  static constexpr int WN = AT >= 64 ? 2 : 1, WM = WARPS / WN;  // warps along N and M
  static constexpr int MT = ROWS / WM, NT = AT / 8 / WN;         // m- and n-tiles per warp
  static constexpr int WSTAGE = TG * 2 * AT * CT;                // floats of a W stage
  static constexpr int SMEM = (XELEMS + 2 * WSTAGE) * 4;
  static_assert(MT * WM == ROWS && NT * WN * 8 == AT && NT % 2 == 0 && SMEM <= 227 * 1024,
                "tiles");
};

// The box row offset of tap (kh, kw) = (j / 3, j % 3) of a group; kd's
// offset is added at run time.
__host__ __device__ constexpr int toff(int j) {
  return shift(j / 3, BH) * HW + shift(j % 3, BW);
}

struct S2Args {
  const float* x;
  const float* wp;    // packed weights [B?][nat][nch][27][2][AT][8]
  const float* bias;  // [A] or null
  float* y;
  int C, A, D, H, W;  // plane = D * H * W < 2^31: in-plane offsets are 32-bit
  int Do, Ho, Wo;
  int64_t plane, oplane;
  int nbh, nbw, nb;   // output bricks along H and W; per sample
  int nch, nat;       // Cin chunks, Cout tiles
  int per_sample;
};

struct Box32Regs {
  float4 v[NX][2];  // the 8-wide row piece
  float e[NX];      // the box's first position along W
};

// The share of one chunk's box that a thread stages.
struct Box32Stager {
  const float* xc;  // channel c0 + c of this sample (clamped to a valid one)
  bool cok;         // c0 + c < C
  int c, v, hr0;

  __device__ __forceinline__ Box32Stager(const S2Args& p, const float* xb, int c0, int tid) {
    c = tid % CT;
    v = tid / CT % PIECES;
    hr0 = tid / (CT * PIECES);
    cok = c0 + c < p.C;
    xc = xb + (cok ? c0 + c : 0) * p.plane;
  }

  // The box whose first input position is (d0, h0, w0) = 2 x the brick's
  // origin - 1, into registers; w0 + 1 is a multiple of 32.
  template <int VX>
  __device__ __forceinline__ void load_x(Box32Regs& r, const S2Args& p, int d0, int h0,
                                         int w0) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      r.v[i][0] = r.v[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      r.e[i] = 0.f;
      const int hr = hr0 + i * HRSTEP;
      const int d = d0 + hr / HH, h = h0 + hr % HH;
      if (cok && hr < HROWS && (unsigned)d < (unsigned)p.D && (unsigned)h < (unsigned)p.H) {
        const float* row = xc + (d * p.H + h) * p.W;
        ldg_row8<VX>(r.v[i], row, w0 + 1 + 8 * v, p.W);
        if (v == 0 && w0 >= 0) r.e[i] = ldg_f(row + w0);
      }
    }
  }

  // Registers -> the parity-split box sx [rows][XS]: element e of the row
  // piece is box position j = 1 + 8 v + e along W, stored at split(j, BW);
  // position 0 is stored first.
  __device__ __forceinline__ void store_x(const Box32Regs& r, float* sx) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int hr = hr0 + i * HRSTEP;
      if (hr < HROWS) {
        const int srow = (split(hr / HH, BD) * HH + split(hr % HH, BH)) * HW;
        float* dst = sx + srow * XS + c;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int s = e % 2 == 0 ? BW + 1 + 4 * v + e / 2 : 4 * v + (e + 1) / 2;
          dst[s * XS] = elem(r.v[i], e);
        }
        if (v == 0) dst[0] = r.e[i];
      }
    }
  }
};

// The products of one staged tap group: taps (kd, j / 3, j % 3), j < 9, of
// one chunk (koff: the byte offset of kd's box rows; sw: the group's W
// tile). Tap j + 1's fragments are loaded before tap j's products; X's are
// split into hi and lo just before their products.
template <class Cf>
__device__ __forceinline__ void mma_group(float (&acc)[Cf::MT][Cf::NT][4], uint32_t koff,
                                          uint32_t sw, const uint32_t (&a_lane)[Cf::MT],
                                          uint32_t b_lane) {
  constexpr int MT = Cf::MT, NT = Cf::NT, AT = NT * 8 * Cf::WN;
  uint32_t raw[2][MT][4], ahi[MT][4], alo[MT][4], bh[2][NT][2], bl[2][NT][2];
  auto load = [&](int j, uint32_t (&a)[MT][4], uint32_t (&h)[NT][2], uint32_t (&l)[NT][2]) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      ldsm_x4(a[m][0], a[m][1], a[m][2], a[m][3], a_lane[m] + koff + toff(j) * XS * 4);
    load_b32<NT, AT>(h, l, sw + b_lane + j * 2 * AT * CT * 4);
  };
  load(0, raw[0], bh[0], bl[0]);
#pragma unroll
  for (int j = 0; j < TG; ++j) {
#pragma unroll
    for (int m = 0; m < MT; ++m) split_frag(raw[j & 1][m], ahi[m], alo[m]);
    if (j + 1 < TG) load(j + 1, raw[(j + 1) & 1], bh[(j + 1) & 1], bl[(j + 1) & 1]);
    mma3(acc, ahi, alo, bh[j & 1], bl[j & 1]);
  }
}

template <int AT, int VX>
__global__ void __launch_bounds__(THREADS, 1) conv3d_s2_f32_tc_kernel(const S2Args p) {
  using Cf = S2<AT>;
  constexpr int MT = Cf::MT, NT = Cf::NT, WSTAGE = Cf::WSTAGE;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const sx = reinterpret_cast<float*>(smem);  // the box [rows][XS]
  float* const sw = sx + XELEMS;                     // two W stages
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % Cf::WM, n0 = warp / Cf::WM * NT;  // the warp's m-tiles, first n-tile
  const int a0 = blockIdx.y * AT;
  const int64_t b = blockIdx.z;
  const float* const xb = p.x + b * p.C * p.plane;
  const float* const wt = p.wp + ((p.per_sample ? b * p.nat : 0) + blockIdx.y) * p.nch *
                                     (int64_t)(3 * WSTAGE);
  float* const yb = p.y + b * p.A * p.oplane;

  // ldmatrix: lane l addresses row l % 8 of 8 x 8 matrix l / 8 (as K2).
  const int aunit = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const uint32_t b_lane = (swz4(brow, (lane >> 3) & 1) + n0 * 8 * CT) * 4;
  uint32_t a_lane[MT];  // the lane's box row at tap (0, 0, 0), per m-tile (brick row q)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int q = wm + m * Cf::WM;
    const int row = ((q / BH) * HH + q % BH) * HW + (lane & 15);
    a_lane[m] = smem_u32(sx) + (row * XS + aunit * 4) * 4;
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

  // step s: tap group s % 3 of chunk s / 3 % nch of the block's brick
  // s / (3 nch), which is brick blockIdx.x + (s / (3 nch)) gridDim.x of the
  // sample (blockIdx.x < nb)
  const int per_brick = 3 * p.nch;
  const int steps = ((p.nb - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * per_brick;
  auto brick = [&](int s, int& d0, int& h0, int& w0) {
    const int bi = blockIdx.x + s / per_brick * gridDim.x;
    w0 = bi % p.nbw * BW;
    h0 = bi / p.nbw % p.nbh * BH;
    d0 = bi / (p.nbw * p.nbh) * BD;
  };
  Box32Stager st(p, xb, 0, tid);
  Box32Regs xr;
  {
    int d0, h0, w0;
    brick(0, d0, h0, w0);
    load_w32<WSTAGE, THREADS>(sw, wt, tid);
    cp_async_commit();
    st.load_x<VX>(xr, p, 2 * d0 - 1, 2 * h0 - 1, 2 * w0 - 1);
    st.store_x(xr, sx);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int s = 0; s < steps; ++s) {
    const int kd = s % 3;
    const bool more = s + 1 < steps;
    const bool next_x = more && kd == 2;  // step s + 1 starts a chunk
    if (more) {  // step s + 1's W by cp.async; at a chunk's end its X into registers
      const int ch = (s + 1) / 3 % p.nch;
      load_w32<WSTAGE, THREADS>(sw + ((s + 1) & 1) * WSTAGE, wt + (ch * 3 + (s + 1) % 3) *
                                (int64_t)WSTAGE, tid);
      if (next_x) {
        int d0, h0, w0;
        brick(s + 1, d0, h0, w0);
        st = Box32Stager(p, xb, ch * CT, tid);
        st.load_x<VX>(xr, p, 2 * d0 - 1, 2 * h0 - 1, 2 * w0 - 1);
      }
    }
    cp_async_commit();
    mma_group<Cf>(acc, shift(kd, BD) * HH * HW * XS * 4, smem_u32(sw + (s & 1) * WSTAGE), a_lane,
                  b_lane);
    if (kd == 2 && s / 3 % p.nch == p.nch - 1) {  // the brick's sums are complete
      int d0, h0, w0;
      brick(s, d0, h0, w0);
      // c[0..1] of an m16n8 tile: row (position) lane / 4, cols (output
      // channels) 2 (lane % 4) + {0, 1}; c[2..3]: row lane / 4 + 8.
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int q = wm + m * Cf::WM, d = d0 + q / BH, h = h0 + q % BH;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int o = a0 + (n0 + n) * 8 + (lane & 3) * 2 + (r & 1);
            const int w = w0 + (lane >> 2) + (r >> 1) * 8;
            if (o < p.A && d < p.Do && h < p.Ho && w < p.Wo)
              yb[o * p.oplane + (d * p.Ho + h) * p.Wo + w] = acc[m][n][r] + bv[n][r & 1];
            acc[m][n][r] = 0.f;
          }
      }
    }
    if (next_x) {
      __syncthreads();  // the box's reads done
      st.store_x(xr, sx);
    }
    cp_async_wait_all();
    __syncthreads();  // step s + 1 staged
  }
}

template <int AT, int VX>
cudaError_t launch(const S2Args& p, int64_t B, unsigned gx, cudaStream_t stream) {
  const auto kernel = conv3d_s2_f32_tc_kernel<AT, VX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S2<AT>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(gx, (unsigned)p.nat, (unsigned)B), THREADS, S2<AT>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int VX>
cudaError_t dispatch_tile(const S2Args& p, int64_t at, int64_t B, unsigned gx, cudaStream_t s) {
  return at == 64 ? launch<64, VX>(p, B, gx, s) : launch<32, VX>(p, B, gx, s);
}

}  // namespace

// F2's stride-2 map on the tensor cores. x [B, Cin, D, H, W] f32 (D * H * W
// < 2^31), y [B, Cout, (D-1)/2+1, (H-1)/2+1, (W-1)/2+1] f32; w [Cout, Cin,
// 27] or, with per_sample, [B, Cout, Cin, 27], and with flip the transposed
// conv's [B?, Cin, Cout, 27], used as flip_t(w); bias f32 [Cout] or null.
// The cut comes from ops/conv3d_strided.py:f2_plan: the brick (bd, bh, bw)
// = (2, 4, 16) output positions, ct = 8, at in {32, 64}, gx blocks along the
// bricks (1 <= gx <= the bricks of a sample; each block walks bricks gx
// apart). wpack holds B? * ceil(Cout / at) * ceil(Cin / 8) * 27 * 2 * at *
// 8 floats (B? = B with per_sample, else 1). Loads along W take 16 bytes
// where W % 4 == 0 and x is 16-byte aligned, else 4.
COMA_API int coma_conv3d_s2_f32_tc(const void* x, const void* w, void* wpack, const void* bias,
                                   void* y, int64_t B, int64_t Cin, int64_t Cout, int64_t D,
                                   int64_t H, int64_t W, int64_t per_sample, int64_t flip,
                                   int64_t bd, int64_t bh, int64_t bw, int64_t ct, int64_t at,
                                   int64_t gx, void* stream) {
  if (B <= 0 || B > 65535 || Cin <= 0 || Cout <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      D * H * W >= (int64_t(1) << 31) || bd != BD || bh != BH || bw != BW || ct != CT ||
      (at != 32 && at != 64) || cdiv(Cout, at) > 65535)
    return cudaErrorInvalidValue;
  S2Args p;
  p.x = static_cast<const float*>(x);
  p.wp = static_cast<const float*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
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
      pack_weights_tf32<TAPS>(static_cast<const float*>(w), static_cast<float*>(wpack), p.A, p.C,
                              (int)at, p.nat, p.nch, flip != 0, per_sample ? B : 1, s);
  if (err != cudaSuccess) return err;
  if (W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return dispatch_tile<4>(p, at, B, (unsigned)gx, s);
  return dispatch_tile<1>(p, at, B, (unsigned)gx, s);
}
