// F1 on the tensor cores in float32: the stride-1 SAME 3-D convolution
// (k in {1, 3})
//
//   y[b, o, p] = sum_c sum_t w[(b,) o, c, t] * x[b, c, p + s_t] (+ bias[o])
//
// with s_t the offset of tap t (3-D, kd major) and x zero outside the
// volume. x [B, Cin, D, H, W] and y [B, Cout, D, H, W] are f32 NCDHW; w is
// f32 [Cout, Cin, k^3] shared or [B, Cout, Cin, k^3] per sample (the
// CondConv sites); bias (f32, may be absent) is added to the f32 sums. Every
// product is three TF32 mma.sync (tf32_common.cuh: 3xTF32), so the sums keep
// f32's accuracy (the reference's Precision.HIGHEST). The same kernel
// computes the input gradient of every stride-1 conv (ops/conv3d.py:
// conv3d_s1_dx, on the cotangent with flip_t(w), which the weight packing
// reads from w in place).
//
// Replaces, in float32, from coma_unet_tpu/ops/pallas/ (rows #1, #2, #3, #6
// and #8 of the kernel table in PERF.md): conv3d.py `_pallas_conv3d_fwd`
// (k = 3 and k = 1) and `_pallas_conv3d_fwd_htiled`, conv3d_p1.py `_p1_fwd`
// and conv3d_packed.py `_packed_fwd` with its entry `pallas_conv3d_w64`, and
// their input gradients. ops/conv3d.py:f1_plan gives the cut.
//
// What bounds it on the H100: at the wide k = 3 sites (32-128 channels)
// operations: [2,32,128^3] -> 32 takes 232 GFLOP, 1.406 ms at the 3xTF32
// rate (165 TFLOP/s), against 1.1 GB of x and y, 0.32 ms at 3.35 TB/s; at
// k = 1 and at 16 channels or fewer on either side, bytes.
//
// Design: K1's implicit GEMM per tap (csrc/conv3d_s1_tc.cu) in f32,
//   Y[p, o] += sum_{c in chunk} X[p + s_t, c] * W_t[c, o],
// on mma.sync m16n8k8 TF32, three per product: M = output positions, N =
// output channels, K = a chunk of CT = 8 input channels. A block owns AT =
// 8, 16, 32 or 64 output channels of one sample in f32 registers and walks
// the bricks of BD x BH x BW = BD x 4 x 16 output positions that f1_plan
// gives it (blockIdx.x, then gridDim.x apart; BD = 8 at k = 3 with AT = 32,
// else 4), each brick chunk by chunk of Cin and, per chunk, its taps in k
// groups of k^2 (one kd each). The whole reduction stays in the block: no
// split-K, no atomics, bit-identical results call to call. It stages in
// shared memory
//  - per chunk, the X halo brick (BD+2R)(BH+2R)(BW+2R) positions x 8
//    channels (R = k / 2), channels-last (48-byte rows), zero outside the
//    volume (the SAME padding) and past Cin, by 4-byte cp.async with zero
//    fill: a half-warp copies the 16 brick positions of one (channel, row),
//    64 contiguous bytes, and other threads its two W-halo positions; two
//    buffers, the next chunk's issued at the first group of this one;
//  - per tap group, its W tile [k^2 taps][hi, lo][AT][8] by 16-byte
//    cp.async from the copy that the weight packing (tf32_common.cuh:
//    pack_weights_tf32) splits into TF32 hi and lo planes once per call,
//    two buffers.
// X is held in shared memory as f32 once and split into hi and lo in
// registers after ldmatrix; a tap moves the lane's ldmatrix row by an
// immediate, and tap j + 1's fragments are loaded before tap j's products.
// One wait and one barrier a group. The tensor cores' f32 accumulation is
// not rounded to nearest, and its error grows with the number of mma
// summed into one register: so a tap group's products (k^2 taps x 3 mma)
// go into registers zeroed at its start, and each group's partial is added
// to the brick's running sums, kept thread-private in shared memory, by f32
// adds in step order (the last group's at the epilogue). The 8 warps are 4
// along M x 2 along N at AT = 64 (4 m-tiles x 4 n-tiles each), else 8 along
// M (AT = 32: 4 x 4, or 2 x 4 at k = 1; AT = 16: 2 x 2; AT = 8: 2 x 1).
// Shared memory at k = 3: 201,472 bytes at AT = 64, 206,080 at AT = 32
// (one block an SM), 97,024 and 79,616 at AT = 16 and 8 (two: their 4 and
// 2 m16n8 tiles a warp fit 128 registers; 8 tiles spilled there). Epilogue:
// the running sums plus the last partial plus bias go straight to y (a
// warp's store is 4 output channels x 8 consecutive positions, whole 32-byte
// sectors), masked at the volume's edge (bricks are ragged at W = 216 and
// 108). In-plane offsets are 32-bit (the entry checks D * H * W < 2^31),
// sample and channel offsets 64-bit.
#include "tf32_common.cuh"

namespace {

using namespace coma;
using namespace coma::tf32;

constexpr int BH = 4, BW = 16;  // brick of BD x BH x BW output positions; BW is one m16 tile
constexpr int WARPS = 8, THREADS = 32 * WARPS;

// K taps per axis, BD brick depth, AT output channels.
template <int K, int BD_, int AT_>
struct S1 {
  static constexpr int BD = BD_, AT = AT_;
  static constexpr int R = K / 2, TG = K * K, G = K;  // taps a group (one kd), groups
  static constexpr int HD = BD + 2 * R, HH = BH + 2 * R, HW = BW + 2 * R;
  static constexpr int HROWS = HD * HH, XELEMS = HROWS * HW * XS;  // halo (d, h) rows; floats
  static constexpr int ROWS = BD * BH;                             // brick rows (m-tiles)
  static constexpr int WN = AT >= 64 ? 2 : 1, WM = WARPS / WN;     // warps along N and M
  static constexpr int MT = ROWS / WM, NT = AT / 8 / WN;           // m- and n-tiles per warp
  static constexpr int WSTAGE = TG * 2 * AT * CT;                  // floats of a W stage
  static constexpr int SUMS = MT * NT * THREADS;  // float4s of the running sums
  static constexpr int SMEM = (2 * XELEMS + 2 * WSTAGE) * 4 + SUMS * 16;
  static constexpr int MIN_BLOCKS = MT * NT >= 8 ? 1 : 2;
  // X staging: the brick positions of (channel, row) item j = hr * 8 + c go
  // to half-warp j % 16, HROWS / 2 items each; the W-halo positions (k = 3)
  // of item j, side s, are piece 2 j + s, pieces tid + i THREADS
  static constexpr int NJ = HROWS * CT / 16;
  static constexpr int NE = R ? (2 * HROWS * CT + THREADS - 1) / THREADS : 0;
  static_assert(MT * WM == ROWS && NT * WN * 8 == AT && (HROWS * CT) % 16 == 0 &&
                    MIN_BLOCKS * SMEM <= 227 * 1024 - MIN_BLOCKS * 1024,
                "tiles");
  // the halo row offset of tap j = (kh, kw) of a group
  __host__ __device__ static constexpr int toff(int j) { return (j / K) * HW + j % K; }
};

struct S1Args {
  const float* x;
  const float* wp;    // packed weights [B?][nat][nch][k^3][2][AT][8]
  const float* bias;  // [A] or null
  float* y;
  int C, A, D, H, W;  // plane = D * H * W < 2^31: in-plane offsets are 32-bit
  int64_t plane;
  int nbh, nbw, nb;   // bricks along H and W; per sample
  int nch, nat;       // Cin chunks, Cout tiles
  int per_sample;
};

// Chunk c0 / 8 of the X halo brick of the brick at (d0, h0, w0) into sx
// [HROWS * HW][XS] by 4-byte cp.async, zero outside the volume and past C.
template <class Cf>
__device__ __forceinline__ void stage_x(float* sx, const S1Args& p, const float* xb, int c0,
                                        int d0, int h0, int w0, int tid) {
  const uint32_t base = smem_u32(sx);
  {  // brick positions: channel (tid / 16) % 8 of rows tid / 128 + 2 i
    const int c = (tid >> 4) & 7, i16 = tid & 15, w = w0 + i16;
    const bool ok = c0 + c < p.C && w < p.W;
    const float* xc = xb + (int64_t)(ok ? c0 + c : 0) * p.plane + w;
#pragma unroll
    for (int i = 0; i < Cf::NJ; ++i) {
      const int hr = (tid >> 7) + 2 * i;
      const int d = d0 - Cf::R + hr / Cf::HH, h = h0 - Cf::R + hr % Cf::HH;
      const bool in = ok && (unsigned)d < (unsigned)p.D && (unsigned)h < (unsigned)p.H;
      cp_async4(base + ((hr * Cf::HW + Cf::R + i16) * XS + c) * 4,
                in ? xc + (d * p.H + h) * p.W : xb, in);
    }
  }
  if constexpr (Cf::R > 0) {  // W-halo positions: side tid % 2, channel tid / 2 % 8
    const int side = tid & 1, c = (tid >> 1) & 7, w = side ? w0 + BW : w0 - 1;
    const bool ok = c0 + c < p.C && (unsigned)w < (unsigned)p.W;
    const float* xc = xb + (int64_t)(ok ? c0 + c : 0) * p.plane + w;
#pragma unroll
    for (int i = 0; i < Cf::NE; ++i) {
      const int hr = (tid >> 4) + 16 * i;
      if (hr < Cf::HROWS) {
        const int d = d0 - Cf::R + hr / Cf::HH, h = h0 - Cf::R + hr % Cf::HH;
        const bool in = ok && (unsigned)d < (unsigned)p.D && (unsigned)h < (unsigned)p.H;
        cp_async4(base + ((hr * Cf::HW + (side ? Cf::HW - 1 : 0)) * XS + c) * 4,
                  in ? xc + (d * p.H + h) * p.W : xb, in);
      }
    }
  }
}

// The products of one staged tap group: taps (kd, j / K, j % K), j < K^2,
// of one chunk (xk: the lane's X address at tap (kd, 0, 0) of m-tile 0, the
// m-tiles MSTEP bytes apart; sw: the group's W tile plus the lane's
// offset). Tap j + 1's fragments are loaded before tap j's products; X's
// are split into hi and lo just before their products.
template <class Cf>
__device__ __forceinline__ void mma_group(float (&acc)[Cf::MT][Cf::NT][4], uint32_t xk,
                                          uint32_t sw) {
  constexpr int MT = Cf::MT, NT = Cf::NT, AT = Cf::AT;
  // m-tile m of the warp is brick row wm + m WM: WM / BH d-planes further
  constexpr uint32_t MSTEP = (Cf::WM / BH) * Cf::HH * Cf::HW * XS * 4;
  uint32_t raw[MT][4], ahi[MT][4], alo[MT][4], bh[2][NT][2], bl[2][NT][2];
  auto load = [&](int j, uint32_t (&h)[NT][2], uint32_t (&l)[NT][2]) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      ldsm_x4(raw[m][0], raw[m][1], raw[m][2], raw[m][3],
              xk + m * MSTEP + Cf::toff(j) * XS * 4);
    load_b32<NT, AT>(h, l, sw + j * 2 * AT * CT * 4);
  };
  load(0, bh[0], bl[0]);
#pragma unroll
  for (int j = 0; j < Cf::TG; ++j) {
#pragma unroll
    for (int m = 0; m < MT; ++m) split_frag(raw[m], ahi[m], alo[m]);
    if (j + 1 < Cf::TG) load(j + 1, bh[(j + 1) & 1], bl[(j + 1) & 1]);
    mma3(acc, ahi, alo, bh[j & 1], bl[j & 1]);
  }
}

template <int K, int BD, int AT>
__global__ void __launch_bounds__(THREADS, S1<K, BD, AT>::MIN_BLOCKS)
    conv3d_s1_f32_tc_kernel(const S1Args p) {
  using Cf = S1<K, BD, AT>;
  constexpr int MT = Cf::MT, NT = Cf::NT, G = Cf::G, WSTAGE = Cf::WSTAGE;
  static_assert(Cf::WM % BH == 0, "a warp's m-tiles share their h");
  extern __shared__ __align__(16) unsigned char smem[];
  float* const sx = reinterpret_cast<float*>(smem);  // two X buffers [rows][XS]
  float* const sw = sx + 2 * Cf::XELEMS;             // two W stages
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the running sums over the brick's tap groups, thread-private: tile
  // (m, n) of thread t at [(m NT + n) THREADS + t]
  float4* const ssum = reinterpret_cast<float4*>(sw + 2 * WSTAGE) + tid;
  const int wm = warp % Cf::WM, n0 = warp / Cf::WM * NT;  // the warp's m-tiles, first n-tile
  const int a0 = blockIdx.y * AT;
  const int64_t b = blockIdx.z;
  const float* const xb = p.x + b * p.C * p.plane;
  const float* const wt = p.wp + ((p.per_sample ? b * p.nat : 0) + blockIdx.y) * p.nch *
                                     (int64_t)(G * WSTAGE);
  float* const yb = p.y + b * p.A * p.plane;

  // ldmatrix: lane l addresses row l % 8 of 8 x 8 matrix l / 8 (as K1).
  const int aunit = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const uint32_t b_lane = (swz4(brow, (lane >> 3) & 1) + n0 * 8 * CT) * 4;
  // the lane's halo row at tap (0, 0, 0) of its first m-tile, brick row wm
  const uint32_t a_off =
      ((((wm / BH) * Cf::HH + wm % BH) * Cf::HW + (lane & 15)) * XS + aunit * 4) * 4;
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

  // step s: tap group s % G of chunk u % nch, u = s / G, of the block's
  // brick u / nch, which is brick blockIdx.x + (u / nch) gridDim.x of the
  // sample (blockIdx.x < nb)
  const int steps = ((p.nb - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * p.nch * G;
  auto brick = [&](int u, int& d0, int& h0, int& w0) {
    const int bi = blockIdx.x + u / p.nch * gridDim.x;
    w0 = bi % p.nbw * BW;
    h0 = bi / p.nbw % p.nbh * BH;
    d0 = bi / (p.nbw * p.nbh) * BD;
  };
  {
    int d0, h0, w0;
    brick(0, d0, h0, w0);
    load_w32<WSTAGE, THREADS>(sw, wt, tid);
    stage_x<Cf>(sx, p, xb, 0, d0, h0, w0, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }
  for (int s = 0; s < steps; ++s) {
    const int g = s % G, u = s / G;
    if (s + 1 < steps)  // step s + 1's W
      load_w32<WSTAGE, THREADS>(sw + ((s + 1) & 1) * WSTAGE,
                                wt + ((s + 1) % (p.nch * G)) * (int64_t)WSTAGE, tid);
    if (g == 0 && (u + 1) * G < steps) {  // the next chunk's X, into the other buffer
      int d0, h0, w0;
      brick(u + 1, d0, h0, w0);
      stage_x<Cf>(sx + ((u + 1) & 1) * Cf::XELEMS, p, xb, (u + 1) % p.nch * CT, d0, h0, w0,
                  tid);
    }
    cp_async_commit();
    mma_group<Cf>(acc,
                  smem_u32(sx + (u & 1) * Cf::XELEMS) + a_off +
                      g * Cf::HH * Cf::HW * XS * 4,
                  smem_u32(sw + (s & 1) * WSTAGE) + b_lane);
    const int ch = u % p.nch;
    const bool last = g == G - 1 && ch == p.nch - 1;  // the brick's last step
    if (!last) {  // the group's partial into the running sums
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float4& t = ssum[(m * NT + n) * THREADS];
          const float4 v = ch == 0 && g == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : t;
          t = make_float4(v.x + acc[m][n][0], v.y + acc[m][n][1], v.z + acc[m][n][2],
                          v.w + acc[m][n][3]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;
        }
    } else {  // the brick's sums are complete
      int d0, h0, w0;
      brick(u, d0, h0, w0);
      // c[0..1] of an m16n8 tile: row (position) lane / 4, cols (output
      // channels) 2 (lane % 4) + {0, 1}; c[2..3]: row lane / 4 + 8.
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int q = wm + m * Cf::WM, d = d0 + q / BH, h = h0 + q % BH;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 t = p.nch * G > 1 ? ssum[(m * NT + n) * THREADS]
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
          const float sum[4] = {t.x + acc[m][n][0], t.y + acc[m][n][1], t.z + acc[m][n][2],
                                t.w + acc[m][n][3]};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int o = a0 + (n0 + n) * 8 + (lane & 3) * 2 + (r & 1);
            const int w = w0 + (lane >> 2) + (r >> 1) * 8;
            if (o < p.A && d < p.D && h < p.H && w < p.W)
              yb[o * p.plane + (d * p.H + h) * p.W + w] = sum[r] + bv[n][r & 1];
            acc[m][n][r] = 0.f;
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // step s + 1 staged; step s's reads done
  }
}

template <int K, int BD, int AT>
cudaError_t launch(const S1Args& p, int64_t B, unsigned gx, cudaStream_t stream) {
  using Cf = S1<K, BD, AT>;
  const auto kernel = conv3d_s1_f32_tc_kernel<K, BD, AT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(gx, (unsigned)p.nat, (unsigned)B), THREADS, Cf::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// The tiles ops/conv3d.py:f1_plan takes: bricks of depth 8 at k = 3,
// AT = 32, and of depth 4 otherwise.
template <int K>
cudaError_t dispatch_tile(const S1Args& p, int64_t bd, int64_t at, int64_t B, unsigned gx,
                          cudaStream_t s) {
  constexpr int BD32 = K == 3 ? 8 : 4;
#define COMA_F1(BD_, AT_) \
  if (bd == (BD_) && at == (AT_)) return launch<K, BD_, AT_>(p, B, gx, s)
  COMA_F1(4, 64);
  COMA_F1(BD32, 32);
  COMA_F1(4, 16);
  COMA_F1(4, 8);
#undef COMA_F1
  return cudaErrorInvalidValue;
}

}  // namespace

// F1 on the tensor cores. x [B, Cin, D, H, W], y [B, Cout, D, H, W] f32
// (D * H * W < 2^31); w [Cout, Cin, k^3] or, with per_sample,
// [B, Cout, Cin, k^3], and with flip the forward layer's [B?, Cin, Cout,
// k^3], used as flip_t(w); bias f32 [Cout] or null. The cut comes from
// ops/conv3d.py:f1_plan: the brick (bd, bh, bw) = (4 or 8, 4, 16), ct = 8,
// at in {8, 16, 32, 64}, gx blocks along the bricks (1 <= gx <= the bricks
// of a sample; each block walks bricks gx apart). wpack holds B? *
// ceil(Cout / at) * ceil(Cin / 8) * k^3 * 2 * at * 8 floats (B? = B with
// per_sample, else 1).
COMA_API int coma_conv3d_s1_f32_tc(const void* x, const void* w, void* wpack, const void* bias,
                                   void* y, int64_t B, int64_t Cin, int64_t Cout, int64_t D,
                                   int64_t H, int64_t W, int64_t k, int64_t per_sample,
                                   int64_t flip, int64_t bd, int64_t bh, int64_t bw, int64_t ct,
                                   int64_t at, int64_t gx, void* stream) {
  if ((k != 1 && k != 3) || (bd != 4 && bd != 8) || bh != BH || bw != BW || ct != CT ||
      (at != 8 && at != 16 && at != 32 && at != 64) || B <= 0 || B > 65535 || Cin <= 0 ||
      Cout <= 0 || D <= 0 || H <= 0 || W <= 0 || D * H * W >= (int64_t(1) << 31) ||
      cdiv(Cout, at) > 65535)
    return cudaErrorInvalidValue;
  S1Args p;
  p.x = static_cast<const float*>(x);
  p.wp = static_cast<const float*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.C = (int)Cin;
  p.A = (int)Cout;
  p.D = (int)D;
  p.H = (int)H;
  p.W = (int)W;
  p.plane = D * H * W;
  p.nbh = (int)cdiv(H, BH);
  p.nbw = (int)cdiv(W, BW);
  p.nb = (int)(cdiv(D, bd) * p.nbh * p.nbw);
  p.nch = (int)cdiv(Cin, CT);
  p.nat = (int)cdiv(Cout, at);
  p.per_sample = per_sample != 0;
  if (gx <= 0 || gx > p.nb || gx > 65535) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* wpk = static_cast<float*>(wpack);
  const int64_t nw = per_sample ? B : 1;
  const cudaError_t err =
      k == 3 ? pack_weights_tf32<27>(wf, wpk, p.A, p.C, (int)at, p.nat, p.nch, flip != 0, nw, s)
             : pack_weights_tf32<1>(wf, wpk, p.A, p.C, (int)at, p.nat, p.nch, flip != 0, nw, s);
  if (err != cudaSuccess) return err;
  if (k == 3) return dispatch_tile<3>(p, bd, at, B, (unsigned)gx, s);
  return dispatch_tile<1>(p, bd, at, B, (unsigned)gx, s);
}
