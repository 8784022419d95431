// K1 on the tensor cores: the stride-1 SAME 3-D convolution (k in {1, 3})
//
//   y[b, o, p] = sum_c sum_t w[(b,) o, c, t] * x[b, c, p + s_t] (+ bias[o])
//
// with s_t the offset of tap t (3-D, kd major) and x zero outside the
// volume. x [B, Cin, D, H, W] and y [B, Cout, D, H, W] are bf16 NCDHW; w is
// bf16 [Cout, Cin, k^3] shared or [B, Cout, Cin, k^3] per sample (the
// CondConv sites); the sums are f32, bias (f32, may be absent) is added
// before the one rounding to bf16. The same kernel computes the input
// gradient of every stride-1 conv (ops/conv3d.py:conv3d_s1_dx: K1 on the
// cotangent with flipped, io-swapped weights, which the weight packing
// reads from w in place).
//
// Replaces, from coma_unet_tpu/ops/pallas/ (rows #1, #2, #3, #6 and #8 of the
// kernel table in PERF.md): conv3d.py `_pallas_conv3d_fwd` (`_conv_kernel`,
// k = 3, and `_conv_k1_kernel`, k = 1) and `_pallas_conv3d_fwd_htiled`,
// conv3d_p1.py `_p1_fwd` and conv3d_packed.py `_packed_fwd` with its entry
// `pallas_conv3d_w64`: one function on four TPU layouts, every layer of the
// model's stride-1 convs and their input gradients; ops/conv3d.py:s1_plan
// gives the cut.
//
// What bounds it on the H100: at the wide k = 3 sites (32-128 channels)
// tensor-core operations (216^3 head.conv1 is 557 GFLOP on 1.3 GB of
// operands); at 16 channels or fewer on either side, and at k = 1, bytes.
// Against the first, the products run on mma.sync and every staged X value
// serves 27 taps x AT output channels; against the second, x is read from
// device memory about once (the halo re-reads of neighbouring bricks hit
// L2), y is written once in 16-byte vectors, and the staging of chunk i+1
// overlaps the products of chunk i.
//
// Design: an implicit GEMM per tap over shared staged operands,
//   Y[p, o] += sum_{c in chunk} X[p + s_t, c] * W_t[c, o],
// on mma.sync m16n8k16 (bf16 operands, f32 sums): M = output positions,
// N = output channels, K = input channels. A block owns a brick of
// BD x BH x BW positions of one sample (BH = 4, BW = 16: one m16 tile per
// (d, h) row; BD = 8 at k = 3 with AT = 32, else 4) and AT = 8, 16, 32 or 64
// output channels, in f32 registers, and walks Cin in chunks of CT = 16
// channels (one k16 step) and, per chunk, the k^3 taps. The whole reduction
// stays in the block: no split-K, no atomics, bit-identical results from
// call to call. Per chunk it stages in shared memory
//  - the X halo brick [(BD+2)(BH+2)(BW+2) positions][16 channels],
//    channels-last, zero outside the volume (the SAME padding, done here),
//    global -> registers -> shared with KB1's staging map (tc_common.cuh).
//    For tap t the A operand is this buffer read from row position + s_t
//    with plain ldmatrix: a tap moves a row pointer, by an immediate offset.
//    Rows are padded to 3 16-byte units (odd), so the 8 rows that one
//    ldmatrix phase reads fall in distinct banks;
//  - the W tile [k^3 taps][AT][16 channels], c contiguous (mma's .col B
//    operand, read with ldmatrix), copied by 16-byte cp.async from a packed
//    copy of w: a first launch lays w (or flip_t(w), read in place) out as
//    [B?][Cout tiles][Cin chunks][k^3][AT][16], zero past Cout and Cin, so
//    a chunk's tile is one contiguous run. Its 32-byte rows swap their two
//    16-byte units when bit 2 of the row is set, which keeps ldmatrix free
//    of bank conflicts with no padding.
// Two stages (one when Cin <= 16): chunk i+1's W cp.asyncs and X loads are
// issued before chunk i's products (the loads are volatile asm) and X is
// stored after them. Each of the 8 warps owns BD / 2 m-tiles and all AT / 8
// n-tiles, so at AT = 64 (BD = 4) and AT = 32 (BD = 8) a warp loads 6
// fragments per 16 products, and it loads tap t+1's fragments before tap
// t's products. Shared memory per stage at k = 3: 31,104 bytes of X at
// BD = 4 (51,840 at BD = 8) and 864 bytes of W per output channel; the wide
// tiles take 210-224 registers and one block an SM, k = 1 two. Epilogue:
// the f32 sums plus bias are rounded to bf16 once, staged as [o][positions]
// and written along W in 16-byte vectors (8 or 2 where W does not allow
// it), masked at the volume's edge (bricks are ragged at W = 216 and 108).
// In-plane offsets are 32-bit (the entry checks D * H * W < 2^31), sample
// and channel offsets 64-bit.
#include "tc_common.cuh"

namespace {

using namespace coma;

constexpr int BH = 4, BW = 16;  // brick of BD x BH x BW positions; BW is one m16 tile
constexpr int CT = 16;          // input channels per chunk: one k16 step
constexpr int WARPS = 8, THREADS = 32 * WARPS;

// K taps per axis, BD brick depth, AT output channels, VW elements per
// vector along W.
template <int K, int BD_, int AT, int VW>
struct S1 {
  static constexpr int BD = BD_, MT = BD * BH / WARPS;  // m-tiles (brick rows) per warp
  static constexpr int R = K / 2, T = K * K * K;
  static constexpr int HD = BD + 2 * R, HH = BH + 2 * R, HW = BW + 2 * R;
  static constexpr int HROWS = HD * HH, XROWS = HROWS * HW;  // halo (d, h) rows, positions
  static constexpr int NT = AT / 8, ATILE = AT;
  // the row offset of tap t in the halo brick
  __host__ __device__ static constexpr int toff(int t) {
    return ((t / (K * K)) * HH + t / K % K) * HW + t % K;
  }
  static constexpr int XS = padded(CT);  // X row: 16 channels padded to 3 16-byte units
  static constexpr int XELEMS = XROWS * XS, WELEMS = T * AT * CT;  // bf16 per stage
  static constexpr int STAGE = XELEMS + WELEMS;
  static constexpr int YS = BD * BH * BW + 8;  // epilogue row [o][positions], padded
  static constexpr int YBYTES = AT * YS * 2;
  static constexpr int SMEM = cmax(2 * STAGE * 2, YBYTES);  // two stages, or one (Cin <= 16)
  // k = 1 holds few registers: two blocks an SM
  static constexpr int MIN_BLOCKS = K == 1 ? 2 : 1;
  // the X staging map of tc_common.cuh:XStager
  static constexpr int CTILE = CT, BWID = BW;
  static constexpr int HRSTEP = THREADS / CT, NX = (HROWS + HRSTEP - 1) / HRSTEP;
  static_assert(AT % 8 == 0 && BD * BH == MT * WARPS && 2 * STAGE * 2 <= 227 * 1024, "tiles");
};

struct S1Args {
  const bf16* x;
  const bf16* wp;     // packed weights [B?][nat][nch][T][AT][CT]
  const float* bias;  // [A] or null
  bf16* y;
  int C, A, D, H, W;  // plane = D * H * W < 2^31: in-plane offsets are 32-bit
  int64_t plane;
  int nbh, nbw, nb;   // bricks along H and W; per sample
  int nch, nat;       // Cin chunks, Cout tiles
  int per_sample;
};

// The products of one staged chunk (K1's X stage at sx, its W tile after it).
template <class Cf>
__device__ __forceinline__ void mma_chunk(float (&acc)[Cf::MT][Cf::NT][4], uint32_t sx,
                                          const int (&arow0)[Cf::MT], int aunit,
                                          uint32_t b_lane) {
  uint32_t a_lane[Cf::MT];
#pragma unroll
  for (int m = 0; m < Cf::MT; ++m) a_lane[m] = sx + (arow0[m] * Cf::XS + aunit * 8) * 2;
  mma_taps<Cf>(acc, sx + Cf::XELEMS * 2, a_lane, b_lane);
}

template <int K, int BD, int AT, int VW>
__global__ void __launch_bounds__(THREADS, S1<K, BD, AT, VW>::MIN_BLOCKS)
conv3d_s1_tc_kernel(const S1Args p) {
  using Cf = S1<K, BD, AT, VW>;
  constexpr int MT = Cf::MT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const stages = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int a0 = blockIdx.y * AT;
  const int64_t b = blockIdx.z;
  const bf16* const xb = p.x + b * p.C * p.plane;
  const bf16* const wt =
      p.wp + ((p.per_sample ? b * p.nat : 0) + blockIdx.y) * p.nch * (int64_t)Cf::WELEMS;
  bf16* const yb = p.y + b * p.A * p.plane;

  // ldmatrix: lane l addresses row l % 8 of 8 x 8 matrix l / 8. A (stored
  // [position][channel]): matrices (rows 0-7, unit 0), (8-15, 0), (0-7, 1),
  // (8-15, 1) of the m-tile; B (stored [o][channel]): (o 0-7, unit 0),
  // (0-7, 1), (8-15, 0), (8-15, 1) of two n-tiles; for x2 only lanes 0-15.
  const int aunit = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const uint32_t b_lane = swz(brow, (lane >> 3) & 1) * 2;
  int arow0[MT];  // halo row of the lane's position at tap 0, per m-tile
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int q = warp + m * WARPS;
    arow0[m] = ((q / BH) * Cf::HH + q % BH) * Cf::HW + (lane & 15);
  }
  // epilogue: this thread's output channels and their bias
  float bv[Cf::NT][2];
#pragma unroll
  for (int n = 0; n < Cf::NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int a = a0 + n * 8 + (lane & 3) * 2 + j;
      bv[n][j] = p.bias != nullptr && a < p.A ? p.bias[a] : 0.f;
    }

  for (int bi = blockIdx.x; bi < p.nb; bi += gridDim.x) {
    const int w0 = bi % p.nbw * BW, h0 = bi / p.nbw % p.nbh * BH;
    const int d0 = bi / (p.nbw * p.nbh) * BD;
    float acc[MT][Cf::NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < Cf::NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;

    XStager<Cf> st(p, xb, 0, tid);
    XRegs<Cf> xr;
    load_w<Cf::WELEMS, THREADS>(stages + Cf::XELEMS, wt, tid);
    cp_async_commit();
    st.template load_x<VW>(xr, p, d0, h0, w0);
    st.store_x(xr, stages);
    cp_async_wait_all();
    __syncthreads();
    int buf = 0;
    for (int ch = 0; ch < p.nch; ++ch) {
      bf16* const cur = stages + buf * Cf::STAGE;
      bf16* const nxt = stages + (buf ^ 1) * Cf::STAGE;
      const bool more = ch + 1 < p.nch;
      if (more) {  // chunk i+1: W by cp.async, X into registers
        load_w<Cf::WELEMS, THREADS>(nxt + Cf::XELEMS, wt + (ch + 1) * (int64_t)Cf::WELEMS, tid);
        cp_async_commit();
        st = XStager<Cf>(p, xb, (ch + 1) * CT, tid);
        st.template load_x<VW>(xr, p, d0, h0, w0);
      }
      mma_chunk<Cf>(acc, smem_u32(cur), arow0, aunit, b_lane);
      if (more) st.store_x(xr, nxt);
      cp_async_wait_all();
      __syncthreads();  // chunk i+1 staged; chunk i's reads done
      buf ^= 1;
    }

    // c[0..1] of an m16n8 tile: row (position) lane / 4, cols (output
    // channels) 2 (lane % 4) + {0, 1}; c[2..3]: row lane / 4 + 8.
    bf16* const sy = stages;  // [AT][YS]
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < Cf::NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int o = n * 8 + (lane & 3) * 2 + (r & 1);
          const int pos = (warp + m * WARPS) * BW + (lane >> 2) + (r >> 1) * 8;
          sy[o * Cf::YS + pos] = __float2bfloat16(acc[m][n][r] + bv[n][r & 1]);
        }
    __syncthreads();
    // y along W: piece i is 8 positions (w 0-7 or 8-15) of brick row q of
    // output channel o
    for (int i = tid; i < AT * BD * BH * 2; i += THREADS) {
      const int o = i / (BD * BH * 2), q = i / 2 % (BD * BH), half = i % 2;
      const int d = d0 + q / BH, h = h0 + q % BH, w = w0 + 8 * half;
      if (a0 + o < p.A && d < p.D && h < p.H && w < p.W) {
        const bf16* src = sy + o * Cf::YS + q * BW + 8 * half;
        bf16* dst = yb + (a0 + o) * p.plane + (d * p.H + h) * p.W + w;
        if constexpr (VW == 8) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else if constexpr (VW == 4) {
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
          if (w + 4 < p.W)
            *reinterpret_cast<uint2*>(dst + 4) = *reinterpret_cast<const uint2*>(src + 4);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (w + e < p.W) dst[e] = src[e];
        }
      }
    }
    __syncthreads();  // the next brick's staging reuses sy
  }
}

// wp[bw][at][ch][t][o][cc] = w[bw][a][c][t] with a = at * AT + o and
// c = ch * CT + cc, zero past Cout (A) and Cin (C); with flip, w is stored
// [bw][c][a][T - 1 - t] (flip_t of the forward layer's weights).
__global__ void __launch_bounds__(256)
s1_pack_weights(const bf16* __restrict__ w, bf16* __restrict__ wp, int A, int C, int T, int AT,
                int nat, int nch, int flip, int64_t total) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int cc = (int)(e % CT), o = (int)(e / CT % AT), t = (int)(e / (CT * AT) % T);
    const int64_t r = e / ((int64_t)CT * AT * T);
    const int ch = (int)(r % nch), at = (int)(r / nch % nat);
    const int64_t bw = r / ((int64_t)nch * nat);
    const int a = at * AT + o, c = ch * CT + cc;
    const int64_t src = flip ? ((bw * C + c) * A + a) * T + (T - 1 - t)
                             : ((bw * A + a) * C + c) * T + t;
    wp[e] = a < A && c < C ? w[src] : __float2bfloat16(0.f);
  }
}

template <int K, int BD, int AT, int VW>
cudaError_t launch_tc(const S1Args& p, int64_t B, unsigned gx, cudaStream_t stream) {
  using Cf = S1<K, BD, AT, VW>;
  const auto kernel = conv3d_s1_tc_kernel<K, BD, AT, VW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return err;
  // one chunk (Cin <= 16) needs one stage: more blocks fit on an SM
  const int smem = p.nch > 1 ? Cf::SMEM : cmax(Cf::STAGE * 2, Cf::YBYTES);
  kernel<<<dim3(gx, (unsigned)p.nat, (unsigned)B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The tiles ops/conv3d.py:s1_plan takes: bricks of depth 8 at k = 3,
// AT = 32, and of depth 4 otherwise.
template <int K, int VW>
cudaError_t dispatch_tile(const S1Args& p, int64_t bd, int64_t at, int64_t B, unsigned gx,
                          cudaStream_t s) {
  constexpr int BD32 = K == 3 ? 8 : 4;
#define COMA_S1(BD_, AT_) \
  if (bd == (BD_) && at == (AT_)) return launch_tc<K, BD_, AT_, VW>(p, B, gx, s)
  COMA_S1(4, 64);
  COMA_S1(BD32, 32);
  COMA_S1(4, 16);
  COMA_S1(4, 8);
#undef COMA_S1
  return cudaErrorInvalidValue;
}

template <int K>
cudaError_t dispatch_vw(const S1Args& p, int vw, int64_t bd, int64_t at, int64_t B,
                        unsigned gx, cudaStream_t s) {
  if (vw == 8) return dispatch_tile<K, 8>(p, bd, at, B, gx, s);
  if (vw == 4) return dispatch_tile<K, 4>(p, bd, at, B, gx, s);
  return dispatch_tile<K, 1>(p, bd, at, B, gx, s);
}

}  // namespace

cudaError_t coma::pack_weights(const bf16* w, bf16* wp, int A, int C, int T, int AT, int nat,
                               int nch, bool flip, int64_t nw, cudaStream_t stream) {
  const int64_t total = nw * nat * nch * (int64_t)T * AT * CT;
  const int64_t blocks = cdiv(total, 256) < 4096 ? cdiv(total, 256) : 4096;
  s1_pack_weights<<<(unsigned)blocks, 256, 0, stream>>>(w, wp, A, C, T, AT, nat, nch, flip,
                                                        total);
  return cudaGetLastError();
}

COMA_API const char* coma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1 on the tensor cores. x [B, Cin, D, H, W], y [B, Cout, D, H, W] bf16
// (D * H * W < 2^31); w [Cout, Cin, k^3] or, with per_sample,
// [B, Cout, Cin, k^3], and with flip the forward layer's [B?, Cin, Cout,
// k^3], used as flip_t(w); bias f32 [Cout] or null. The cut comes from
// ops/conv3d.py:s1_plan: the brick (bd, bh, bw) = (4 or 8, 4, 16), ct = 16,
// at in {8, 16, 32, 64}, gx blocks along the bricks (each block walks
// bricks gx apart). wpack holds B? * ceil(Cout / at) * ceil(Cin / 16) *
// k^3 * at * 16 bf16 (B? = B with per_sample, else 1). Loads and stores
// along W take 16 or 8 bytes where W and the pointers allow it, else 2.
COMA_API int coma_conv3d_s1_tc(const void* x, const void* w, void* wpack, const void* bias,
                               void* y, int64_t B, int64_t Cin, int64_t Cout, int64_t D,
                               int64_t H, int64_t W, int64_t k, int64_t per_sample,
                               int64_t flip, int64_t bd, int64_t bh, int64_t bw, int64_t ct,
                               int64_t at, int64_t gx, void* stream) {
  if ((bd != 4 && bd != 8) || bh != BH || bw != BW || ct != CT || (k != 1 && k != 3) || B <= 0 ||
      B > 65535 || Cin <= 0 || Cout <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      D * H * W >= (int64_t(1) << 31) || gx <= 0 || gx > 65535 || cdiv(Cout, at) > 65535 ||
      (at != 8 && at != 16 && at != 32 && at != 64))
    return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  const int vw = W % 8 == 0 && align % 16 == 0 ? 8 : W % 4 == 0 && align % 8 == 0 ? 4 : 1;
  const auto s = static_cast<cudaStream_t>(stream);
  S1Args p;
  p.x = static_cast<const bf16*>(x);
  p.wp = static_cast<const bf16*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<bf16*>(y);
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
  const cudaError_t err =
      pack_weights(static_cast<const bf16*>(w), static_cast<bf16*>(wpack), p.A, p.C,
                   (int)(k * k * k), (int)at, p.nat, p.nch, flip != 0, per_sample ? B : 1, s);
  if (err != cudaSuccess) return err;
  if (k == 3) return dispatch_vw<3>(p, vw, bd, at, B, (unsigned)gx, s);
  return dispatch_vw<1>(p, vw, bd, at, B, (unsigned)gx, s);
}
