// F1: the float32 form of K1, on the CUDA cores. One kernel template
// computes the stride-1 SAME conv, k in {1, 3}, a sum in f32 over the input
// channels c and the taps t = (td, th, tw) of w[(b,) o, c, t]:
//     y[b, o, q] = sum_{c,t} w[o, c, t] * x[b, c, q + t - k / 2]
// (+ bias[o], f32, may be absent), with x zero outside the volume. x, y are
// f32 NCDHW, w f32 [Cout, Cin, k^3] shared or [B, Cout, Cin, k^3] per sample
// (the CondConv sites). With flip, w is the forward layer's [B?, Cin, Cout,
// k^3] read as flip_t(w)[o, c, t] = w[c, o, k^3 - 1 - t]: the input
// gradient (ops/conv3d.py:conv3d_s1_dx). F2, the stride-2 and transposed
// convs in float32, runs on the tensor cores (conv3d_s2_f32_tc.cu,
// conv3d_t2_f32_tc.cu).
//
// Replaces, in float32, from coma_unet_tpu/ops/pallas/ (the kernel table in
// PERF.md): conv3d.py `_pallas_conv3d_fwd` and `_pallas_conv3d_fwd_htiled`,
// conv3d_p1.py `_p1_fwd`, conv3d_packed.py `_packed_fwd` / `pallas_conv3d_w64`
// (rows #1, #2, #3, #6, #8). The TPU kernels switch to Precision.HIGHEST for
// f32: every product here is an f32 FMA, no TF32.
//
// What bounds it on the H100: at the wide sites f32 operations (on the CUDA
// cores: 67 TFLOP/s), at 16 channels or fewer on either side bytes. Design:
// a block of 256 threads owns a tile of 4 x 8 x 32 output positions and Q
// output channels (1, 4, 8 or 16; ops/conv3d.py:f1_plan picks the smallest
// that holds the layer, wider layers take tiles), in registers: a thread
// owns 4 consecutive positions along W x Q channels. The block walks Cin in
// stages of CI channels; per stage it copies the input box of its tile
// (zero outside the volume: the padding, done here) and the stage's weights
// [c][t][Q] into shared memory by 4-byte cp.async, two stages in flight, so
// that stage i+1 lands while stage i is summed. Per channel and (td, th) a
// thread loads the box row its positions need once (4 + k - 1 values) and
// uses it for every tw and every one of its Q channels (4 k Q FMAs; the Q
// weights of a tap are float4 broadcasts). Every output is one thread's
// ordered sum: no split-K, no atomics, the same bits from call to call.
// Element offsets are 64-bit.
#include "f32_common.cuh"

namespace {

using coma::cdiv;
using namespace coma::f32;

constexpr int THREADS = 256;
constexpr int VW = 4;                 // consecutive positions along W a thread owns
constexpr int TD = 4, TH = 8, TW = 8 * VW;  // the block's tile of output positions
constexpr int MAX_SMEM = 227 * 1024;

// The staged box of one input channel and the stage's sizes.
template <int K>
struct Geo {
  static constexpr int BD = TD + K - 1, BH = TH + K - 1, BW = TW + K - 1;
  static constexpr int ROW = BW | 1;  // odd: a warp's 4 rows fall in distinct banks
  static constexpr int CI = K == 1 ? 8 : 4;
  static constexpr int TAPS = K * K * K;
  static constexpr int XBOX = BD * BH * ROW;
  static constexpr int XS = round4(CI * XBOX);
  template <int Q>
  __host__ __device__ static constexpr int stage() { return XS + round4(CI * TAPS * Q); }
  template <int Q>
  __host__ __device__ static constexpr int smem() { return 2 * 4 * stage<Q>(); }
};

struct FArgs {
  const float* x;
  const float* w;
  const float* bias;   // [Cout] or null
  float* y;
  int64_t Cin, Cout;
  int D, H, W;
  int tiles_h, tiles_w;
  int64_t wb, wo, wc;  // weight strides: sample (0 if shared), output and input channel
  int flip;
  int vec;             // output rows take float4 stores
};

// acc[q][i] += xv[i] * wt[q] for the Q weights of one tap.
template <int Q>
__device__ __forceinline__ void fma_tap(float (&acc)[Q][VW], const float* __restrict__ wt,
                                        const float (&xv)[VW]) {
  if constexpr (Q % 4 == 0) {
#pragma unroll
    for (int q4 = 0; q4 < Q / 4; ++q4) {
      const float4 w4 = reinterpret_cast<const float4*>(wt)[q4];
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[4 * q4 + j][i] = fmaf(xv[i], wv[j], acc[4 * q4 + j][i]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float wv = wt[q];
#pragma unroll
      for (int i = 0; i < VW; ++i) acc[q][i] = fmaf(xv[i], wv, acc[q][i]);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* __restrict__ p) {
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = p[j];
}

template <int OFF, int N>
__device__ __forceinline__ void window(float (&out)[VW], const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < VW; ++i) out[i] = v[i + OFF];
}

// One input channel's contribution: xc its box, wc its weights [t][Q].
template <int K, int Q>
__device__ __forceinline__ void channel(float (&acc)[Q][VW], const float* __restrict__ xc,
                                        const float* __restrict__ wc, int dz, int hy, int wq) {
  using G = Geo<K>;
  float xt[VW];
#pragma unroll
  for (int kd = 0; kd < K; ++kd)
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      float xv[VW + K - 1];
      load_row(xv, xc + ((dz + kd) * G::BH + hy + kh) * G::ROW + VW * wq);
      const float* wt = wc + (kd * K + kh) * K * Q;
      window<0>(xt, xv);
      fma_tap<Q>(acc, wt, xt);
      if constexpr (K == 3) {
        window<1>(xt, xv);
        fma_tap<Q>(acc, wt + Q, xt);
        window<2>(xt, xv);
        fma_tap<Q>(acc, wt + 2 * Q, xt);
      }
    }
}

template <int K, int Q>
__global__ void __launch_bounds__(THREADS) conv3d_f32_kernel(const FArgs a) {
  using G = Geo<K>;
  extern __shared__ __align__(16) float smem[];
  constexpr int STAGE = G::template stage<Q>();
  const int tid = threadIdx.x;
  const int wq = tid % 8, hy = (tid / 8) % TH, dz = tid / (8 * TH);
  int64_t tile = blockIdx.x;
  const int tw = (int)(tile % a.tiles_w);
  tile /= a.tiles_w;
  const int th = (int)(tile % a.tiles_h);
  const int td = (int)(tile / a.tiles_h);
  const int gd0 = td * TD, gh0 = th * TH, gw0 = tw * TW;
  const int o0 = blockIdx.y * Q;
  const int b = blockIdx.z;
  // the box's origin in the input
  const int xd0 = gd0 - K / 2, xh0 = gh0 - K / 2, xw0 = gw0 - K / 2;
  const float* const xb = a.x + (int64_t)b * a.Cin * a.D * a.H * a.W;
  const float* const wb = a.w + b * a.wb;

  const auto stage = [&](int chunk, int buf) {
    float* const xs = smem + buf * STAGE;
    float* const ws = xs + G::XS;
    const int64_t c0 = (int64_t)chunk * G::CI;
    stage_box<G::BD, G::BH, G::BW, G::ROW, false>(xs, G::XBOX, xb, a.Cin, a.D, a.H, a.W, c0,
                                                  G::CI, xd0, xh0, xw0, tid, THREADS);
    for (int e = tid; e < G::CI * G::TAPS * Q; e += THREADS) {
      const int q = e % Q, t = (e / Q) % G::TAPS, c = e / (Q * G::TAPS);
      const int64_t o = o0 + q, ci = c0 + c;
      const bool ok = o < a.Cout && ci < a.Cin;
      const float* s = ok ? wb + o * a.wo + ci * a.wc + (a.flip ? G::TAPS - 1 - t : t) : a.w;
      cp_async4(ws + e, s, ok);
    }
    cp_async_commit();
  };

  float acc[Q][VW];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int i = 0; i < VW; ++i) acc[q][i] = 0.f;

  const int chunks = (int)cdiv(a.Cin, G::CI);
  stage(0, 0);
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      stage(k + 1, (k + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* const xs = smem + (k & 1) * STAGE;
    const float* const ws = xs + G::XS;
    const int64_t left = a.Cin - (int64_t)k * G::CI;
    const int nc = left < G::CI ? (int)left : G::CI;
    for (int c = 0; c < nc; ++c)
      channel<K, Q>(acc, xs + c * G::XBOX, ws + c * G::TAPS * Q, dz, hy, wq);
    __syncthreads();
  }

  // epilogue: bias, then each thread's 4 positions of each of its channels
  const int gd = gd0 + dz, gh = gh0 + hy, gw = gw0 + VW * wq;
  if (gd >= a.D || gh >= a.H) return;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int64_t o = o0 + q;
    if (o >= a.Cout) break;
    const float bv = a.bias ? a.bias[o] : 0.f;
    float* const yr = a.y + (((b * a.Cout + o) * a.D + gd) * (int64_t)a.H + gh) * a.W;
    if (a.vec && gw + VW <= a.W) {
      *reinterpret_cast<float4*>(yr + gw) =
          make_float4(acc[q][0] + bv, acc[q][1] + bv, acc[q][2] + bv, acc[q][3] + bv);
      continue;
    }
#pragma unroll
    for (int i = 0; i < VW; ++i)
      if (gw + i < a.W) yr[gw + i] = acc[q][i] + bv;
  }
}

template <int K, int Q>
cudaError_t launch(const FArgs& a, dim3 grid, cudaStream_t stream) {
  constexpr int smem = Geo<K>::template smem<Q>();
  static_assert(smem <= MAX_SMEM, "a stage pair must fit a CTA");
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3d_f32_kernel<K, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  conv3d_f32_kernel<K, Q><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_q(const FArgs& a, int64_t q, dim3 grid, cudaStream_t stream) {
  switch (q) {
    case 1: return launch<K, 1>(a, grid, stream);
    case 4: return launch<K, 4>(a, grid, stream);
    case 8: return launch<K, 8>(a, grid, stream);
    default: return launch<K, 16>(a, grid, stream);
  }
}

template <int K>
int64_t smem_of(int64_t q) {
  using G = Geo<K>;
  switch (q) {
    case 1: return G::template smem<1>();
    case 4: return G::template smem<4>();
    case 8: return G::template smem<8>();
    default: return G::template smem<16>();
  }
}

}  // namespace

// F1 in f32, k in {1, 3}. x [B, Cin, D, H, W], y [B, Cout, D, H, W]; w [B?,
// Cout, Cin, k^3] (B? = B with per_sample), or with flip the forward
// layer's [B?, Cin, Cout, k^3] read as flip_t(w); bias f32 [Cout] or null.
// The cut comes from ops/conv3d.py:f1_plan: the tile (td, th, tw) = (4, 8,
// 32) of the output, ci input channels a stage (8 at k = 1, else 4), q in
// {1, 4, 8, 16} output channels a block, smem the bytes of two stages; the
// grid is (tiles, ceil(Cout / q), B).
COMA_API int coma_conv3d_f32(const void* x, const void* w, const void* bias, void* y, int64_t B,
                             int64_t Cin, int64_t Cout, int64_t D, int64_t H, int64_t W,
                             int64_t k, int64_t per_sample, int64_t flip, int64_t td, int64_t th,
                             int64_t tw, int64_t ci, int64_t q, int64_t smem, void* stream) {
  if ((k != 1 && k != 3) || B <= 0 || Cin <= 0 || Cout <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      D * H * W >= (int64_t(1) << 31) || td != TD || th != TH || tw != TW ||
      (q != 1 && q != 4 && q != 8 && q != 16))
    return cudaErrorInvalidValue;
  const int64_t want_ci = k == 1 ? 8 : 4;
  const int64_t want_smem = k == 1 ? smem_of<1>(q) : smem_of<3>(q);
  if (ci != want_ci || smem != want_smem) return cudaErrorInvalidValue;
  FArgs a{};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<float*>(y);
  a.Cin = Cin;
  a.Cout = Cout;
  a.D = (int)D;
  a.H = (int)H;
  a.W = (int)W;
  a.tiles_h = (int)cdiv(a.H, TH);
  a.tiles_w = (int)cdiv(a.W, TW);
  const int64_t tiles = cdiv(a.D, TD) * a.tiles_h * a.tiles_w;
  const int64_t taps = k * k * k;
  a.wb = per_sample ? Cout * Cin * taps : 0;
  a.wo = flip ? taps : Cin * taps;
  a.wc = flip ? Cout * taps : taps;
  a.flip = (int)(flip != 0);
  a.vec = a.W % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (tiles > 0x7fffffff || cdiv(Cout, q) > 65535 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)cdiv(Cout, q), (unsigned)B);
  const auto s = static_cast<cudaStream_t>(stream);
  return k == 1 ? launch_q<1>(a, q, grid, s) : launch_q<3>(a, q, grid, s);
}
