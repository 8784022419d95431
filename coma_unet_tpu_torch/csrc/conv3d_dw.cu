// KB2: weight gradient of the stride-2 k=3 convolution and, with the roles
// of its operands swapped, of the transposed stride-2 convolution:
//   M[cp, cf, t] = sum_p half[cp, p] * full[cf, 2p + t - 1],
// per sample or summed over the batch, with p over the positions of the
// half-resolution tensor (3-D), t over the 27 taps (kd major) and `full`
// read as zero outside its bounds. Both are bf16 NCDHW; M is f32
// [Cp, Cf, 27] (shared) or [B, Cp, Cf, 27] (per sample), summed in f32. For
// the stride-2 conv (half = g, full = x) M is dW; for the transposed conv
// (half = x, full = g) dW is M with its two channel axes swapped and its
// taps flipped (done by the caller on these small tensors).
//
// Replaces, from coma_unet_tpu/ops/pallas/ (rows #16 and #17 of the kernel
// table in PERF.md): conv3d_strided.py `_dw_dil_v1` (`_dw_dil_kernel`) and
// `_dw_v2` (`_dw_kernel_v2`). KB1, the stride-1 weight gradient, has its own
// tensor-core kernel (conv3d_dw_tc.cu).
//
// What bounds it on the H100: arithmetic. The reduction runs over every
// half-resolution position for an output of a few tens of thousands of
// values. This simple version runs on the CUDA cores in f32, and its
// gather's index arithmetic rivals its FMAs.
//
// Design: a GEMM out[a, n] = sum_p G[a, p] * Xcol[n, p], n = c * K^3 + t
// (G = half, X = full, S = 2, K = 3), whose long reduction axis is split
// across blocks. Block (n tile, a tile, split) takes KC consecutive
// positions of one sample and walks them KT at a time: it stages the G tile
// [KT][MT] and the gathered X tile [KT][NT] (stride-S addressing and the
// zero halo done at the gather) in shared memory as f32, and each of its
// 16 x 16 threads keeps a TM x TN tile of f32 sums, so a shared-memory read
// feeds TM or TN FMAs. Each block writes its partial sums to a workspace; a
// second launch (dw_reduce.cuh) sums the partials of each output in a fixed
// order, so results are identical from run to run (no float atomics).
// Element offsets are 64-bit.
#include "dw_reduce.cuh"

namespace {

using coma::bf16;
using coma::cdiv;

constexpr int DW_TX = 16, DW_TY = 16;  // threads along n (x) and a (y)
constexpr int DW_THREADS = DW_TX * DW_TY;
constexpr int DW_KT = 32;              // positions per shared-memory step
constexpr int DW_PAD = 4;              // row padding: 2-way bank conflicts at most

template <int N>
__device__ __forceinline__ void load_row(float* dst, const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

template <int S, int K, int TM, int TN>
__global__ void __launch_bounds__(DW_THREADS)
conv3d_dw_kernel(const bf16* __restrict__ G, const bf16* __restrict__ X, float* __restrict__ ws,
                 int64_t A, int64_t C, int64_t Pd, int64_t Ph, int64_t Pw, int64_t D, int64_t H,
                 int64_t W, int64_t kc, int64_t sps) {
  constexpr int T = K * K * K;
  constexpr int R = K / 2;
  constexpr int MT = DW_TY * TM, NT = DW_TX * TN;
  constexpr int MS = MT + DW_PAD, NS = NT + DW_PAD;  // padded row strides
  __shared__ __align__(16) float sG[DW_KT * MS];
  __shared__ __align__(16) float sX[DW_KT * NS];
  __shared__ int64_t sXoff[NT];   // channel offset of column n, -1 past N
  __shared__ int sTap[NT][3];     // (td, th, tw) - R of column n
  __shared__ int64_t sPos[DW_KT][3];  // S * (pd, ph, pw) of each position, pd < 0 past the end

  const int tid = threadIdx.x;
  const int tx = tid % DW_TX, ty = tid / DW_TX;
  const int64_t N = C * T;
  const int64_t n0 = (int64_t)blockIdx.x * NT;
  const int64_t m0 = (int64_t)blockIdx.y * MT;
  const int64_t split = blockIdx.z;
  const int64_t b = split / sps;
  const int64_t P = Pd * Ph * Pw;
  const int64_t k0 = (split % sps) * kc;
  const int64_t k1 = k0 + kc < P ? k0 + kc : P;
  const bf16* Gb = G + b * A * P;
  const bf16* Xb = X + b * C * D * H * W;

  for (int i = tid; i < NT; i += DW_THREADS) {
    const int64_t n = n0 + i;
    const int t = (int)(n % T);
    sXoff[i] = n < N ? (n / T) * D * H * W : -1;
    sTap[i][0] = t / (K * K) - R;
    sTap[i][1] = (t / K) % K - R;
    sTap[i][2] = t % K - R;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int64_t kb = k0; kb < k1; kb += DW_KT) {
    __syncthreads();  // the previous step's reads are done
    if (tid < DW_KT) {
      const int64_t p = kb + tid;
      if (p < k1) {
        sPos[tid][0] = S * (p / (Ph * Pw));
        sPos[tid][1] = S * ((p / Pw) % Ph);
        sPos[tid][2] = S * (p % Pw);
      } else {
        sPos[tid][0] = -1000000;  // every tap lands out of bounds
        sPos[tid][1] = sPos[tid][2] = 0;
      }
    }
    for (int i = tid; i < MT * DW_KT; i += DW_THREADS) {
      const int kk = i % DW_KT, mm = i / DW_KT;
      const int64_t p = kb + kk, a = m0 + mm;
      sG[kk * MS + mm] = (p < k1 && a < A) ? __bfloat162float(Gb[a * P + p]) : 0.f;
    }
    __syncthreads();  // sPos ready
    for (int i = tid; i < NT * DW_KT; i += DW_THREADS) {
      const int kk = i % DW_KT, nn = i / DW_KT;
      const int64_t off = sXoff[nn];
      const int64_t d = sPos[kk][0] + sTap[nn][0];
      const int64_t h = sPos[kk][1] + sTap[nn][1];
      const int64_t w = sPos[kk][2] + sTap[nn][2];
      float v = 0.f;
      if (off >= 0 && d >= 0 && d < D && h >= 0 && h < H && w >= 0 && w < W)
        v = __bfloat162float(Xb[off + (d * H + h) * W + w]);
      sX[kk * NS + nn] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < DW_KT; ++kk) {
      float gv[TM], xv[TN];
      load_row<TM>(gv, sG + kk * MS + ty * TM);
      load_row<TN>(xv, sX + kk * NS + tx * TN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
    }
  }

  float* out = ws + split * A * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t a = m0 + ty * TM + i;
    if (a >= A) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t n = n0 + tx * TN + j;
      if (n < N) out[a * N + n] = acc[i][j];
    }
  }
}

template <int S, int K, int TM, int TN>
cudaError_t launch_dw(const bf16* G, const bf16* X, float* ws, float* out, int64_t B, int64_t A,
                      int64_t C, int64_t Pd, int64_t Ph, int64_t Pw, int64_t D, int64_t H,
                      int64_t W, int64_t per_sample, int64_t kc, cudaStream_t stream) {
  const int64_t N = C * K * K * K;
  const int64_t sps = cdiv(Pd * Ph * Pw, kc);
  const dim3 grid((unsigned)cdiv(N, DW_TX * TN), (unsigned)cdiv(A, DW_TY * TM), (unsigned)(B * sps));
  conv3d_dw_kernel<S, K, TM, TN><<<grid, DW_THREADS, 0, stream>>>(G, X, ws, A, C, Pd, Ph, Pw, D,
                                                                  H, W, kc, sps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_reduce(ws, out, A * N, B, sps, per_sample, stream);
}

// Tile shape by the output's extent: TM a-rows and TN columns per thread.
template <int S, int K>
cudaError_t dispatch_dw(const bf16* G, const bf16* X, float* ws, float* out, int64_t B, int64_t A,
                        int64_t C, int64_t Pd, int64_t Ph, int64_t Pw, int64_t D, int64_t H,
                        int64_t W, int64_t ps, int64_t kc, cudaStream_t s) {
  const bool wide = C * K * K * K > 32;
#define COMA_DW(TM, TN) launch_dw<S, K, TM, TN>(G, X, ws, out, B, A, C, Pd, Ph, Pw, D, H, W, ps, kc, s)
  if (A > 32) return wide ? COMA_DW(4, 8) : COMA_DW(4, 2);
  if (A > 16) return wide ? COMA_DW(2, 8) : COMA_DW(2, 2);
  return wide ? COMA_DW(1, 8) : COMA_DW(1, 2);
#undef COMA_DW
}

int64_t check_dw(int64_t B, int64_t A, int64_t Pd, int64_t Ph, int64_t Pw, int64_t kc) {
  if (kc <= 0 || B <= 0 || A <= 0) return -1;
  const int64_t splits = B * cdiv(Pd * Ph * Pw, kc);
  if (splits > 65535 || cdiv(A, DW_TY) > 65535) return -1;
  return splits;
}

}  // namespace

// KB2. full [B, Cf, D, H, W], half [B, Cp, (D-1)/2+1, (H-1)/2+1, (W-1)/2+1]
// bf16; out f32 M [Cp, Cf, 27] or, with per_sample, [B, Cp, Cf, 27]; ws holds
// B * ceil(half voxels / kc) * Cp * Cf * 27 floats of scratch.
COMA_API int coma_conv3d_strided_dw(const void* full, const void* half, void* ws, void* out,
                                    int64_t B, int64_t Cf, int64_t Cp, int64_t D, int64_t H,
                                    int64_t W, int64_t per_sample, int64_t kc, void* stream) {
  const int64_t Pd = (D - 1) / 2 + 1, Ph = (H - 1) / 2 + 1, Pw = (W - 1) / 2 + 1;
  if (check_dw(B, Cp, Pd, Ph, Pw, kc) < 0) return cudaErrorInvalidValue;
  return dispatch_dw<2, 3>(static_cast<const bf16*>(half), static_cast<const bf16*>(full),
                           static_cast<float*>(ws), static_cast<float*>(out), B, Cp, Cf, Pd, Ph,
                           Pw, D, H, W, per_sample, kc, static_cast<cudaStream_t>(stream));
}
