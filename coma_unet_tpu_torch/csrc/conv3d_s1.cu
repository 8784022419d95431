// K1: stride-1 SAME 3-D convolution, k in {1, 3}.
//
// x [B, Cin, D, H, W] bf16, w [Cout, Cin, k, k, k] bf16 (shared) or
// [B, Cout, Cin, k, k, k] bf16 (per sample: the CondConv expert mixture),
// optional bias [Cout] f32, y [B, Cout, D, H, W] bf16; f32 accumulation.
//
// Replaces rows #1, #2, #6 and #8 of the kernel table in PERF.md, from
// coma_unet_tpu/ops/pallas/: conv3d.py `_pallas_conv3d_fwd`
// (`_conv_kernel`, k=3, and `_conv_k1_kernel`, k=1), conv3d_p1.py `_p1_fwd`
// (`_p1_kernel`, the same function with four output D-slices stacked on the
// MXU rows) and conv3d_packed.py `_packed_fwd` (`_packed_kernel`, the same
// function on the D-pair-packed 64^3 layout, which the port does not use).
//
// What bounds it on the H100: at the 128^3 sites (Cin, Cout <= 64) a k=3
// conv does 27 * Cin multiply-adds per output for 2 * (Cin + Cout) bytes of
// traffic, so it is bound by arithmetic, not by memory. This simple version
// runs on the CUDA cores in f32, not on the tensor cores (wgmma), so its
// ceiling is the f32 FMA rate (about 1/15 of the bf16 tensor-core rate).
//
// Design: one block per (b, d, 32x32 tile of H x W, group of Q output
// channels). The input tile with its halo, for a chunk of CC input channels
// and the K neighbouring D-slices, is staged in shared memory as f32 along
// with the chunk's weights. Each thread owns one W column and P = 4
// consecutive H rows for Q output channels (P * Q f32 accumulators), so every
// input value read from shared memory feeds Q FMAs and every weight float4
// feeds 4 * P FMAs. Warps read consecutive W columns: no bank conflicts;
// weights are warp-uniform broadcasts. Element offsets are 64-bit.
#include "common.cuh"

namespace {

using coma::bf16;
using coma::cdiv;

constexpr int TX = 32;       // threads along W
constexpr int TY = 8;        // threads along H
constexpr int P = 4;         // H rows per thread
constexpr int TW = TX;       // output tile width
constexpr int TH = TY * P;   // output tile height

template <int K, int Q>
__global__ void __launch_bounds__(TX * TY)
conv3d_s1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ y,
                 int64_t Cin, int64_t Cout, int64_t D, int64_t H, int64_t W,
                 int64_t w_batch_stride) {
  constexpr int R = K / 2;
  constexpr int TAPS = K * K * K;
  constexpr int CC = K == 3 ? 2 : 8;  // input channels per shared-memory chunk
  constexpr int IR = TH + K - 1;
  constexpr int IC = TW + K - 1;
  __shared__ float s_in[CC][K][IR][IC];
  __shared__ __align__(16) float s_w[CC * TAPS * Q];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int64_t n_wt = cdiv(W, TW);
  const int64_t h0 = (blockIdx.x / n_wt) * TH;
  const int64_t w0 = (blockIdx.x % n_wt) * TW;
  const int64_t d = blockIdx.y;
  const int64_t n_co = cdiv(Cout, Q);
  const int64_t b = blockIdx.z / n_co;
  const int64_t co0 = (blockIdx.z % n_co) * Q;
  const bf16* xb = x + b * Cin * D * H * W;
  const bf16* wb = w + b * w_batch_stride;

  float acc[P][Q];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[p][q] = 0.f;

  for (int64_t c0 = 0; c0 < Cin; c0 += CC) {
    float* s_flat = &s_in[0][0][0][0];
    for (int i = tid; i < CC * K * IR * IC; i += TX * TY) {
      const int col = i % IC;
      const int r = (i / IC) % IR;
      const int kd = (i / (IC * IR)) % K;
      const int ci = i / (IC * IR * K);
      const int64_t c = c0 + ci, dd = d + kd - R, hh = h0 + r - R, ww = w0 + col - R;
      float v = 0.f;
      if (c < Cin && dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = __bfloat162float(xb[((c * D + dd) * H + hh) * W + ww]);
      s_flat[i] = v;
    }
    coma::load_weights<Q, TAPS>(s_w, wb, Cout, Cin, co0, c0, CC, tid, TX * TY);
    __syncthreads();

    const int cn = (int)(Cin - c0 < CC ? Cin - c0 : CC);
    for (int ci = 0; ci < cn; ++ci) {
#pragma unroll
      for (int kd = 0; kd < K; ++kd) {
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          float v[P + K - 1];
#pragma unroll
          for (int r = 0; r < P + K - 1; ++r) v[r] = s_in[ci][kd][ty * P + r][tx + kw];
#pragma unroll
          for (int kh = 0; kh < K; ++kh) {
            const float* wp = s_w + (ci * TAPS + (kd * K + kh) * K + kw) * Q;
#pragma unroll
            for (int p = 0; p < P; ++p) coma::fma_q<Q>(acc[p], v[p + kh], wp);
          }
        }
      }
    }
    __syncthreads();
  }

  const int64_t ww = w0 + tx;
  if (ww >= W) return;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int64_t co = co0 + q;
    if (co >= Cout) break;
    const float bv = bias ? bias[co] : 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int64_t hh = h0 + ty * P + p;
      if (hh < H) y[(((b * Cout + co) * D + d) * H + hh) * W + ww] = __float2bfloat16(acc[p][q] + bv);
    }
  }
}

template <int K, int Q>
cudaError_t launch(const bf16* x, const bf16* w, const float* bias, bf16* y, int64_t B,
                   int64_t Cin, int64_t Cout, int64_t D, int64_t H, int64_t W,
                   int64_t w_batch_stride, cudaStream_t stream) {
  const dim3 grid((unsigned)(cdiv(H, TH) * cdiv(W, TW)), (unsigned)D, (unsigned)(B * cdiv(Cout, Q)));
  conv3d_s1_kernel<K, Q><<<grid, dim3(TX, TY), 0, stream>>>(x, w, bias, y, Cin, Cout, D, H, W,
                                                           w_batch_stride);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch_q(const bf16* x, const bf16* w, const float* bias, bf16* y, int64_t B,
                       int64_t Cin, int64_t Cout, int64_t D, int64_t H, int64_t W,
                       int64_t wbs, cudaStream_t s) {
  if (Cout >= 16) return launch<K, 16>(x, w, bias, y, B, Cin, Cout, D, H, W, wbs, s);
  if (Cout >= 8) return launch<K, 8>(x, w, bias, y, B, Cin, Cout, D, H, W, wbs, s);
  return launch<K, 4>(x, w, bias, y, B, Cin, Cout, D, H, W, wbs, s);
}

}  // namespace

COMA_API const char* coma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bias may be null; per_sample != 0 means w is [B, Cout, Cin, k, k, k].
COMA_API int coma_conv3d_s1(const void* x, const void* w, const void* bias, void* y, int64_t B,
                            int64_t Cin, int64_t Cout, int64_t D, int64_t H, int64_t W,
                            int64_t k, int64_t per_sample, void* stream) {
  if ((k != 1 && k != 3) || D > 65535 || B * cdiv(Cout, 4) > 65535) return cudaErrorInvalidValue;
  const int64_t wbs = per_sample ? Cout * Cin * k * k * k : 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const bf16*>(x);
  const auto wp = static_cast<const bf16*>(w);
  const auto bp = static_cast<const float*>(bias);
  const auto yp = static_cast<bf16*>(y);
  return k == 3 ? dispatch_q<3>(xp, wp, bp, yp, B, Cin, Cout, D, H, W, wbs, s)
                : dispatch_q<1>(xp, wp, bp, yp, B, Cin, Cout, D, H, W, wbs, s);
}
