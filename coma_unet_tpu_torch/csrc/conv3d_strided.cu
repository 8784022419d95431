// K3: the transposed stride-2 3-D convolution (k=3), the adjoint of K2's
// stride-2 SAME conv (csrc/conv3d_s2_tc.cu).
//
// It takes bf16 x and w, an optional f32 bias [Cout], writes bf16 y and
// accumulates in f32. w is [Cout, Cin, 3, 3, 3] (shared) or
// [B, Cout, Cin, 3, 3, 3] (per sample: the CondConv expert mixture).
//
// K3 replaces rows #14-#15 of the kernel table in PERF.md, from
// coma_unet_tpu/ops/pallas/: conv3d_strided.py `_t2_fwd_v1` (`_t2_kernel`)
// and `_t2_fwd_v2` (`_t2_kernel_v2` + `_t2_phase_merge`). It computes the
// JAX form exactly:
// per axis out[o] = sum_k xd[o + k - 1] * w[k], where xd is x dilated by 2
// with padding (1, 2) -- torch's ConvTranspose3d(stride 2, padding 1,
// output_padding 1) with flipped, io-swapped weights. An even o = 2i takes
// only k=1 from x[i]; an odd o = 2i+1 takes k=0 from x[i] and k=2 from
// x[i+1] (x[n] reads zero). So each input position i owns the 2x2x2 output
// cube o = 2i + parity, and each of the 27 taps feeds exactly one of its 8
// parity classes: no zero-inserted input is ever formed.
//
// What bounds it on the H100: arithmetic (27/8 * Cin multiply-adds per
// output, at Cin, Cout <= 64), here on the CUDA cores in f32. The input box
// with its halo and the weights of a chunk of input channels are staged in
// shared memory as f32, and each thread keeps f32 accumulators for a group
// of Q output channels over the whole 2x2x2 output cube, so each
// shared-memory read feeds several FMAs; it writes its two W-neighbours as
// one bf16x2 store. Element offsets are 64-bit.
#include "common.cuh"

namespace {

using coma::bf16;
using coma::cdiv;

// ---------------------------------------------------------------- K3 (t2)
constexpr int T2_TX = 32, T2_TY = 8;  // threads over input (W, H) positions
constexpr int T2_CC = 8;              // input channels per shared-memory chunk
constexpr int T2_Q = 8;               // output channels per thread (8 * Q accumulators)

// Per axis, tap k of the transposed conv feeds output parity (k != 1) from
// input offset (k == 2): k=1 -> (even, x[i]); k=0 -> (odd, x[i]); k=2 -> (odd, x[i+1]).
__global__ void __launch_bounds__(T2_TX * T2_TY)
conv3d_t2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ y, int64_t Cin,
                 int64_t Cout, int64_t Di, int64_t Hi, int64_t Wi, int64_t w_batch_stride) {
  constexpr int Q = T2_Q;
  __shared__ float s_in[T2_CC][2][T2_TY + 1][T2_TX + 1];
  __shared__ __align__(16) float s_w[T2_CC * 27 * Q];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * T2_TX + tx;
  const int64_t n_wt = cdiv(Wi, T2_TX);
  const int64_t ih0 = (blockIdx.x / n_wt) * T2_TY;
  const int64_t iw0 = (blockIdx.x % n_wt) * T2_TX;
  const int64_t id = blockIdx.y;
  const int64_t n_co = cdiv(Cout, Q);
  const int64_t b = blockIdx.z / n_co;
  const int64_t co0 = (blockIdx.z % n_co) * Q;
  const bf16* xb = x + b * Cin * Di * Hi * Wi;
  const bf16* wb = w + b * w_batch_stride;

  float acc[2][2][2][Q];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[a >> 2][(a >> 1) & 1][a & 1][q] = 0.f;

  constexpr int BOX = 2 * (T2_TY + 1) * (T2_TX + 1);
  for (int64_t c0 = 0; c0 < Cin; c0 += T2_CC) {
    float* s_flat = &s_in[0][0][0][0];
    for (int i = tid; i < T2_CC * BOX; i += T2_TX * T2_TY) {
      const int col = i % (T2_TX + 1);
      const int r = (i / (T2_TX + 1)) % (T2_TY + 1);
      const int a = (i / ((T2_TX + 1) * (T2_TY + 1))) % 2;
      const int ci = i / BOX;
      const int64_t c = c0 + ci, dd = id + a, hh = ih0 + r, ww = iw0 + col;
      float v = 0.f;
      if (c < Cin && dd < Di && hh < Hi && ww < Wi)
        v = __bfloat162float(xb[((c * Di + dd) * Hi + hh) * Wi + ww]);
      s_flat[i] = v;
    }
    coma::load_weights<Q, 27>(s_w, wb, Cout, Cin, co0, c0, T2_CC, tid, T2_TX * T2_TY);
    __syncthreads();

    const int cn = (int)(Cin - c0 < T2_CC ? Cin - c0 : T2_CC);
    for (int ci = 0; ci < cn; ++ci) {
      float v[2][2][2];
#pragma unroll
      for (int a = 0; a < 8; ++a)
        v[a >> 2][(a >> 1) & 1][a & 1] = s_in[ci][a >> 2][ty + ((a >> 1) & 1)][tx + (a & 1)];
#pragma unroll
      for (int kd = 0; kd < 3; ++kd)
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            coma::fma_q<Q>(acc[kd != 1][kh != 1][kw != 1], v[kd == 2][kh == 2][kw == 2],
                           s_w + (ci * 27 + (kd * 3 + kh) * 3 + kw) * Q);
    }
    __syncthreads();
  }

  const int64_t ih = ih0 + ty, iw = iw0 + tx;
  if (ih >= Hi || iw >= Wi) return;
  const int64_t Do = 2 * Di, Ho = 2 * Hi, Wo = 2 * Wi;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int64_t co = co0 + q;
    if (co >= Cout) break;
    const float bv = bias ? bias[co] : 0.f;
#pragma unroll
    for (int pd = 0; pd < 2; ++pd)
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
        const int64_t off = (((b * Cout + co) * Do + 2 * id + pd) * Ho + 2 * ih + ph) * Wo + 2 * iw;
        *reinterpret_cast<__nv_bfloat162*>(y + off) =
            __floats2bfloat162_rn(acc[pd][ph][0][q] + bv, acc[pd][ph][1][q] + bv);
      }
  }
}

}  // namespace

// x is [B, Cin, Di, Hi, Wi]; y is [B, Cout, 2 Di, 2 Hi, 2 Wi]; bias may be null.
COMA_API int coma_conv3d_t2(const void* x, const void* w, const void* bias, void* y, int64_t B,
                            int64_t Cin, int64_t Cout, int64_t Di, int64_t Hi, int64_t Wi,
                            int64_t per_sample, void* stream) {
  if (Di > 65535 || B * cdiv(Cout, T2_Q) > 65535) return cudaErrorInvalidValue;
  const int64_t wbs = per_sample ? Cout * Cin * 27 : 0;
  const dim3 grid((unsigned)(cdiv(Hi, T2_TY) * cdiv(Wi, T2_TX)), (unsigned)Di,
                  (unsigned)(B * cdiv(Cout, T2_Q)));
  conv3d_t2_kernel<<<grid, dim3(T2_TX, T2_TY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(y), Cin, Cout, Di, Hi, Wi, wbs);
  return cudaGetLastError();
}
