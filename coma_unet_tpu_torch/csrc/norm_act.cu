// K4: instance norm + FiLM + activation, forward.
//
// x [B, C, D, H, W] bf16 is taken as B*C rows of N = D*H*W voxels. Per row
// (b, c): mean and variance in f32 (eps inside the rsqrt), then
//   u = scale[b, c] * (x - mean) * rsqrt(var + eps) + shift[b, c]
//   y = act(u)   act: 0 none, 1 relu, 2 leakyrelu (slope 0.01), 3 prelu (alpha[0])
// computed in f32 and stored as bf16. scale, shift and alpha are device
// pointers and may be null (identity FiLM; alpha is read only for prelu).
//
// Replaces row #18 of the kernel table in PERF.md (its forward half):
// coma_unet_tpu/ops/pallas/norm_act.py `_norm_act_fwd_impl`
// (`_stats_kernel` then `_apply_kernel`). The TPU kernel carries one running
// sum per (b, c) across its sequential grid and takes var = E[x^2] - mean^2,
// which cancels badly in f32 over a 2M-voxel row whose mean is large against
// its spread. Here blocks run in parallel, so the reduction is split:
//   1. stats:    one block per (row, chunk of CHUNK voxels) sums x - s and
//                (x - s)^2 with s the row's first voxel (a shift that keeps
//                the sums small) and stores the chunk's (count, mean, M2);
//   2. finalize: one thread per row merges its chunks with Chan's pairwise
//                formula in f64 and stores (mean, rstd);
//   3. apply:    one block per (row, chunk) normalizes, applies FiLM and the
//                activation, and stores bf16.
//
// The forward leaves its per-row (mean, rstd) in `stats` for the backward.
//
// KB3: the backward of the same function, with the stats of the forward.
// With yhat = (x - mean) * rstd, u = scale * yhat + shift, gt = g * act'(u)
// and gy = gt * scale, per row:
//   dx     = rstd * (gy - sum(gy) / N - yhat * sum(gy * yhat) / N)
//   dscale = sum(gt * yhat),  dshift = sum(gt),
//   dalpha = sum over all rows of sum(g * min(u, 0))   (prelu's one slope)
// act' is 1[u > 0] for relu, but 1 or 0.01 / alpha split at u >= 0 for
// leakyrelu / prelu, as in the JAX package. Replaces row #19:
// norm_act.py `_norm_act_bwd_impl` (`_bwd_reduce_kernel` then
// `_bwd_apply_kernel`). Passes:
//   1. bwd reduce:   one block per (row, chunk) stores the chunk's five f32
//                    sums (sum gy, gy*yhat, g*min(u,0), gt*yhat, gt);
//   2. bwd finalize: one thread per row adds its chunks in order in f64;
//                    then one thread adds the rows' prelu sums in order;
//   3. bwd apply:    one block per (row, chunk) stores dx in x's dtype.
// Fixed orders throughout: the result is the same from run to run.
//
// What bounds them on the H100: memory. The forward reads x twice and writes
// y once (6 bytes per voxel), the backward reads x and g twice and writes dx
// once (10 bytes per voxel), with a few flops per voxel; rows of 2M voxels
// give thousands of blocks. Threads move 8 bf16 (16 bytes) per load and
// store when N % 8 == 0, else one voxel at a time. Element offsets are
// 64-bit.
#include "common.cuh"

namespace {

using coma::bf16;
using coma::cdiv;

constexpr int THREADS = 256;

__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[THREADS / 32], sb[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < THREADS / 32 ? sa[lane] : 0.f;
    b = lane < THREADS / 32 ? sb[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
norm_stats_kernel(const bf16* __restrict__ x, float* __restrict__ part, int64_t N,
                  int64_t chunk, int vec) {
  const int64_t row = blockIdx.y, nchunk = gridDim.x;
  const bf16* xr = x + row * N;
  const float s = __bfloat162float(xr[0]);
  const int64_t start = blockIdx.x * chunk;
  const int64_t end = start + chunk < N ? start + chunk : N;
  float s1 = 0.f, s2 = 0.f;
  if (vec) {
    for (int64_t i = start + 8 * threadIdx.x; i < end; i += 8 * THREADS) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = __bfloat162float(v[j]) - s;
        s1 += t;
        s2 = fmaf(t, t, s2);
      }
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += THREADS) {
      const float t = __bfloat162float(xr[i]) - s;
      s1 += t;
      s2 = fmaf(t, t, s2);
    }
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    const float n = (float)(end - start);
    float* p = part + (row * nchunk + blockIdx.x) * 3;
    p[0] = n;
    p[1] = s + s1 / n;
    p[2] = fmaxf(s2 - s1 * (s1 / n), 0.f);
  }
}

__global__ void norm_finalize_kernel(const float* __restrict__ part, float* __restrict__ stats,
                                     int64_t rows, int64_t nchunk, float eps) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (int64_t c = 0; c < nchunk; ++c) {
    const float* p = part + (row * nchunk + c) * 3;
    const double nb = p[0], mb = p[1], m2b = p[2];
    const double nn = n + nb, delta = mb - mean;
    mean += delta * nb / nn;
    m2 += m2b + delta * delta * n * nb / nn;
    n = nn;
  }
  stats[2 * row] = (float)mean;
  stats[2 * row + 1] = rsqrtf((float)(m2 / n) + eps);
}

__device__ __forceinline__ float activate(float u, int act, float alpha) {
  switch (act) {
    case 1: return fmaxf(u, 0.f);
    case 2: return u >= 0.f ? u : 0.01f * u;
    case 3: return u >= 0.f ? u : alpha * u;
    default: return u;
  }
}

__global__ void __launch_bounds__(THREADS)
norm_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ stats,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  const float* __restrict__ alpha, bf16* __restrict__ y, int64_t N,
                  int64_t chunk, int act, int vec) {
  const int64_t row = blockIdx.y;
  const float mean = stats[2 * row], rstd = stats[2 * row + 1];
  const float sc = scale ? scale[row] : 1.f;
  const float sh = shift ? shift[row] : 0.f;
  const float a = (act == 3 && alpha) ? alpha[0] : 0.f;
  const bf16* xr = x + row * N;
  bf16* yr = y + row * N;
  const int64_t start = blockIdx.x * chunk;
  const int64_t end = start + chunk < N ? start + chunk : N;
  if (vec) {
    for (int64_t i = start + 8 * threadIdx.x; i < end; i += 8 * THREADS) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
      uint4 out;
      bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float u = sc * ((__bfloat162float(v[j]) - mean) * rstd) + sh;
        o[j] = __float2bfloat16(activate(u, act, a));
      }
      *reinterpret_cast<uint4*>(yr + i) = out;
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += THREADS) {
      const float u = sc * ((__bfloat162float(xr[i]) - mean) * rstd) + sh;
      yr[i] = __float2bfloat16(activate(u, act, a));
    }
  }
}

// ------------------------------------------------------------------ KB3
__device__ __forceinline__ float act_deriv(float u, int act, float alpha) {
  switch (act) {
    case 1: return u > 0.f ? 1.f : 0.f;
    case 2: return u >= 0.f ? 1.f : 0.01f;
    case 3: return u >= 0.f ? 1.f : alpha;
    default: return 1.f;
  }
}

struct RowParams {
  float mean, rstd, sc, sh, a;
};

__device__ __forceinline__ RowParams row_params(const float* stats, const float* scale,
                                                const float* shift, const float* alpha,
                                                int64_t row, int act) {
  return {stats[2 * row], stats[2 * row + 1], scale ? scale[row] : 1.f,
          shift ? shift[row] : 0.f, (act == 3 && alpha) ? alpha[0] : 0.f};
}

constexpr int NSUM = 5;

__device__ __forceinline__ void bwd_accumulate(float xv, float gv, const RowParams& rp, int act,
                                               float* s) {
  const float yhat = (xv - rp.mean) * rp.rstd;
  const float u = rp.sc * yhat + rp.sh;
  const float gt = gv * act_deriv(u, act, rp.a);
  const float gy = gt * rp.sc;
  s[0] += gy;
  s[1] = fmaf(gy, yhat, s[1]);
  s[2] = fmaf(gv, fminf(u, 0.f), s[2]);
  s[3] = fmaf(gt, yhat, s[3]);
  s[4] += gt;
}

__global__ void __launch_bounds__(THREADS)
norm_bwd_reduce_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                       const float* __restrict__ stats, const float* __restrict__ scale,
                       const float* __restrict__ shift, const float* __restrict__ alpha,
                       float* __restrict__ part, int64_t N, int64_t chunk, int act, int vec) {
  __shared__ float red[NSUM][THREADS / 32];
  const int64_t row = blockIdx.y, nchunk = gridDim.x;
  const RowParams rp = row_params(stats, scale, shift, alpha, row, act);
  const bf16* xr = x + row * N;
  const bf16* gr = g + row * N;
  const int64_t start = blockIdx.x * chunk;
  const int64_t end = start + chunk < N ? start + chunk : N;
  float s[NSUM] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (vec) {
    for (int64_t i = start + 8 * threadIdx.x; i < end; i += 8 * THREADS) {
      const uint4 xraw = *reinterpret_cast<const uint4*>(xr + i);
      const uint4 graw = *reinterpret_cast<const uint4*>(gr + i);
      const bf16* xv = reinterpret_cast<const bf16*>(&xraw);
      const bf16* gv = reinterpret_cast<const bf16*>(&graw);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bwd_accumulate(__bfloat162float(xv[j]), __bfloat162float(gv[j]), rp, act, s);
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += THREADS)
      bwd_accumulate(__bfloat162float(xr[i]), __bfloat162float(gr[i]), rp, act, s);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < NSUM; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
    if (lane == 0) red[j][warp] = s[j];
  }
  __syncthreads();
  if (threadIdx.x < NSUM) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += red[threadIdx.x][w];
    part[(row * nchunk + blockIdx.x) * NSUM + threadIdx.x] = t;
  }
}

__global__ void norm_bwd_finalize_kernel(const float* __restrict__ part, float* __restrict__ sums,
                                         int64_t rows, int64_t nchunk) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  double s[NSUM] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int64_t c = 0; c < nchunk; ++c)
#pragma unroll
    for (int j = 0; j < NSUM; ++j) s[j] += part[(row * nchunk + c) * NSUM + j];
#pragma unroll
  for (int j = 0; j < NSUM; ++j) sums[row * NSUM + j] = (float)s[j];
}

__global__ void norm_bwd_alpha_kernel(const float* __restrict__ sums, float* __restrict__ dalpha,
                                      int64_t rows) {
  double s = 0.0;
  for (int64_t r = 0; r < rows; ++r) s += sums[r * NSUM + 2];
  dalpha[0] = (float)s;
}

__device__ __forceinline__ float bwd_dx(float xv, float gv, const RowParams& rp, int act,
                                        float m0, float m1) {
  const float yhat = (xv - rp.mean) * rp.rstd;
  const float u = rp.sc * yhat + rp.sh;
  const float gy = gv * act_deriv(u, act, rp.a) * rp.sc;
  return rp.rstd * (gy - m0 - yhat * m1);
}

__global__ void __launch_bounds__(THREADS)
norm_bwd_apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                      const float* __restrict__ stats, const float* __restrict__ scale,
                      const float* __restrict__ shift, const float* __restrict__ alpha,
                      const float* __restrict__ sums, bf16* __restrict__ dx, int64_t N,
                      int64_t chunk, int act, int vec) {
  const int64_t row = blockIdx.y;
  const RowParams rp = row_params(stats, scale, shift, alpha, row, act);
  const float m0 = sums[row * NSUM] / (float)N, m1 = sums[row * NSUM + 1] / (float)N;
  const bf16* xr = x + row * N;
  const bf16* gr = g + row * N;
  bf16* dr = dx + row * N;
  const int64_t start = blockIdx.x * chunk;
  const int64_t end = start + chunk < N ? start + chunk : N;
  if (vec) {
    for (int64_t i = start + 8 * threadIdx.x; i < end; i += 8 * THREADS) {
      const uint4 xraw = *reinterpret_cast<const uint4*>(xr + i);
      const uint4 graw = *reinterpret_cast<const uint4*>(gr + i);
      const bf16* xv = reinterpret_cast<const bf16*>(&xraw);
      const bf16* gv = reinterpret_cast<const bf16*>(&graw);
      uint4 out;
      bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = __float2bfloat16(
            bwd_dx(__bfloat162float(xv[j]), __bfloat162float(gv[j]), rp, act, m0, m1));
      *reinterpret_cast<uint4*>(dr + i) = out;
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += THREADS)
      dr[i] = __float2bfloat16(
          bwd_dx(__bfloat162float(xr[i]), __bfloat162float(gr[i]), rp, act, m0, m1));
  }
}

}  // namespace

// part holds rows * ceil(N / chunk) * 3 floats of scratch; stats receives
// rows * 2 floats (mean, rstd); chunk must be a multiple of 8.
COMA_API int coma_norm_act(const void* x, const void* scale, const void* shift,
                           const void* alpha, void* y, void* part, void* stats, int64_t rows,
                           int64_t N, int64_t chunk, int64_t act, float eps, void* stream) {
  if (rows > 65535 || chunk % 8 != 0 || act < 0 || act > 3) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t nchunk = cdiv(N, chunk);
  const int vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((unsigned)nchunk, (unsigned)rows);
  const auto xp = static_cast<const bf16*>(x);
  norm_stats_kernel<<<grid, THREADS, 0, s>>>(xp, static_cast<float*>(part), N, chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  norm_finalize_kernel<<<(unsigned)cdiv(rows, 128), 128, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(stats), rows, nchunk, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  norm_apply_kernel<<<grid, THREADS, 0, s>>>(
      xp, static_cast<const float*>(stats), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(alpha), static_cast<bf16*>(y), N,
      chunk, (int)act, vec);
  return cudaGetLastError();
}

// x, g, dx [rows, N] bf16; stats [rows, 2] from coma_norm_act; scale, shift
// [rows] f32 or null; alpha [1] f32 (read for prelu only). part holds
// rows * ceil(N / chunk) * 5 floats of scratch; sums receives [rows, 5]
// (sum gy, gy*yhat, g*min(u,0), gt*yhat = dscale, gt = dshift) and dalpha
// [1] the prelu slope's gradient; chunk must be a multiple of 8.
COMA_API int coma_norm_act_bwd(const void* x, const void* g, const void* stats, const void* scale,
                               const void* shift, const void* alpha, void* dx, void* part,
                               void* sums, void* dalpha, int64_t rows, int64_t N, int64_t chunk,
                               int64_t act, void* stream) {
  if (rows > 65535 || chunk % 8 != 0 || act < 0 || act > 3) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t nchunk = cdiv(N, chunk);
  const int vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const dim3 grid((unsigned)nchunk, (unsigned)rows);
  const auto xp = static_cast<const bf16*>(x);
  const auto gp = static_cast<const bf16*>(g);
  const auto st = static_cast<const float*>(stats);
  const auto sc = static_cast<const float*>(scale);
  const auto sh = static_cast<const float*>(shift);
  const auto al = static_cast<const float*>(alpha);
  norm_bwd_reduce_kernel<<<grid, THREADS, 0, s>>>(xp, gp, st, sc, sh, al,
                                                  static_cast<float*>(part), N, chunk, (int)act, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  norm_bwd_finalize_kernel<<<(unsigned)cdiv(rows, 128), 128, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(sums), rows, nchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  norm_bwd_alpha_kernel<<<1, 1, 0, s>>>(static_cast<const float*>(sums),
                                        static_cast<float*>(dalpha), rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  norm_bwd_apply_kernel<<<grid, THREADS, 0, s>>>(xp, gp, st, sc, sh, al,
                                                 static_cast<const float*>(sums),
                                                 static_cast<bf16*>(dx), N, chunk, (int)act, vec);
  return cudaGetLastError();
}
