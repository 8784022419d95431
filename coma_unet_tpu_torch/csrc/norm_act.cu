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
// What bounds it on the H100: memory. It reads x twice and writes y once
// (6 bytes per voxel) with a few flops per voxel; rows of 2M voxels give
// thousands of blocks. Threads move 8 bf16 (16 bytes) per load and store
// when N % 8 == 0, else one voxel at a time. Element offsets are 64-bit.
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

}  // namespace

// part holds rows * ceil(N / chunk) * 3 floats and stats rows * 2 floats of
// scratch; chunk must be a multiple of 8.
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
