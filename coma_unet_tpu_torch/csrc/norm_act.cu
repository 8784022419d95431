// K4: instance norm + FiLM + activation, forward; KB3: its backward. Each
// is one persistent kernel launch that reads every byte of x (and g) from
// device memory once.
//
// x [B, C, D, H, W] bf16 or f32 is taken as B*C rows of N = D*H*W voxels. Per row
// (b, c) the forward takes mean and variance in f32 (eps inside the rsqrt),
// then
//   u = scale[b, c] * (x - mean) * rsqrt(var + eps) + shift[b, c]
//   y = act(u)   act: 0 none, 1 relu, 2 leakyrelu (slope 0.01), 3 prelu (alpha[0])
// in f32, stored in x's type, and keeps the row's (mean, rstd) in `stats` for
// the backward. scale, shift and alpha are device pointers and may be null
// (identity FiLM; alpha is read only for prelu). Replaces row #18 of the
// kernel table in PERF.md (its forward half) and row #20:
// coma_unet_tpu/ops/pallas/norm_act.py `_norm_act_fwd_impl` (`_stats_kernel`
// then `_apply_kernel`) and instance_norm.py `pallas_instance_norm`.
//
// The backward, with yhat = (x - mean) * rstd, u = scale * yhat + shift,
// gt = g * act'(u) and gy = gt * scale, per row:
//   dx     = rstd * (gy - sum(gy) / N - yhat * sum(gy * yhat) / N)
//   dscale = sum(gt * yhat),  dshift = sum(gt),
//   dalpha = sum over all rows of sum(g * min(u, 0))   (prelu's one slope)
// act' is 1[u > 0] for relu, but 1 or 0.01 / alpha split at u >= 0 for
// leakyrelu / prelu, as in the JAX package. Replaces row #19: norm_act.py
// `_norm_act_bwd_impl` (`_bwd_reduce_kernel` then `_bwd_apply_kernel`).
//
// What bounds them on the H100: memory. The forward must read x and write
// y (4 bytes a voxel in bf16, 8 in f32), the backward read x and g and
// write dx (6 bytes, 12 in f32),
// with a few flops a voxel. Both need a whole row's sums before they can
// write a voxel, and a row of the 216^3 path is 20 MB. So the grid is
// persistent and co-resident (cudaLaunchCooperativeKernel), about one CTA
// an SM, cut by ops/norm_act.py:na_plan: each row is split into `segs`
// segments on distinct CTAs, `per_round` rows a round. Per round a CTA
//   1. has its segment copied into shared memory, in chunks of CHUNK
//      16-byte groups, each completing on its own mbarrier (the bulk copy
//      engine, cp.async.bulk, when every segment starts and ends on 16
//      bytes; otherwise 16-byte loads, and 2-byte loads at a ragged edge);
//   2. computes its partial as the chunks land: for K4 (count, mean, M2) of
//      x - s, s the row's first voxel (a shift that keeps the f32 sums
//      small when the mean is large against the spread); for KB3 the five
//      sums (gy, gy * yhat, g * min(u, 0), gt * yhat, gt);
//   3. publishes it (an add with release order on the row's counter) and
//      waits, with acquire order, until all the row's segments have;
//   4. merges the row's partials in f64 in a fixed order (Chan's formula in
//      closed form for K4: mean = sum n_i m_i / N, M2 = sum M2_i + n_i
//      (m_i - mean)^2; plain sums for KB3): every CTA of the row does it
//      itself (the partials read by as many threads, then added by one
//      warp) and gets the same bits, and segment 0 stores the row's (mean,
//      rstd), for KB3 its five sums;
//   5. applies from shared memory and stores in 16-byte vectors;
//   6. issues the next round's copy of each chunk as soon as this round has
//      consumed it, so that one round's stores overlap the next one's loads.
// What does not fit is read from device memory where it is needed: KB3
// keeps g's segment first and as much of x's as fits, and reads the rest of
// x again in step 5, just after step 2 read it (most of it from the 50 MB
// L2). One code path, with no limit on N or the rows. dalpha: the last CTA
// to store its row's sums (one more counter) adds the rows' third sums in
// row order in f64. No float atomics: two calls give the same bits. The C
// entry zeroes the counters before the launch. Element offsets are 64-bit.
// Every kernel here is templated on the element type T, bf16 or f32 (its
// float32 form): a 16-byte group holds EPG = 16 / sizeof(T) values, so an
// f32 CTA keeps half as many voxels (na_plan takes the element size), and
// the sums, the f64 merge and its order are the same for both.
//
// Measured on the H100 (PERF.md): a round costs the row's bytes at
// about 2.2-2.8 TB/s plus 4-6 us of meeting, in which the device's memory
// idles; at 216^3 a row fills the grid, so every round pays it.
#include "common.cuh"

namespace {

using coma::bf16;
using coma::cdiv;

// The element types: values a 16-byte group, and the conversions to and
// from the f32 the arithmetic runs in.
template <class T>
struct Elem;

template <>
struct Elem<bf16> {
  static constexpr int EPG = 8;
  __device__ static float load(bf16 v) { return __bfloat162float(v); }
  __device__ static bf16 store(float v) { return __float2bfloat16(v); }
};

template <>
struct Elem<float> {
  static constexpr int EPG = 4;
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
};

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 2048;              // 16-byte groups a chunk of one tensor (32 KB)
constexpr int PER = CHUNK / THREADS;     // groups of a chunk a thread takes
constexpr int MAX_SMEM = 223 * 1024;     // dynamic shared memory a CTA may keep
constexpr int MAX_CHUNKS = (MAX_SMEM / 16 + CHUNK - 1) / CHUNK;
constexpr int MAX_SEGS = 160;            // segments a row (at most one a CTA)
constexpr int NSUM = 5;

template <class T>
struct NaArgs {
  const T* x;
  const T* g;           // KB3: the cotangent of y
  const float* scale;   // [rows] or null
  const float* shift;   // [rows] or null
  const float* alpha;   // [1], read for prelu
  T* out;               // y (K4) or dx (KB3)
  float* stats;         // [rows, 2] (mean, rstd): K4 writes them, KB3 reads them
  float* sums;          // KB3: [rows, 5]
  float* dalpha;        // KB3: [1]
  float* part;          // [rows, segs, 3 (K4) or 5 (KB3)] partials
  unsigned* count;      // [rows + 1] arrivals, zero at launch
  int64_t rows, n, seg;
  int segs, per_round, keep_groups, bulk, vec;
  float eps;
};

// One CTA's segment of one row, in the row's aligned coordinates (element
// e of the row is element o + e there; o = (row * N) % EPG when the pointers
// are 16-byte aligned, so groups of EPG are 16-byte vectors).
struct Seg {
  int64_t base;   // offset of the aligned row: row * N - o
  int64_t lo, hi; // the segment: [o + e0, o + e1)
  int64_t g0;     // its first 16-byte group
  int groups;     // groups it touches
  int kg, kx;     // groups of g and of x kept in shared memory
};

template <class T>
__device__ __forceinline__ Seg segment(const NaArgs<T>& a, int64_t row, int sidx, bool two) {
  constexpr int EPG = Elem<T>::EPG;
  const int64_t o = a.vec ? (row * a.n) % EPG : 0;
  const int64_t e0 = sidx * a.seg, e1 = e0 + a.seg < a.n ? e0 + a.seg : a.n;
  Seg s;
  s.base = row * a.n - o;
  s.lo = o + e0;
  s.hi = o + e1;
  s.g0 = s.lo / EPG;
  s.groups = (int)((s.hi + EPG - 1) / EPG - s.g0);
  s.kg = two ? min(s.groups, a.keep_groups) : 0;
  s.kx = min(s.groups, a.keep_groups - s.kg);
  return s;
}

template <int EPG>
__device__ __forceinline__ bool whole(int64_t e, const Seg& s) {
  return e >= s.lo && e + EPG <= s.hi;
}

// Group k of an aligned row: one 16-byte load when it lies inside the
// segment (and the pointers allow it), else the elements inside, one at a
// time, the rest 0.
template <class T>
__device__ __forceinline__ uint4 load_group(const T* row, int64_t k, const Seg& s, int vec) {
  constexpr int EPG = Elem<T>::EPG;
  const int64_t e = EPG * k;
  if (vec && whole<EPG>(e, s)) return *reinterpret_cast<const uint4*>(row + e);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  T* pv = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int j = 0; j < EPG; ++j)
    if (e + j >= s.lo && e + j < s.hi) pv[j] = row[e + j];
  return v;
}

template <class T>
__device__ __forceinline__ void store_group(T* row, int64_t k, const Seg& s, int vec,
                                            const uint4& v) {
  constexpr int EPG = Elem<T>::EPG;
  const int64_t e = EPG * k;
  if (vec && whole<EPG>(e, s)) {
    *reinterpret_cast<uint4*>(row + e) = v;
    return;
  }
  const T* pv = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int j = 0; j < EPG; ++j)
    if (e + j >= s.lo && e + j < s.hi) row[e + j] = pv[j];
}

// Value j of a 16-byte group of T, as f32.
template <class T>
__device__ __forceinline__ float val(const uint4& v, int j) {
  return Elem<T>::load(reinterpret_cast<const T*>(&v)[j]);
}

// Calls f(j) for each element j of group k that lies in the segment.
template <int EPG, class F>
__device__ __forceinline__ void for_each(int64_t k, const Seg& s, F&& f) {
  const int64_t e = EPG * k;
  if (whole<EPG>(e, s)) {
#pragma unroll
    for (int j = 0; j < EPG; ++j) f(j);
  } else {
#pragma unroll
    for (int j = 0; j < EPG; ++j)
      if (e + j >= s.lo && e + j < s.hi) f(j);
  }
}

// ----------------------------------------------------- copies and barriers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Chunk c of the segment (its kept groups of g and of x) into shared
// memory, completing on bar. Issued by one thread.
template <class T>
__device__ __forceinline__ void issue_chunk(uint32_t bar, const uint4* sg, const uint4* sx,
                                            const T* gr, const T* xr, const Seg& s, int c) {
  constexpr int EPG = Elem<T>::EPG;
  const int k = c * CHUNK;
  const int ng = max(0, min(CHUNK, s.kg - k)), nx = max(0, min(CHUNK, s.kx - k));
  // the async proxy next writes what the generic proxy read
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(16 * (ng + nx))
               : "memory");
  if (ng > 0) bulk_copy(smem_u32(sg + k), gr + EPG * (s.g0 + k), 16 * ng, bar);
  if (nx > 0) bulk_copy(smem_u32(sx + k), xr + EPG * (s.g0 + k), 16 * nx, bar);
}

// Thread 0: publish this CTA's partial (stored before) with release order
// and wait, with acquire order, until the row's `target` segments have
// published theirs.
__device__ __forceinline__ void arrive_and_wait(unsigned* counter, unsigned target) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
  unsigned seen;
  while (true) {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    if (seen >= target) break;
    __nanosleep(20);
  }
}

// Sums v (float or double) over the CTA of NW warps in a fixed order; the
// totals land in thread 0.
template <class A, int K, int NW>
__device__ __forceinline__ void block_total(A (&v)[K], A (*red)[NW]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
    if (lane == 0) red[j][warp] = v[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      A t = 0;
      for (int w = 0; w < NW; ++w) t += red[j][w];
      v[j] = t;
    }
  }
}

// The sum of v over a warp in a fixed order, in every lane.
__device__ __forceinline__ double warp_total(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// ----------------------------------------------------------- arithmetic
template <int ACT>
__device__ __forceinline__ float activate(float u, float alpha) {
  if constexpr (ACT == 1) return fmaxf(u, 0.f);
  if constexpr (ACT == 2) return u >= 0.f ? u : 0.01f * u;
  if constexpr (ACT == 3) return u >= 0.f ? u : alpha * u;
  return u;
}

template <int ACT>
__device__ __forceinline__ float act_deriv(float u, float alpha) {
  if constexpr (ACT == 1) return u > 0.f ? 1.f : 0.f;
  if constexpr (ACT == 2) return u >= 0.f ? 1.f : 0.01f;
  if constexpr (ACT == 3) return u >= 0.f ? 1.f : alpha;
  return 1.f;
}

// ---------------------------------------------------------------- kernel
// BWD false: K4; true: KB3.
template <class T, bool BWD, int ACT>
__device__ __forceinline__ void run(const NaArgs<T>& a) {
  constexpr int EPG = Elem<T>::EPG;
  constexpr int NA = BWD ? NSUM : 2;  // f32 sums a thread carries
  constexpr int NP = BWD ? NSUM : 3;  // floats a partial
  extern __shared__ __align__(128) uint4 buf[];
  __shared__ __align__(8) uint64_t bars[MAX_CHUNKS];
  __shared__ float red[NA][WARPS];
  __shared__ float rowp[2];  // K4: (mean, rstd); KB3: (sum gy / N, sum gy * yhat / N)
  __shared__ float parts[MAX_SEGS * NP];  // the row's partials
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int slot = blockIdx.x / a.segs, sidx = blockIdx.x % a.segs;
  int64_t row = slot;
  if (row >= a.rows) return;

  const auto bar = [&](int c) { return smem_u32(&bars[c]); };
  Seg s = segment(a, row, sidx, BWD);
  // with bulk copies every segment is whole groups from 0: the same layout
  // every round
  const int kept_chunks = cdiv(max(s.kg, s.kx), CHUNK);
  if (a.bulk) {
    if (tid == 0) {
      for (int c = 0; c < kept_chunks; ++c) mbar_init(bar(c));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int c = 0; c < kept_chunks; ++c)
        issue_chunk(bar(c), buf, buf + s.kg, a.g + s.base, a.x + s.base, s, c);
    }
    __syncthreads();
  }
  const float alpha = ACT == 3 ? a.alpha[0] : 0.f;
  for (int r = 0; row < a.rows; ++r, row += a.per_round) {
    s = segment(a, row, sidx, BWD);
    if (!a.bulk) {  // stage this round's kept groups by loads
      __syncthreads();  // the last round's reads of buf are done
      for (int k = tid; k < s.kg; k += THREADS)
        buf[k] = load_group(a.g + s.base, s.g0 + k, s, a.vec);
      for (int k = tid; k < s.kx; k += THREADS)
        buf[s.kg + k] = load_group(a.x + s.base, s.g0 + k, s, a.vec);
      __syncthreads();
    }
    const uint4* const sg = buf;
    const uint4* const sx = buf + s.kg;
    const T* const xr = a.x + s.base;
    const T* const gr = a.g + s.base;
    T* const outr = a.out + s.base;
    const float sc = a.scale ? a.scale[row] : 1.f, sh = a.shift ? a.shift[row] : 0.f;
    float mean = 0.f, rstd = 0.f, shift0 = 0.f;
    if constexpr (BWD) {
      mean = a.stats[2 * row];
      rstd = a.stats[2 * row + 1];
    } else {
      shift0 = Elem<T>::load(a.x[row * a.n]);
    }
    const int chunks = cdiv(s.groups, CHUNK);
    // a chunk's x for this thread, all loads first; g is read where it is used
    const auto fetch = [&](int c, uint4 (&xv)[PER]) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int kl = c * CHUNK + i * THREADS + tid;
        if (kl < s.groups) xv[i] = kl < s.kx ? sx[kl] : load_group(xr, s.g0 + kl, s, a.vec);
      }
    };
    const auto gval = [&](int kl) {
      return kl < s.kg ? sg[kl] : load_group(gr, s.g0 + kl, s, a.vec);
    };

    // 1. the segment's partial, chunk by chunk as the copies land
    float acc[NA];
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[j] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      if (a.bulk && c < kept_chunks)
        while (!mbar_try_wait(bar(c), r & 1)) {
        }
      uint4 xv[PER];
      fetch(c, xv);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int kl = c * CHUNK + i * THREADS + tid;
        if (kl >= s.groups) continue;
        if constexpr (BWD) {
          const uint4 gv = gval(kl);
          for_each<EPG>(s.g0 + kl, s, [&](int j) {
            const float yhat = (val<T>(xv[i], j) - mean) * rstd;
            const float u = sc * yhat + sh;
            const float gj = val<T>(gv, j);
            const float gt = gj * act_deriv<ACT>(u, alpha);
            const float gy = gt * sc;
            acc[0] += gy;
            acc[1] = fmaf(gy, yhat, acc[1]);
            acc[2] = fmaf(gj, fminf(u, 0.f), acc[2]);
            acc[3] = fmaf(gt, yhat, acc[3]);
            acc[4] += gt;
          });
        } else {
          for_each<EPG>(s.g0 + kl, s, [&](int j) {
            const float t = val<T>(xv[i], j) - shift0;
            acc[0] += t;
            acc[1] = fmaf(t, t, acc[1]);
          });
        }
      }
    }
    block_total(acc, red);
    float* const part = a.part + row * a.segs * NP;
    if (tid == 0) {
      float* p = part + sidx * NP;
      if constexpr (BWD) {
#pragma unroll
        for (int j = 0; j < NSUM; ++j) p[j] = acc[j];
      } else {
        const float cnt = (float)(s.hi - s.lo), m = acc[0] / cnt;
        p[0] = cnt;
        p[1] = m;
        p[2] = fmaxf(acc[1] - acc[0] * m, 0.f);
      }
      // 2. meet the row's other segments
      if (a.segs > 1) arrive_and_wait(a.count + row, (unsigned)a.segs);
    }
    __syncthreads();

    // 3. merge the row's partials in f64, the same way in every CTA of the
    // row: one load each, by as many threads, then one warp adds them
    if (tid < a.segs)
#pragma unroll
      for (int j = 0; j < NP; ++j) parts[tid * NP + j] = __ldcg(part + tid * NP + j);
    __syncthreads();
    if (warp == 0) {
      const double nd = (double)a.n;
      if constexpr (BWD) {
        double t[NSUM];
#pragma unroll
        for (int j = 0; j < NSUM; ++j) t[j] = 0.0;
        for (int i = lane; i < a.segs; i += 32)
#pragma unroll
          for (int j = 0; j < NSUM; ++j) t[j] += (double)parts[i * NP + j];
#pragma unroll
        for (int j = 0; j < NSUM; ++j) t[j] = warp_total(t[j]);
        if (lane == 0) {
          rowp[0] = (float)(t[0] / nd);
          rowp[1] = (float)(t[1] / nd);
          if (sidx == 0) {
#pragma unroll
            for (int j = 0; j < NSUM; ++j) a.sums[row * NSUM + j] = (float)t[j];
            // the last row to finish adds the rows' prelu sums in row order
            __threadfence();
            if (atomicAdd(a.count + a.rows, 1u) == (unsigned)a.rows - 1u) {
              __threadfence();
              double da = 0.0;
              for (int64_t q = 0; q < a.rows; ++q) da += (double)__ldcg(a.sums + q * NSUM + 2);
              a.dalpha[0] = ACT == 3 ? (float)da : 0.f;
            }
          }
        }
      } else {
        double sn = 0.0;
        for (int i = lane; i < a.segs; i += 32)
          sn += (double)parts[i * NP] * (double)parts[i * NP + 1];
        const double mt = warp_total(sn) / nd;
        double m2 = 0.0;
        for (int i = lane; i < a.segs; i += 32) {
          const double d = (double)parts[i * NP + 1] - mt;
          m2 += (double)parts[i * NP + 2] + (double)parts[i * NP] * d * d;
        }
        m2 = warp_total(m2);
        if (lane == 0) {
          const float mu = (float)((double)shift0 + mt);
          const float rs = rsqrtf((float)(m2 / nd) + a.eps);
          rowp[0] = mu;
          rowp[1] = rs;
          if (sidx == 0) {
            a.stats[2 * row] = mu;
            a.stats[2 * row + 1] = rs;
          }
        }
      }
    }
    __syncthreads();
    const float p0 = rowp[0], p1 = rowp[1];

    // 4. apply, handing each chunk to the next round's copy once consumed
    const bool more = row + a.per_round < a.rows;
    const int64_t next = (row + a.per_round) * a.n;  // bulk: o = 0
    for (int c = 0; c < chunks; ++c) {
      uint4 xv[PER];
      fetch(c, xv);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int kl = c * CHUNK + i * THREADS + tid;
        if (kl >= s.groups) continue;
        uint4 ov = make_uint4(0u, 0u, 0u, 0u);
        T* const o = reinterpret_cast<T*>(&ov);
        if constexpr (BWD) {
          const uint4 gv = gval(kl);
          for_each<EPG>(s.g0 + kl, s, [&](int j) {
            const float yhat = (val<T>(xv[i], j) - mean) * rstd;
            const float u = sc * yhat + sh;
            const float gy = val<T>(gv, j) * act_deriv<ACT>(u, alpha) * sc;
            o[j] = Elem<T>::store(rstd * (gy - p0 - yhat * p1));
          });
        } else {
          for_each<EPG>(s.g0 + kl, s, [&](int j) {
            const float u = sc * ((val<T>(xv[i], j) - p0) * p1) + sh;
            o[j] = Elem<T>::store(activate<ACT>(u, alpha));
          });
        }
        store_group(outr, s.g0 + kl, s, a.vec, ov);
      }
      if (a.bulk && more && c < kept_chunks) {
        __syncthreads();
        if (tid == 0) issue_chunk(bar(c), buf, buf + s.kg, a.g + next, a.x + next, s, c);
      }
    }
  }
}

template <class T, int ACT>
__global__ void __launch_bounds__(THREADS, 1) norm_act_kernel(const NaArgs<T> a) {
  run<T, false, ACT>(a);
}

template <class T, int ACT>
__global__ void __launch_bounds__(THREADS, 1) norm_act_bwd_kernel(const NaArgs<T> a) {
  run<T, true, ACT>(a);
}

template <class T, bool BWD, int ACT>
cudaError_t launch(const NaArgs<T>& a, int64_t grid, int64_t smem, cudaStream_t stream) {
  const void* kernel = BWD ? reinterpret_cast<const void*>(norm_act_bwd_kernel<T, ACT>)
                           : reinterpret_cast<const void*>(norm_act_kernel<T, ACT>);
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  void* args[] = {const_cast<NaArgs<T>*>(&a)};
  // every CTA must be resident: a CTA waits for its row's other segments
  return cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid), dim3(THREADS), args,
                                     (size_t)smem, stream);
}

// Zeroes the counters, then launches the kernel.
template <class T, bool BWD>
cudaError_t launch_act(const NaArgs<T>& a, int64_t act, int64_t grid, int64_t smem,
                       cudaStream_t stream) {
  const cudaError_t err =
      cudaMemsetAsync(a.count, 0, sizeof(unsigned) * (size_t)(a.rows + 1), stream);
  if (err != cudaSuccess) return err;
  switch (act) {
    case 1: return launch<T, BWD, 1>(a, grid, smem, stream);
    case 2: return launch<T, BWD, 2>(a, grid, smem, stream);
    case 3: return launch<T, BWD, 3>(a, grid, smem, stream);
    default: return launch<T, BWD, 0>(a, grid, smem, stream);
  }
}

// Fills the cut of `a` from the plan and checks it; false if it does not
// cover every row and voxel, or does not fit.
template <class T>
bool set_plan(NaArgs<T>& a, int64_t rows, int64_t n, int64_t act, int64_t segs, int64_t per_round,
              int64_t rounds, int64_t seg, int64_t keep, int64_t grid, int64_t bulk,
              int64_t smem) {
  if (rows < 1 || n < 1 || act < 0 || act > 3 || segs < 1 || per_round < 1 || seg < 8 ||
      seg % 8 != 0 || keep < 0 || keep % Elem<T>::EPG != 0 || grid != segs * per_round ||
      grid > (1 << 30) || (segs - 1) * seg >= n || segs * seg < n || segs > MAX_SEGS ||
      per_round * rounds < rows || smem < (int64_t)sizeof(T) * keep || smem > MAX_SMEM)
    return false;
  a.rows = rows;
  a.n = n;
  a.seg = seg;
  a.segs = (int)segs;
  a.per_round = (int)per_round;
  a.keep_groups = (int)(keep / Elem<T>::EPG);
  a.bulk = (int)(bulk && a.vec);
  return true;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class T>
int norm_act_entry(const void* x, const void* scale, const void* shift, const void* alpha,
                   void* y, void* stats, void* scratch, int64_t rows, int64_t n, int64_t act,
                   int64_t segs, int64_t per_round, int64_t rounds, int64_t seg, int64_t keep,
                   int64_t grid, int64_t bulk, int64_t smem, float eps, void* stream) {
  NaArgs<T> a{};
  a.x = static_cast<const T*>(x);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.alpha = static_cast<const float*>(alpha);
  a.out = static_cast<T*>(y);
  a.stats = static_cast<float*>(stats);
  a.vec = aligned16(x) && aligned16(y);
  a.eps = eps;
  if (!set_plan(a, rows, n, act, segs, per_round, rounds, seg, keep, grid, bulk, smem))
    return cudaErrorInvalidValue;
  a.part = static_cast<float*>(scratch);
  a.count = reinterpret_cast<unsigned*>(a.part + rows * segs * 3);
  return launch_act<T, false>(a, act, grid, smem, static_cast<cudaStream_t>(stream));
}

template <class T>
int norm_act_bwd_entry(const void* x, const void* g, const void* stats, const void* scale,
                       const void* shift, const void* alpha, void* dx, void* sums, void* dalpha,
                       void* scratch, int64_t rows, int64_t n, int64_t act, int64_t segs,
                       int64_t per_round, int64_t rounds, int64_t seg, int64_t keep, int64_t grid,
                       int64_t bulk, int64_t smem, void* stream) {
  NaArgs<T> a{};
  a.x = static_cast<const T*>(x);
  a.g = static_cast<const T*>(g);
  a.stats = static_cast<float*>(const_cast<void*>(stats));
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.alpha = static_cast<const float*>(alpha);
  a.out = static_cast<T*>(dx);
  a.sums = static_cast<float*>(sums);
  a.dalpha = static_cast<float*>(dalpha);
  a.vec = aligned16(x) && aligned16(g) && aligned16(dx);
  if (!set_plan(a, rows, n, act, segs, per_round, rounds, seg, keep, grid, bulk, smem))
    return cudaErrorInvalidValue;
  a.part = static_cast<float*>(scratch);
  a.count = reinterpret_cast<unsigned*>(a.part + rows * segs * NSUM);
  return launch_act<T, true>(a, act, grid, smem, static_cast<cudaStream_t>(stream));
}

}  // namespace

// x, y [rows, n] bf16; scale, shift [rows] f32 or null; alpha [1] f32
// (read for prelu only). stats receives [rows, 2] (mean, rstd). scratch:
// rows * segs * 3 floats of partials, then rows + 1 32-bit counters, zeroed
// here. The cut (segs .. smem) comes from ops/norm_act.py:na_plan.
COMA_API int coma_norm_act(const void* x, const void* scale, const void* shift,
                           const void* alpha, void* y, void* stats, void* scratch, int64_t rows,
                           int64_t n, int64_t act, int64_t segs, int64_t per_round,
                           int64_t rounds, int64_t seg, int64_t keep, int64_t grid, int64_t bulk,
                           int64_t smem, float eps, void* stream) {
  return norm_act_entry<bf16>(x, scale, shift, alpha, y, stats, scratch, rows, n, act, segs,
                              per_round, rounds, seg, keep, grid, bulk, smem, eps, stream);
}

// coma_norm_act's float32 form: x, y [rows, n] f32, the cut from na_plan at
// element size 4.
COMA_API int coma_norm_act_f32(const void* x, const void* scale, const void* shift,
                               const void* alpha, void* y, void* stats, void* scratch,
                               int64_t rows, int64_t n, int64_t act, int64_t segs,
                               int64_t per_round, int64_t rounds, int64_t seg, int64_t keep,
                               int64_t grid, int64_t bulk, int64_t smem, float eps,
                               void* stream) {
  return norm_act_entry<float>(x, scale, shift, alpha, y, stats, scratch, rows, n, act, segs,
                               per_round, rounds, seg, keep, grid, bulk, smem, eps, stream);
}

// x, g, dx [rows, n] bf16; stats [rows, 2] from coma_norm_act; scale, shift
// [rows] f32 or null; alpha [1] f32 (read for prelu only). sums receives
// [rows, 5] (sum gy, gy*yhat, g*min(u,0), gt*yhat = dscale, gt = dshift)
// and dalpha [1] the prelu slope's gradient (0 for the other activations).
// scratch: rows * segs * 5 floats of partials, then rows + 1 32-bit
// counters, zeroed here. The cut (segs .. smem) comes from ops/norm_act.py:na_plan.
COMA_API int coma_norm_act_bwd(const void* x, const void* g, const void* stats, const void* scale,
                               const void* shift, const void* alpha, void* dx, void* sums,
                               void* dalpha, void* scratch, int64_t rows, int64_t n, int64_t act,
                               int64_t segs, int64_t per_round, int64_t rounds, int64_t seg,
                               int64_t keep, int64_t grid, int64_t bulk, int64_t smem,
                               void* stream) {
  return norm_act_bwd_entry<bf16>(x, g, stats, scale, shift, alpha, dx, sums, dalpha, scratch,
                                  rows, n, act, segs, per_round, rounds, seg, keep, grid, bulk,
                                  smem, stream);
}

// coma_norm_act_bwd's float32 form: x, g, dx [rows, n] f32, the cut from
// na_plan at element size 4.
COMA_API int coma_norm_act_bwd_f32(const void* x, const void* g, const void* stats,
                                   const void* scale, const void* shift, const void* alpha,
                                   void* dx, void* sums, void* dalpha, void* scratch,
                                   int64_t rows, int64_t n, int64_t act, int64_t segs,
                                   int64_t per_round, int64_t rounds, int64_t seg, int64_t keep,
                                   int64_t grid, int64_t bulk, int64_t smem, void* stream) {
  return norm_act_bwd_entry<float>(x, g, stats, scale, shift, alpha, dx, sums, dalpha, scratch,
                                   rows, n, act, segs, per_round, rounds, seg, keep, grid, bulk,
                                   smem, stream);
}

// ------------------------------------------------------- K4's slab form
// Where a volume's depth is split over ranks (parallel/spatial.py), a rank
// holds only its slab of each row, and the row's statistics are merged
// across the ranks between K4's two halves. So the halves are two entries
// here, the counterparts of the Pallas kernel's own two:
//   coma_norm_stats: each row's partial of the slab, (count, mean, M2) in
//     f64. Replaces norm_act.py `_stats_kernel` (its launch in
//     `_norm_act_fwd_impl`).
//   coma_norm_apply: y = act(scale * (x - mean) * rstd + shift) from the
//     given per-row f32 mean and rstd, stored in x's type. Replaces
//     `_apply_kernel`.
// Both read x once (apply writes y once): bound by memory, 3.35 TB/s on the
// H100, and on the one-channel sites of the path (2 MB) by the launch and
// one trip to memory. Both are cut by ops/norm_act.py:slab_plan: each row
// into `segs` segments of `seg` voxels (a multiple of 8, at least 16 KB),
// on a 2-D grid of (segment, row), rows folded past 65,535; the statistics
// take as many segments a row as one wave of the kernel's own occupancy
// holds (a second wave costs another round of CTA starts, reductions and
// tickets for no more bytes in flight), the apply 16 KB pieces, which even
// out over the SMs as they finish.
// A CTA takes its segment in the row's aligned coordinates (`Piece`): the
// 16-byte groups wholly inside it as vectors, each thread issuing
// SLAB_UNROLL loads before it uses any, and the at most EPG - 1 elements at
// each ragged end one at a time, so a row that starts off 16 bytes (N % EPG
// != 0, or x off 16) still streams in vectors. The statistics half is one
// launch: each CTA stores a shifted partial (count, mean and M2 of x - s,
// s the row's first voxel of the slab; each 16-byte group summed in f32,
// the groups and the CTA's threads in f64 in a fixed order; stored as f32)
// and takes a ticket on its row's counter (acquire-release);
// the CTA that takes the last ticket stages the row's partials in shared
// memory and merges them in f64 in segment order (K4's merge), writes
// (count, mean, M2) and sets the counter back to 0. The result does not
// depend on which CTA comes last, and there are no float atomics: two calls
// give the same bits. The partials and the counters are a workspace the
// wrapper keeps per device, zeroed once; calls on one device are ordered
// on its current stream. The apply half reads its row's mean, rstd, scale,
// shift and alpha once a CTA (no division per group) and cuts in y's
// aligned coordinates: 16-byte stores, and 16-byte loads of x too where x
// shares y's offset (element loads where not). Both are templated on the
// element type like K4 (the `_f32` entries are the float32 forms).
namespace {

constexpr int SLAB_THREADS = 256;
constexpr int SLAB_CTAS = 4;  // CTAs an SM holds of the statistics: at most 64 registers
constexpr int SLAB_WARPS = SLAB_THREADS / 32;
constexpr int SLAB_UNROLL = 4;  // 16-byte groups a thread loads before it uses them
constexpr int64_t SLAB_ROWS_Y = 65535;  // rows a grid takes in y; more fold
constexpr int SLAB_STAGE = 512;         // partials the merge stages at a time (a multiple of 32)

template <class T>
struct SlabArgs {
  const T* x;
  const float* stats;  // apply: [rows, 2] (mean, rstd)
  const float* scale;  // apply: [rows] or null
  const float* shift;  // apply: [rows] or null
  const float* alpha;  // apply: [1], read for prelu
  T* y;                // apply: the output
  float* part;         // stats: [rows, segs, 3] partials
  unsigned* count;     // stats: [rows] tickets, 0 at launch and left 0
  double* out;         // stats: [rows, 3] (count, mean, M2)
  int64_t rows, n, seg;
  int segs;
  int off;  // elements from the 16-byte boundary below the aligned tensor
            // (stats: x; apply: y) to its start
};

// Segment [e0, e1) of a row in its aligned coordinates: element e of the
// row is element o + e of the aligned base, whose groups of EPG elements
// are 16-byte aligned. Groups [g0, g1) lie wholly inside the segment;
// elements [lo, a) and [b, hi) are its ragged ends (all of it where no
// group fits).
struct Piece {
  int64_t lo, hi, g0, g1, a, b;
};

template <int EPG>
__device__ __forceinline__ Piece piece(int64_t o, int64_t e0, int64_t e1) {
  Piece p;
  p.lo = o + e0;
  p.hi = o + e1;
  p.g0 = (p.lo + EPG - 1) / EPG;
  p.g1 = p.hi / EPG;
  if (p.g0 < p.g1) {
    p.a = EPG * p.g0;
    p.b = EPG * p.g1;
  } else {
    p.g1 = p.g0;
    p.a = p.b = p.hi;
  }
  return p;
}

// Calls f(e, v) for each element e of the piece's ragged ends, v its value
// in `base` as f32, spread over the CTA's threads in a fixed order,
// SLAB_UNROLL elements a thread a trip, all loaded first.
template <class T, class F>
__device__ __forceinline__ void for_edges(const T* base, const Piece& p, F&& f) {
  const int64_t head = p.a - p.lo, count = head + (p.hi - p.b);
  for (int64_t i = threadIdx.x; i < count; i += SLAB_UNROLL * SLAB_THREADS) {
    int64_t e[SLAB_UNROLL];
    float v[SLAB_UNROLL];
#pragma unroll
    for (int u = 0; u < SLAB_UNROLL; ++u) {
      const int64_t iu = i + u * SLAB_THREADS;
      e[u] = iu < head ? p.lo + iu : p.b + iu - head;
      if (iu < count) v[u] = Elem<T>::load(base[e[u]]);
    }
#pragma unroll
    for (int u = 0; u < SLAB_UNROLL; ++u)
      if (i + u * SLAB_THREADS < count) f(e[u], v[u]);
  }
}

// Group k of `base` as 16 bytes: one vector load where VEC, else EPG
// element loads (base is not 16-byte aligned there).
template <bool VEC, class T>
__device__ __forceinline__ uint4 load16(const T* base, int64_t k) {
  constexpr int EPG = Elem<T>::EPG;
  if constexpr (VEC) return *reinterpret_cast<const uint4*>(base + EPG * k);
  uint4 v;
  T* const pv = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int j = 0; j < EPG; ++j) pv[j] = base[EPG * k + j];
  return v;
}

// Calls f(k, v) for each group k of the piece that this thread takes, v
// its 16 bytes of `base` (`load16`): SLAB_UNROLL groups a trip, all loaded
// first.
template <bool VEC, class T, class F>
__device__ __forceinline__ void for_groups(const T* base, const Piece& p, F&& f) {
  constexpr int EPG = Elem<T>::EPG;
  for (int64_t k = p.g0 + threadIdx.x; k < p.g1; k += SLAB_UNROLL * SLAB_THREADS) {
    uint4 v[SLAB_UNROLL];
#pragma unroll
    for (int u = 0; u < SLAB_UNROLL; ++u) {
      const int64_t ku = k + u * SLAB_THREADS;
      if (ku < p.g1) v[u] = load16<VEC>(base, ku);
    }
#pragma unroll
    for (int u = 0; u < SLAB_UNROLL; ++u) {
      const int64_t ku = k + u * SLAB_THREADS;
      if (ku < p.g1) f(ku, v[u]);
    }
  }
}

// Thread 0: adds one to the counter with acquire-release order (this CTA's
// partial, stored before, is published; the partials of the CTAs that took
// earlier tickets are seen) and returns the count before.
__device__ __forceinline__ unsigned ticket(unsigned* counter) {
  unsigned prev;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(prev)
               : "l"(counter)
               : "memory");
  return prev;
}

template <class T>
__global__ void __launch_bounds__(SLAB_THREADS, SLAB_CTAS)
    slab_stats_kernel(const SlabArgs<T> a) {
  constexpr int EPG = Elem<T>::EPG;
  __shared__ double red[2][SLAB_WARPS];
  __shared__ float stage[3 * SLAB_STAGE];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid % 32;
  const int sidx = blockIdx.x;
  const int64_t e0 = (int64_t)sidx * a.seg, e1 = e0 + a.seg < a.n ? e0 + a.seg : a.n;
  for (int64_t row = blockIdx.y; row < a.rows; row += gridDim.y) {
    const T* const xr = a.x + row * a.n;
    const int64_t o = (uint64_t)(a.off + row * a.n) % EPG;
    const T* const base = xr - o;
    const Piece p = piece<EPG>(o, e0, e1);
    const float s0 = Elem<T>::load(xr[0]);
    // the shifted sums of each 16-byte group in f32, added to the thread's
    // f64 sums (the ragged ends' values one by one): a thread's run of a
    // long segment (about 1,300 values at 216^3's level-0 slabs) adds no
    // f32 rounding that grows with its length, and M2 = sum t^2 - m sum t
    // cancels in f64
    double acc[2] = {0.0, 0.0};
    for_groups<true>(base, p, [&](int64_t, const uint4& v) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int j = 0; j < EPG; ++j) {
        const float t = val<T>(v, j) - s0;
        s += t;
        q = fmaf(t, t, q);
      }
      acc[0] += (double)s;
      acc[1] += (double)q;
    });
    for_edges(base, p, [&](int64_t, float v) {
      const double t = (double)(v - s0);
      acc[0] += t;
      acc[1] = fma(t, t, acc[1]);
    });
    block_total(acc, red);
    if (tid == 0) {
      const double cnt = (double)(e1 - e0), m = acc[0] / cnt;
      float* const pp = a.part + (row * a.segs + sidx) * 3;
      pp[0] = (float)cnt;
      pp[1] = (float)m;
      pp[2] = (float)fmax(fma(-acc[0], m, acc[1]), 0.0);
      last = ticket(a.count + row) == (unsigned)a.segs - 1u;
    }
    __syncthreads();
    // the last CTA of the row merges its partials in f64 in segment order,
    // K4's merge (`run`, step 3): the CTA stages them in shared memory, up
    // to SLAB_STAGE at a time, and one warp adds them, lane l those of
    // segments l, l + 32, ...
    if (last) {
      const float* const pr = a.part + row * a.segs * 3;
      const double nd = (double)a.n;
      const bool once = a.segs <= SLAB_STAGE;  // both passes read one staging
      double sn = 0.0, mt = 0.0, m2 = 0.0;
      for (int pass = 0; pass < 2; ++pass) {
        for (int c0 = 0; c0 < a.segs; c0 += SLAB_STAGE) {
          const int cnt = min(SLAB_STAGE, a.segs - c0);
          if (pass == 0 || !once) {
            __syncthreads();  // the last chunk's reads are done
            for (int i = tid; i < 3 * cnt; i += SLAB_THREADS) stage[i] = __ldcg(pr + 3 * c0 + i);
            __syncthreads();
          }
          if (tid < 32) {
            for (int i = lane; i < cnt; i += 32) {
              const float* const q = stage + 3 * i;
              if (pass == 0) {
                sn += (double)q[0] * (double)q[1];
              } else {
                const double d = (double)q[1] - mt;
                m2 += (double)q[2] + (double)q[0] * d * d;
              }
            }
          }
        }
        if (tid < 32) {
          if (pass == 0) mt = warp_total(sn) / nd;
          else m2 = warp_total(m2);
        }
      }
      if (tid == 0) {
        a.out[3 * row] = nd;
        a.out[3 * row + 1] = (double)s0 + mt;
        a.out[3 * row + 2] = m2;
        a.count[row] = 0u;  // the next call finds it zero
      }
    }
    __syncthreads();  // red and last are free for the next row
  }
}

// VEC: x shares y's offset, so x's groups load as 16-byte vectors too;
// else element by element.
template <class T, int ACT, bool VEC>
__global__ void __launch_bounds__(SLAB_THREADS) slab_apply_kernel(const SlabArgs<T> a) {
  constexpr int EPG = Elem<T>::EPG;
  const float alpha = ACT == 3 ? a.alpha[0] : 0.f;
  const int64_t e0 = (int64_t)blockIdx.x * a.seg, e1 = e0 + a.seg < a.n ? e0 + a.seg : a.n;
  for (int64_t row = blockIdx.y; row < a.rows; row += gridDim.y) {
    const float mean = a.stats[2 * row], rstd = a.stats[2 * row + 1];
    const float sc = a.scale ? a.scale[row] : 1.f, sh = a.shift ? a.shift[row] : 0.f;
    const auto f = [&](float v) {
      return Elem<T>::store(activate<ACT>(sc * ((v - mean) * rstd) + sh, alpha));
    };
    // y's aligned coordinates: 16-byte stores
    const int64_t o = (uint64_t)(a.off + row * a.n) % EPG;
    const T* const xb = a.x + row * a.n - o;
    T* const yb = a.y + row * a.n - o;
    const Piece p = piece<EPG>(o, e0, e1);
    for_groups<VEC>(xb, p, [&](int64_t k, const uint4& v) {
      uint4 w;
      T* const pw = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int j = 0; j < EPG; ++j) pw[j] = f(val<T>(v, j));
      *reinterpret_cast<uint4*>(yb + EPG * k) = w;
    });
    for_edges(xb, p, [&](int64_t e, float v) { yb[e] = f(v); });
  }
}

// The apply kernel for activation act, with x's groups as vectors or not.
template <class T>
using ApplyKernel = void (*)(const SlabArgs<T>);

template <class T>
ApplyKernel<T> slab_apply_kernel_of(int64_t act, bool vec) {
  switch (act) {
    case 1: return vec ? &slab_apply_kernel<T, 1, true> : &slab_apply_kernel<T, 1, false>;
    case 2: return vec ? &slab_apply_kernel<T, 2, true> : &slab_apply_kernel<T, 2, false>;
    case 3: return vec ? &slab_apply_kernel<T, 3, true> : &slab_apply_kernel<T, 3, false>;
    default: return vec ? &slab_apply_kernel<T, 0, true> : &slab_apply_kernel<T, 0, false>;
  }
}

// Elements from the 16-byte boundary at or below p to p.
template <class T>
int slab_off(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) % 16 / sizeof(T));
}

// Fills the cut of `a` and checks it; false if it does not cover every
// voxel of every row, or x is not aligned to its element size.
template <class T>
bool slab_cut(SlabArgs<T>& a, int64_t rows, int64_t n, int64_t seg, int64_t segs) {
  if (rows < 1 || n < 1 || seg < 8 || seg % 8 != 0 || segs < 1 || segs > (1 << 30) ||
      (segs - 1) * seg >= n || segs * seg < n ||
      reinterpret_cast<uintptr_t>(a.x) % sizeof(T) != 0)
    return false;
  a.rows = rows;
  a.n = n;
  a.seg = seg;
  a.segs = (int)segs;
  return true;
}

dim3 slab_grid(const int64_t rows, const int64_t segs) {
  return dim3((unsigned)segs, (unsigned)(rows < SLAB_ROWS_Y ? rows : SLAB_ROWS_Y));
}

template <class T>
int norm_stats_entry(const void* x, void* part, void* count, void* stats, int64_t rows,
                     int64_t n, int64_t seg, int64_t segs, void* stream) {
  SlabArgs<T> a{};
  a.x = static_cast<const T*>(x);
  a.part = static_cast<float*>(part);
  a.count = static_cast<unsigned*>(count);
  a.out = static_cast<double*>(stats);
  if (!slab_cut(a, rows, n, seg, segs)) return cudaErrorInvalidValue;
  a.off = slab_off<T>(x);
  slab_stats_kernel<T>
      <<<slab_grid(rows, segs), SLAB_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <class T>
int norm_apply_entry(const void* x, const void* stats, const void* scale, const void* shift,
                     const void* alpha, void* y, int64_t rows, int64_t n, int64_t act,
                     int64_t seg, int64_t segs, void* stream) {
  SlabArgs<T> a{};
  a.x = static_cast<const T*>(x);
  a.stats = static_cast<const float*>(stats);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.alpha = static_cast<const float*>(alpha);
  a.y = static_cast<T*>(y);
  if (act < 0 || act > 3 || !slab_cut(a, rows, n, seg, segs) ||
      reinterpret_cast<uintptr_t>(y) % sizeof(T) != 0)
    return cudaErrorInvalidValue;
  a.off = slab_off<T>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = slab_grid(rows, segs);
  const bool vec = slab_off<T>(x) == a.off;
  slab_apply_kernel_of<T>(act, vec)<<<grid, SLAB_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <class T>
const void* slab_kernel(int64_t half, int64_t act) {
  if (half == 0) return reinterpret_cast<const void*>(slab_stats_kernel<T>);
  return reinterpret_cast<const void*>(slab_apply_kernel_of<T>(act, true));
}

}  // namespace

// x [rows, n] bf16 (a slab of each row). stats receives [rows, 3] f64:
// (count, mean, M2) of each row. part: rows * segs * 3 floats of partials;
// count: rows 32-bit counters, zero at the call and left zero. Each of the
// segs segments of a row is seg voxels (a multiple of 8; the last may be
// shorter); the cut comes from ops/norm_act.py:slab_plan.
COMA_API int coma_norm_stats(const void* x, void* part, void* count, void* stats, int64_t rows,
                             int64_t n, int64_t seg, int64_t segs, void* stream) {
  return norm_stats_entry<bf16>(x, part, count, stats, rows, n, seg, segs, stream);
}

// coma_norm_stats's float32 form: x [rows, n] f32.
COMA_API int coma_norm_stats_f32(const void* x, void* part, void* count, void* stats,
                                 int64_t rows, int64_t n, int64_t seg, int64_t segs,
                                 void* stream) {
  return norm_stats_entry<float>(x, part, count, stats, rows, n, seg, segs, stream);
}

// x, y [rows, n] bf16; stats [rows, 2] f32 (mean, rstd); scale, shift [rows]
// f32 or null; alpha [1] f32 (read for prelu only); act as coma_norm_act's;
// the cut (seg, segs) from ops/norm_act.py:slab_plan.
COMA_API int coma_norm_apply(const void* x, const void* stats, const void* scale,
                             const void* shift, const void* alpha, void* y, int64_t rows,
                             int64_t n, int64_t act, int64_t seg, int64_t segs, void* stream) {
  return norm_apply_entry<bf16>(x, stats, scale, shift, alpha, y, rows, n, act, seg, segs,
                                stream);
}

// coma_norm_apply's float32 form: x, y [rows, n] f32.
COMA_API int coma_norm_apply_f32(const void* x, const void* stats, const void* scale,
                                 const void* shift, const void* alpha, void* y, int64_t rows,
                                 int64_t n, int64_t act, int64_t seg, int64_t segs,
                                 void* stream) {
  return norm_apply_entry<float>(x, stats, scale, shift, alpha, y, rows, n, act, seg, segs,
                                 stream);
}

// The CTAs of one slab half an SM holds on the current device: half 0 the
// statistics, 1 the apply with activation act; elem the element size (2
// bf16, 4 f32). Returns the count, or minus the CUDA error.
COMA_API int coma_slab_ctas_per_sm(int64_t half, int64_t act, int64_t elem) {
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, elem == 4 ? slab_kernel<float>(half, act) : slab_kernel<bf16>(half, act),
      SLAB_THREADS, 0);
  return err == cudaSuccess ? ctas : -(int)err;
}
