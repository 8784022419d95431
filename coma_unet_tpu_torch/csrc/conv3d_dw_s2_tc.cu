// KB2 on the tensor cores: the weight gradient of the stride-2 k=3
// convolution and, with the roles of its operands swapped, of the transposed
// stride-2 convolution:
//
//   M[cp, cf, t] = sum_p half[cp, p] * full[cf, 2p + s_t - 1],
//
// per sample or summed over the batch, with p over the positions of the
// half-resolution tensor (3-D), s_t in {0, 1, 2}^3 the offset of tap t (kd
// major) and `full` read as zero outside its bounds. Both are bf16 NCDHW:
// full [B, Cf, D, H, W], half [B, Cp, (D-1)/2+1, (H-1)/2+1, (W-1)/2+1], so
// odd sizes are allowed. M is f32 [Cp, Cf, 27] (shared) or [B, Cp, Cf, 27]
// (per sample), summed in f32. For the stride-2 conv (half = g, full = x) M
// is dW; for the transposed conv (half = x, full = g) dW is M with its two
// channel axes swapped and its taps flipped (done by the caller on these
// small tensors).
//
// Replaces, from coma_unet_tpu/ops/pallas/ (rows #16 and #17 of the kernel
// table in PERF.md): conv3d_strided.py `_dw_dil_v1` (`_dw_dil_kernel`) and
// `_dw_v2` (`_dw_kernel_v2`).
//
// What bounds it on the H100: bytes, barely. At the path's shape (Cf = 32,
// Cp = 64, per sample) 216^3 b=1 reads 645 MB of `full` and 161 MB of
// `half`, 0.241 ms at 3.35 TB/s, against 139 GFLOP, 0.141 ms of bf16
// tensor-core operations; each half position takes 27 x Cf x Cp products,
// so a design that does them on the CUDA cores is far from either. Against
// the operations, the products run on mma.sync and every staged value
// serves many of them (a `full` value all Cp channels of the taps that read
// it, a `half` value all 16 x 27 (cf, tap) pairs); against the bytes, each
// operand is staged once per 16 channels of `full` (the halo re-reads of
// neighbouring bricks hit L2), and the staging of brick i+1 overlaps the
// products of brick i.
//
// Design: KB1's per-tap GEMM over positions (conv3d_dw_tc.cu) on K2's
// stride-2 halo box (conv3d_s2_tc.cu),
//   D_t[cf, cp] += sum_{p in brick} full[cf, 2p + s_t - 1] * half[cp, p],
// on mma.sync m16n8k16 (bf16 operands, f32 sums): M = 16 channels of
// `full`, N = AT = 64 channels of `half` (narrower layers pad with zeros),
// K = half-resolution positions. A block owns 16 x 64 x 27 sums in
// registers: each of its 9 warps one (kd, kh) pair, its three kw taps and
// all 8 n-tiles (96 f32 a thread), so a warp's 4 ldmatrix of `half` serve 3
// taps and its 3 of `full` 8 n-tiles. It walks a run of bricks of
// BD x BH x BW = 2 x 4 x 16 half-resolution positions of one sample (BW is
// one k16 step, a brick 8 steps). Per brick it stages in shared memory
//  - K2's stride-2 halo box of `full` (tc_common.cuh:Box2, BoxStager):
//    5 x 9 x 33 positions x 16 channels, channels-last, zero outside the
//    volume, each axis split by parity, so tap offset s along an axis reads
//    box position q + shift(s, n) at unit stride: a tap is one row offset,
//    and the A operand is read with ldmatrix.trans as KB1 reads its X;
//  - the `half` tile [64][positions], positions contiguous, by cp.async
//    with zero fill past the volume and past Cp (KB1's G tile,
//    tc_common.cuh:GStager).
// The box is not staged through registers, as K2 and KB1 stage theirs:
// its 45 registers a thread, live across the products, made ptxas spill (9
// warps leave 168 registers a thread, 3 warps sharing an SM
// sub-partition). Instead one thread copies the brick's box rows in their
// own NCDHW order, 16 channels x 5 x 9 rows x 32 positions (46,080 bytes),
// into a raw buffer with one TMA copy (cp.async.bulk.tensor, zero-filled
// outside the volume and past C, completing on an mbarrier); every thread
// copies its share of the tile by cp.async. Per brick i the block
// transposes brick i's raw rows from shared memory into the box, a
// barrier, issues brick i+2's copies into the raw buffer just read, and
// computes brick i: the copies have two bricks' products to land in. The
// box's first position along W (full w0, one before the raw rows) of each
// row is the last position of the brick before it, which the transpose
// passes on; only a run's first brick copies it (4 bytes by cp.async). A W
// or a pointer that TMA cannot take (W % 8 != 0) loads the raw rows with
// 2-byte loads instead. The box has one buffer, raw rows two, tiles three:
// 2 x (46,080 + 2,880) + 71,280 + 3 x 17,408 + 2 mbarriers = 221,440
// bytes, one block an SM, two barriers a brick. (Development runs at
// 216^3 on an H100: the box staged through registers by the MMA warps,
// 2.2 ms; by three loader warps beside them, 2.1; raw rows by every
// thread's cp.async, 1.9, and 1.34 once the first positions were passed
// on instead of copied, a 32-byte sector for 4 bytes; by TMA, 0.94-1.0.)
//
// Split-K: the bricks of each sample are cut into runs (a split never
// straddles two samples); each split writes its partial M to the f32
// workspace and dw_reduce.cuh sums the partials in split order: no float
// atomics, bit-identical results from run to run. The cut is chosen in
// Python (ops/conv3d_strided.py:sdw_plan). In-plane offsets are 32-bit (the
// entry checks D * H * W < 2^31), sample and channel offsets 64-bit.
#include <cuda.h>  // CUtensorMap

#include "dw_reduce.cuh"
#include "tc_common.cuh"

namespace {

using namespace coma;

constexpr int BD = 2, BH = 4, BW = 16;  // brick of half positions; BW is one k16 step
constexpr int CT = 16, AT = 64;         // channels of `full` (m16) and of `half` (n) per block
constexpr int TAPS = 27;
constexpr int WARPS = 9, THREADS = 32 * WARPS;  // a warp per (kd, kh)

struct Sdw : Box2<BD, BH, THREADS> {
  static constexpr int J = 1, MT = CT / 16, NT = AT / 8;
  static constexpr int STEPS = BD * BH, KB = STEPS * BW, GS = padded(KB);  // k16 steps, positions
  static constexpr int ATILE = AT, BWID = BW, BHGT = BH;
  static constexpr int NG = (AT * 2 * STEPS + THREADS - 1) / THREADS;
  static constexpr int GELEMS = AT * GS;
  // the raw box: [CT channels][HROWS box rows][2 BW positions after the
  // box's first] (a TMA box of `full`, dense); beside it the first
  // positions [CT][HROWS], 4 bytes each (box positions -1 and 0)
  static constexpr int ROWS = CT * HROWS, RAWCH = HROWS * 2 * BW, RAW = CT * RAWCH;
  static constexpr int NE = (ROWS + THREADS - 1) / THREADS;
  // shared memory: two raw boxes (TMA wants 128-byte aligned boxes), two
  // first-position arrays, the box, three tiles, two mbarriers
  static constexpr int FIRSTS = 2 * RAW * 2, BOX = FIRSTS + 2 * ROWS * 4;
  static constexpr int TILES = BOX + XELEMS * 2, MBARS = TILES + 3 * GELEMS * 2;
  static constexpr int SMEM = MBARS + 2 * 8;
  // kw tap tw reads the parity-split row at shift(tw, BW)
  __host__ __device__ static constexpr int kwoff(int tw) { return shift(tw, BW); }
  static_assert(SMEM <= 227 * 1024 && HRSTEP * NX == HROWS && RAW * 2 % 128 == 0 &&
                    BOX % 16 == 0 && TILES % 16 == 0 && MBARS % 8 == 0, "tiles");
};

struct SdwArgs {
  const bf16* full;
  const bf16* half;
  float* ws;
  int C, D, H, W;  // full: channels and sizes; plane = D * H * W < 2^31
  int64_t plane;
  struct {         // half: channels and sizes
    int A, D, H, W;
    int64_t plane;
  } g;
  int nbh, nbw;          // bricks along H and W of half
  int64_t nb, bps, sps;  // bricks per sample, per split; splits per sample
};

// mbarriers and the TMA copy of the raw box.
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

// The raw box of brick origin (d0, h0, w0) of full (box positions 1 .. 2 BW
// along W: full w0 + 1 ..), one TMA copy completing on bar; zero outside
// the volume and past C. Issued by one thread.
__device__ __forceinline__ void tma_raw(uint32_t dst, const CUtensorMap& tmap, uint32_t bar,
                                        int c0, int d0, int h0, int w0, int b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(Sdw::RAW * 2)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&tmap)), "r"(w0 + 1), "r"(h0), "r"(d0), "r"(c0), "r"(b),
      "r"(bar)
      : "memory");
}

// The same by 2-byte loads, for a W or a pointer that TMA cannot take.
__device__ __forceinline__ void load_raw(bf16* raw, const SdwArgs& p, const bf16* xb, int c0,
                                         int d0, int h0, int w0, int tid) {
  for (int i = tid; i < Sdw::ROWS * 4; i += THREADS) {
    const int c = i / 4 / Sdw::HROWS, hr = i / 4 % Sdw::HROWS, w = w0 + 1 + 8 * (i % 4);
    const int d = d0 + hr / Sdw::HH, h = h0 + hr % Sdw::HH;
    const bool ok = c0 + c < p.C && (unsigned)d < (unsigned)p.D && (unsigned)h < (unsigned)p.H;
    const bf16* src = xb + (ok ? (c0 + c) * p.plane + (d * p.H + h) * p.W : 0);
    *reinterpret_cast<uint4*>(raw + c * Sdw::RAWCH + hr * 2 * BW + 8 * (i % 4)) =
        ok ? ld_row8<1>(src, w, p.W) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The first positions (full w0 - 1, w0) of the raw box's rows into first,
// zero outside the volume and past C: by cp.async (VX = 8) or 2-byte loads.
template <int VX>
__device__ __forceinline__ void load_first(bf16* first, const SdwArgs& p, const bf16* xb,
                                           int c0, int d0, int h0, int w0, int tid) {
#pragma unroll
  for (int j = 0; j < Sdw::NE; ++j) {
    const int row = tid + j * THREADS;
    const int c = row / Sdw::HROWS, hr = row % Sdw::HROWS;
    const int d = d0 + hr / Sdw::HH, h = h0 + hr % Sdw::HH;
    const bool ok = row < Sdw::ROWS && c0 + c < p.C && w0 > 0 && (unsigned)d < (unsigned)p.D &&
                    (unsigned)h < (unsigned)p.H;
    const bf16* src = xb + (ok ? (c0 + c) * p.plane + (d * p.H + h) * p.W + w0 - 1 : 0);
    if (row < Sdw::ROWS) {
      if constexpr (VX == 8)
        cp_async4(smem_u32(first + 2 * row), src, ok);
      else
        reinterpret_cast<uint32_t*>(first)[row] = ok ? ld_u16(src + 1) << 16 : 0u;
    }
  }
}

// The raw box (and its first positions) -> the channels-last, parity-split
// box. The next brick's first positions are this brick's last ones (box
// position 2 BW) when it follows along W, else zero (its box starts at
// w = -1): they go to next_first, so only a run's first brick copies them.
__device__ __forceinline__ void raw_to_box(const bf16* raw, const bf16* first,
                                           const BoxStager<Sdw>& st, bf16* box,
                                           bf16* next_first, bool follows) {
  const uint32_t* e = reinterpret_cast<const uint32_t*>(first) + 2 * st.cp * Sdw::HROWS;
  uint32_t* ne = reinterpret_cast<uint32_t*>(next_first) + 2 * st.cp * Sdw::HROWS;
#pragma unroll
  for (int i = 0; i < Sdw::NX; ++i) {
    const int hr = st.hr0 + i * Sdw::HRSTEP;
    const bf16* r = raw + 2 * st.cp * Sdw::RAWCH + hr * 2 * BW + 8 * st.v;
    const uint4 a = *reinterpret_cast<const uint4*>(r);
    const uint4 b = *reinterpret_cast<const uint4*>(r + Sdw::RAWCH);
    const uint32_t e0 = st.v == 0 ? __byte_perm(e[hr], e[hr + Sdw::HROWS], 0x7632) : 0u;
    st.store_row(hr, a, b, e0, box);
    if (st.v == 2 * BW / 8 - 1 && next_first != nullptr) {  // the piece that ends the row
      ne[hr] = follows ? a.w & 0xffff0000u : 0u;
      ne[hr + Sdw::HROWS] = follows ? b.w & 0xffff0000u : 0u;
    }
  }
}

template <int VX, int VG>
__global__ void __launch_bounds__(THREADS, 1)
    conv3d_dw_s2_tc_kernel(const SdwArgs p, const __grid_constant__ CUtensorMap tmap) {
  using Cf = Sdw;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const raws = reinterpret_cast<bf16*>(smem);                   // two raw boxes
  bf16* const firsts = reinterpret_cast<bf16*>(smem + Cf::FIRSTS);    // their first positions
  bf16* const box = reinterpret_cast<bf16*>(smem + Cf::BOX);
  bf16* const tiles = reinterpret_cast<bf16*>(smem + Cf::TILES);      // three tiles of half
  const uint32_t mbars = smem_u32(smem + Cf::MBARS);                  // one a raw box
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * CT, a0 = blockIdx.y * AT;
  const int64_t split_ = blockIdx.z, b = split_ / p.sps;
  const int64_t bi0 = split_ % p.sps * p.bps;
  const int n = (int)((bi0 + p.bps < p.nb ? bi0 + p.bps : p.nb) - bi0);  // bricks of the run
  const bf16* const xb = p.full + b * p.C * p.plane;
  const bf16* const gb = p.half + b * p.g.A * p.g.plane;
  // the transpose's thread: lanes 0-7 of a warp take channel pairs 0-1 x the
  // 4 pieces, so their 16-byte reads of the raw box fall in distinct banks
  const BoxStager<Cf> st(p, xb, c0,
                         (tid & ~31) | ((lane >> 2) & 1) | ((lane >> 3) << 1) | ((lane & 3) << 3));
  const GStager<Cf> gst(tid);

  const int td = warp / 3, th = warp % 3;
  // ldmatrix: lane l addresses row l % 8 of 8 x 8 matrix l / 8, as in KB1: A
  // is stored [position][channel] (read transposed), B [cp][position].
  const int lrow = ((lane >> 4) << 3) + (lane & 7), lcol = ((lane >> 3) & 1) * 8;
  const uint32_t a_lane = (lrow * Cf::XS + lcol) * 2;
  const uint32_t b_lane = (lrow * Cf::GS + lcol) * 2;
  float acc[3][Cf::MT][Cf::NT][4];
#pragma unroll
  for (int tw = 0; tw < 3; ++tw)
#pragma unroll
    for (int j = 0; j < Cf::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[tw][0][j][r] = 0.f;

  // the next brick to stage (half positions); bricks in order, w fastest
  int w0 = (int)(bi0 % p.nbw) * BW, h0 = (int)(bi0 / p.nbw % p.nbh) * BH;
  int d0 = (int)(bi0 / ((int64_t)p.nbw * p.nbh)) * BD;
  auto issue = [&](int k) {  // brick k's tile, raw box and first positions
    bf16* const raw = raws + (k & 1) * Cf::RAW;
    bf16* const first = firsts + (k & 1) * 2 * Cf::ROWS;
    gst.template load_g<VG>(tiles + k % 3 * Cf::GELEMS, p.g, gb, a0, d0, h0, w0);
    if constexpr (VX == 8) {
      if (tid == 0) {  // the async proxy next writes what the generic proxy read
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        tma_raw(smem_u32(raw), tmap, mbars + (k & 1) * 8, c0, 2 * d0 - 1, 2 * h0 - 1,
                2 * w0 - 1, (int)b);
      }
    } else {
      load_raw(raw, p, xb, c0, 2 * d0 - 1, 2 * h0 - 1, 2 * w0 - 1, tid);
    }
    if (k == 0) load_first<VX>(first, p, xb, c0, 2 * d0 - 1, 2 * h0 - 1, 2 * w0 - 1, tid);
    cp_async_commit();
    w0 += BW;
    if (w0 >= p.g.W) {
      w0 = 0;
      h0 += BH;
      if (h0 >= p.g.H) {
        h0 = 0;
        d0 += BD;
      }
    }
  };
  // brick k + 2 is issued once brick k's raw box is transposed, so its
  // loads have two bricks' products to land in
  if (tid == 0) {
    mbar_init(mbars);
    mbar_init(mbars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n > 0) issue(0);
  if (n > 1) issue(1);
  int kw0 = (int)(bi0 % p.nbw) * BW;  // brick k's origin along W (half positions)
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n)
      cp_async_wait_one();
    else
      cp_async_wait_all();
    if constexpr (VX == 8)
      while (!mbar_try_wait(mbars + (k & 1) * 8, (k >> 1) & 1)) {
      }
    __syncthreads();  // brick k has landed; brick k - 1's products are done
    kw0 = k == 0 ? kw0 : kw0 + BW < p.g.W ? kw0 + BW : 0;
    raw_to_box(raws + (k & 1) * Cf::RAW, firsts + (k & 1) * 2 * Cf::ROWS, st, box,
               k + 1 < n ? firsts + ((k + 1) & 1) * 2 * Cf::ROWS : nullptr, kw0 + BW < p.g.W);
    __syncthreads();  // brick k's box is stored and its raw box read
    if (k + 2 < n) issue(k + 2);
    // the warp's (kd, kh) taps as row offsets of the parity-split box
    mma_brick<Cf, 3>(acc, smem_u32(box), smem_u32(tiles + k % 3 * Cf::GELEMS), a_lane, b_lane,
                     b_lane, shift(td, BD), shift(th, BH), 0);
  }

  // c[0..1] of an m16n8 tile: row (cf) lane / 4, cols (cp) 2 (lane % 4) +
  // {0, 1}; c[2..3]: row lane / 4 + 8.
  float* const out = p.ws + split_ * p.g.A * p.C * TAPS;
#pragma unroll
  for (int tw = 0; tw < 3; ++tw)
#pragma unroll
    for (int j = 0; j < Cf::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = c0 + (lane >> 2) + (r >> 1) * 8;
        const int a = a0 + j * 8 + (lane & 3) * 2 + (r & 1);
        if (c < p.C && a < p.g.A)
          out[((int64_t)a * p.C + c) * TAPS + (td * 3 + th) * 3 + tw] = acc[tw][0][j][r];
      }
}

template <int VX, int VG>
cudaError_t launch(const SdwArgs& p, const CUtensorMap& tmap, int64_t B, int64_t per_sample,
                   float* out, cudaStream_t stream) {
  const auto kernel = conv3d_dw_s2_tc_kernel<VX, VG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sdw::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)cdiv(p.C, CT), (unsigned)cdiv(p.g.A, AT), (unsigned)(B * p.sps));
  kernel<<<grid, THREADS, Sdw::SMEM, stream>>>(p, tmap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_reduce(p.ws, out, (int64_t)p.g.A * p.C * TAPS, B, p.sps, per_sample, stream);
}

// The TMA descriptor of full [B, C, D, H, W] (W % 8 == 0, 16-byte aligned)
// with boxes of the raw box's shape, through cuTensorMapEncodeTiled
// (looked up by cudaGetDriverEntryPoint, so the library needs no -lcuda).
cudaError_t encode_full(CUtensorMap* tmap, const void* full, int64_t B, int64_t C, int64_t D,
                        int64_t H, int64_t W) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[5] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)C,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)W * 2, (cuuint64_t)(H * W) * 2,
                                 (cuuint64_t)(D * H * W) * 2, (cuuint64_t)(C * D * H * W) * 2};
  const cuuint32_t box[5] = {2 * BW, Sdw::HH, Sdw::HD, CT, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(full),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// KB2. full [B, Cf, D, H, W] bf16 (D * H * W < 2^31), half [B, Cp, (D-1)/2+1,
// (H-1)/2+1, (W-1)/2+1] bf16; out f32 M [Cp, Cf, 27] or, with per_sample,
// [B, Cp, Cf, 27]. The cut comes from ops/conv3d_strided.py:sdw_plan: ct =
// 16 channels of full and at = 64 of half per block, the brick (bd, bh, bw)
// = (2, 4, 16) half positions and bps bricks per split; ws holds B *
// ceil(bricks / bps) * Cp * Cf * 27 floats. full's raw rows come by TMA
// and half's tiles by 16- or 8-byte cp.async where W % 8 == 0 and the
// pointers allow it, else both by 2-byte loads.
COMA_API int coma_conv3d_strided_dw(const void* full, const void* half, void* ws, void* out,
                                    int64_t B, int64_t Cf, int64_t Cp, int64_t D, int64_t H,
                                    int64_t W, int64_t per_sample, int64_t ct, int64_t at,
                                    int64_t bd, int64_t bh, int64_t bw, int64_t bps,
                                    void* stream) {
  if (B <= 0 || Cf <= 0 || Cp <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      D * H * W >= (int64_t(1) << 31) || ct != CT || at != AT || bd != BD || bh != BH ||
      bw != BW || bps <= 0 || cdiv(Cf, CT) > 65535 || cdiv(Cp, AT) > 65535)
    return cudaErrorInvalidValue;
  SdwArgs p;
  p.full = static_cast<const bf16*>(full);
  p.half = static_cast<const bf16*>(half);
  p.ws = static_cast<float*>(ws);
  p.C = (int)Cf;
  p.D = (int)D;
  p.H = (int)H;
  p.W = (int)W;
  p.plane = D * H * W;
  p.g.A = (int)Cp;
  p.g.D = (int)((D - 1) / 2 + 1);
  p.g.H = (int)((H - 1) / 2 + 1);
  p.g.W = (int)((W - 1) / 2 + 1);
  p.g.plane = (int64_t)p.g.D * p.g.H * p.g.W;
  p.nbh = (int)cdiv(p.g.H, BH);
  p.nbw = (int)cdiv(p.g.W, BW);
  p.nb = cdiv(p.g.D, BD) * p.nbh * p.nbw;
  p.bps = bps;
  p.sps = cdiv(p.nb, bps);
  if (B * p.sps > 65535) return cudaErrorInvalidValue;
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t fa = reinterpret_cast<uintptr_t>(full), ha = reinterpret_cast<uintptr_t>(half);
  CUtensorMap tmap = {};
  const bool vx = W % 8 == 0 && fa % 16 == 0 && p.g.W % 4 == 0 && ha % 8 == 0;
  if (vx) {
    const cudaError_t err = encode_full(&tmap, full, B, Cf, D, H, W);
    if (err != cudaSuccess) return err;
  }
  if (vx && p.g.W % 8 == 0 && ha % 16 == 0) return launch<8, 8>(p, tmap, B, per_sample, o, s);
  if (vx) return launch<8, 4>(p, tmap, B, per_sample, o, s);
  return launch<1, 1>(p, tmap, B, per_sample, o, s);
}
