// KS: the H-parity split, x [B, C, D, H, W] -> (h0, h1), hp [B, C, D, H/2, W]
// with hp[..., i, :] = x[..., 2i + p, :]. A bit-exact copy for any element
// type: H is even, so the rows of W elements that x holds in order are
// (b, c, d, h) with h = 2i + p, and output row r of phase p is input row
// 2r + p.
//
// Replaces row #13 of the kernel table in PERF.md:
// coma_unet_tpu/ops/pallas/phase_split.py `pallas_hsplit` (`_hsplit_kernel`,
// which selects the phases on the TPU with strided sublane reads).
//
// What bounds it on the H100: memory. It reads x once and writes it once,
// with no arithmetic. Design: one thread per output vector of V bytes, V
// the widest of 16, 8, 4 or 2 that divides the row's bytes and both
// pointers' alignment, so rows whose width is a multiple of 8 bf16 move as
// 16-byte loads and stores. blockIdx.y is the phase; consecutive threads take
// consecutive vectors of one output row, so both sides coalesce. Element
// offsets are 64-bit. The entries are templated on the element type (bf16,
// and f32 for the float32 form, `coma_hsplit_f32`): both copy bits.
#include "common.cuh"

namespace {

using coma::cdiv;

constexpr int HS_THREADS = 256;

template <typename V>
__global__ void __launch_bounds__(HS_THREADS)
hsplit_kernel(const V* __restrict__ x, V* __restrict__ h0, V* __restrict__ h1, int64_t rows,
              int64_t vpr) {
  const int64_t i = (int64_t)blockIdx.x * HS_THREADS + threadIdx.x;
  if (i >= rows * vpr) return;
  const int64_t r = i / vpr, c = i % vpr;
  const int p = blockIdx.y;
  (p ? h1 : h0)[i] = x[(2 * r + p) * vpr + c];
}

template <typename V>
cudaError_t launch_hsplit(const void* x, void* h0, void* h1, int64_t rows, int64_t row_bytes,
                          cudaStream_t stream) {
  const int64_t vpr = row_bytes / (int64_t)sizeof(V);
  const dim3 grid((unsigned)cdiv(rows * vpr, HS_THREADS), 2);
  hsplit_kernel<V><<<grid, HS_THREADS, 0, stream>>>(static_cast<const V*>(x),
                                                     static_cast<V*>(h0), static_cast<V*>(h1),
                                                     rows, vpr);
  return cudaGetLastError();
}

// The split of rows of row_bytes bytes of T (bf16 or f32): the widest
// vector that divides the row and both pointers' alignment.
template <class T>
int hsplit_entry(const void* x, void* h0, void* h1, int64_t rows, int64_t row_bytes,
                 void* stream) {
  if (rows <= 0 || row_bytes <= 0 || row_bytes % (int64_t)sizeof(T) != 0)
    return cudaErrorInvalidValue;
  if (cdiv(rows * (row_bytes / 2), HS_THREADS) > 0x7fffffff) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(h0) |
                          reinterpret_cast<uintptr_t>(h1) | (uintptr_t)row_bytes;
  if (align % 16 == 0) return launch_hsplit<uint4>(x, h0, h1, rows, row_bytes, s);
  if (align % 8 == 0) return launch_hsplit<uint2>(x, h0, h1, rows, row_bytes, s);
  if (align % 4 == 0) return launch_hsplit<unsigned int>(x, h0, h1, rows, row_bytes, s);
  return launch_hsplit<unsigned short>(x, h0, h1, rows, row_bytes, s);
}

}  // namespace

// x holds 2 * rows rows of row_bytes bytes of bf16; h0 and h1 receive rows
// rows each.
COMA_API int coma_hsplit(const void* x, void* h0, void* h1, int64_t rows, int64_t row_bytes,
                         void* stream) {
  return hsplit_entry<coma::bf16>(x, h0, h1, rows, row_bytes, stream);
}

// coma_hsplit's float32 form: rows of row_bytes bytes of f32.
COMA_API int coma_hsplit_f32(const void* x, void* h0, void* h1, int64_t rows, int64_t row_bytes,
                             void* stream) {
  return hsplit_entry<float>(x, h0, h1, rows, row_bytes, stream);
}
