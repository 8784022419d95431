// The native NIfTI reader of the port: NIfTI-1 decode, nearest-neighbour
// resample to a target spacing, center pad/crop, and a batch of files on a
// pool of threads. Bound with ctypes by `runtime/native.py`; the calls run
// outside Python's interpreter lock.
//
// The same reading as the numpy reader (`io/volume.py:load_nifti_vol` then
// `ops/preprocess.py:center_pad_crop`):
//   * any NIfTI-1 datatype the numpy reader takes, either byte order, gzip
//     or not, scl_slope/scl_inter applied in float32 when not (1 or 0, 0);
//   * the resampled size is round(n * (spacing / new_spacing)), halves to
//     even as numpy rounds; output index i reads input index
//     floor(i * (new_spacing / spacing) + 0.5), and 0 where that is past the
//     input;
//   * NaN -> 0, +-inf -> the largest finite float32 (numpy's nan_to_num);
//   * center pad with zeros, or crop, each axis to the target.
// Arrays are float32 (z, y, x), x fastest: the file's own order.
//
// zlib is reached through the three functions it exports for gzip files,
// declared here, so no zlib header is needed to build; the library links
// the zlib that Python itself loads.

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

extern "C" {
typedef struct gzFile_s* gzFile;
gzFile gzopen(const char* path, const char* mode);
int gzread(gzFile file, void* buf, unsigned len);
int gzclose(gzFile file);
}

namespace {

constexpr size_t kHeaderBytes = 348;

struct Volume {
  std::vector<float> data;  // (z, y, x), x fastest
  int64_t nx = 0, ny = 0, nz = 0;
  double sx = 1.0, sy = 1.0, sz = 1.0;  // spacing (x, y, z), mm
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  size_t n = strlen(path);
  if (n > 3 && strcmp(path + n - 3, ".gz") == 0) {
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    out.clear();
    std::vector<uint8_t> buf(1 << 20);
    int r;
    while ((r = gzread(f, buf.data(), static_cast<unsigned>(buf.size()))) > 0)
      out.insert(out.end(), buf.data(), buf.data() + r);
    gzclose(f);
    return r == 0;
  }
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long size = ok ? ftell(f) : -1;
  ok = ok && size >= 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    out.resize(static_cast<size_t>(size));
    ok = fread(out.data(), 1, out.size(), f) == out.size();
  }
  fclose(f);
  return ok;
}

// The T at `p`, in the file's byte order.
template <typename T>
T get(const uint8_t* p, bool swap) {
  uint8_t b[sizeof(T)];
  memcpy(b, p, sizeof(T));
  if (swap)
    for (size_t i = 0; i < sizeof(T) / 2; ++i) std::swap(b[i], b[sizeof(T) - 1 - i]);
  T v;
  memcpy(&v, b, sizeof(T));
  return v;
}

template <typename T>
void decode(const uint8_t* src, int64_t n, bool swap, bool scale, float slope,
            float inter, float* dst) {
  for (int64_t i = 0; i < n; ++i) {
    float v = static_cast<float>(get<T>(src + i * sizeof(T), swap));
    dst[i] = scale ? v * slope + inter : v;
  }
}

bool load_nifti(const char* path, Volume& v) {
  std::vector<uint8_t> raw;
  if (!read_file(path, raw) || raw.size() < kHeaderBytes) return false;
  const uint8_t* h = raw.data();
  bool swap = false;
  if (get<int32_t>(h, false) != 348) {
    if (get<int32_t>(h, true) != 348) return false;
    swap = true;
  }
  if (memcmp(h + 344, "n+1\0", 4) != 0 && memcmp(h + 344, "ni1\0", 4) != 0)
    return false;
  int16_t dim[8];
  for (int i = 0; i < 8; ++i) dim[i] = get<int16_t>(h + 40 + 2 * i, swap);
  if (dim[0] < 3 || dim[0] > 7) return false;
  for (int i = 1; i <= 3; ++i)
    if (dim[i] <= 0) return false;
  for (int i = 4; i <= dim[0]; ++i)  // one volume: any further dim is 1
    if (dim[i] != 1) return false;
  int16_t datatype = get<int16_t>(h + 70, swap);
  float pixdim[4];
  for (int i = 0; i < 4; ++i) pixdim[i] = get<float>(h + 76 + 4 * i, swap);
  float vox_offset = get<float>(h + 108, swap);
  float slope = get<float>(h + 112, swap);
  float inter = get<float>(h + 116, swap);
  v.nx = dim[1];
  v.ny = dim[2];
  v.nz = dim[3];
  v.sx = std::fabs(pixdim[1]);
  v.sy = std::fabs(pixdim[2]);
  v.sz = std::fabs(pixdim[3]);
  int64_t n = v.nx * v.ny * v.nz;
  size_t elem;
  switch (datatype) {
    case 2: case 256: elem = 1; break;
    case 4: case 512: elem = 2; break;
    case 8: case 16: case 768: elem = 4; break;
    case 64: case 1024: case 1280: elem = 8; break;
    default: return false;
  }
  if (!(vox_offset >= 0.f)) return false;
  size_t off = static_cast<size_t>(vox_offset);
  if (raw.size() < off || raw.size() - off < static_cast<size_t>(n) * elem)
    return false;
  bool scale = !(slope == 0.f || slope == 1.f) || inter != 0.f;
  if (slope == 0.f) slope = 1.f;
  v.data.resize(n);
  const uint8_t* src = raw.data() + off;
  float* dst = v.data.data();
  switch (datatype) {
    case 2: decode<uint8_t>(src, n, swap, scale, slope, inter, dst); break;
    case 4: decode<int16_t>(src, n, swap, scale, slope, inter, dst); break;
    case 8: decode<int32_t>(src, n, swap, scale, slope, inter, dst); break;
    case 16: decode<float>(src, n, swap, scale, slope, inter, dst); break;
    case 64: decode<double>(src, n, swap, scale, slope, inter, dst); break;
    case 256: decode<int8_t>(src, n, swap, scale, slope, inter, dst); break;
    case 512: decode<uint16_t>(src, n, swap, scale, slope, inter, dst); break;
    case 768: decode<uint32_t>(src, n, swap, scale, slope, inter, dst); break;
    case 1024: decode<int64_t>(src, n, swap, scale, slope, inter, dst); break;
    case 1280: decode<uint64_t>(src, n, swap, scale, slope, inter, dst); break;
  }
  for (float& x : v.data) {
    if (std::isnan(x)) x = 0.f;
    else if (std::isinf(x)) x = x > 0 ? FLT_MAX : -FLT_MAX;
  }
  return true;
}

// Input index of output index i, or -1 past the input.
std::vector<int64_t> nearest_indices(int64_t n_out, double ratio, int64_t n) {
  std::vector<int64_t> idx(n_out);
  for (int64_t i = 0; i < n_out; ++i) {
    int64_t j = static_cast<int64_t>(std::floor(i * ratio + 0.5));
    idx[i] = (j >= 0 && j < n) ? j : -1;
  }
  return idx;
}

void resample(const Volume& v, double ns, Volume& out) {
  // std::nearbyint rounds halves to even in the default rounding mode
  auto size = [ns](int64_t n, double s) {
    return static_cast<int64_t>(std::nearbyint(n * (s / ns)));
  };
  out.nx = size(v.nx, v.sx);
  out.ny = size(v.ny, v.sy);
  out.nz = size(v.nz, v.sz);
  out.sx = out.sy = out.sz = ns;
  out.data.assign(out.nx * out.ny * out.nz, 0.f);
  auto xi = nearest_indices(out.nx, ns / v.sx, v.nx);
  auto yi = nearest_indices(out.ny, ns / v.sy, v.ny);
  auto zi = nearest_indices(out.nz, ns / v.sz, v.nz);
  for (int64_t z = 0; z < out.nz; ++z) {
    if (zi[z] < 0) continue;
    for (int64_t y = 0; y < out.ny; ++y) {
      if (yi[y] < 0) continue;
      const float* row = v.data.data() + (zi[z] * v.ny + yi[y]) * v.nx;
      float* orow = out.data.data() + (z * out.ny + y) * out.nx;
      for (int64_t x = 0; x < out.nx; ++x)
        if (xi[x] >= 0) orow[x] = row[xi[x]];
    }
  }
}

// Center pad (zeros) or crop each axis of `v` to (tz, ty, tx) into `out`.
void pad_crop(const Volume& v, int64_t tz, int64_t ty, int64_t tx, float* out) {
  memset(out, 0, sizeof(float) * tz * ty * tx);
  auto span = [](int64_t n, int64_t t, int64_t& src, int64_t& dst, int64_t& len) {
    src = n < t ? 0 : (n - t) / 2;
    dst = n < t ? (t - n) / 2 : 0;
    len = n < t ? n : t;
  };
  int64_t sz, dz, lz, sy, dy, ly, sx, dx, lx;
  span(v.nz, tz, sz, dz, lz);
  span(v.ny, ty, sy, dy, ly);
  span(v.nx, tx, sx, dx, lx);
  for (int64_t z = 0; z < lz; ++z)
    for (int64_t y = 0; y < ly; ++y)
      memcpy(out + ((dz + z) * ty + dy + y) * tx + dx,
             v.data.data() + ((sz + z) * v.ny + sy + y) * v.nx + sx,
             sizeof(float) * lx);
}

// One file -> `out` [tz, ty, tx]: read, resample to `new_spacing` mm when
// `resize`, center pad/crop. Returns 0 on success, 1 if the file cannot be
// read or is not a NIfTI-1 volume this reader takes.
int load_one(const char* path, float* out, int64_t tz, int64_t ty, int64_t tx,
             double new_spacing, int resize) {
  Volume v;
  if (!load_nifti(path, v)) return 1;
  if (resize) {
    Volume r;
    resample(v, new_spacing, r);
    pad_crop(r, tz, ty, tx, out);
  } else {
    pad_crop(v, tz, ty, tx, out);
  }
  return 0;
}

}  // namespace

extern "C" {

// `n` files (`paths` holds n NUL-terminated strings back to back) -> `out`
// [n, tz, ty, tx] on `num_threads` threads (0: one per core, at most n);
// status[i] is 0 where file i was read, 1 where it cannot be read or is not
// a NIfTI-1 volume this reader takes. Returns the number of failures.
int coma_nifti_load_batch(const char* paths, int64_t n, float* out,
                          int32_t* status, int64_t tz, int64_t ty, int64_t tx,
                          double new_spacing, int resize, int num_threads) {
  std::vector<const char*> ptrs(n);
  for (int64_t i = 0; i < n; ++i) {
    ptrs[i] = paths;
    paths += strlen(paths) + 1;
  }
  int64_t nt = num_threads > 0 ? num_threads : std::thread::hardware_concurrency();
  nt = std::max<int64_t>(1, std::min<int64_t>(nt, n));
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);
  auto work = [&]() {
    for (int64_t i; (i = next.fetch_add(1)) < n;) {
      status[i] = load_one(ptrs[i], out + i * tz * ty * tx, tz, ty, tx,
                           new_spacing, resize);
      if (status[i] != 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 1; t < nt; ++t) threads.emplace_back(work);
  work();
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
