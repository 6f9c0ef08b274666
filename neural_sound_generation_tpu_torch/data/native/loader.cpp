// Native data-loader runtime: mmap-backed .npy corpus with GIL-free
// batch assembly.
//
// TPU-native counterpart of the reference's DataLoader worker processes
// (src/dataloader.py:475: num_workers + pin_memory): instead of fork+pickle
// fan-out, every preprocessed shard (.npy written by the preprocess
// pipeline, src/preprocess.py semantics) is mmap'd once at corpus open —
// page cache shared, headers parsed a single time — and batches are
// assembled by memcpy straight into caller-provided buffers. Called
// through ctypes, these fills run with the GIL released, so Python-side
// prefetch threads overlap with device compute even under one process.
//
// Crop/pad semantics mirror data/collate.py::collate_mel_batch exactly
// (hop-aligned crops, zero-padded mels, pad_value-padded audio); the
// Python binding keeps sampler order and RNG draws so native batches are
// bit-identical to the pure-Python path.
//
// C ABI only — bound via ctypes (no pybind11 in this environment).

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

enum class Dtype { F32, I16, I32, I64 };

struct NpyArray {
  void* map = nullptr;        // whole-file mapping
  size_t map_len = 0;
  const char* data = nullptr; // first element
  Dtype dtype = Dtype::F32;
  int64_t shape[2] = {0, 0};
  int ndim = 0;

  int64_t rows() const { return shape[0]; }
  int64_t cols() const { return ndim == 2 ? shape[1] : 1; }
  size_t elem_size() const {
    switch (dtype) {
      case Dtype::I16: return 2;
      case Dtype::F32: case Dtype::I32: return 4;
      case Dtype::I64: return 8;
    }
    return 4;
  }
};

// Minimal .npy parser: v1.0/v2.0 headers as written by np.save —
// little-endian C-order scalars, 1-D or 2-D.
bool parse_npy(const char* path, NpyArray* out, std::string* err) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) {
    *err = std::string("open failed: ") + path + ": " + strerror(errno);
    return false;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 10) {
    ::close(fd);
    *err = std::string("stat failed or file too small: ") + path;
    return false;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);  // mapping persists without the fd
  if (map == MAP_FAILED) {
    *err = std::string("mmap failed: ") + path;
    return false;
  }
  const unsigned char* p = static_cast<const unsigned char*>(map);
  if (memcmp(p, "\x93NUMPY", 6) != 0) {
    munmap(map, st.st_size);
    *err = std::string("not a .npy file: ") + path;
    return false;
  }
  int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    if (st.st_size < 12) {
      munmap(map, st.st_size);
      *err = std::string("truncated v2 header: ") + path;
      return false;
    }
    header_len = p[8] | (p[9] << 8) | (size_t(p[10]) << 16) | (size_t(p[11]) << 24);
    header_off = 12;
  }
  // bound the header against the mapped size BEFORE touching it — a
  // truncated/corrupt shard must surface as an error (and the Python
  // fallback), not a SIGBUS past the last mapped page
  if (header_len > size_t(st.st_size) - header_off) {
    munmap(map, st.st_size);
    *err = std::string("header overruns file: ") + path;
    return false;
  }
  std::string header(reinterpret_cast<const char*>(p) + header_off, header_len);

  auto find_value = [&](const char* key) -> std::string {
    size_t k = header.find(key);
    if (k == std::string::npos) return "";
    size_t c = header.find(':', k);
    return c == std::string::npos ? "" : header.substr(c + 1);
  };

  std::string descr = find_value("'descr'");
  if (descr.find("'<f4'") != std::string::npos) out->dtype = Dtype::F32;
  else if (descr.find("'<i2'") != std::string::npos) out->dtype = Dtype::I16;
  else if (descr.find("'<i4'") != std::string::npos) out->dtype = Dtype::I32;
  else if (descr.find("'<i8'") != std::string::npos) out->dtype = Dtype::I64;
  else {
    munmap(map, st.st_size);
    *err = std::string("unsupported dtype in ") + path + ": " + header;
    return false;
  }
  if (find_value("'fortran_order'").find("True") != std::string::npos) {
    munmap(map, st.st_size);
    *err = std::string("fortran order unsupported: ") + path;
    return false;
  }
  std::string shape = find_value("'shape'");
  size_t open_paren = shape.find('(');
  size_t close_paren = shape.find(')');
  if (open_paren == std::string::npos || close_paren == std::string::npos) {
    munmap(map, st.st_size);
    *err = std::string("bad shape in header: ") + path;
    return false;
  }
  std::string dims = shape.substr(open_paren + 1, close_paren - open_paren - 1);
  out->ndim = 0;
  const char* s = dims.c_str();
  while (*s && out->ndim < 2) {
    while (*s && !isdigit(*s)) s++;
    if (!*s) break;
    out->shape[out->ndim++] = strtoll(s, const_cast<char**>(&s), 10);
  }
  if (out->ndim == 0) {
    munmap(map, st.st_size);
    *err = std::string("scalar npy unsupported: ") + path;
    return false;
  }
  // reject leftover dims: silently truncating a (N, T, C) shard to
  // (N, T) would serve interleaved channel samples as a mono stream
  // (the truncation size check still passes — the file is LARGER)
  while (*s && !isdigit(*s)) s++;
  if (*s) {
    munmap(map, st.st_size);
    *err = std::string("npy with >2 dims unsupported: ") + path;
    return false;
  }
  out->map = map;
  out->map_len = st.st_size;
  out->data = reinterpret_cast<const char*>(p) + header_off + header_len;
  // overflow-safe size math: a corrupt/malicious header with huge dims
  // must surface as "truncated", not wrap the multiplication and pass
  size_t rows_cols = 0, need = 0, end = 0;
  bool bogus = out->rows() < 0 || out->cols() < 0 ||
               __builtin_mul_overflow(size_t(out->rows()),
                                      size_t(out->cols()), &rows_cols) ||
               __builtin_mul_overflow(out->elem_size(), rows_cols, &need) ||
               __builtin_add_overflow(header_off + header_len, need, &end);
  if (bogus || end > size_t(st.st_size)) {
    munmap(map, st.st_size);
    out->map = nullptr;
    *err = std::string("truncated npy: ") + path;
    return false;
  }
  return true;
}

struct Corpus {
  std::vector<NpyArray> audio;
  std::vector<NpyArray> mel;
  std::string last_error;

  ~Corpus() {  // unmap everything on any exit path (incl. open failure)
    for (auto& a : audio)
      if (a.map) munmap(a.map, a.map_len);
    for (auto& m : mel)
      if (m.map) munmap(m.map, m.map_len);
  }
};

int64_t clamp_nonneg(int64_t v) { return v < 0 ? 0 : v; }

// read one audio sample as f32/i32 regardless of on-disk dtype
inline float audio_f32(const NpyArray& a, int64_t i) {
  switch (a.dtype) {
    case Dtype::F32: return reinterpret_cast<const float*>(a.data)[i];
    case Dtype::I16: return float(reinterpret_cast<const int16_t*>(a.data)[i]);
    case Dtype::I32: return float(reinterpret_cast<const int32_t*>(a.data)[i]);
    case Dtype::I64: return float(reinterpret_cast<const int64_t*>(a.data)[i]);
  }
  return 0.f;
}
inline int32_t audio_i32(const NpyArray& a, int64_t i) {
  switch (a.dtype) {
    case Dtype::F32: return int32_t(reinterpret_cast<const float*>(a.data)[i]);
    case Dtype::I16: return int32_t(reinterpret_cast<const int16_t*>(a.data)[i]);
    case Dtype::I32: return reinterpret_cast<const int32_t*>(a.data)[i];
    case Dtype::I64: return int32_t(reinterpret_cast<const int64_t*>(a.data)[i]);
  }
  return 0;
}

}  // namespace

extern "C" {

// paths: n audio paths then n mel paths (mel entries may be empty strings
// for audio-only corpora). Returns nullptr on error; the failure reason
// is reported via stderr.
void* nsg_corpus_open(const char** audio_paths, const char** mel_paths, int n) {
  auto* c = new Corpus();
  c->audio.resize(n);
  c->mel.resize(n);
  std::string err;
  for (int i = 0; i < n; i++) {
    if (!parse_npy(audio_paths[i], &c->audio[i], &err)) {
      fprintf(stderr, "[nsg_loader] %s\n", err.c_str());
      delete c;
      return nullptr;
    }
    if (mel_paths && mel_paths[i] && mel_paths[i][0] != '\0') {
      if (!parse_npy(mel_paths[i], &c->mel[i], &err)) {
        fprintf(stderr, "[nsg_loader] %s\n", err.c_str());
        delete c;
        return nullptr;
      }
    }
  }
  return c;
}

void nsg_corpus_close(void* handle) {
  delete static_cast<Corpus*>(handle);  // ~Corpus unmaps
}

int nsg_corpus_len(void* handle) {
  return int(static_cast<Corpus*>(handle)->audio.size());
}

// per-item metadata: audio samples, mel frames, mel bins (0 if no mel)
void nsg_corpus_meta(void* handle, int64_t* audio_len, int64_t* mel_frames,
                     int64_t* mel_bins) {
  auto* c = static_cast<Corpus*>(handle);
  for (size_t i = 0; i < c->audio.size(); i++) {
    audio_len[i] = c->audio[i].rows() * (c->audio[i].ndim == 2
                                             ? c->audio[i].cols()
                                             : 1);
    mel_frames[i] = c->mel[i].map ? c->mel[i].rows() : 0;
    mel_bins[i] = c->mel[i].map ? c->mel[i].cols() : 0;
  }
}

// Fill (b, frames_out, n_mels) f32 from mel[idx][start:start+usable_rows],
// zero-padding the tail — the collate_mel_batch mel branch. usable[i] is
// min(audio_len//hop, mel_frames) as computed by the binding.
int nsg_fill_mel_batch(void* handle, const int32_t* idx, const int64_t* starts,
                       const int64_t* usable, int b, int64_t frames_out,
                       int64_t n_mels, float* out) {
  auto* c = static_cast<Corpus*>(handle);
  for (int i = 0; i < b; i++) {
    const NpyArray& m = c->mel[idx[i]];
    if (!m.map || m.dtype != Dtype::F32 || m.cols() != n_mels) return -1;
    float* dst = out + size_t(i) * frames_out * n_mels;
    int64_t copy_rows = usable[i] >= frames_out ? frames_out
                                                : clamp_nonneg(usable[i]);
    int64_t s = usable[i] >= frames_out ? starts[i] : 0;
    if (s + copy_rows > m.rows()) return -2;
    memcpy(dst, reinterpret_cast<const float*>(m.data) + s * n_mels,
           size_t(copy_rows) * n_mels * sizeof(float));
    if (copy_rows < frames_out)
      memset(dst + copy_rows * n_mels, 0,
             size_t(frames_out - copy_rows) * n_mels * sizeof(float));
  }
  return 0;
}

// Fill (b, samples_out) f32 audio: crop [start*hop, (start+frames)*hop) or
// copy usable*hop samples + pad_value tail — collate_mel_batch audio branch.
int nsg_fill_audio_f32(void* handle, const int32_t* idx, const int64_t* starts,
                       const int64_t* usable, int b, int64_t frames_out,
                       int64_t hop, float pad_value, float* out) {
  auto* c = static_cast<Corpus*>(handle);
  int64_t samples_out = frames_out * hop;
  for (int i = 0; i < b; i++) {
    const NpyArray& a = c->audio[idx[i]];
    float* dst = out + size_t(i) * samples_out;
    int64_t total = a.rows() * (a.ndim == 2 ? a.cols() : 1);
    int64_t copy;
    int64_t s0;
    if (usable[i] >= frames_out) {
      s0 = starts[i] * hop;
      copy = samples_out;
    } else {
      s0 = 0;
      copy = clamp_nonneg(usable[i]) * hop;
    }
    if (s0 + copy > total) return -2;
    if (a.dtype == Dtype::F32) {
      memcpy(dst, reinterpret_cast<const float*>(a.data) + s0,
             size_t(copy) * sizeof(float));
    } else {
      for (int64_t j = 0; j < copy; j++) dst[j] = audio_f32(a, s0 + j);
    }
    for (int64_t j = copy; j < samples_out; j++) dst[j] = pad_value;
  }
  return 0;
}

// Same, int32 output (mulaw-quantize corpora store i16/i32 codes; output
// is widened so quantize_channels up to 65536 is exact).
int nsg_fill_audio_i32(void* handle, const int32_t* idx, const int64_t* starts,
                       const int64_t* usable, int b, int64_t frames_out,
                       int64_t hop, int32_t pad_value, int32_t* out) {
  auto* c = static_cast<Corpus*>(handle);
  int64_t samples_out = frames_out * hop;
  for (int i = 0; i < b; i++) {
    const NpyArray& a = c->audio[idx[i]];
    int32_t* dst = out + size_t(i) * samples_out;
    int64_t total = a.rows() * (a.ndim == 2 ? a.cols() : 1);
    int64_t copy;
    int64_t s0;
    if (usable[i] >= frames_out) {
      s0 = starts[i] * hop;
      copy = samples_out;
    } else {
      s0 = 0;
      copy = clamp_nonneg(usable[i]) * hop;
    }
    if (s0 + copy > total) return -2;
    if (a.dtype == Dtype::I32) {
      memcpy(dst, reinterpret_cast<const int32_t*>(a.data) + s0,
             size_t(copy) * sizeof(int32_t));
    } else {
      for (int64_t j = 0; j < copy; j++) dst[j] = audio_i32(a, s0 + j);
    }
    for (int64_t j = copy; j < samples_out; j++) dst[j] = pad_value;
  }
  return 0;
}

// Advise the kernel about upcoming sequential use of a shard (optional
// prefetch hint for spinning-disk hosts; no-op on errors).
void nsg_corpus_willneed(void* handle, int32_t item) {
  auto* c = static_cast<Corpus*>(handle);
  if (item < 0 || size_t(item) >= c->audio.size()) return;
  const NpyArray& a = c->audio[item];
  if (a.map) madvise(a.map, a.map_len, MADV_WILLNEED);
  const NpyArray& m = c->mel[item];
  if (m.map) madvise(m.map, m.map_len, MADV_WILLNEED);
}

}  // extern "C"
