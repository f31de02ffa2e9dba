// Native record-shard codec: mmap + field parsing, for the port's
// `BTR1` shards (the port's own copy of the JAX package's
// native/record_codec.cc, the same entry points, RCField layout and
// limits: 8 dims, 64 fields, the oversize and corrupt-record checks).
//
// C++ backend of bisinger_tpu_torch/data/records.py's RecordReader
// (backend "auto" or "native"). Exposed through ctypes
// (bisinger_tpu_torch/native/__init__.py), which copies each array out of
// the mmap. Built at first use with the host C++ compiler
// (`c++ -O3 -fPIC -std=c++17 -shared`) into bisinger_tpu_torch/_build/,
// keyed by a hash of this file, the compiler and the flags
// (bisinger_tpu_torch/ops/_build.py).

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint8_t kTArray = 0;
constexpr uint8_t kTStr = 1;
constexpr uint8_t kTInt = 2;
constexpr uint8_t kTFloat = 3;
constexpr uint8_t kTBytes = 4;
constexpr uint8_t kTNone = 5;
constexpr int kMaxDims = 8;

struct Shard {
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  const uint64_t* offsets = nullptr;  // n + 1 entries
  int64_t n = 0;
  // backing allocations
  void* data_map = nullptr;
  uint8_t* idx_buf = nullptr;
};

// Parse a .npy file containing a 1-D uint64 array; returns malloc'd copy.
uint8_t* load_npy_u64(const char* path, const uint64_t** out, int64_t* count) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  uint8_t magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    fclose(f);
    return nullptr;
  }
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    uint16_t h16;
    if (fread(&h16, 2, 1, f) != 1) { fclose(f); return nullptr; }
    hlen = h16;
  } else {
    if (fread(&hlen, 4, 1, f) != 1) { fclose(f); return nullptr; }
  }
  char* header = new char[hlen + 1];
  if (fread(header, 1, hlen, f) != hlen) { delete[] header; fclose(f); return nullptr; }
  header[hlen] = 0;
  bool ok = strstr(header, "'<u8'") != nullptr && strstr(header, "'fortran_order': False");
  delete[] header;
  if (!ok) { fclose(f); return nullptr; }
  long data_start = ftell(f);
  fseek(f, 0, SEEK_END);
  long end = ftell(f);
  fseek(f, data_start, SEEK_SET);
  long nbytes = end - data_start;
  if (nbytes <= 0 || nbytes % 8 != 0) { fclose(f); return nullptr; }
  uint8_t* buf = new uint8_t[nbytes];
  if (fread(buf, 1, nbytes, f) != static_cast<size_t>(nbytes)) {
    delete[] buf;
    fclose(f);
    return nullptr;
  }
  fclose(f);
  *out = reinterpret_cast<const uint64_t*>(buf);
  *count = nbytes / 8;
  return buf;
}

}  // namespace

extern "C" {

struct RCField {
  const char* key;
  uint32_t key_len;
  uint8_t type;
  const char* dtype;     // arrays: numpy dtype str, e.g. "<f4"
  uint32_t dtype_len;
  uint32_t ndim;
  int64_t shape[kMaxDims];
  const void* data;      // arrays/str/bytes: payload pointer into mmap
  uint64_t data_len;
  int64_t ival;          // ints
  double fval;           // floats
};

void* rc_open(const char* data_path, const char* idx_path) {
  Shard* s = new Shard();
  int fd = open(data_path, O_RDONLY);
  if (fd < 0) { delete s; return nullptr; }
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); delete s; return nullptr; }
  s->data_len = st.st_size;
  if (s->data_len > 0) {
    s->data_map = mmap(nullptr, s->data_len, PROT_READ, MAP_PRIVATE, fd, 0);
    if (s->data_map == MAP_FAILED) { close(fd); delete s; return nullptr; }
    s->data = static_cast<const uint8_t*>(s->data_map);
  }
  close(fd);

  int64_t n_offsets = 0;
  s->idx_buf = load_npy_u64(idx_path, &s->offsets, &n_offsets);
  if (!s->idx_buf || n_offsets < 1) {
    if (s->data_map) munmap(s->data_map, s->data_len);
    delete[] s->idx_buf;
    delete s;
    return nullptr;
  }
  s->n = n_offsets - 1;
  return s;
}

void rc_close(void* h) {
  Shard* s = static_cast<Shard*>(h);
  if (!s) return;
  if (s->data_map) munmap(s->data_map, s->data_len);
  delete[] s->idx_buf;
  delete s;
}

int64_t rc_len(void* h) { return static_cast<Shard*>(h)->n; }

// Parse record `idx` into `out[0..max_fields)`; returns the number of
// fields, or -1 on corruption / overflow.
int rc_parse(void* h, int64_t idx, RCField* out, int max_fields) {
  Shard* s = static_cast<Shard*>(h);
  if (idx < 0 || idx >= s->n) return -1;
  uint64_t off = s->offsets[idx];
  uint64_t end = s->offsets[idx + 1];
  // untrusted idx: also reject off > end and wraparound in off + 8
  if (end > s->data_len || off > end || end - off < 8) return -1;
  const uint8_t* p = s->data + off;
  const uint8_t* pe = s->data + end;
  if (memcmp(p, "BTR1", 4) != 0) return -1;
  uint32_t n_fields;
  memcpy(&n_fields, p + 4, 4);
  p += 8;
  if (static_cast<int>(n_fields) > max_fields) return -1;

  for (uint32_t i = 0; i < n_fields; ++i) {
    RCField* f = &out[i];
    memset(f, 0, sizeof(RCField));
    if (p + 2 > pe) return -1;
    uint16_t klen;
    memcpy(&klen, p, 2);
    p += 2;
    if (p + klen + 1 > pe) return -1;
    f->key = reinterpret_cast<const char*>(p);
    f->key_len = klen;
    p += klen;
    f->type = *p++;
    switch (f->type) {
      case kTArray: {
        if (p + 2 > pe) return -1;
        uint16_t dtlen;
        memcpy(&dtlen, p, 2);
        p += 2;
        if (p + dtlen + 1 > pe) return -1;
        f->dtype = reinterpret_cast<const char*>(p);
        f->dtype_len = dtlen;
        p += dtlen;
        uint8_t ndim = *p++;
        if (ndim > kMaxDims || p + 8 * ndim + 8 > pe) return -1;
        f->ndim = ndim;
        memcpy(f->shape, p, 8 * ndim);
        p += 8 * ndim;
        uint64_t nbytes;
        memcpy(&nbytes, p, 8);
        p += 8;
        // compare against the REMAINING length: `p + nbytes > pe` with an
        // untrusted uint64 can wrap the pointer and defeat the check
        if (nbytes > (uint64_t)(pe - p)) return -1;
        f->data = p;
        f->data_len = nbytes;
        p += nbytes;
        break;
      }
      case kTStr:
      case kTBytes: {
        if (p + 8 > pe) return -1;
        uint64_t n;
        memcpy(&n, p, 8);
        p += 8;
        if (n > (uint64_t)(pe - p)) return -1;
        f->data = p;
        f->data_len = n;
        p += n;
        break;
      }
      case kTInt: {
        if (p + 8 > pe) return -1;
        memcpy(&f->ival, p, 8);
        p += 8;
        break;
      }
      case kTFloat: {
        if (p + 8 > pe) return -1;
        memcpy(&f->fval, p, 8);
        p += 8;
        break;
      }
      case kTNone:
        break;
      default:
        return -1;
    }
  }
  return static_cast<int>(n_fields);
}

}  // extern "C"
