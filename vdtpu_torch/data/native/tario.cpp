// Native tar shard indexer and reader for the webdataset input pipeline
// (vdtpu_torch/data/webdataset.py): ustar and GNU tar header walking,
// member extent indexing, and pread-based extraction, so Python never
// touches per-member tarfile overhead on the input path. A plain C ABI for
// ctypes; the same reader as the JAX package's vdtpu/data/native/tario.cpp,
// kept here so the port builds it from its own sources.
//
// Build: vdtpu_torch/data/native/__init__.py (g++ -O2 -shared -fPIC, into
// build/native/ at the root of the checkout, at first use).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Entry {
  std::string name;
  int64_t offset;  // payload offset in bytes
  int64_t size;
};

struct TarIndex {
  int fd = -1;
  std::vector<Entry> entries;
};

int64_t parse_octal(const char* p, size_t n) {
  // tar numeric fields: octal ASCII, or base-256 when the high bit is set
  if (static_cast<unsigned char>(p[0]) & 0x80) {
    int64_t v = static_cast<unsigned char>(p[0]) & 0x7f;
    for (size_t i = 1; i < n; ++i)
      v = (v << 8) | static_cast<unsigned char>(p[i]);
    return v;
  }
  int64_t v = 0;
  for (size_t i = 0; i < n && p[i]; ++i) {
    if (p[i] == ' ') continue;
    if (p[i] < '0' || p[i] > '7') break;
    v = v * 8 + (p[i] - '0');
  }
  return v;
}

bool is_zero_block(const char* b) {
  for (int i = 0; i < 512; ++i)
    if (b[i]) return false;
  return true;
}

}  // namespace

extern "C" {

TarIndex* tario_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  auto* idx = new TarIndex();
  idx->fd = fd;

  char block[512];
  int64_t pos = 0;
  std::string pending_longname;
  int zero_blocks = 0;
  while (true) {
    ssize_t r = ::pread(fd, block, 512, pos);
    if (r < 512) break;
    if (is_zero_block(block)) {
      if (++zero_blocks >= 2) break;
      pos += 512;
      continue;
    }
    zero_blocks = 0;
    int64_t size = parse_octal(block + 124, 12);
    char typeflag = block[156];
    std::string name(block, strnlen(block, 100));
    // ustar prefix field (POSIX long paths)
    if (std::memcmp(block + 257, "ustar", 5) == 0 && block[345]) {
      std::string prefix(block + 345, strnlen(block + 345, 155));
      name = prefix + "/" + name;
    }
    int64_t payload = pos + 512;
    int64_t padded = (size + 511) & ~int64_t(511);
    if (typeflag == 'L') {  // GNU longname: payload is the real name
      std::string ln(size_t(size), '\0');
      if (::pread(fd, ln.data(), size_t(size), payload) == size) {
        while (!ln.empty() && ln.back() == '\0') ln.pop_back();
        pending_longname = ln;
      }
    } else if (typeflag == '0' || typeflag == '\0') {
      Entry e;
      e.name = pending_longname.empty() ? name : pending_longname;
      pending_longname.clear();
      e.offset = payload;
      e.size = size;
      idx->entries.push_back(std::move(e));
    } else {
      pending_longname.clear();
    }
    pos = payload + padded;
  }
  return idx;
}

int64_t tario_count(TarIndex* idx) {
  return idx ? int64_t(idx->entries.size()) : -1;
}

const char* tario_name(TarIndex* idx, int64_t i) {
  if (!idx || i < 0 || size_t(i) >= idx->entries.size()) return nullptr;
  return idx->entries[size_t(i)].name.c_str();
}

int64_t tario_size(TarIndex* idx, int64_t i) {
  if (!idx || i < 0 || size_t(i) >= idx->entries.size()) return -1;
  return idx->entries[size_t(i)].size;
}

int64_t tario_read(TarIndex* idx, int64_t i, char* out, int64_t cap) {
  if (!idx || i < 0 || size_t(i) >= idx->entries.size()) return -1;
  const Entry& e = idx->entries[size_t(i)];
  int64_t n = e.size < cap ? e.size : cap;
  int64_t done = 0;
  while (done < n) {
    ssize_t r = ::pread(idx->fd, out + done, size_t(n - done), e.offset + done);
    if (r <= 0) return -1;
    done += r;
  }
  return n;
}

void tario_close(TarIndex* idx) {
  if (!idx) return;
  if (idx->fd >= 0) ::close(idx->fd);
  delete idx;
}

}  // extern "C"
