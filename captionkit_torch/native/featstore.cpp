// Native feature store (a copy of captionkit/native/featstore.cpp): an
// mmap-backed row gather for bottom-up features, bound with ctypes by
// captionkit_torch/data/faststore.py.
//
// Gathers B rows of [R=36, F=2048] float features (~300 KB each) from a
// memory-mapped .npy into the contiguous batch buffer that the host-to-
// device copy reads: threaded memcpy, no interpreter lock, no numpy
// fancy-indexing temporaries. The .npy header is parsed in Python; C++
// only sees (path, payload offset, rows, row_bytes).
//
// Built at first use by captionkit_torch/utils/nativebuild.py (g++ -O3
// -std=c++17 -fPIC -shared, -lpthread) into build/captionkit_torch/.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;  // mmap base
  size_t map_len = 0;
  size_t payload_off = 0;
  int64_t rows = 0;
  int64_t row_bytes = 0;
};

constexpr int64_t kRowsPerThreadMin = 16;

}  // namespace

extern "C" {

// Returns nullptr on failure.
void* featstore_open(const char* path, int64_t payload_off, int64_t rows,
                     int64_t row_bytes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  size_t need = static_cast<size_t>(payload_off) +
                static_cast<size_t>(rows) * static_cast<size_t>(row_bytes);
  if (static_cast<size_t>(st.st_size) < need) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(base, st.st_size, MADV_WILLNEED);
  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->map_len = st.st_size;
  s->payload_off = payload_off;
  s->rows = rows;
  s->row_bytes = row_bytes;
  return s;
}

void featstore_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  if (s->base) munmap(const_cast<uint8_t*>(s->base), s->map_len);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

// Gather n rows by index into out (n * row_bytes, caller-owned).
// Returns 0 on success, -1 on an out-of-range index.
int featstore_gather(void* handle, const int64_t* indices, int64_t n,
                     uint8_t* out, int64_t n_threads) {
  auto* s = static_cast<Store*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    if (indices[i] < 0 || indices[i] >= s->rows) return -1;
  }
  const uint8_t* payload = s->base + s->payload_off;
  const int64_t rb = s->row_bytes;

  auto copy_range = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * rb, payload + indices[i] * rb, rb);
    }
  };

  if (n_threads <= 1 || n < kRowsPerThreadMin * 2) {
    copy_range(0, n);
    return 0;
  }
  int64_t workers = std::min<int64_t>(
      n_threads, (n + kRowsPerThreadMin - 1) / kRowsPerThreadMin);
  std::vector<std::thread> threads;
  threads.reserve(workers);
  int64_t chunk = (n + workers - 1) / workers;
  for (int64_t w = 0; w < workers; ++w) {
    int64_t lo = w * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(copy_range, lo, hi);
  }
  for (auto& t : threads) t.join();
  return 0;
}

int64_t featstore_rows(void* handle) {
  return static_cast<Store*>(handle)->rows;
}

}  // extern "C"
