// Native data loader: memory-mapped .npy image shards -> prefetched float
// batches (the port's own copy of the JAX package's native/dataloader.cpp;
// the same arithmetic, so the same seed gives the same batches).
//
// The reference feeds training from a Python LMDB DataLoader
// (exp/stylesdf/dataset.py + torch DataLoader workers). A training step of
// batch x 1024^2 x 3 float32 (~50 MB per batch of 4) needs its host side
// off the interpreter: this library maps the packed uint8 .npy shards and
// runs a pool of worker threads that shuffle (seeded, per epoch),
// optionally hflip, normalize to [-1, 1] and fill a ring of ready batches.
// Python consumes them through ctypes (cips3dpp_torch/io/native_loader.py,
// which builds this file with g++ -O3 -shared -fPIC -std=c++17 -pthread).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Shard {
  const uint8_t* data = nullptr;  // pixel data (n, h, w, 3), C-order
  size_t n = 0;
  size_t mapped_size = 0;
  void* map_base = nullptr;
};

// Minimal .npy header parse: uint8, C-order, shape (n, h, w, 3).
bool parse_npy(const char* path, Shard* shard, long* h, long* w) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return false; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return false;
  const uint8_t* p = static_cast<const uint8_t*>(base);
  if (st.st_size < 10 || memcmp(p, "\x93NUMPY", 6) != 0) {
    munmap(base, st.st_size);
    return false;
  }
  uint16_t header_len;
  memcpy(&header_len, p + 8, 2);  // version 1.0 little-endian
  std::string header(reinterpret_cast<const char*>(p + 10), header_len);
  if (header.find("|u1") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    munmap(base, st.st_size);
    return false;
  }
  auto lp = header.find('(');
  auto rp = header.find(')');
  long dims[4] = {0, 0, 0, 0};
  int nd = 0;
  std::string shape_str = header.substr(lp + 1, rp - lp - 1);
  char* cursor = shape_str.data();
  while (nd < 4) {
    char* end;
    long v = strtol(cursor, &end, 10);
    if (end == cursor) break;
    dims[nd++] = v;
    cursor = end;
    while (*cursor == ',' || *cursor == ' ') cursor++;
  }
  if (nd != 4 || dims[3] != 3) {
    munmap(base, st.st_size);
    return false;
  }
  shard->map_base = base;
  shard->mapped_size = st.st_size;
  shard->data = p + 10 + header_len;
  shard->n = dims[0];
  *h = dims[1];
  *w = dims[2];
  return true;
}

struct Loader {
  std::vector<Shard> shards;
  std::vector<size_t> offsets;  // cumulative start index per shard
  size_t total = 0;
  long h = 0, w = 0;
  int batch = 0;
  bool hflip = true;
  uint64_t seed = 0;
  int shard_index = 0, num_shards = 1;  // host sharding

  // ring of ready batches
  std::queue<float*> ready;
  std::queue<float*> free_bufs;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> cursor{0};  // global sample counter

  size_t batch_floats() const {
    return static_cast<size_t>(batch) * h * w * 3;
  }

  const uint8_t* sample_ptr(size_t idx) const {
    size_t s = 0;
    while (s + 1 < shards.size() && offsets[s + 1] <= idx) s++;
    return shards[s].data + (idx - offsets[s]) * (size_t)h * w * 3;
  }

  void fill_batch(float* out, uint64_t batch_idx) {
    // per-epoch seeded permutation, evaluated lazily per element via a
    // feistel-ish hash so no O(N) shuffle state is needed
    size_t usable = (total / num_shards);
    for (int b = 0; b < batch; ++b) {
      uint64_t linear = batch_idx * batch + b;
      uint64_t epoch = linear / usable;
      uint64_t pos = linear % usable;
      // splitmix-based pseudo-permutation within the epoch
      uint64_t x = pos + 0x9E3779B97f4A7C15ULL * (seed + epoch * 1315423911ULL);
      x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ULL;
      x ^= x >> 27; x *= 0x94D049BB133111EBULL;
      x ^= x >> 31;
      size_t idx = (x % usable) * num_shards + shard_index;
      bool flip = hflip && ((x >> 33) & 1);

      const uint8_t* src = sample_ptr(idx % total);
      float* dst = out + (size_t)b * h * w * 3;
      // IEEE division matches the Python pipeline (x/127.5 - 1) bit-for-bit
      if (!flip) {
        size_t n = (size_t)h * w * 3;
        for (size_t i = 0; i < n; ++i) dst[i] = src[i] / 127.5f - 1.0f;
      } else {
        for (long row = 0; row < h; ++row) {
          const uint8_t* srow = src + row * w * 3;
          float* drow = dst + row * w * 3;
          for (long col = 0; col < w; ++col) {
            const uint8_t* sp = srow + (w - 1 - col) * 3;
            float* dp = drow + col * 3;
            dp[0] = sp[0] / 127.5f - 1.0f;
            dp[1] = sp[1] / 127.5f - 1.0f;
            dp[2] = sp[2] / 127.5f - 1.0f;
          }
        }
      }
    }
  }

  void worker_loop() {
    while (!stop.load()) {
      float* buf = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_bufs.empty(); });
        if (stop.load()) return;
        buf = free_bufs.front();
        free_bufs.pop();
      }
      uint64_t bidx = cursor.fetch_add(1);
      fill_batch(buf, bidx);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push(buf);
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n_paths, int batch, uint64_t seed,
                    int hflip, int shard_index, int num_shards,
                    int n_threads, int ring_size) {
  auto* L = new Loader();
  L->batch = batch;
  L->seed = seed;
  L->hflip = hflip != 0;
  L->shard_index = shard_index;
  L->num_shards = num_shards;
  for (int i = 0; i < n_paths; ++i) {
    Shard s;
    long h = 0, w = 0;
    if (!parse_npy(paths[i], &s, &h, &w)) {
      delete L;
      return nullptr;
    }
    if (L->h == 0) { L->h = h; L->w = w; }
    if (h != L->h || w != L->w) { delete L; return nullptr; }
    L->offsets.push_back(L->total);
    L->total += s.n;
    L->shards.push_back(s);
  }
  if (L->total == 0) { delete L; return nullptr; }
  for (int i = 0; i < ring_size; ++i)
    L->free_bufs.push(new float[L->batch_floats()]);
  for (int i = 0; i < n_threads; ++i)
    L->workers.emplace_back([L] { L->worker_loop(); });
  return L;
}

long loader_height(void* h) { return static_cast<Loader*>(h)->h; }
long loader_width(void* h) { return static_cast<Loader*>(h)->w; }
long loader_size(void* h) { return static_cast<Loader*>(h)->total; }

// Copy the next ready batch into `out` (batch*h*w*3 floats). Blocking.
int loader_next(void* handle, float* out) {
  auto* L = static_cast<Loader*>(handle);
  float* buf = nullptr;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return L->stop.load() || !L->ready.empty(); });
    if (L->stop.load()) return -1;
    buf = L->ready.front();
    L->ready.pop();
  }
  memcpy(out, buf, L->batch_floats() * sizeof(float));
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_bufs.push(buf);
  }
  L->cv_free.notify_one();
  return 0;
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  while (!L->ready.empty()) { delete[] L->ready.front(); L->ready.pop(); }
  while (!L->free_bufs.empty()) { delete[] L->free_bufs.front(); L->free_bufs.pop(); }
  for (auto& s : L->shards) munmap(s.map_base, s.mapped_size);
  delete L;
}

}  // extern "C"
