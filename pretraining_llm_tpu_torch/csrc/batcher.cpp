// Native data batcher: mmap'd token files -> (x, y) int32 batches.
//
// The port's copy of the JAX package's native/batcher.cpp, built by
// pretraining_llm_tpu_torch/data/_native.py into build/native/ at first use.
// The whole batch is produced by one call:
//
//   - the token file is mmap'd once (MAP_SHARED, random-access advised);
//   - crop starts come from a counter-based splitmix64 PRNG, so sampling is
//     stateless: batch k of seed s is a pure function of (s, k), and exact
//     checkpoint resume needs only the counter;
//   - rows are gathered uint16 -> int32 by a small thread pool directly into
//     caller-provided buffers (x and the shifted-by-one y in one pass);
//   - contiguous-block host sharding mirrors the Python loader.
//
// The same (seed, counter) gives the same batch as the JAX package's build.
// Plain C interface for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Batcher {
  const uint16_t* data = nullptr;  // shard view into the mapping
  size_t n_tokens = 0;             // tokens in the shard view
  const void* map_base = nullptr;  // for munmap
  size_t map_len = 0;
  int64_t context_length = 0;
  int n_threads = 1;
};

// splitmix64: counter-based, statistically solid for crop sampling.
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or null on failure.
// Shards the token stream into contiguous blocks with context_length overlap,
// matching data/loader.py::MemmapTokens.
void* batcher_open(const char* path, int64_t context_length, int32_t shard_index,
                   int32_t shard_count, int32_t n_threads) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 2) {
    ::close(fd);
    return nullptr;
  }
  size_t total = static_cast<size_t>(st.st_size) / sizeof(uint16_t);
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  ::close(fd);  // mapping persists
  if (base == MAP_FAILED) return nullptr;
  madvise(base, st.st_size, MADV_RANDOM);

  size_t lo = 0, hi = total;
  if (shard_count > 1) {
    lo = (total * static_cast<size_t>(shard_index)) / shard_count;
    hi = (total * static_cast<size_t>(shard_index + 1)) / shard_count +
         static_cast<size_t>(context_length);
    if (hi > total) hi = total;
  }
  if (hi - lo < static_cast<size_t>(context_length) + 1) {
    munmap(base, st.st_size);
    return nullptr;
  }
  auto* b = new Batcher();
  b->map_base = base;
  b->map_len = st.st_size;
  b->data = static_cast<const uint16_t*>(base) + lo;
  b->n_tokens = hi - lo;
  b->context_length = context_length;
  b->n_threads = n_threads > 0 ? n_threads : 1;
  return b;
}

int64_t batcher_num_tokens(void* handle) {
  return static_cast<Batcher*>(handle)->n_tokens;
}

// Fill x, y (each batch_size * context_length int32) for batch number
// `counter` of stream `seed`. Deterministic: no internal state.
void batcher_sample(void* handle, uint64_t seed, uint64_t counter,
                    int32_t batch_size, int32_t* x, int32_t* y) {
  auto* b = static_cast<Batcher*>(handle);
  const int64_t t = b->context_length;
  const uint64_t n_starts = b->n_tokens - t;  // starts 0 .. n_starts-1

  auto fill_rows = [&](int32_t row_begin, int32_t row_end) {
    for (int32_t r = row_begin; r < row_end; ++r) {
      uint64_t rnd = splitmix64(seed * 0x100000001b3ULL + counter * 0x9e3779b9ULL + r);
      uint64_t start = rnd % n_starts;
      const uint16_t* src = b->data + start;
      int32_t* xr = x + static_cast<int64_t>(r) * t;
      int32_t* yr = y + static_cast<int64_t>(r) * t;
      for (int64_t i = 0; i < t; ++i) {
        xr[i] = static_cast<int32_t>(src[i]);
        yr[i] = static_cast<int32_t>(src[i + 1]);
      }
    }
  };

  int threads = b->n_threads;
  // Thread spawn costs ~50us each: only fan out when each thread gets enough
  // copying (>=1M tokens) to amortize it.
  if (threads <= 1 || static_cast<int64_t>(batch_size) * t < threads * (1 << 20)) {
    fill_rows(0, batch_size);
    return;
  }
  std::vector<std::thread> pool;
  int32_t per = (batch_size + threads - 1) / threads;
  for (int i = 0; i < threads; ++i) {
    int32_t lo = i * per;
    int32_t hi = lo + per > batch_size ? batch_size : lo + per;
    if (lo >= hi) break;
    pool.emplace_back(fill_rows, lo, hi);
  }
  for (auto& th : pool) th.join();
}

void batcher_close(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  munmap(const_cast<void*>(b->map_base), b->map_len);
  delete b;
}

}  // extern "C"
