// Native byte-level BPE encoder of the port's data pipeline.
//
// The port's own copy of the JAX package's encoder (native/bpe.cpp), built
// by data/_native.py with the host C++ compiler into build/native/ at first
// use. It runs on the host; it is not device code.
//
// Algorithm: greedy lowest-rank-first pair merging over a doubly linked list
// with a lazy min-heap of candidate pairs, O(n log n) per document against
// the Python sweep's O(n * n_merges). It gives the ids of
// BPETokenizer._encode_python (data/bpe.py): the heap orders by (rank,
// position), and because a merge with rank r only ever creates pairs of
// rank > r (merge i can only reference ids < 256+i), pending same-rank
// occurrences are always consumed left to right before any newly created
// pair, exactly like the Python sweep.
//
// C ABI (ctypes, no exceptions across the boundary):
//   bpe_create(a, b, n)       -> handle; merge i is (a[i], b[i]) -> 256+i
//   bpe_encode(h, text, n, out) -> token count; out must hold n int32s
//   bpe_destroy(h)
#include <cstdint>
#include <queue>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

inline uint64_t pair_key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

struct Bpe {
  std::unordered_map<uint64_t, int32_t> ranks;
};

// (rank, left-position): min-heap pops lowest rank, then leftmost.
using Entry = std::pair<int64_t, int64_t>;

}  // namespace

extern "C" {

void* bpe_create(const int32_t* a, const int32_t* b, int32_t n_merges) {
  Bpe* t = new (std::nothrow) Bpe();
  if (t == nullptr) return nullptr;
  t->ranks.reserve(n_merges * 2);
  for (int32_t i = 0; i < n_merges; ++i) {
    // operator[]: last index wins on duplicate pairs, matching the Python
    // ranks dict built by enumerate() (data/bpe.py).
    t->ranks[pair_key(a[i], b[i])] = i;
  }
  return t;
}

void bpe_destroy(void* handle) { delete static_cast<Bpe*>(handle); }

int64_t bpe_encode(void* handle, const uint8_t* text, int64_t n, int32_t* out) {
  const Bpe* t = static_cast<const Bpe*>(handle);
  if (n <= 0) return 0;
  std::vector<int32_t> ids(text, text + n);
  std::vector<int64_t> next(n), prev(n);
  std::vector<char> alive(n, 1);
  for (int64_t i = 0; i < n; ++i) {
    prev[i] = i - 1;
    next[i] = i + 1;
  }

  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
  auto maybe_push = [&](int64_t left) {
    int64_t right = next[left];
    if (right >= n) return;
    auto it = t->ranks.find(pair_key(ids[left], ids[right]));
    if (it != t->ranks.end()) heap.emplace(it->second, left);
  };
  for (int64_t i = 0; i + 1 < n; ++i) maybe_push(i);

  while (!heap.empty()) {
    auto [rank, i] = heap.top();
    heap.pop();
    if (!alive[i]) continue;
    int64_t j = next[i];
    if (j >= n) continue;
    // Lazy validation: the pair may have been consumed or changed since push.
    auto it = t->ranks.find(pair_key(ids[i], ids[j]));
    if (it == t->ranks.end() || it->second != rank) continue;
    // Merge: right element folds into the left.
    ids[i] = 256 + static_cast<int32_t>(rank);
    alive[j] = 0;
    int64_t k = next[j];
    next[i] = k;
    if (k < n) prev[k] = i;
    if (prev[i] >= 0) maybe_push(prev[i]);
    maybe_push(i);
  }

  int64_t m = 0;
  for (int64_t i = 0; i < n; i = next[i]) out[m++] = ids[i];
  return m;
}

}  // extern "C"
