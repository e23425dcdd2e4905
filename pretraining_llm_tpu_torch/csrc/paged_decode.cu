// Paged decode attention straight off the KV block pool, for Hopper sm_90a.
//
// Replaces: pretraining_llm_tpu/ops/pallas_paged.py::_paged_call and its
// kernel _paged_kernel (T uniform queries per row; query t of a row sees
// slots <= seq + t, and > seq + t - window with a sliding window).
//
// What bounds it on the H100: bytes. Each (row, KV head) reads its live
// pages once -- bs * Dh K and V elements per page -- and does ~4 * n_rep *
// T FLOPs per element read: a few FLOPs per byte against the card's ~295
// FLOP/byte ridge, so the limit is the memory rate. At R = n_rep * T = 1
// query row (gpt2 decode) the tensor cores cannot help (wgmma takes 64
// rows): what a design can do is keep enough page loads in flight on
// enough SMs, and keep every thread busy on the few rows there are.
//
// Two kernels, picked by shape before launch
// (ops/cuda_paged.py::paged_route):
//
// Route "split" (paged_split_kernel: Dh 64 or 128, 64-slot pages, R <= 16):
// a split page stream with an in-kernel combine.
//   - One block of 128 threads per (partition p, KV head g, row b). A row's
//     table is cut into `parts` partitions of nb_split = ceil(nb / parts)
//     entries; the wrapper picks `parts` from B, G, nb and the SM count
//     alone (ops/cuda_paged.py::_kv_partitions: at least two blocks per SM
//     at the main path's decode step), never from seq_lens, which lie on
//     the card. A block reads the pages of its partition that are live --
//     j * bs <= seq + T - 1 and, with a window, j * bs + bs - 1 > seq -
//     window -- so dead table tails (block 0) and window-dead pages are
//     never read, and a partition past its row's frontier reads nothing.
//   - The thread layout follows the copies: thread (c, sg) owns 16-byte
//     chunk c of slots sg, sg + NG, ... of every page (NC = Dh * elem / 16
//     chunk lanes per slot, NG = 128 / NC slot groups). It copies those
//     chunks of K and V into a ring of 2-4 pages with cp.async (16 bytes
//     each, up to 4 pages of a partition in flight from the block's start)
//     and is the only thread that reads them, so the ring needs no barrier
//     of its own. At R = 1 every thread works on every page: the score
//     pass is NS = bs / NG slots x one chunk per thread, reduced over the
//     chunk lanes with shuffles, and the P.V pass the same slots x chunk.
//   - q is kept in registers (fp32) for R <= 4, read from shared memory
//     above; the running (m, l) per row in shared memory, and each
//     thread's share of acc (its slots, its chunk, every row) in fp32
//     registers. Per page: scores -> barrier -> online softmax (one warp
//     per row: fp32, NEG_INF = -1e30, masked p = 0 by the mask itself, P
//     rounded to V's dtype as the Pallas kernel does before P.V) ->
//     barrier -> P.V. Scores and alpha are double-buffered, so a page
//     costs two barriers.
//   - After the walk the slot groups' sums are added in a fixed order
//     (shared memory over the ring). With one partition the block writes
//     acc / l (l == 0 gives zeros). Otherwise it writes its fp32 partial
//     (acc, m, l) -- an empty partition only m = NEG_INF and l = 0 -- then
//     takes a ticket from the (row, head)'s arrival counter. The block
//     that arrives last merges the partials in partition order (m = max,
//     w_p = exp(m_p - m), l = sum l_p w_p, acc = sum acc_p w_p, skipping
//     partials with l_p == 0, whose acc is exactly zero), writes the
//     output and resets the counter to 0 for the next launch. The merge
//     order does not depend on which block came last, so a repeat launch
//     gives the same bits. Partials and counters are the wrapper's
//     scratch: the kernel allocates nothing.
//
// Route "loop" (paged_decode_kernel: every other shape), the port's first
// kernel, simple first:
//   - One block of 256 threads per (KV head g, batch row b). The block reads
//     its row's block ids from `tables` itself (the TPU kernel's scalar
//     prefetch) and walks the pages j with j*bs <= seq+T-1 -- and, with a
//     window, j*bs+bs-1 > seq-window. Dead tail entries (block 0) lie past
//     the frontier and are never read.
//   - Each page's K and V (bs, Dh) for head g are staged in shared memory as
//     fp32 (K rows padded to Dh+1 floats), and serve all n_rep*T query rows
//     of the group: row r is query t = r % T of head g*n_rep + r / T, the
//     heads-major fold of the Pallas kernel. K/V are never repeated.
//   - Scores for the whole (rows, bs) panel, then an online softmax (fp32,
//     NEG_INF = -1e30, masked p = 0, one warp per row), then the PV update
//     of an fp32 accumulator in shared memory. P is rounded to V's dtype
//     before the PV product; a row with l == 0 gives zeros.
//
// Both run on the caller's stream and allocate nothing. The Python wrapper
// (ops/cuda_paged.py::paged_decode_attention) counts the launches per route.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Must match ops/cuda_paged.py::smem_bytes, which refuses shapes above the
// card's per-block limit before launching.
size_t smem_bytes(int rows, int D, int bs) {
  return sizeof(float) *
         (size_t)(rows * D + bs * (D + 1) + bs * D + rows * bs + rows * D + 3 * rows);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out, int H,
                    int G, int Tq, int D, int bs, int nb, int window,
                    float scale) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int n_rep = H / G;
  const int R = n_rep * Tq;
  const int LDK = D + 1;
  float* sQ = smem;             // R x D
  float* sK = sQ + R * D;       // bs x LDK
  float* sV = sK + bs * LDK;    // bs x D
  float* sS = sV + bs * D;      // R x bs
  float* sAcc = sS + R * bs;    // R x D
  float* sM = sAcc + R * D;     // R
  float* sL = sM + R;           // R
  float* sA = sL + R;           // R (this page's rescale factor)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = THREADS / 32;

  // q, out: (B, Tq, H, D). Group row r -> head g*n_rep + r/Tq, query r%Tq.
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int hh = g * n_rep + r / Tq, t = r % Tq;
    sQ[i] = to_f(q[(((size_t)b * Tq + t) * H + hh) * D + d]);
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }

  const int seq = seq_lens[b];
  const int j_hi = min(nb - 1, (seq + Tq - 1) / bs);
  for (int j = 0; j <= j_hi; ++j) {
    if (window > 0 && j * bs + bs - 1 <= seq - window) continue;  // below every window
    const size_t blk = (size_t)tables[(size_t)b * nb + j];
    __syncthreads();  // previous page's readers (and the init above) are done
    for (int i = tid; i < bs * D; i += THREADS) {
      const int s = i / D, d = i - s * D;
      const size_t off = ((blk * bs + s) * G + g) * D + d;  // pool (n_blocks, bs, G, D)
      sK[s * LDK + d] = to_f(k_pool[off]);
      sV[s * D + d] = to_f(v_pool[off]);
    }
    __syncthreads();

    for (int i = tid; i < R * bs; i += THREADS) {
      const int r = i / bs, s = i - r * bs;
      const float* qr = sQ + r * D;
      const float* ks = sK + s * LDK;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qr[d] * ks[d];
      sS[i] = dot * scale;
    }
    __syncthreads();

    for (int r = warp; r < R; r += n_warps) {
      const int frontier = seq + r % Tq;  // query t's own slot, inclusive
      float mx = NEG_INF;
      for (int s = lane; s < bs; s += 32) {
        const int lin = j * bs + s;
        const bool ok = lin <= frontier && (window <= 0 || lin > frontier - window);
        const float sc = ok ? sS[r * bs + s] : NEG_INF;
        sS[r * bs + s] = sc;
        mx = fmaxf(mx, sc);
      }
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int s = lane; s < bs; s += 32) {
        const int lin = j * bs + s;
        const bool ok = lin <= frontier && (window <= 0 || lin > frontier - window);
        const float p = ok ? expf(sS[r * bs + s] - m_new) : 0.f;
        psum += p;
        sS[r * bs + s] = to_f(from_f<T>(p));  // P in V's dtype
      }
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sL[r] = sL[r] * alpha + psum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < R * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      const float* pr = sS + r * bs;
      float a = sAcc[i] * sA[r];
      for (int s = 0; s < bs; ++s) a += pr[s] * sV[s * D + d];
      sAcc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int hh = g * n_rep + r / Tq, t = r % Tq;
    const float l = sL[r];
    const float safe_l = (l == 0.f) ? 1.f : l;
    out[(((size_t)b * Tq + t) * H + hh) * D + d] = from_f<T>(sAcc[i] / safe_l);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* seq_lens, void* out, int B, int H,
           int G, int Tq, int D, int bs, int nb, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes((H / G) * Tq, D, bs);
  auto kern = paged_decode_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(G, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), H, G, Tq, D,
      bs, nb, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route "split": the split page stream with an in-kernel combine
// ---------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 128;
constexpr int SPLIT_BS = 64;             // the page size the split route takes
constexpr int SPLIT_MAX_ROWS = 16;       // n_rep * T
constexpr int RING_BUDGET = 96 * 1024;   // bytes of pages in flight per block

// Shared memory of one split block, in bytes, for ESZ-byte elements and up to
// RT query rows. ops/cuda_paged.py::split_smem_bytes repeats this arithmetic.
template <int ESZ, int D, int RT>
struct SplitSmem {
  static constexpr int NG = SPLIT_THREADS / (D * ESZ / 16);   // slot groups
  static constexpr int STAGE = 2 * SPLIT_BS * D * ESZ;        // one page's K and V of one head
  static constexpr int STAGES = 4 * STAGE <= RING_BUDGET ? 4 : 3 * STAGE <= RING_BUDGET ? 3 : 2;
  static constexpr int RED = NG * RT * D * 4;                 // the slot groups' sums, after the walk
  static constexpr int AREA = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  static constexpr int Q = AREA;                              // q rows, fp32
  static constexpr int S = Q + RT * D * 4;                    // scores, then P: two buffers
  static constexpr int STAT = S + 2 * RT * SPLIT_BS * 4;      // m, l, and alpha (two buffers)
  static constexpr int ALLOC = STAT + 4 * RT * 4 + 16;        // and the last-block flag
};

// The CH elements of one 16-byte chunk of shared memory, as fp32.
__device__ __forceinline__ void chunk_f32(float (&f)[4], const uint8_t* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void chunk_f32(float (&f)[8], const uint8_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int D, int RT>
__global__ void __launch_bounds__(SPLIT_THREADS)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
                   const int* __restrict__ tables, const int* __restrict__ seq_lens, T* __restrict__ out,
                   float* __restrict__ part_acc, float* __restrict__ part_ml, int* __restrict__ counters, int H,
                   int G, int Tq, int nb, int window, int parts, int nb_split, float scale) {
  using L = SplitSmem<sizeof(T), D, RT>;
  constexpr int BS = SPLIT_BS;
  constexpr int CH = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr int NC = D / CH;          // chunks of a slot row: the lanes of one slot
  constexpr int NG = L::NG;           // slot groups
  constexpr int NS = BS / NG;         // slots of a thread on each page
  constexpr int STAGES = L::STAGES;
  constexpr int WARPS = SPLIT_THREADS / 32;
  constexpr bool Q_REGS = RT <= 4;
  static_assert(NC <= 32 && 32 % NC == 0 && BS % NG == 0, "a slot's chunks lie in one warp");
  extern __shared__ __align__(16) uint8_t split_smem[];
  float* sQ = reinterpret_cast<float*>(split_smem + L::Q);     // [RT][D]
  float* sS = reinterpret_cast<float*>(split_smem + L::S);     // [2][RT][BS]
  float* sM = reinterpret_cast<float*>(split_smem + L::STAT);  // [RT]
  float* sL = sM + RT;                                   // [RT]
  float* sA = sL + RT;                                   // [2][RT]
  int* sLast = reinterpret_cast<int*>(sA + 2 * RT);

  const int part = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_rep = H / G;
  const int R = n_rep * Tq;  // query rows of the group: row r is query r % Tq of head g * n_rep + r / Tq
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % NC, sg = tid / NC;

  // This partition's live pages [j_lo, j_lo + n_pages).
  const int seq = seq_lens[b];
  int j_lo = part * nb_split;
  const int j_hi = min(min(nb - 1, (seq + Tq - 1) / BS), j_lo + nb_split - 1);
  if (window > 0) {
    const int x = seq - window - BS + 1;  // pages j with j * BS <= x lie below every query's window
    if (x >= 0) j_lo = max(j_lo, x / BS + 1);
  }
  const int n_pages = max(0, j_hi - j_lo + 1);

  for (int i = tid; i < R * D; i += SPLIT_THREADS) {
    const int r = i / D, d = i - r * D;
    sQ[i] = to_f(q[(((size_t)b * Tq + r % Tq) * H + g * n_rep + r / Tq) * D + d]);
  }
  for (int r = tid; r < RT; r += SPLIT_THREADS) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }
  __syncthreads();

  float acc[RT][CH];  // this thread's share: its slots, its chunk, every row
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < CH; ++e) acc[r][e] = 0.f;

  if (n_pages > 0) {
    float qr[Q_REGS ? RT : 1][CH];
    if constexpr (Q_REGS) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int e = 0; e < CH; ++e) qr[r][e] = r < R ? sQ[r * D + c * CH + e] : 0.f;
    }
    // Page i's block id sits in lane i % 32 of every warp, 32 entries at a time.
    const int* tbl = tables + (size_t)b * nb + j_lo;
    int blk_lane = lane < n_pages ? tbl[lane] : 0;
    const size_t head_off = (size_t)g * D + c * CH;
    auto fetch_page = [&](int i) {  // page i into stage i % STAGES: this thread's chunks of K and V
      if (i > 0 && i % 32 == 0) blk_lane = i + lane < n_pages ? tbl[i + lane] : 0;
      const size_t blk = (size_t)__shfl_sync(0xffffffffu, blk_lane, i % 32);
      uint8_t* st = split_smem + (i % STAGES) * L::STAGE;
      const T* kb = k_pool + blk * BS * G * D + head_off;
      const T* vb = v_pool + blk * BS * G * D + head_off;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int s = sg + NG * k;
        cp_async16(st + (s * D + c * CH) * sizeof(T), kb + (size_t)s * G * D);
        cp_async16(st + ((BS + s) * D + c * CH) * sizeof(T), vb + (size_t)s * G * D);
      }
    };
    // Every page of the first STAGES in flight at once, one group each.
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      if (i < n_pages) fetch_page(i);
      cp_async_commit();
    }

    for (int i = 0; i < n_pages; ++i) {
      const int j = j_lo + i;
      const uint8_t* st = split_smem + (i % STAGES) * L::STAGE;
      float* sc = sS + (i & 1) * RT * BS;
      float* al = sA + (i & 1) * RT;
      if (i == 0) cp_async_wait<STAGES - 1>();  // group i: this thread's chunks of page i
      else cp_async_wait<STAGES - 2>();

      // Scores: q . k over this thread's chunk, summed over the slot's chunk lanes.
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int s = sg + NG * k;
        float kf[CH];
        chunk_f32(kf, st + (s * D + c * CH) * sizeof(T));
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < R) {
            float dot = 0.f;
            if constexpr (Q_REGS) {
#pragma unroll
              for (int e = 0; e < CH; ++e) dot = fmaf(qr[r][e], kf[e], dot);
            } else {
              const float* qv = sQ + r * D + c * CH;
#pragma unroll
              for (int e = 0; e < CH; ++e) dot = fmaf(qv[e], kf[e], dot);
            }
#pragma unroll
            for (int off = NC / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
            if (c == 0) sc[r * BS + s] = dot * scale;
          }
        }
      }
      __syncthreads();  // the scores of page i; every thread is past page i - 1's P.V

      // Page i + STAGES - 1 into the stage page i - 1 used (this thread's own chunks).
      if (i > 0) {
        if (i + STAGES - 1 < n_pages) fetch_page(i + STAGES - 1);
        cp_async_commit();
      }

      // Online softmax, one warp per row.
      for (int r = warp; r < R; r += WARPS) {
        const int front = seq + r % Tq;  // query t's own slot, inclusive
        float x[BS / 32];
        bool ok[BS / 32];
        float mx = NEG_INF;
#pragma unroll
        for (int u = 0; u < BS / 32; ++u) {
          const int lin = j * BS + lane + 32 * u;
          ok[u] = lin <= front && (window <= 0 || lin > front - window);
          x[u] = ok[u] ? sc[r * BS + lane + 32 * u] : NEG_INF;
          mx = fmaxf(mx, x[u]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = sM[r];
        const float m_new = fmaxf(m_prev, mx);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < BS / 32; ++u) {
          const float p = ok[u] ? expf(x[u] - m_new) : 0.f;
          psum += p;
          sc[r * BS + lane + 32 * u] = to_f(from_f<T>(p));  // P in V's dtype
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          sL[r] = sL[r] * alpha + psum;
          sM[r] = m_new;
          al[r] = alpha;
        }
      }
      __syncthreads();  // P and alpha of page i

      // acc = acc * alpha + P . V over this thread's slots and chunk.
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < R) {
          const float a = al[r];
#pragma unroll
          for (int e = 0; e < CH; ++e) acc[r][e] *= a;
        }
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int s = sg + NG * k;
        float vf[CH];
        chunk_f32(vf, st + ((BS + s) * D + c * CH) * sizeof(T));
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < R) {
            const float p = sc[r * BS + s];
#pragma unroll
            for (int e = 0; e < CH; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it holds the slot groups' sums next
    float* red = reinterpret_cast<float*>(split_smem);  // [NG][RT][D]
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < R) {
#pragma unroll
        for (int e = 0; e < CH; e += 4)
          *reinterpret_cast<float4*>(red + (sg * RT + r) * D + c * CH + e) =
              make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
      }
    }
    __syncthreads();
  }

  // This block's result per (row, dim): the slot groups summed in order.
  const float* red = reinterpret_cast<const float*>(split_smem);
  auto block_acc = [&](int r, int d) {
    float a = 0.f;
    if (n_pages > 0)
      for (int gg = 0; gg < NG; ++gg) a += red[(gg * RT + r) * D + d];
    return a;
  };
  auto out_at = [&](int r, int d) -> T& {
    return out[(((size_t)b * Tq + r % Tq) * H + g * n_rep + r / Tq) * D + d];
  };

  if (parts == 1) {
    for (int i = tid; i < R * D; i += SPLIT_THREADS) {
      const int r = i / D, d = i - r * D;
      const float l = sL[r];
      out_at(r, d) = from_f<T>(block_acc(r, d) / (l == 0.f ? 1.f : l));
    }
    return;
  }

  // A partial per (row b, head g, partition): acc (R, D) and (m, l) per row.
  const size_t pbase = (size_t)(b * G + g) * parts;
  if (n_pages > 0) {
    for (int i = tid; i < R * D; i += SPLIT_THREADS) {
      const int r = i / D, d = i - r * D;
      part_acc[((pbase + part) * R + r) * D + d] = block_acc(r, d);
    }
  }
  for (int r = tid; r < R; r += SPLIT_THREADS) {
    part_ml[((pbase + part) * R + r) * 2] = sM[r];
    part_ml[((pbase + part) * R + r) * 2 + 1] = sL[r];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *sLast = atomicAdd(&counters[b * G + g], 1) == parts - 1;
  __syncthreads();
  if (!*sLast) return;

  // The last block of (b, g) merges every partition's partial, in order.
  __threadfence();
  for (int i = tid; i < R * D; i += SPLIT_THREADS) {
    const int r = i / D, d = i - r * D;
    float m = NEG_INF;
    for (int p = 0; p < parts; ++p) m = fmaxf(m, __ldcg(&part_ml[((pbase + p) * R + r) * 2]));
    float l = 0.f, a = 0.f;
    for (int p = 0; p < parts; ++p) {
      const size_t o = (pbase + p) * R + r;
      const float lp = __ldcg(&part_ml[o * 2 + 1]);
      if (lp != 0.f) {
        const float w = expf(__ldcg(&part_ml[o * 2]) - m);
        l += lp * w;
        a += __ldcg(&part_acc[o * D + d]) * w;
      }
    }
    out_at(r, d) = from_f<T>(a / (l == 0.f ? 1.f : l));
  }
  if (tid == 0) counters[b * G + g] = 0;  // ready for the next launch
}

template <typename T, int D, int RT>
int launch_split(const void* q, const void* k_pool, const void* v_pool, const void* tables, const void* seq_lens,
                 void* out, void* part_acc, void* part_ml, void* counters, int B, int H, int G, int Tq, int nb,
                 int window, int parts, int nb_split, float scale, cudaStream_t stream) {
  auto kern = paged_split_kernel<T, D, RT>;
  constexpr int smem = SplitSmem<sizeof(T), D, RT>::ALLOC;
  static std::atomic<uint32_t> smem_set{0};
  if (int err = allow_smem(kern, smem, smem_set)) return err;
  kern<<<dim3(parts, G, B), SPLIT_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(seq_lens), static_cast<T*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), static_cast<int*>(counters), H, G, Tq, nb,
      window, parts, nb_split, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_split_rows(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                        const void* seq_lens, void* out, void* part_acc, void* part_ml, void* counters, int B, int H,
                        int G, int Tq, int nb, int window, int parts, int nb_split, float scale,
                        cudaStream_t stream) {
  const int rows = (H / G) * Tq;
#define PLLM_SPLIT(RT_)                                                                                      \
  return launch_split<T, D, RT_>(q, k_pool, v_pool, tables, seq_lens, out, part_acc, part_ml, counters, B, H, \
                                 G, Tq, nb, window, parts, nb_split, scale, stream)
  if (rows == 1) PLLM_SPLIT(1);
  if (rows <= 4) PLLM_SPLIT(4);
  PLLM_SPLIT(SPLIT_MAX_ROWS);
#undef PLLM_SPLIT
}

}  // namespace

// q, out: (B, Tq, H, D); k_pool, v_pool: (n_blocks, bs, G, D);
// tables: (B, nb) int32; seq_lens: (B,) int32.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int pllm_paged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const void* tables,
                                 const void* seq_lens, void* out, int B, int H,
                                 int G, int Tq, int D, int bs, int nb,
                                 int window, float scale, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || G <= 0 || H % G != 0 || Tq <= 0 || D <= 0 || bs <= 0 || nb <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, seq_lens, out, B, H, G, Tq, D, bs, nb, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, seq_lens, out, B, H, G, Tq, D, bs, nb, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The split route: D 64 or 128, bs 64, n_rep * Tq <= 16; partition p reads
// table entries [p * nb_split, (p + 1) * nb_split), 1 <= parts <= nb.
// part_acc: (B, G, parts, n_rep * Tq, D) fp32 and part_ml: (B, G, parts,
// n_rep * Tq, 2) fp32, scratch read only when parts > 1; counters: (B * G,)
// int32, zero before the launch and zero again after it. The pools 16-byte
// aligned (cp.async copies 16 bytes).
extern "C" int pllm_paged_decode_split(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                                       const void* seq_lens, void* out, void* part_acc, void* part_ml,
                                       void* counters, int B, int H, int G, int Tq, int D, int bs, int nb,
                                       int window, int parts, int nb_split, float scale, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || G <= 0 || H % G != 0 || Tq <= 0 || nb <= 0 || bs != SPLIT_BS || parts < 1 || parts > nb ||
      nb_split < 1 || (long long)parts * nb_split < nb ||
      (H / G) * Tq > SPLIT_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
#define PLLM_SPLIT_D(TT, DD)                                                                                 \
  if (D == DD)                                                                                               \
    return dispatch_split_rows<TT, DD>(q, k_pool, v_pool, tables, seq_lens, out, part_acc, part_ml, counters, B, \
                                       H, G, Tq, nb, window, parts, nb_split, scale, s);
  if (dtype == 0) { PLLM_SPLIT_D(float, 64) PLLM_SPLIT_D(float, 128) }
  if (dtype == 1) { PLLM_SPLIT_D(__nv_bfloat16, 64) PLLM_SPLIT_D(__nv_bfloat16, 128) }
#undef PLLM_SPLIT_D
  return (int)cudaErrorInvalidValue;
}
