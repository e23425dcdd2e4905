// Paged decode attention straight off the KV block pool, for Hopper sm_90a.
//
// Replaces: pretraining_llm_tpu/ops/pallas_paged.py::_paged_call and its
// kernel _paged_kernel (T uniform queries per row; query t of a row sees
// slots <= seq + t, and > seq + t - window with a sliding window).
//
// What bounds it on the H100: bytes. Each (row, KV head) reads its live
// pages once -- bs * Dh K and V elements per page -- and does ~4 * n_rep *
// T FLOPs per element read: a few FLOPs per byte against the card's ~295
// FLOP/byte ridge, so the limit is the memory rate.
//
// Design (simple first):
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
//   - Runs on the caller's stream; allocates nothing. The Python wrapper
//     (ops/cuda_paged.py::paged_decode_attention) counts its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
