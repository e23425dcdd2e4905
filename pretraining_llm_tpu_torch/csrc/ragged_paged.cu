// Ragged paged attention straight off the KV block pool, for Hopper sm_90a.
//
// Replaces: pretraining_llm_tpu/ops/pallas_ragged.py::_ragged_call with its
// kernels _ragged_kernel (single pass) and _ragged_split_kernel (the KV range
// cut into `splits` partitions), both through _attend_page in its classic
// and AMLA forms, over exact (fp32/bf16) or int8 pools with fp32 or bf16
// scale pages. Row b carries q_lens[b] real queries; query t sits at slot
// seq + t and sees slots <= seq + t (and > seq + t - window with a sliding
// window); queries t >= q_lens[b] are padding and come back as zeros.
//
// What bounds it on the H100: bytes for decode rows (a few FLOPs per byte of
// the row's live pages), operations for long prefill chunks (a 256-query
// chunk does ~4 * 256 FLOPs per K/V element read). This first version runs
// fp32 arithmetic on CUDA cores, so it sits far above either bound; tensor
// cores (mma/wgmma) and cp.async/TMA page loads are later work.
//
// Design (simple first):
//   - The TPU walks the page axis in order and carries (acc, m, l) in VMEM
//     scratch from one grid step to the next. Here one block of 256 threads
//     owns (row b, KV head g, query tile[, partition p]) and walks its pages
//     in a loop, keeping (acc, m, l) in shared memory. Blocks never talk.
//   - Query tiles: the TPU holds all H*T query rows of a row in VMEM; at a
//     256-token chunk with GQA n_rep 4 the fp32 accumulator alone would
//     pass the 227 KB a block may use. A block takes `tq` queries of the
//     row (all n_rep heads of group g for each), so at most about 64 query
//     rows; block row r is query t0 + r / n_rep of head g*n_rep + r % n_rep.
//   - Liveness per tile: a tile walks pages j with j*bs <= seq + t_last,
//     where t_last = min(q_len, t0 + tq) - 1 is its own last real query;
//     with a window it skips pages wholly at or below seq + t0 - window.
//     A tile with no real query reads no page and writes zeros (or empty
//     partials). The split form's partition p walks pages
//     [p*nb_split, min((p+1)*nb_split, nb)) of that range.
//   - Each page's K and V for head g are staged in shared memory as fp32.
//     Classic form: int8 pages are dequantized there as
//     code * (f32(scale) * (1/127)). AMLA form: pages stay raw codes; K's
//     scale multiplies the score columns after the QK dot, V's scale the
//     probability columns before the PV dot.
//   - Online softmax, one warp per query row, NEG_INF = -1e30 (finite) and
//     p zeroed by the mask. Classic: expf, alpha = exp(m_prev - m_new).
//     AMLA: scores carry scale*log2(e), the running max is
//     max(m_prev, ceil(rowmax)), delta = clip(m_prev - m_new, -126, 0) is an
//     integer, p = exp2f(s - m_new) (CUDA's exp2f, not the fast __exp2f
//     approximation), and l and acc are rescaled by adding delta to the
//     fp32 exponent field, guarded for zero/subnormal inputs and underflow.
//   - With exact pools P is rounded to V's dtype before the PV product (the
//     Pallas cast); with int8 pools V is fp32 and P stays fp32.
//   - Single pass: out = acc / l (l == 0 -> zeros) in q's dtype. Split: the
//     unnormalized fp32 partials (acc, m, l) go to buffers the wrapper
//     allocates; ops/cuda_ragged.py combines them with log-sum-exp weights.
//   - Runs on the caller's stream; allocates nothing. The wrapper
//     (ops/cuda_ragged.py::ragged_paged_attention) counts launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// P before the PV product: rounded to V's dtype for exact pools; int8 pools
// multiply an fp32 V, so P stays fp32.
template <typename TKV> __device__ __forceinline__ float round_p(float p) {
  return to_f(from_f<TKV>(p));
}
template <> __device__ __forceinline__ float round_p<int8_t>(float p) { return p; }

// x * 2^k for an integer k in [-126, 0], as an add to the exponent field
// (pallas_ragged.py::_exp2_mul_add): zeros and subnormals stay zero, and an
// underflow flushes to zero instead of borrowing into the sign bit.
__device__ __forceinline__ float exp2_mul_add(float x, int k) {
  const int bits = __float_as_int(x);
  const int exp_field = (bits >> 23) & 0xFF;
  return (exp_field > 0 && exp_field + k > 0) ? __int_as_float(bits + k * (1 << 23)) : 0.f;
}

// Must match ops/cuda_ragged.py::smem_bytes, which refuses shapes above the
// card's per-block limit before launching.
size_t smem_bytes(int rows, int D, int bs) {
  return sizeof(float) * (size_t)(rows * D + bs * (D + 1) + bs * D + rows * bs +
                                  rows * D + 3 * rows + 2 * bs);
}

template <typename TQ, typename TKV, typename TS>
__global__ void __launch_bounds__(THREADS)
ragged_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
              const TKV* __restrict__ v_pool, const TS* __restrict__ k_scale,
              const TS* __restrict__ v_scale, const int* __restrict__ tables,
              const int* __restrict__ seq_lens, const int* __restrict__ q_lens,
              TQ* __restrict__ out, float* __restrict__ acc_p,
              float* __restrict__ m_p, float* __restrict__ l_p, int T, int H,
              int G, int D, int bs, int nb, int window, int splits,
              int nb_split, int tq, int amla, float score_scale) {
  constexpr bool kQuant = sizeof(TKV) == 1;
  extern __shared__ float smem[];
  const int n_rep = H / G;
  const int n_tiles = (T + tq - 1) / tq;
  const int tile = blockIdx.x % n_tiles;
  const int g = (blockIdx.x / n_tiles) % G;
  const int b = blockIdx.x / (n_tiles * G);
  const int part = blockIdx.y;
  const int t0 = tile * tq;
  const int nt = min(tq, T - t0);
  const int R = nt * n_rep;  // query rows of this block
  const int RM = tq * n_rep;  // rows the shared memory is laid out for
  const int LDK = D + 1;
  float* sQ = smem;              // RM x D
  float* sK = sQ + RM * D;       // bs x LDK
  float* sV = sK + bs * LDK;     // bs x D
  float* sS = sV + bs * D;       // RM x bs: scores, then P
  float* sAcc = sS + RM * bs;    // RM x D
  float* sM = sAcc + RM * D;     // RM
  float* sL = sM + RM;           // RM
  float* sA = sL + RM;           // RM: this page's alpha (classic) or delta (AMLA)
  float* sKs = sA + RM;          // bs: AMLA int8 score-column scales
  float* sVs = sKs + bs;         // bs: AMLA int8 probability-column scales
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = THREADS / 32;

  // q, out: (B, T, H, D).
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int t = t0 + r / n_rep, hh = g * n_rep + r % n_rep;
    sQ[i] = to_f(q[(((size_t)b * T + t) * H + hh) * D + d]);
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }

  const int seq = seq_lens[b];
  const int qlen = q_lens[b];
  const int t_last = min(qlen, t0 + nt) - 1;  // last real query of the tile
  int j_lo = 0, j_hi = -1;                    // no page when t_last < t0
  if (t_last >= t0) j_hi = min(nb - 1, (seq + t_last) / bs);
  if (splits > 1) {
    j_lo = part * nb_split;
    j_hi = min(j_hi, min(nb, (part + 1) * nb_split) - 1);
  }
  for (int j = j_lo; j <= j_hi; ++j) {
    if (window > 0 && j * bs + bs - 1 <= seq + t0 - window) continue;  // below every window
    const size_t blk = (size_t)tables[(size_t)b * nb + j];
    __syncthreads();  // the previous page's readers (and the init above) are done
    for (int i = tid; i < bs * D; i += THREADS) {
      const int s = i / D, d = i - s * D;
      const size_t off = ((blk * bs + s) * G + g) * D + d;  // pool (n_blocks, bs, G, D)
      float kx = to_f(k_pool[off]);
      float vx = to_f(v_pool[off]);
      if (kQuant && !amla) {
        const size_t so = (blk * bs + s) * G + g;  // scales (n_blocks, bs, G, 1)
        kx *= to_f(k_scale[so]) * (1.f / 127.f);
        vx *= to_f(v_scale[so]) * (1.f / 127.f);
      }
      sK[s * LDK + d] = kx;
      sV[s * D + d] = vx;
    }
    if (kQuant && amla) {
      for (int s = tid; s < bs; s += THREADS) {
        const size_t so = (blk * bs + s) * G + g;
        sKs[s] = to_f(k_scale[so]) * (1.f / 127.f);
        sVs[s] = to_f(v_scale[so]) * (1.f / 127.f);
      }
    }
    __syncthreads();

    for (int i = tid; i < R * bs; i += THREADS) {
      const int r = i / bs, s = i - r * bs;
      const float* qr = sQ + r * D;
      const float* ks = sK + s * LDK;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qr[d] * ks[d];
      float sc = dot * score_scale;
      if (kQuant && amla) sc *= sKs[s];
      sS[i] = sc;
    }
    __syncthreads();

    for (int r = warp; r < R; r += n_warps) {
      const int t = t0 + r / n_rep;
      const int frontier = seq + t;  // query t's own slot, inclusive
      const bool real = t < qlen;
      float mx = NEG_INF;
      for (int s = lane; s < bs; s += 32) {
        const int lin = j * bs + s;
        const bool ok = real && lin <= frontier && (window <= 0 || lin > frontier - window);
        const float sc = ok ? sS[r * bs + s] : NEG_INF;
        sS[r * bs + s] = sc;
        mx = fmaxf(mx, sc);
      }
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = amla ? fmaxf(m_prev, ceilf(mx)) : fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int s = lane; s < bs; s += 32) {
        const int lin = j * bs + s;
        const bool ok = real && lin <= frontier && (window <= 0 || lin > frontier - window);
        const float sc = sS[r * bs + s];
        const float p = ok ? (amla ? exp2f(sc - m_new) : expf(sc - m_new)) : 0.f;
        psum += p;
        const float pv = (kQuant && amla) ? p * sVs[s] : p;
        sS[r * bs + s] = round_p<TKV>(pv);
      }
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        if (amla) {
          const int delta = (int)fminf(fmaxf(m_prev - m_new, -126.f), 0.f);
          sL[r] = exp2_mul_add(sL[r], delta) + psum;
          sA[r] = (float)delta;
        } else {
          const float alpha = expf(m_prev - m_new);
          sL[r] = sL[r] * alpha + psum;
          sA[r] = alpha;
        }
        sM[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < R * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      const float* pr = sS + r * bs;
      float pv = 0.f;
      for (int s = 0; s < bs; ++s) pv += pr[s] * sV[s * D + d];
      const float a = amla ? exp2_mul_add(sAcc[i], (int)sA[r]) : sAcc[i] * sA[r];
      sAcc[i] = a + pv;
    }
  }
  __syncthreads();

  if (splits > 1) {
    // Partials (B, P, T, H, D) and (B, P, T, H): unnormalized.
    for (int i = tid; i < R * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      const int t = t0 + r / n_rep, hh = g * n_rep + r % n_rep;
      acc_p[((((size_t)b * splits + part) * T + t) * H + hh) * D + d] = sAcc[i];
    }
    for (int r = tid; r < R; r += THREADS) {
      const int t = t0 + r / n_rep, hh = g * n_rep + r % n_rep;
      const size_t o = (((size_t)b * splits + part) * T + t) * H + hh;
      m_p[o] = sM[r];
      l_p[o] = sL[r];
    }
    return;
  }
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int t = t0 + r / n_rep, hh = g * n_rep + r % n_rep;
    const float l = sL[r];
    const float safe_l = (l == 0.f) ? 1.f : l;
    out[(((size_t)b * T + t) * H + hh) * D + d] = from_f<TQ>(sAcc[i] / safe_l);
  }
}

template <typename TQ, typename TKV, typename TS>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* seq_lens, const void* q_lens, void* out, void* acc_p,
           void* m_p, void* l_p, int B, int T, int H, int G, int D, int bs,
           int nb, int window, int splits, int tq, int amla, float score_scale,
           cudaStream_t stream) {
  const int n_rep = H / G;
  const size_t smem = smem_bytes(tq * n_rep, D, bs);
  auto kern = ragged_kernel<TQ, TKV, TS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T + tq - 1) / tq;
  const int nb_split = (nb + splits - 1) / splits;
  dim3 grid((unsigned)B * G * n_tiles, splits);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const TS*>(k_scale),
      static_cast<const TS*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(seq_lens), static_cast<const int*>(q_lens),
      static_cast<TQ*>(out), static_cast<float*>(acc_p),
      static_cast<float*>(m_p), static_cast<float*>(l_p), T, H, G, D, bs, nb,
      window, splits, nb_split, tq, amla, score_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, T, H, D); k_pool, v_pool: (n_blocks, bs, G, D); k_scale,
// v_scale: (n_blocks, bs, G, 1) or null for exact pools; tables: (B, nb)
// int32; seq_lens, q_lens: (B,) int32. splits == 1 writes `out`; splits > 1
// writes the partials acc_p (B, splits, T, H, D) and m_p, l_p
// (B, splits, T, H), all fp32. tq: queries per block. score_scale:
// 1/sqrt(D), times log2(e) under AMLA.
// q_dtype: 0 = float32, 1 = bfloat16. kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8. scale_dtype (int8 only): 0 = float32, 1 = bfloat16.
extern "C" int pllm_ragged_paged(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* seq_lens, const void* q_lens,
                                 void* out, void* acc_p, void* m_p, void* l_p,
                                 int B, int T, int H, int G, int D, int bs,
                                 int nb, int window, int splits, int tq,
                                 int amla, float score_scale, int q_dtype,
                                 int kv_dtype, int scale_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || G <= 0 || H % G != 0 || D <= 0 || bs <= 0 || nb <= 0 ||
      splits <= 0 || tq <= 0)
    return (int)cudaErrorInvalidValue;
#define PLLM_RAGGED(TQ_, TKV_, TS_)                                                  \
  return launch<TQ_, TKV_, TS_>(q, k_pool, v_pool, k_scale, v_scale, tables,        \
                                seq_lens, q_lens, out, acc_p, m_p, l_p, B, T, H, G, \
                                D, bs, nb, window, splits, tq, amla, score_scale, s)
  if (kv_dtype == 0 && q_dtype == 0) PLLM_RAGGED(float, float, float);
  if (kv_dtype == 1 && q_dtype == 1) PLLM_RAGGED(__nv_bfloat16, __nv_bfloat16, float);
  if (kv_dtype == 2) {
    if (q_dtype == 0 && scale_dtype == 0) PLLM_RAGGED(float, int8_t, float);
    if (q_dtype == 0 && scale_dtype == 1) PLLM_RAGGED(float, int8_t, __nv_bfloat16);
    if (q_dtype == 1 && scale_dtype == 0) PLLM_RAGGED(__nv_bfloat16, int8_t, float);
    if (q_dtype == 1 && scale_dtype == 1) PLLM_RAGGED(__nv_bfloat16, int8_t, __nv_bfloat16);
  }
#undef PLLM_RAGGED
  return (int)cudaErrorInvalidValue;
}
