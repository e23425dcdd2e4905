// Flash-attention backward (FlashAttention-2) for Hopper, sm_90a: three
// kernels, dQ, dK/dV and one pass, on the CUDA cores: the fp32 route. bf16
// calls run the tensor-core kernels of flash_bwd_tc.cu; every C entry here
// takes fp32 only.
//
// Replaces, in pretraining_llm_tpu/ops/pallas_flash.py::_bwd:
//   _bwd_dq_kernel    -> flash_bwd_dq_kernel    (pllm_flash_bwd_dq)
//   _bwd_dkv_kernel   -> flash_bwd_dkv_kernel   (pllm_flash_bwd_dkv)
//   _bwd_fused_kernel -> flash_bwd_dkv_kernel<..., true> + flash_bwd_dq_merge_kernel
//                        (pllm_flash_bwd_fused)
// The wrapper (ops/cuda_flash.py::flash_attention_bwd) picks between the
// one-pass kernel and the dQ + dK/dV pair with the TPU dispatch rule
// (_block_sizes: one q block and one kv block -> one pass), so both
// packages run the same algorithm for every shape. Always causal, with an
// optional sliding window and optional document segments ((B, T) int32
// ids, or null): the mask is _mask_ok's, q >= k, q - k < window and
// seg[q] == seg[k]; tiles are skipped by _run_ok's causal/window rule.
//
// Math (per query row i, key j, scale = 1/sqrt(Dh)):
//   p  = exp(q.k * scale - lse_i), zeroed where the causal/window/segment mask fails
//   dp = dO_i . v_j;  ds = p * (dp - D_i) * scale,  D_i = rowsum(dO_i * O_i)
//   dQ_i = sum_j ds.k_j;  dK_j = sum_i ds.q_i;  dV_j = sum_i p.dO_i
// D (delta) and lse come from the wrapper and the forward (K1), in fp32.
// Rounding points follow the Pallas kernels: every product takes operands
// in the compute dtype with fp32 accumulation; P is rounded to dO's dtype
// before P^T.dO, dS to K's dtype before dS.K and to Q's before dS^T.Q;
// dq, dk, dv are written in q's, k's and v's dtype.
//
// What bounds it on the H100: the one-pass kernel does 5 products of
// 2*Dh FLOPs over the visible (i, j) pairs, the split pair 7, against the
// bytes of q, k, v, dO, lse, D read once and dq, dk, dv written once. At
// gpt2-124m's T = 1024, Dh 64, bf16, that is ~360 FLOPs per byte, above
// the card's ~295 ridge: operations bound it. These kernels run their
// products on the CUDA cores in fp32 (67 TFLOP/s at most), which is what
// fp32 operands need: TF32 tensor-core products would miss the fp32 bars.
//
// Design (simple first):
//   - 64-row query tiles and 64-key KV tiles, 256 threads: four threads
//     own one row of a tile, each computing 16 of the 64 scores (columns
//     jj*4 + c) and Dh/4 of the row's outputs, as in K1 (flash_fwd.cu).
//     Tiles are staged in shared memory as fp32, rows padded to Dh+1.
//   - The TPU carries accumulators across its innermost grid axis; CUDA
//     blocks run in no order, so a loop inside the block walks those tiles:
//       dQ:   one block per (b*h, q tile) walks the kv tiles the query
//             tile can see (the forward's _run_ok range); dQ in registers.
//       dK/dV: one block per (b*g, kv tile) walks the q tiles of each of
//             the group's n_rep query heads that can see it; dK and dV
//             accumulate in registers.
//       one pass: the dK/dV walk, and each (q tile, kv tile) pair's dQ
//             contribution dS.K is written to that kv tile's fp32 partial
//             of the query rows; a second kernel sums each row's partials
//             in kv-tile order and writes dq in q's dtype. S and P are
//             built once per pair: 5 products where the split takes 7. The
//             TPU kernel held all of T in VMEM with a (T, T) S; a Hopper
//             block has 227 KB, so it is tiled like FA2.
//   - Every sum runs in a fixed order (no atomics), so a repeat launch
//     gives the same bits, as on the tensor-core route.
//   - Tiles that no (query, key) pair can reach are never started
//     (_run_ok); the mask is _mask_ok's predicate, q >= k and, with a
//     window, q - k < window and, with segments, seg[q] == seg[k]; the
//     ragged edge (T not a multiple of 64) is masked in the kernel. P is
//     zeroed by the mask itself, never by exp underflow.
//   - Runs on the caller's stream; allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to T and back: the compute-dtype operand of a product.
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ bool visible(int qi, int kj, int T_len, int window) {
  bool ok = qi < T_len && kj < T_len && kj <= qi;
  if (window > 0) ok = ok && (qi - kj < window);
  return ok;
}

// Rows [r0, r0 + 64) of a (T_len, D) matrix into shared memory as fp32,
// leading dimension D + 1; rows past T_len are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int T_len) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int rr = i / D, dd = i - rr * D;
    dst[rr * (D + 1) + dd] = (r0 + rr < T_len) ? to_f(src[(size_t)(r0 + rr) * D + dd]) : 0.f;
  }
}

constexpr size_t dq_smem(int d) {
  return sizeof(float) * (size_t)(4 * 64 * (d + 1) + BQ * (BK + 1));
}
constexpr size_t dkv_smem(int d) {
  return sizeof(float) * (size_t)(4 * 64 * (d + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

// ---------------------------------------------------------------------------
// dQ (_bwd_dq_kernel): one block per (b*h, q tile).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ seg, T* __restrict__ dq, int H, int G, int T_len,
                    int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int PLD = BK + 1;
  constexpr int DC = D / 4;
  constexpr int SC = BK / 4;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + 64 * LD;
  float* sK = sDO + 64 * LD;
  float* sV = sK + 64 * LD;
  float* sDS = sV + 64 * LD;  // BQ x PLD
  __shared__ int sSegK[BK];   // document ids of the staged keys

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest kv walks first
  const int b = bh / H;
  const int h = bh - b * H;
  const int bg = b * G + h / (H / G);
  const T* qp = q + (size_t)bh * T_len * D;
  const T* dop = dout + (size_t)bh * T_len * D;
  const T* kp = k + (size_t)bg * T_len * D;
  const T* vp = v + (size_t)bg * T_len * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c = tid & 3;
  const int qi = q0 + r;

  stage<T, D>(sQ, qp, q0, T_len);
  stage<T, D>(sDO, dop, q0, T_len);
  const float lse_r = qi < T_len ? lse[(size_t)bh * T_len + qi] : 0.f;
  const float delta_r = qi < T_len ? delta[(size_t)bh * T_len + qi] : 0.f;
  const int* segp = seg != nullptr ? seg + (size_t)b * T_len : nullptr;
  const int seg_q = (segp != nullptr && qi < T_len) ? segp[qi] : 0;

  float acc[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) acc[i] = 0.f;

  const int kv_end = min(T_len, q0 + BQ);
  int kv_begin = 0;
  if (window > 0 && q0 - (window - 1) > 0) kv_begin = ((q0 - (window - 1)) / BK) * BK;

  for (int j0 = kv_begin; j0 < kv_end; j0 += BK) {
    __syncthreads();  // every reader of the previous tile is done
    stage<T, D>(sK, kp, j0, T_len);
    stage<T, D>(sV, vp, j0, T_len);
    if (segp != nullptr && tid < BK) sSegK[tid] = (j0 + tid < T_len) ? segp[j0 + tid] : -1;
    __syncthreads();

    float s[SC], dp[SC];
#pragma unroll
    for (int jj = 0; jj < SC; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float qd = sQ[r * LD + dd];
      const float od = sDO[r * LD + dd];
#pragma unroll
      for (int jj = 0; jj < SC; ++jj) {
        s[jj] += qd * sK[(jj * 4 + c) * LD + dd];
        dp[jj] += od * sV[(jj * 4 + c) * LD + dd];
      }
    }
#pragma unroll
    for (int jj = 0; jj < SC; ++jj) {
      const int kj = j0 + jj * 4 + c;
      const bool ok = visible(qi, kj, T_len, window) && (segp == nullptr || sSegK[jj * 4 + c] == seg_q);
      const float p = ok ? expf(s[jj] * scale - lse_r) : 0.f;
      sDS[r * PLD + jj * 4 + c] = rnd<T>(p * (dp[jj] - delta_r) * scale);  // dS in K's dtype
    }
    __syncwarp();  // row r's dS is written and read by the same four lanes

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = sDS[r * PLD + kk];
#pragma unroll
      for (int i = 0; i < DC; ++i) acc[i] += ds * sK[kk * LD + i * 4 + c];
    }
  }

  if (qi < T_len) {
    T* row = dq + ((size_t)bh * T_len + qi) * D;
#pragma unroll
    for (int i = 0; i < DC; ++i) row[i * 4 + c] = from_f<T>(acc[i]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV (_bwd_dkv_kernel) and, with FUSED, the one-pass kernel
// (_bwd_fused_kernel): one block per (b*g, kv tile).
// ---------------------------------------------------------------------------
// With FUSED, dq_part is (T / 64 kv tiles, B*H, T, D) fp32: kv tile j's
// contribution to each query row it sees.
template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seg, float* __restrict__ dq_part, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int G, int T_len, int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int PLD = BQ + 1;
  constexpr int DC = D / 4;
  constexpr int SC = BQ / 4;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + 64 * LD;
  float* sQ = sV + 64 * LD;
  float* sDO = sQ + 64 * LD;
  float* sP = sDO + 64 * LD;  // BK x PLD, row = key, column = query
  float* sDS = sP + BK * PLD;  // BK x PLD
  float* sL = sDS + BK * PLD;  // BQ lse of the staged q tile
  float* sD = sL + BQ;         // BQ delta
  __shared__ int sSegQ[BQ];    // document ids of the staged q tile

  const int bg = blockIdx.y;
  const int k0 = blockIdx.x * BK;  // k0 = 0 walks the most q tiles: first
  const int b = bg / G;
  const int g = bg - b * G;
  const int n_rep = H / G;
  const T* kp = k + (size_t)bg * T_len * D;
  const T* vp = v + (size_t)bg * T_len * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // key row of the tile (query row in the dQ phase)
  const int c = tid & 3;
  const int kj = k0 + r;
  const int* segp = seg != nullptr ? seg + (size_t)b * T_len : nullptr;
  const int seg_k = (segp != nullptr && kj < T_len) ? segp[kj] : 0;

  stage<T, D>(sK, kp, k0, T_len);
  stage<T, D>(sV, vp, k0, T_len);

  float dk_acc[DC], dv_acc[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // q tiles that can see this kv tile: from the diagonal up to the last
  // query inside the window of the tile's last key.
  const int q_begin = (k0 / BQ) * BQ;
  const int q_end = window > 0 ? min(T_len, k0 + BK - 1 + window) : T_len;

  for (int rep = 0; rep < n_rep; ++rep) {
    const int bh = b * H + g * n_rep + rep;
    const T* qp = q + (size_t)bh * T_len * D;
    const T* dop = dout + (size_t)bh * T_len * D;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // every reader of the previous q tile is done
      stage<T, D>(sQ, qp, q0, T_len);
      stage<T, D>(sDO, dop, q0, T_len);
      if (tid < BQ) {
        const bool in = q0 + tid < T_len;
        sL[tid] = in ? lse[(size_t)bh * T_len + q0 + tid] : 0.f;
        sD[tid] = in ? delta[(size_t)bh * T_len + q0 + tid] : 0.f;
        if (segp != nullptr) sSegQ[tid] = in ? segp[q0 + tid] : -1;
      }
      __syncthreads();

      float s[SC], dp[SC];
#pragma unroll
      for (int jj = 0; jj < SC; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) {
        const float kd = sK[r * LD + dd];
        const float vd = sV[r * LD + dd];
#pragma unroll
        for (int jj = 0; jj < SC; ++jj) {
          s[jj] += kd * sQ[(jj * 4 + c) * LD + dd];
          dp[jj] += vd * sDO[(jj * 4 + c) * LD + dd];
        }
      }
#pragma unroll
      for (int jj = 0; jj < SC; ++jj) {
        const int qq = jj * 4 + c;
        const bool ok = visible(q0 + qq, kj, T_len, window) && (segp == nullptr || sSegQ[qq] == seg_k);
        const float p = ok ? expf(s[jj] * scale - sL[qq]) : 0.f;
        sP[r * PLD + qq] = rnd<T>(p);                                 // P in dO's dtype
        sDS[r * PLD + qq] = rnd<T>(p * (dp[jj] - sD[qq]) * scale);    // dS in Q's dtype
      }
      if (FUSED) {
        __syncthreads();  // the dQ phase reads every key row's dS
        const int qi = q0 + r;
        if (qi < T_len) {
          float part[DC];
#pragma unroll
          for (int i = 0; i < DC; ++i) part[i] = 0.f;
#pragma unroll 4
          for (int kk = 0; kk < BK; ++kk) {
            const float ds = sDS[kk * PLD + r];
#pragma unroll
            for (int i = 0; i < DC; ++i) part[i] += ds * sK[kk * LD + i * 4 + c];
          }
          const size_t bh_total = (size_t)gridDim.y * n_rep;
          float* row = dq_part + (((size_t)blockIdx.x * bh_total + bh) * T_len + qi) * D;
#pragma unroll
          for (int i = 0; i < DC; ++i) row[i * 4 + c] = part[i];
        }
      } else {
        __syncwarp();  // key row r's P and dS are written and read by its four lanes
      }

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        const float p = sP[r * PLD + qq];
        const float ds = sDS[r * PLD + qq];
#pragma unroll
        for (int i = 0; i < DC; ++i) {
          dv_acc[i] += p * sDO[qq * LD + i * 4 + c];
          dk_acc[i] += ds * sQ[qq * LD + i * 4 + c];
        }
      }
    }
  }

  if (kj < T_len) {
    T* krow = dk + ((size_t)bg * T_len + kj) * D;
    T* vrow = dv + ((size_t)bg * T_len + kj) * D;
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      krow[i * 4 + c] = from_f<T>(dk_acc[i]);
      vrow[i * 4 + c] = from_f<T>(dv_acc[i]);
    }
  }
}

// dQ of the one pass: each element the sum of its kv tiles' partials in
// kv-tile order. The kv tiles a query tile sees are the dQ kernel's range
// (the forward's _run_ok), exactly those whose blocks wrote its partials.
// One thread per (b*h, query, column), grid-stride.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_merge_kernel(const float* __restrict__ dq_part, T* __restrict__ dq, int BH, int T_len, int D,
                          int window) {
  const size_t n = (size_t)BH * T_len * D;  // one kv tile's partials
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += (size_t)gridDim.x * THREADS) {
    const int qi = (int)((i / D) % T_len);
    const int q0 = (qi / BQ) * BQ;
    const int kv_end = min(T_len, q0 + BQ);
    int kv_begin = 0;
    if (window > 0 && q0 - (window - 1) > 0) kv_begin = ((q0 - (window - 1)) / BK) * BK;
    float acc = 0.f;
    for (int j0 = kv_begin; j0 < kv_end; j0 += BK) acc += dq_part[(size_t)(j0 / BK) * n + i];
    dq[i] = from_f<T>(acc);
  }
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* seg, void* dq, int B, int H, int G, int T_len,
              int window, float scale, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  const size_t smem = dq_smem(D);
  if (int err = set_smem(kern, smem)) return err;
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<T*>(dq), H, G,
      T_len, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool FUSED>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* seg, void* dq_part, void* dk, void* dv, int B, int H,
               int G, int T_len, int window, float scale, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, D, FUSED>;
  const size_t smem = dkv_smem(D);
  if (int err = set_smem(kern, smem)) return err;
  dim3 grid((T_len + BK - 1) / BK, B * G);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<float*>(dq_part),
      static_cast<T*>(dk),
      static_cast<T*>(dv), H, G, T_len, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_fused(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, const void* seg, void* dq, void* dk, void* dv, void* dq_part, int B,
                 int H, int G, int T_len, int window, float scale, cudaStream_t stream) {
  if (int err = launch_dkv<T, D, true>(q, k, v, dout, lse, delta, seg, dq_part, dk, dv, B, H, G, T_len, window,
                                       scale, stream)) {
    return err;
  }
  const size_t n = (size_t)B * H * T_len * D;
  const int blocks = (int)((n + THREADS - 1) / THREADS < 132 * 8 ? (n + THREADS - 1) / THREADS : 132 * 8);
  flash_bwd_dq_merge_kernel<T><<<blocks, THREADS, 0, stream>>>(static_cast<const float*>(dq_part),
                                                               static_cast<T*>(dq), B * H, T_len, D, window);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int G, int T_len) {
  return B <= 0 || T_len <= 0 || G <= 0 || H % G != 0;
}

}  // namespace

// q, dout: (B*H, T, D); k, v: (B*G, T, D); lse, delta: (B*H, T) fp32; seg:
// (B, T) int32 document ids or null. dtype must be 0 (float32). D must be
// 32, 64 or 128.
#define PLLM_DISPATCH(CALL)                                                 \
  if (dtype == 0 && D == 32) return CALL(float, 32);                        \
  if (dtype == 0 && D == 64) return CALL(float, 64);                        \
  if (dtype == 0 && D == 128) return CALL(float, 128);                      \
  return (int)cudaErrorInvalidValue;

// dq like q.
extern "C" int pllm_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* seg, void* dq, int B, int H, int G, int T_len, int D,
                                 int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, G, T_len)) return (int)cudaErrorInvalidValue;
#define CALL(T, DD) launch_dq<T, DD>(q, k, v, dout, lse, delta, seg, dq, B, H, G, T_len, window, scale, s)
  PLLM_DISPATCH(CALL)
#undef CALL
}

// dk, dv like k, v.
extern "C" int pllm_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  const void* seg, void* dk, void* dv, int B, int H, int G, int T_len,
                                  int D,
                                  int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, G, T_len) || dtype != 0) return (int)cudaErrorInvalidValue;
  if (D == 32) return launch_dkv<float, 32, false>(q, k, v, dout, lse, delta, seg, nullptr, dk, dv, B, H, G,
                                                   T_len, window, scale, s);
  if (D == 64) return launch_dkv<float, 64, false>(q, k, v, dout, lse, delta, seg, nullptr, dk, dv, B, H, G,
                                                   T_len, window, scale, s);
  if (D == 128) return launch_dkv<float, 128, false>(q, k, v, dout, lse, delta, seg, nullptr, dk, dv, B, H, G,
                                                     T_len, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// dq, dk, dv like q, k, v; dq_part: (ceil(T / 64), B*H, T, D) fp32 scratch
// (no zeroing needed: the merge reads only the partials the kernel wrote).
extern "C" int pllm_flash_bwd_fused(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* seg, void* dq, void* dk, void* dv, void* dq_part, int B,
                                    int H, int G, int T_len, int D, int window, float scale, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, G, T_len)) return (int)cudaErrorInvalidValue;
#define CALL(T, DD) launch_fused<T, DD>(q, k, v, dout, lse, delta, seg, dq, dk, dv, dq_part, B, H, G, \
                                        T_len, window, scale, s)
  PLLM_DISPATCH(CALL)
#undef CALL
}
