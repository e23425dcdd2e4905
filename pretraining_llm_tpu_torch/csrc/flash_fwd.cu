// Flash-attention forward (FlashAttention-2 schedule) for Hopper, sm_90a.
//
// Replaces: pretraining_llm_tpu/ops/pallas_flash.py::_fwd and its kernel
// _fwd_kernel (causal and sliding-window masks; GQA by KV head h / n_rep).
// Always causal, as every caller is. Document segments and the backward
// kernels belong to the training slice.
//
// What bounds it on the H100: causal attention does ~2*B*H*T^2*Dh FLOPs
// against ~4*B*H*T*Dh*2 bytes of bf16 q/k/v/o, i.e. ~T/4 FLOPs per byte.
// At the serving prefill's T = 1024 that is ~254, just under the card's
// ~295 FLOP/byte ridge (bytes bound it, by a hair); longer prompts are
// bound by operations. This kernel runs its products on the CUDA cores in
// fp32, far below either bound: tensor cores are the first speed lever.
//
// Design (simple first; tensor cores are later work):
//   - One block of 256 threads per (b*h, 64-row query tile). A loop inside
//     the block walks the 64-key KV tiles, taking the place of the TPU
//     kernel's sequential kv grid axis. Tiles past the causal frontier or
//     wholly below the window are never started (_run_ok).
//   - Q, K, V tiles are staged in shared memory as fp32 (rows padded to
//     Dh+1 floats so a warp's column reads hit distinct banks); scores, the
//     online softmax (fp32, NEG_INF = -1e30) and the PV product run on the
//     CUDA cores with fp32 accumulation.
//   - Four threads own one query row: each computes 16 of the tile's 64
//     scores and Dh/4 of the row's outputs; row max and sum are reduced
//     with warp shuffles, so the running (m, l) stats live in registers.
//   - Masked entries get p = 0 explicitly; P is rounded to V's dtype
//     before the PV product, and a row with l == 0 gives zeros (safe_l),
//     exactly as the Pallas kernel does.
//   - The ragged edge (T not a multiple of 64) is masked in the kernel.
//   - Runs on the caller's stream; allocates nothing. The Python wrapper
//     (ops/cuda_flash.py::flash_attention_fwd) counts its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(BQ * (d + 1) + BK * (d + 1) + BK * d + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int G, int T_len, int window,
                 float scale) {
  constexpr int LD = D + 1;
  constexpr int PLD = BK + 1;
  constexpr int DC = D / 4;   // output columns per thread: dd * 4 + c
  constexpr int SC = BK / 4;  // score columns per thread: jj * 4 + c
  extern __shared__ float smem[];
  float* sQ = smem;           // BQ x LD
  float* sK = sQ + BQ * LD;   // BK x LD
  float* sV = sK + BK * LD;   // BK x D
  float* sP = sV + BK * D;    // BQ x PLD

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int b = bh / H;
  const int h = bh - b * H;
  const int bg = b * G + h / (H / G);  // GQA: the group's shared KV head
  const T* qp = q + (size_t)bh * T_len * D;
  const T* kp = k + (size_t)bg * T_len * D;
  const T* vp = v + (size_t)bg * T_len * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c = tid & 3;
  const int qi = q0 + r;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, dd = i - rr * D;
    sQ[rr * LD + dd] = (q0 + rr < T_len) ? to_f(qp[(size_t)(q0 + rr) * D + dd]) : 0.f;
  }

  float acc[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  // Tiles that can hold a valid (query, key) pair for this query tile.
  const int kv_end = min(T_len, q0 + BQ);
  int kv_begin = 0;
  if (window > 0 && q0 - (window - 1) > 0) kv_begin = ((q0 - (window - 1)) / BK) * BK;

  for (int j0 = kv_begin; j0 < kv_end; j0 += BK) {
    __syncthreads();  // every reader of the previous tile is done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int kk = i / D, dd = i - kk * D;
      const bool in = j0 + kk < T_len;
      const size_t off = (size_t)(j0 + kk) * D + dd;
      sK[kk * LD + dd] = in ? to_f(kp[off]) : 0.f;
      sV[kk * D + dd] = in ? to_f(vp[off]) : 0.f;
    }
    __syncthreads();

    float s[SC];
#pragma unroll
    for (int jj = 0; jj < SC; ++jj) s[jj] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float qd = sQ[r * LD + dd];
#pragma unroll
      for (int jj = 0; jj < SC; ++jj) s[jj] += qd * sK[(jj * 4 + c) * LD + dd];
    }

    unsigned ok_bits = 0u;
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < SC; ++jj) {
      const int kj = j0 + jj * 4 + c;
      bool ok = kj < T_len && kj <= qi;
      if (window > 0) ok = ok && (qi - kj < window);
      s[jj] = ok ? s[jj] * scale : NEG_INF;
      ok_bits |= (ok ? 1u : 0u) << jj;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < SC; ++jj) {
      const float p = ((ok_bits >> jj) & 1u) ? expf(s[jj] - m_new) : 0.f;
      psum += p;
      sP[r * PLD + jj * 4 + c] = to_f(from_f<T>(p));  // P in V's dtype
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // row r's P is written and read by the same four lanes

#pragma unroll
    for (int i = 0; i < DC; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float p = sP[r * PLD + kk];
#pragma unroll
      for (int i = 0; i < DC; ++i) acc[i] += p * sV[kk * D + i * 4 + c];
    }
  }

  if (qi < T_len) {
    const float safe_l = (l == 0.f) ? 1.f : l;
    T* orow = o + ((size_t)bh * T_len + qi) * D;
#pragma unroll
    for (int i = 0; i < DC; ++i) orow[i * 4 + c] = from_f<T>(acc[i] / safe_l);
    if (c == 0) lse[(size_t)bh * T_len + qi] = m + logf(safe_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int G, int T_len, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, G, T_len, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B*H, T, D); k, v: (B*G, T, D); o like q; lse: (B*H, T) fp32.
// dtype: 0 = float32, 1 = bfloat16. D must be 64 or 128.
extern "C" int pllm_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int G,
                              int T_len, int D, int window, float scale,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_len <= 0 || G <= 0 || H % G != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, lse, B, H, G, T_len, window, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, lse, B, H, G, T_len, window, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, G, T_len, window, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, G, T_len, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
