// Flash-attention forward (K1) on Hopper's tensor cores, sm_90a: the bf16
// route. fp32 calls keep the CUDA-core kernel of flash_fwd.cu.
//
// Replaces: pretraining_llm_tpu/ops/pallas_flash.py::_fwd and its kernel
// _fwd_kernel (causal, optional sliding window, optional (B, T) int32
// document segments; GQA by KV head h / n_rep). It computes what
// flash_fwd.cu computes, at the same rounding points: fp32 scores and
// softmax with the finite NEG_INF = -1e30, masked p zeroed by the mask
// itself (_mask_ok: k <= q, q - k < window, seg[q] == seg[k]), P rounded to
// bf16 (V's dtype) before PV, fp32 row sums of the unrounded p, a row with
// no visible key gives zeros, fp32 lse. Tiles are skipped by the causal and
// window rule alone (_run_ok). Head dims 32, 64 and 128.
//
// What bounds it on the H100: causal attention does 2 products of 2*Dh
// FLOPs over the visible (q, k) pairs against q, k, v, o read or written
// once: ~T/4 FLOPs per byte, at gpt2-124m's T = 1024 about 254, just under
// the card's ~295 ridge (bytes bound it, by a hair); longer T is bound by
// operations. So the products must run on the tensor cores, fed without
// stalls.
//
// Design:
//   - One block per (b*h, 64-query tile): one consumer warpgroup and one
//     producer warp (160 threads). Blocks are small so that two (Dh 128)
//     or three (Dh <= 64) share an SM: one block's TMA fill and epilogue
//     run under another's products. Blocks of the longest kv walk (the
//     last query tiles) are launched first.
//   - The producer warp loads the block's Q tile once and the K/V tiles
//     (64 keys) into a 2-stage ring with TMA (128- or 64-byte swizzle,
//     zeros past T), each stage guarded by a full and an empty mbarrier;
//     with segments its lanes also stage the tile's 64 key document ids.
//   - The consumer: S = Q.K^T by wgmma m64n64k16 (bf16 operands from
//     shared memory, fp32 accumulators); the online softmax in registers
//     on the accumulator fragments (row max across each row's four lanes,
//     exp2 with scale*log2(e) folded in, row sums per thread, reduced once
//     at the end); P rounded to bf16 in registers is the A operand of
//     O += P.V (wgmma m64nDk16, V read MN-major from the same swizzled
//     tile). P never touches shared memory. O += P.V is left in flight
//     under the next tile's S and waited for with it.
//   - The mask runs only on tiles that cross the diagonal, the ragged edge
//     or the window's edge, and on every tile when segments are given: two
//     comparisons with the row's visible key range, computed once, and the
//     document ids.
//   - Runs on the caller's stream; allocates nothing. The Python wrapper
//     (ops/cuda_flash.py::flash_attention_fwd) picks this kernel for bf16
//     and counts its launches (launches_tc).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = TILE_ROWS;     // query rows per block
constexpr int BK = TILE_ROWS;     // keys per kv tile
constexpr int STAGES = 2;         // K/V ring depth
constexpr int CONSUMERS = 128;    // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int TILE = TILE_ROWS * D * 2;       // one bf16 tile
  static constexpr int Q = 0;
  static constexpr int KV = TILE;                       // STAGES x (K tile, V tile)
  static constexpr int SEG = KV + STAGES * 2 * TILE;    // STAGES x BK key document ids
  static constexpr int BAR = SEG + STAGES * BK * 4;     // q_full, full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + (1 + 2 * STAGES) * 8 + 1024;  // + room to align the base
};

template <int D>
__global__ void __launch_bounds__(THREADS, D == 128 ? 2 : 3)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const int* __restrict__ seg,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int G, int T_len,
                    int window, float scale_log2) {
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  int* seg_k = reinterpret_cast<int*>(smem + S::SEG);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest kv walk first
  const int b = bh / H;
  const int bg = b * G + (bh - b * H) / (H / G);  // GQA: the group's shared KV head
  const int* segp = seg != nullptr ? seg + (size_t)b * T_len : nullptr;
  // kv tiles that can hold a visible (query, key) pair of this block.
  const int kv_end = min(T_len, q0 + BQ);
  int kv_begin = 0;
  if (window > 0 && q0 - (window - 1) > 0) kv_begin = ((q0 - (window - 1)) / BK) * BK;
  const int n_tiles = (kv_end - kv_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 2);                // the expect_tx arrival and the producer warp's
      mbar_init(&empty[s], CONSUMERS / 32);  // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---------------- producer warp ----------------
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, S::TILE);
      tma_load_tile<D>(smem + S::Q, &qmap, q_full, q0, bh);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const int j0 = kv_begin + i * BK;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      if (lane == 0) {
        uint8_t* kt = smem + S::KV + s * 2 * S::TILE;
        mbar_arrive_expect_tx(&full[s], 2 * S::TILE);
        tma_load_tile<D>(kt, &kmap, &full[s], j0, bg);
        tma_load_tile<D>(kt + S::TILE, &vmap, &full[s], j0, bg);
      }
      if (segp != nullptr)
        for (int c = lane; c < BK; c += 32) seg_k[s * BK + c] = j0 + c < T_len ? segp[j0 + c] : -1;
      warp_arrive(&full[s]);
    }
    return;
  }

  // ---------------- consumer warpgroup ----------------
  const int lane = threadIdx.x & 31;
  const int qa = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);  // rows qa and qb = qa + 8
  const int qb = qa + 8;
  const int cq = 2 * (lane & 3);  // the thread's first column in each 8-column group
  // Each row's visible keys by the causal and window rule: [lo, hi].
  const int hi_a = min(qa, T_len - 1), hi_b = min(qb, T_len - 1);
  const int lo_a = window > 0 ? qa - (window - 1) : 0, lo_b = window > 0 ? qb - (window - 1) : 0;
  int seg_a = 0, seg_b = 0;
  if (segp != nullptr) {
    seg_a = qa < T_len ? segp[qa] : -2;
    seg_b = qb < T_len ? segp[qb] : -2;
  }
  const uint32_t q_tile = smem_u32(smem + S::Q);

  float acc[D / 2];  // O, 64 x D
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;  // running row max, log2 units
  float l_a = 0.f, l_b = 0.f;          // this thread's share of the running row sum
  uint32_t pa[4][4];                   // P in bf16: the A operand of k step kk (keys 16kk..16kk+15)
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int j0 = kv_begin + i * BK;
    const uint32_t k_tile = smem_u32(smem + S::KV + s * 2 * S::TILE);
    const uint32_t v_tile = k_tile + S::TILE;
    mbar_wait(&full[s], (i / STAGES) & 1);
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, kmajor_desc<D>(q_tile, kk), kmajor_desc<D>(k_tile, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();  // this tile's S, and the previous tile's O += P.V
    fence_regs(sc);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    if (i > 0) warp_arrive(&empty[(i - 1) % STAGES]);

    const bool masked = segp != nullptr || j0 + BK - 1 > q0 || j0 + BK > T_len ||
                        (window > 0 && q0 + BQ - 1 - j0 >= window);
    uint32_t ok_bits = 0xffffffffu;
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      int2 sk = make_int2(0, 0);
      if (masked && segp != nullptr) sk = *reinterpret_cast<const int2*>(seg_k + s * BK + 8 * n + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * n + e] * scale_log2;
        if (masked) {
          const int kj = j0 + 8 * n + cq + (e & 1);
          bool ok = e < 2 ? (kj >= lo_a && kj <= hi_a) : (kj >= lo_b && kj <= hi_b);
          if (segp != nullptr) ok = ok && ((e & 1) ? sk.y : sk.x) == (e < 2 ? seg_a : seg_b);
          if (!ok) {
            x = NEG_INF;
            ok_bits &= ~(1u << (4 * n + e));
          }
        }
        sc[4 * n + e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const bool row_a = (e & 2) == 0;
      const float p = ((ok_bits >> e) & 1u) ? exp2f(sc[e] - (row_a ? mn_a : mn_b)) : 0.f;
      sc[e] = p;
      if (row_a) ps_a += p;
      else ps_b += p;
    }
    l_a = l_a * alpha_a + ps_a;
    l_b = l_b * alpha_b + ps_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= alpha_a;
      acc[4 * n + 1] *= alpha_a;
      acc[4 * n + 2] *= alpha_b;
      acc[4 * n + 3] *= alpha_b;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // O += P.V, left in flight under the next tile's S = Q.K^T.
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, pa[kk], mnmajor_desc<D>(v_tile, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float safe_a = l_a == 0.f ? 1.f : l_a, safe_b = l_b == 0.f ? 1.f : l_b;
  const float inv_a = 1.f / safe_a, inv_b = 1.f / safe_b;
  __nv_bfloat16* oa = o + ((size_t)bh * T_len + qa) * D;
  __nv_bfloat16* ob = o + ((size_t)bh * T_len + qb) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + cq;
    if (qa < T_len)
      *reinterpret_cast<__nv_bfloat162*>(oa + c) = __floats2bfloat162_rn(acc[4 * n] * inv_a, acc[4 * n + 1] * inv_a);
    if (qb < T_len)
      *reinterpret_cast<__nv_bfloat162*>(ob + c) =
          __floats2bfloat162_rn(acc[4 * n + 2] * inv_b, acc[4 * n + 3] * inv_b);
  }
  if ((lane & 3) == 0) {
    if (qa < T_len) lse[(size_t)bh * T_len + qa] = (m_a + log2f(safe_a)) * LN2;
    if (qb < T_len) lse[(size_t)bh * T_len + qb] = (m_b + log2f(safe_b)) * LN2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse, int B, int H, int G,
           int T_len, int window, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (int err = make_tile_map<D>(&qmap, q, T_len, B * H)) return err;
  if (int err = make_tile_map<D>(&kmap, k, T_len, B * G)) return err;
  if (int err = make_tile_map<D>(&vmap, v, T_len, B * G)) return err;
  auto kern = flash_fwd_tc_kernel<D>;
  const int smem = Smem<D>::ALLOC;
  static std::atomic<uint32_t> smem_set{0};
  if (int err = allow_smem(kern, smem, smem_set)) return err;
  dim3 grid(B * H, (T_len + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(qmap, kmap, vmap, static_cast<const int*>(seg),
                                        static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, G, T_len,
                                        window, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B*H, T, D) bf16; k, v: (B*G, T, D) bf16, each 16-byte aligned and
// contiguous; seg: (B, T) int32 or null; o like q; lse: (B*H, T) fp32.
// dtype must be 1 (bfloat16); D must be 32, 64 or 128.
extern "C" int pllm_flash_fwd_tc(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
                                 int B, int H, int G, int T_len, int D, int window, float scale, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || B <= 0 || T_len <= 0 || G <= 0 || H % G != 0) return (int)cudaErrorInvalidValue;
  if (D == 32) return launch<32>(q, k, v, seg, o, lse, B, H, G, T_len, window, scale, s);
  if (D == 64) return launch<64>(q, k, v, seg, o, lse, B, H, G, T_len, window, scale, s);
  if (D == 128) return launch<128>(q, k, v, seg, o, lse, B, H, G, T_len, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
