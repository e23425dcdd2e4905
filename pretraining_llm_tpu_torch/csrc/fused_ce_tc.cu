// Fused cross-entropy forward on Hopper's tensor cores, sm_90a: the bf16
// route of B9. fp32 keeps ce_kernel<float, D, FWD> of fused_ce.cu
// (ops/cuda_ce.py::ce_route): wgmma's fp32 form is TF32, which would miss
// the fp32 bars.
//
// Replaces: pretraining_llm_tpu/ops/pallas_ce.py::_fwd_kernel (its
// pallas_call in _ce_fwd): per token s, the online log-sum-exp over
// vocabulary tiles of logits[s, v] = h[s] . W[v] (bf16 operands, fp32
// sums), the label's logit, and loss = lse - label logit, with the
// vocabulary columns >= V at NEG_INF (_logits_tile).
//
// What bounds it on the H100: operations. 2 * S * D * V = 0.95 TFLOP at
// gpt2-124m's training head (S 12288, D 768, V 50304) against ~97 MB of
// operands: 0.96 ms at the bf16 peak, far above the ~295 FLOP/byte ridge.
// So the products run on the tensor cores (wgmma), fed by TMA, and the
// softmax runs on the accumulator fragments.
//
// Design:
//   - One block per (128-token tile, vocabulary partition): one producer
//     warp and two consumer warpgroups (288 threads), each warpgroup 64
//     token rows as the M of wgmma m64n256k16. The block walks its
//     partition's vocabulary tiles of BN = 256 columns; a tile is D / 64
//     products over 64-column slices of D, summed in the accumulator in a
//     fixed order.
//   - Operands: h (S, D) and W (V, D), both K-major as they lie (for the
//     tied head W is the embedding itself, no copy), streamed by the
//     producer with TMA in 64-column, 128-byte-swizzled slices (h: 128
//     rows, W: 256 rows) through a 4-stage mbarrier ring of 48 KB stages.
//     The producer runs ahead across tile boundaries, so the next tile's
//     slices load during a tile's epilogue. Rows past S and past V arrive
//     as TMA zeros; rows past S are never written.
//   - Epilogue on the fp32 accumulator fragments, per tile: columns >= V
//     set to NEG_INF (in the last tile only), the label's logit picked
//     where a fragment column equals the row's label (in the tile that
//     holds it only), the row max across each row's four lanes, then the
//     online (m, l) in fp32 with exp(x - m) as exp2(x log2 e - m log2 e).
//     Each thread keeps its share of l for its two rows; the four lanes'
//     shares are added once, after the walk.
//   - Filling the card: ceil(S / 128) token tiles (96 at T3) do not fill
//     132 SMs, so the vocabulary is cut into P partitions of whole tiles
//     (ops/cuda_ce.py::ce_partitions: the P <= 16 with the fewest block
//     waves x tiles per block; 11 at T3, 1056 blocks = 8 waves). With
//     P > 1 each block writes its (m, l, gold) per token as fp32 partials
//     and takes a ticket from its token tile's arrival counter; the last
//     block to arrive merges the P partials in partition order (m = max,
//     l = sum l_p exp(m_p - m), gold = sum gold_p), writes lse = m + log l
//     and loss = lse - gold, and resets the counter to 0. The merge order
//     does not depend on which block came last, and each product's order
//     is fixed: a repeat launch gives the same bits.
//   - L2 traffic: a block reads its h tile and one W tile per vocabulary
//     tile, (128 + 256) * D * 2 bytes for each 128 x 256 logits: 11.1 GB at
//     T3's head, against ~29.7 GB for fused_ce.cu's 32-row blocks, each of
//     which reads all of W. Blocks of one partition run together (the
//     token tile is blockIdx.x), so a partition's W (77 MB / P) and h
//     (19 MB) stay in the 50 MB L2 while they walk.
//   - Runs on the caller's stream; allocates nothing (partials and counters
//     are the wrapper's scratch). The wrapper (ops/cuda_ce.py::fused_ce_fwd)
//     picks this kernel by ce_route and counts its launches.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;  // token rows of a block: two consumer warpgroups of 64
constexpr int BN = 256;  // vocabulary columns of a tile: the wgmma N
constexpr int BK = 64;   // columns of D in a slice: one 128-byte swizzle span
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, in bytes. ops/cuda_ce.py::tc_smem_bytes
// repeats this arithmetic.
struct Smem {
  static constexpr int H_SLICE = BM * BK * 2;        // 64 columns of the h tile
  static constexpr int W_SLICE = BN * BK * 2;        // 64 columns of a W tile
  static constexpr int STAGE = H_SLICE + W_SLICE;    // one ring stage
  static constexpr int BAR = STAGES * STAGE;         // full[STAGES], empty[STAGES]
  static constexpr int FLAG = BAR + 2 * STAGES * 8;  // the last-block flag
  static constexpr int ALLOC = FLAG + 16 + 1024;     // + room to align the base
};

__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_tc_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
                 const int* __restrict__ labels, float* __restrict__ loss, float* __restrict__ lse,
                 float* __restrict__ part, int* __restrict__ counters, int S, int V, int D, int parts,
                 int tiles_per_part) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem::BAR);
  uint64_t* empty = full + STAGES;
  int* sLast = reinterpret_cast<int*>(smem + Smem::FLAG);

  const int tok0 = blockIdx.x * BM;
  const int pidx = blockIdx.y;
  const int n_vt = (V + BN - 1) / BN;
  const int vt_lo = pidx * tiles_per_part;
  const int vt_hi = min(n_vt, vt_lo + tiles_per_part);
  const int n_k = D / BK;
  const int n_slices = max(0, vt_hi - vt_lo) * n_k;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                // the producer's expect_tx arrival
      mbar_init(&empty[s], CONSUMERS / 32);  // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---------------- producer warp (one lane) ----------------
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < n_slices; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        uint8_t* st = smem + s * Smem::STAGE;
        const int vt = vt_lo + i / n_k, kc = (i % n_k) * BK;
        mbar_arrive_expect_tx(&full[s], Smem::STAGE);
        tma_load_2d(st, &hmap, &full[s], kc, tok0);
        tma_load_2d(st + Smem::H_SLICE, &wmap, &full[s], kc, vt * BN);
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int ra = tok0 + wg * 64 + (tid >> 5) * 16 + (lane >> 2);  // the thread's rows ra and rb = ra + 8
  const int rb = ra + 8;
  const int cq = 2 * (lane & 3);  // its first column in each 8-column group
  const int lab_a = ra < S ? labels[ra] : -1;
  const int lab_b = rb < S ? labels[rb] : -1;
  float m_a = NEG_INF, m_b = NEG_INF;  // running row max (shared by the row's four lanes)
  float l_a = 0.f, l_b = 0.f;          // this thread's share of the running row sum
  float gold_a = 0.f, gold_b = 0.f;    // the label's logit, in the one lane that holds it

  float acc[BN / 2];  // logits, 64 x 256
  int i = 0;          // ring slice
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    fence_regs(acc);
    for (int kk = 0; kk < n_k; ++kk, ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint32_t a_tile = smem_u32(smem + s * Smem::STAGE) + wg * 64 * 128;
      const uint32_t b_tile = smem_u32(smem + s * Smem::STAGE + Smem::H_SLICE);
      wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < BK / 16; ++k4)
        wgmma_ss_n256(acc, kmajor_desc<64>(a_tile, k4), kmajor_desc<64, BN>(b_tile, k4), 1);
      wgmma_commit();
      if (kk > 0) {
        wgmma_wait<1>();  // the previous slice's products are done: free its stage
        warp_arrive(&empty[(i - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    warp_arrive(&empty[(i - 1) % STAGES]);

    const int col0 = vt * BN;
    if (col0 + BN > V) {  // the vocabulary tail: NEG_INF, as _logits_tile
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col0 + 8 * n + cq + (e & 1) >= V) acc[4 * n + e] = NEG_INF;
    }
    if (lab_a >= col0 && lab_a < col0 + BN) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col0 + 8 * n + cq + e == lab_a) gold_a += acc[4 * n + e];
    }
    if (lab_b >= col0 && lab_b < col0 + BN) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col0 + 8 * n + cq + e == lab_b) gold_b += acc[4 * n + 2 + e];
    }
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(acc[4 * n], acc[4 * n + 1]));
      mx_b = fmaxf(mx_b, fmaxf(acc[4 * n + 2], acc[4 * n + 3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float sa = mn_a * LOG2E, sb = mn_b * LOG2E;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      ps_a += exp2f(fmaf(acc[4 * n], LOG2E, -sa)) + exp2f(fmaf(acc[4 * n + 1], LOG2E, -sa));
      ps_b += exp2f(fmaf(acc[4 * n + 2], LOG2E, -sb)) + exp2f(fmaf(acc[4 * n + 3], LOG2E, -sb));
    }
    l_a = l_a * exp2f((m_a - mn_a) * LOG2E) + ps_a;
    l_b = l_b * exp2f((m_b - mn_b) * LOG2E) + ps_b;
    m_a = mn_a;
    m_b = mn_b;
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    gold_a += __shfl_xor_sync(0xffffffffu, gold_a, off);
    gold_b += __shfl_xor_sync(0xffffffffu, gold_b, off);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= S) continue;
      const float m = half ? m_b : m_a, l = half ? l_b : l_a, gold = half ? gold_b : gold_a;
      if (parts == 1) {
        const float x = m + logf(l);
        lse[r] = x;
        loss[r] = x - gold;
      } else {  // partials (P, 3, S): m, l, gold
        part[((size_t)pidx * 3 + 0) * S + r] = m;
        part[((size_t)pidx * 3 + 1) * S + r] = l;
        part[((size_t)pidx * 3 + 2) * S + r] = gold;
      }
    }
  }
  if (parts == 1) return;

  __threadfence();
  named_sync(1, CONSUMERS);
  if (threadIdx.x == 0) *sLast = atomicAdd(&counters[blockIdx.x], 1) == parts - 1;
  named_sync(1, CONSUMERS);
  if (!*sLast) return;

  // The last block of this token tile merges the P partials, in order.
  __threadfence();
  if (threadIdx.x < BM && tok0 + (int)threadIdx.x < S) {
    const int r = tok0 + threadIdx.x;
    float m = NEG_INF;
    for (int p = 0; p < parts; ++p) m = fmaxf(m, __ldcg(&part[((size_t)p * 3) * S + r]));
    float l = 0.f, gold = 0.f;
    for (int p = 0; p < parts; ++p) {
      l += __ldcg(&part[((size_t)p * 3 + 1) * S + r]) * expf(__ldcg(&part[((size_t)p * 3) * S + r]) - m);
      gold += __ldcg(&part[((size_t)p * 3 + 2) * S + r]);
    }
    const float x = m + logf(l);
    lse[r] = x;
    loss[r] = x - gold;
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

}  // namespace

// h: (S, D) bf16; w: (V, D) bf16 (16-byte aligned, D a multiple of 64);
// labels: (S,) int32; loss, lse: (S,) fp32. The vocabulary's ceil(V / 256)
// tiles are cut into `parts` partitions of `tiles_per_part` tiles. With
// parts > 1, part: (parts, 3, S) fp32 scratch and counters: (ceil(S / 128),)
// int32, zero before the launch and zero again after it.
extern "C" int pllm_ce_fwd_tc(const void* h, const void* w, const void* labels, void* loss, void* lse, void* part,
                              void* counters, int S, int V, int D, int parts, int tiles_per_part, void* stream) {
  const int n_vt = (V + BN - 1) / BN;
  if (S <= 0 || V <= 0 || D <= 0 || D % BK != 0 || parts < 1 || tiles_per_part < 1 ||
      (long long)parts * tiles_per_part < n_vt || (parts - 1) * tiles_per_part >= n_vt)
    return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  if (int err = make_row_map(&hmap, h, S, D, BM)) return err;
  if (int err = make_row_map(&wmap, w, V, D, BN)) return err;
  static std::atomic<uint32_t> smem_set{0};
  if (int err = allow_smem(ce_fwd_tc_kernel, Smem::ALLOC, smem_set)) return err;
  dim3 grid((unsigned)((S + BM - 1) / BM), (unsigned)parts);
  ce_fwd_tc_kernel<<<grid, THREADS, Smem::ALLOC, static_cast<cudaStream_t>(stream)>>>(
      hmap, wmap, static_cast<const int*>(labels), static_cast<float*>(loss), static_cast<float*>(lse),
      static_cast<float*>(part), static_cast<int*>(counters), S, V, D, parts, tiles_per_part);
  return (int)cudaGetLastError();
}
