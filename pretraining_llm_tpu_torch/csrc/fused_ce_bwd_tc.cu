// Fused cross-entropy backward on Hopper's tensor cores, sm_90a: the bf16
// route of B10 (dH) and B11 (dW). fp32 keeps ce_kernel<float, D, DH / DW>
// of fused_ce.cu (ops/cuda_ce.py::ce_bwd_route): wgmma's fp32 form is TF32,
// which would miss the fp32 bars.
//
// Replaces, in pretraining_llm_tpu/ops/pallas_ce.py (their pallas_calls in
// _ce_bwd):
//   _bwd_dh_kernel -> ce_bwd_tc_kernel<DH, DC> (pllm_ce_bwd_tc, mode 0)
//   _bwd_dw_kernel -> ce_bwd_tc_kernel<DW, DC> (pllm_ce_bwd_tc, mode 1)
// Per token s and vocabulary row v, at the Pallas kernels' rounding points:
//   p~[s, v] = g[s] * (exp(h[s] . W[v] - lse[s]) - [v == label[s]]), formed
//   in fp32 from fp32 logits sums and rounded to bf16 before its product;
//   dH[s] = sum_v p~[s, v] W[v] and dW[v] = sum_s p~[s, v] h[s], summed in
//   fp32 and written in bf16; vocabulary rows >= V and tokens >= S add
//   nothing.
//
// What bounds it on the H100: operations. At gpt2-124m's training head
// (S 12288, D 768, V 50304) each kernel does two products of 2 S D V =
// 0.95 TFLOP (the logits, recomputed, and its own) against ~100 MB of
// operands: 1.92 ms at the bf16 peak, the two-product bound. This design
// recomputes the logits once per D-chunk (below); at D 768 with DC 256
// that is three times, four products in all, so its own floor is 3.84 ms.
// What holds it above that floor is the loads: every 128 x 128 logits tile
// streams its 128 resident rows again beside the walked ones, 384 KB per
// tile at D 768 through a 160 KB ring; with no product at all the kernel
// keeps two thirds (dW) to three quarters (dH) of its time
// (utils/ce_bwd_ablation.py, PERF.md). Sharing the logits across a
// thread-block cluster of the D-chunks is the design that removes both the
// recompute and that traffic.
//
// Design:
//   - Roles. A block owns an output tile of BM = 128 resident rows (tokens,
//     rows of h, for dH; vocabulary rows of W for dW) and walks the other
//     operand in tiles of BN = 128 rows (W's for dH, h's for dW), as the
//     TPU kernel's innermost grid axis. Per walked tile: the logits tile
//     R . X^T over the whole of D, p~ on its fp32 fragments, then
//     out[:, chunk] += p~ . X[:, chunk]. For dW the logits are W . h^T,
//     the vocabulary rows as M, so p~^T is already in the accumulator
//     layout (as dV += P^T . dO in flash_bwd_tc.cu): no transpose.
//   - The output does not fit whole: 128 x 768 fp32 is 384 KB, more than an
//     SM's registers or shared memory. A block keeps DC columns of D (a
//     chunk, DC <= 256: 64 x DC fp32 per consumer warpgroup, DC / 2
//     registers a thread), so the grid is (row tiles, ceil(D / DC) chunks,
//     partitions) and each block recomputes every logits tile.
//   - Two warpgroups (256 threads), each 64 rows as the M of wgmma. No
//     producer warp: registers are reserved for warps in groups of four, so
//     one more warp would cap every thread at 168 registers and spill the
//     64 x DC output (DC / 2 registers) beside the 64 x 128 logits tile
//     (64). Thread 0 issues the loads instead: each walked tile as D / 64
//     slices of 64 columns (R: 128 rows, X: 128 rows, 128-byte swizzle)
//     into a STAGES-deep mbarrier ring. It issues a slice once every warp
//     has freed the stage the slice reuses (and, for a chunk slice,
//     finished the previous tile's second product), and only after it has
//     done so itself: it waits on the other warps, never on its own
//     progress. Its waits may not trap (mbar_wait_in_pipeline): a trap
//     between two wgmma makes ptxas serialize every wgmma of the kernel.
//   - A tile's slices come in ascending order starting after the block's
//     chunk (a rotation), so the chunk's own slices come last: the logits
//     are summed over the slices in that order (wgmma m64n128k16, both
//     operands K-major) and each stage is freed as soon as its product is
//     done. The X halves of the chunk's slices land not in the ring but in
//     a chunk buffer, side by side, where they are the B operand of the
//     second product (MN-major, one wgmma m64nDCk16 per 16 walked rows);
//     the buffer is freed once that product is done. Each slice is loaded
//     once.
//   - Epilogue on the fp32 logits fragments: exp as exp2 of logit * log2 e
//     - lse * log2 e (dH: the row's; dW: the walked token's), the label's
//     1 subtracted only in the tile that holds it, times g, the walked tail
//     zeroed (vocabulary columns >= V for dH; tokens >= S have g = 0 for
//     dW, the walked tokens' values staged in shared memory at the tile's
//     start); rounded to bf16 pairs, the A operand of the second product
//     from registers (wgmma_rs). The chunk is summed in registers over the
//     walked tiles in ascending order: no atomics.
//   - Filling the card: the walked axis may be cut into P partitions of
//     whole tiles (ops/cuda_ce.py::ce_bwd_plan, from S, V, D and the SM
//     count). With P > 1 each block writes its fp32 partial sums and takes
//     a ticket from its output tile's arrival counter; the last block adds
//     the P partials in partition order, writes the tile and resets the
//     counter. Every sum has a fixed order: a repeat launch gives the same
//     bits.
//   - Any D that is a multiple of 64: D / 64 slices; the last chunk may be
//     narrower than DC (the chunk buffer's panels past it hold zeros, and
//     their output columns are not written).
//   - Runs on the caller's stream; allocates nothing (the partials and the
//     counters are the wrapper's scratch). The wrappers
//     (ops/cuda_ce.py::fused_ce_dh, fused_ce_dw) pick it by ce_bwd_route
//     and count its launches.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;  // output rows of a block: two consumer warpgroups of 64
constexpr int BN = 128;  // walked rows of a tile: the logits' N
constexpr int BK = 64;   // columns of D in a slice: one 128-byte swizzle span
constexpr int STAGES = 5;
constexpr int THREADS = 256;  // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;

enum Mode { DH = 0, DW = 1 };

// 2^x by the SFU alone (ex2.approx.ftz): exp2f adds steps for results
// below 2^-126, which flush to 0 here, far under any p~ that adds to a sum.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of one block, in bytes. ops/cuda_ce.py::tc_bwd_smem_bytes
// repeats this arithmetic.
template <int DC>
struct Smem {
  static constexpr int R_SLICE = BM * BK * 2;            // 64 columns of the resident tile
  static constexpr int X_SLICE = BN * BK * 2;            // 64 columns of a walked tile
  static constexpr int STAGE = R_SLICE + X_SLICE;        // one ring stage
  static constexpr int CHUNK = STAGES * STAGE;           // the chunk buffer: DC / 64 walked slices
  static constexpr int VEC = CHUNK + DC / BK * X_SLICE;  // dW: a walked tile's lse * log2 e, g, labels
  static constexpr int BAR = VEC + 3 * BN * 4;           // full[STAGES], empty[STAGES], chunk_free
  static constexpr int FLAG = BAR + (2 * STAGES + 1) * 8;  // the last-block flag
  static constexpr int ALLOC = FLAG + 16 + 1024;         // + room to align the base
};

template <int MODE, int DC>
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_tc_kernel(const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap xmap,
                 const int* __restrict__ labels, const float* __restrict__ lse, const float* __restrict__ g,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part, int* __restrict__ counters, int S,
                 int V, int D, int parts, int tiles_per_part) {
  using Sm = Smem<DC>;
  constexpr int NP = DC / BK;  // slices of a chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sm::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* chunk_free = empty + STAGES;
  int* sLast = reinterpret_cast<int*>(smem + Sm::FLAG);

  const int n_rows = MODE == DH ? S : V;  // rows of the output
  const int n_walk = MODE == DH ? V : S;  // rows of the walked operand
  const int row0 = blockIdx.x * BM;
  const int n_k = D / BK;
  const int k_lo = blockIdx.y * NP;       // the chunk's first slice
  const int nc = min(NP, n_k - k_lo);     // and its count (the last chunk may be narrower)
  const int k_first = (k_lo + nc) % n_k;  // a tile's first slice: the chunk's come last
  const int held0 = n_k - nc;             // a tile's slices from here on are the chunk's
  const int n_wt = (n_walk + BN - 1) / BN;
  const int wt_lo = blockIdx.z * tiles_per_part;
  const int wt_hi = min(n_wt, wt_lo + tiles_per_part);
  const int n_slices = max(0, wt_hi - wt_lo) * n_k;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);              // thread 0's expect_tx arrival
      mbar_init(&empty[s], THREADS / 32);  // one per warp
    }
    mbar_init(chunk_free, THREADS / 32);
    fence_barrier_init();
  }
  if (nc < NP) {
    // A narrow last chunk: the panels past it are read by the second
    // product but never loaded; zeros keep their (unwritten) sums finite.
    for (int b = threadIdx.x * 16; b < (NP - nc) * Sm::X_SLICE; b += THREADS * 16)
      *reinterpret_cast<uint4*>(smem + Sm::CHUNK + nc * Sm::X_SLICE + b) = make_uint4(0u, 0u, 0u, 0u);
    fence_async_shared();
  }
  __syncthreads();

  // ---------------- loads, issued by thread 0 ----------------
  // Slice j goes to stage j % STAGES once every warp has freed that stage's
  // previous slice, j - STAGES; a chunk slice also waits until every warp
  // is done with the previous tile's second product. Thread 0 issues j only
  // once it has freed j - STAGES itself (the slices up to `freed`) and, for
  // a chunk slice, finished that product (the tiles up to `tiles_done`), so
  // its waits are on the other warps alone.
  int next = 0;           // the next slice to issue
  bool stalled = false;   // a wait that never ended (mbar_wait_in_pipeline)
  auto issue = [&](int freed, int tiles_done) {
    for (; next < n_slices && next - STAGES <= freed; ++next) {
      const int s = next % STAGES;
      const int t = next / n_k, kk = next % n_k;
      if (kk >= held0 && t > tiles_done + 1) break;
      if (next >= STAGES) mbar_wait_in_pipeline(&empty[s], ((next / STAGES) - 1) & 1, stalled);
      if (kk >= held0 && t > 0) mbar_wait_in_pipeline(chunk_free, (t - 1) & 1, stalled);
      uint8_t* st = smem + s * Sm::STAGE;
      uint8_t* x = kk < held0 ? st + Sm::R_SLICE : smem + Sm::CHUNK + (kk - held0) * Sm::X_SLICE;
      const int kc = (k_first + kk) % n_k * BK;
      mbar_arrive_expect_tx(&full[s], Sm::STAGE);
      tma_load_2d(st, &rmap, &full[s], kc, row0);
      tma_load_2d(x, &xmap, &full[s], kc, (wt_lo + t) * BN);
    }
  };
  if (threadIdx.x == 0) issue(-1, -1);

  // ---------------- the walk ----------------
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int ra = row0 + wg * 64 + (tid >> 5) * 16 + (lane >> 2);  // the thread's rows ra and rb = ra + 8
  const int rb = ra + 8;
  const int cq = 2 * (lane & 3);  // its first column in each 8-column group
  // dH: the rows are tokens, each with its label, lse * log2 e and g.
  int lab_a = -1, lab_b = -1;
  float ls_a = 0.f, ls_b = 0.f, g_a = 0.f, g_b = 0.f;
  if (MODE == DH) {
    if (ra < S) {
      lab_a = labels[ra];
      ls_a = lse[ra] * LOG2E;
      g_a = g[ra];
    }
    if (rb < S) {
      lab_b = labels[rb];
      ls_b = lse[rb] * LOG2E;
      g_b = g[rb];
    }
  }
  const uint32_t chunk_tile = smem_u32(smem + Sm::CHUNK);

  float acc[DC / 2];  // out[:, chunk]: 64 rows x DC columns
#pragma unroll
  for (int e = 0; e < DC / 2; ++e) acc[e] = 0.f;
  float lg[BN / 2];  // logits, then p~: 64 x 128
  int i = 0;         // ring slice
  for (int wt = wt_lo; wt < wt_hi; ++wt) {
    const int t = wt - wt_lo;
    bool hit = false;  // dW: a walked token's label is one of the block's rows
    if (MODE == DW) {
      // The walked tokens' lse * log2 e, g and labels, for this tile's
      // epilogue (tokens >= S: g = 0, no label), once the previous tile's
      // readers are done.
      float* vec = reinterpret_cast<float*>(smem + Sm::VEC);
      __syncthreads();
      if (threadIdx.x < BN) {
        const int tok = wt * BN + threadIdx.x;
        const bool in = tok < S;
        const int l = in ? labels[tok] : -1;
        vec[threadIdx.x] = in ? lse[tok] * LOG2E : 0.f;
        vec[BN + threadIdx.x] = in ? g[tok] : 0.f;
        reinterpret_cast<int*>(vec)[2 * BN + threadIdx.x] = l;
        hit = l >= row0 && l < row0 + BM;
      }
      hit = __syncthreads_or(hit);
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) lg[e] = 0.f;
    fence_regs(lg);
    for (int kk = 0; kk < n_k; ++kk, ++i) {
      const int s = i % STAGES;
      mbar_wait_in_pipeline(&full[s], (i / STAGES) & 1, stalled);
      const uint32_t r_tile = smem_u32(smem + s * Sm::STAGE) + wg * 64 * 128;
      const uint32_t x_tile = kk < held0 ? smem_u32(smem + s * Sm::STAGE + Sm::R_SLICE)
                                         : chunk_tile + (kk - held0) * Sm::X_SLICE;
      wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < BK / 16; ++k4)
        wgmma_ss_n128(lg, kmajor_desc<64>(r_tile, k4), kmajor_desc<64, BN>(x_tile, k4), 1);
      wgmma_commit();
      if (kk > 0) {
        wgmma_wait<1>();  // the previous slice's products are done: free its stage
        warp_arrive(&empty[(i - 1) % STAGES]);
        if (threadIdx.x == 0) issue(i - 1, t - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(lg);
    warp_arrive(&empty[(i - 1) % STAGES]);
    if (threadIdx.x == 0) issue(i - 1, t - 1);

    // p~ = g * (exp(logit - lse) - [label]) on the fragments.
    const int col0 = wt * BN;
    if (MODE == DH) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) lg[e] = exp2_ftz(fmaf(lg[e], LOG2E, (e & 2) ? -ls_b : -ls_a));
      if (lab_a >= col0 && lab_a < col0 + BN) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col0 + 8 * n + cq + e == lab_a) lg[4 * n + e] -= 1.f;
      }
      if (lab_b >= col0 && lab_b < col0 + BN) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col0 + 8 * n + cq + e == lab_b) lg[4 * n + 2 + e] -= 1.f;
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) lg[e] *= (e & 2) ? g_b : g_a;
      if (col0 + BN > V) {  // the vocabulary tail adds nothing
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col0 + 8 * n + cq + (e & 1) >= V) lg[4 * n + e] = 0.f;
      }
    } else {
      const float* vls = reinterpret_cast<const float*>(smem + Sm::VEC);
      const float* vg = vls + BN;
      const int* vlab = reinterpret_cast<const int*>(vg + BN);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(vls + 8 * n + cq);
        const float2 g2 = *reinterpret_cast<const float2*>(vg + 8 * n + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_ftz(fmaf(lg[4 * n + e], LOG2E, (e & 1) ? -l2.y : -l2.x));
          if (hit && vlab[8 * n + cq + (e & 1)] == ((e & 2) ? rb : ra)) p -= 1.f;
          lg[4 * n + e] = p * ((e & 1) ? g2.y : g2.x);
        }
      }
    }
    uint32_t pa[BN / 16][4];  // p~ in bf16: the A operand, k step = 16 walked rows
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(lg[8 * kk + 2 * r], lg[8 * kk + 2 * r + 1]);

    // out[:, chunk] += p~ . X[:, chunk], the chunk buffer read MN-major.
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<DC>(acc, pa[kk], mnmajor_desc<64, BN>(chunk_tile, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pa[kk]);
    warp_arrive(chunk_free);
    if (threadIdx.x == 0) issue(i - 1, t);
  }

  if (stalled) __trap();  // every wgmma is done: the fault ends the launch here

  if (parts > 1) {
    // This block's fp32 partial sums: each thread's values, 256 threads apart.
    const size_t n_tiles = (size_t)gridDim.x * gridDim.y;
    const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const size_t per_tile = (size_t)DC / 2 * THREADS;
    float* mine = part + (blockIdx.z * n_tiles + tile) * per_tile + threadIdx.x;
#pragma unroll
    for (int e = 0; e < DC / 2; ++e)
      if (e < nc * 32) mine[e * THREADS] = acc[e];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *sLast = atomicAdd(&counters[tile], 1) == parts - 1;
    __syncthreads();
    if (!*sLast) return;

    // The last block of this output tile adds the P partials, in order.
    __threadfence();
    for (int q = 0; q < parts; ++q) {
      const float* theirs = part + (q * n_tiles + tile) * per_tile + threadIdx.x;
#pragma unroll
      for (int e = 0; e < DC / 2; ++e)
        if (e < nc * 32) {
          const float x = __ldcg(theirs + e * THREADS);
          acc[e] = q == 0 ? x : acc[e] + x;
        }
    }
    if (threadIdx.x == 0) counters[tile] = 0;  // ready for the next launch
  }

  // Rows ra and rb; columns 64 k_lo + 8n + cq, + 1, for the chunk's nc * 8 groups.
  __nv_bfloat16* oa = out + (size_t)ra * D + k_lo * BK + cq;
  __nv_bfloat16* ob = oa + (size_t)8 * D;
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    if (n >= nc * 8) break;
    if (ra < n_rows) *reinterpret_cast<__nv_bfloat162*>(oa + 8 * n) = __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
    if (rb < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * n) = __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

template <int MODE, int DC>
int launch(const CUtensorMap& rmap, const CUtensorMap& xmap, const void* labels, const void* lse, const void* g,
           void* out, void* part, void* counters, int S, int V, int D, int parts, int tiles_per_part,
           cudaStream_t stream) {
  auto kern = ce_bwd_tc_kernel<MODE, DC>;
  static std::atomic<uint32_t> smem_set{0};
  if (int err = allow_smem(kern, Smem<DC>::ALLOC, smem_set)) return err;
  const int rows = MODE == DH ? S : V;
  dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)((D + DC - 1) / DC), (unsigned)parts);
  kern<<<grid, THREADS, Smem<DC>::ALLOC, stream>>>(
      rmap, xmap, static_cast<const int*>(labels), static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), static_cast<int*>(counters), S, V, D, parts,
      tiles_per_part);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: dh (S, D) bf16; mode 1: dw (V, D) bf16, into `out`. h: (S, D) bf16;
// w: (V, D) bf16 (16-byte aligned, D a multiple of 64); labels: (S,) int32;
// lse, g: (S,) fp32. dc: the chunk width, 128, 192 or 256. The walked axis's
// ceil(n / 128) tiles (n = V for dh, S for dw) are cut into `parts`
// partitions of `tiles_per_part` tiles. With parts > 1, part: fp32 scratch
// of parts x ceil(rows / 128) x ceil(D / dc) x 128 x dc, and counters:
// ceil(rows / 128) x ceil(D / dc) int32, zero before the launch and zero
// again after it (rows = S for dh, V for dw).
extern "C" int pllm_ce_bwd_tc(int mode, const void* h, const void* w, const void* labels, const void* lse,
                              const void* g, void* out, void* part, void* counters, int S, int V, int D, int dc,
                              int parts, int tiles_per_part, void* stream) {
  const int n_wt = ((mode == DH ? V : S) + BN - 1) / BN;
  if ((mode != DH && mode != DW) || S <= 0 || V <= 0 || D <= 0 || D % BK != 0 || parts < 1 ||
      tiles_per_part < 1 || (long long)parts * tiles_per_part < n_wt || (parts - 1) * tiles_per_part >= n_wt)
    return (int)cudaErrorInvalidValue;
  CUtensorMap rmap, xmap;
  if (int err = make_row_map(&rmap, mode == DH ? h : w, mode == DH ? S : V, D, BM)) return err;
  if (int err = make_row_map(&xmap, mode == DH ? w : h, mode == DH ? V : S, D, BN)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PLLM_CE_BWD(M, DCV)                                                                                 \
  if (mode == M && dc == DCV)                                                                               \
    return launch<M, DCV>(rmap, xmap, labels, lse, g, out, part, counters, S, V, D, parts, tiles_per_part, s);
  PLLM_CE_BWD(DH, 128) PLLM_CE_BWD(DH, 192) PLLM_CE_BWD(DH, 256)
  PLLM_CE_BWD(DW, 128) PLLM_CE_BWD(DW, 192) PLLM_CE_BWD(DW, 256)
#undef PLLM_CE_BWD
  return (int)cudaErrorInvalidValue;
}
