// Flash-attention backward on Hopper's tensor cores, sm_90a: the bf16 route
// of all three backward kernels. fp32 calls keep flash_bwd.cu's CUDA-core
// kernels.
//
// Replaces, in pretraining_llm_tpu/ops/pallas_flash.py::_bwd:
//   _bwd_dkv_kernel   -> flash_bwd_tc_kernel<D, false> (pllm_flash_bwd_dkv_tc, B3)
//   _bwd_fused_kernel -> flash_bwd_tc_kernel<D, true>  (pllm_flash_bwd_fused_tc, B4)
//   _bwd_dq_kernel    -> flash_bwd_dq_tc_kernel<D>     (pllm_flash_bwd_dq_tc, B2)
// They compute what flash_bwd.cu's kernels compute, at the same rounding
// points (per query i, key j, scale = 1/sqrt(Dh)):
//   p  = exp(q.k * scale - lse_i), zeroed where _mask_ok fails (k <= q,
//        q - k < window, seg[q] == seg[k]);
//   ds = p * (dO_i.v_j - D_i) * scale, D_i = rowsum(dO_i * O_i) (fp32, from
//        the wrapper);
//   dV_j = sum_i bf16(p) dO_i, dK_j = sum_i bf16(ds) q_i over the group's
//        n_rep query heads, dQ_i = sum_j bf16(ds) k_j; fp32 sums written as
//        bf16.
// No floating-point atomics: every sum is taken in a fixed order, so each
// kernel gives the same bits on every launch.
//
// What bounds them on the H100: the one pass does 5 products of 2*Dh FLOPs
// over the visible pairs, dQ 3 and dK/dV 4, against q, k, v, dO, lse, D
// read once and the gradients written once; at gpt2-124m's T = 1024, Dh 64
// the one pass is ~360 FLOPs per byte, at llama3-1b-gqa's T = 2048, Dh 128
// dK/dV ~990, both above the card's ~295 ridge: operations bound them, so
// the products run on the tensor cores.
//
// Design:
//   - dK/dV and the one pass: one block per (b*g, 64-key tile), one
//     consumer warpgroup and one producer warp (160 threads). The block
//     walks the query tiles of each of the group's n_rep heads that can
//     see its keys (from the diagonal to the window's end), as the TPU's
//     innermost grid axis does, and keeps dK and dV in fp32 registers
//     across the walk. The producer warp loads K and V once, and Q and dO
//     tile by tile into a 2-stage ring with TMA (zeros past T), its lanes
//     staging the tile's lse (times log2(e)), D and query document ids;
//     full and empty mbarriers guard each stage. The consumer computes
//     S^T = K.Q^T and dP^T = V.dO^T (wgmma m64n64k16, both operands from
//     shared memory, K-major), so P^T and dS^T land in registers already
//     shaped as the A operand of dV += P^T.dO and dK += dS^T.Q (wgmma
//     m64nDk16, dO and Q read MN-major from the same swizzled tiles).
//   - The one pass adds dQ, with a third role: the consumer warpgroup, the
//     producer warp and a dQ writer warp (192 threads; two blocks per SM at
//     Dh <= 64, at the price of a few spilled registers, PERF.md). The consumers take each query tile in two halves of
//     32 queries (S^T, dP^T and the dV/dK products per half), so that the
//     registers of S^T and dP^T never meet those of dQ. Each half's dS^T
//     goes from registers to a swizzled 64 x 64 bf16 tile in shared memory
//     (two tiles, one per step); then dQ_part = dS.K is one more wgmma with
//     both operands read MN-major from there (dS^T transposed, K from its
//     resident tile), in 64-column parts (two at Dh 128), written as fp32
//     into a 2-buffer ring of 128-byte swizzled boxes for the writer warp.
//   - dQ is summed in a fixed order, with no floating-point atomics: the
//     partials of a (head, query tile) join its fp32 sum in ascending key
//     tile order, from the first key tile inside the window to the
//     diagonal, each adder waiting its turn on an int32 counter per (head,
//     query tile) in global memory (acquire/release). The writer warp takes
//     the turn, then TMA stores the first partial and adds the next ones in
//     the L2 (one fp32 add per element, in turn order), passing the turn
//     when the copy is complete; the diagonal, the last adder, adds the sum
//     to its partial and writes the bf16 dq. Blocks take their key tile from
//     a ticket counter, first key tiles first (the longest walks first, as
//     for dK/dV), so a block waits only on blocks that took a ticket before
//     it: running or done, never waiting to be scheduled. Ascending, and
//     not descending from the diagonal, because of that order: descending
//     turns need the last key tiles dispatched first, and the longest walks
//     then start last (PERF.md). With n_rep > 1 each head of a key tile's
//     walk is one step shorter than its predecessor's, so a block that
//     starts beside its predecessor falls one step further behind it per
//     head and waits.
//   - dQ: K1's structure (flash_fwd_tc.cu) with three products. One block
//     per (b*h, 64-query tile), longest kv walk first; Q and dO stay
//     resident, K/V tiles stream through the 2-stage ring, the producer
//     also stages the queries' lse*log2(e), D and document ids. S = Q.K^T
//     and dP = dO.V^T by wgmma from shared memory; dS, rounded to bf16 in
//     registers, is the A operand of dQ += dS.K (K read MN-major, as K1
//     reads V), left in flight under the next tile's S and dP. Each block
//     owns its rows: no atomics, no turns.
//   - The mask runs only on the diagonal tile, the ragged edge and the
//     window's edge, and on every tile when segments are given: the causal
//     and window comparisons, and the document ids.
//   - Runs on the caller's stream; allocates nothing (the one pass's fp32
//     buffer and turn counters come from the wrapper). The Python wrappers
//     (ops/cuda_flash.py::flash_bwd_dkv, flash_bwd_fused, flash_bwd_dq)
//     pick these kernels for bf16 and count their launches (launches_tc).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BKV = TILE_ROWS;  // keys per tile
constexpr int BQ = TILE_ROWS;   // queries per tile
constexpr int STAGES = 2;       // ring depth
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int FUSED_THREADS = THREADS + 32;  // the one pass: and one dQ writer warp
constexpr int CONSUMER_BAR = 1;  // named barrier of the consumer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// The first key tile that a query tile starting at q0 can see: the tile
// of the key window - 1 before q0 (0 without a window).
__device__ __forceinline__ int first_key_tile(int q0, int window) {
  return (window > 0 && q0 - (window - 1) > 0) ? (q0 - (window - 1)) / BKV : 0;
}

template <int D, bool FUSED>
struct Smem {
  static constexpr int TILE = TILE_ROWS * D * 2;           // one bf16 tile
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int QS = 2 * TILE;                       // STAGES x (Q tile, dO tile)
  static constexpr int DS = QS + STAGES * 2 * TILE;         // one pass: 2 x dS^T, 64 keys x 64 queries bf16
  static constexpr int DQ = DS + (FUSED ? 2 * TILE_ROWS * BQ * 2 : 0);  // one pass: 2 x (64 x D fp32 dQ partial)
  static constexpr int VEC = DQ + (FUSED ? 2 * BQ * D * 4 : 0);  // STAGES x (lse*log2e, D, seg) of BQ queries
  static constexpr int BAR = VEC + STAGES * 3 * BQ * 4;  // kv_full, full[STAGES], empty[STAGES], dq_full[2], dq_empty[2]
  static constexpr int TICKET = BAR + (1 + 2 * STAGES + 4) * 8;
  static constexpr int ALLOC = TICKET + 8 + 1024;
};

template <int D, bool FUSED>
__global__ void __launch_bounds__(FUSED ? FUSED_THREADS : THREADS, FUSED && D < 128 ? 2 : 1)
flash_bwd_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap accmap, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, __nv_bfloat16* __restrict__ dq, const float* __restrict__ dq_acc,
                    int* __restrict__ turns, int H, int G, int T_len, int window, float scale) {
  using S = Smem<D, FUSED>;
  constexpr int QW = FUSED ? 32 : BQ;    // queries per part of a query tile
  constexpr int NQ = D < 64 ? D : 64;     // dQ columns per product (one pass)
  constexpr int PARTS = D / NQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* dq_full = empty + STAGES;  // one pass: a dQ partial buffer written
  uint64_t* dq_empty = dq_full + 2;    // ... and free again
  float* dq_bufs = reinterpret_cast<float*>(smem + S::DQ);
  int* ticket = reinterpret_cast<int*>(smem + S::TICKET);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 2);  // the expect_tx arrival and the producer warp's
      mbar_init(&empty[s], CONSUMERS / 32);  // one per consumer warp
    }
    if constexpr (FUSED) {
      for (int s = 0; s < 2; ++s) {
        mbar_init(&dq_full[s], CONSUMERS / 32);
        mbar_init(&dq_empty[s], 1);  // the writer warp's
      }
      *ticket = atomicAdd(turns, 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  int bg, k0;
  if constexpr (FUSED) {
    // Key tiles in ticket order, the first (longest walks) first: a block
    // waits (in the writer warp) only on blocks of lower key tiles, which
    // took their tickets earlier.
    const int t = *ticket;
    bg = t % gridDim.x;
    k0 = (t / gridDim.x) * BKV;
  } else {
    bg = blockIdx.x;
    k0 = blockIdx.y * BKV;  // k0 = 0 walks the most q tiles: launched first
  }
  const int b = bg / G;
  const int g = bg - b * G;
  const int n_rep = H / G;
  const int* segp = seg != nullptr ? seg + (size_t)b * T_len : nullptr;
  // q tiles that can see this kv tile: from the diagonal up to the last
  // query inside the window of the tile's last key.
  const int q_begin = (k0 / BQ) * BQ;
  const int q_end = window > 0 ? min(T_len, k0 + BKV - 1 + window) : T_len;
  const int n_q = (q_end - q_begin + BQ - 1) / BQ;
  const int n_iter = n_rep * n_q;
  const int n_qt = (T_len + BQ - 1) / BQ;

  if (FUSED && threadIdx.x >= THREADS) {
    // ---------------- dQ writer warp (one pass) ----------------
    // Each step's dQ partial (64 x D fp32, from the consumers through a
    // 2-buffer ring, 128-byte swizzled boxes of 32 columns) joins its (head,
    // query tile)'s sum in its turn: key tiles from the first inside the
    // window of the tile's first query up to the diagonal. The first adder
    // stores it to the fp32 buffer and the next ones add to it there (TMA
    // stores and fp32 adds in the L2), each turn passed (and its buffer
    // freed) once its copy is complete; the diagonal, the last adder, adds
    // the sum to the buffer and writes the bf16 dq.
    const int lane = threadIdx.x & 31;
    int* pending = nullptr;  // the turn of the copy in flight
    int pending_buf = 0;     // ... and its buffer
    auto finish_pending = [&]() {
      if (lane == 0) {
        bulk_wait_all();
        fence_async();
        pass_turn(pending);
      }
      warp_arrive(&dq_empty[pending_buf]);
      pending = nullptr;
    };
    for (int i = 0; i < n_iter; ++i) {
      const int bb = i & 1;
      const uint8_t* buf = reinterpret_cast<const uint8_t*>(dq_bufs + bb * BQ * D);
      const int bh = b * H + g * n_rep + i / n_q;
      const int q0 = q_begin + (i % n_q) * BQ;
      const int turn = k0 / BKV - first_key_tile(q0, window);
      int* turn_p = turns + 1 + (size_t)bh * n_qt + q0 / BQ;
      // The previous copy's turn passes and its buffer frees as soon as it
      // is complete; this step's turn is taken before its partial is ready.
      if (pending != nullptr) finish_pending();
      if (lane == 0 && turn > 0) wait_turn(turn_p, turn);
      __syncwarp();  // lane 0's acquire covers the lanes' reads of the sum
      mbar_wait(&dq_full[bb], (i >> 1) & 1);
      if (k0 != q0) {
        if (lane == 0) {
          fence_async();
#pragma unroll
          for (int c = 0; c < D / F32_BOX_COLS; ++c) {
            if (turn == 0) tma_store_3d(&accmap, buf + c * F32_BOX_BYTES, c * F32_BOX_COLS, q0, bh);
            else tma_add_3d(&accmap, buf + c * F32_BOX_BYTES, c * F32_BOX_COLS, q0, bh);
          }
          bulk_commit();
        }
        pending = turn_p;
        pending_buf = bb;
      } else {
        // Row r, columns 4c..4c+3 of the partial, plus the sum so far.
        const float* sum = dq_acc + ((size_t)bh * T_len + q0) * D;
        __nv_bfloat16* out = dq + ((size_t)bh * T_len + q0) * D;
        constexpr int CH = D / 4;  // 16-byte chunks of a row
        constexpr int U = 8;       // chunks per lane in flight
        for (int e0 = lane; e0 < TILE_ROWS * CH; e0 += 32 * U) {
          float4 x[U], y[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + 32 * u, r = e / CH, col = 4 * (e % CH);
            if (e < TILE_ROWS * CH && q0 + r < T_len) {
              x[u] = *reinterpret_cast<const float4*>(buf + (col / F32_BOX_COLS) * F32_BOX_BYTES +
                                                      swizzle128(r, (col % F32_BOX_COLS) * 4));
              if (turn > 0) y[u] = __ldcg(reinterpret_cast<const float4*>(sum + r * D + col));
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + 32 * u, r = e / CH, col = 4 * (e % CH);
            if (e >= TILE_ROWS * CH || q0 + r >= T_len) continue;
            if (turn > 0) x[u] = make_float4(y[u].x + x[u].x, y[u].y + x[u].y, y[u].z + x[u].z, y[u].w + x[u].w);
            __nv_bfloat162 lo = __floats2bfloat162_rn(x[u].x, x[u].y), hi = __floats2bfloat162_rn(x[u].z, x[u].w);
            *reinterpret_cast<uint2*>(out + r * D + col) =
                make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
          }
        }
        warp_arrive(&dq_empty[bb]);
      }
    }
    if (pending != nullptr) finish_pending();
    return;
  }

  if (threadIdx.x >= CONSUMERS) {
    // ---------------- producer warp ----------------
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * S::TILE);
      tma_load_tile<D>(smem + S::K, &kmap, kv_full, k0, bg);
      tma_load_tile<D>(smem + S::V, &vmap, kv_full, k0, bg);
    }
    for (int i = 0; i < n_iter; ++i) {
      const int s = i % STAGES;
      const int bh = b * H + g * n_rep + i / n_q;
      const int q0 = q_begin + (i % n_q) * BQ;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      if (lane == 0) {
        uint8_t* qt = smem + S::QS + s * 2 * S::TILE;
        mbar_arrive_expect_tx(&full[s], 2 * S::TILE);
        tma_load_tile<D>(qt, &qmap, &full[s], q0, bh);
        tma_load_tile<D>(qt + S::TILE, &domap, &full[s], q0, bh);
      }
      float* vec = reinterpret_cast<float*>(smem + S::VEC) + s * 3 * BQ;
      for (int c = lane; c < BQ; c += 32) {
        const int qi = q0 + c;
        const bool in = qi < T_len;
        vec[c] = in ? lse[(size_t)bh * T_len + qi] * LOG2E : 0.f;
        vec[BQ + c] = in ? delta[(size_t)bh * T_len + qi] : 0.f;
        if (segp != nullptr) reinterpret_cast<int*>(vec)[2 * BQ + c] = in ? segp[qi] : -1;
      }
      warp_arrive(&full[s]);
    }
    return;
  }

  // ---------------- consumer warpgroup ----------------
  const int lane = threadIdx.x & 31;
  const int ra = (threadIdx.x >> 5) * 16 + (lane >> 2);  // the thread's rows ra and ra + 8 of a tile
  const int ka = k0 + ra;  // key rows ka and kb = ka + 8
  const int kb = ka + 8;
  const int cq = 2 * (lane & 3);  // the thread's first column in each 8-column group
  int seg_a = 0, seg_b = 0;
  if (segp != nullptr) {
    seg_a = ka < T_len ? segp[ka] : -2;
    seg_b = kb < T_len ? segp[kb] : -2;
  }
  // The causal and window rule for key k and query q: 0 <= q - k < span;
  // dK/dV keeps each key row's visible queries, [lo, hi] (empty for a key
  // past T).
  const unsigned span = window > 0 ? (unsigned)window : 0x7fffffffu;
  const int lo_a = ka < T_len ? ka : T_len, lo_b = kb < T_len ? kb : T_len;
  const int hi_a = window > 0 ? min(T_len - 1, ka + window - 1) : T_len - 1;
  const int hi_b = window > 0 ? min(T_len - 1, kb + window - 1) : T_len - 1;
  const float scale_log2 = scale * LOG2E;
  const uint32_t k_base = smem_u32(smem + S::K);
  const uint32_t v_base = smem_u32(smem + S::V);
  const uint32_t ds_base = smem_u32(smem + S::DS);

  float dk_acc[D / 2], dv_acc[D / 2];  // 64 keys x D each
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int i = 0; i < n_iter; ++i) {
    const int s = i % STAGES;
    const int q0 = q_begin + (i % n_q) * BQ;
    // Opaque tile addresses: each step rebuilds its descriptors where it
    // uses them, rather than keeping every one in registers.
    const uint32_t k_tile = opaque(k_base), v_tile = opaque(v_base);
    const uint32_t q_tile = opaque(smem_u32(smem + S::QS + s * 2 * S::TILE));
    const uint32_t do_tile = q_tile + S::TILE;
    const float* vec = reinterpret_cast<const float*>(smem + S::VEC) + s * 3 * BQ;
    mbar_wait(&full[s], (i / STAGES) & 1);

    // The causal and window mask runs on the diagonal, ragged and window-edge
    // tiles only; the document mask, when given, on every tile.
    const bool edge = q0 < k0 + BKV - 1 || q0 + BQ > T_len || k0 + BKV > T_len ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window);
    const bool masked = edge || segp != nullptr;
    // The query tile in parts of QW queries (the one pass: two halves, so
    // that S^T and dP^T of a part leave registers for its dQ).
#pragma unroll
    for (int hq = 0; hq < BQ / QW; ++hq) {
      const int c0 = hq * QW;  // the part's first query column
      float st[QW / 2], dpt[QW / 2];  // S^T and dP^T: 64 keys x QW queries
#pragma unroll
      for (int e = 0; e < QW / 2; ++e) st[e] = dpt[e] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<QW>(st, kmajor_desc<D>(k_tile, kk), kmajor_desc<D>(q_tile + c0 * Panels<D>::SW, kk), 1);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<QW>(dpt, kmajor_desc<D>(v_tile, kk), kmajor_desc<D>(do_tile + c0 * Panels<D>::SW, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
#pragma unroll
      for (int n = 0; n < QW / 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(vec + c0 + 8 * n + cq);
        int2 sq = make_int2(0, 0);
        if (masked && segp != nullptr) sq = *reinterpret_cast<const int2*>(vec + 2 * BQ + c0 + 8 * n + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(st[4 * n + e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
          if (masked) {
            const int qi = q0 + c0 + 8 * n + cq + (e & 1);
            bool ok;
            if constexpr (FUSED)  // no registers for the rows' visible ranges
              ok = !edge || ((unsigned)(qi - (e < 2 ? ka : kb)) < span && qi < T_len);
            else
              ok = e < 2 ? (qi >= lo_a && qi <= hi_a) : (qi >= lo_b && qi <= hi_b);
            if (segp != nullptr) ok = ok && ((e & 1) ? sq.y : sq.x) == (e < 2 ? seg_a : seg_b);
            p = ok ? p : 0.f;
          }
          st[4 * n + e] = p;
        }
      }
#pragma unroll
      for (int n = 0; n < QW / 8; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(vec + BQ + c0 + 8 * n + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
      uint32_t pa[QW / 16][4], da[QW / 16][4];  // P^T and dS^T in bf16: A operands, k step = 16 queries
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      if constexpr (FUSED) {
        // dS^T to shared memory, keys x queries with the 128-byte swizzle:
        // da[kk][r] holds key row ra (r even) or ra + 8, queries c0 + 8n + cq
        // and + 1 with n = 2kk + r/2. Two tiles, one per step: the one
        // written here was last read two steps ago, before every consumer
        // passed the previous step's barrier.
        uint8_t* ds = smem + S::DS + (i & 1) * TILE_ROWS * BQ * 2;
#pragma unroll
        for (int kk = 0; kk < QW / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<uint32_t*>(ds + swizzle128(ra + 8 * (r & 1), 2 * c0 + 32 * kk + 16 * (r >> 1) + 2 * cq)) =
                da[kk][r];
      }

      fence_regs(dv_acc);
      fence_regs(dk_acc);
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk)
        wgmma_rs<D>(dv_acc, pa[kk], mnmajor_desc<D>(do_tile, c0 / 16 + kk), 1);
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk)
        wgmma_rs<D>(dk_acc, da[kk], mnmajor_desc<D>(q_tile, c0 / 16 + kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
    }
    warp_arrive(&empty[s]);

    if constexpr (FUSED) {
      // This pair's dQ partial, dS.K for columns [64 part, 64 part + NQ)
      // (dS^T and K read MN-major, K's columns from its panel `part`), to
      // the writer warp's ring.
      fence_async_shared();
      named_sync(CONSUMER_BAR, CONSUMERS);  // every consumer's dS^T is in the tile
      const uint32_t ds_tile = opaque(ds_base + (i & 1) * TILE_ROWS * BQ * 2);
      uint8_t* buf = reinterpret_cast<uint8_t*>(dq_bufs + (i & 1) * BQ * D);
      if (i >= 2) mbar_wait(&dq_empty[i & 1], ((i >> 1) - 1) & 1);
#pragma unroll
      for (int part = 0; part < PARTS; ++part) {
        float dq_part[NQ / 2];  // 64 queries x NQ columns
#pragma unroll
        for (int e = 0; e < NQ / 2; ++e) dq_part[e] = 0.f;
        fence_regs(dq_part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_ss_tt<NQ>(dq_part, mnmajor_desc<64>(ds_tile, kk),
                          mnmajor_desc<NQ>(k_tile + part * TILE_ROWS * Panels<D>::SW, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_part);
#pragma unroll
        for (int n = 0; n < NQ / 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // columns 8n + cq, + 1 of rows ra, ra + 8: swizzled boxes
            const int col = part * NQ + 8 * n;
            *reinterpret_cast<float2*>(buf + (col / F32_BOX_COLS) * F32_BOX_BYTES +
                                       swizzle128(ra + 8 * h, (col % F32_BOX_COLS + cq) * 4)) =
                make_float2(dq_part[4 * n + 2 * h], dq_part[4 * n + 2 * h + 1]);
          }
      }
      fence_async_shared();  // the writer may hand the buffer to TMA
      warp_arrive(&dq_full[i & 1]);
    }
  }

  __nv_bfloat16* dka = dk + ((size_t)bg * T_len + ka) * D;
  __nv_bfloat16* dkb = dk + ((size_t)bg * T_len + kb) * D;
  __nv_bfloat16* dva = dv + ((size_t)bg * T_len + ka) * D;
  __nv_bfloat16* dvb = dv + ((size_t)bg * T_len + kb) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + cq;
    if (ka < T_len) {
      *reinterpret_cast<__nv_bfloat162*>(dka + c) = __floats2bfloat162_rn(dk_acc[4 * n], dk_acc[4 * n + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dva + c) = __floats2bfloat162_rn(dv_acc[4 * n], dv_acc[4 * n + 1]);
    }
    if (kb < T_len) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + c) = __floats2bfloat162_rn(dk_acc[4 * n + 2], dk_acc[4 * n + 3]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + c) = __floats2bfloat162_rn(dv_acc[4 * n + 2], dv_acc[4 * n + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ (B2): one block per (b*h, 64-query tile).
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int TILE = TILE_ROWS * D * 2;          // one bf16 tile
  static constexpr int Q = 0;
  static constexpr int DO = TILE;
  static constexpr int KV = 2 * TILE;                      // STAGES x (K tile, V tile)
  static constexpr int VEC = KV + STAGES * 2 * TILE;       // lse*log2e, D, seg of the BQ queries
  static constexpr int SEG = VEC + 3 * BQ * 4;             // STAGES x BKV key document ids
  static constexpr int BAR = SEG + STAGES * BKV * 4;       // q_full, full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ seg, __nv_bfloat16* __restrict__ dq, int H, int G, int T_len,
                       int window, float scale) {
  using S = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  float* vec = reinterpret_cast<float*>(smem + S::VEC);
  int* seg_k = reinterpret_cast<int*>(smem + S::SEG);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest kv walk first
  const int b = bh / H;
  const int bg = b * G + (bh - b * H) / (H / G);  // GQA: the group's shared KV head
  const int* segp = seg != nullptr ? seg + (size_t)b * T_len : nullptr;
  // kv tiles that can hold a visible (query, key) pair of this block.
  const int kv_end = min(T_len, q0 + BQ);
  int kv_begin = 0;
  if (window > 0 && q0 - (window - 1) > 0) kv_begin = ((q0 - (window - 1)) / BKV) * BKV;
  const int n_tiles = (kv_end - kv_begin + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 2);  // the expect_tx arrival and the producer warp's
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 2);
      mbar_init(&empty[s], CONSUMERS / 32);  // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---------------- producer warp ----------------
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * S::TILE);
      tma_load_tile<D>(smem + S::Q, &qmap, q_full, q0, bh);
      tma_load_tile<D>(smem + S::DO, &domap, q_full, q0, bh);
    }
    for (int c = lane; c < BQ; c += 32) {
      const int qi = q0 + c;
      const bool in = qi < T_len;
      vec[c] = in ? lse[(size_t)bh * T_len + qi] * LOG2E : 0.f;
      vec[BQ + c] = in ? delta[(size_t)bh * T_len + qi] : 0.f;
      if (segp != nullptr) reinterpret_cast<int*>(vec)[2 * BQ + c] = in ? segp[qi] : -2;
    }
    warp_arrive(q_full);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const int j0 = kv_begin + i * BKV;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      if (lane == 0) {
        uint8_t* kt = smem + S::KV + s * 2 * S::TILE;
        mbar_arrive_expect_tx(&full[s], 2 * S::TILE);
        tma_load_tile<D>(kt, &kmap, &full[s], j0, bg);
        tma_load_tile<D>(kt + S::TILE, &vmap, &full[s], j0, bg);
      }
      if (segp != nullptr)
        for (int c = lane; c < BKV; c += 32) seg_k[s * BKV + c] = j0 + c < T_len ? segp[j0 + c] : -1;
      warp_arrive(&full[s]);
    }
    return;
  }

  // ---------------- consumer warpgroup ----------------
  const int lane = threadIdx.x & 31;
  const int ra = (threadIdx.x >> 5) * 16 + (lane >> 2);  // local rows ra and rb = ra + 8
  const int rb = ra + 8;
  const int qa = q0 + ra, qb = q0 + rb;
  const int cq = 2 * (lane & 3);  // the thread's first column in each 8-column group
  // Each row's visible keys by the causal and window rule: [lo, hi].
  const int hi_a = min(qa, T_len - 1), hi_b = min(qb, T_len - 1);
  const int lo_a = window > 0 ? qa - (window - 1) : 0, lo_b = window > 0 ? qb - (window - 1) : 0;
  const float scale_log2 = scale * LOG2E;
  const uint32_t q_tile = smem_u32(smem + S::Q);
  const uint32_t do_tile = smem_u32(smem + S::DO);

  float acc[D / 2];  // dQ, 64 x D
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t da[4][4];  // dS in bf16: the A operand of k step kk (keys 16kk..16kk+15)
  mbar_wait(q_full, 0);
  const float lse_a = vec[ra], lse_b = vec[rb], d_a = vec[BQ + ra], d_b = vec[BQ + rb];
  int seg_a = 0, seg_b = 0;
  if (segp != nullptr) {
    seg_a = reinterpret_cast<const int*>(vec)[2 * BQ + ra];
    seg_b = reinterpret_cast<const int*>(vec)[2 * BQ + rb];
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int j0 = kv_begin + i * BKV;
    const uint32_t k_tile = smem_u32(smem + S::KV + s * 2 * S::TILE);
    const uint32_t v_tile = k_tile + S::TILE;
    mbar_wait(&full[s], (i / STAGES) & 1);
    float sc[32], dp[32];  // S and dP: 64 queries x 64 keys
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, kmajor_desc<D>(q_tile, kk), kmajor_desc<D>(k_tile, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc<D>(do_tile, kk), kmajor_desc<D>(v_tile, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();  // this tile's S and dP, and the previous tile's dQ += dS.K
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(da[kk]);
    if (i > 0) warp_arrive(&empty[(i - 1) % STAGES]);

    const bool masked = segp != nullptr || j0 + BKV - 1 > q0 || j0 + BKV > T_len ||
                        (window > 0 && q0 + BQ - 1 - j0 >= window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      int2 sk = make_int2(0, 0);
      if (masked && segp != nullptr) sk = *reinterpret_cast<const int2*>(seg_k + s * BKV + 8 * n + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool row_a = e < 2;
        float p = exp2f(sc[4 * n + e] * scale_log2 - (row_a ? lse_a : lse_b));
        if (masked) {
          const int kj = j0 + 8 * n + cq + (e & 1);
          bool ok = row_a ? (kj >= lo_a && kj <= hi_a) : (kj >= lo_b && kj <= hi_b);
          if (segp != nullptr) ok = ok && ((e & 1) ? sk.y : sk.x) == (row_a ? seg_a : seg_b);
          p = ok ? p : 0.f;
        }
        sc[4 * n + e] = p * (dp[4 * n + e] - (row_a ? d_a : d_b)) * scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) da[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // dQ += dS.K, left in flight under the next tile's S and dP.
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, da[kk], mnmajor_desc<D>(k_tile, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(da[kk]);

  __nv_bfloat16* dqa = dq + ((size_t)bh * T_len + qa) * D;
  __nv_bfloat16* dqb = dq + ((size_t)bh * T_len + qb) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + cq;
    if (qa < T_len) *reinterpret_cast<__nv_bfloat162*>(dqa + c) = __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
    if (qb < T_len)
      *reinterpret_cast<__nv_bfloat162*>(dqb + c) = __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int D>
int make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout, int B, int H, int G,
              int T_len) {
  if (int err = make_tile_map<D>(&m->q, q, T_len, B * H)) return err;
  if (int err = make_tile_map<D>(&m->k, k, T_len, B * G)) return err;
  if (int err = make_tile_map<D>(&m->v, v, T_len, B * G)) return err;
  return make_tile_map<D>(&m->dout, dout, T_len, B * H);
}

template <int D, bool FUSED>
int launch_kv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
              const void* seg, void* dq, void* dk, void* dv, void* dq_acc, void* turns, int B, int H, int G,
              int T_len, int window, float scale, cudaStream_t stream) {
  Maps m;
  if (int err = make_maps<D>(&m, q, k, v, dout, B, H, G, T_len)) return err;
  CUtensorMap accmap = m.q;  // dK/dV: unused
  if (FUSED)
    if (int err = make_f32_tile_map<D>(&accmap, dq_acc, T_len, B * H)) return err;
  auto kern = flash_bwd_tc_kernel<D, FUSED>;
  const int smem = Smem<D, FUSED>::ALLOC;
  static std::atomic<uint32_t> smem_set{0};
  if (int err = allow_smem(kern, smem, smem_set)) return err;
  dim3 grid(B * G, (T_len + BKV - 1) / BKV);
  kern<<<grid, FUSED ? FUSED_THREADS : THREADS, smem, stream>>>(
      m.q, m.k, m.v, m.dout, accmap, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<__nv_bfloat16*>(dq), static_cast<const float*>(dq_acc),
                                        static_cast<int*>(turns), H, G, T_len, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
              const void* seg, void* dq, int B, int H, int G, int T_len, int window, float scale,
              cudaStream_t stream) {
  Maps m;
  if (int err = make_maps<D>(&m, q, k, v, dout, B, H, G, T_len)) return err;
  auto kern = flash_bwd_dq_tc_kernel<D>;
  const int smem = DqSmem<D>::ALLOC;
  static std::atomic<uint32_t> smem_set{0};
  if (int err = allow_smem(kern, smem, smem_set)) return err;
  dim3 grid(B * H, (T_len + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
                                        static_cast<const float*>(delta), static_cast<const int*>(seg),
                                        static_cast<__nv_bfloat16*>(dq), H, G, T_len, window, scale);
  return (int)cudaGetLastError();
}

bool bad_call(int B, int H, int G, int T_len, int dtype) {
  return dtype != 1 || B <= 0 || T_len <= 0 || G <= 0 || H % G != 0;
}

}  // namespace

// q, dout: (B*H, T, D) bf16; k, v: (B*G, T, D) bf16, each 16-byte aligned
// and contiguous; lse, delta: (B*H, T) fp32; seg: (B, T) int32 or null.
// dtype must be 1 (bfloat16); D must be 32, 64 or 128.

// dk, dv like k, v.
extern "C" int pllm_flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* delta, const void* seg, void* dk, void* dv,
                                     int B, int H, int G, int T_len, int D, int window, float scale, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_call(B, H, G, T_len, dtype)) return (int)cudaErrorInvalidValue;
#define CALL(DD) \
  launch_kv<DD, false>(q, k, v, dout, lse, delta, seg, nullptr, dk, dv, nullptr, nullptr, B, H, G, T_len, window, scale, s)
  if (D == 32) return CALL(32);
  if (D == 64) return CALL(64);
  if (D == 128) return CALL(128);
#undef CALL
  return (int)cudaErrorInvalidValue;
}

// dq like q, dk, dv like k, v; dq_acc: (B*H, T, D) fp32 scratch (no need
// to zero it); turns: B*H*ceil(T/64) + 1 int32, zeroed by the caller.
extern "C" int pllm_flash_bwd_fused_tc(const void* q, const void* k, const void* v, const void* dout,
                                       const void* lse, const void* delta, const void* seg, void* dq, void* dk,
                                       void* dv, void* dq_acc, void* turns, int B, int H, int G, int T_len, int D,
                                       int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_call(B, H, G, T_len, dtype)) return (int)cudaErrorInvalidValue;
#define CALL(DD) \
  launch_kv<DD, true>(q, k, v, dout, lse, delta, seg, dq, dk, dv, dq_acc, turns, B, H, G, T_len, window, scale, s)
  if (D == 32) return CALL(32);
  if (D == 64) return CALL(64);
  if (D == 128) return CALL(128);
#undef CALL
  return (int)cudaErrorInvalidValue;
}

// dq like q.
extern "C" int pllm_flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, const void* seg, void* dq, int B, int H,
                                    int G, int T_len, int D, int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_call(B, H, G, T_len, dtype)) return (int)cudaErrorInvalidValue;
  if (D == 32) return launch_dq<32>(q, k, v, dout, lse, delta, seg, dq, B, H, G, T_len, window, scale, s);
  if (D == 64) return launch_dq<64>(q, k, v, dout, lse, delta, seg, dq, B, H, G, T_len, window, scale, s);
  if (D == 128) return launch_dq<128>(q, k, v, dout, lse, delta, seg, dq, B, H, G, T_len, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
