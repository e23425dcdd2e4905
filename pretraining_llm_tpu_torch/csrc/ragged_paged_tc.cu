// Ragged paged attention on Hopper's tensor cores, sm_90a: the bf16 route.
// fp32 queries, and bf16 shapes outside this kernel's rule, keep the
// CUDA-core kernel of ragged_paged.cu (ops/cuda_ragged.py::ragged_route).
//
// Replaces: pretraining_llm_tpu/ops/pallas_ragged.py::_ragged_call with its
// kernels _ragged_kernel (one pass) and _ragged_split_kernel (the KV range
// cut into `splits` partitions, merged by the wrapper's log-sum-exp
// combine), both through _attend_page in its classic and AMLA forms
// (_exp2_mul_add), over exact bf16 pools or int8 pools with fp32 or bf16
// scale pages, for bf16 queries. Row b carries q_lens[b] real queries;
// query t sits at slot seq + t and sees slots <= seq + t (and
// > seq + t - window); queries t >= q_lens[b] are padding and come back as
// zeros.
//
// What bounds it on the H100: bytes at decode (one query row per head
// reads its whole live KV: a few FLOPs per byte), operations in long
// chunks (a 256-query chunk does ~4 * 256 FLOPs per K/V element read). So
// both products run on the tensor cores, and the page loads run ahead of
// them through a ring in shared memory.
//
// Design:
//   - One block per (row b, KV head g, query tile[, partition p]): one
//     consumer warpgroup and one producer warp (160 threads). A tile's 64
//     query rows are the M of the warpgroup's wgmma: tq = 64 / n_rep
//     queries x the n_rep heads of group g, block row r = query
//     t0 + r / n_rep of head g * n_rep + r % n_rep. The last query tiles of
//     a row (the longest page walks) are launched first.
//   - Page liveness per tile, as in ragged_paged.cu: pages j with
//     j * bs <= seq + t_last (t_last the tile's last real query), minus the
//     pages wholly at or below seq + t0 - window, cut to the partition's
//     range [p * nb_split, (p + 1) * nb_split). A tile with no real query
//     reads no page and writes zeros, or empty partials (acc 0, m NEG_INF,
//     l 0).
//   - The producer warp reads the block table itself (32 entries at a
//     time, one per lane) and brings page j's K and V for head g into a
//     2-3 stage ring with TMA: a rank-3 tensor map over the pool seen as
//     (n_blocks * bs rows, G, D), one box = bs rows x 1 head x one 128-byte
//     swizzle panel of D (bf16 pools), or bs rows x D bytes unswizzled
//     (int8 codes). Its lanes load the page's bs K and V scale values with
//     plain loads (the (n_blocks, bs, G, 1) scale pool has a slot stride
//     of 2G or 4G bytes, which TMA cannot box), one page ahead, and store
//     f32(scale) * (1/127). Each stage is guarded by a full and an empty
//     mbarrier.
//   - int8 pages: wgmma has no int8 x bf16 form. The consumers widen each
//     page's codes (|c| <= 127: exact in bf16) into a bf16 tile in the
//     swizzled layout wgmma reads (two such tiles, alternating), then
//     release the ring stage. In both forms K's scale multiplies the score
//     columns after the dot and V's scale the probability columns before
//     P.V (the JAX AMLA form's column multiplies; for the classic form the
//     same products, reassociated).
//   - The consumer: S = Q.K^T by wgmma m64n{64,128}k16 (Q resident, loaded
//     once with 16-byte loads; K read K-major), scores times 1/sqrt(Dh)
//     (times log2(e) under AMLA) and the K scale, the mask (causal
//     frontier, window, pad queries, slots past bs), the online softmax in
//     registers on the accumulator fragments (row max across each row's
//     four lanes, row sums per thread, reduced once at the end). Classic:
//     expf and an alpha multiply. AMLA: the running max is
//     max(m, ceil(rowmax)), delta = clip(m_prev - m_new, -126, 0) is an
//     integer, p = exp2f(s - m) (not the fast __exp2f), and l and every
//     accumulator register are rescaled by adding delta to the fp32
//     exponent field, guarded for zeros, subnormals and underflow.
//     NEG_INF = -1e30 (finite), and p is zeroed through the mask itself.
//     P (times V's scale for int8) rounded to bf16 in registers is the A
//     operand of O += P.V (wgmma m64nDk16, V read MN-major). Over exact
//     pools O += P.V is left in flight under the next page's S.
//   - Epilogue: one pass writes acc / l in bf16 (l == 0 gives zeros); the
//     split form writes the fp32 partials acc (B, P, T, H, D), m and l
//     (B, P, T, H), combined by ops/cuda_ragged.py. Every output element is
//     written by one block and no atomics are used: a repeat launch gives
//     the same bits.
//   - Rounding points. Exact bf16 pools: those of the JAX kernel (fp32 S,
//     P rounded to V's dtype before P.V). int8 pools move in two places
//     from the JAX kernel, which keeps P in fp32 against an fp32 V: K's
//     scale is applied after the dot instead of before (an fp32
//     reassociation, ~1e-7 relative), and P * vs / 127 is rounded to bf16
//     for the tensor-core product (~2^-9 relative per element). The output
//     is bf16 either way.
//   - Block sizes: bs a multiple of 16 up to 128. Tiles hold BSM = 64 (bs
//     <= 64) or 128 rows; rows past bs are zeros and masked.
//   - Runs on the caller's stream; allocates nothing. The wrapper
//     (ops/cuda_ragged.py::ragged_paged_attention) picks this kernel by
//     ragged_route and counts its launches.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int ROWS = TILE_ROWS;          // query rows per block: the wgmma M
constexpr int CONSUMERS = 128;           // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr float NEG_INF = -1e30f;
constexpr int RING_BUDGET = 110 * 1024;  // a third ring stage only if two blocks still fit on an SM

constexpr int round1k(int x) { return (x + 1023) / 1024 * 1024; }

// Shared memory of one block, in bytes. ops/cuda_ragged.py::tc_smem_bytes
// repeats this arithmetic.
template <int D, int BSM, bool QUANT>
struct Smem {
  static constexpr int TILE = BSM * D * 2;                     // one bf16 page tile (K or V)
  static constexpr int RAW = QUANT ? BSM * D : TILE;           // one page as it arrives
  static constexpr int SCALES = QUANT ? 2 * BSM * 4 : 0;       // K and V scale columns, fp32
  static constexpr int STAGE = round1k(2 * RAW + SCALES);      // one ring stage
  static constexpr int WIDE = QUANT ? round1k(2 * TILE + SCALES) : 0;  // one widened page
  static constexpr int Q = 0;
  static constexpr int RING = ROWS * D * 2;
  static constexpr int STAGES = RING + 2 * WIDE + 3 * STAGE <= RING_BUDGET ? 3 : 2;
  static constexpr int CV = RING + STAGES * STAGE;             // two widened pages (int8)
  static constexpr int BAR = CV + 2 * WIDE;                    // full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + 2 * STAGES * 8 + 1024;    // + room to align the base
};

// x * 2^k for an integer k in [-126, 0], as an add to the exponent field
// (pallas_ragged.py::_exp2_mul_add): zeros and subnormals stay zero, and an
// underflow flushes to zero instead of borrowing into the sign bit.
__device__ __forceinline__ float exp2_mul_add(float x, int k) {
  const int bits = __float_as_int(x);
  const int exp_field = (bits >> 23) & 0xFF;
  return (exp_field > 0 && exp_field + k > 0) ? __int_as_float(bits + k * (1 << 23)) : 0.f;
}

// Four int8 codes (one 32-bit word) as two bf16 pairs, exactly.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const float c0 = (float)((int)(w << 24) >> 24), c1 = (float)((int)(w << 16) >> 24);
  const float c2 = (float)((int)(w << 8) >> 24), c3 = (float)((int)w >> 24);
  return make_uint2(pack_bf16(c0, c1), pack_bf16(c2, c3));
}

template <int D, int BSM, bool QUANT>
__global__ void __launch_bounds__(THREADS, (D == 64 && BSM == 64) ? 3 : (D * BSM <= 8192 ? 2 : 1))
ragged_tc_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_scale,
                 const void* __restrict__ v_scale, int scale_bf16, const int* __restrict__ tables,
                 const int* __restrict__ seq_lens, const int* __restrict__ q_lens, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ acc_p, float* __restrict__ m_p, float* __restrict__ l_p, int T, int H, int G,
                 int bs, int nb, int window, int splits, int nb_split, int tq, int amla, float score_scale) {
  using S = Smem<D, BSM, QUANT>;
  constexpr int STAGES = S::STAGES;
  constexpr int NP = D / 64;  // 128-byte panels of a bf16 row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* empty = full + STAGES;

  const int n_rep = H / G;
  const int n_tiles = (T + tq - 1) / tq;
  const int tile = n_tiles - 1 - (int)(blockIdx.x % n_tiles);  // longest page walk first
  const int g = (blockIdx.x / n_tiles) % G;
  const int b = blockIdx.x / (n_tiles * G);
  const int part = blockIdx.y;
  const int t0 = tile * tq;
  const int nt = min(tq, T - t0);
  const int R = nt * n_rep;  // query rows of this block
  const int seq = seq_lens[b];
  const int qlen = q_lens[b];
  const int t_last = min(qlen, t0 + nt) - 1;  // last real query of the tile
  int j_lo = 0, j_hi = -1;                    // no page when t_last < t0
  if (t_last >= t0) j_hi = min(nb - 1, (seq + t_last) / bs);
  if (splits > 1) {
    j_lo = part * nb_split;
    j_hi = min(j_hi, min(nb, (part + 1) * nb_split) - 1);
  }
  if (window > 0) {  // skip the pages wholly at or below every window of the tile
    const int x = seq + t0 - window + 2 - bs;
    if (x > 0) j_lo = max(j_lo, (x + bs - 1) / bs);
  }
  const int n_pages = max(0, j_hi - j_lo + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 2);                // the expect_tx arrival and the producer warp's
      mbar_init(&empty[s], CONSUMERS / 32);  // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---------------- producer warp ----------------
    // Page i + 1's table entry and scale values are loaded while page i's
    // stage is filled: no dependent global load waits in the ring's path.
    // Lane l holds the table entry of page 32 * k + l of the current 32.
    const int lane = threadIdx.x & 31;
    const int* tbl = tables + (size_t)b * nb + j_lo;
    const uint32_t page_bytes = (uint32_t)bs * D * (QUANT ? 1 : 2);
    int blk_lane = lane < n_pages ? tbl[lane] : 0;
    float ksr[BSM / 32], vsr[BSM / 32];  // scale values of the lane's slots lane + 32k
    auto fetch_scales = [&](int row0) {
#pragma unroll
      for (int k = 0; k < BSM / 32; ++k) {
        const int c = lane + 32 * k;
        if (c < bs) {
          const size_t so = ((size_t)row0 + c) * G + g;
          ksr[k] = scale_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(k_scale)[so])
                              : static_cast<const float*>(k_scale)[so];
          vsr[k] = scale_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(v_scale)[so])
                              : static_cast<const float*>(v_scale)[so];
        }
      }
    };
    int row0 = __shfl_sync(0xffffffffu, blk_lane, 0) * bs;  // the page's first row of the pool
    if constexpr (QUANT) fetch_scales(row0);
    for (int i = 0; i < n_pages; ++i) {
      const int s = i % STAGES;
      uint8_t* st = smem + S::RING + s * S::STAGE;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * page_bytes);
        if constexpr (QUANT) {
          tma_load_3d(st, &kmap, &full[s], 0, g, row0);
          tma_load_3d(st + S::RAW, &vmap, &full[s], 0, g, row0);
        } else {
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            tma_load_3d(st + p * BSM * 128, &kmap, &full[s], p * 64, g, row0);
            tma_load_3d(st + S::RAW + p * BSM * 128, &vmap, &full[s], p * 64, g, row0);
          }
        }
      }
      if constexpr (QUANT) {
        float* sks = reinterpret_cast<float*>(st + 2 * S::RAW);
#pragma unroll
        for (int k = 0; k < BSM / 32; ++k) {
          const int c = lane + 32 * k;
          if (c < bs) {
            sks[c] = ksr[k] * (1.f / 127.f);
            sks[BSM + c] = vsr[k] * (1.f / 127.f);
          }
        }
      }
      warp_arrive(&full[s]);
      if (i + 1 < n_pages) {
        if ((i + 1) % 32 == 0) blk_lane = i + 1 + lane < n_pages ? tbl[i + 1 + lane] : 0;
        row0 = __shfl_sync(0xffffffffu, blk_lane, (i + 1) % 32) * bs;
        if constexpr (QUANT) fetch_scales(row0);
      }
    }
    return;
  }

  // ---------------- consumer warpgroup ----------------
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  // Q, resident: 64 rows x D, zeros past R, in 128-byte swizzled panels.
  for (int c = tid; c < ROWS * D / 8; c += CONSUMERS) {
    const int r = c / (D / 8), ch = c % (D / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < R) {
      const int t = t0 + r / n_rep, hh = g * n_rep + r % n_rep;
      v = *reinterpret_cast<const uint4*>(q + (((size_t)b * T + t) * H + hh) * D + ch * 8);
    }
    *reinterpret_cast<uint4*>(smem + S::Q + (ch / 8) * ROWS * 128 + swizzle128(r, (ch % 8) * 16)) = v;
  }
  // Tile rows past bs are read by both products: zeros, written once (TMA
  // and the widening never touch them). The widened pages' scale columns
  // too.
  if (bs < BSM) {
    constexpr int N_TILES = QUANT ? 4 : 2 * STAGES;
    const int per_panel = (BSM - bs) * 128 / 16;
    for (int c = tid; c < N_TILES * NP * per_panel; c += CONSUMERS) {
      const int tl = c / (NP * per_panel), rest = c % (NP * per_panel);
      const int p = rest / per_panel, k = rest % per_panel;
      uint8_t* base = QUANT ? smem + S::CV + (tl >> 1) * S::WIDE + (tl & 1) * S::TILE
                            : smem + S::RING + (tl >> 1) * S::STAGE + (tl & 1) * S::RAW;
      *reinterpret_cast<uint4*>(base + p * BSM * 128 + bs * 128 + k * 16) = make_uint4(0, 0, 0, 0);
    }
  }
  if constexpr (QUANT) {
    for (int c = tid; c < 2 * 2 * BSM; c += CONSUMERS)
      reinterpret_cast<float*>(smem + S::CV + (c / (2 * BSM)) * S::WIDE + 2 * S::TILE)[c % (2 * BSM)] = 0.f;
  }
  fence_async_shared();
  named_sync(1, CONSUMERS);

  const int ra = (tid >> 5) * 16 + (lane >> 2);  // the thread's rows ra and rb = ra + 8
  const int rb = ra + 8;
  const int cq = 2 * (lane & 3);  // its first column in each 8-column group
  // Each row's visible slots [lo, hi]; hi = -1 for a pad row or query.
  int lo_a = 0, hi_a = -1, lo_b = 0, hi_b = -1;
  {
    const int ta = t0 + ra / n_rep, tb = t0 + rb / n_rep;
    if (ra < R && ta < qlen) {
      hi_a = seq + ta;
      lo_a = window > 0 ? hi_a - window + 1 : 0;
    }
    if (rb < R && tb < qlen) {
      hi_b = seq + tb;
      lo_b = window > 0 ? hi_b - window + 1 : 0;
    }
  }
  const uint32_t q_tile = smem_u32(smem + S::Q);

  float acc[D / 2];  // O, 64 x D
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;  // running row max (log2 units under AMLA)
  float l_a = 0.f, l_b = 0.f;          // this thread's share of the running row sum
  uint32_t pa[BSM / 16][4];            // P in bf16: the A operand of k step kk (slots 16kk..16kk+15)

  for (int i = 0; i < n_pages; ++i) {
    const int s = i % STAGES;
    const int j = j_lo + i;
    uint8_t* st = smem + S::RING + s * S::STAGE;
    mbar_wait(&full[s], (i / STAGES) & 1);
    uint32_t k_tile = smem_u32(st);
    const float* sk = nullptr;  // K and V scale columns (int8), times 1/127
    const float* sv = nullptr;
    if constexpr (QUANT) {
      // Widen the codes into the page's bf16 tiles. The tiles were last
      // read by page i - 2's O += P.V, which every warp waited for before
      // page i - 1's barrier below.
      uint8_t* cv = smem + S::CV + (i & 1) * S::WIDE;
      const int chunks = bs * D / 16;  // 16 codes each, per tile
      for (int c = tid; c < 2 * chunks; c += CONSUMERS) {
        const int which = c >= chunks, cc = c - which * chunks;
        const int r = cc / (D / 16), col0 = (cc % (D / 16)) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(st + which * S::RAW + r * D + col0);
        const uint2 w0 = widen4(raw.x), w1 = widen4(raw.y), w2 = widen4(raw.z), w3 = widen4(raw.w);
        uint8_t* dst = cv + which * S::TILE + (col0 / 64) * BSM * 128;
        const int b0 = (col0 % 64) * 2;
        *reinterpret_cast<uint4*>(dst + swizzle128(r, b0)) = make_uint4(w0.x, w0.y, w1.x, w1.y);
        *reinterpret_cast<uint4*>(dst + swizzle128(r, b0 + 16)) = make_uint4(w2.x, w2.y, w3.x, w3.y);
      }
      const float* stk = reinterpret_cast<const float*>(st + 2 * S::RAW);
      float* cvk = reinterpret_cast<float*>(cv + 2 * S::TILE);
      for (int c = tid; c < bs; c += CONSUMERS) {
        cvk[c] = stk[c];
        cvk[BSM + c] = stk[BSM + c];
      }
      fence_async_shared();
      warp_arrive(&empty[s]);  // the ring stage is free again
      named_sync(1, CONSUMERS);
      k_tile = smem_u32(cv);
      sk = cvk;
      sv = cvk + BSM;
    }
    const uint32_t v_tile = k_tile + S::TILE;

    float sc[BSM / 2];
#pragma unroll
    for (int e = 0; e < BSM / 2; ++e) sc[e] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BSM>(sc, kmajor_desc<D>(q_tile, kk), kmajor_desc<D, BSM>(k_tile, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();  // this page's S, and the previous page's O += P.V
    fence_regs(sc);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BSM / 16; ++kk) fence_regs(pa[kk]);
    if (!QUANT && i > 0) warp_arrive(&empty[(i - 1) % STAGES]);

    const int base = j * bs;
    uint64_t ok_bits = 0;
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int n = 0; n < BSM / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + cq + (e & 1);
        const int lin = base + col;
        const bool ok = col < bs && (e < 2 ? (lin >= lo_a && lin <= hi_a) : (lin >= lo_b && lin <= hi_b));
        float x = sc[4 * n + e] * score_scale;
        if constexpr (QUANT) x *= sk[col];
        x = ok ? x : NEG_INF;
        if (ok) ok_bits |= 1ull << (4 * n + e);
        sc[4 * n + e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    float ps_a = 0.f, ps_b = 0.f;
    if (amla) {
      const float mn_a = fmaxf(m_a, ceilf(mx_a)), mn_b = fmaxf(m_b, ceilf(mx_b));
      const int d_a = (int)fminf(fmaxf(m_a - mn_a, -126.f), 0.f);
      const int d_b = (int)fminf(fmaxf(m_b - mn_b, -126.f), 0.f);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int e = 0; e < BSM / 2; ++e) {
        const bool row_a = (e & 2) == 0;
        const float p = ((ok_bits >> e) & 1ull) ? exp2f(sc[e] - (row_a ? mn_a : mn_b)) : 0.f;
        sc[e] = p;
        if (row_a) ps_a += p;
        else ps_b += p;
      }
      l_a = exp2_mul_add(l_a, d_a) + ps_a;
      l_b = exp2_mul_add(l_b, d_b) + ps_b;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] = exp2_mul_add(acc[4 * n], d_a);
        acc[4 * n + 1] = exp2_mul_add(acc[4 * n + 1], d_a);
        acc[4 * n + 2] = exp2_mul_add(acc[4 * n + 2], d_b);
        acc[4 * n + 3] = exp2_mul_add(acc[4 * n + 3], d_b);
      }
    } else {
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int e = 0; e < BSM / 2; ++e) {
        const bool row_a = (e & 2) == 0;
        const float p = ((ok_bits >> e) & 1ull) ? expf(sc[e] - (row_a ? mn_a : mn_b)) : 0.f;
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
    }
#pragma unroll
    for (int kk = 0; kk < BSM / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p0 = sc[8 * kk + 2 * r], p1 = sc[8 * kk + 2 * r + 1];
        if constexpr (QUANT) {  // V's scale on the probability columns
          const int col = 16 * kk + 8 * (r >> 1) + cq;
          p0 *= sv[col];
          p1 *= sv[col + 1];
        }
        pa[kk][r] = pack_bf16(p0, p1);
      }

    // O += P.V (V's rows past bs are zeros, as are their p). Exact pools
    // leave it in flight under the next page's S = Q.K^T; int8 pools wait
    // for it, so that the next page's widening runs beside no product.
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BSM / 16; ++kk) wgmma_rs<D>(acc, pa[kk], mnmajor_desc<D, BSM>(v_tile, kk), 1);
    wgmma_commit();
    if constexpr (QUANT) {
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BSM / 16; ++kk) fence_regs(pa[kk]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < BSM / 16; ++kk) fence_regs(pa[kk]);

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= R) continue;
    const int t = t0 + r / n_rep, hh = g * n_rep + r % n_rep;
    const float l = half ? l_b : l_a;
    if (splits > 1) {  // unnormalized partials (B, P, T, H, D) and (B, P, T, H)
      const size_t o = (((size_t)b * splits + part) * T + t) * H + hh;
      float* ap = acc_p + o * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(ap + 8 * n + cq) = make_float2(acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
      if ((lane & 3) == 0) {
        m_p[o] = half ? m_b : m_a;
        l_p[o] = l;
      }
    } else {
      const float safe_l = l == 0.f ? 1.f : l;
      __nv_bfloat16* op = out + (((size_t)b * T + t) * H + hh) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * n + cq) =
            __floats2bfloat162_rn(acc[4 * n + 2 * half] / safe_l, acc[4 * n + 2 * half + 1] / safe_l);
    }
  }
}

// Tensor map over a (n_blocks, bs, G, D) pool seen as (n_blocks * bs rows,
// G, D): boxes of bs rows x 1 head x one 128-byte swizzled panel of D (bf16)
// or x D unswizzled bytes (int8 codes). Returns 0 or a cudaError_t.
static int make_pool_map(CUtensorMap* map, const void* ptr, bool quant, int D, int G, long long rows, int bs) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int elem = quant ? 1 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elem, (cuuint64_t)G * D * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(quant ? D : 64), 1, (cuuint32_t)bs};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(map, quant ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                            const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            quant ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, int BSM, bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale, const void* v_scale,
           int scale_bf16, const void* tables, const void* seq_lens, const void* q_lens, void* out, void* acc_p,
           void* m_p, void* l_p, int B, int T, int H, int G, int bs, int nb, int n_blocks, int window, int splits,
           int tq, int amla, float score_scale, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  const long long rows = (long long)n_blocks * bs;
  if (int err = make_pool_map(&kmap, k_pool, QUANT, D, G, rows, bs)) return err;
  if (int err = make_pool_map(&vmap, v_pool, QUANT, D, G, rows, bs)) return err;
  auto kern = ragged_tc_kernel<D, BSM, QUANT>;
  const int smem = Smem<D, BSM, QUANT>::ALLOC;
  static std::atomic<uint32_t> smem_set{0};
  if (int err = allow_smem(kern, smem, smem_set)) return err;
  const int n_tiles = (T + tq - 1) / tq;
  const int nb_split = (nb + splits - 1) / splits;
  dim3 grid((unsigned)(B * G * n_tiles), splits);
  kern<<<grid, THREADS, smem, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), k_scale, v_scale, scale_bf16,
      static_cast<const int*>(tables), static_cast<const int*>(seq_lens), static_cast<const int*>(q_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(acc_p), static_cast<float*>(m_p),
      static_cast<float*>(l_p), T, H, G, bs, nb, window, splits, nb_split, tq, amla, score_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, T, H, D) bf16; k_pool, v_pool: (n_blocks, bs, G, D) bf16 or
// int8; k_scale, v_scale: (n_blocks, bs, G, 1) fp32 or bf16 (int8 pools),
// else null; tables: (B, nb) int32; seq_lens, q_lens: (B,) int32. q and
// the pools 16-byte aligned, everything contiguous. splits == 1 writes
// `out`; splits > 1 writes the fp32 partials acc_p (B, splits, T, H, D) and
// m_p, l_p (B, splits, T, H). tq: queries per block, tq * H / G <= 64.
// score_scale: 1/sqrt(D), times log2(e) under AMLA. kv_dtype: 1 =
// bfloat16, 2 = int8; scale_dtype (int8 only): 0 = float32, 1 = bfloat16.
// D must be 64 or 128 and bs a multiple of 16 up to 128.
extern "C" int pllm_ragged_paged_tc(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                                    const void* v_scale, const void* tables, const void* seq_lens,
                                    const void* q_lens, void* out, void* acc_p, void* m_p, void* l_p, int B, int T,
                                    int H, int G, int D, int bs, int nb, int n_blocks, int window, int splits,
                                    int tq, int amla, float score_scale, int kv_dtype, int scale_dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || G <= 0 || H % G != 0 || nb <= 0 || n_blocks <= 0 || splits <= 0 || tq <= 0 ||
      tq * (H / G) > ROWS || bs < 16 || bs > 128 || bs % 16 != 0 || (kv_dtype != 1 && kv_dtype != 2))
    return (int)cudaErrorInvalidValue;
  const bool quant = kv_dtype == 2;
#define PLLM_RAGGED_TC(D_, BSM_, Q_)                                                                         \
  return launch<D_, BSM_, Q_>(q, k_pool, v_pool, k_scale, v_scale, scale_dtype, tables, seq_lens, q_lens, out, \
                              acc_p, m_p, l_p, B, T, H, G, bs, nb, n_blocks, window, splits, tq, amla,         \
                              score_scale, s)
  if (D == 64 && bs <= 64) {
    if (quant) PLLM_RAGGED_TC(64, 64, true);
    PLLM_RAGGED_TC(64, 64, false);
  }
  if (D == 64) {
    if (quant) PLLM_RAGGED_TC(64, 128, true);
    PLLM_RAGGED_TC(64, 128, false);
  }
  if (D == 128 && bs <= 64) {
    if (quant) PLLM_RAGGED_TC(128, 64, true);
    PLLM_RAGGED_TC(128, 64, false);
  }
  if (D == 128) {
    if (quant) PLLM_RAGGED_TC(128, 128, true);
    PLLM_RAGGED_TC(128, 128, false);
  }
#undef PLLM_RAGGED_TC
  return (int)cudaErrorInvalidValue;
}
