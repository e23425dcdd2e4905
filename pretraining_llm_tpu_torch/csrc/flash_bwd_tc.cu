// Flash-attention dK/dV backward (B3) on Hopper's tensor cores, sm_90a:
// the bf16 route. fp32 calls keep flash_bwd.cu's CUDA-core
// flash_bwd_dkv_kernel; dQ (B2) and the one-pass kernel (B4) stay there for
// both dtypes.
//
// Replaces: pretraining_llm_tpu/ops/pallas_flash.py::_bwd's _bwd_dkv_kernel.
// It computes what flash_bwd.cu's dK/dV kernel computes, at the same
// rounding points (per query i, key j, scale = 1/sqrt(Dh)):
//   p  = exp(q.k * scale - lse_i), zeroed where _mask_ok fails (k <= q,
//        q - k < window, seg[q] == seg[k]);
//   ds = p * (dO_i.v_j - D_i) * scale, D_i = rowsum(dO_i * O_i) (fp32, from
//        the wrapper);
//   dV_j = sum_i bf16(p) dO_i, dK_j = sum_i bf16(ds) q_i over the group's
//        n_rep query heads, fp32 sums written as bf16.
// No atomics: each block owns its keys' dK and dV, so the result is the
// same bit for bit on every launch.
//
// What bounds it on the H100: 4 products of 2*Dh FLOPs over the visible
// pairs against q, k, v, dO, lse, D read once and dk, dv written once; at
// llama3-1b-gqa's T = 2048, Dh 128 that is ~990 FLOPs per byte, far above
// the ~295 ridge: operations bound it, so the products run on the tensor
// cores.
//
// Design:
//   - One block per (b*g, 64-key tile): one consumer warpgroup and one
//     producer warp (160 threads). Blocks of the first key tiles, whose
//     causal walks are longest, are launched first. The block walks the
//     query tiles of each of the group's n_rep heads that can see its keys
//     (from the diagonal to the window's end), as the TPU's innermost grid
//     axis does, and keeps dK and dV in fp32 registers across the walk.
//   - The producer warp loads K and V once, and Q and dO tile by tile into
//     a 2-stage ring with TMA (zeros past T), its lanes staging the tile's
//     lse (times log2(e)), D and query document ids beside them; full and
//     empty mbarriers guard each stage.
//   - The consumer computes S^T = K.Q^T and dP^T = V.dO^T (wgmma m64n64k16,
//     both operands from shared memory, K-major), so P^T and dS^T land in
//     registers already shaped as the A operand of dV += P^T.dO and
//     dK += dS^T.Q (wgmma m64nDk16, dO and Q read MN-major from the same
//     swizzled tiles). P and dS never touch shared memory. A dQ product
//     (the one-pass kernel, B4) would read the same dS fragments at the
//     marked point of the loop.
//   - The mask runs only on the diagonal tile, the ragged edge and the
//     window's edge, and on every tile when segments are given: two
//     comparisons with the key row's visible query range, computed once,
//     and the document ids.
//   - Runs on the caller's stream; allocates nothing. The Python wrapper
//     (ops/cuda_flash.py::flash_bwd_dkv) picks this kernel for bf16 and
//     counts its launches (launches_tc).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BKV = TILE_ROWS;  // keys per block
constexpr int BQ = TILE_ROWS;   // queries per step of the walk
constexpr int STAGES = 2;       // Q/dO ring depth
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int TILE = TILE_ROWS * D * 2;          // one bf16 tile
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int QS = 2 * TILE;                      // STAGES x (Q tile, dO tile)
  static constexpr int VEC = QS + STAGES * 2 * TILE;       // STAGES x (lse*log2e, D, seg) of BQ queries
  static constexpr int BAR = VEC + STAGES * 3 * BQ * 4;    // kv_full, full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int H, int G, int T_len, int window, float scale) {
  using S = Smem<D>;
  constexpr int NC = BQ / 8;  // 8-column groups of a (64 keys, BQ queries) product
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int bg = blockIdx.x;
  const int k0 = blockIdx.y * BKV;  // k0 = 0 walks the most q tiles: launched first
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

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 2);  // the expect_tx arrival and the producer warp's
      mbar_init(&empty[s], CONSUMERS / 32);  // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

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
  const int ka = k0 + (threadIdx.x >> 5) * 16 + (lane >> 2);  // key rows ka and kb = ka + 8
  const int kb = ka + 8;
  const int cq = 2 * (lane & 3);  // the thread's first column in each 8-column group
  int seg_a = 0, seg_b = 0;
  if (segp != nullptr) {
    seg_a = ka < T_len ? segp[ka] : -2;
    seg_b = kb < T_len ? segp[kb] : -2;
  }
  // Each key row's visible queries by the causal and window rule: [lo, hi]
  // (empty for a key past T).
  const int lo_a = ka < T_len ? ka : T_len, lo_b = kb < T_len ? kb : T_len;
  const int hi_a = window > 0 ? min(T_len - 1, ka + window - 1) : T_len - 1;
  const int hi_b = window > 0 ? min(T_len - 1, kb + window - 1) : T_len - 1;
  const float scale_log2 = scale * LOG2E;
  const uint32_t k_tile = smem_u32(smem + S::K);
  const uint32_t v_tile = smem_u32(smem + S::V);

  float dk_acc[D / 2], dv_acc[D / 2];  // 64 keys x D each
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int i = 0; i < n_iter; ++i) {
    const int s = i % STAGES;
    const int q0 = q_begin + (i % n_q) * BQ;
    const uint32_t q_tile = smem_u32(smem + S::QS + s * 2 * S::TILE);
    const uint32_t do_tile = q_tile + S::TILE;
    const float* vec = reinterpret_cast<const float*>(smem + S::VEC) + s * 3 * BQ;
    mbar_wait(&full[s], (i / STAGES) & 1);

    float st[BQ / 2], dpt[BQ / 2];  // S^T and dP^T: 64 keys x BQ queries
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) st[e] = dpt[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, kmajor_desc<D>(k_tile, kk), kmajor_desc<D>(q_tile, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, kmajor_desc<D>(v_tile, kk), kmajor_desc<D>(do_tile, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    const bool masked = segp != nullptr || q0 < k0 + BKV - 1 || q0 + BQ > T_len || k0 + BKV > T_len ||
                        (window > 0 && q0 + BQ - 1 - k0 >= window);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(vec + 8 * n + cq);
      int2 sq = make_int2(0, 0);
      if (masked && segp != nullptr) sq = *reinterpret_cast<const int2*>(vec + 2 * BQ + 8 * n + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(st[4 * n + e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
        if (masked) {
          const int qi = q0 + 8 * n + cq + (e & 1);
          bool ok = e < 2 ? (qi >= lo_a && qi <= hi_a) : (qi >= lo_b && qi <= hi_b);
          if (segp != nullptr) ok = ok && ((e & 1) ? sq.y : sq.x) == (e < 2 ? seg_a : seg_b);
          p = ok ? p : 0.f;
        }
        st[4 * n + e] = p;
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(vec + BQ + 8 * n + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x)) * scale;
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T and dS^T in bf16: A operands, k step = 16 queries
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }
    // (A dQ epilogue, dQ += dS.K, would read da here.)

    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(dv_acc, pa[kk], mnmajor_desc<D>(do_tile, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(dk_acc, da[kk], mnmajor_desc<D>(q_tile, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    warp_arrive(&empty[s]);
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

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
           const void* seg, void* dk, void* dv, int B, int H, int G, int T_len, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, domap;
  if (int err = make_tile_map<D>(&qmap, q, T_len, B * H)) return err;
  if (int err = make_tile_map<D>(&kmap, k, T_len, B * G)) return err;
  if (int err = make_tile_map<D>(&vmap, v, T_len, B * G)) return err;
  if (int err = make_tile_map<D>(&domap, dout, T_len, B * H)) return err;
  auto kern = flash_bwd_dkv_tc_kernel<D>;
  const int smem = Smem<D>::ALLOC;
  static std::atomic<uint32_t> smem_set{0};
  if (int err = allow_smem(kern, smem, smem_set)) return err;
  dim3 grid(B * G, (T_len + BKV - 1) / BKV);
  kern<<<grid, THREADS, smem, stream>>>(qmap, kmap, vmap, domap, static_cast<const float*>(lse),
                                        static_cast<const float*>(delta), static_cast<const int*>(seg),
                                        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, G,
                                        T_len, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout: (B*H, T, D) bf16; k, v: (B*G, T, D) bf16, each 16-byte aligned
// and contiguous; lse, delta: (B*H, T) fp32; seg: (B, T) int32 or null; dk,
// dv like k, v. dtype must be 1 (bfloat16); D must be 32, 64 or 128.
extern "C" int pllm_flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* delta, const void* seg, void* dk, void* dv,
                                     int B, int H, int G, int T_len, int D, int window, float scale, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || B <= 0 || T_len <= 0 || G <= 0 || H % G != 0) return (int)cudaErrorInvalidValue;
  if (D == 32) return launch<32>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, G, T_len, window, scale, s);
  if (D == 64) return launch<64>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, G, T_len, window, scale, s);
  if (D == 128) return launch<128>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, G, T_len, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
