// Fused cross-entropy head for Hopper, sm_90a: per-token loss and lse of
// h @ W without the (S, V) logits, and the two gradients. Two kernels: the
// fp32 route (ce32_kernel, CUDA cores, any D that is a multiple of 64), and
// ce_kernel, the first bf16 design (mma.sync, D up to 1024), which the bf16
// route's tensor-core kernels (fused_ce_tc.cu, fused_ce_bwd_tc.cu) replaced
// and chip_smoke.py times as their "was".
//
// Replaces, in pretraining_llm_tpu/ops/pallas_ce.py:
//   _fwd_kernel    -> ce32_kernel<FWD>     (pllm_ce_fwd, fp32); ce_kernel<bf16, D, FWD>
//   _bwd_dh_kernel -> ce32_kernel<DH, NT2> (pllm_ce_dh, fp32);  ce_kernel<bf16, D, DH>
//   _bwd_dw_kernel -> ce32_kernel<DW, NT2> (pllm_ce_dw, fp32);  ce_kernel<bf16, D, DW>
//
// Math (row s of h, column v of W, g the per-token cotangent):
//   logits[s, v] = h[s] . W[v]            (compute-dtype operands, fp32 sums)
//   lse[s] = log sum_v exp(logits[s, v]); loss[s] = lse[s] - logits[s, label[s]]
//   p~[s, v] = g[s] * (exp(logits[s, v] - lse[s]) - [v == label[s]])
//   dH[s] = sum_v p~[s, v] W[v];  dW[v] = sum_s p~[s, v] h[s]
// Rounding points follow the Pallas kernels: p~ is formed in fp32 and
// rounded to the compute dtype before its product; dH is written in h's
// dtype and dW in W's. The vocabulary tail (V not a multiple of the tile)
// and the token tail are masked in the kernel: their rows are staged as
// zeros and their p~ is 0.
//
// W is read as (V, D) row-major: for the tied head that is the embedding
// itself. dW is written (V, D).
//
// What bounds it on the H100: at gpt2-124m's training shape (S = 12288,
// D = 768, V = 50304, bf16) the forward does 2*S*D*V = 0.95 TFLOP against
// ~96 MB of operands; each backward kernel recomputes the logits and does
// one more product of the same size (1.9 TFLOP). Far above the card's
// ~295 FLOP/byte ridge: operations bound all three.
//
// The fp32 design (ce32_kernel): D streamed, so any width takes the same
// shared memory.
//   - One block of 256 threads owns 32 resident rows (tokens for the
//     forward and dH, vocabulary entries for dW) and walks the other
//     operand in tiles of 32 rows. Each (32, 32) logits tile is summed over
//     D in 64-column slices of both operands, staged in shared memory one
//     slice pair at a time, each thread's four logits in one fp32
//     accumulator each, k ascending: a fixed order.
//   - dH and dW keep one D-chunk of the output per block (DC = 64 * NT2
//     columns, the widest of 512, 256, 128, 64 dividing D; blockIdx.y picks
//     the chunk) in registers, and recompute the logits tile for each chunk.
//     p~ goes to shared memory in fp32, then the walked tile's chunk
//     columns, and out += p~ . X[:, chunk] adds in walked-row order. No
//     atomics: a repeat launch gives the same bits.
//   - What bounds it: operations on the CUDA cores (67 TFLOP/s in fp32),
//     the logits once for the forward and 1 + D / DC times for dH and dW.
//     Speed is not its point: fp32 heads are the reference precision.
//
// The bf16 design (ce_kernel; wgmma and TMA came later, in the _tc files):
//   - One block of 256 threads (8 warps) owns 32 resident rows: tokens for
//     the forward and dH (rows of h), vocabulary entries for dW (rows of
//     W). The rows are staged in shared memory once. A loop inside the
//     block walks the other operand in tiles of BN rows (W's rows for the
//     forward and dH, h's rows for dW) staged whole in shared memory;
//     that loop takes the place of the TPU kernel's innermost grid axis.
//     dH and dW split the work as the TPU kernels do, each summing over
//     its own axis with no atomics.
//   - The (32, BN) logits tile comes from the staged operands on the
//     tensor cores (mma.sync m16n8k16, fp32 accumulators). 8 warps as
//     2 x 4, each a 16-row strip of the tile.
//   - Forward: each thread keeps an online (max, sum, label logit) for its
//     two rows over its own columns; the partial stats merge across the
//     row's lanes and warps once, after the walk.
//   - dH / dW: p~ goes to shared memory in the compute dtype and the
//     second product (32, BN) x (BN, D) adds into fp32 accumulators in
//     registers, each warp owning D/8 output columns of all 32 rows.
//   - Runs on the caller's stream; allocates nothing. The Python wrappers
//     (ops/cuda_ce.py) count the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 32;        // resident rows per block
constexpr int THREADS = 256;  // 8 warps
constexpr float NEG_INF = -1e30f;

enum Mode { FWD = 0, DH = 1, DW = 2 };

// Walked tile rows and shared-memory row padding of the bf16 kernel: rows
// of D + 8 elements keep 16-byte rows and conflict-free fragment loads.
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int BN = 64, PAD = 8, PPAD = 8; };

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D, int MODE>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int BN = Cfg<T>::BN;
  constexpr int LD = D + Cfg<T>::PAD;
  size_t b = sizeof(T) * (size_t)(BR + BN) * LD;         // resident rows, walked tile
  if (MODE != FWD) b += sizeof(T) * (size_t)BR * (BN + Cfg<T>::PPAD);  // p~
  b += sizeof(float) * (size_t)3 * BN;                   // per-token lse, g, label of a walked tile
  b += sizeof(float) * (size_t)3 * 4 * BR;               // forward stats of the 4 column warps
  return b;
}

// Rows [r0, r0 + n) of a (rows, D) row-major matrix into shared memory with
// leading dimension LD; rows at or past ``rows`` are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int r0, int n, int rows) {
  constexpr int LD = D + Cfg<T>::PAD;
  constexpr int PER_ROW = D / 8;  // 16-byte vectors
  for (int i = threadIdx.x; i < n * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Accumulator layout (that of mma m16n8k16, kept by ce32_kernel too):
// element e of an (16 x 8) tile sits at row g + 8 * (e >> 1), column
// 2 * t4 + (e & 1), with g = lane / 4 and t4 = lane % 4.

// acc[nt] += A[16 rows from a0] . B[8 rows from b0 + 8 nt]^T over K = D;
// A and B both hold their K values contiguous per row (leading dim LD).
template <typename T, int D, int NT>
__device__ __forceinline__ void gemm_abt(float (*acc)[4], const T* a0, const T* b0, int g, int t4) {
  constexpr int LD = D + Cfg<T>::PAD;
#pragma unroll 4
  for (int k0 = 0; k0 < D; k0 += 16) {
    const T* ar = a0 + g * LD + k0 + 2 * t4;
    const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * LD), ld32(ar + 8), ld32(ar + 8 * LD + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const T* br = b0 + (nt * 8 + g) * LD + k0 + 2 * t4;
      mma_bf16(acc[nt], a, ld32(br), ld32(br + 8));
    }
  }
}

// acc[mt][nt] += P[32 x BN] . X[BN x (8 NT columns from c0)]: P holds its
// K values contiguous per row (leading dim LDP), X is row-major (BN, D)
// with leading dim LD, so its K values (rows) are strided.
template <typename T, int D, int NT>
__device__ __forceinline__ void gemm_px(float (*acc)[NT][4], const T* sP, const T* sX, int c0, int g,
                                        int t4) {
  constexpr int BN = Cfg<T>::BN;
  constexpr int LD = D + Cfg<T>::PAD;
  constexpr int LDP = BN + Cfg<T>::PPAD;
#pragma unroll
  for (int k0 = 0; k0 < BN; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const T* ar = sP + (mt * 16 + g) * LDP + k0 + 2 * t4;
      a[mt][0] = ld32(ar);
      a[mt][1] = ld32(ar + 8 * LDP);
      a[mt][2] = ld32(ar + 8);
      a[mt][3] = ld32(ar + 8 * LDP + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const T* x = sX + (k0 + 2 * t4) * LD + c0 + nt * 8 + g;
      const uint32_t b0 = pack2(x[0], x[LD]);
      const uint32_t b1 = pack2(x[8 * LD], x[9 * LD]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

// h: (S, D); w: (V, D); labels (S,) int32; lse, g (S,) fp32.
// FWD writes loss and lse; DH writes out = dH (S, D); DW writes out = dW (V, D).
template <typename T, int D, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
ce_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ labels,
          const float* __restrict__ lse_in, const float* __restrict__ g_in,
          float* __restrict__ loss_out, float* __restrict__ lse_out, T* __restrict__ out,
          int S, int V) {
  constexpr int BN = Cfg<T>::BN;
  constexpr int LD = D + Cfg<T>::PAD;
  constexpr int LDP = BN + Cfg<T>::PPAD;
  constexpr int NT1 = BN / 32;  // n8 tiles of a warp's logits strip (4 column warps)
  constexpr int NT2 = D / 64;   // n8 tiles of a warp's D / 8 output columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sR = reinterpret_cast<T*>(smem_raw);
  T* sX = sR + BR * LD;
  T* sP = sX + BN * LD;
  float* sTok = reinterpret_cast<float*>(smem_raw + smem_bytes<T, D, MODE>() -
                                         sizeof(float) * (3 * BN + 12 * BR));
  float* sLse = sTok;        // BN: lse of a walked token tile (DW)
  float* sG = sLse + BN;     // BN: g
  int* sLab = reinterpret_cast<int*>(sG + BN);  // BN: labels
  float* sStat = sG + 2 * BN;  // 3 x 4 x BR: forward (m, l, gold) per column warp

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // logits strip: rows 16 wm, columns wn * BN / 4
  const int row0 = blockIdx.x * BR;
  const bool walk_vocab = MODE != DW;
  const int n_res = walk_vocab ? S : V;     // resident rows' extent
  const int n_walk = walk_vocab ? V : S;    // walked rows' extent

  stage_rows<T, D>(sR, walk_vocab ? h : w, row0, BR, n_res);

  // Per-token values of this thread's two resident rows (forward, dH).
  int lab_r[2] = {0, 0};
  float lse_r[2] = {0.f, 0.f}, g_r[2] = {0.f, 0.f};
  if (walk_vocab) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int tok = row0 + wm * 16 + g + 8 * hr;
      if (tok < S) {
        lab_r[hr] = labels[tok];
        if (MODE == DH) { lse_r[hr] = lse_in[tok]; g_r[hr] = g_in[tok]; }
      }
    }
  }

  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f}, gold_r[2] = {0.f, 0.f};
  float acc[2][MODE == FWD ? 1 : NT2][4];
  if constexpr (MODE != FWD) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  for (int j0 = 0; j0 < n_walk; j0 += BN) {
    __syncthreads();  // every reader of the previous tile is done
    stage_rows<T, D>(sX, walk_vocab ? w : h, j0, BN, n_walk);
    if (MODE == DW && tid < BN) {
      const int tok = j0 + tid;
      sLse[tid] = tok < S ? lse_in[tok] : 0.f;
      sG[tid] = tok < S ? g_in[tok] : 0.f;
      sLab[tid] = tok < S ? labels[tok] : -1;
    }
    __syncthreads();

    float lg[NT1][4];
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) lg[nt][e] = 0.f;
    gemm_abt<T, D, NT1>(lg, sR + wm * 16 * LD, sX + wn * (BN / 4) * LD, g, t4);

    if constexpr (MODE == FWD) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = NEG_INF;
        bool any = false;
#pragma unroll
        for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int voc = j0 + wn * (BN / 4) + nt * 8 + 2 * t4 + c;
            if (voc < V) {
              any = true;
              mx = fmaxf(mx, lg[nt][2 * hr + c]);
              if (voc == lab_r[hr]) gold_r[hr] += lg[nt][2 * hr + c];
            }
          }
        if (any) {
          const float m_new = fmaxf(m_r[hr], mx);
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int voc = j0 + wn * (BN / 4) + nt * 8 + 2 * t4 + c;
              if (voc < V) sum += expf(lg[nt][2 * hr + c] - m_new);
            }
          l_r[hr] = l_r[hr] * expf(m_r[hr] - m_new) + sum;
          m_r[hr] = m_new;
        }
      }
    } else {
      // p~ in the compute dtype, (32, BN) in shared memory.
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = wm * 16 + g + 8 * (e >> 1);
          const int lc = wn * (BN / 4) + nt * 8 + 2 * t4 + (e & 1);
          float p = 0.f;
          if (MODE == DH) {
            const int tok = row0 + lr, voc = j0 + lc;
            if (tok < S && voc < V) {
              const int hr = e >> 1;
              p = g_r[hr] * (expf(lg[nt][e] - lse_r[hr]) - (voc == lab_r[hr] ? 1.f : 0.f));
            }
          } else {
            const int voc = row0 + lr, tok = j0 + lc;
            if (tok < S && voc < V) {
              p = sG[lc] * (expf(lg[nt][e] - sLse[lc]) - (voc == sLab[lc] ? 1.f : 0.f));
            }
          }
          sP[lr * LDP + lc] = from_f<T>(p);
        }
      __syncthreads();
      gemm_px<T, D, NT2>(acc, sP, sX, warp * (D / 8), g, t4);
    }
  }

  if constexpr (MODE == FWD) {
    // Merge the partial stats: the row's 4 lanes, then its 4 column warps.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m_r[hr], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l_r[hr], off);
        const float go = __shfl_xor_sync(0xffffffffu, gold_r[hr], off);
        const float mn = fmaxf(m_r[hr], mo);
        l_r[hr] = l_r[hr] * expf(m_r[hr] - mn) + lo * expf(mo - mn);
        m_r[hr] = mn;
        gold_r[hr] += go;
      }
      if (t4 == 0) {
        const int lr = wm * 16 + g + 8 * hr;
        sStat[(0 * 4 + wn) * BR + lr] = m_r[hr];
        sStat[(1 * 4 + wn) * BR + lr] = l_r[hr];
        sStat[(2 * 4 + wn) * BR + lr] = gold_r[hr];
      }
    }
    __syncthreads();
    if (tid < BR && row0 + tid < S) {
      float m = NEG_INF;
#pragma unroll
      for (int q = 0; q < 4; ++q) m = fmaxf(m, sStat[(0 * 4 + q) * BR + tid]);
      float l = 0.f, gold = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        l += sStat[(1 * 4 + q) * BR + tid] * expf(sStat[(0 * 4 + q) * BR + tid] - m);
        gold += sStat[(2 * 4 + q) * BR + tid];
      }
      const float lse = m + logf(l);
      lse_out[row0 + tid] = lse;
      loss_out[row0 + tid] = lse - gold;
    }
  } else {
    // dH rows are tokens, dW rows vocabulary entries.
    const int n_out = walk_vocab ? S : V;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row0 + mt * 16 + g + 8 * hr;
        if (r >= n_out) continue;
        T* orow = out + (size_t)r * D + warp * (D / 8) + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt) {
          orow[nt * 8] = from_f<T>(acc[mt][nt][2 * hr]);
          orow[nt * 8 + 1] = from_f<T>(acc[mt][nt][2 * hr + 1]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// fp32 route: ce32_kernel, D streamed (the design notes at the top).
// ---------------------------------------------------------------------------
constexpr int F_BR = 32;          // resident rows per block
constexpr int F_BN = 32;          // walked rows per tile
constexpr int F_DK = 64;          // D slice of the logits products
constexpr int F_LD = F_DK + 1;    // staged slice row: a warp's column reads hit distinct banks
constexpr int F_LDP = F_BN + 1;   // p~ row

template <int MODE, int NT2>
__host__ __device__ constexpr size_t ce32_smem() {
  size_t b = sizeof(float) * (size_t)(F_BR + F_BN) * F_LD;  // resident and walked slices
  if (MODE != FWD) b += sizeof(float) * ((size_t)F_BR * F_LDP + (size_t)F_BN * 64 * NT2);  // p~, chunk
  b += sizeof(float) * (size_t)(3 * F_BN + 12 * F_BR);  // walked tokens' lse, g, label; forward stats
  return b;
}

// Columns [k0, k0 + ncols) of rows [r0, r0 + 32) of a (rows, D) row-major
// fp32 matrix into shared memory with leading dimension ld; rows at or past
// ``rows`` are zeros. ncols is a multiple of 4, k0 and D of 64.
__device__ __forceinline__ void stage32(float* dst, int ld, const float* __restrict__ src, int r0, int rows,
                                        int k0, int ncols, int D) {
  const int per_row = ncols / 4;
  for (int i = threadIdx.x; i < 32 * per_row; i += THREADS) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows) val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + k0 + c);
    float* d = dst + r * ld + c;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

// h: (S, D); w: (V, D); labels (S,) int32; lse, g (S,) fp32; D a multiple
// of 64 (of 64 * NT2 for DH, DW). FWD writes loss and lse; DH writes out =
// dH (S, D); DW writes out = dW (V, D). Block (x, y): resident rows 32 x,
// output columns [64 NT2 y, 64 NT2 (y + 1)).
template <int MODE, int NT2>
__global__ void __launch_bounds__(THREADS, 1)
ce32_kernel(const float* __restrict__ h, const float* __restrict__ w, const int* __restrict__ labels,
            const float* __restrict__ lse_in, const float* __restrict__ g_in,
            float* __restrict__ loss_out, float* __restrict__ lse_out, float* __restrict__ out,
            int S, int V, int D) {
  constexpr int DC = 64 * NT2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sR = reinterpret_cast<float*>(smem_raw);
  float* sW = sR + F_BR * F_LD;
  float* sP = sW + F_BN * F_LD;                       // DH, DW: (32, 32) p~
  float* sX = sP + (MODE == FWD ? 0 : F_BR * F_LDP);  // DH, DW: (32, DC) walked chunk
  float* sTok = sX + (MODE == FWD ? 0 : F_BN * DC);
  float* sLse = sTok;              // F_BN: lse of a walked token tile (DW)
  float* sG = sLse + F_BN;         // F_BN: g
  int* sLab = reinterpret_cast<int*>(sG + F_BN);  // F_BN: labels
  float* sStat = sG + 2 * F_BN;    // 3 x 4 x F_BR: forward (m, l, gold) per column warp

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // logits strip: rows 16 wm, columns 8 wn
  const int row0 = blockIdx.x * F_BR;
  const int c0 = blockIdx.y * DC;
  const bool walk_vocab = MODE != DW;
  const int n_res = walk_vocab ? S : V;
  const int n_walk = walk_vocab ? V : S;
  const float* res_src = walk_vocab ? h : w;
  const float* walk_src = walk_vocab ? w : h;

  int lab_r[2] = {0, 0};
  float lse_r[2] = {0.f, 0.f}, g_r[2] = {0.f, 0.f};
  if (walk_vocab) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int tok = row0 + wm * 16 + g + 8 * hr;
      if (tok < S) {
        lab_r[hr] = labels[tok];
        if (MODE == DH) { lse_r[hr] = lse_in[tok]; g_r[hr] = g_in[tok]; }
      }
    }
  }

  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f}, gold_r[2] = {0.f, 0.f};
  float acc[2][MODE == FWD ? 1 : NT2][4];
  if constexpr (MODE != FWD) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  for (int j0 = 0; j0 < n_walk; j0 += F_BN) {
    float lg[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < D; k0 += F_DK) {
      __syncthreads();  // every reader of the previous slices (and p~, chunk) is done
      stage32(sR, F_LD, res_src, row0, n_res, k0, F_DK, D);
      stage32(sW, F_LD, walk_src, j0, n_walk, k0, F_DK, D);
      if (MODE == DW && k0 == 0 && tid < F_BN) {
        const int tok = j0 + tid;
        sLse[tid] = tok < S ? lse_in[tok] : 0.f;
        sG[tid] = tok < S ? g_in[tok] : 0.f;
        sLab[tid] = tok < S ? labels[tok] : -1;
      }
      __syncthreads();
      const float* a = sR + wm * 16 * F_LD;
      const float* b = sW + wn * 8 * F_LD;
#pragma unroll 8
      for (int k = 0; k < F_DK; ++k) {
        const float x0 = a[g * F_LD + k], x1 = a[(g + 8) * F_LD + k];
        const float y0 = b[2 * t4 * F_LD + k], y1 = b[(2 * t4 + 1) * F_LD + k];
        lg[0] += x0 * y0; lg[1] += x0 * y1;
        lg[2] += x1 * y0; lg[3] += x1 * y1;
      }
    }

    if constexpr (MODE == FWD) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = NEG_INF;
        bool any = false;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int voc = j0 + wn * 8 + 2 * t4 + c;
          if (voc < V) {
            any = true;
            mx = fmaxf(mx, lg[2 * hr + c]);
            if (voc == lab_r[hr]) gold_r[hr] += lg[2 * hr + c];
          }
        }
        if (any) {
          const float m_new = fmaxf(m_r[hr], mx);
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (j0 + wn * 8 + 2 * t4 + c < V) sum += expf(lg[2 * hr + c] - m_new);
          }
          l_r[hr] = l_r[hr] * expf(m_r[hr] - m_new) + sum;
          m_r[hr] = m_new;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = wm * 16 + g + 8 * (e >> 1);
        const int lc = wn * 8 + 2 * t4 + (e & 1);
        float p = 0.f;
        if (MODE == DH) {
          const int tok = row0 + lr, voc = j0 + lc;
          if (tok < S && voc < V) {
            const int hr = e >> 1;
            p = g_r[hr] * (expf(lg[e] - lse_r[hr]) - (voc == lab_r[hr] ? 1.f : 0.f));
          }
        } else {
          const int voc = row0 + lr, tok = j0 + lc;
          if (tok < S && voc < V) p = sG[lc] * (expf(lg[e] - sLse[lc]) - (voc == sLab[lc] ? 1.f : 0.f));
        }
        sP[lr * F_LDP + lc] = p;
      }
      stage32(sX, DC, walk_src, j0, n_walk, c0, DC, D);
      __syncthreads();
      // acc += p~ (32 x 32) . X[:, chunk], each warp DC / 8 columns of all 32 rows.
      const int cw = warp * (DC / 8);
#pragma unroll 4
      for (int k = 0; k < F_BN; ++k) {
        float x[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          x[mt][0] = sP[(mt * 16 + g) * F_LDP + k];
          x[mt][1] = sP[(mt * 16 + g + 8) * F_LDP + k];
        }
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt) {
          const float y0 = sX[k * DC + cw + nt * 8 + 2 * t4];
          const float y1 = sX[k * DC + cw + nt * 8 + 2 * t4 + 1];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            acc[mt][nt][0] += x[mt][0] * y0; acc[mt][nt][1] += x[mt][0] * y1;
            acc[mt][nt][2] += x[mt][1] * y0; acc[mt][nt][3] += x[mt][1] * y1;
          }
        }
      }
    }
  }

  if constexpr (MODE == FWD) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m_r[hr], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l_r[hr], off);
        const float go = __shfl_xor_sync(0xffffffffu, gold_r[hr], off);
        const float mn = fmaxf(m_r[hr], mo);
        l_r[hr] = l_r[hr] * expf(m_r[hr] - mn) + lo * expf(mo - mn);
        m_r[hr] = mn;
        gold_r[hr] += go;
      }
      if (t4 == 0) {
        const int lr = wm * 16 + g + 8 * hr;
        sStat[(0 * 4 + wn) * F_BR + lr] = m_r[hr];
        sStat[(1 * 4 + wn) * F_BR + lr] = l_r[hr];
        sStat[(2 * 4 + wn) * F_BR + lr] = gold_r[hr];
      }
    }
    __syncthreads();
    if (tid < F_BR && row0 + tid < S) {
      float m = NEG_INF;
#pragma unroll
      for (int q = 0; q < 4; ++q) m = fmaxf(m, sStat[(0 * 4 + q) * F_BR + tid]);
      float l = 0.f, gold = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        l += sStat[(1 * 4 + q) * F_BR + tid] * expf(sStat[(0 * 4 + q) * F_BR + tid] - m);
        gold += sStat[(2 * 4 + q) * F_BR + tid];
      }
      const float lse = m + logf(l);
      lse_out[row0 + tid] = lse;
      loss_out[row0 + tid] = lse - gold;
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row0 + mt * 16 + g + 8 * hr;
        if (r >= n_res) continue;
        float* orow = out + (size_t)r * D + c0 + warp * (DC / 8) + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt) {
          orow[nt * 8] = acc[mt][nt][2 * hr];
          orow[nt * 8 + 1] = acc[mt][nt][2 * hr + 1];
        }
      }
  }
}

template <int MODE, int NT2>
int launch32(const void* h, const void* w, const void* labels, const void* lse_in, const void* g_in,
             void* loss, void* lse_out, void* out, int S, int V, int D, cudaStream_t stream) {
  constexpr size_t smem = ce32_smem<MODE, NT2>();
  static_assert(smem <= 232448, "fp32 fused CE tile exceeds the 227 KB of shared memory a block can use");
  auto kern = ce32_kernel<MODE, NT2>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = MODE == DW ? V : S;
  dim3 grid((rows + F_BR - 1) / F_BR, MODE == FWD ? 1 : D / (64 * NT2));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), static_cast<const int*>(labels),
      static_cast<const float*>(lse_in), static_cast<const float*>(g_in), static_cast<float*>(loss),
      static_cast<float*>(lse_out), static_cast<float*>(out), S, V, D);
  return (int)cudaGetLastError();
}

template <typename T, int D, int MODE>
int launch(const void* h, const void* w, const void* labels, const void* lse_in, const void* g_in,
           void* loss, void* lse_out, void* out, int S, int V, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D, MODE>();
  static_assert(smem <= 232448, "fused CE tile exceeds the 227 KB of shared memory a block can use");
  auto kern = ce_kernel<T, D, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = MODE == DW ? V : S;
  kern<<<(rows + BR - 1) / BR, THREADS, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<const int*>(labels),
      static_cast<const float*>(lse_in), static_cast<const float*>(g_in), static_cast<float*>(loss),
      static_cast<float*>(lse_out), static_cast<T*>(out), S, V);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const void* h, const void* w, const void* labels, const void* lse_in, const void* g_in,
             void* loss, void* lse_out, void* out, int S, int V, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
#define PLLM_CE(TT, DD)                                                                      \
  if (D == DD) return launch<TT, DD, MODE>(h, w, labels, lse_in, g_in, loss, lse_out, out, S, V, s);
  if (dtype == 1) {
    PLLM_CE(__nv_bfloat16, 64) PLLM_CE(__nv_bfloat16, 128) PLLM_CE(__nv_bfloat16, 256)
    PLLM_CE(__nv_bfloat16, 512) PLLM_CE(__nv_bfloat16, 768) PLLM_CE(__nv_bfloat16, 1024)
  } else if (dtype == 0 && D > 0 && D % 64 == 0) {
    if constexpr (MODE == FWD) {
      return launch32<MODE, 1>(h, w, labels, lse_in, g_in, loss, lse_out, out, S, V, D, s);
    } else {  // dH and dW: the widest output chunk of 512, 256, 128, 64 columns dividing D
      if (D % 512 == 0) return launch32<MODE, 8>(h, w, labels, lse_in, g_in, loss, lse_out, out, S, V, D, s);
      if (D % 256 == 0) return launch32<MODE, 4>(h, w, labels, lse_in, g_in, loss, lse_out, out, S, V, D, s);
      if (D % 128 == 0) return launch32<MODE, 2>(h, w, labels, lse_in, g_in, loss, lse_out, out, S, V, D, s);
      return launch32<MODE, 1>(h, w, labels, lse_in, g_in, loss, lse_out, out, S, V, D, s);
    }
  }
#undef PLLM_CE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and w alike). D: any positive multiple
// of 64 (fp32), or one of {64, 128, 256, 512, 768, 1024} (bf16).

// loss, lse: (S,) fp32.
extern "C" int pllm_ce_fwd(const void* h, const void* w, const void* labels, void* loss, void* lse,
                           int S, int V, int D, int dtype, void* stream) {
  return dispatch<FWD>(h, w, labels, nullptr, nullptr, loss, lse, nullptr, S, V, D, dtype, stream);
}

// dh: (S, D) like h.
extern "C" int pllm_ce_dh(const void* h, const void* w, const void* labels, const void* lse,
                          const void* g, void* dh, int S, int V, int D, int dtype, void* stream) {
  return dispatch<DH>(h, w, labels, lse, g, nullptr, nullptr, dh, S, V, D, dtype, stream);
}

// dw: (V, D) like w.
extern "C" int pllm_ce_dw(const void* h, const void* w, const void* labels, const void* lse,
                          const void* g, void* dw, int S, int V, int D, int dtype, void* stream) {
  return dispatch<DW>(h, w, labels, lse, g, nullptr, nullptr, dw, S, V, D, dtype, stream);
}
