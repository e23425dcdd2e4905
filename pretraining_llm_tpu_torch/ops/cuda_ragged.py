"""Ragged paged attention: the CUDA kernels ``csrc/ragged_paged_tc.cu`` and
``csrc/ragged_paged.cu`` and their plain PyTorch version.

Counterpart of ``pretraining_llm_tpu/ops/pallas_ragged.py``: attention over
each row's pages of the block pool (n_blocks, block_size, G, Dh) through its
block table, where row b carries ``q_lens[b]`` real queries of the batch's
T. Query t of row b sits at slot ``seq_lens[b] + t`` and sees slots
<= seq + t (and > seq + t - window); queries t >= q_lens[b] are padding and
come back as zeros. One launch mixes decode rows (q_len 1) with prefill
chunks and prefix-cache suffixes. Pools are exact (fp32/bf16) or int8 codes
with per-(slot, head) scale pages (fp32 or bf16), dequantized as
``code * (f32(scale) * (1/127))``.

``ragged_paged_attention`` launches a kernel for CUDA tensors: one pass
(``kv_splits`` 1), or the KV range cut into ``kv_splits`` partitions whose
fp32 partials are merged here by a log-sum-exp combine (torch ops), in the
classic or the AMLA form (``amla=True``: base-2 online softmax with an
integer running max and exponent-add rescaling). Two routes, chosen by
shape and dtype before launch (``ragged_route``): bf16 queries over bf16 or
int8 pools at Dh 64 or 128 and block sizes that are multiples of 16 up to
128 run on the tensor cores (``wgmma`` fed by a TMA ring of page loads,
``csrc/ragged_paged_tc.cu``); fp32 queries, and every other bf16 shape,
run the CUDA-core kernel (``csrc/ragged_paged.cu``), because TF32 products
would miss the fp32 bar. A failure raises; no route stands in for another.
For CPU tensors it runs ``ragged_gather_attention``, the plain version,
which the JAX package calls its single source of truth for what the kernel
computes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pretraining_llm_tpu_torch.ops import _build

NEG_INF = -1e30  # finite, as in the Pallas kernel: exp/max edge cases
LOG2E = 1.4426950408889634  # log2(e): nat-domain scores to base 2 (AMLA)
MAX_SMEM_BYTES = 232448  # per-block dynamic shared memory on sm_90
TILE_ROWS = 64  # query rows (queries x heads of a KV group) per block
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = tuple(
    [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 11
    + [ctypes.c_float]
    + [ctypes.c_int] * 3
    + [ctypes.c_void_p]
)
# (q, k_pool, v_pool, k_scale, v_scale, tables, seq_lens, q_lens, out, acc_p, m_p, l_p,
#  B, T, H, G, D, bs, nb, n_blocks, window, splits, tq, amla, score_scale, kv_dtype, scale_dtype, stream)
_TC_ARGTYPES = tuple(
    [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 12
    + [ctypes.c_float]
    + [ctypes.c_int] * 2
    + [ctypes.c_void_p]
)
_TC_HEAD_DIMS = (64, 128)
ROUTES = ("wgmma", "fp32")


def ragged_route(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_dim: int, block_size: int,
                 n_rep: int = 1) -> str:
    """The kernel that a CUDA call takes: ``"wgmma"`` (the tensor-core
    kernel) for bfloat16 queries over bfloat16 or int8 pools at Dh 64 or 128,
    a block size that is a multiple of 16 no larger than 128 and at most
    TILE_ROWS query heads per KV head; ``"fp32"`` (the CUDA-core kernel) for
    float32 queries and for every other bfloat16 shape. Raises for dtypes
    that neither kernel takes."""
    if q_dtype not in _Q_CODES:
        raise TypeError(f"ragged attention takes float32 or bfloat16 q, got {q_dtype}")
    if kv_dtype not in _KV_CODES:
        raise TypeError(f"ragged attention takes float32, bfloat16 or int8 pools, got {kv_dtype}")
    if q_dtype == torch.float32:
        return "fp32"
    if kv_dtype == torch.float32:
        raise TypeError("bfloat16 queries take bfloat16 or int8 pools, not float32")
    fits = head_dim in _TC_HEAD_DIMS and block_size % 16 == 0 and 16 <= block_size <= 128
    return "wgmma" if fits and n_rep <= TILE_ROWS else "fp32"


def tc_smem_bytes(d: int, bs: int, quantized: bool) -> int:
    """Shared memory one block of the tensor-core kernel uses (must match
    ``Smem`` in ``csrc/ragged_paged_tc.cu``): the resident Q tile, a ring of
    2-3 pages as they arrive (bf16 tiles, or int8 codes and their fp32
    scale columns), two widened bf16 pages for int8 pools, the barriers and
    room to align the base."""
    def round1k(x: int) -> int:
        return (x + 1023) // 1024 * 1024

    bsm = 64 if bs <= 64 else 128
    tile = bsm * d * 2
    raw = bsm * d if quantized else tile
    scales = 2 * bsm * 4 if quantized else 0
    stage = round1k(2 * raw + scales)
    wide = round1k(2 * tile + scales) if quantized else 0
    ring = TILE_ROWS * d * 2
    stages = 3 if ring + 2 * wide + 3 * stage <= 110 * 1024 else 2
    return ring + stages * stage + 2 * wide + 2 * stages * 8 + 1024


def queries_per_tile(n_rep: int, t: int) -> int:
    """Queries of a row one block takes: all n_rep heads of its KV group for
    each, about TILE_ROWS rows in all."""
    return max(1, min(t, TILE_ROWS // n_rep))


def smem_bytes(rows: int, d: int, bs: int) -> int:
    """Shared memory one block uses (must match ``smem_bytes`` in the
    source): q rows, a padded K page, a V page, the score panel, the
    accumulator, three per-row stats and two per-slot scale columns, all
    fp32."""
    return 4 * (rows * d + bs * (d + 1) + bs * d + rows * bs + rows * d + 3 * rows + 2 * bs)


def _auto_kv_splits(nb: int, b: int) -> int:
    """Partition-count heuristic, as in the JAX package: target ~8 lanes of
    (B, splits), never slice a row below 2 pages per partition, and a batch
    that already fills the grid gets no splits at all."""
    target = max(1, 8 // max(b, 1))
    p = 1
    while p * 2 <= target and nb // (p * 2) >= 2:
        p *= 2
    return p


def ragged_gather_attention(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, seq_lens: torch.Tensor, q_lens: torch.Tensor, *,
    window: int = 0, k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version: materialize ``pool[tables]`` (int8 pools dequantized
    after the gather) and run the per-query masked softmax in fp32, with
    the ragged validity term. Pad queries return zeros. q (B, T, H, Dh);
    returns q's shape and dtype."""
    b, t, h, d = q.shape
    g = k_pool.shape[2]
    n_rep = h // g
    bs = k_pool.shape[1]
    kv_len = block_tables.shape[1] * bs
    tables = block_tables.long()
    ck = k_pool[tables].reshape(b, kv_len, g, d)
    cv = v_pool[tables].reshape(b, kv_len, g, d)
    if k_scale is not None:
        cks = k_scale[tables].reshape(b, kv_len, g, 1)
        cvs = v_scale[tables].reshape(b, kv_len, g, 1)
        ck = ck.float() * (cks.float() * (1.0 / 127.0))
        cv = cv.float() * (cvs.float() * (1.0 / 127.0))
    if n_rep > 1:
        ck = ck.repeat_interleave(n_rep, dim=2)
        cv = cv.repeat_interleave(n_rep, dim=2)
    dev = q.device
    lin = torch.arange(kv_len, device=dev)
    pos = seq_lens.long()[:, None] + torch.arange(t, device=dev)[None, :]  # (B, T)
    mask = lin[None, None, :] <= pos[:, :, None]  # (B, T, kv_len)
    if window:
        mask = mask & (lin[None, None, :] > pos[:, :, None] - window)
    qvalid = torch.arange(t, device=dev)[None, :] < q_lens.long()[:, None]  # (B, T)
    mask = (mask & qvalid[:, :, None])[:, :, None, :]  # (B, T, 1, kv_len)
    s = torch.einsum("bthd,bkhd->bthk", q.float(), ck.float()) / (d**0.5)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bthk,bkhd->bthd", p, cv.float())
    return out.to(q.dtype)


def ragged_paged_attention(
    q: torch.Tensor,  # (B, T, H, Dh): T is the batch's largest query count
    k_pool: torch.Tensor,  # (n_blocks, block_size, G, Dh)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int32, 0-padded tails
    seq_lens: torch.Tensor,  # (B,) int32: row b's committed offset
    q_lens: torch.Tensor,  # (B,) int32: row b's true query count, <= T
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,  # (n_blocks, block_size, G, 1)
    v_scale: Optional[torch.Tensor] = None,
    kv_splits: Optional[int] = None,  # None = auto heuristic; 1 = one pass
    amla: bool = False,
) -> torch.Tensor:
    """The kernel for CUDA tensors, ``ragged_gather_attention`` for CPU
    tensors. ``k_scale``/``v_scale`` (both or neither) mark int8 pools.
    ``kv_splits`` is clamped to the table width. Invariant (the caller's,
    unchecked): 0 <= q_lens <= T and seq_lens + q_lens <= max_blocks *
    block_size. Returns q's shape and dtype.

    ``ragged_paged_attention.launches`` counts one-pass launches,
    ``ragged_paged_attention.split_launches`` split launches and
    ``ragged_paged_attention.launches_by_route`` both, per route."""
    if q.ndim != 4:
        raise ValueError(
            f"ragged attention takes (B, T, H, Dh) queries, got {tuple(q.shape)} "
            f"(single-token decode belongs to paged_decode_attention)"
        )
    b, t, h, d = q.shape
    g = k_pool.shape[2]
    if h % g != 0:
        raise ValueError(f"kv heads ({g}) must divide query heads ({h})")
    if k_pool.shape != v_pool.shape or k_pool.ndim != 4 or k_pool.shape[3] != d:
        raise ValueError(f"k/v pool mismatch: {tuple(k_pool.shape)} vs {tuple(v_pool.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(
            f"tables {tuple(block_tables.shape)} / seq_lens {tuple(seq_lens.shape)} "
            f"do not match batch {b}"
        )
    if q_lens.shape != (b,):
        raise ValueError(f"q_lens {tuple(q_lens.shape)} does not match batch {b}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is not None:
        want = tuple(k_pool.shape[:-1]) + (1,)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(
                f"scale pools must be {want}, got {tuple(k_scale.shape)} / {tuple(v_scale.shape)}"
            )
    nb = block_tables.shape[1]
    if kv_splits is None:
        kv_splits = _auto_kv_splits(nb, b)
    kv_splits = int(kv_splits)
    if kv_splits < 1:
        raise ValueError(f"kv_splits must be >= 1 (or None for auto), got {kv_splits}")
    kv_splits = min(kv_splits, nb)
    if q.device.type == "cpu":
        return ragged_gather_attention(
            q, k_pool, v_pool, block_tables, seq_lens, q_lens, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )

    quantized = k_scale is not None
    tensors = [q, k_pool, v_pool, block_tables, seq_lens, q_lens]
    if quantized:
        tensors += [k_scale, v_scale]
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError(f"ragged_paged_attention: tensors on {[str(x.device) for x in tensors]}")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"ragged_paged_attention takes float32 or bfloat16 q, got {q.dtype}")
    if quantized:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError(f"scale pools need int8 k/v pools, got {k_pool.dtype}/{v_pool.dtype}")
        if k_scale.dtype not in _Q_CODES or v_scale.dtype != k_scale.dtype:
            raise TypeError(
                f"scale pools must both be float32 or bfloat16, got {k_scale.dtype}/{v_scale.dtype}"
            )
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"exact pools must have q's dtype {q.dtype}, got {k_pool.dtype}/{v_pool.dtype}"
        )
    if any(x.dtype != torch.int32 for x in (block_tables, seq_lens, q_lens)):
        raise TypeError("block_tables, seq_lens and q_lens must be int32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("ragged_paged_attention: every operand must be contiguous")
    bs = k_pool.shape[1]
    n_rep = h // g
    tq = queries_per_tile(n_rep, t)
    route = ragged_route(q.dtype, k_pool.dtype, d, bs, n_rep)
    need = tc_smem_bytes(d, bs, quantized) if route == "wgmma" else smem_bytes(tq * n_rep, d, bs)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"ragged_paged_attention: {n_rep} heads x {tq} queries x Dh {d} x block "
            f"{bs} needs {need} bytes of shared memory (> {MAX_SMEM_BYTES})"
        )
    if route == "wgmma":  # TMA reads q and the pools from 16-byte aligned addresses
        q, k_pool, v_pool = _build.aligned(q), _build.aligned(k_pool), _build.aligned(v_pool)

    split = kv_splits > 1
    out = acc_p = m_p = l_p = None
    if not split:
        out = torch.empty_like(q)
    else:
        acc_p = torch.empty((b, kv_splits, t, h, d), dtype=torch.float32, device=q.device)
        m_p = torch.empty((b, kv_splits, t, h), dtype=torch.float32, device=q.device)
        l_p = torch.empty_like(m_p)
    scale = 1.0 / d**0.5
    score_scale = scale * LOG2E if amla else scale

    def ptr(x: Optional[torch.Tensor]) -> Optional[int]:
        return None if x is None else x.data_ptr()

    pointers = (
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
        block_tables.data_ptr(), seq_lens.data_ptr(), q_lens.data_ptr(),
        ptr(out), ptr(acc_p), ptr(m_p), ptr(l_p),
    )
    scale_code = _Q_CODES[k_scale.dtype] if quantized else 0
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "wgmma":
        lib = _build.load("ragged_paged_tc", "pllm_ragged_paged_tc", _TC_ARGTYPES)
        rc = lib(*pointers, b, t, h, g, d, bs, nb, k_pool.shape[0], int(window), kv_splits, tq,
                 int(bool(amla)), score_scale, _KV_CODES[k_pool.dtype], scale_code, stream)
        _build.check(rc, "ragged_paged_tc")
    else:
        lib = _build.load("ragged_paged", "pllm_ragged_paged", _ARGTYPES)
        rc = lib(*pointers, b, t, h, g, d, bs, nb, int(window), kv_splits, tq, int(bool(amla)),
                 score_scale, _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], scale_code, stream)
        _build.check(rc, "ragged_paged")
    ragged_paged_attention.launches_by_route[route] += 1
    if not split:
        ragged_paged_attention.launches += 1
        return out
    ragged_paged_attention.split_launches += 1
    # Log-sum-exp combine across partitions. Empty partitions carry
    # (acc 0, m NEG_INF, l 0): against a live sibling their weight
    # underflows to 0; an all-empty row keeps w = 1 but l = 0, and the
    # safe-l division gives the pad-query zeros.
    m_tot = m_p.amax(dim=1, keepdim=True)
    w = torch.exp2(m_p - m_tot) if amla else torch.exp(m_p - m_tot)
    l_tot = (l_p * w).sum(dim=1)
    acc_tot = (acc_p * w[..., None]).sum(dim=1)
    safe_l = torch.where(l_tot == 0.0, torch.ones_like(l_tot), l_tot)
    return (acc_tot / safe_l[..., None]).to(q.dtype)


ragged_paged_attention.launches = 0
ragged_paged_attention.split_launches = 0
ragged_paged_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
