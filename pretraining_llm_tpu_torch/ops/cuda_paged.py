"""Paged decode attention: the CUDA kernels of ``csrc/paged_decode.cu`` (K2)
and their plain PyTorch version.

Counterpart of ``pretraining_llm_tpu/ops/pallas_paged.py::
paged_decode_attention``: attention over each row's pages of the block pool
(n_blocks, block_size, G, Dh) through its block table, with T uniform
queries per row; query t sits at slot seq + t and sees slots <= seq + t
(and > seq + t - window). The plain version is the model's gather lane —
``pool[tables]`` plus a masked softmax — so on the CPU both lanes of
``paged_attention_impl`` compute the same thing.

Two kernels, chosen by shape before launch (``paged_route``): Dh 64 or 128
with 64-slot pages and at most 16 query rows per KV head (n_rep * T) run
the split page stream (``"split"``: each row's table cut into
``_kv_partitions`` partitions, one block each, cp.async page rings, the
partials merged in partition order by the last block of each (row, KV
head) inside the same launch); every other shape runs the one-block-per-
(row, KV head) loop (``"loop"``). A failure raises; no route stands in for
another.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pretraining_llm_tpu_torch.ops import _build
from pretraining_llm_tpu_torch.ops.attention import naive_attention

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448  # per-block dynamic shared memory on sm_90
_ARGTYPES = tuple(
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
# (q, k_pool, v_pool, tables, seq_lens, out, part_acc, part_ml, counters,
#  B, H, G, T, D, bs, nb, window, parts, nb_split, scale, dtype, stream)
_SPLIT_ARGTYPES = tuple(
    [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
ROUTES = ("split", "loop")
SPLIT_HEAD_DIMS = (64, 128)
SPLIT_BLOCK_SIZE = 64
SPLIT_MAX_ROWS = 16
SPLIT_THREADS = 128
SPLIT_RING_BUDGET = 96 * 1024
BLOCKS_PER_SM = 2  # the split route's grid holds at least this many blocks per SM


def paged_route(dtype: torch.dtype, head_dim: int, block_size: int, rows: int) -> str:
    """The kernel that a CUDA call takes: ``"split"`` (the split page
    stream) for float32 or bfloat16 at Dh 64 or 128, 64-slot pages and at
    most 16 query rows per KV head (``rows`` = n_rep * T); ``"loop"`` (one
    block per row and KV head) for every other shape. Raises for dtypes
    that neither kernel takes."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16, got {dtype}")
    fits = head_dim in SPLIT_HEAD_DIMS and block_size == SPLIT_BLOCK_SIZE and rows <= SPLIT_MAX_ROWS
    return "split" if fits else "loop"


def _kv_partitions(b: int, g: int, nb: int, sm_count: int) -> Tuple[int, int]:
    """(partitions, table entries per partition) of the split route, from
    shapes the host knows (never from seq_lens, which lie on the card): the
    smallest power of two of partitions that gives the grid of B x G x
    partitions blocks BLOCKS_PER_SM blocks per SM, at most one partition
    per table entry, then no partition left without an entry."""
    parts = 1
    while b * g * parts < BLOCKS_PER_SM * sm_count and parts < nb:
        parts *= 2
    per = -(-nb // min(parts, nb))
    return -(-nb // per), per


def split_smem_bytes(elem_bytes: int, d: int, rows: int) -> int:
    """Shared memory one split block uses (must match ``SplitSmem`` in the
    source) for up to ``rows`` query rows: a ring of 2-4 pages (K and V of
    one head), which then holds the slot groups' sums, q in fp32, two
    score buffers, m, l and two alpha columns, and the last-block flag."""
    ng = SPLIT_THREADS // (d * elem_bytes // 16)
    stage = 2 * SPLIT_BLOCK_SIZE * d * elem_bytes
    stages = 4 if 4 * stage <= SPLIT_RING_BUDGET else (3 if 3 * stage <= SPLIT_RING_BUDGET else 2)
    area = max(stages * stage, ng * rows * d * 4)
    return area + rows * d * 4 + 2 * rows * SPLIT_BLOCK_SIZE * 4 + 4 * rows * 4 + 16


def smem_bytes(rows: int, d: int, bs: int) -> int:
    """Shared memory one block of the loop route uses (must match
    ``smem_bytes`` in the source): q rows, a padded K page, a V page, the
    score panel, the accumulator and three per-row stats, all fp32."""
    return 4 * (rows * d + bs * (d + 1) + bs * d + rows * bs + rows * d + 3 * rows)


def paged_kv_mask(seq_lens: torch.Tensor, t: int, kv_len: int, window: int) -> torch.Tensor:
    """(B, T, kv_len) visibility: query t of row b sees linear slots
    <= seq_b + t (its own just-written slot included), and with a window
    only slots > seq_b + t - window."""
    lin = torch.arange(kv_len, device=seq_lens.device)
    pos = seq_lens.long()[:, None] + torch.arange(t, device=seq_lens.device)[None, :]
    mask = lin[None, None, :] <= pos[:, :, None]
    if window:
        mask = mask & (lin[None, None, :] > pos[:, :, None] - window)
    return mask


def paged_decode_attention_reference(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, seq_lens: torch.Tensor, *, window: int = 0,
) -> torch.Tensor:
    """Plain version of K2: gather each row's pages into its logical KV
    sequence, then masked attention. q (B, H, Dh) or (B, T, H, Dh)."""
    multi = q.ndim == 4
    q4 = q if multi else q[:, None]
    b, t = q4.shape[:2]
    bs = k_pool.shape[1]
    kv_len = block_tables.shape[1] * bs
    tables = block_tables.long()

    def gather(pool: torch.Tensor) -> torch.Tensor:
        return pool[tables].reshape((b, kv_len) + tuple(pool.shape[2:])).to(q.dtype)

    out = naive_attention(
        q4, gather(k_pool), gather(v_pool), causal=False,
        kv_mask=paged_kv_mask(seq_lens, t, kv_len, window),
    )
    return out if multi else out[:, 0]


def paged_decode_attention(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, seq_lens: torch.Tensor, *, window: int = 0,
) -> torch.Tensor:
    """K2 for CUDA tensors (the kernel ``paged_route`` picks), the plain
    version for CPU tensors. Returns q's shape.
    ``paged_decode_attention.launches`` counts kernel launches and
    ``paged_decode_attention.launches_by_route`` the launches per route."""
    multi = q.ndim == 4
    if not multi and q.ndim != 3:
        raise ValueError(f"q must be (B, H, Dh) or (B, T, H, Dh), got {tuple(q.shape)}")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    t = q.shape[1] if multi else 1
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != d:
        raise ValueError(f"k/v pool mismatch: {tuple(k_pool.shape)} vs {tuple(v_pool.shape)}")
    g = k_pool.shape[2]
    if h % g != 0:
        raise ValueError(f"kv heads ({g}) must divide query heads ({h})")
    if block_tables.ndim != 2 or block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(
            f"tables {tuple(block_tables.shape)} / seq_lens {tuple(seq_lens.shape)} "
            f"do not match batch {b}"
        )
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, seq_lens, window=window
        )
    tensors = (q, k_pool, v_pool, block_tables, seq_lens)
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError(f"paged_decode_attention: tensors on {[str(x.device) for x in tensors]}")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"paged_decode_attention takes float32 or bfloat16 q and pools of the "
            f"same dtype, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
        )
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_decode_attention: every operand must be contiguous")
    bs, nb = k_pool.shape[1], block_tables.shape[1]
    rows = (h // g) * t
    route = paged_route(q.dtype, d, bs, rows)
    if route == "loop" and (need := smem_bytes(rows, d, bs)) > MAX_SMEM_BYTES:
        raise ValueError(
            f"paged_decode_attention: {h // g} heads x {t} queries x Dh {d} x "
            f"block {bs} needs {need} bytes of shared memory (> {MAX_SMEM_BYTES})"
        )
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "split":  # cp.async copies 16-byte chunks of the pools
        k_pool, v_pool = _build.aligned(k_pool), _build.aligned(v_pool)
        parts, per = _kv_partitions(b, g, nb, _build.sm_count(q.device.index))
        # fp32 partials: acc (B, G, parts, rows, D), then (m, l) per row;
        # read only with several partitions
        n_acc = b * g * parts * rows * d if parts > 1 else 0
        part = torch.empty(n_acc + n_acc // d * 2, dtype=torch.float32, device=q.device)
        counters = _build.counters(q.device, stream, b * g)
        lib = _build.load("paged_decode", "pllm_paged_decode_split", _SPLIT_ARGTYPES)
        rc = lib(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), part.data_ptr(), part[n_acc:].data_ptr(),
            counters.data_ptr(), b, h, g, t, d, bs, nb, int(window), parts, per, 1.0 / d**0.5,
            _DTYPE_CODES[q.dtype], stream,
        )
    else:
        lib = _build.load("paged_decode", "pllm_paged_decode", _ARGTYPES)
        rc = lib(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            b, h, g, t, d, bs, nb, int(window), 1.0 / d**0.5,
            _DTYPE_CODES[q.dtype], stream,
        )
    _build.check(rc, f"paged_decode ({route})")
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_by_route[route] += 1
    by_t = paged_decode_attention.launches_by_queries
    by_t[(route, t)] = by_t.get((route, t), 0) + 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
# Launches by (route, queries per row T): decode steps run T = 1, a
# speculative verify T = k + 1.
paged_decode_attention.launches_by_queries = {}
