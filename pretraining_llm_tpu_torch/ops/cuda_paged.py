"""Paged decode attention: the CUDA kernel ``csrc/paged_decode.cu`` (K2) and
its plain PyTorch version.

Counterpart of ``pretraining_llm_tpu/ops/pallas_paged.py::
paged_decode_attention``: attention over each row's pages of the block pool
(n_blocks, block_size, G, Dh) through its block table, with T uniform
queries per row; query t sits at slot seq + t and sees slots <= seq + t
(and > seq + t - window). The plain version is the model's gather lane —
``pool[tables]`` plus a masked softmax — so on the CPU both lanes of
``paged_attention_impl`` compute the same thing.
"""

from __future__ import annotations

import ctypes

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


def smem_bytes(rows: int, d: int, bs: int) -> int:
    """Shared memory one K2 block uses (must match ``smem_bytes`` in the
    source): q rows, a padded K page, a V page, the score panel, the
    accumulator and three per-row stats, all fp32."""
    return 4 * (rows * d + bs * (d + 1) + bs * d + rows * bs + rows * d + 3 * rows)


def _paged_kv_mask(seq_lens: torch.Tensor, t: int, kv_len: int, window: int) -> torch.Tensor:
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
        kv_mask=_paged_kv_mask(seq_lens, t, kv_len, window),
    )
    return out if multi else out[:, 0]


def paged_decode_attention(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, seq_lens: torch.Tensor, *, window: int = 0,
) -> torch.Tensor:
    """K2 for CUDA tensors, the plain version for CPU tensors. Returns q's
    shape. ``paged_decode_attention.launches`` counts kernel launches."""
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
    need = smem_bytes((h // g) * t, d, bs)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"paged_decode_attention: {h // g} heads x {t} queries x Dh {d} x "
            f"block {bs} needs {need} bytes of shared memory (> {MAX_SMEM_BYTES})"
        )
    out = torch.empty_like(q)
    lib = _build.load("paged_decode", "pllm_paged_decode", _ARGTYPES)
    rc = lib(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        b, h, g, t, d, bs, nb, int(window), 1.0 / d**0.5,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "paged_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
