"""Flash-attention dispatch.

Counterpart of ``pretraining_llm_tpu/ops/flash_attention.py::flash_attention``
without the TPU mesh branches: q (B, T, H, Dh) and k/v (B, T, G, Dh) are
folded heads-first and handed to ``cuda_flash.FlashAttention``, whose
forward launches the CUDA forward kernel and whose backward launches the
CUDA backward kernels for CUDA tensors, and which runs the plain versions
for CPU tensors. Nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from pretraining_llm_tpu_torch.ops.cuda_flash import FlashAttention


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0,
    block_q: int = 0, block_kv: int = 0, segments: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal attention, (B, T, H, Dh) x (B, T, G, Dh) -> (B, T, H, Dh), G | H.
    ``block_q``/``block_kv`` (0 = auto) choose the backward's algorithm as
    the JAX package's blocks do (``cuda_flash.backward_is_one_pass``).
    ``segments`` (B, T) int document ids: a query attends only keys of its
    own document."""
    b, t, h, d = q.shape
    g = k.shape[2]
    if h % g:
        raise ValueError(f"kv heads ({g}) must divide query heads ({h})")

    def heads_first(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 1, 3).reshape(b * x.shape[2], t, d).contiguous()

    seg = None if segments is None else segments.to(torch.int32).contiguous()
    o = FlashAttention.apply(
        heads_first(q), heads_first(k), heads_first(v), h, g, int(window),
        int(block_q), int(block_kv), seg,
    )
    return o.reshape(b, h, t, d).permute(0, 2, 1, 3)
