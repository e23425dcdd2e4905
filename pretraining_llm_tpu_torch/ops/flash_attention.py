"""Flash-attention dispatch.

Counterpart of ``pretraining_llm_tpu/ops/flash_attention.py::flash_attention``
without the TPU mesh branches: q (B, T, H, Dh) and k/v (B, T, G, Dh) are
folded heads-first and handed to ``cuda_flash.flash_attention_fwd``, which
launches the CUDA kernel for a CUDA tensor and runs the plain version for a
CPU tensor. Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from pretraining_llm_tpu_torch.ops.cuda_flash import flash_attention_fwd


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0,
) -> torch.Tensor:
    """Causal attention, (B, T, H, Dh) x (B, T, G, Dh) -> (B, T, H, Dh), G | H."""
    b, t, h, d = q.shape
    g = k.shape[2]
    if h % g:
        raise ValueError(f"kv heads ({g}) must divide query heads ({h})")

    def heads_first(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 1, 3).reshape(b * x.shape[2], t, d).contiguous()

    o, _ = flash_attention_fwd(heads_first(q), heads_first(k), heads_first(v), h, g, window=window)
    return o.reshape(b, h, t, d).permute(0, 2, 1, 3)
