"""Layer primitives: norms, activations, RoPE — plain functions on tensors.

Counterpart of ``pretraining_llm_tpu/models/layers.py``: norm math runs in
fp32 and the result is cast back to the input dtype; GELU is the tanh
approximation; RoPE rotates split halves (not interleaved pairs) and takes
shared (T,) or per-row (B, T) positions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def layernorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    y = y * p["scale"].float()
    return y.to(x.dtype)


def apply_norm(kind: str, p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    return layernorm(p, x, eps) if kind == "layernorm" else rmsnorm(p, x, eps)


def activation_fn(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "relu":
        return torch.relu(x)
    if kind == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"activation_fn does not handle {kind!r} (swiglu is fused in mlp)")


def rope_table(
    context_length: int, head_dim: int, theta: float, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape (T, head_dim // 2), fp32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))
    angles = torch.arange(context_length, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """Rotate (B, T, H, Dh) by position: ``positions`` is (T,) shared by the
    batch or (B, T) per row. Positions index the tables directly; callers
    keep them inside ``[0, context_length)``."""
    cos_t = cos[positions]
    sin_t = sin[positions]
    if positions.ndim == 2:
        cos_t, sin_t = cos_t[:, :, None], sin_t[:, :, None]  # (B, T, 1, Dh/2)
    else:
        cos_t, sin_t = cos_t[None, :, None], sin_t[None, :, None]  # (1, T, 1, Dh/2)
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos_t - x2 * sin_t, x2 * cos_t + x1 * sin_t], dim=-1)
    return rotated.to(x.dtype)
