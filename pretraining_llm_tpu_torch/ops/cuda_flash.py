"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` (K1) and its
plain PyTorch version.

Counterpart of ``pretraining_llm_tpu/ops/pallas_flash.py::_fwd``: O and the
per-row logsumexp of causal (optionally sliding-window) attention over the
heads-first folds q (B*H, T, Dh) and k/v (B*G, T, Dh); query head h reads
KV head h // (H/G). ``flash_attention_fwd`` launches the kernel for CUDA
tensors and runs ``flash_attention_fwd_reference`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pretraining_llm_tpu_torch.ops import _build

NEG_INF = -1e30  # finite, as in the Pallas kernel: exp/max edge cases
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_ARGTYPES = tuple(
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


def _valid_mask(t: int, window: int, device: torch.device) -> torch.Tensor:
    qpos = torch.arange(t, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    ok = qpos >= kpos
    if window:
        ok = ok & (qpos - kpos < window)
    return ok


def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h: int, g: int, *,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: same causal and window masks, fp32 softmax with
    finite NEG_INF, masked p zeroed, P cast to V's dtype before PV, zeros
    for a row with no visible key. Returns (o like q, lse (B*H, T) fp32)."""
    bh, t, d = q.shape
    b = bh // h
    qf = q.reshape(b, g, h // g, t, d).float()
    kf = k.reshape(b, g, t, d).float()
    vf = v.reshape(b, g, t, d)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf) * (1.0 / d**0.5)
    ok = _valid_mask(t, window, q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype).float(), vf.float()) / safe_l
    lse = (m + torch.log(safe_l))[..., 0]
    return o.reshape(bh, t, d).to(q.dtype), lse.reshape(bh, t)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h: int, g: int, *,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 for CUDA tensors, the plain version for CPU tensors.

    q: (B*H, T, Dh); k, v: (B*G, T, Dh), contiguous, one dtype (fp32 or
    bf16), Dh in {64, 128}. Returns (o like q, lse (B*H, T) fp32).
    ``flash_attention_fwd.launches`` counts kernel launches."""
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3:
        raise ValueError(f"expected q (B*H,T,Dh), k/v (B*G,T,Dh); got {q.shape}, {k.shape}, {v.shape}")
    bh, t, d = q.shape
    if h % g or bh % h or k.shape != (bh // h * g, t, d):
        raise ValueError(f"q {tuple(q.shape)} / kv {tuple(k.shape)} do not fold H={h}, G={g}")
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, h, g, window=window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_fwd: tensors on {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} not in {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k, v must be contiguous")
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_fwd", "pllm_flash_fwd", _ARGTYPES)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh // h, h, g, t, d, int(window), 1.0 / d**0.5,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
