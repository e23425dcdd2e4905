"""Plain masked attention — the ``attention_impl="naive"`` lane and the
paged gather lane.

Counterpart of ``pretraining_llm_tpu/ops/attention.py::naive_attention``:
scores and softmax in fp32, GQA native (each group of H/G query heads
attends its shared KV head; K/V are never repeated), causal masking by
position arithmetic, an optional sliding window, a ``kv_mask`` of
(B, Tk) or per query (B, Tq, Tk), and document ``segments``. Rows whose
every key is masked by ``kv_mask`` give zeros, not NaN.
"""

from __future__ import annotations

from typing import Optional

import torch


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: int = 0,
    segments: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: (B, Tq, H, Dh); k, v: (B, Tk, G, Dh) with G | H -> (B, Tq, H, Dh).

    ``segments`` (B, T) int document ids (self-attention, Tq == Tk): a query
    attends only keys of its own document (packed-sequence training)."""
    b, tq, h, dh = q.shape
    tk, g = k.shape[1], k.shape[2]
    if h % g:
        raise ValueError(f"kv heads ({g}) must divide query heads ({h})")
    scale = 1.0 / (dh**0.5)
    qg = q.reshape(b, tq, g, h // g, dh)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
    causal_mask = None
    if causal or window:
        if q_positions is None:
            q_positions = torch.arange(tq, device=q.device) + (tk - tq)
        if kv_positions is None:
            kv_positions = torch.arange(tk, device=q.device)
    if causal:
        causal_mask = q_positions[:, None] >= kv_positions[None, :]  # (Tq, Tk)
        scores = scores.masked_fill(~causal_mask, float("-inf"))
    if window:
        w_ok = (q_positions[:, None] - kv_positions[None, :]) < window
        scores = scores.masked_fill(~w_ok, float("-inf"))
    kv_mask_q = None
    if kv_mask is not None:
        kv_mask_q = kv_mask if kv_mask.ndim == 3 else kv_mask[:, None, :]
        scores = scores.masked_fill(~kv_mask_q[:, None, None], float("-inf"))
    if segments is not None:
        if tq != tk:
            raise ValueError("segments requires self-attention (Tq == Tk)")
        seg_ok = segments[:, :, None] == segments[:, None, :]  # (B, Tq, Tk)
        scores = scores.masked_fill(~seg_ok[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if kv_mask_q is not None:
        # A query whose every key is masked softmaxes to NaN (0/0): zero
        # exactly those rows, derived from the masks so genuine NaNs from
        # corrupt inputs still propagate.
        valid = kv_mask_q.expand(b, tq, tk)
        if causal_mask is not None:
            valid = valid & causal_mask[None]
        dead = ~valid.any(dim=-1)  # (B, Tq)
        probs = probs.masked_fill(dead[:, None, None, :, None], 0.0)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, tq, h, dh).to(q.dtype)
