"""Token sampling: greedy, temperature, top-k, top-p, min-p.

Counterpart of ``pretraining_llm_tpu/generation/sampling.py``. Random draws
come from an explicit ``torch.Generator`` (categorical sampling is the
Gumbel-max trick), so streams differ from JAX's for the same seed; greedy
decoding is identical.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
) -> torch.Tensor:
    """Sample token ids (B,) int32 from (B, V) logits. temperature=0 ->
    greedy. Rows with a NaN or +inf logit give -1 on the sampling path (out
    of vocab, so the engine fails the request loudly)."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    bad = (torch.isnan(logits) | (logits == math.inf)).any(dim=-1)
    logits = logits / temperature
    # A fill, not a host-to-device copy: sampling never waits for the stream.
    neg_inf = torch.full((), -math.inf, device=logits.device)
    if min_p is not None and 0.0 < min_p <= 1.0:
        # Keep tokens with prob >= min_p * max prob, in logit space.
        cutoff = logits.amax(dim=-1, keepdim=True) + math.log(min_p)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    do_top_k = top_k is not None and top_k > 0
    do_top_p = top_p is not None and 0.0 < top_p < 1.0
    if do_top_k:
        top_k = min(top_k, logits.shape[-1])  # k > V is a no-op filter
    if do_top_p:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        if do_top_k:
            kth = sorted_desc[:, top_k - 1 : top_k]
            logits = torch.where(logits < kth, neg_inf, logits)
            sorted_desc = torch.where(sorted_desc < kth, neg_inf, sorted_desc)
        cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
        # Smallest prefix with cumulative mass >= top_p (always >= 1 token).
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff_logit = torch.gather(sorted_desc, -1, cutoff_idx)
        logits = torch.where(logits < cutoff_logit, neg_inf, logits)
    elif do_top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    sampled = _categorical(logits, generator)
    return torch.where(bad, torch.full_like(sampled, -1), sampled).to(torch.int32)


def sample_logits_fused(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
    logprobs_k: int = 0,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """``sample_logits`` plus the top-``logprobs_k`` log-softmax of the raw
    logits: ``(tokens, None)`` or ``(tokens, (values (B, k) fp32, ids (B,
    k) int32))``, values sorted descending."""
    tokens = sample_logits(
        logits, generator, temperature=temperature, top_k=top_k, top_p=top_p,
        min_p=min_p,
    )
    if logprobs_k <= 0:
        return tokens, None
    lp = torch.log_softmax(logits.float(), dim=-1)
    vals, ids = torch.topk(lp, logprobs_k, dim=-1)
    return tokens, (vals, ids.to(torch.int32))
