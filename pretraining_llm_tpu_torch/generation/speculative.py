"""Speculative decoding: a small draft model proposes k tokens, the target
verifies them in one forward.

Counterpart of ``pretraining_llm_tpu/generation/speculative.py``. Decode is
bound by streaming the weights for one token a step; a draft that proposes
k tokens, verified in one (k+1)-token target forward, emits between 1 and
k+1 tokens per target forward.

Contract: greedy (temperature 0) output equals target-only greedy decoding
for any draft, since a proposal is accepted iff it is the target's argmax
and the round's last token is the target's argmax. Sampling uses the
accept/reject rule (``accept_reject``), whose output distribution is the
target's.

``generate_speculative`` is the batch-1 dense-cache path: both models keep
a dense cache over the same slots; the prefill runs at cache index 0 (the
flash kernel K1 on the card), each round k single-token draft steps and a
write-only step for the k-th proposal, then one (k+1)-token target verify
at the round's index (``blockwise_attention``). Where JAX runs the rounds
in one ``while_loop``, the port runs a host loop and reads each round's
accepted count. ``spec_next_inputs`` chains the serving engine's rounds on
the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.generation.sampling import sample_logits
from pretraining_llm_tpu_torch.models import transformer


def _sanitize(cfg: ModelConfig) -> ModelConfig:
    """A generation is one document: drop document masking (forward
    refuses it with a cache)."""
    if cfg.doc_mask_token >= 0:
        cfg = dataclasses.replace(cfg, doc_mask_token=-1)
    return cfg


def _probs(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """(..., V) fp32 distribution at the round's temperature; temperature
    0 gives the one-hot of the argmax (greedy acceptance and correction)."""
    logits = logits.float()
    if temperature == 0.0:
        # A scatter, not ``one_hot``, whose index checks read the device.
        return torch.zeros_like(logits).scatter_(-1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
    return torch.softmax(logits / temperature, dim=-1)


def spec_next_inputs(
    emit: torch.Tensor,  # (B, k+1) int32 round emissions
    n_emit: torch.Tensor,  # (B,) int32 tokens emitted per row (>= 1)
    seq_lens: torch.Tensor,  # (B,) int32 frontier the round was dispatched at
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The next round's (seed token, frontier), chained on the device from
    a ``paged_spec_round`` result with no host read: row b's seed is its
    last emitted token ``emit[b, n_emit[b] - 1]`` and its frontier advances
    by ``n_emit[b]``."""
    rows = torch.arange(emit.shape[0], device=emit.device)
    nxt = emit[rows, (n_emit.long() - 1).clamp_min(0)]
    return nxt, seq_lens + n_emit


def accept_reject(
    p_dists: torch.Tensor,  # (B, k+1, V) target distributions after each fed token
    q_dists: torch.Tensor,  # (B, k, V) draft distributions the proposals came from
    drafts: torch.Tensor,  # (B, k) proposals
    generator: Optional[torch.Generator],
    temperature: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The speculative acceptance rule (Leviathan et al. 2023), vectorized
    over rows: accept proposal i with probability min(1, p_i(d_i) /
    q_i(d_i)) (greedy: iff it is the target's argmax), stop at the first
    rejection and draw the round's last token from norm(max(p - q, 0)) at
    that position, or from the target's (k+1)-th distribution after k
    acceptances. Returns (emit (B, k+1) int32, n_emit (B,) int32): row b's
    tokens are emit[b, :n_emit[b]]."""
    b, k = drafts.shape
    v = p_dists.shape[-1]
    rows = torch.arange(b, device=drafts.device)
    idx = drafts.long()[:, :, None]
    p_at = p_dists[:, :k].gather(2, idx)[..., 0]  # (B, k)
    q_at = q_dists.gather(2, idx)[..., 0]
    if temperature == 0.0:
        accepts = p_at > 0.0
    else:
        u = torch.rand((b, k), generator=generator, device=drafts.device)
        accepts = u < torch.clamp(p_at / q_at.clamp_min(1e-30), max=1.0)
    n_acc = torch.cumprod(accepts.to(torch.int32), dim=1).sum(dim=1)  # (B,)
    p_final = p_dists[rows, n_acc]  # (B, V)
    if temperature == 0.0:
        final = torch.argmax(p_final, dim=-1)
    else:
        q_pad = torch.cat([q_dists, q_dists.new_zeros((b, 1, v))], dim=1)
        resid = (p_final - q_pad[rows, n_acc]).clamp_min(0.0)
        resid = resid / resid.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        u = torch.rand((b, v), generator=generator, device=drafts.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        final = torch.argmax(torch.log(resid + 1e-30) + gumbel, dim=-1)
    emit = torch.cat([drafts.to(torch.int32), drafts.new_zeros((b, 1), dtype=torch.int32)], dim=1)
    emit = emit.index_put((rows, n_acc.long()), final.to(torch.int32))
    return emit, (n_acc + 1).to(torch.int32)


def generate_speculative(
    params_target: Any,
    cfg_target: ModelConfig,
    params_draft: Any,
    cfg_draft: ModelConfig,
    prompt_tokens: Any,  # (P,) or (1, P) ints
    max_new_tokens: int,
    seed: Union[int, torch.Generator] = 0,
    *,
    k: int = 4,
    temperature: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """Returns ((max_new_tokens,) int32 token ids on the params' device,
    {"rounds", "proposed", "accepted"}); accepted / proposed is the draft's
    hit rate."""
    cfg_t = _sanitize(cfg_target)
    cfg_d = _sanitize(cfg_draft)
    if cfg_t.vocab_size != cfg_d.vocab_size:
        raise ValueError(
            f"draft vocab ({cfg_d.vocab_size}) must equal target vocab ({cfg_t.vocab_size})"
        )
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    device = params_target["tok_embed"]["embedding"].device
    if torch.is_tensor(prompt_tokens):
        prompt = prompt_tokens.to(device=device, dtype=torch.long)
    else:
        prompt = torch.as_tensor(np.asarray(prompt_tokens, np.int64), device=device)
    prompt = torch.atleast_2d(prompt)
    if prompt.shape[0] != 1:
        raise ValueError(
            "speculative decoding is the batch-1 latency path; use "
            "generation.generate for batched throughput decoding"
        )
    p_len = int(prompt.shape[1])
    total = p_len + max_new_tokens + k + 1  # a round may overshoot
    for cfg, name in ((cfg_t, "target"), (cfg_d, "draft")):
        if total > cfg.context_length:
            raise ValueError(
                f"prompt({p_len}) + max_new({max_new_tokens}) + k({k}) exceeds "
                f"the {name} context ({cfg.context_length})"
            )
    gen: Optional[torch.Generator]
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed))

    def sample(logits: torch.Tensor) -> torch.Tensor:  # (V,) -> () int
        if temperature == 0.0:
            return torch.argmax(logits.float())
        return sample_logits(logits[None], gen, temperature=temperature)[0]

    with torch.no_grad():
        t_cache = transformer.make_kv_cache(cfg_t, 1, total, device=device)
        d_cache = transformer.make_kv_cache(cfg_d, 1, total, device=device)
        t_logits, t_cache = transformer.forward(params_target, prompt, cfg_t, kv_cache=t_cache, cache_index=0)
        _, d_cache = transformer.forward(params_draft, prompt, cfg_d, kv_cache=d_cache, cache_index=0)
        last = sample(t_logits[0, -1])
        out = [int(last)]
        stats = {"rounds": 0, "proposed": 0, "accepted": 0}
        idx = p_len  # slot of `last`, in neither cache yet
        while len(out) < max_new_tokens:
            tok = last
            drafts, q_dists = [], []
            for j in range(k):
                logits, d_cache = transformer.forward(
                    params_draft, tok.reshape(1, 1).long(), cfg_d, kv_cache=d_cache, cache_index=idx + j,
                )
                q_dists.append(_probs(logits[0, 0], temperature))
                tok = sample(logits[0, 0])
                drafts.append(tok)
            # Write-only: park the k-th proposal's K/V at slot idx + k.
            _, d_cache = transformer.forward(
                params_draft, tok.reshape(1, 1).long(), cfg_d, kv_cache=d_cache, cache_index=idx + k,
            )
            drafts_t = torch.stack(drafts).reshape(1, k).to(torch.int32)
            fed = torch.cat([last.reshape(1, 1).to(torch.int32), drafts_t], dim=1)
            t_logits, t_cache = transformer.forward(params_target, fed.long(), cfg_t, kv_cache=t_cache,
                                                    cache_index=idx)
            emit, n_emit = accept_reject(
                _probs(t_logits.float(), temperature), torch.stack(q_dists)[None], drafts_t, gen, temperature,
            )
            n = int(n_emit[0])  # the round's one host read
            out.extend(emit[0, :n].tolist())
            stats["rounds"] += 1
            stats["proposed"] += k
            stats["accepted"] += n - 1
            last = emit[0, n - 1]
            idx += n
    return torch.tensor(out[:max_new_tokens], dtype=torch.int32, device=device), stats
