"""Paged KV cache for continuous-batching serving: the block allocator,
batched admission prefill, and paged decode steps.

Counterpart of ``pretraining_llm_tpu/generation/paged.py``. K/V live in a
shared pool of fixed-size blocks per layer; each live request owns an
ordered list of block ids (a row of ``block_tables``) and a logical length
(``seq_lens``). Admission prefills the padded prompts into a dense cache,
scatters each row's pages into the pools and samples the first tokens;
decode steps write one token per row and attend over the row's pages.

PyTorch has no compile cache to protect, so prompts pad only to the batch's
longest page count (the JAX package buckets rows and pages to powers of
two); the logits of every real token are the same either way.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.generation.sampling import sample_logits, sample_logits_fused
from pretraining_llm_tpu_torch.models import transformer
from pretraining_llm_tpu_torch.models.transformer import PagedInfo


def required_blocks(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache slots."""
    return -(-n_tokens // block_size)


def check_paged_bounds(block_tables, seq_lens, block_size: int) -> None:
    """Host-side guard for the PagedInfo capacity invariant: a decode step
    WRITES slot seq_len, so every row needs 0 <= seq_len < capacity."""
    tables = np.asarray(block_tables)
    seq = np.asarray(seq_lens)
    cap = tables.shape[-1] * block_size
    if (seq >= cap).any() or (seq < 0).any():
        bad = np.nonzero((seq >= cap) | (seq < 0))[0].tolist()
        raise ValueError(
            f"paged rows {bad} violate 0 <= seq_len < capacity={cap}: a "
            f"step would overwrite a live block (seq_lens={seq[bad]})"
        )


class BlockAllocator:
    """Host-side free list over pool block ids. Block 0 is reserved as the
    scratch target and never handed out."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need n_blocks >= 2 (block 0 is reserved)")
        self.n_blocks = n_blocks
        # LIFO: recently freed blocks are reused first.
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._live: set = set()

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n block ids, or None if the pool cannot cover them (all or
        nothing: a partial grant would deadlock admission)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._live.update(ids)
        return ids

    def free(self, ids: Sequence[int]) -> None:
        for i in ids:
            if i not in self._live:
                raise ValueError(f"double free / foreign block id {i}")
            self._live.discard(i)
            self._free.append(i)


def _block_size(pools: transformer.KVCache) -> int:
    return int(pools["layers"][0]["k_pool"].shape[1])


def prefill_logits_into_pool_batched(
    params: transformer.Params,
    cfg: ModelConfig,
    pools: transformer.KVCache,
    prompts: Sequence[Sequence[int]],
    rows_block_ids: Sequence[Sequence[int]],
) -> Tuple[torch.Tensor, transformer.KVCache]:
    """Prefill N prompts in one causal forward and write their pages into
    the pools. ``rows_block_ids[i]`` must be exactly
    ceil(len(prompts[i]) / block_size) pages. Returns (each row's last-token
    logits (N, V) fp32, pools updated in place).

    Pad slots past a prompt's end hold garbage K/V; the decode mask only
    exposes slot j once j <= seq_len, and the decode step writes slot
    seq_len before its attention reads it."""
    bs = _block_size(pools)
    device = pools["layers"][0]["k_pool"].device
    n = len(prompts)
    if n == 0:
        raise ValueError("no prompts")
    pages = []
    for i, (p, ids) in enumerate(zip(prompts, rows_block_ids)):
        if len(p) == 0:
            raise ValueError("empty prompt")
        np_i = required_blocks(len(p), bs)
        if np_i != len(ids):
            raise ValueError(
                f"prompt {i} of {len(p)} tokens needs exactly {np_i} pages; "
                f"got {len(ids)} block ids"
            )
        pages.append(np_i)
    n_pages = max(pages)
    p_bucket = n_pages * bs
    prompt_arr = np.zeros((n, p_bucket), np.int64)
    lens = np.zeros((n,), np.int64)
    for i, p in enumerate(prompts):
        prompt_arr[i, : len(p)] = p
        lens[i] = len(p)

    cache = transformer.make_kv_cache(cfg, n, p_bucket, device=device)
    logits, cache = transformer.forward(
        params, torch.from_numpy(prompt_arr).to(device), cfg,
        kv_cache=cache, cache_index=0,
    )
    last = logits[torch.arange(n, device=device), torch.from_numpy(lens - 1).to(device)]

    # Scatter only the real pages: (row, page) -> pool block id.
    rows = torch.tensor([i for i, np_i in enumerate(pages) for _ in range(np_i)], device=device)
    cols = torch.tensor([j for np_i in pages for j in range(np_i)], device=device)
    ids = torch.tensor([b for row_ids in rows_block_ids for b in row_ids], device=device)
    g, dh = cfg.kv_heads, cfg.head_dim
    for layer, pool in enumerate(pools["layers"]):
        for name, pool_name in (("k", "k_pool"), ("v", "v_pool")):
            staged = cache[name][layer].reshape(n, n_pages, bs, g, dh)
            pool[pool_name][ids] = staged[rows, cols].to(pool[pool_name].dtype)
    return last, pools


def prefill_into_pool_batched(
    params: transformer.Params,
    cfg: ModelConfig,
    pools: transformer.KVCache,
    prompts: Sequence[Sequence[int]],
    rows_block_ids: Sequence[Sequence[int]],
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
) -> Tuple[torch.Tensor, transformer.KVCache]:
    """Batched admission: ``prefill_logits_into_pool_batched``, then sample
    each row's first token. Returns (first tokens (N,) int32 on the pools'
    device, pools)."""
    last, pools = prefill_logits_into_pool_batched(params, cfg, pools, prompts, rows_block_ids)
    toks = sample_logits(
        last, generator, temperature=temperature, top_k=top_k, top_p=top_p,
        min_p=min_p,
    )
    return toks, pools


def paged_decode_steps(
    params: transformer.Params,
    pools: transformer.KVCache,
    tokens: torch.Tensor,  # (B,) int — each row's previously sampled token
    block_tables: torch.Tensor,  # (B, max_blocks) int32
    seq_lens: torch.Tensor,  # (B,) int32
    generator: Optional[torch.Generator],
    cfg: ModelConfig,
    n_steps: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
    logprobs_k: int = 0,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]], transformer.KVCache]:
    """``n_steps`` lockstep decode steps for every batch row.

    Each step writes each row's token at slot seq_len, attends over its
    pages and samples the next token. Idle rows (all-zero table row, seq 0)
    scribble on the scratch block and their tokens are ignored by the
    engine. Rows passing their table capacity mid-window redirect writes to
    the scratch block (the model's overshoot guard); the scheduler must
    pre-allocate pages covering seq_len + n_steps writes per live row.

    Returns ((B, n_steps) int32 tokens, None or the ((B, n_steps, k) values,
    (B, n_steps, k) ids) logprob sliver when ``logprobs_k > 0``, pools)."""
    toks, lp_vals, lp_ids = [], [], []
    tok, seq = tokens, seq_lens
    for _ in range(n_steps):
        logits, pools = transformer.forward(
            params, tok[:, None].long(), cfg, kv_cache=pools,
            paged=PagedInfo(block_tables, seq),
        )
        tok, lp = sample_logits_fused(
            logits[:, 0], generator, temperature=temperature, top_k=top_k,
            top_p=top_p, min_p=min_p, logprobs_k=logprobs_k,
        )
        toks.append(tok)
        if lp is not None:
            lp_vals.append(lp[0])
            lp_ids.append(lp[1])
        seq = seq + 1
    lp_out = (torch.stack(lp_vals, 1), torch.stack(lp_ids, 1)) if logprobs_k > 0 else None
    return torch.stack(toks, 1), lp_out, pools



def paged_decode_step(
    params: transformer.Params,
    pools: transformer.KVCache,
    tokens: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: ModelConfig,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
) -> Tuple[torch.Tensor, transformer.KVCache]:
    """One lockstep decode step for every batch row (``paged_decode_steps``
    with one step). Returns ((B,) int32 tokens, pools)."""
    toks, _, pools = paged_decode_steps(
        params, pools, tokens, block_tables, seq_lens, generator, cfg, 1,
        temperature, top_k, top_p, min_p,
    )
    return toks[:, 0], pools
