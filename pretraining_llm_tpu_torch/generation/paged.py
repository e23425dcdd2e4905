"""Paged KV cache for continuous-batching serving: the block allocator,
batched admission prefill, suffix (chunk) prefill, paged decode steps (fused
sampling, or the unfused lane's logits and separate sampler) and the
speculative round over a target and a draft pool.

Counterpart of ``pretraining_llm_tpu/generation/paged.py``. K/V live in a
shared pool of fixed-size blocks per layer; each live request owns an
ordered list of block ids (a row of ``block_tables``) and a logical length
(``seq_lens``). Admission prefills the padded prompts into a dense cache,
scatters each row's pages into the pools and samples the first tokens;
suffix prefill runs a multi-token paged forward over each row's uncached
suffix or next prompt chunk, on top of the pages already in its table;
decode steps write one token per row and attend over the row's pages.

PyTorch has no compile cache to protect, so prompts pad only to the batch's
longest page count and suffixes to the longest suffix (the JAX package
buckets rows and lengths to powers of two); the logits of every real token
are the same either way.

Host arrays reach a CUDA device through ``to_device``: a pinned copy and a
non-blocking upload, so that no call here waits for the stream (the
pipelined scheduler dispatches while earlier windows still run).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.generation.sampling import sample_logits, sample_logits_fused
from pretraining_llm_tpu_torch.generation.speculative import _probs, accept_reject
from pretraining_llm_tpu_torch.models import transformer
from pretraining_llm_tpu_torch.models.transformer import PagedInfo


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: on CUDA
    through a pinned copy uploaded with ``non_blocking`` (PyTorch's pinned
    allocator keeps the buffer until the upload has run); on the CPU a copy,
    so that later host writes to ``arr`` cannot reach the tensor."""
    host = torch.from_numpy(np.array(arr, copy=True))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


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

    def alloc_upto(self, n: int) -> List[int]:
        """Up to ``n`` block ids, possibly fewer or none: the pipelined
        scheduler's opportunistic growth toward its in-flight horizon.
        Grants beyond a row's need are rolled back with ``free``."""
        if n < 0:
            raise ValueError(f"alloc_upto({n})")
        ids = [self._free.pop() for _ in range(min(n, len(self._free)))]
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
        params, to_device(prompt_arr, device), cfg, kv_cache=cache, cache_index=0,
    )
    last = logits[torch.arange(n, device=device), to_device(lens - 1, device)]

    # Scatter only the real pages: (row, page) -> pool block id.
    rows = to_device(np.asarray([i for i, np_i in enumerate(pages) for _ in range(np_i)], np.int64), device)
    cols = to_device(np.asarray([j for np_i in pages for j in range(np_i)], np.int64), device)
    ids = to_device(np.asarray([b for row_ids in rows_block_ids for b in row_ids], np.int64), device)
    for layer, pool in enumerate(pools["layers"]):
        for name, buf in cache.items():  # k, v (+ k_scale, v_scale)
            staged = buf[layer].reshape((n, n_pages, bs) + tuple(buf.shape[-2:]))
            target = pool[name + "_pool"]
            target[ids] = staged[rows, cols].to(target.dtype)
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


def prefill_suffix_logits_into_pool_batched(
    params: transformer.Params,
    cfg: ModelConfig,
    pools: transformer.KVCache,
    suffixes: Sequence[Sequence[int]],
    tables_rows: np.ndarray,  # (N, max_blocks) int: the rows' block tables
    cached_lens: Sequence[int],
    *,
    t_bucket: Optional[int] = None,
) -> Tuple[torch.Tensor, transformer.KVCache]:
    """Prefill N rows' suffixes in ONE multi-token paged forward. Token j of
    row i writes its K/V at slot cached_lens[i] + j through the row's table
    and attends over every page below it (the shared prefix pages read
    only). ``t_bucket`` pins the token axis (chunked prefill: every chunk
    group runs at the chunk size); else rows pad to the longest suffix.
    The forward carries ``q_lens`` = the suffix lengths, so the kernel lane
    takes the ragged kernel. Pad tokens write slots above each row's
    frontier (overwritten before any mask exposes them) or, past the table,
    the scratch block. Returns (each row's last-real-token logits (N, V)
    fp32, pools updated in place)."""
    n = len(suffixes)
    if n == 0:
        raise ValueError("no suffixes")
    if len(cached_lens) != n:
        raise ValueError(f"{n} suffixes but {len(cached_lens)} cached_lens")
    for i, suffix in enumerate(suffixes):
        if len(suffix) == 0:
            raise ValueError(f"suffix {i} is empty (hit must be capped)")
    tables_np = np.asarray(tables_rows, np.int32)
    if tables_np.ndim != 2 or tables_np.shape[0] != n:
        raise ValueError(f"tables_rows must be (n={n}, max_blocks); got {tables_np.shape}")
    max_t = max(len(suffix) for suffix in suffixes)
    if t_bucket is None:
        t_bucket = max_t
    elif t_bucket < max_t:
        raise ValueError(f"t_bucket={t_bucket} cannot hold a {max_t}-token suffix")
    suf = np.zeros((n, t_bucket), np.int64)
    lens = np.zeros((n,), np.int32)
    for i, suffix in enumerate(suffixes):
        suf[i, : len(suffix)] = suffix
        lens[i] = len(suffix)
    device = pools["layers"][0]["k_pool"].device
    lens_dev = to_device(lens, device)
    info = PagedInfo(
        to_device(tables_np, device), to_device(np.asarray(cached_lens, np.int32), device),
        q_lens=lens_dev,
    )
    logits, pools = transformer.forward(
        params, to_device(suf, device), cfg, kv_cache=pools, paged=info
    )
    last = logits[torch.arange(n, device=device), lens_dev.long() - 1]
    return last, pools


def prefill_suffix_into_pool_batched(
    params: transformer.Params,
    cfg: ModelConfig,
    pools: transformer.KVCache,
    suffixes: Sequence[Sequence[int]],
    tables_rows: np.ndarray,
    cached_lens: Sequence[int],
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
    t_bucket: Optional[int] = None,
) -> Tuple[torch.Tensor, transformer.KVCache]:
    """``prefill_suffix_logits_into_pool_batched``, then sample each row's
    first token from its last suffix position. Returns (tokens (N,) int32 on
    the pools' device, pools)."""
    last, pools = prefill_suffix_logits_into_pool_batched(
        params, cfg, pools, suffixes, tables_rows, cached_lens, t_bucket=t_bucket
    )
    toks = sample_logits(
        last, generator, temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p
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


def paged_decode_logits(
    params: transformer.Params,
    pools: transformer.KVCache,
    tokens: torch.Tensor,  # (B,) int
    block_tables: torch.Tensor,  # (B, max_blocks) int32
    seq_lens: torch.Tensor,  # (B,) int32
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, transformer.KVCache]:
    """The unfused lane's forward: one decode step for every row, returning
    the raw (B, V) fp32 logits of each row's position; the token is picked
    by a separate ``sample_tokens`` call (the engine brings the logits to
    the host in between, the transfer fused sampling saves)."""
    logits, pools = transformer.forward(
        params, tokens[:, None].long(), cfg, kv_cache=pools,
        paged=PagedInfo(block_tables, seq_lens),
    )
    return logits[:, 0].float(), pools


def sample_tokens(
    logits: torch.Tensor,  # (B, V) fp32
    generator: Optional[torch.Generator],
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
) -> torch.Tensor:
    """The unfused lane's sampler over logits the host has seen: the fused
    path's ``sample_logits``, so greedy streams of the two lanes agree."""
    return sample_logits(
        logits, generator, temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
    )


def paged_spec_round(
    params_t: transformer.Params,
    t_pools: transformer.KVCache,
    d_pools: transformer.KVCache,
    params_d: transformer.Params,
    tokens: torch.Tensor,  # (B,) int — each row's newest accepted token
    block_tables: torch.Tensor,  # (B, max_blocks) int32, shared by both pools
    seq_lens: torch.Tensor,  # (B,) int32
    generator: Optional[torch.Generator],
    cfg_t: ModelConfig,
    cfg_d: ModelConfig,
    k: int,
    temperature: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, transformer.KVCache, transformer.KVCache]:
    """One speculative round for every row over the paged pools: k draft
    steps at T = 1 propose, a write-only draft step parks the k-th
    proposal's K/V at slot seq + k, then the target verifies all k in one
    (k+1)-token paged forward and ``speculative.accept_reject`` keeps 1 to
    k+1 tokens a row. Both pools share one block table and frontier: page p
    of a request holds target K/V in the target pool and draft K/V in the
    draft pool. Rejected slots hold garbage above the new frontier,
    overwritten by the next round. Returns (emit (B, k+1), n_emit (B,),
    t_pools, d_pools); greedy output equals target-only paged decoding row
    for row."""
    drafts, q_dists = [], []
    tok = tokens
    for j in range(k):
        logits, d_pools = transformer.forward(
            params_d, tok[:, None].long(), cfg_d, kv_cache=d_pools,
            paged=PagedInfo(block_tables, seq_lens + j),
        )
        step = logits[:, 0].float()
        q_dists.append(_probs(step, temperature))
        if temperature == 0.0:
            tok = torch.argmax(step, dim=-1).to(torch.int32)
        else:
            tok = sample_logits(step, generator, temperature=temperature)
        drafts.append(tok)
    _, d_pools = transformer.forward(
        params_d, tok[:, None].long(), cfg_d, kv_cache=d_pools,
        paged=PagedInfo(block_tables, seq_lens + k),
    )
    drafts_t = torch.stack(drafts, dim=1)  # (B, k)
    fed = torch.cat([tokens[:, None].to(torch.int32), drafts_t], dim=1)  # (B, k+1)
    t_logits, t_pools = transformer.forward(
        params_t, fed.long(), cfg_t, kv_cache=t_pools, paged=PagedInfo(block_tables, seq_lens),
    )
    emit, n_emit = accept_reject(
        _probs(t_logits.float(), temperature), torch.stack(q_dists, dim=1), drafts_t,
        generator, temperature,
    )
    return emit, n_emit, t_pools, d_pools
