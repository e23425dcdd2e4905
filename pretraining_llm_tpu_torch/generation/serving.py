"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``pretraining_llm_tpu/generation/serving.py::ServingEngine``
with its synchronous scheduler. Each ``step()`` runs:

  admission   — every waiting request that fits claims a free batch row and
                pool blocks (with the prefix cache on, the longest cached
                block-aligned prefix of its prompt is mapped read-only into
                its table and only the rest is charged); all claimed
                prompts prefill in one batched forward (cache hits, and
                every admission under ``int8-kv``, through the suffix lane)
                and each samples its first token;
  chunks      — with ``prefill_chunk_tokens``, admission runs no prefill:
                mid-prefill rows stream their prompts in chunks, FCFS under
                a per-step token budget, and a row's final chunk samples its
                first token;
  growth      — every live row gets the pages its next window writes,
                evicting cold cached pages before preempting;
  preemption  — when the pool runs dry, the youngest running request is
                evicted and requeued with prompt + generated as its new
                prompt (recompute on resume), so the oldest requests always
                finish;
  decode      — a window of ``steps_per_sched`` lockstep decode steps,
                clamped to the live rows' remaining budget;
  reap        — tokens are appended; finished rows publish their full
                committed pages to the prefix cache and free the rest.

Idle and mid-prefill rows keep decoding with their outputs ignored (their
writes land at or above their frontier, or on the reserved scratch block).
Host state (tables, lengths, tokens) lives in numpy and is copied to the
device once per window.

``quantize="int8"`` quantizes the block projections (``models/quantize.py``);
``"int8-kv"`` also turns the KV pools into int8 codes with bf16 scale pages.

Not ported yet, and refused with ``NotImplementedError``: the pipelined
scheduler (``pipeline_depth`` > 1, ``admit_batch``), speculative decoding,
sharded serving (``mesh``), the unfused sampling lane and KV checksums.
Greedy output is identical at every pipeline depth in the JAX package, so
the synchronous scheduler serves the same tokens.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.generation import paged
from pretraining_llm_tpu_torch.generation.prefix_cache import PrefixCache
from pretraining_llm_tpu_torch.models import quantize as quantize_mod
from pretraining_llm_tpu_torch.models import transformer
from pretraining_llm_tpu_torch.utils.device import DeviceLike, resolve_device


class IntegrityError(RuntimeError):
    """An out-of-vocab token id reached the output: corrupted state."""


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    # Tokens generated in earlier incarnations of a preempted request: they
    # were folded into `prompt` for recompute on resume, but belong to the
    # output.
    prefix: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    # Leading entries of ``blocks`` that are shared prefix-cache pages
    # (read only; refcounted by the cache, never freed directly).
    n_shared: int = 0
    row: Optional[int] = None
    admit_order: int = -1
    preemptions: int = 0
    # Chunked prefill: the next prompt index to prefill, or None once the
    # whole prompt is resident. While set, the row's tokens are ignored by
    # decode windows: its committed frontier is mid-prompt.
    prefill_pos: Optional[int] = None


class ServingEngine:
    """Continuous-batching text generation over a shared paged KV pool.

    Usage::

        eng = ServingEngine(params, cfg, max_batch=4, n_blocks=128)
        rid = eng.submit(prompt_ids, max_new_tokens=64)
        outputs = eng.run()        # {rid: [token, ...]}

    ``params`` must lie on ``device`` (default ``cuda``). ``temperature=0``
    (default) decodes greedily; sampling draws from a ``torch.Generator``
    seeded with ``seed``.
    """

    def __init__(
        self,
        params: Any,
        cfg: ModelConfig,
        *,
        max_batch: int = 8,
        n_blocks: int = 256,
        block_size: int = 64,
        max_seq: Optional[int] = None,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        min_p: Optional[float] = None,
        stop_token: Optional[int] = None,
        seed: int = 0,
        steps_per_sched: int = 1,
        pipeline_depth: int = 1,
        admit_batch: int = 0,
        prefill_chunk_tokens: int = 0,
        prefix_cache: bool = False,
        prefix_cache_min_blocks: int = 1,
        kv_checksum: bool = False,
        quantize: str = "none",
        mesh: Any = None,
        draft_params: Any = None,
        draft_cfg: Optional[ModelConfig] = None,
        spec_k: int = 0,
        fused_sampling: bool = True,
        logprobs_k: int = 0,
        device: DeviceLike = None,
    ):
        unported = []
        if pipeline_depth != 1:
            unported.append(f"pipeline_depth={pipeline_depth} (pipelined scheduler)")
        if admit_batch > 1:
            unported.append(f"admit_batch={admit_batch} (pipelined scheduler)")
        if kv_checksum:
            unported.append("kv_checksum")
        if mesh is not None:
            unported.append("mesh (sharded serving)")
        if spec_k or draft_params is not None or draft_cfg is not None:
            unported.append("spec_k / draft model (speculative serving)")
        if not fused_sampling:
            unported.append("fused_sampling=False (unfused sampling lane)")
        if unported:
            raise NotImplementedError(
                "ServingEngine options not ported to PyTorch yet: " + ", ".join(unported)
            )
        if cfg.n_experts:
            raise NotImplementedError("paged serving of MoE models is not ported to PyTorch yet")
        if cfg.doc_mask_token >= 0:
            # A decode session is one document; forward() refuses document
            # masking with a cache (the JAX engine sanitizes it the same way).
            cfg = dataclasses.replace(cfg, doc_mask_token=-1)
        transformer.check_ported(cfg)
        if logprobs_k < 0:
            raise ValueError(f"logprobs_k must be >= 0, got {logprobs_k}")
        if quantize not in ("none", "int8", "int8-kv"):
            raise ValueError(f"quantize must be 'none', 'int8' or 'int8-kv', got {quantize!r}")
        if prefill_chunk_tokens < 0:
            raise ValueError(f"prefill_chunk_tokens must be >= 0, got {prefill_chunk_tokens}")
        self.device = resolve_device(device)
        leaf = params["tok_embed"]["embedding"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params lie on {leaf.device}, the engine runs on {self.device}")
        self.quantize = quantize
        if quantize != "none":
            if quantize == "int8-kv" and cfg.kv_cache_dtype != "int8":
                cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
            # Pre-quantized trees pass through; float trees are quantized here.
            if not quantize_mod.is_quantized(params):
                params = quantize_mod.quantize_params_for_serving(params, cfg)
        # Chunked prefill: prompts stream in chunks of at most this many
        # tokens between decode windows (0 = monolithic admission prefill).
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.params = params
        self.cfg = cfg
        self.logprobs_k = int(logprobs_k)
        # Per-request top-k logprobs, one entry per output token: (values,
        # ids) lists, or None for tokens sampled by the admission prefill.
        self.logprobs: Dict[int, List[Optional[tuple]]] = {}
        self.max_batch = int(max_batch)
        self.block_size = int(block_size)
        # Every reachable prefill bucket (prompts pad to whole blocks, and
        # a preempted request resumes with prompt + generated) must fit
        # the model context.
        ctx_aligned = (cfg.context_length // self.block_size) * self.block_size
        self.max_seq = int(min(max_seq or cfg.context_length, ctx_aligned))
        # No row can hold more than the pool's usable blocks.
        self.max_blocks = min(
            paged.required_blocks(self.max_seq, self.block_size), n_blocks - 1
        )
        self.temperature = temperature
        self.top_k, self.top_p, self.min_p = top_k, top_p, min_p
        self.stop_token = stop_token
        self.steps_per_sched = max(1, int(steps_per_sched))
        # bf16 scale pages for int8-kv; fp32 for an int8 pool set directly.
        self.pools = transformer.make_paged_kv_pool(
            cfg, n_blocks, block_size, device=self.device,
            scale_dtype=torch.bfloat16 if quantize == "int8-kv" else None,
        )
        self.n_blocks = int(n_blocks)
        self.alloc = paged.BlockAllocator(n_blocks)
        self.tables = np.zeros((self.max_batch, self.max_blocks), np.int32)
        self.seq_lens = np.zeros((self.max_batch,), np.int32)
        self.tokens = np.zeros((self.max_batch,), np.int32)
        self.rows: List[Optional[_Request]] = [None] * self.max_batch
        self.waiting: deque = deque()
        self.finished: Dict[int, List[int]] = {}
        # Per-request lifecycle timestamps (monotonic seconds): submit_s,
        # admit_s (first row claim), first_token_s, end_s.
        self.req_timing: Dict[int, Dict[str, float]] = {}
        self._now = time.monotonic
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._next_rid = 0
        self._admit_counter = 0
        self.stats = {
            "steps": 0, "tokens": 0, "preemptions": 0, "admissions": 0,
            # Prompt tokens actually prefilled (suffix only for cache hits).
            "prefill_tokens": 0,
            # Chunked prefill: chunk forwards, chunk tokens, and steps whose
            # chunk forward shared the step with a decode window
            # (interleaved) or ran alone (dedicated).
            "prefill_chunks": 0, "prefill_chunk_tokens": 0,
            "chunk_windows_interleaved": 0, "chunk_windows_dedicated": 0,
            # Host seconds from dispatch to the sampled tokens' arrival on
            # the host (which waits for the device): admission prefills and
            # chunk forwards, and decode windows.
            "prefill_s": 0.0, "decode_s": 0.0,
        }
        # (rows, padded length) of each admission's monolithic prefill
        # forward, and (cached lengths, suffix lengths, token bucket) of
        # each suffix or chunk forward.
        self.prefill_shapes: List[Tuple[int, int]] = []
        self.suffix_shapes: List[Tuple[List[int], List[int], int]] = []
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache:
            self.prefix_cache = PrefixCache(
                self.alloc, self.block_size, min_blocks=prefix_cache_min_blocks,
                stats=self.stats,
            )

    # -- public API --------------------------------------------------------

    def validate_request(self, prompt_ids: Sequence[int], max_new_tokens: Any) -> int:
        """Everything submit() checks, without queueing anything. Returns
        the normalized integer ``max_new_tokens``."""
        try:
            max_new = int(max_new_tokens)
        except (TypeError, ValueError):
            raise ValueError(
                f"max_new_tokens must be an integer, got {type(max_new_tokens).__name__}"
            )
        if max_new != max_new_tokens:
            raise ValueError(f"max_new_tokens must be an integer, got {max_new_tokens!r}")
        p = len(prompt_ids)
        if p == 0:
            raise ValueError("empty prompt")
        ids = np.asarray(prompt_ids)
        if ids.ndim != 1:
            raise ValueError(
                f"prompt must be a flat list of token ids, got an array of shape {ids.shape}"
            )
        if ids.dtype.kind not in "iu":
            raise ValueError(f"prompt must be integer token ids, got dtype {ids.dtype}")
        lo, hi = int(ids.min()), int(ids.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(
                f"prompt token ids must be in [0, {self.cfg.vocab_size}); got range [{lo}, {hi}]"
            )
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        total = p + max_new
        if total > self.max_seq:
            raise ValueError(
                f"prompt({p}) + max_new({max_new}) = {total} exceeds max_seq={self.max_seq}"
            )
        if paged.required_blocks(total, self.block_size) > self.alloc.n_blocks - 1:
            raise ValueError(
                f"request needs {paged.required_blocks(total, self.block_size)} "
                f"blocks; the pool only has {self.alloc.n_blocks - 1}"
            )
        return max_new

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int) -> int:
        """Queue a request; returns its id. Fails fast if the request can
        never fit (prompt + generation must fit max_seq and the pool)."""
        max_new = self.validate_request(prompt_ids, max_new_tokens)
        rid = self._next_rid
        self._next_rid += 1
        self.req_timing[rid] = {"submit_s": self._now()}
        self.waiting.append(_Request(rid, [int(t) for t in prompt_ids], max_new))
        return rid

    def timing_summary(self, rid: int) -> Dict[str, float]:
        """Lifecycle latencies (seconds): ``queue_wait_s`` (submit -> first
        row claim), ``ttft_s`` (submit -> first output token), ``e2e_s``
        (submit -> finish). Only phases the request reached appear. With
        the prefix cache on, ``cached_tokens`` counts the prompt tokens
        served from it, summed over admissions."""
        t = self.req_timing.get(rid)
        if not t:
            return {}
        out: Dict[str, float] = {}
        sub = t["submit_s"]
        if "admit_s" in t:
            out["queue_wait_s"] = t["admit_s"] - sub
        if "first_token_s" in t:
            out["ttft_s"] = t["first_token_s"] - sub
        if "end_s" in t:
            out["e2e_s"] = t["end_s"] - sub
        if "cached_tokens" in t:
            out["cached_tokens"] = int(t["cached_tokens"])
        return out

    def pool_info(self) -> Dict[str, Any]:
        """KV-pool layout: element dtypes, bytes per block and pool bytes,
        summed over every pool tensor (scale pages included)."""
        layer0 = self.pools["layers"][0]
        total = sum(x.numel() * x.element_size() for lyr in self.pools["layers"] for x in lyr.values())
        scale = layer0.get("k_scale_pool")
        return {
            "quantize": self.quantize,
            "kv_dtype": str(layer0["k_pool"].dtype).replace("torch.", ""),
            "kv_scale_dtype": None if scale is None else str(scale.dtype).replace("torch.", ""),
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "bytes_per_block": total // self.n_blocks,
            "pool_bytes": total,
        }

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.rows)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.n_active > 0

    def step(self) -> None:
        """One scheduling round: admit -> prefill chunks (chunked mode) ->
        grow/preempt -> a decode window -> reap. A no-op when nothing is
        running or waiting. Forwards run under ``torch.inference_mode()``:
        params fresh from training (leaves that require grad) record no
        graph."""
        with torch.inference_mode():
            self._admit()
            chunked = self._dispatch_prefill_chunks()
            decoded = self._step_decode() if self._n_decode_rows() else False
        if chunked:
            key = "chunk_windows_interleaved" if decoded else "chunk_windows_dedicated"
            self.stats[key] += 1

    def run(self) -> Dict[int, List[int]]:
        """Drive the engine until every submitted request has finished;
        returns {rid: output tokens}."""
        while self.has_work():
            self.step()
        return self.finished

    # -- scheduling internals ---------------------------------------------

    def _n_decode_rows(self) -> int:
        """Rows past their prefill phase (mid-chunk rows do not decode)."""
        return sum(1 for r in self.rows if r is not None and r.prefill_pos is None)

    def _window_len(self) -> int:
        """``steps_per_sched`` clamped by the live rows' remaining budget,
        rounded up to a power of two (the JAX package's window-program
        buckets — kept so the two engines run the same windows)."""
        n = self.steps_per_sched
        if n <= 1:
            return 1
        rem = max(
            (req.max_new - len(req.generated) for req in self.rows if req is not None),
            default=n,
        )
        if rem >= n:
            return n
        b = 1
        while b < max(1, rem):
            b <<= 1
        return min(b, n)

    def _step_decode(self) -> bool:
        """The decode arm of step(); True when a window ran."""
        n = self._window_len()
        self._ensure_write_pages(horizon=n)
        if self._n_decode_rows() == 0:  # everyone got preempted (tiny pool)
            return False
        paged.check_paged_bounds(self.tables, self.seq_lens, self.block_size)
        dev = self.device
        t0 = time.perf_counter()
        toks, lp, self.pools = paged.paged_decode_steps(
            self.params, self.pools,
            torch.from_numpy(self.tokens).to(dev),
            torch.from_numpy(self.tables).to(dev),
            torch.from_numpy(self.seq_lens).to(dev),
            self._gen, self.cfg, n, self.temperature, self.top_k, self.top_p,
            self.min_p, logprobs_k=self.logprobs_k,
        )
        window = toks.cpu().numpy()  # (B, n)
        lp_host = None if lp is None else (lp[0].cpu().numpy(), lp[1].cpu().numpy())
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["steps"] += n
        for row, req in enumerate(self.rows):
            if req is None or req.prefill_pos is not None:
                continue
            self._consume_tokens(
                req, row, window[row],
                lp=None if lp_host is None else (lp_host[0][row], lp_host[1][row]),
            )
        return True

    def _consume_tokens(self, req: _Request, row: int, toks, lp=None) -> None:
        """Append a row's window of tokens, finish on stop/max_new and
        discard the surplus."""
        for i, tok in enumerate(int(t) for t in toks):
            self.seq_lens[row] += 1
            self._check_token(req, tok)
            req.generated.append(tok)
            self._lp_append(req, None if lp is None else (lp[0][i].tolist(), lp[1][i].tolist()))
            self._emit_token(req, tok)
            self.tokens[row] = tok
            self.stats["tokens"] += 1
            if tok == self.stop_token or len(req.generated) >= req.max_new:
                self._finish(req)
                break

    def _lp_append(self, req: _Request, entry) -> None:
        if self.logprobs_k:
            self.logprobs.setdefault(req.rid, []).append(entry)

    def _emit_token(self, req: _Request, tok: int) -> None:
        t = self.req_timing.get(req.rid)
        if t is not None and tok != self.stop_token:
            t.setdefault("first_token_s", self._now())

    def _check_token(self, req: _Request, tok: int) -> None:
        """An out-of-vocab id can only come from corrupted state (sampling
        maps non-finite logits to -1), so fail loudly instead of streaming
        it."""
        if 0 <= tok < self.cfg.vocab_size:
            return
        self.stats["invalid_tokens"] = self.stats.get("invalid_tokens", 0) + 1
        raise IntegrityError(
            f"invalid token id {tok} for rid {req.rid} (vocab size "
            f"{self.cfg.vocab_size}): refusing to stream corrupted output"
        )

    def _first_tokens(self, group: List[_Request], toks) -> None:
        """Commit the prefill-sampled first token of each request of a
        group (host array ``toks``, one per request)."""
        for req, tok in zip(group, (int(t) for t in toks)):
            self._check_token(req, tok)
            req.generated.append(tok)
            self._lp_append(req, None)  # prefill-sampled: no logprob sliver
            self._emit_token(req, tok)
            self.tokens[req.row] = tok
            if tok == self.stop_token or len(req.generated) >= req.max_new:
                self._finish(req)

    def _cache_available(self) -> int:
        """Blocks admission may count on: the free list plus cold cached
        blocks the LRU hands back on demand."""
        avail = self.alloc.available
        if self.prefix_cache is not None:
            avail += self.prefix_cache.evictable
        return avail

    def _cache_alloc(self, n: int) -> Optional[List[int]]:
        """``alloc.alloc(n)``, evicting cold cached blocks first when the
        free list alone cannot cover it."""
        if self.prefix_cache is not None and n > self.alloc.available:
            self.prefix_cache.evict(n - self.alloc.available)
        return self.alloc.alloc(n)

    def _admit(self) -> None:
        """FCFS admission: every queue head that fits claims a free row,
        then all claimed prompts prefill in one batched forward per lane
        (none in chunked mode: the chunks stream them)."""
        admits: List[_Request] = []
        while self.waiting:
            free_rows = [i for i, r in enumerate(self.rows) if r is None]
            if not free_rows:
                break
            req: _Request = self.waiting[0]
            p = len(req.prompt)
            # +1: the first decode step writes slot p — its page must exist.
            need = paged.required_blocks(p + 1, self.block_size)
            # Prefix-cache lookup: retain the longest cached block-aligned
            # prefix and charge admission only for the rest.
            cached_len, shared = 0, []
            if self.prefix_cache is not None:
                cached_len, shared = self.prefix_cache.acquire(req.prompt)
            need_new = need - len(shared)
            # Admission watermark: keep one growth block of headroom per
            # running row, else a nearly dry pool admits a newcomer only for
            # it to be preempted at the next block boundary. Cold cached
            # blocks count as available.
            if self._cache_available() - need_new < self.n_active:
                if shared:
                    self.prefix_cache.release_shared(shared)
                break
            blocks = self._cache_alloc(need_new)
            self.waiting.popleft()
            row = free_rows[0]
            req.blocks = shared + blocks
            req.n_shared = len(shared)
            req.row = row
            if self.prefix_cache is not None:
                if cached_len:
                    self.prefix_cache.note_hit(cached_len)
                else:
                    self.prefix_cache.note_miss()
            req.admit_order = self._admit_counter
            self._admit_counter += 1
            self.stats["admissions"] += 1
            if not self.prefill_chunk_tokens:
                # Chunked mode counts prefill (and rework) where it is paid:
                # at chunk dispatch.
                self.stats["prefill_tokens"] += p - cached_len
                if req.preemptions > 0:
                    self.stats["preempted_tokens_recomputed"] = (
                        self.stats.get("preempted_tokens_recomputed", 0) + p - cached_len
                    )
            t = self.req_timing.get(req.rid)
            if t is not None:
                t.setdefault("admit_s", self._now())
                if self.prefix_cache is not None:
                    t["cached_tokens"] = t.get("cached_tokens", 0) + cached_len
            self.rows[row] = req
            self.tables[row, :] = 0
            self.tables[row, : len(req.blocks)] = req.blocks
            if self.prefill_chunk_tokens:
                # The committed frontier starts at the cached prefix; the
                # chunks stream the rest.
                req.prefill_pos = cached_len
                self.seq_lens[row] = cached_len
            else:
                self.seq_lens[row] = p
            admits.append(req)
        if not admits or self.prefill_chunk_tokens:
            return
        # Cache hits prefill only their uncached suffix; misses run the
        # monolithic prefill. Under int8-kv every admission takes the suffix
        # lane (cached length 0 for a miss): the monolithic lane's flash
        # prefill attends the unquantized local k/v while the suffix lane
        # attends dequantized pages, and the page bytes must be the same
        # function of the prompt in every configuration.
        miss = [r for r in admits if r.n_shared == 0]
        hits = [r for r in admits if r.n_shared > 0]
        if self.quantize == "int8-kv":
            miss, hits = [], miss + hits
        t0 = time.perf_counter()
        groups = []
        if miss:
            toks, self.pools = paged.prefill_into_pool_batched(
                self.params, self.cfg, self.pools, [r.prompt for r in miss],
                [r.blocks[: paged.required_blocks(len(r.prompt), self.block_size)] for r in miss],
                self._gen, temperature=self.temperature, top_k=self.top_k,
                top_p=self.top_p, min_p=self.min_p,
            )
            pad_pages = max(paged.required_blocks(len(r.prompt), self.block_size) for r in miss)
            self.prefill_shapes.append((len(miss), pad_pages * self.block_size))
            groups.append((miss, toks))
        if hits:
            bs = self.block_size
            suffixes = [r.prompt[r.n_shared * bs:] for r in hits]
            offsets = [r.n_shared * bs for r in hits]
            toks, self.pools = paged.prefill_suffix_into_pool_batched(
                self.params, self.cfg, self.pools, suffixes,
                self.tables[[r.row for r in hits]], offsets, self._gen,
                temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
                min_p=self.min_p,
            )
            self.suffix_shapes.append((offsets, [len(x) for x in suffixes], max(map(len, suffixes))))
            groups.append((hits, toks))
        host = [(group, toks.cpu().numpy()) for group, toks in groups]
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["tokens"] += len(admits)
        for group, toks in host:
            self._first_tokens(group, toks)

    def _dispatch_prefill_chunks(self) -> bool:
        """Stream mid-prefill rows' next prompt chunks in one multi-token
        paged forward (the suffix lane with the token axis pinned to the
        chunk size), FCFS by admission order under a budget of
        ``prefill_chunk_tokens`` tokens; rows past it wait. A chunk commits
        at dispatch (its content is prompt data). A row's final chunk
        samples its first token from the last prompt position, and the row
        joins the next decode window. True when a chunk forward ran."""
        if not self.prefill_chunk_tokens:
            return False
        pending = sorted(
            (r for r in self.rows if r is not None and r.prefill_pos is not None),
            key=lambda r: r.admit_order,
        )
        if not pending:
            return False
        budget = self.prefill_chunk_tokens
        group: List[_Request] = []
        chunks: List[List[int]] = []
        offsets: List[int] = []
        for req in pending:
            if budget <= 0:
                self.stats["chunk_deferrals"] = self.stats.get("chunk_deferrals", 0) + 1
                continue
            start = req.prefill_pos
            take = min(budget, len(req.prompt) - start)
            group.append(req)
            chunks.append(req.prompt[start:start + take])
            offsets.append(start)
            budget -= take
        t0 = time.perf_counter()
        toks, self.pools = paged.prefill_suffix_into_pool_batched(
            self.params, self.cfg, self.pools, chunks,
            self.tables[[r.row for r in group]], offsets, self._gen,
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
            min_p=self.min_p, t_bucket=self.prefill_chunk_tokens,
        )
        self.suffix_shapes.append((offsets, [len(c) for c in chunks], self.prefill_chunk_tokens))
        finals: List[Tuple[_Request, int]] = []
        for i, req in enumerate(group):
            take = len(chunks[i])
            end = offsets[i] + take
            req.prefill_pos = None if end == len(req.prompt) else end
            self.seq_lens[req.row] = end
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_chunk_tokens"] += take
            self.stats["prefill_tokens"] += take
            if req.preemptions > 0:
                self.stats["preempted_tokens_recomputed"] = (
                    self.stats.get("preempted_tokens_recomputed", 0) + take
                )
            if req.prefill_pos is None:
                finals.append((req, i))
        host = toks.cpu().numpy()  # waits for the chunk forward
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["tokens"] += len(finals)
        self._first_tokens([req for req, _ in finals], [host[i] for _, i in finals])
        return True

    def _ensure_write_pages(self, horizon: int = 1) -> None:
        """Every live row's next ``horizon`` write slots must have pages
        (a write to an unallocated page would fall through to the scratch
        block and lose that token's K/V); when the pool is dry, evict cold
        cached blocks, then preempt youngest first. Slots a row cannot
        reach before finishing, or past table capacity, need no pages:
        those writes are scratch-redirected and discarded."""
        capacity = self.max_blocks * self.block_size
        for row in range(self.max_batch):
            req = self.rows[row]
            if req is None:
                continue
            remaining = req.max_new - len(req.generated)
            last_write = min(
                int(self.seq_lens[row]) + min(horizon, remaining) - 1, capacity - 1
            )
            need_pages = last_write // self.block_size + 1
            while len(req.blocks) < need_pages:
                got = self.alloc.alloc(1)
                if got is not None:
                    req.blocks.extend(got)
                    self.tables[row, len(req.blocks) - 1] = got[0]
                    continue
                if self.prefix_cache is not None and self.prefix_cache.evict(1):
                    continue  # a cold cached block went back to the pool
                victim = max((r for r in self.rows if r is not None), key=lambda r: r.admit_order)
                self._preempt(victim)
                if victim is req or self.rows[row] is not req:
                    break  # this row is gone; nothing more to grow

    def _preempt(self, req: _Request) -> None:
        """Evict a running request: free its blocks and requeue it at the
        front with prompt + generated as its new prompt."""
        self.stats["preemptions"] += 1
        new_prompt = req.prompt + req.generated
        remaining = req.max_new - len(req.generated)
        self._release_row(req)
        self.waiting.appendleft(_Request(
            req.rid, new_prompt, remaining,
            prefix=req.prefix + req.generated, preemptions=req.preemptions + 1,
        ))

    def _finish(self, req: _Request) -> None:
        out = req.prefix + req.generated
        if self.stop_token is not None and out and out[-1] == self.stop_token:
            out = out[:-1]
        self.finished[req.rid] = out
        if self.logprobs_k:
            lps = self.logprobs.get(req.rid)
            if lps is not None and len(lps) > len(out):
                self.logprobs[req.rid] = lps[: len(out)]
        t = self.req_timing.get(req.rid)
        if t is not None:
            t["end_s"] = self._now()
        self._release_row(req)

    def _release_row(self, req: _Request) -> None:
        row = req.row
        if self.prefix_cache is not None:
            # Publish the row's committed full blocks (and deref its shared
            # ones). Only slots below p + g - 1 are surely written (the last
            # sampled token was never fed); a mid-prefill row has written
            # exactly its chunks below prefill_pos.
            g, p = len(req.generated), len(req.prompt)
            if req.prefill_pos is not None:
                publish_len = req.prefill_pos
            else:
                publish_len = p + g - 1 if g else p
            self.prefix_cache.release_row(
                req.prompt + req.generated, req.blocks, req.n_shared, publish_len
            )
        else:
            self.alloc.free(req.blocks)
        req.blocks = []
        req.n_shared = 0
        req.row = None
        self.rows[row] = None
        self.tables[row, :] = 0
        self.seq_lens[row] = 0
        self.tokens[row] = 0
