"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``pretraining_llm_tpu/generation/serving.py::ServingEngine``
with its synchronous scheduler. Each ``step()`` runs:

  admission   — every waiting request that fits claims a free batch row and
                pool blocks; all claimed prompts prefill in one batched
                forward, their pages land in the pools, and each samples its
                first token;
  growth      — every live row gets the pages its next window writes;
  preemption  — when the pool runs dry, the youngest running request is
                evicted and requeued with prompt + generated as its new
                prompt (recompute on resume), so the oldest requests always
                finish;
  decode      — a window of ``steps_per_sched`` lockstep decode steps,
                clamped to the live rows' remaining budget;
  reap        — tokens are appended, and finished rows free their blocks.

Idle rows keep decoding into the reserved scratch block with their outputs
ignored. Host state (tables, lengths, tokens) lives in numpy and is copied
to the device once per window.

Not ported yet, and refused with ``NotImplementedError``: the pipelined
scheduler (``pipeline_depth`` > 1, ``admit_batch``), the prefix cache,
chunked prefill, speculative decoding, quantized serving, sharded serving
(``mesh``), the unfused sampling lane and KV checksums. Greedy output is
identical at every pipeline depth in the JAX package, so the synchronous
scheduler serves the same tokens.
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
    row: Optional[int] = None
    admit_order: int = -1
    preemptions: int = 0


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
        if prefill_chunk_tokens:
            unported.append(f"prefill_chunk_tokens={prefill_chunk_tokens} (chunked prefill)")
        if prefix_cache:
            unported.append("prefix_cache")
        if kv_checksum:
            unported.append("kv_checksum")
        if quantize != "none":
            unported.append(f"quantize={quantize!r}")
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
        transformer.check_ported(cfg)
        if logprobs_k < 0:
            raise ValueError(f"logprobs_k must be >= 0, got {logprobs_k}")
        self.device = resolve_device(device)
        leaf = params["tok_embed"]["embedding"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params lie on {leaf.device}, the engine runs on {self.device}")
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
        self.pools = transformer.make_paged_kv_pool(cfg, n_blocks, block_size, device=self.device)
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
            "prefill_tokens": 0,
            # Host seconds from dispatch to the sampled tokens' arrival on
            # the host (which waits for the device): admission prefills and
            # decode windows.
            "prefill_s": 0.0, "decode_s": 0.0,
        }
        # (rows, padded length) of each admission's batched prefill forward.
        self.prefill_shapes: List[Tuple[int, int]] = []

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
        (submit -> finish). Only phases the request reached appear."""
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
        return out

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.rows)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.n_active > 0

    def step(self) -> None:
        """One scheduling round: admit -> grow/preempt -> a decode window
        -> reap. A no-op when nothing is running or waiting."""
        self._admit()
        if self.n_active:
            self._step_decode()

    def run(self) -> Dict[int, List[int]]:
        """Drive the engine until every submitted request has finished;
        returns {rid: output tokens}."""
        while self.has_work():
            self.step()
        return self.finished

    # -- scheduling internals ---------------------------------------------

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

    def _step_decode(self) -> None:
        n = self._window_len()
        self._ensure_write_pages(horizon=n)
        if self.n_active == 0:  # everyone got preempted (tiny pool)
            return
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
            if req is None:
                continue
            self._consume_tokens(
                req, row, window[row],
                lp=None if lp_host is None else (lp_host[0][row], lp_host[1][row]),
            )

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

    def _admit(self) -> None:
        """FCFS admission: every queue head that fits claims a free row,
        then all claimed prompts prefill in one batched forward."""
        admits: List[_Request] = []
        while self.waiting:
            free_rows = [i for i, r in enumerate(self.rows) if r is None]
            if not free_rows:
                break
            req: _Request = self.waiting[0]
            p = len(req.prompt)
            # +1: the first decode step writes slot p — its page must exist.
            need = paged.required_blocks(p + 1, self.block_size)
            # Admission watermark: keep one growth block of headroom per
            # running row, else a nearly dry pool admits a newcomer only
            # for it to be preempted at the next block boundary.
            if self.alloc.available - need < self.n_active:
                break
            blocks = self.alloc.alloc(need)
            self.waiting.popleft()
            row = free_rows[0]
            req.blocks = blocks
            req.row = row
            req.admit_order = self._admit_counter
            self._admit_counter += 1
            self.stats["admissions"] += 1
            self.stats["prefill_tokens"] += p
            if req.preemptions > 0:
                self.stats["preempted_tokens_recomputed"] = (
                    self.stats.get("preempted_tokens_recomputed", 0) + p
                )
            t = self.req_timing.get(req.rid)
            if t is not None:
                t.setdefault("admit_s", self._now())
            self.rows[row] = req
            self.tables[row, :] = 0
            self.tables[row, : len(req.blocks)] = req.blocks
            self.seq_lens[row] = p
            admits.append(req)
        if not admits:
            return
        t0 = time.perf_counter()
        toks_dev, self.pools = paged.prefill_into_pool_batched(
            self.params, self.cfg, self.pools, [r.prompt for r in admits],
            [r.blocks[: paged.required_blocks(len(r.prompt), self.block_size)] for r in admits],
            self._gen, temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, min_p=self.min_p,
        )
        toks = toks_dev.cpu().numpy()
        self.stats["prefill_s"] += time.perf_counter() - t0
        pad_pages = max(paged.required_blocks(len(r.prompt), self.block_size) for r in admits)
        self.prefill_shapes.append((len(admits), pad_pages * self.block_size))
        self.stats["tokens"] += len(admits)
        for i, req in enumerate(admits):
            tok = int(toks[i])
            self._check_token(req, tok)
            req.generated.append(tok)
            self._lp_append(req, None)  # prefill-sampled: no logprob sliver
            self._emit_token(req, tok)
            self.tokens[req.row] = tok
            if tok == self.stop_token or len(req.generated) >= req.max_new:
                self._finish(req)

    def _ensure_write_pages(self, horizon: int = 1) -> None:
        """Every live row's next ``horizon`` write slots must have pages
        (a write to an unallocated page would fall through to the scratch
        block and lose that token's K/V); when the pool is dry, preempt
        youngest first. Slots a row cannot reach before finishing, or past
        table capacity, need no pages: those writes are scratch-redirected
        and discarded."""
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
        self.alloc.free(req.blocks)
        req.blocks = []
        req.row = None
        self.rows[row] = None
        self.tables[row, :] = 0
        self.seq_lens[row] = 0
        self.tokens[row] = 0
