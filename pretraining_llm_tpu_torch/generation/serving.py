"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``pretraining_llm_tpu/generation/serving.py::ServingEngine``.
A scheduling round runs:

  admission   — every waiting request that fits claims a free batch row and
                pool blocks (with the prefix cache on, the longest cached
                block-aligned prefix of its prompt is mapped read-only into
                its table and only the rest is charged); all claimed
                prompts prefill in one batched forward (cache hits, and
                every admission under ``int8-kv``, through the suffix lane)
                and each samples its first token;
  chunks      — with ``prefill_chunk_tokens``, admission runs no prefill:
                mid-prefill rows stream their prompts in chunks, FCFS under
                a per-round token budget, and a row's final chunk samples
                its first token;
  growth      — every live row gets the pages its next window writes,
                evicting cold cached pages before preempting;
  preemption  — when the pool runs dry, the youngest running request is
                evicted and requeued with prompt + generated as its new
                prompt (recompute on resume), so the oldest requests always
                finish;
  decode      — a window of ``steps_per_sched`` lockstep decode steps,
                clamped to the live rows' remaining budget, or, with a
                draft model (``spec_k``), one speculative round;
  reap        — tokens are appended; finished rows publish their full
                committed pages to the prefix cache and free the rest.

Two schedulers drive these rounds. ``run(pipeline=True)`` (the default, as
in JAX) keeps a queue of up to ``pipeline_depth`` dispatched-but-unreaped
windows: window k+1's input tokens chain from window k's last column on
the device, host ``seq_lens`` advance at dispatch, and the host's reap,
admission and bookkeeping for older windows overlap the device's work on
the newer ones. Tables and lengths go up through pinned buffers without
waiting for the stream, first tokens stay on the device until the window
they joined is reaped, and tokens come back through a pinned copy and a
CUDA event recorded at dispatch; the reap waits on that event alone and
counts the wait as ``host_blocked_s``. A decision that needs exact state
(preemption, rolling back speculative page grants) flushes the queue and
replays from committed state; surplus tokens of rows that finished while
windows were in flight are dropped at reap. ``run(pipeline=False)`` and
``step()`` are the synchronous scheduler. Greedy streams are the same
under both, at every depth, with or without speculation.

Idle and mid-prefill rows keep decoding with their outputs ignored (their
writes land at or above their frontier, or on the reserved scratch block).

``quantize="int8"`` quantizes the block projections (``models/quantize.py``);
``"int8-kv"`` also turns the KV pools into int8 codes with bf16 scale pages.
``kv_checksum`` digests every page the prefix cache publishes and checks
it when a later admission acquires it (``resilience/integrity.py``).
``fused_sampling=False`` runs the unfused lane: each decode step's logits
come to the host and a separate call samples the token.

The JAX engine's three host spans are recorded, at its points, into the
default recorder of ``observability/spans.py`` (a trainer's or a
caller's ``SpanRecorder``): ``serving.dispatch_window`` around each decode
window's or speculative round's dispatch, ``serving.reap_window`` around
each reap (its ``host_blocked_s`` in the span's args) and
``serving.host_blocked`` around the reap's wait for the window's event.

Not ported: sharded serving (``mesh``) raises ``NotImplementedError``. MoE
models raise the JAX engine's ``ValueError`` (it serves none). Per-request
traces, the capacity sampler, the decision log and the window histograms
(installed by the JAX frontend), ``cancel``, ``health_gauges`` and
migration blocks belong to the fleet subsystem.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.generation import paged, speculative
from pretraining_llm_tpu_torch.generation.prefix_cache import PrefixCache
from pretraining_llm_tpu_torch.models import quantize as quantize_mod
from pretraining_llm_tpu_torch.models import transformer
from pretraining_llm_tpu_torch.observability import spans as _spans
from pretraining_llm_tpu_torch.resilience import integrity
from pretraining_llm_tpu_torch.resilience.integrity import IntegrityError
from pretraining_llm_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["IntegrityError", "ServingEngine"]


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
    # Pipelined admission: the first sampled token, still on its way from
    # the device, as (readback, index), until the window the row joined is
    # reaped (``_resolve_first``).
    pending_first: Optional[tuple] = None
    # Chunked prefill: the next prompt index to prefill, or None once the
    # whole prompt is resident. While set, the row joins no decode window
    # or spec round: its committed frontier is mid-prompt.
    prefill_pos: Optional[int] = None

    @property
    def n_generated(self) -> int:
        """Generated count including a first token not read back yet: the
        count the scheduling math (budgets, page horizons) uses."""
        return len(self.generated) + (1 if self.pending_first is not None else 0)


class _Readback:
    """Device tensors on their way to the host. On CUDA each is copied into
    pinned memory without waiting, and one event is recorded after the
    copies; ``wait`` waits for that event alone, not for work queued
    later. On the CPU the tensors are already there."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in tensors]
            for h, x in zip(self.host, tensors):
                h.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(tensors)

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


@dataclasses.dataclass
class _Window:
    """One dispatched-but-unreaped unit of device work. ``snapshot`` pins
    the (row, request) pairs it was dispatched against: at reap, rows whose
    request has changed since (finished in an earlier reap, maybe
    re-admitted) are surplus and their tokens are dropped."""

    kind: str  # "decode" | "spec"
    snapshot: List[tuple]  # [(row, _Request)] at dispatch
    readback: _Readback  # decode: toks (+ logprob values, ids); spec: emit, n_emit
    toks: Any = None  # decode: (B, n) device tokens (the next window chains on them)
    emit: Any = None  # spec: (B, k+1) device emissions
    n_emit: Any = None  # spec: (B,) device emit counts
    seq_dev: Any = None  # spec: (B,) device frontier at dispatch


class ServingEngine:
    """Continuous-batching text generation over a shared paged KV pool.

    Usage::

        eng = ServingEngine(params, cfg, max_batch=4, n_blocks=128)
        rid = eng.submit(prompt_ids, max_new_tokens=64)
        outputs = eng.run()        # {rid: [token, ...]}

    ``params`` (and ``draft_params``) must lie on ``device`` (default
    ``cuda``). ``temperature=0`` (default) decodes greedily; sampling draws
    from a ``torch.Generator`` seeded with ``seed``. The arguments, their
    defaults and the ``ValueError``s are the JAX engine's.
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
        pipeline_depth: int = 2,
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
        if mesh is not None:
            raise NotImplementedError("ServingEngine(mesh=...) (sharded serving) is not ported to PyTorch yet")
        if cfg.n_experts:
            # The JAX engine's rule: pad slots inside a prefill bucket would
            # compete for expert capacity.
            raise ValueError("paged serving does not support MoE models yet")
        if cfg.doc_mask_token >= 0:
            # A decode session is one document; forward() refuses document
            # masking with a cache (the JAX engine sanitizes it the same way).
            cfg = dataclasses.replace(cfg, doc_mask_token=-1)
        transformer.check_ported(cfg)
        # Speculative serving: a draft model proposes spec_k tokens a
        # round, the target verifies them in one multi-token paged forward
        # (paged.paged_spec_round).
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if (spec_k > 0) != (draft_params is not None and draft_cfg is not None):
            raise ValueError(
                "speculative serving needs all three of draft_params, "
                "draft_cfg and spec_k >= 1 (or none of them)"
            )
        self.fused_sampling = bool(fused_sampling)
        if logprobs_k < 0:
            raise ValueError(f"logprobs_k must be >= 0, got {logprobs_k}")
        if logprobs_k and not fused_sampling:
            raise ValueError(
                "logprobs_k requires fused_sampling (the logprob sliver "
                "rides the fused decode payload)"
            )
        if spec_k and (not fused_sampling or logprobs_k):
            raise ValueError(
                "speculative serving supports only the fused decode path "
                "without logprobs (spec rounds never materialize "
                "per-token logits host-side)"
            )
        self.logprobs_k = int(logprobs_k)
        # Per-request top-k logprobs, one entry per output token: (values,
        # ids) lists, or None for tokens sampled by a prefill.
        self.logprobs: Dict[int, List[Optional[tuple]]] = {}
        self.spec_k = int(spec_k)
        self.draft_params = draft_params
        self.draft_cfg: Optional[ModelConfig] = None
        if spec_k:
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab ({draft_cfg.vocab_size}) must equal "
                    f"target vocab ({cfg.vocab_size})"
                )
            if draft_cfg.n_experts:
                raise ValueError("draft model cannot be MoE (same rule)")
            if top_k or top_p or min_p:
                raise ValueError(
                    "speculative serving supports temperature-only "
                    "sampling (the accept/reject rule needs the raw "
                    "draft/target distributions)"
                )
            if draft_cfg.doc_mask_token >= 0:
                draft_cfg = dataclasses.replace(draft_cfg, doc_mask_token=-1)
            transformer.check_ported(draft_cfg)
            self.draft_cfg = draft_cfg
        if quantize not in ("none", "int8", "int8-kv"):
            raise ValueError(f"quantize must be 'none', 'int8' or 'int8-kv', got {quantize!r}")
        self.device = resolve_device(device)
        for name, tree in (("params", params), ("draft_params", self.draft_params)):
            if tree is None:
                continue
            leaf = tree["tok_embed"]["embedding"]
            if leaf.device.type != self.device.type:
                raise ValueError(f"{name} lie on {leaf.device}, the engine runs on {self.device}")
        self.quantize = quantize
        if quantize != "none":
            if quantize == "int8-kv" and cfg.kv_cache_dtype != "int8":
                cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
                if self.draft_cfg is not None and self.draft_cfg.kv_cache_dtype != "int8":
                    self.draft_cfg = dataclasses.replace(self.draft_cfg, kv_cache_dtype="int8")
            # Pre-quantized trees pass through; float trees are quantized here.
            if not quantize_mod.is_quantized(params):
                params = quantize_mod.quantize_params_for_serving(params, cfg)
            if self.spec_k and not quantize_mod.is_quantized(self.draft_params):
                self.draft_params = quantize_mod.quantize_params_for_serving(
                    self.draft_params, self.draft_cfg
                )
        self.params = params
        self.cfg = cfg
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
        # Pipelined scheduler: windows kept in flight before the oldest is
        # reaped (1 = double buffering).
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.pipeline_depth = int(pipeline_depth)
        # Cross-window admission batching (pipelined only): while rows run,
        # wait until this many admissions can share one prefill.
        if admit_batch < 0:
            raise ValueError(f"admit_batch must be >= 0, got {admit_batch}")
        self.admit_batch = int(admit_batch)
        # Chunked prefill: prompts stream in chunks of at most this many
        # tokens between decode windows (0 = monolithic admission prefill).
        if prefill_chunk_tokens < 0:
            raise ValueError(f"prefill_chunk_tokens must be >= 0, got {prefill_chunk_tokens}")
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.kv_checksum = bool(kv_checksum)

        def build_pool(pool_cfg: ModelConfig) -> transformer.KVCache:
            # bf16 scale pages for int8-kv; fp32 for an int8 pool set directly.
            return transformer.make_paged_kv_pool(
                pool_cfg, n_blocks, block_size, device=self.device,
                scale_dtype=torch.bfloat16 if quantize == "int8-kv" else None,
            )

        self.pools = build_pool(cfg)
        # The draft pool has the target's block structure: the same table
        # and ids, the draft's dims per block.
        self.d_pools = build_pool(self.draft_cfg) if self.spec_k else None
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
        # Pipelined state: the in-flight windows (oldest first) and the
        # admission first tokens to merge into the next dispatch's inputs.
        self._inflight: deque = deque()
        self._pending_admit_merges: List[tuple] = []
        self.stats = {
            "steps": 0, "tokens": 0, "preemptions": 0, "admissions": 0,
            # Pipelined scheduler: windows dispatched and reaped, host
            # seconds blocked on a window's readback, queue flushes.
            "windows": 0, "windows_reaped": 0, "host_blocked_s": 0.0, "flushes": 0,
            # Prompt tokens actually prefilled (suffix only for cache hits).
            "prefill_tokens": 0,
            # Chunked prefill: chunk forwards, chunk tokens, and rounds
            # whose chunk forward shared the round with a decode window
            # (interleaved) or ran alone (dedicated).
            "prefill_chunks": 0, "prefill_chunk_tokens": 0,
            "chunk_windows_interleaved": 0, "chunk_windows_dedicated": 0,
            # Unfused lane: bytes of (B, V) logits brought to the host.
            "logits_bytes_host": 0,
            # Host seconds of admission prefills and chunk forwards (the
            # synchronous scheduler: dispatch to first tokens on the host;
            # the pipelined one: dispatch only), and of synchronous decode
            # windows, dispatch to tokens on the host.
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
        summed over every pool tensor (scale pages included); the draft
        pool's bytes apart."""

        def nbytes(pools: transformer.KVCache) -> int:
            return sum(x.numel() * x.element_size() for lyr in pools["layers"] for x in lyr.values())

        layer0 = self.pools["layers"][0]
        total = nbytes(self.pools)
        scale = layer0.get("k_scale_pool")
        info = {
            "quantize": self.quantize,
            "kv_dtype": str(layer0["k_pool"].dtype).replace("torch.", ""),
            "kv_scale_dtype": None if scale is None else str(scale.dtype).replace("torch.", ""),
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "bytes_per_block": total // self.n_blocks,
            "pool_bytes": total,
        }
        if self.d_pools is not None:
            info["draft_pool_bytes"] = nbytes(self.d_pools)
        return info

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.rows)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.n_active > 0

    def step(self) -> None:
        """One round of the synchronous scheduler: admit -> prefill chunks
        (chunked mode) -> grow/preempt -> a decode window (or one spec
        round) -> reap. A no-op when nothing is running or waiting.
        Forwards run under ``torch.inference_mode()``: params fresh from
        training (leaves that require grad) record no graph."""
        with torch.inference_mode():
            self._admit()
            chunked = self._dispatch_prefill_chunks(defer=False)
            decoded = self._step_decode() if self._n_decode_rows() else False
        if chunked:
            self._note_chunk_window(decoded)

    def run(self, *, pipeline: bool = True) -> Dict[int, List[int]]:
        """Drive the engine until every submitted request has finished;
        returns {rid: output tokens}. ``pipeline=True`` (default) runs the
        pipelined scheduler (``pipeline_tick`` in a loop), ``False`` the
        synchronous one. Greedy outputs are identical either way, at every
        ``pipeline_depth``; sampled streams differ (the generator is drawn
        in dispatch order, and deeper queues dispatch surplus windows)."""
        if not pipeline:
            while self.has_work():
                self.step()
            return self.finished
        if self._inflight:
            raise RuntimeError("run() re-entered with windows in flight")
        while self.has_work() or self._inflight:
            self.pipeline_tick()
        return self.finished

    def pipeline_tick(self) -> bool:
        """One turn of the pipelined scheduler: admit waiting requests,
        stream prefill chunks, dispatch at most one window (or spec round),
        reap windows beyond the queue depth. Returns True while device work
        remains dispatched or runnable."""
        depth = self.pipeline_depth
        with torch.inference_mode():
            self._admit(defer=True)
            # Chunks go before the decode dispatch: their writes are
            # committed prompt data, earlier in stream order than this
            # round's window.
            chunked = self._dispatch_prefill_chunks(defer=True)
            decoded = False
            if self._n_decode_rows():
                if self.spec_k:
                    # Each queued round and the new one may advance the
                    # device frontier by k+1 past the committed seq_lens:
                    # ensure the whole horizon before dispatch.
                    k = self.spec_k
                    self._ensure_write_pages(horizon=(k + 1) * (len(self._inflight) + 1))
                    if self._n_decode_rows():
                        self._dispatch_spec_round()
                        decoded = True
                else:
                    # One window length for the page horizon and the
                    # dispatch; prealloc grows rows toward the whole
                    # in-flight horizon from the free list.
                    n = self._window_len()
                    self._ensure_write_pages(horizon=n, prealloc=n * (depth - 1))
                    if self._n_decode_rows():
                        self._dispatch_window(n)
                        decoded = True
            if chunked:
                self._note_chunk_window(decoded)
            # Reap the oldest window once the queue exceeds its depth, and
            # drain when nothing is running.
            while len(self._inflight) > depth or (self._inflight and not self.n_active):
                self._reap_window(self._inflight.popleft())
        return bool(self._inflight) or self.has_work()

    # -- decode -------------------------------------------------------------

    def _n_decode_rows(self) -> int:
        """Rows past their prefill phase (mid-chunk rows do not decode)."""
        return sum(1 for r in self.rows if r is not None and r.prefill_pos is None)

    def _window_len(self) -> int:
        """``steps_per_sched`` clamped by the live rows' remaining budget,
        rounded up to a power of two (the JAX package's window-program
        buckets, kept so the two engines run the same windows). Pipelined
        mode sees ``n_generated`` up to the queue's lag behind: the clamp
        then overestimates the budget, never cuts a live row short."""
        n = self.steps_per_sched
        if n <= 1:
            return 1
        rem = max(
            (req.max_new - req.n_generated for req in self.rows if req is not None),
            default=n,
        )
        if rem >= n:
            return n
        b = 1
        while b < max(1, rem):
            b <<= 1
        return min(b, n)

    def _note_chunk_window(self, decoded: bool) -> None:
        key = "chunk_windows_interleaved" if decoded else "chunk_windows_dedicated"
        self.stats[key] += 1

    def _decode_window(self, base: torch.Tensor, tables_dev: torch.Tensor, seq_dev: torch.Tensor,
                       n: int) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """The decode window's device work for both schedulers: (B, n)
        device tokens and the optional ((B, n, k) values, ids) logprob
        sliver. Fused (default): sampling runs with the forward, only token
        ids come back. Unfused: each step's (B, V) logits come to the host
        (counted in ``logits_bytes_host``) and a separate ``sample_tokens``
        call picks the token; greedy tokens are the same."""
        if not self.fused_sampling:
            tok, seq, cols = base, seq_dev, []
            for _ in range(n):
                logits, self.pools = paged.paged_decode_logits(
                    self.params, self.pools, tok, tables_dev, seq, self.cfg
                )
                host = logits.cpu()  # the round trip fused sampling saves
                self.stats["logits_bytes_host"] += host.numel() * host.element_size()
                tok = paged.sample_tokens(
                    host.to(self.device), self._gen, temperature=self.temperature,
                    top_k=self.top_k, top_p=self.top_p, min_p=self.min_p,
                )
                cols.append(tok)
                seq = seq + 1
            return torch.stack(cols, 1), None
        toks, lp, self.pools = paged.paged_decode_steps(
            self.params, self.pools, base, tables_dev, seq_dev, self._gen, self.cfg, n,
            self.temperature, self.top_k, self.top_p, self.min_p, logprobs_k=self.logprobs_k,
        )
        return toks, lp

    def _step_decode(self) -> bool:
        """The decode arm of step(); True when a window (or spec round)
        ran."""
        if self.spec_k:
            return self._spec_step()
        n = self._window_len()
        self._ensure_write_pages(horizon=n)
        if self._n_decode_rows() == 0:  # everyone got preempted (tiny pool)
            return False
        paged.check_paged_bounds(self.tables, self.seq_lens, self.block_size)
        dev = self.device
        t0 = time.perf_counter()
        toks, lp = self._decode_window(
            paged.to_device(self.tokens, dev), paged.to_device(self.tables, dev),
            paged.to_device(self.seq_lens, dev), n,
        )
        window = toks.cpu().numpy()  # (B, n)
        lp_host = None if lp is None else (lp[0].cpu().numpy(), lp[1].cpu().numpy())
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["steps"] += n
        for row, req in enumerate(self.rows):
            if req is None or req.prefill_pos is not None:
                continue
            self._consume_tokens(
                req, row, window[row], advance_seq=True,
                lp=None if lp_host is None else (lp_host[0][row], lp_host[1][row]),
            )
        return True

    def _spec_step(self) -> bool:
        """One synchronous speculative round for every decoding row. It
        writes slots [seq, seq + k] in both pools, so the page horizon is
        k + 1; rejected slots hold garbage above each row's new frontier,
        overwritten by the next round."""
        k = self.spec_k
        self._ensure_write_pages(horizon=k + 1)
        if self._n_decode_rows() == 0:  # everyone got preempted (tiny pool)
            return False
        paged.check_paged_bounds(self.tables, self.seq_lens, self.block_size)
        dev = self.device
        t0 = time.perf_counter()
        emit, n_emit, self.pools, self.d_pools = paged.paged_spec_round(
            self.params, self.pools, self.d_pools, self.draft_params,
            paged.to_device(self.tokens, dev), paged.to_device(self.tables, dev),
            paged.to_device(self.seq_lens, dev), self._gen, self.cfg, self.draft_cfg, k,
            self.temperature,
        )
        emit, n_emit = emit.cpu().numpy(), n_emit.cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        self.stats["spec_rounds"] = self.stats.get("spec_rounds", 0) + 1
        self.stats["spec_proposed"] = self.stats.get("spec_proposed", 0) + k * self._n_decode_rows()
        for row, req in enumerate(self.rows):
            if req is None or req.prefill_pos is not None:
                continue
            ne = int(n_emit[row])
            self.stats["spec_accepted"] = self.stats.get("spec_accepted", 0) + ne - 1
            self._consume_tokens(req, row, emit[row, :ne], advance_seq=True)
        return True

    def _decode_snapshot(self) -> Tuple[List[int], np.ndarray]:
        """The rows a dispatch decodes (past their prefill phase) and the
        committed frontier clamped to capacity - 1: a finished-but-unreaped
        row may have written its whole allocation, and its garbage writes
        must stay in its own last block until it is reaped."""
        capacity = self.max_blocks * self.block_size
        active = [i for i, r in enumerate(self.rows) if r is not None and r.prefill_pos is None]
        seq = np.minimum(self.seq_lens, capacity - 1)
        paged.check_paged_bounds(self.tables[active], seq[active], self.block_size)
        return active, seq

    def _dispatch_window(self, n: int) -> None:
        """Enqueue one decode window without waiting for the queued ones:
        input tokens come from the youngest in-flight window's last column
        (on the device) merged with admission first tokens (also on the
        device); host seq_lens advance by the window length at dispatch
        (every decoding row writes that many slots, finished or not). ``n``
        is the length the caller ensured pages for."""
        capacity = self.max_blocks * self.block_size
        active, seq_dispatch = self._decode_snapshot()
        dev = self.device
        with _spans.span("serving.dispatch_window", steps=n):
            if self._inflight:
                base = self._inflight[-1].toks[:, -1]
            else:
                base = paged.to_device(self.tokens, dev)
            base = self._merge_admitted(base)
            toks, lp = self._decode_window(
                base, paged.to_device(self.tables, dev), paged.to_device(seq_dispatch, dev), n,
            )
            readback = _Readback(toks) if lp is None else _Readback(toks, lp[0], lp[1])
        self.stats["steps"] += n
        self.stats["windows"] += 1
        snapshot = [(i, self.rows[i]) for i in active]
        for i in active:
            self.seq_lens[i] = min(int(self.seq_lens[i]) + n, capacity)
        self._inflight.append(_Window(kind="decode", snapshot=snapshot, readback=readback, toks=toks))

    def _dispatch_spec_round(self) -> None:
        """Enqueue one speculative round against the device frontier: seed
        tokens and seq_lens chain from the youngest queued round
        (``speculative.spec_next_inputs``, no host read); rows admitted
        since are spliced in from committed host state. With an empty queue
        both come from committed host state (the replay path)."""
        k = self.spec_k
        # The bounds check runs on committed state (a lower bound of the
        # device frontier); in-flight advances stay inside the ensured
        # horizon by construction.
        active, _ = self._decode_snapshot()
        dev = self.device
        with _spans.span("serving.dispatch_window", steps=k + 1):
            if self._inflight:
                prev = self._inflight[-1]
                base, seq_dev = speculative.spec_next_inputs(prev.emit, prev.n_emit, prev.seq_dev)
            else:
                base = paged.to_device(self.tokens, dev)
                seq_dev = paged.to_device(self.seq_lens, dev)
            base, seq_dev = self._merge_admitted(base, seq_dev)
            emit, n_emit, self.pools, self.d_pools = paged.paged_spec_round(
                self.params, self.pools, self.d_pools, self.draft_params, base,
                paged.to_device(self.tables, dev), seq_dev, self._gen, self.cfg, self.draft_cfg, k,
                self.temperature,
            )
        self.stats["steps"] += 1
        self.stats["windows"] += 1
        self.stats["spec_rounds"] = self.stats.get("spec_rounds", 0) + 1
        snapshot = [(i, self.rows[i]) for i in active]
        self._inflight.append(_Window(
            kind="spec", snapshot=snapshot, readback=_Readback(emit, n_emit), emit=emit, n_emit=n_emit,
            seq_dev=seq_dev,
        ))

    def _merge_admitted(self, base: torch.Tensor, seq_dev: Optional[torch.Tensor] = None):
        """Splice rows admitted since the last dispatch into the chained
        device inputs: their prefill-sampled first token and (spec mode)
        their committed frontier. A released row's chained values are
        garbage by design (its zero table sends its writes to scratch), but
        a re-admitted row restarts from committed host state."""
        dev = self.device
        for toks_dev, idxs, rows in self._pending_admit_merges:
            r = paged.to_device(np.asarray(rows, np.int64), dev)
            picked = toks_dev[paged.to_device(np.asarray(idxs, np.int64), dev)]
            base = base.index_put((r,), picked.to(base.dtype))
            if seq_dev is not None:
                seq_dev = seq_dev.index_put(
                    (r,), paged.to_device(self.seq_lens[np.asarray(rows)], dev).to(seq_dev.dtype)
                )
        self._pending_admit_merges = []
        return base if seq_dev is None else (base, seq_dev)

    def _reap_window(self, w: _Window) -> None:
        """Bring a window's tokens to the host and do the lagged
        bookkeeping: resolve deferred first tokens, extend outputs, finish
        rows on stop/max_new (their surplus tokens are dropped, as in the
        synchronous path). The wait for the window's event is the host's
        blocked time, counted in ``host_blocked_s``."""
        with _spans.span("serving.reap_window", window=self.stats["windows_reaped"]) as meta:
            t0 = time.perf_counter()
            with _spans.span("serving.host_blocked"):
                host = w.readback.wait()
            blocked = time.perf_counter() - t0
            meta["host_blocked_s"] = round(blocked, 6)
            self.stats["host_blocked_s"] += blocked
            self.stats["windows_reaped"] += 1
            self._commit_window(w, host)

    def _commit_window(self, w: _Window, host: List[np.ndarray]) -> None:
        """The reap's bookkeeping on a window's host tokens."""
        capacity = self.max_blocks * self.block_size
        lp_host = (host[1], host[2]) if w.kind == "decode" and len(host) == 3 else None
        for row, req in w.snapshot:
            if req.row != row or self.rows[row] is not req:
                # Finished in an earlier reap (maybe re-admitted since):
                # this window's tokens for it are surplus. (Preemption
                # cannot land here: it flushes the queue first.)
                continue
            self._resolve_first(req)
            if req.row is None:  # the first token alone finished it
                continue
            if w.kind == "spec":
                # Commit the round's advance. Proposals and acceptances are
                # counted here, so surplus rounds skew neither.
                ne = int(host[1][row])
                self.seq_lens[row] = min(int(self.seq_lens[row]) + ne, capacity)
                self.stats["spec_proposed"] = self.stats.get("spec_proposed", 0) + self.spec_k
                self.stats["spec_accepted"] = self.stats.get("spec_accepted", 0) + ne - 1
                self._consume_tokens(req, row, host[0][row, :ne], advance_seq=False)
            else:
                self._consume_tokens(
                    req, row, host[0][row], advance_seq=False,
                    lp=None if lp_host is None else (lp_host[0][row], lp_host[1][row]),
                )

    def _flush_inflight(self) -> None:
        """Drain every in-flight window, oldest first, so host state is
        committed: required before preemption and before rolling back
        speculative page grants. The next dispatch finds an empty queue
        and restarts the device chain from host tokens and seq_lens."""
        if self._inflight:
            self.stats["flushes"] += 1
        while self._inflight:
            self._reap_window(self._inflight.popleft())

    def _consume_tokens(self, req: _Request, row: int, toks, advance_seq: bool, lp=None) -> None:
        """Append a row's tokens, finish on stop/max_new and drop the
        surplus. ``advance_seq``: the synchronous paths advance the
        frontier here; the pipelined path advanced it at dispatch (decode)
        or at reap (spec). ``lp``: the row's ((n, k) values, ids) slice."""
        for i, tok in enumerate(int(t) for t in toks):
            if advance_seq:
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
        err = IntegrityError(
            f"invalid token id {tok} for rid {req.rid} (vocab size "
            f"{self.cfg.vocab_size}): refusing to stream corrupted output"
        )
        err.rid = req.rid
        err.token = int(tok)
        raise err

    def _commit_first(self, req: _Request, tok: int) -> None:
        """Commit a prefill-sampled first token."""
        self._check_token(req, tok)
        req.generated.append(tok)
        self._lp_append(req, None)  # prefill-sampled: no logprob sliver
        self._emit_token(req, tok)
        if req.row is not None:
            self.tokens[req.row] = tok
            if tok == self.stop_token or len(req.generated) >= req.max_new:
                self._finish(req)

    def _resolve_first(self, req: _Request) -> None:
        """Commit a deferred admission token (its readback was recorded at
        admission, before any window that needs it)."""
        if req.pending_first is None:
            return
        readback, i = req.pending_first
        req.pending_first = None
        self._commit_first(req, int(readback.wait()[0][i]))

    def _verify_shared(self, req: _Request, cached_len: int, shared: List[int]) -> Tuple[int, List[int]]:
        """Verify-on-acquire (``kv_checksum``): re-digest every shared block
        against the digest recorded at publish. At the first mismatch keep
        only the verified prefix of the hit, release the rest and drop the
        corrupt block from the cache: this admission (and every later one)
        prefills those tokens privately."""
        for j, b in enumerate(shared):
            expected = self.prefix_cache.checksum_of(b)
            if expected is None or integrity.kv_block_digest(self.pools, b) == expected:
                continue
            self.prefix_cache.release_shared(shared[j:])
            self.prefix_cache.drop_block(b)
            self.stats["kv_mismatches"] = self.stats.get("kv_mismatches", 0) + 1
            keep = shared[:j]
            if len(keep) < self.prefix_cache.min_blocks:
                if keep:
                    self.prefix_cache.release_shared(keep)
                return 0, []
            return min(cached_len, len(keep) * self.block_size), keep
        return cached_len, shared

    # -- admission ----------------------------------------------------------

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

    def _admission_capacity(self) -> int:
        """How many queue heads the free-row and watermark rules would
        admit now, without committing anything (the ``admit_batch``
        lookahead; each head is charged its full block need)."""
        free_rows = sum(r is None for r in self.rows)
        avail = self._cache_available()
        active = self.n_active
        count = 0
        for req in self.waiting:
            if count >= free_rows:
                break
            need = paged.required_blocks(len(req.prompt) + 1, self.block_size)
            if avail - need < active:
                break
            avail -= need
            active += 1
            count += 1
        return count

    def _admit(self, defer: bool = False) -> None:
        """FCFS admission: every queue head that fits claims a free row,
        then all claimed prompts prefill in one batched forward per lane
        (none in chunked mode: the chunks stream them).

        ``defer=True`` (pipelined) keeps the sampled first tokens on the
        device: bookkeeping that needs their values waits for the reap of
        the window they join, while the scheduling math counts them
        (``n_generated``). ``admit_batch`` > 1 (pipelined only): while rows
        run, waiting requests accumulate until that many can share one
        batched prefill."""
        if defer and self.admit_batch > 1 and self.waiting and self.n_active:
            goal = min(self.admit_batch, len(self.waiting), self.max_batch)
            if self._admission_capacity() < goal:
                self.stats["admit_deferrals"] = self.stats.get("admit_deferrals", 0) + 1
                return
            self.stats["admit_batches"] = self.stats.get("admit_batches", 0) + 1
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
                if self.kv_checksum and shared:
                    cached_len, shared = self._verify_shared(req, cached_len, shared)
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
        sample_kw = dict(temperature=self.temperature, top_k=self.top_k, top_p=self.top_p, min_p=self.min_p)
        groups = []
        if miss:
            prompts = [r.prompt for r in miss]
            prefill_ids = [r.blocks[: paged.required_blocks(len(r.prompt), self.block_size)] for r in miss]
            toks, self.pools = paged.prefill_into_pool_batched(
                self.params, self.cfg, self.pools, prompts, prefill_ids, self._gen, **sample_kw,
            )
            if self.spec_k:
                # The draft pool covers the same pages; its sampled tokens
                # are dropped (the target's first token seeds the round).
                _, self.d_pools = paged.prefill_into_pool_batched(
                    self.draft_params, self.draft_cfg, self.d_pools, prompts, prefill_ids, self._gen,
                    temperature=self.temperature,
                )
            pad_pages = max(len(ids) for ids in prefill_ids)
            self.prefill_shapes.append((len(miss), pad_pages * self.block_size))
            groups.append((miss, toks))
        if hits:
            bs = self.block_size
            suffixes = [r.prompt[r.n_shared * bs:] for r in hits]
            offsets = [r.n_shared * bs for r in hits]
            tables_rows = self.tables[[r.row for r in hits]]
            toks, self.pools = paged.prefill_suffix_into_pool_batched(
                self.params, self.cfg, self.pools, suffixes, tables_rows, offsets, self._gen, **sample_kw,
            )
            if self.spec_k:
                # Shared block ids index both pools, so the draft's prefix
                # K/V is resident too: suffix only there as well.
                _, self.d_pools = paged.prefill_suffix_into_pool_batched(
                    self.draft_params, self.draft_cfg, self.d_pools, suffixes, tables_rows, offsets,
                    self._gen, temperature=self.temperature,
                )
            self.suffix_shapes.append((offsets, [len(x) for x in suffixes], max(map(len, suffixes))))
            groups.append((hits, toks))
        self.stats["tokens"] += len(admits)  # the prefill-sampled firsts
        if defer:
            for group, toks in groups:
                readback = _Readback(toks)
                for i, req in enumerate(group):
                    req.pending_first = (readback, i)
                # The next dispatch merges these device tokens into its
                # inputs without a host round trip.
                self._pending_admit_merges.append((toks, list(range(len(group))), [r.row for r in group]))
            self.stats["prefill_s"] += time.perf_counter() - t0
            return
        host = [(group, toks.cpu().numpy()) for group, toks in groups]
        self.stats["prefill_s"] += time.perf_counter() - t0
        for group, toks in host:
            for req, tok in zip(group, toks):
                self._commit_first(req, int(tok))

    def _dispatch_prefill_chunks(self, defer: bool) -> bool:
        """Stream mid-prefill rows' next prompt chunks in one multi-token
        paged forward (the suffix lane with the token axis pinned to the
        chunk size), FCFS by admission order under a budget of
        ``prefill_chunk_tokens`` tokens; rows past it wait. A chunk commits
        at dispatch (its content is prompt data). A row's final chunk
        samples its first token from the last prompt position, and the row
        joins the next decode window. In pipelined spec mode every chunked
        row also queues a merge entry, so the next round's chained frontier
        is reset to the committed one. True when a chunk forward ran."""
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
        tables_rows = self.tables[[r.row for r in group]]
        toks, self.pools = paged.prefill_suffix_into_pool_batched(
            self.params, self.cfg, self.pools, chunks, tables_rows, offsets, self._gen,
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
            min_p=self.min_p, t_bucket=self.prefill_chunk_tokens,
        )
        if self.spec_k:
            # The draft pool holds the same chunk K/V (shared block ids);
            # its sampled tokens are dropped.
            _, self.d_pools = paged.prefill_suffix_into_pool_batched(
                self.draft_params, self.draft_cfg, self.d_pools, chunks, tables_rows, offsets,
                self._gen, temperature=self.temperature, t_bucket=self.prefill_chunk_tokens,
            )
        self.suffix_shapes.append((offsets, [len(c) for c in chunks], self.prefill_chunk_tokens))
        finals: List[int] = []
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
                finals.append(i)
        self.stats["tokens"] += len(finals)  # prefill-sampled firsts
        if defer:
            if finals:
                readback = _Readback(toks)
                for i in finals:
                    group[i].pending_first = (readback, i)
            if self.spec_k:
                # Every chunked row merges: finals bring their first token,
                # the others only pin the chained frontier to the committed
                # one (their token is never consumed).
                self._pending_admit_merges.append((toks, list(range(len(group))), [r.row for r in group]))
            elif finals:
                self._pending_admit_merges.append((toks, finals, [group[i].row for i in finals]))
            self.stats["prefill_s"] += time.perf_counter() - t0
            return True
        host = toks.cpu().numpy()  # waits for the chunk forward
        self.stats["prefill_s"] += time.perf_counter() - t0
        for i in finals:
            self._commit_first(group[i], int(host[i]))
        return True

    # -- pages ----------------------------------------------------------------

    def _row_need_pages(self, row: int, req: _Request, horizon: int) -> int:
        """Pages covering the row's next ``horizon`` write slots (slots it
        cannot reach before finishing, or past the table, need none: those
        writes go to scratch and are dropped). ``n_generated`` may lag the
        device by the queue, which only overestimates the need. A row still
        streaming its prompt also keeps the pages its admission granted for
        the rest of the prompt: its next chunks write there before any
        growth round runs. (The JAX engine counts only the decode horizon,
        so its page reclaim can free pages a later chunk writes, whose K/V
        then goes to the scratch block.)"""
        capacity = self.max_blocks * self.block_size
        remaining = req.max_new - req.n_generated
        last_write = min(int(self.seq_lens[row]) + min(horizon, remaining) - 1, capacity - 1)
        need = last_write // self.block_size + 1
        if req.prefill_pos is not None:
            need = max(need, paged.required_blocks(len(req.prompt) + 1, self.block_size))
        return need

    def _ensure_write_pages(self, horizon: int = 1, prealloc: int = 0) -> None:
        """Every live row's next ``horizon`` write slots must have pages (a
        write to an unallocated page would fall through to the scratch
        block and lose that token's K/V). When the pool is dry: drain the
        in-flight queue, then roll back rows' speculative page grants,
        then evict cold cached blocks, and only then preempt, youngest
        first. ``prealloc`` grows rows a further N slots from the free list
        only (never a flush or a preemption), keeping one headroom block
        per active row."""
        for row in range(self.max_batch):
            req = self.rows[row]
            if req is None:
                continue
            need_pages = self._row_need_pages(row, req, horizon)
            while len(req.blocks) < need_pages:
                got = self.alloc.alloc(1)
                if got is not None:
                    req.blocks.extend(got)
                    self.tables[row, len(req.blocks) - 1] = got[0]
                    continue
                if self._inflight:
                    # Finished rows in the queue may free blocks, and
                    # preemption bookkeeping must be exact.
                    self._flush_inflight()
                    if self.rows[row] is not req:
                        break  # this row finished in the flush
                    continue
                if self._reclaim_spec_pages(horizon):
                    continue
                if self.prefix_cache is not None and self.prefix_cache.evict(1):
                    continue  # a cold cached block went back to the pool
                victim = max((r for r in self.rows if r is not None), key=lambda r: r.admit_order)
                self._preempt(victim)
                if victim is req or self.rows[row] is not req:
                    break  # this row is gone; nothing more to grow
        if prealloc > 0:
            self._prealloc_write_pages(horizon + prealloc)

    def _prealloc_write_pages(self, horizon: int) -> None:
        """Best-effort growth toward ``horizon`` write slots per live row,
        from the free list only, keeping one headroom block per active
        row."""
        for row in range(self.max_batch):
            req = self.rows[row]
            if req is None:
                continue
            want = self._row_need_pages(row, req, horizon) - len(req.blocks)
            spare = self.alloc.available - self.n_active
            if want <= 0 or spare <= 0:
                continue
            got = self.alloc.alloc_upto(min(want, spare))
            for b in got:
                req.blocks.append(b)
                self.tables[row, len(req.blocks) - 1] = b
            if got:
                self.stats["page_preallocs"] = self.stats.get("page_preallocs", 0) + len(got)
            if len(got) < want:
                return  # no spare pages this round

    def _reclaim_spec_pages(self, horizon: int) -> int:
        """Roll back speculative page grants: free every live row's blocks
        beyond its ``horizon`` coverage. Only with an empty queue (callers
        flush first): then no write targets the reclaimed pages. Returns
        the number of blocks freed."""
        if self._inflight:
            raise RuntimeError("page reclaim needs committed state (flush the queue first)")
        freed = 0
        for row in range(self.max_batch):
            req = self.rows[row]
            if req is None:
                continue
            need_pages = self._row_need_pages(row, req, horizon)
            if len(req.blocks) > need_pages:
                surplus = req.blocks[need_pages:]
                del req.blocks[need_pages:]
                self.tables[row, need_pages:] = 0
                self.alloc.free(surplus)
                freed += len(surplus)
        if freed:
            self.stats["page_reclaims"] = self.stats.get("page_reclaims", 0) + freed
        return freed

    # -- release --------------------------------------------------------------

    def _preempt(self, req: _Request) -> None:
        """Evict a running request: free its blocks and requeue it at the
        front with prompt + generated as its new prompt. A victim admitted
        this round may still hold its first token on the device: resolve it
        first (which may finish the request)."""
        self._resolve_first(req)
        if req.row is None:
            return
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
            # sampled token was never fed), and in-flight windows write at
            # or above that frontier, so publishing below it is safe
            # mid-pipeline; a mid-prefill row has written exactly its chunks
            # below prefill_pos.
            g, p = len(req.generated), len(req.prompt)
            if req.prefill_pos is not None:
                publish_len = req.prefill_pos
            else:
                publish_len = p + g - 1 if g else p
            published = self.prefix_cache.release_row(
                req.prompt + req.generated, req.blocks, req.n_shared, publish_len
            )
            if self.kv_checksum:
                # Pages below the committed frontier are final, so the
                # digest taken now is what every later acquire checks.
                for b in published:
                    self.prefix_cache.set_checksum(b, integrity.kv_block_digest(self.pools, b))
        else:
            self.alloc.free(req.blocks)
        req.blocks = []
        req.n_shared = 0
        req.row = None
        self.rows[row] = None
        self.tables[row, :] = 0
        self.seq_lens[row] = 0
        self.tokens[row] = 0
