"""Long-lived engine thread: the online request lifecycle over ServingEngine
(the JAX package's ``frontend/engine_loop.py``).

``ServingEngine.run()`` is offline — every request is submitted up front
and the call drains to completion. This loop makes the engine ONLINE:

  - one dedicated thread owns the engine (and therefore all device
    dispatch; device state never crosses threads) and repeatedly calls
    ``pipeline_tick()``, the single deep-pipelined scheduler turn;
  - gateway threads ``submit()`` into a thread-safe inbox; the loop
    drains it BETWEEN scheduler turns, so requests arriving mid-decode
    join the engine's waiting queue and are admitted at the next window
    boundary without disturbing in-flight windows;
  - committed tokens stream to per-request queues via the engine's
    ``on_token`` hook (commit time = reap time under deep pipelining, so
    a streamed token is never retracted);
  - cancellation and per-request deadlines are applied between turns:
    the engine's ``cancel()`` flushes the in-flight window queue before
    releasing the victim's row and pool blocks (see ServingEngine.cancel
    for why the flush must come first), so surviving requests' outputs
    are bit-identical to a run that never saw the victim.

Terminal statuses mirror the HTTP story: ``done`` (200), ``cancelled``
(499 client closed), ``expired`` (504 deadline), ``error`` (500).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from pretraining_llm_tpu_torch.frontend.admission import (
    AdmissionController,
    RejectedBusy,
    RejectedInfeasible,
    Ticket,
)
from pretraining_llm_tpu_torch.observability.capacity import (
    CapacitySampler,
    DecisionLog,
)

TERMINAL_STATUSES = ("done", "cancelled", "expired", "error")

# Distinguishes "caller made no tracing decision" (loop samples from its
# own tracer) from an explicit trace=None (gateway decided: unsampled).
_TRACE_UNSET = object()


def _finish_trace(trace: Any, status: str, **meta: Any) -> None:
    """Finish a request trace UNLESS its owner deferred the root: the
    fleet router marks lineage-tree roots ``finish_deferred`` because an
    attempt-level terminal here (e.g. "error" on a replica crash) is not
    the request's fate — the router redrives and finishes the root once
    the lineage settles."""
    if trace is None or getattr(trace, "finish_deferred", False):
        return
    trace.finish(status, **meta)


@dataclasses.dataclass
class FrontendRequest:
    """One in-flight request as the frontend sees it. ``out_q`` carries
    ``("token", int)`` items followed by exactly one
    ``("end", status, info)`` tuple; ``tokens``/``status``/``info`` are
    the loop thread's authoritative copies, safe to read after the end
    event has been consumed."""

    prompt: List[int]
    max_new: int
    deadline: Optional[float]  # monotonic deadline, None = none
    submitted_s: float
    ticket: Optional[Ticket] = None
    trace: Any = None  # observability.tracing.RequestTrace | None
    out_q: "queue.Queue[Tuple]" = dataclasses.field(default_factory=queue.Queue)
    rid: Optional[int] = None
    status: str = "queued"
    tokens: List[int] = dataclasses.field(default_factory=list)
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)
    cancel_requested: bool = False
    # Scheduling priority (higher = more important). The loop itself is
    # FIFO regardless; the fleet router's brownout mode sheds by it.
    priority: int = 0

    def events(self, timeout: Optional[float] = None) -> Iterator[Tuple]:
        """Yield stream events until (and including) the terminal
        ``("end", status, info)``. ``timeout`` bounds the wait for EACH
        event; expiry raises ``TimeoutError``."""
        while True:
            try:
                ev = self.out_q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no stream event within {timeout}s (status={self.status})"
                )
            yield ev
            if ev[0] == "end":
                return

    def result(
        self, timeout: Optional[float] = None
    ) -> Tuple[str, List[int], Dict[str, Any]]:
        """Drain the stream; returns (status, tokens, info)."""
        for _ in self.events(timeout=timeout):
            pass
        return self.status, self.tokens, self.info


class EngineLoop:
    """Owns a ServingEngine on a dedicated thread; see module docstring.

    ``bus`` (optional, observability.events.EventBus) receives per-request
    lifecycle events: req_submit, req_done, req_cancelled, req_expired —
    each terminal event carries queue_wait_s/ttft_s/e2e_s and the token
    count, so the event stream is the serving audit log.
    """

    def __init__(
        self,
        engine: Any,
        *,
        admission: Optional[AdmissionController] = None,
        bus: Any = None,
        idle_wait_s: float = 0.005,
        clock: Any = time.monotonic,
        tracer: Any = None,
        registry: Any = None,
        capacity_ring: int = 512,
        weight_fingerprint_interval_s: float = 0.0,
    ) -> None:
        self.engine = engine
        self.admission = admission
        self.bus = bus
        self.idle_wait_s = float(idle_wait_s)
        # Deadlines compare against this clock; injectable so tests can
        # expire a request mid-flight deterministically.
        self._clock = clock
        # Per-request tracing (observability.tracing.Tracer). None = off:
        # submit() mints no trace and every recording site is a single
        # attribute/None check.
        self.tracer = tracer
        # Typed live metrics (observability.metrics.MetricsRegistry).
        # Histograms are observed once per terminal / reaped window, the
        # token counter once per committed token — each is one lock +
        # bisect, no device work anywhere.
        self.registry = registry
        self._h_ttft = self._h_tpot = self._h_queue = self._h_e2e = None
        self._c_terminal: Dict[str, Any] = {}
        self._c_tokens = self._c_submitted = None
        if registry is not None:
            self._h_ttft = registry.histogram(
                "ttft_seconds", "submit -> first committed token")
            self._h_tpot = registry.histogram(
                "tpot_seconds", "per-output-token seconds after the first")
            self._h_queue = registry.histogram(
                "queue_wait_seconds", "submit -> engine row claim")
            self._h_e2e = registry.histogram(
                "e2e_seconds", "submit -> terminal")
            self._c_terminal = {
                s: registry.counter(
                    "requests_terminal_total",
                    "requests reaching a terminal status", status=s)
                for s in TERMINAL_STATUSES
            }
            self._c_tokens = registry.counter(
                "tokens_streamed_total", "committed tokens streamed to clients")
            self._c_submitted = registry.counter(
                "requests_submitted_total", "requests accepted past admission")
            engine.window_hist = registry.histogram(
                "window_seconds", "decode-window dispatch -> reap wall time")
            engine.host_blocked_hist = registry.histogram(
                "host_blocked_seconds", "host blocked on window readback")
            cache = getattr(engine, "prefix_cache", None)
            if cache is not None:
                cache.bind(registry)
            engine.preempt_counter = registry.counter(
                "preemptions_total", "running requests preempted (pool dry)")
            engine.preempt_tokens_counter = registry.counter(
                "preempted_tokens_recomputed_total",
                "prompt tokens re-prefilled on preemption resume")
            engine.chunk_counter = registry.counter(
                "prefill_chunks_total", "prefill chunks dispatched")
            engine.chunk_tokens_counter = registry.counter(
                "prefill_chunk_tokens_total",
                "prompt tokens prefilled via the chunk lane")
            engine.chunk_interleaved_counter = registry.counter(
                "chunk_windows_interleaved_total",
                "scheduler ticks that dispatched chunks alongside a decode window")
            engine.chunk_dedicated_counter = registry.counter(
                "chunk_windows_dedicated_total",
                "scheduler ticks that dispatched chunks with no decode rows live")
            self._c_shed = {
                kind: registry.counter(
                    "deadline_shed_total",
                    "requests shed on deadline grounds", kind=kind)
                for kind in ("admission", "inflight")
            }
            engine.invalid_token_counter = registry.counter(
                "invalid_token_total",
                "out-of-vocab token ids caught by the reap sanity guard")
            engine.kv_mismatch_counter = registry.counter(
                "kv_checksum_mismatch_total",
                "cached KV pages that failed verify-on-acquire")
            # KV-pool residency is static per engine (pools are allocated
            # once at construction), so the gauge is set here rather than
            # on the per-window path. Includes scale pools on quantized
            # engines — it is the number capacity planning compares across
            # quantize modes at a fixed HBM budget.
            pool_info = getattr(engine, "pool_info", None)
            if pool_info is not None:
                info = pool_info()
                registry.gauge(
                    "kv_pool_bytes",
                    "resident KV pool bytes across layers, including "
                    "quantization scale pools",
                ).set(info["pool_bytes"])
                registry.gauge(
                    "kv_pool_bytes_per_block",
                    "KV pool bytes per block across layers (quantized "
                    "pools pack more tokens per byte)",
                ).set(info["bytes_per_block"])
        else:
            self._c_shed = {}
        # Capacity observability (observability/capacity.py): occupancy
        # sampler + scheduler decision log, installed on the engine like
        # the histograms above. ``capacity_ring`` bounds both buffers;
        # 0 disables the layer entirely (engine hooks stay None).
        if capacity_ring < 0:
            raise ValueError(
                f"capacity_ring must be >= 0, got {capacity_ring}"
            )
        self.capacity: Optional[CapacitySampler] = None
        self.decisions: Optional[DecisionLog] = None
        if capacity_ring > 0:
            self.capacity = CapacitySampler(
                engine.max_batch,
                engine.alloc.n_blocks - 1,  # block 0 is reserved scratch
                maxlen=capacity_ring,
                bus=bus,
                admission_snapshot_fn=(
                    admission.snapshot if admission is not None else None
                ),
                pool_layout=(
                    engine.pool_info()
                    if hasattr(engine, "pool_info") else None
                ),
            )
            self.decisions = DecisionLog(maxlen=capacity_ring, bus=bus)
            if registry is not None:
                self.capacity.bind(registry)
            engine.capacity = self.capacity
            engine.decisions = self.decisions
        engine.on_token = self._on_token
        engine.on_finish = self._on_finish
        # Engine-loop liveness: monotonic time of the last completed
        # scheduler turn; /healthz subtracts it from now to distinguish a
        # wedged loop (stuck in one turn) from a healthy idle one (which
        # keeps turning).
        self._last_turn = self._clock()
        self._inbox: "queue.Queue[FrontendRequest]" = queue.Queue()
        # Control mailbox: callables executed ON the loop thread between
        # scheduler turns. This is the only sanctioned way for another
        # thread to mutate engine device state (e.g. KV-page adoption
        # writes ``engine.pools`` — racing the loop thread's own pools
        # swap would lose one side's update). Reads of committed state
        # don't need it; writes do.
        self._control: "queue.Queue[Tuple[Callable[[], Any], queue.Queue]]" = (
            queue.Queue()
        )
        # Guards the submit-side put against the shutdown drain: once the
        # loop thread has drained the inbox (_drained), a late put would
        # enqueue a request nothing will ever terminate.
        self._inbox_lock = threading.Lock()
        self._drained = False
        self._by_rid: Dict[int, FrontendRequest] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()  # counters only
        # Guards the terminal status check-and-set: a wedged-stop caller
        # (_fail_outstanding) and a later-unwedging loop thread may race
        # to deliver the same request's terminal; exactly one must win.
        self._term_lock = threading.Lock()
        # Set by _run on the way down when the engine (or a hook) raised —
        # the fleet router reads it to distinguish "crashed" from
        # "stopped" without parsing terminal reasons.
        self.failure: Optional[BaseException] = None
        # Live weight fingerprint (resilience/integrity.py). Both values are
        # computed ON the loop thread — the only thread allowed to dispatch
        # device work for this engine — and merely READ by the router's
        # sentinel: ``weight_fingerprint0`` is pinned once at loop start (the
        # known-good reference), ``weight_fingerprint`` is refreshed every
        # ``weight_fingerprint_interval_s`` between scheduler turns. 0
        # disables the layer (both stay None; no device work added).
        if weight_fingerprint_interval_s < 0:
            raise ValueError(
                f"weight_fingerprint_interval_s must be >= 0, got "
                f"{weight_fingerprint_interval_s}"
            )
        self.weight_fingerprint_interval_s = float(weight_fingerprint_interval_s)
        self.weight_fingerprint0: Optional[float] = None
        self.weight_fingerprint: Optional[float] = None
        self._draining = False
        self.counters: Dict[str, int] = {
            "submitted": 0, "completed": 0, "cancelled": 0, "expired": 0,
            "errors": 0, "tokens_streamed": 0,
        }

    # -- public API (any thread) -------------------------------------------

    def start(self) -> "EngineLoop":
        assert self._thread is None, "start() called twice"
        self._thread = threading.Thread(
            target=self._run, name="engine-loop", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> bool:
        """Stop the loop thread. Outstanding requests get an ``error``
        terminal event ("shutdown") — a serving process going down does
        not pretend in-flight work completed.

        Returns True when the loop thread exited within ``timeout``. On
        expiry the (daemon) thread is abandoned mid-turn, but its
        outstanding requests are NOT stranded: this caller delivers
        their error terminals itself — idempotent against the wedged
        thread waking up later and running its own shutdown path — and
        the timeout is surfaced as a warning plus the False return, so a
        fleet drain can eject the replica instead of trusting it."""
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is None:
            return True
        t.join(timeout=timeout)
        if t.is_alive():
            n_out = len(self._by_rid) + self._inbox.qsize()
            warnings.warn(
                f"EngineLoop.stop: loop thread still alive after "
                f"{timeout}s; delivering error terminals for {n_out} "
                f"outstanding request(s) from the stopping thread",
                RuntimeWarning,
                stacklevel=2,
            )
            self._fail_outstanding(f"shutdown timeout after {timeout}s")
            return False
        self._thread = None
        return True

    def _fail_outstanding(self, reason: str) -> int:
        """Deliver ``error`` terminals for every request the loop thread
        will never get to (the wedged-stop path). Runs on the STOPPING
        thread and touches only host-side dicts and queues — the wedged
        loop thread still owns the engine, so no device work, no
        ``eng.cancel``. Returns how many terminals were delivered."""
        n = 0
        for req in list(self._by_rid.values()):
            if req.status not in TERMINAL_STATUSES:
                self._terminal(req, "error", reason=reason)
                n += 1
        with self._inbox_lock:
            self._drained = True
        while True:
            try:
                req = self._inbox.get_nowait()
            except queue.Empty:
                break
            self._terminal(req, "error", reason=reason)
            n += 1
        return n

    def __enter__(self) -> "EngineLoop":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        """True while the loop thread is alive and not stopping."""
        t = self._thread
        return t is not None and t.is_alive() and not self._stop.is_set()

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Stop accepting new work (``submit`` raises, ``/readyz`` reports
        not-ready) while in-flight requests keep decoding — the first half
        of the rolling-restart handshake: drain, redrive/finish, stop()."""
        self._draining = True

    def readiness(self) -> Dict[str, Any]:
        """The ``/readyz`` signal, distinct from ``/healthz`` liveness: a
        draining or stopped loop is alive (liveness ok) but must not
        receive new traffic (readiness not ok)."""
        return {
            "ready": self.running and not self._draining,
            "running": self.running,
            "draining": self._draining,
        }

    def submit(
        self,
        prompt: List[int],
        max_new_tokens: int,
        *,
        deadline_s: Optional[float] = None,
        trace: Any = _TRACE_UNSET,
        priority: int = 0,
    ) -> FrontendRequest:
        """Validate, pass admission, enqueue. Raises ``ValueError`` on a
        malformed request (gateway: 400), ``RejectedBusy`` (429) or
        ``RejectedInfeasible`` (504) from the admission controller.
        Returns immediately with the request handle; tokens stream on its
        ``out_q``.

        ``trace`` is a gateway-minted RequestTrace (the gateway owns the
        inbound ``traceparent`` header and the sampling decision — an
        explicit ``None`` means "decided: unsampled" and the loop must
        NOT re-sample); with no gateway in the path (in-process loadgen)
        the argument is left unset and the loop mints one from its own
        tracer. A rejected request still gets a complete one-span trace:
        admission outcome + a ``rejected`` terminal."""
        if self._stop.is_set() or self._thread is None:
            raise RuntimeError("EngineLoop is not running")
        if self._draining:
            raise RuntimeError("EngineLoop is draining")
        if trace is _TRACE_UNSET:
            trace = (
                self.tracer.begin_request() if self.tracer is not None else None
            )
        trace_fields = (
            {"trace_id": trace.trace_id} if trace is not None else {}
        )
        try:
            # validate_request reads only construction-time constants —
            # safe from gateway threads while the loop thread runs.
            max_new = self.engine.validate_request(prompt, max_new_tokens)
        except ValueError as e:
            self._rejected(trace, "invalid", str(e), trace_fields)
            raise
        ticket = None
        t_adm = time.perf_counter()
        if self.admission is not None:
            # Prefix-cache hint: tokens already resident in shared blocks
            # won't charge the outstanding budget. peek() is lock-guarded
            # and side-effect-free, so gateway threads may call it while
            # the loop thread mutates the cache; the hint can go stale
            # either way before the engine's own lookup, which only makes
            # the discount conservative, never the budget unsound (the
            # ticket stores whatever was charged).
            cached = 0
            cache = getattr(self.engine, "prefix_cache", None)
            if cache is not None:
                cached = cache.peek(prompt)
            try:
                ticket = self.admission.try_admit(
                    len(prompt), max_new, deadline_s=deadline_s,
                    cached_tokens=cached,
                )
            except RejectedBusy as e:
                self._rejected(trace, "busy", e.reason, trace_fields)
                raise
            except RejectedInfeasible as e:
                self._rejected(trace, "infeasible", e.reason, trace_fields)
                raise
        try:
            now = self._clock()
            if trace is not None:
                trace.span("req.admission", t_adm, outcome="admitted")
                # The engine's queue span starts here: admission passed,
                # the request is now waiting (inbox + engine queue).
                trace.marks["submit"] = time.perf_counter()
            req = FrontendRequest(
                prompt=[int(t) for t in prompt],
                max_new=max_new,
                deadline=(now + deadline_s) if deadline_s is not None else None,
                submitted_s=now,
                ticket=ticket,
                trace=trace,
                priority=int(priority),
            )
            with self._lock:
                self.counters["submitted"] += 1
            if self._c_submitted is not None:
                self._c_submitted.inc()
            if self.bus is not None:
                self.bus.emit(
                    "req_submit", n_prompt=len(req.prompt), max_new=max_new,
                    deadline_s=deadline_s, **trace_fields,
                )
            with self._inbox_lock:
                if self._drained:
                    raise RuntimeError("EngineLoop is not running")
                self._inbox.put(req)
        except BaseException:
            # The request never reached the inbox, so _terminal will never
            # run for it — its admission budget must be returned here or
            # the queue-depth slot leaks until restart.
            if ticket is not None:
                self.admission.release(ticket)
            _finish_trace(trace, "error", reason="submit failed")
            raise
        self._wake.set()
        return req

    def _rejected(
        self,
        trace: Any,
        reason: str,
        detail: str,
        trace_fields: Dict[str, Any],
    ) -> None:
        """Bookkeeping for a request refused before the inbox: one
        ``req_rejected`` event, a decision record, and a finished
        (rejected) trace."""
        if self.bus is not None:
            self.bus.emit(
                "req_rejected", reason=reason, detail=detail, **trace_fields
            )
        if self.decisions is not None and reason in ("busy", "infeasible"):
            self.decisions.record(
                f"reject_{reason}", detail=detail,
                trace_id=trace_fields.get("trace_id"),
            )
        if reason == "infeasible" and self._c_shed:
            self._c_shed["admission"].inc()
        if trace is not None:
            trace.span(
                "req.admission", time.perf_counter(),
                outcome="rejected", reason=reason,
            )
            _finish_trace(trace, "rejected", reason=reason)

    def run_on_loop(
        self, fn: Callable[[], Any], *, timeout: Optional[float] = 30.0
    ) -> Any:
        """Run ``fn()`` on the loop thread between scheduler turns and
        return its result (re-raising its exception). The engine owns all
        device dispatch on that one thread, so any caller that must WRITE
        engine state (KV-page adoption swaps ``engine.pools``) funnels
        through here instead of racing the turn loop. Draining loops
        still execute control work — adoption into a draining replica is
        legal; only a stopped/dead loop refuses."""
        if self._stop.is_set() or self._thread is None or not self._thread.is_alive():
            raise RuntimeError("EngineLoop is not running")
        done: "queue.Queue[Tuple[str, Any]]" = queue.Queue(maxsize=1)
        self._control.put((fn, done))
        self._wake.set()
        try:
            kind, value = done.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"loop-thread control call did not complete in {timeout}s"
            )
        if kind == "err":
            raise value
        return value

    def cancel(self, req: FrontendRequest) -> None:
        """Request cancellation (client disconnect / explicit abort). The
        loop applies it between scheduler turns; tokens already committed
        stay delivered, then the handle gets a ``cancelled`` terminal."""
        req.cancel_requested = True
        self._wake.set()

    def last_turn_age_s(self) -> float:
        """Seconds since the loop thread last COMPLETED a scheduler turn
        — the /healthz liveness signal. A healthy loop (busy or idle)
        keeps this near zero; a loop wedged inside one turn (a hung
        device dispatch) lets it grow without bound."""
        return max(0.0, self._clock() - self._last_turn)

    @property
    def active_requests(self) -> int:
        """Requests in the system (inbox + engine), the router's load and
        spill signal. A point-in-time read off host containers only."""
        return len(self._by_rid) + self._inbox.qsize()

    def metrics(self) -> Dict[str, float]:
        """Counter snapshot for /metrics: loop counters + live gauges +
        the engine's numeric stats (prefixed ``engine_``) + admission."""
        with self._lock:
            out: Dict[str, float] = dict(self.counters)
        out["active_requests"] = self.active_requests
        for k, v in list(self.engine.stats.items()):
            if isinstance(v, (int, float)):
                out[f"engine_{k}"] = v
        if self.admission is not None:
            for k, v in self.admission.snapshot().items():
                out[f"admission_{k}"] = v
        return out

    # -- live introspection (gateway threads) --------------------------------
    #
    # Both debug views read engine host state WITHOUT the loop thread's
    # cooperation: every container touched (rows list, waiting deque,
    # _by_rid dict, req_timing) is only ever mutated between scheduler
    # turns, and each read is a single snapshot (list()/dict()) of a
    # structure CPython mutates atomically — so a concurrent turn can make
    # the view stale by one boundary, never torn mid-request. Purely
    # host-side: no device access, nothing on the hot path.

    def debug_requests(self) -> List[Dict[str, Any]]:
        """Per-request live state for /debug/requests: frontend status,
        engine phase (row vs. queue), blocks held, cached tokens, and the
        preemption count — the "where is my request right now" view."""
        eng = self.engine
        on_row = {}
        for row, ereq in enumerate(list(eng.rows)):
            if ereq is not None:
                on_row[ereq.rid] = (row, ereq)
        queued = {ereq.rid: ereq for ereq in list(eng.waiting)}
        now = self._clock()
        out: List[Dict[str, Any]] = []
        for rid, req in list(self._by_rid.items()):
            rec: Dict[str, Any] = {
                "rid": rid,
                "status": req.status,
                "n_prompt": len(req.prompt),
                "max_new": req.max_new,
                "n_tokens": len(req.tokens),
            }
            if req.trace is not None:
                rec["trace_id"] = req.trace.trace_id
            if req.deadline is not None:
                rec["deadline_remaining_s"] = round(req.deadline - now, 6)
            ereq = None
            if rid in on_row:
                row, ereq = on_row[rid]
                rec["phase"] = "decode"
                rec["row"] = row
            elif rid in queued:
                ereq = queued[rid]
                rec["phase"] = "queued"
            else:
                rec["phase"] = "inbox"
            if ereq is not None:
                rec["blocks_held"] = len(ereq.blocks)
                rec["blocks_shared"] = ereq.n_shared
                rec["preemptions"] = ereq.preemptions
            timing = eng.req_timing.get(rid)
            if timing and "cached_tokens" in timing:
                rec["cached_tokens"] = timing["cached_tokens"]
            out.append(rec)
        return out

    def debug_engine(self) -> Dict[str, Any]:
        """Engine-wide capacity state for /debug/engine: pool-block
        accounting (must tie out against the allocator — the CI gate
        asserts it), row occupancy, queue depths, the occupancy ring
        tail, and decision-log totals + tail."""
        eng = self.engine
        pool_total = eng.alloc.n_blocks - 1  # block 0 is reserved scratch
        free = eng.alloc.available
        cache = getattr(eng, "prefix_cache", None)
        cold = cache.evictable if cache is not None else 0
        out: Dict[str, Any] = {
            "rows": {
                "active": sum(r is not None for r in list(eng.rows)),
                "capacity": eng.max_batch,
            },
            "waiting": len(eng.waiting),
            "inbox": self._inbox.qsize(),
            "pool": {
                "total": pool_total,
                "free": free,
                "cold": cold,
                "live": pool_total - free - cold,
            },
            # Pool byte/dtype identity (quantize mode, KV dtype, scale
            # dtype, bytes-per-block): how an operator confirms which
            # graph a replica is actually serving from /debug/engine.
            **(
                {"pool_layout": eng.pool_info()}
                if hasattr(eng, "pool_info") else {}
            ),
            "stats": {
                k: v for k, v in list(eng.stats.items())
                if isinstance(v, (int, float))
            },
        }
        if cache is not None:
            out["prefix_cache"] = cache.debug_snapshot()
        if self.admission is not None:
            out["admission"] = self.admission.snapshot()
        if self.capacity is not None:
            out["occupancy"] = self.capacity.tail(32)
            out["windows_sampled"] = self.capacity.windows_sampled
        if self.decisions is not None:
            out["decisions"] = {
                "counts": self.decisions.counts_snapshot(),
                "tail": self.decisions.tail(32),
            }
        return out

    # -- loop thread --------------------------------------------------------

    def _run(self) -> None:
        eng = self.engine
        failure: Optional[BaseException] = None
        fp_interval = self.weight_fingerprint_interval_s
        last_fp = self._clock()
        if fp_interval > 0:
            # Pin the known-good reference before serving the first request.
            # Both the pin and every periodic refresh run HERE so the device
            # reduction stays on the one thread that owns engine dispatch.
            from pretraining_llm_tpu_torch.resilience.integrity import weight_fingerprint
            self.weight_fingerprint0 = weight_fingerprint(eng.params)
            self.weight_fingerprint = self.weight_fingerprint0
        try:
            while True:
                self._wake.clear()
                self._drain_control()
                self._drain_inbox()
                self._apply_cancels_and_deadlines()
                if self._stop.is_set():
                    break
                busy = False
                if eng.has_work() or eng._inflight:
                    busy = eng.pipeline_tick()
                    # A long window may have carried requests past their
                    # deadlines; apply before the next dispatch extends them.
                    self._apply_cancels_and_deadlines()
                self._last_turn = self._clock()
                if fp_interval > 0 and self._clock() - last_fp >= fp_interval:
                    self.weight_fingerprint = weight_fingerprint(eng.params)
                    last_fp = self._clock()
                if not busy and self._inbox.empty() and not self._stop.is_set():
                    self._wake.wait(self.idle_wait_s)
        except BaseException as e:
            failure = e
            self.failure = e
            from pretraining_llm_tpu_torch.resilience.integrity import IntegrityError
            if self.bus is not None and isinstance(e, IntegrityError):
                self.bus.emit(
                    "integrity_invalid_token",
                    rid=getattr(e, "rid", None),
                    token=getattr(e, "token", None),
                )
            raise
        finally:
            # Runs on clean stop() AND when the engine (or a hook) raised:
            # every outstanding request must get a terminal event, or the
            # gateway threads blocked in result()/events() hang forever.
            # _stop also makes submit() raise instead of enqueueing into a
            # dead loop.
            self._stop.set()
            reason = (
                "shutdown" if failure is None
                else f"engine failure: {failure!r}"
            )
            try:
                # Drain device state so nothing is mid-write, then fail
                # the survivors loudly. A FAILED engine's flush must not
                # stream or complete anything (after an integrity trip the
                # commit stream is exactly what can't be trusted — e.g. the
                # reap that raised already advanced past the bad token, so
                # later windows would skip a position): mute the callbacks
                # and let every request take the error terminal below,
                # which redrives it from its last CLEAN committed frontier.
                if failure is not None:
                    eng.on_token = None
                    eng.on_finish = None
                eng._flush_inflight()
            except Exception:
                pass  # the engine is already broken; still fail survivors
            for req in list(self._by_rid.values()):
                try:
                    if req.rid is not None:
                        eng.cancel(req.rid)
                except Exception:
                    pass
                self._terminal(req, "error", reason=reason)
            with self._inbox_lock:
                self._drained = True
            while True:
                try:
                    req = self._inbox.get_nowait()
                except queue.Empty:
                    break
                self._terminal(req, "error", reason=reason)
            # Control callers blocked in run_on_loop must not hang until
            # their timeout: the loop is down, tell them now.
            while True:
                try:
                    _, done = self._control.get_nowait()
                except queue.Empty:
                    break
                try:
                    done.put_nowait(
                        ("err", RuntimeError(f"EngineLoop stopped: {reason}"))
                    )
                except queue.Full:
                    pass

    def _drain_control(self) -> None:
        """Execute queued control callables (loop thread). A callable's
        exception is delivered to its caller, never allowed to kill the
        loop — control work is auxiliary to serving."""
        while True:
            try:
                fn, done = self._control.get_nowait()
            except queue.Empty:
                return
            try:
                result = ("ok", fn())
            except BaseException as e:  # delivered, not raised here
                result = ("err", e)
            try:
                done.put_nowait(result)
            except queue.Full:
                pass  # caller timed out and went away

    def _drain_inbox(self) -> None:
        eng = self.engine
        while True:
            try:
                req = self._inbox.get_nowait()
            except queue.Empty:
                return
            if req.cancel_requested:
                self._terminal(req, "cancelled")
                continue
            now = self._clock()
            if req.deadline is not None and now >= req.deadline:
                self._terminal(req, "expired")
                continue
            try:
                req.rid = eng.submit(req.prompt, req.max_new)
            except ValueError as e:  # pre-validated; belt and suspenders
                self._terminal(req, "error", reason=str(e))
                continue
            if req.trace is not None:
                eng.set_trace(req.rid, req.trace)
            req.status = "active"
            self._by_rid[req.rid] = req

    def _apply_cancels_and_deadlines(self) -> None:
        eng = self.engine
        now = self._clock()
        for rid, req in list(self._by_rid.items()):
            if req.status in TERMINAL_STATUSES:
                continue
            status = None
            if req.cancel_requested:
                status = "cancelled"
            elif req.deadline is not None and now >= req.deadline:
                status = "expired"
            if status is None:
                continue
            # cancel() may flush the queue; the flush can FINISH this
            # request (tokens stream, _on_finish sends the done terminal)
            # — then cancellation lost the race and there is nothing to do.
            if eng.cancel(rid):
                self._terminal(req, status)

    # -- engine hooks (loop thread) ----------------------------------------

    def _on_token(self, rid: int, tok: int) -> None:
        req = self._by_rid.get(rid)
        if req is None:
            return
        req.tokens.append(tok)
        with self._lock:
            self.counters["tokens_streamed"] += 1
        if self._c_tokens is not None:
            self._c_tokens.inc()
        req.out_q.put(("token", tok))

    def _on_finish(self, rid: int, out: List[int]) -> None:
        req = self._by_rid.get(rid)
        if req is None:
            return
        req.tokens = list(out)  # authoritative (== concatenated stream)
        self._terminal(req, "done")

    # -- terminal bookkeeping (loop thread) --------------------------------

    _COUNTER_FOR = {
        "done": "completed", "cancelled": "cancelled",
        "expired": "expired", "error": "errors",
    }

    def _terminal(self, req: FrontendRequest, status: str, **info: Any) -> None:
        with self._term_lock:
            if req.status in TERMINAL_STATUSES:
                return
            req.status = status
        eng = self.engine
        timing: Dict[str, float] = {}
        if req.rid is not None:
            timing = eng.timing_summary(req.rid)
            self._by_rid.pop(req.rid, None)
            # Bound long-lived growth: the loop owns delivery, the engine
            # need not keep per-request state past the terminal event.
            eng.req_timing.pop(req.rid, None)
            eng.finished.pop(req.rid, None)
            eng.cancelled.discard(req.rid)
            eng.pop_trace(req.rid)
        info.update(timing)
        info["n_tokens"] = len(req.tokens)
        if req.trace is not None:
            info["trace_id"] = req.trace.trace_id
        req.info = info
        if status == "expired":
            # Deadline shed mid-flight: the decision-log twin of the
            # admission-time infeasible reject.
            if self._c_shed:
                self._c_shed["inflight"].inc()
            if self.decisions is not None:
                self.decisions.record(
                    "expire_inflight", rid=req.rid,
                    trace_id=info.get("trace_id"),
                    n_tokens=len(req.tokens),
                )
        tpot = None
        if (
            status == "done"
            and len(req.tokens) > 1
            and "ttft_s" in timing
            and "e2e_s" in timing
        ):
            tpot = (timing["e2e_s"] - timing["ttft_s"]) / (len(req.tokens) - 1)
            info["tpot_s"] = tpot
        if self.admission is not None and req.ticket is not None:
            self.admission.release(req.ticket, tpot_s=tpot)
        with self._lock:
            self.counters[self._COUNTER_FOR[status]] += 1
        if self.registry is not None:
            # e2e is observed for EVERY terminal (engine timing when the
            # request ran, loop clock otherwise) so the histogram _count
            # equals the terminal-event count by construction; the other
            # latencies only exist for phases the request reached.
            self._h_e2e.observe(
                timing.get("e2e_s", self._clock() - req.submitted_s))
            if "queue_wait_s" in timing:
                self._h_queue.observe(timing["queue_wait_s"])
            if "ttft_s" in timing:
                self._h_ttft.observe(timing["ttft_s"])
            if tpot is not None:
                self._h_tpot.observe(tpot)
            self._c_terminal[status].inc()
        if req.trace is not None and not req.trace.finished:
            if "admit" not in req.trace.marks:
                # Never admitted (cancelled/expired in the inbox or the
                # engine's waiting queue): close the queue span here so
                # the tree is still complete — queue time IS where this
                # request's whole life went.
                req.trace.span(
                    "req.queue",
                    req.trace.marks.get("submit", req.trace.t0),
                    outcome=status,
                )
            _finish_trace(req.trace, status, n_tokens=len(req.tokens))
        if self.bus is not None:
            self.bus.emit(f"req_{status}", **info)
        req.out_q.put(("end", status, info))
