"""Per-request distributed tracing for the serving path (the JAX package's
``observability/tracing.py``).

A request's latency story crosses three thread domains — the gateway
handler that accepted it, the engine-loop thread that schedules it, and
the device windows it rides — so nested context-manager spans (spans.py)
cannot describe it: its queue wait STARTS on one thread and ENDS on
another, and its decode windows overlap each other under deep
pipelining. This module adds the request-scoped half:

  SpanContext       trace-id/span-id pair, parsed from / rendered to the
                    W3C ``traceparent`` header (an inbound id is honored,
                    so the gateway joins a caller's existing trace);
  RequestTrace      one request's span tree: explicit-timestamp
                    child spans (queue, admission, prefill, each decode
                    window) parented under a single root ``req.request``
                    span, recorded into the shared SpanRecorder so
                    Perfetto shows gateway threads, the engine loop and
                    per-request waterfalls on ONE timeline (each request
                    renders on its own virtual track);
  Tracer            mints RequestTraces; per-request sampling happens
                    here — an unsampled request gets ``None`` and every
                    recording site guards on it, so disabled tracing
                    costs one attribute check.

Every span's args carry ``trace_id``/``span_id``/``parent_span_id``; the
EventBus ``req_*`` records carry the same ``trace_id``, which is the
cross-link ``obs_report --slo`` joins on.

  group_request_spans / check_trace_tree
                    the analyzer's completeness check of each request's
                    span tree in an exported trace, used by the port's
                    ``obs_report`` (the JAX script's checks, so a checker
                    of the port needs nothing of the JAX package).
"""

from __future__ import annotations

import random
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from pretraining_llm_tpu_torch.observability import spans as _spans

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


@dataclass(frozen=True)
class SpanContext:
    """An immutable (trace_id, span_id) pair plus the sampling decision."""

    trace_id: str
    span_id: str
    sampled: bool = True


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a W3C ``traceparent`` header; returns None on anything
    malformed (the spec says: ignore and start a fresh trace — a broken
    client header must never 500 a generate call). All-zero trace or span
    ids are invalid per spec and also return None."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(
        trace_id=trace_id, span_id=span_id, sampled=bool(int(flags, 16) & 0x01)
    )


def format_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


class RequestTrace:
    """One request's span tree. Child spans take EXPLICIT perf_counter
    timestamps because their endpoints live on different threads; all
    children parent directly under the root request span (a two-level
    tree — deep nesting would only restate the names). ``marks`` is a
    scratch dict the frontend/engine use to carry boundary timestamps
    (submit, admit) between the threads that observe them; the engine
    loop is the only writer after submit, so no lock is needed there.
    """

    __slots__ = (
        "trace_id", "root_id", "parent_id", "marks", "t0",
        "_recorder", "_track", "_rng", "_finished", "_lock",
        "finish_deferred",
    )

    def __init__(
        self,
        recorder: _spans.SpanRecorder,
        trace_id: str,
        *,
        parent_id: Optional[str] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        self._recorder = recorder
        self._rng = rng if rng is not None else random
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.root_id = self._new_span_id()
        self._track = f"req {trace_id[:12]}"
        self.t0 = time.perf_counter()
        self.marks: Dict[str, float] = {"start": self.t0}
        self._finished = False
        # When True, the terminal paths that normally finish() the trace
        # (EngineLoop._terminal / _rejected) record their spans but leave
        # the root open — the fleet router owns the root of a lineage
        # tree and finishes it exactly once, after redrives settle.
        self.finish_deferred = False
        self._lock = threading.Lock()

    def _new_span_id(self) -> str:
        return f"{self._rng.getrandbits(64) or 1:016x}"

    def new_span_id(self) -> str:
        """Mint a span id under this trace's RNG — used by the router to
        pre-allocate a placement-attempt span id so it can hand workers a
        ``traceparent`` pointing AT the attempt before the attempt span
        itself is recorded (spans are written at completion)."""
        return self._new_span_id()

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.root_id, sampled=True)

    def span(
        self,
        name: str,
        t0: float,
        t1: Optional[float] = None,
        *,
        span_id: Optional[str] = None,
        **meta: Any,
    ) -> None:
        """Record one completed child span [t0, t1] (perf_counter
        seconds); ``t1`` defaults to now. ``span_id`` lets a caller that
        pre-allocated the id (``new_span_id``, the router's attempt
        spans) record under it so grandchildren minted earlier still
        parent correctly."""
        end = time.perf_counter() if t1 is None else t1
        self._recorder.record(
            name,
            t0,
            max(0.0, end - t0),
            meta={
                "trace_id": self.trace_id,
                "span_id": span_id if span_id is not None else self._new_span_id(),
                "parent_span_id": self.root_id,
                **meta,
            },
            track=self._track,
        )

    def event(self, name: str, **meta: Any) -> None:
        """Zero-duration child span (a point on the waterfall). One
        clock read serves as both endpoints — two reads would make the
        instant negative-width after the exporter's subtraction."""
        now = time.perf_counter()
        self.span(name, now, now, **meta)

    def finish(self, status: str, **meta: Any) -> bool:
        """Record the terminal point and the root request span (t0 ->
        now). Idempotent: exactly one root per trace, whichever of the
        loop terminal / gateway rejection paths gets here first wins.
        Returns False if the trace was already finished."""
        with self._lock:
            if self._finished:
                return False
            self._finished = True
        end = time.perf_counter()
        self.span("req.terminal", end, end, status=status)
        root_meta: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "span_id": self.root_id,
            "status": status,
            **meta,
        }
        if self.parent_id is not None:
            root_meta["parent_span_id"] = self.parent_id
        self._recorder.record(
            "req.request",
            self.t0,
            max(0.0, end - self.t0),
            meta=root_meta,
            track=self._track,
        )
        return True

    @property
    def finished(self) -> bool:
        return self._finished


class Tracer:
    """Mints per-request traces into one SpanRecorder.

    ``sample`` is the head-sampling fraction for requests WITHOUT an
    inbound ``traceparent``; an inbound header's sampled flag is honored
    verbatim (the caller already decided). ``seed`` makes id generation
    and sampling deterministic for tests; production leaves it None.
    """

    def __init__(
        self,
        recorder: Optional[_spans.SpanRecorder] = None,
        *,
        sample: float = 1.0,
        seed: Optional[int] = None,
    ) -> None:
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self._recorder = recorder if recorder is not None else _spans.get_recorder()
        self.sample = float(sample)
        self._rng = random.Random(seed) if seed is not None else random.Random()
        self._lock = threading.Lock()

    @property
    def recorder(self) -> _spans.SpanRecorder:
        return self._recorder

    def begin_request(
        self, traceparent: Optional[str] = None
    ) -> Optional[RequestTrace]:
        """Start (or join) a trace for one request; None = unsampled,
        and every downstream site records nothing for this request."""
        inbound = parse_traceparent(traceparent)
        with self._lock:
            if inbound is not None:
                sampled = inbound.sampled
            else:
                sampled = self.sample > 0.0 and (
                    self.sample >= 1.0 or self._rng.random() < self.sample
                )
            if not sampled:
                return None
            trace_id = (
                inbound.trace_id
                if inbound is not None
                else f"{self._rng.getrandbits(128) or 1:032x}"
            )
            return RequestTrace(
                self._recorder,
                trace_id,
                parent_id=inbound.span_id if inbound is not None else None,
                rng=self._rng,
            )


# -- trace analysis (obs_report's --trace checks) ----------------------------

_ROOT = "req.request"
_TERMINAL = "req.terminal"
_ATTEMPT = "req.attempt"


def group_request_spans(trace: Dict[str, Any]) -> Dict[str, List[Dict[str, Any]]]:
    """Group complete ("X") events of a Chrome trace export by
    ``args.trace_id``. Host spans without a trace_id (the engine loop's own
    rows) are not request spans and are skipped."""
    groups: Dict[str, List[Dict[str, Any]]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        tid = (ev.get("args") or {}).get("trace_id")
        if tid:
            groups.setdefault(tid, []).append(ev)
    return groups


def _is_remote(ev: Dict[str, Any]) -> bool:
    return bool((ev.get("args") or {}).get("remote"))


def check_trace_tree(trace_id: str, spans: List[Dict[str, Any]]) -> List[str]:
    """Structural completeness of ONE request's span tree; returns problems
    (empty = complete). A done request must show the whole journey (queue,
    prefill, at least one decode window, first token, terminal); a rejected
    one only its admission verdict; cancelled/expired/error at minimum the
    queue time they burned before dying. Every local span hangs off the one
    root. Remote spans (a worker's subtree) hang off a ``req.attempt`` span
    of the trace instead, and still count toward the journey."""
    problems: List[str] = []
    short = trace_id[:12]
    local = [ev for ev in spans if not _is_remote(ev)]
    remote = [ev for ev in spans if _is_remote(ev)]
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for ev in spans:
        by_name.setdefault(ev["name"], []).append(ev)
    roots = [ev for ev in local if ev["name"] == _ROOT]
    if len(roots) != 1:
        problems.append(f"trace {short}: {len(roots)} root spans (want 1)")
        return problems  # nothing else is checkable without the root
    root = roots[0]
    root_sid = root["args"].get("span_id")
    status = root["args"].get("status")
    terminals = [ev for ev in local if ev["name"] == _TERMINAL]
    if len(terminals) != 1:
        problems.append(f"trace {short}: {len(terminals)} terminal events (want 1)")
    elif terminals[0]["args"].get("status") != status:
        problems.append(
            f"trace {short}: terminal status "
            f"{terminals[0]['args'].get('status')!r} != root {status!r}"
        )
    for ev in local:
        if ev is root:
            continue
        if ev["args"].get("parent_span_id") != root_sid:
            problems.append(
                f"trace {short}: {ev['name']} span not parented to root"
            )
    attempt_ids = {
        ev["args"].get("span_id") for ev in local if ev["name"] == _ATTEMPT
    }
    for ev in remote:
        if ev["name"] == _ROOT and ev["args"].get("parent_span_id") not in attempt_ids:
            problems.append(
                f"trace {short}: worker subtree (replica "
                f"{ev['args'].get('worker')}) not parented to any "
                f"req.attempt span"
            )
    need = {
        "done": ("req.queue", "req.prefill", "req.window",
                 "req.first_token", _TERMINAL),
        "rejected": ("req.admission", _TERMINAL),
    }.get(status, ("req.queue", _TERMINAL))
    for name in need:
        if name == "req.prefill" and "req.prefill_chunk" in by_name:
            # Chunked prefill replaces the monolithic prefill span with
            # one span per chunk; either form proves the prompt landed.
            continue
        if name not in by_name:
            problems.append(
                f"trace {short} ({status}): missing {name} span"
            )
    return problems
