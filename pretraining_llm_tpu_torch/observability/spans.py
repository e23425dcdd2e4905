"""Host-side nested spans -> Chrome trace-event JSON (Perfetto-viewable);
the JAX package's ``observability/spans.py``.

The torch profiler (utils/profiling.py) answers "what is the DEVICE doing";
these spans answer "what is the HOST loop doing" — where a wall-clock minute
went when it wasn't step time: eval, checkpoint IO, rollback restores,
supervisor gaps. The exported file uses the Chrome trace-event format, so it
opens in Perfetto (ui.perfetto.dev) alongside the torch profiler traces from
``train.profile_dir`` and lines up on wall time.

Cost model: ``span()`` does two ``perf_counter`` reads and one list append —
no device syncs, no allocation beyond the tuple — so it is safe to use
anywhere on the host, though the trainer only brackets off-path work (the
per-step path records nothing). Memory is bounded: past ``max_events`` new
spans are counted as dropped instead of recorded.

Spans nest per-thread: each records its thread id and stack depth, and the
"X" (complete) Chrome events reconstruct the nesting from time containment.
(The fleet's request tracer and worker span export, ``record`` and
``drain`` in the JAX package, are not ported.)
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple


class SpanRecorder:
    def __init__(self, max_events: int = 200_000) -> None:
        self.max_events = max_events
        # (name, t_start perf_counter s, dur s, thread id, depth, meta)
        self._events: List[Tuple[str, float, float, int, int, Dict[str, Any]]] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        # Anchor for converting perf_counter timestamps to epoch us at
        # export: one wall/perf pair read together at construction.
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str, **meta: Any) -> Iterator[Dict[str, Any]]:
        """Record a span; ``meta`` (plus anything the body adds to the
        yielded dict) lands in the Chrome trace event's ``args``, so
        per-span counters — e.g. the serving scheduler's host-blocked
        seconds per decode window — are inspectable in Perfetto. Values
        must be JSON-serializable."""
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        t0 = time.perf_counter()
        out: Dict[str, Any] = dict(meta)
        try:
            yield out
        finally:
            dur = time.perf_counter() - t0
            self._local.depth = depth
            with self._lock:
                if len(self._events) < self.max_events:
                    self._events.append(
                        (name, t0, dur, threading.get_ident(), depth, out)
                    )
                else:
                    self._dropped += 1

    # -- aggregate views ----------------------------------------------

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name count + total/max seconds (host accounting). ``max_s``
        singles out the straggler occurrence: for the serving reap span
        that is the window where the host actually blocked on the device."""
        with self._lock:
            events = list(self._events)
        out: Dict[str, Dict[str, float]] = {}
        for name, _t0, dur, _tid, _depth, _meta in events:
            agg = out.setdefault(name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += dur
            agg["max_s"] = max(agg["max_s"], dur)
        return out

    @property
    def dropped(self) -> int:
        return self._dropped

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object ("X" complete events, us units).
        A nonzero dropped count is surfaced as an explicit instant event IN
        the trace: a saturated recorder must not look like a complete one."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        pid = os.getpid()
        trace = []
        t_last = 0.0
        for name, t0, dur, tid, depth, meta in events:
            ts = (self._wall0 + (t0 - self._perf0)) * 1e6
            t_last = max(t_last, ts + dur * 1e6)
            trace.append({
                "name": name,
                "ph": "X",
                "ts": ts,
                "dur": dur * 1e6,
                "pid": pid,
                "tid": tid,
                "args": {"depth": depth, **meta},
            })
        if dropped:
            trace.append({
                "name": "spans_dropped", "ph": "i", "s": "p", "pid": pid,
                "tid": 0, "ts": t_last, "args": {"dropped": dropped},
            })
        return {
            "traceEvents": trace,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": dropped},
        }

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON atomically; returns the path."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0


# Module-level default recorder: layers without a hub reference (the
# checkpoint module) record into this; the trainer's hub adopts it so their
# spans land in the same export.
_default: Optional[SpanRecorder] = None


def get_recorder() -> SpanRecorder:
    global _default
    if _default is None:
        _default = SpanRecorder()
    return _default


def set_recorder(recorder: SpanRecorder) -> None:
    """Install `recorder` as the module default (the hub adopts its own so
    checkpoint-layer spans land in the exported trace)."""
    global _default
    _default = recorder


def span(name: str, **meta: Any):
    """Convenience: a span on the module-level default recorder."""
    return get_recorder().span(name, **meta)
