"""Typed live metrics: counters, gauges, and log-bucketed histograms (the
JAX package's ``observability/metrics.py``).

The textfile exporter (export.py) renders a flat ``{name: value}`` dict —
every series becomes ``# TYPE ... gauge``, which is wrong for anything
monotonic (Prometheus clients cannot ``rate()`` a gauge safely across
restarts) and cannot express a latency distribution at all. This module is
the typed half: a small registry of

  Counter     monotonically increasing; names MUST end ``_total``
              (enforced — the Prometheus naming contract, not a style nit);
  Gauge       a value that goes both ways (queue depth, EWMA);
  Histogram   fixed log-spaced buckets with ``_bucket{le=...}``/``_sum``/
              ``_count`` exposition and a quantile estimator, so TTFT/TPOT
              tails are live at ``/metrics`` instead of only in offline
              nearest-rank reports.

Hot-path cost model: one ``observe``/``inc`` is a bisect over ~20 floats
plus a few attribute writes under a per-metric lock — no allocation on the
histogram path, no global registry lock after creation, and nothing here
can ever touch a device. The serving engine records per-WINDOW (not
per-token) histograms and per-token counter increments; both are noise
next to a device dispatch.

Label support is deliberately minimal: labels are fixed per series at
creation (``registry.counter("http_responses_total", code="200")``), and
the registry keys series by (name, labels) so one ``# TYPE`` header covers
every labeled child, as the exposition format requires.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_right
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from pretraining_llm_tpu_torch.observability.export import (
    _format_labels,
    _format_value,
    _metric_name,
)

# Default latency buckets: log-spaced, factor 2, 100us .. ~105s. 21 finite
# bounds cover everything from a per-token host callback to a queue wait
# that already blew any SLO; the +Inf bucket is implicit.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    1e-4 * (2.0 ** i) for i in range(21)
)


def log_buckets(lo: float, hi: float, *, factor: float = 2.0) -> Tuple[float, ...]:
    """Log-spaced bucket bounds from ``lo`` up to at least ``hi``."""
    if lo <= 0 or hi <= lo or factor <= 1.0:
        raise ValueError(f"need 0 < lo < hi and factor > 1, got {lo}, {hi}, {factor}")
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


class Counter:
    """Monotonic counter. ``inc`` only accepts non-negative deltas."""

    __slots__ = ("name", "labels", "help", "_value", "_lock")

    def __init__(self, name: str, labels: Mapping[str, str], help: str = "") -> None:
        self.name = name
        self.labels = dict(labels)
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        return [(self.name, self.labels, self.value)]


class Gauge:
    """A value that can go both ways; ``set``/``inc``/``dec``."""

    __slots__ = ("name", "labels", "help", "_value", "_lock")

    def __init__(self, name: str, labels: Mapping[str, str], help: str = "") -> None:
        self.name = name
        self.labels = dict(labels)
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        return [(self.name, self.labels, self.value)]


class Histogram:
    """Fixed-bucket histogram with Prometheus cumulative exposition.

    ``bounds`` are the finite upper bounds (sorted ascending); the +Inf
    overflow bucket is implicit. ``observe`` is the hot path: one bisect +
    three writes under the per-metric lock. Values below the first bound
    (including 0 and any negative clock artifact) land in the first
    bucket — a latency can never be lost to a bounds check.
    """

    __slots__ = (
        "name", "labels", "help", "bounds", "_counts", "_sum", "_count",
        "_min", "_max", "_lock",
    )

    def __init__(
        self,
        name: str,
        labels: Mapping[str, str],
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
    ) -> None:
        bounds = tuple(buckets if buckets is not None else DEFAULT_LATENCY_BUCKETS)
        if not bounds or list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name}: bounds must be sorted and unique, got {bounds}")
        if any(not math.isfinite(b) for b in bounds):
            raise ValueError(f"histogram {name}: bounds must be finite (+Inf is implicit)")
        self.name = name
        self.labels = dict(labels)
        self.help = help
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_right(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
            }

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) from the buckets: find the
        bucket holding the target rank, interpolate linearly inside it, and
        clamp to the observed min/max so the estimate never leaves the data
        range. The error bound is the width of the bucket the true value
        fell in — the property the bucket-vs-nearest-rank test checks."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._counts)
            n = self._count
            vmin, vmax = self._min, self._max
        if n == 0:
            return float("nan")
        target = max(1, math.ceil(q * n))
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else min(vmin, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else vmax
                lo = max(lo, vmin)
                hi = min(hi, vmax) if hi >= lo else lo
                frac = (target - cum) / c
                return min(max(lo + frac * (hi - lo), vmin), vmax)
            cum += c
        return vmax  # unreachable unless counts were mutated mid-iteration

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        snap = self.snapshot()
        out: List[Tuple[str, Dict[str, str], float]] = []
        cum = 0
        for bound, c in zip(snap["bounds"], snap["counts"]):
            cum += c
            out.append(
                (self.name + "_bucket", {**self.labels, "le": _le_str(bound)}, float(cum))
            )
        out.append(
            (self.name + "_bucket", {**self.labels, "le": "+Inf"}, float(snap["count"]))
        )
        out.append((self.name + "_sum", dict(self.labels), snap["sum"]))
        out.append((self.name + "_count", dict(self.labels), float(snap["count"])))
        return out


def _le_str(bound: float) -> str:
    """Canonical ``le`` label value: integral bounds render without the
    trailing .0 (Prometheus convention), others as repr."""
    f = float(bound)
    return str(int(f)) if f == int(f) else repr(f)


_RESERVED_SUFFIXES = ("_bucket", "_sum", "_count")


class MetricsRegistry:
    """Get-or-create registry of typed series; renders valid exposition.

    ``prefix`` is prepended to every metric name at registration (one
    registry per exposition namespace: ``pllm_serving_`` for the gateway,
    ``pllm_`` for training). Series are keyed by (name, labels): the same
    call site gets the same object back, and distinct label sets under one
    name share a single ``# TYPE`` header at render time.

    ``const_labels`` are merged into every series registered here (call-site
    labels win on collision). This is how a fleet of engine replicas shares
    one metric vocabulary without stomping each other: each replica gets its
    own registry carrying ``{"replica": "i"}``, the SAME registration code
    runs unchanged inside each, and ``render_merged`` joins the registries
    into one exposition where the label tells the series apart.
    """

    def __init__(
        self,
        prefix: str = "",
        const_labels: Optional[Mapping[str, Any]] = None,
    ) -> None:
        self.prefix = prefix
        self.const_labels = {
            k: str(v) for k, v in (const_labels or {}).items()
        }
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}
        self._kinds: Dict[str, str] = {}  # name -> counter|gauge|histogram
        self._helps: Dict[str, str] = {}

    def _get(self, kind: str, cls: Any, name: str, help: str, labels: Dict[str, str], **kw: Any) -> Any:
        full = _metric_name(name, self.prefix)
        if self.const_labels:
            labels = {**self.const_labels, **labels}
        key = (full, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            existing_kind = self._kinds.get(full)
            if existing_kind is not None and existing_kind != kind:
                raise ValueError(
                    f"metric {full} already registered as {existing_kind}, "
                    f"requested {kind}"
                )
            m = self._series.get(key)
            if m is None:
                m = cls(full, {k: str(v) for k, v in labels.items()}, help=help, **kw)
                self._series[key] = m
                self._kinds[full] = kind
                if help:
                    self._helps[full] = help
            return m

    def counter(self, name: str, help: str = "", **labels: Any) -> Counter:
        if not name.endswith("_total"):
            raise ValueError(
                f"counter names must end '_total' (Prometheus counter "
                f"naming contract), got {name!r}"
            )
        return self._get("counter", Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels: Any) -> Gauge:
        return self._get("gauge", Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
        **labels: Any,
    ) -> Histogram:
        if name.endswith(_RESERVED_SUFFIXES) or name.endswith("_total"):
            raise ValueError(
                f"histogram name {name!r} collides with a generated series "
                f"suffix (_bucket/_sum/_count) or the counter suffix"
            )
        return self._get("histogram", Histogram, name, help, labels, buckets=buckets)

    # -- exposition ---------------------------------------------------------

    def render(self, extra_gauges: Optional[Mapping[str, float]] = None) -> str:
        """Full Prometheus text exposition: ``# HELP``/``# TYPE`` once per
        metric name, then every labeled sample. ``extra_gauges`` lets a
        caller merge untyped legacy values in as gauges under the
        registry's prefix (the gateway's engine-stats snapshot)."""
        with self._lock:
            series = list(self._series.values())
            kinds = dict(self._kinds)
            helps = dict(self._helps)
        by_name: Dict[str, List[Any]] = {}
        for m in series:
            by_name.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(by_name):
            if name in helps:
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} {kinds[name]}")
            samples: List[Tuple[str, Dict[str, str], float]] = []
            for m in by_name[name]:
                samples.extend(m.samples())
            for sname, slabels, sval in samples:
                lines.append(f"{sname}{_format_labels(slabels)} {_format_value(sval)}")
        if extra_gauges:
            for key in sorted(extra_gauges):
                val = extra_gauges[key]
                if isinstance(val, bool):
                    val = float(val)
                if not isinstance(val, (int, float)):
                    continue
                name = _metric_name(key, self.prefix)
                if name in kinds:
                    continue  # a typed series owns this name
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_format_value(float(val))}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump (obs_report / tests): flat values for counters
        and gauges, full bucket state for histograms."""
        with self._lock:
            series = list(self._series.items())
            kinds = dict(self._kinds)
        out: Dict[str, Any] = {}
        for (name, labelkey), m in series:
            label_str = ",".join(f"{k}={v}" for k, v in labelkey)
            key = f"{name}{{{label_str}}}" if label_str else name
            if kinds[name] == "histogram":
                out[key] = m.snapshot()
            else:
                out[key] = m.value
        return out


def render_merged(
    registries: Sequence[MetricsRegistry],
    extra_gauges: Optional[Mapping[str, float]] = None,
) -> str:
    """One valid exposition over several registries (the fleet case: one
    fleet-level registry + one per replica, all sharing a prefix and metric
    names distinguished by const_labels). Metric names may repeat ACROSS
    registries — they get one ``# TYPE`` header and their samples are
    concatenated — but a name registered as different kinds in different
    registries is a programming error and raises. ``extra_gauges`` follow
    ``MetricsRegistry.render`` semantics against the merged name set, using
    the first registry's prefix."""
    if not registries:
        raise ValueError("render_merged needs at least one registry")
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    by_name: Dict[str, List[Any]] = {}
    for reg in registries:
        with reg._lock:
            series = list(reg._series.values())
            for name, kind in reg._kinds.items():
                prior = kinds.get(name)
                if prior is not None and prior != kind:
                    raise ValueError(
                        f"metric {name} registered as {prior} in one "
                        f"registry and {kind} in another"
                    )
                kinds[name] = kind
            for name, help in reg._helps.items():
                helps.setdefault(name, help)
        for m in series:
            by_name.setdefault(m.name, []).append(m)
    lines: List[str] = []
    for name in sorted(by_name):
        if name in helps:
            lines.append(f"# HELP {name} {helps[name]}")
        lines.append(f"# TYPE {name} {kinds[name]}")
        for m in by_name[name]:
            for sname, slabels, sval in m.samples():
                lines.append(
                    f"{sname}{_format_labels(slabels)} {_format_value(sval)}"
                )
    if extra_gauges:
        prefix = registries[0].prefix
        for key in sorted(extra_gauges):
            val = extra_gauges[key]
            if isinstance(val, bool):
                val = float(val)
            if not isinstance(val, (int, float)):
                continue
            name = _metric_name(key, prefix)
            if name in kinds:
                continue  # a typed series owns this name
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_format_value(float(val))}")
    return "\n".join(lines) + ("\n" if lines else "")
