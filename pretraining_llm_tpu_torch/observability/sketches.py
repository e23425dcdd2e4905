"""Mergeable streaming percentile sketches for the live SLO engine (the JAX
package's ``observability/sketches.py``; ``to_dict`` gives the same JSON).

The offline analyzer (``pretraining_llm_tpu_torch.obs_report``) computes exact percentiles
because it holds the whole run in memory; a live fleet cannot. This
module provides the streaming replacement: a t-digest-style centroid
sketch that is

  fixed-size       — at most ~2x the compression parameter centroids,
                     independent of stream length, so a long-lived
                     server's memory is bounded;
  deterministic    — compression is a pure function of the centroid
                     multiset: sorted totally by (mean, weight), merged
                     greedily under the k-scale bound. Same observations
                     (in any order, once compressed from the same
                     multiset) -> byte-identical centroids. No RNG, no
                     wall clock;
  mergeable        — ``DigestSketch.merge_all([s0, s1, ...])`` flattens
                     every input's centroids into one multiset and
                     compresses ONCE, so the fleet-wide digest is
                     invariant under any permutation of the replica list
                     (the property tests/test_observability.py pins).
                     Pairwise a.merge(b) chains are NOT order-invariant
                     (each intermediate compression is lossy) — the
                     router always aggregates via merge_all;
  serializable     — ``to_dict``/``from_dict`` round-trip exactly, so a
                     worker can ship its sketch inside a ``health_pull``
                     reply and the router merges it without re-observing.

Accuracy: centroid weight is capped at ``4 * W * q * (1-q) / compression``
(the k0-style scale function), so tails hold singleton centroids —
p99/p999 stay sharp while the median trades a little resolution. The
rank error at quantile q is bounded by half the covering centroid's
weight fraction, i.e. <= 2 * q * (1-q) / compression.

``WindowedSketch`` wraps a ring of digests bucketed on an injectable
clock: observations land in the current bucket, queries merge the
buckets inside the window, and expired buckets fall off wholesale — a
rolling-window distribution with O(buckets) memory and deterministic
behavior under a fake clock (the SLO engine's alert tests depend on it).

Pure stdlib + host-side only: no torch, nothing here can
touch a device.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# Flat centroid representation: (mean, weight). Kept as tuples, not a
# class — sketches are merged/serialized constantly and tuples sort
# totally with no key function.
Centroid = Tuple[float, float]

DEFAULT_COMPRESSION = 64


class DigestSketch:
    """Fixed-size deterministic t-digest-style quantile sketch."""

    __slots__ = (
        "compression", "_centroids", "_buffer", "count", "sum",
        "min", "max",
    )

    def __init__(self, compression: int = DEFAULT_COMPRESSION) -> None:
        if compression < 8:
            raise ValueError(
                f"compression must be >= 8, got {compression}"
            )
        self.compression = int(compression)
        self._centroids: List[Centroid] = []
        # Incoming observations buffer (amortizes compression); flushed
        # at 4x compression, on query, and on serialize.
        self._buffer: List[Centroid] = []
        self.count = 0.0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- ingest -------------------------------------------------------

    def observe(self, value: float, weight: float = 1.0) -> None:
        value = float(value)
        weight = float(weight)
        if not math.isfinite(value) or weight <= 0:
            return  # a NaN latency must not poison every later quantile
        self._buffer.append((value, weight))
        self.count += weight
        self.sum += value * weight
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if len(self._buffer) >= 4 * self.compression:
            self._compress()

    # -- compression --------------------------------------------------

    def _compress(self) -> None:
        """Greedy neighbor merge over the totally-sorted centroid list.

        Deterministic: sorted input (ties broken by weight — identical
        (mean, weight) pairs are interchangeable), left-to-right sweep,
        merge allowed while the candidate's weight stays under the
        k-scale bound at its midpoint quantile. Singletons are always
        representable (the bound is floored at 1 observation-weight).
        """
        if not self._buffer and len(self._centroids) <= 2 * self.compression:
            return
        pts = sorted(self._centroids + self._buffer)
        self._buffer = []
        if not pts:
            return
        total = sum(w for _, w in pts)
        out: List[Centroid] = []
        cur_mean, cur_w = pts[0]
        done_w = 0.0  # weight fully emitted before the current centroid
        for mean, w in pts[1:]:
            q = (done_w + cur_w + w / 2.0) / total
            limit = max(1.0, 4.0 * total * q * (1.0 - q) / self.compression)
            if cur_w + w <= limit:
                merged = cur_w + w
                cur_mean += (mean - cur_mean) * (w / merged)
                cur_w = merged
            else:
                out.append((cur_mean, cur_w))
                done_w += cur_w
                cur_mean, cur_w = mean, w
        out.append((cur_mean, cur_w))
        self._centroids = out

    # -- query --------------------------------------------------------

    def quantile(self, q: float) -> float:
        """Estimated value at quantile ``q`` in [0, 1]; NaN when empty.

        Linear interpolation between adjacent centroid midpoints,
        clamped to the exact observed min/max at the tails (a sketch
        must never report a value outside the data's range).
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        self._compress()
        cents = self._centroids
        if not cents:
            return math.nan
        if len(cents) == 1:
            return cents[0][0]
        total = self.count
        target = q * total
        # Midpoint rank of each centroid: cum + w/2.
        cum = 0.0
        prev_rank = 0.0
        prev_val = self.min
        for mean, w in cents:
            rank = cum + w / 2.0
            if target <= rank:
                span = rank - prev_rank
                frac = (target - prev_rank) / span if span > 0 else 0.0
                return prev_val + (mean - prev_val) * frac
            prev_rank, prev_val = rank, mean
            cum += w
        # Past the last midpoint: interpolate toward the exact max.
        span = total - prev_rank
        frac = (target - prev_rank) / span if span > 0 else 1.0
        return prev_val + (self.max - prev_val) * min(1.0, frac)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def centroids(self) -> List[Centroid]:
        """The compressed centroid list (flushes the buffer first)."""
        self._compress()
        return list(self._centroids)

    # -- merge --------------------------------------------------------

    @classmethod
    def merge_all(
        cls,
        sketches: Iterable["DigestSketch"],
        compression: Optional[int] = None,
    ) -> "DigestSketch":
        """Merge any number of sketches into a fresh one.

        Order-invariant: the union of centroid multisets is flattened
        and compressed exactly once, so any permutation of ``sketches``
        yields identical centroids (and therefore identical quantiles).
        """
        sketches = list(sketches)
        if compression is None:
            compression = max(
                (s.compression for s in sketches), default=DEFAULT_COMPRESSION
            )
        out = cls(compression)
        for s in sketches:
            out._buffer.extend(s._centroids)
            out._buffer.extend(s._buffer)
            out.count += s.count
            out.sum += s.sum
            if s.min < out.min:
                out.min = s.min
            if s.max > out.max:
                out.max = s.max
        out._compress()
        return out

    # -- wire ---------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe representation (rides inside health_pull replies)."""
        self._compress()
        return {
            "compression": self.compression,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "centroids": [[m, w] for m, w in self._centroids],
        }

    @classmethod
    def from_dict(cls, payload: Dict[str, Any]) -> "DigestSketch":
        out = cls(int(payload.get("compression", DEFAULT_COMPRESSION)))
        out._centroids = [
            (float(m), float(w)) for m, w in payload.get("centroids", [])
        ]
        out.count = float(payload.get("count", 0.0))
        out.sum = float(payload.get("sum", 0.0))
        mn = payload.get("min")
        mx = payload.get("max")
        out.min = float(mn) if mn is not None else math.inf
        out.max = float(mx) if mx is not None else -math.inf
        return out

    def summary(
        self, quantiles: Sequence[float] = (0.5, 0.9, 0.95, 0.99)
    ) -> Dict[str, Any]:
        """The snapshot shape GET /slo serves per metric."""
        out: Dict[str, Any] = {"count": int(self.count)}
        if not self.count:
            return out
        out["mean"] = self.mean
        out["min"] = self.min
        out["max"] = self.max
        for q in quantiles:
            out[f"p{str(q)[2:].ljust(2, '0')}"] = self.quantile(q)
        return out


class WindowedSketch:
    """Rolling-window digest: a ring of per-bucket sketches on a clock.

    ``buckets`` sub-sketches each covering ``window_s / buckets``
    seconds; ``observe`` lands in the bucket the injected clock says is
    current, ``merged()``/``quantile()`` see only buckets newer than the
    window. Expiry is wholesale bucket drop — O(1), no re-weighting.
    Thread-safe (the bus delivers from whatever thread emitted).
    """

    def __init__(
        self,
        *,
        window_s: float = 60.0,
        buckets: int = 6,
        compression: int = DEFAULT_COMPRESSION,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if buckets < 1:
            raise ValueError(f"buckets must be >= 1, got {buckets}")
        self.window_s = float(window_s)
        self.buckets = int(buckets)
        self.bucket_s = self.window_s / self.buckets
        self.compression = int(compression)
        self._clock = clock
        self._lock = threading.Lock()
        # bucket index (floor(t / bucket_s)) -> sketch for that slice.
        self._ring: Dict[int, DigestSketch] = {}
        self.total_count = 0.0  # lifetime, survives bucket expiry

    def _bucket_id(self) -> int:
        return int(self._clock() // self.bucket_s)

    def _prune_locked(self, now_id: int) -> None:
        dead = [b for b in self._ring if b <= now_id - self.buckets]
        for b in dead:
            del self._ring[b]

    def observe(self, value: float, weight: float = 1.0) -> None:
        now_id = self._bucket_id()
        with self._lock:
            self._prune_locked(now_id)
            sk = self._ring.get(now_id)
            if sk is None:
                sk = self._ring[now_id] = DigestSketch(self.compression)
            sk.observe(value, weight)
            self.total_count += weight

    def merged(self) -> DigestSketch:
        """One digest over the live window (order-invariant merge)."""
        now_id = self._bucket_id()
        with self._lock:
            self._prune_locked(now_id)
            live = [self._ring[b] for b in sorted(self._ring)]
        return DigestSketch.merge_all(live, compression=self.compression)

    def quantile(self, q: float) -> float:
        return self.merged().quantile(q)

    @property
    def count(self) -> float:
        """Observations inside the live window."""
        now_id = self._bucket_id()
        with self._lock:
            self._prune_locked(now_id)
            return sum(s.count for s in self._ring.values())

    def summary(
        self, quantiles: Sequence[float] = (0.5, 0.9, 0.95, 0.99)
    ) -> Dict[str, Any]:
        out = self.merged().summary(quantiles)
        out["window_s"] = self.window_s
        return out


class WindowedCounts:
    """Rolling event tallies on the same bucket ring as WindowedSketch.

    The burn-rate rules need "good / bad events in the last N seconds"
    for several N at once, so buckets are sized by the FINEST window and
    ``sums(last_s)`` folds however many buckets a coarser window spans.
    Lifetime totals survive expiry (they are the error-budget ledger).
    """

    def __init__(
        self,
        *,
        horizon_s: float,
        bucket_s: float,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if bucket_s <= 0 or horizon_s < bucket_s:
            raise ValueError(
                f"need horizon_s >= bucket_s > 0, got "
                f"horizon_s={horizon_s} bucket_s={bucket_s}"
            )
        self.horizon_s = float(horizon_s)
        self.bucket_s = float(bucket_s)
        self._n_buckets = int(math.ceil(self.horizon_s / self.bucket_s))
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: Dict[int, Dict[str, float]] = {}
        self.totals: Dict[str, float] = {}

    def _bucket_id(self) -> int:
        return int(self._clock() // self.bucket_s)

    def add(self, key: str, n: float = 1.0) -> None:
        now_id = self._bucket_id()
        with self._lock:
            dead = [b for b in self._ring if b <= now_id - self._n_buckets]
            for b in dead:
                del self._ring[b]
            bucket = self._ring.setdefault(now_id, {})
            bucket[key] = bucket.get(key, 0.0) + n
            self.totals[key] = self.totals.get(key, 0.0) + n

    def sums(self, last_s: float) -> Dict[str, float]:
        """Tallies over the trailing ``last_s`` seconds (bucket-aligned:
        includes every bucket that overlaps the interval, so a window
        reads at worst one bucket_s wide — deterministic either way)."""
        now_id = self._bucket_id()
        span = int(math.ceil(float(last_s) / self.bucket_s))
        lo = now_id - min(span, self._n_buckets) + 1
        out: Dict[str, float] = {}
        with self._lock:
            for b, bucket in self._ring.items():
                if lo <= b <= now_id:
                    for k, v in bucket.items():
                        out[k] = out.get(k, 0.0) + v
        return out
