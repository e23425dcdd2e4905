"""Live SLO engine: rolling latency distributions, error budgets, and
multi-window burn-rate alerting over the serving event stream (the JAX
package's ``observability/slo.py``).

Everything the engine knows arrives through the typed event bus — the
``req_*`` terminal events already carry the lifecycle latencies
(``queue_wait_s`` / ``ttft_s`` / ``e2e_s`` / ``tpot_s``) and, in fleet
mode, a ``replica`` index (process-mode workers forward their events
over the wire, so ONE router-side bus sees the whole fleet). The SLO
engine subscribes once and maintains:

  distributions   a ``WindowedSketch`` per latency metric, fleet-wide
                  and per replica (sketches.py: deterministic, mergeable,
                  bounded memory);
  error budgets   per ``SLOClass``: each eligible terminal is classified
                  good or bad against the class's objectives (latency
                  over threshold, or a non-``done`` terminal for the
                  availability objective); lifetime totals are the
                  budget ledger, rolling windows feed the burn rates;
  burn-rate rules Google-SRE-style multi-window alerts: a rule fires
                  when the bad-fraction / budget ratio exceeds its
                  threshold over BOTH its short and long window (the
                  short window makes the alert reset fast; the long one
                  keeps one stray slow request from paging). ``fast_burn``
                  pages on budget-torching incidents, ``slow_burn``
                  tickets on sustained leaks.

Alert lifecycle: on the good->bad edge the engine emits one
``slo_alert`` event (state="firing") carrying a monotonically-numbered
``alert_id`` AND records an ``slo_alert`` decision with the same id —
the event stream is the replayable timeline, the decision log is the
queryable ledger, and the shared id is the lineage join the tests pin.
When the burn drops back under threshold the engine emits the matching
state="resolved" event (no decision: resolution costs nobody anything).

Clocks: every window and alert decision runs on the injected ``clock``
(default ``time.monotonic``), so a test driving a fake clock gets
deterministic bucket rotation and alert edges. Evaluation happens
inline on each observed terminal — no background thread, no polling.

Cancelled terminals (``req_cancelled``) contribute to the latency
sketches but are EXCLUDED from good/bad classification: a client
hanging up is not server unavailability, and counting it either way
would let clients spend (or launder) the error budget.

Client-visible rejects (``req_rejected`` with ``fleet=True``, or with
no replica tag — a single-loop deployment) ARE availability-bad: a 429
the fleet could not absorb burns budget, which is how an injected
``reject_storm`` covering every replica trips ``fast_burn``. Internal
replica-tagged refusals the router spills to a peer are not counted —
the request may still succeed elsewhere.

Pure stdlib + host-side.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from pretraining_llm_tpu_torch.observability.sketches import (
    DigestSketch,
    WindowedCounts,
    WindowedSketch,
)

# Latency fields lifted off terminal events into sketches. The queue age
# is the admission-to-dispatch wait the engine already measures as
# queue_wait_s.
LATENCY_METRICS = ("ttft_s", "tpot_s", "e2e_s", "queue_wait_s")

# Terminal kinds. Availability counts done vs expired/error; cancelled
# is sketched but not classified (see module docstring).
TERMINAL_KINDS = ("req_done", "req_expired", "req_error", "req_cancelled")
_CLASSIFIED_KINDS = ("req_done", "req_expired", "req_error")

# Client-visible rejects burn availability budget too: a 429 the fleet
# could not absorb is unavailability from the caller's seat (this is
# what makes an injected reject_storm trip the fast-burn rule). A
# replica-tagged reject WITHOUT the fleet flag is an internal refusal
# the router spills to a peer — the request may still succeed, so only
# the router's fleet-level reject (or a single-loop reject, which has
# no replica tag) counts.
_REJECT_KIND = "req_rejected"


@dataclass(frozen=True)
class SLOObjective:
    """One measurable promise inside an SLO class.

    ``metric`` is a latency field name (threshold_s applies) or
    ``"availability"`` (a non-done terminal is bad, threshold ignored).
    """

    metric: str
    target: float  # fraction of eligible events that must be good
    threshold_s: float = 0.0

    def __post_init__(self) -> None:
        if self.metric not in LATENCY_METRICS + ("availability",):
            raise ValueError(
                f"unknown SLO metric {self.metric!r}; expected one of "
                f"{LATENCY_METRICS + ('availability',)}"
            )
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target must be in (0, 1), got {self.target}"
            )
        if self.metric != "availability" and self.threshold_s <= 0:
            raise ValueError(
                f"latency objective {self.metric} needs threshold_s > 0"
            )


@dataclass(frozen=True)
class BurnRateRule:
    """Fire when burn >= threshold over BOTH windows (short <= long)."""

    name: str
    short_s: float
    long_s: float
    threshold: float
    severity: str = "page"

    def __post_init__(self) -> None:
        if not 0 < self.short_s <= self.long_s:
            raise ValueError(
                f"need 0 < short_s <= long_s, got "
                f"short_s={self.short_s} long_s={self.long_s}"
            )
        if self.threshold <= 1.0:
            raise ValueError(
                f"threshold must be > 1 (1.0 = exactly on budget), got "
                f"{self.threshold}"
            )


# The classic SRE pairing, scaled to serving-test time horizons by the
# caller via ``window_scale`` on SLOEngine (production keeps the
# defaults; a test passes a small scale and a fake clock).
DEFAULT_RULES = (
    BurnRateRule("fast_burn", short_s=60.0, long_s=300.0,
                 threshold=14.0, severity="page"),
    BurnRateRule("slow_burn", short_s=300.0, long_s=3600.0,
                 threshold=3.0, severity="ticket"),
)


@dataclass(frozen=True)
class SLOClass:
    """A named bundle of objectives sharing one error budget."""

    name: str
    objectives: Tuple[SLOObjective, ...]
    rules: Tuple[BurnRateRule, ...] = DEFAULT_RULES

    def __post_init__(self) -> None:
        if not self.objectives:
            raise ValueError(f"SLO class {self.name!r} has no objectives")

    @property
    def target(self) -> float:
        """The class target is the strictest objective's."""
        return max(o.target for o in self.objectives)

    @property
    def budget(self) -> float:
        """Error budget: tolerated bad fraction (1 - target)."""
        return 1.0 - self.target


def default_slo_classes(
    *,
    ttft_s: float = 2.0,
    e2e_s: float = 30.0,
    target: float = 0.99,
) -> Tuple[SLOClass, ...]:
    """The out-of-the-box class serve.py installs: interactive traffic
    promised a TTFT and e2e bound plus availability at ``target``."""
    return (
        SLOClass(
            "interactive",
            objectives=(
                SLOObjective("availability", target=target),
                SLOObjective("ttft_s", target=target, threshold_s=ttft_s),
                SLOObjective("e2e_s", target=target, threshold_s=e2e_s),
            ),
        ),
    )


class SLOEngine:
    """Bus subscriber maintaining sketches, budgets, and alerts."""

    def __init__(
        self,
        *,
        classes: Optional[Sequence[SLOClass]] = None,
        bus: Optional[Any] = None,
        decisions: Optional[Any] = None,
        clock: Callable[[], float] = time.monotonic,
        window_s: float = 60.0,
        window_buckets: int = 6,
        compression: int = 64,
        window_scale: float = 1.0,
    ) -> None:
        """``window_s`` sizes the latency sketches; ``window_scale``
        multiplies every rule's short/long window (tests shrink hours to
        seconds without redefining the rules). ``bus`` is subscribed to
        immediately when given; alerts are emitted back into the SAME
        bus (emit is re-entrant: subscribers run outside its lock)."""
        if window_scale <= 0:
            raise ValueError(f"window_scale must be > 0, got {window_scale}")
        self.classes: Tuple[SLOClass, ...] = tuple(
            classes if classes is not None else default_slo_classes()
        )
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO class names: {names}")
        self.bus = bus
        self.decisions = decisions
        self._clock = clock
        self.window_s = float(window_s)
        self.window_scale = float(window_scale)
        self._lock = threading.Lock()

        def make_windowed() -> Dict[str, WindowedSketch]:
            return {
                m: WindowedSketch(
                    window_s=self.window_s,
                    buckets=window_buckets,
                    compression=compression,
                    clock=clock,
                )
                for m in LATENCY_METRICS
            }

        self._make_windowed = make_windowed
        self._fleet = make_windowed()
        self._per_replica: Dict[int, Dict[str, WindowedSketch]] = {}

        # One counts ring per class, bucketed at the finest rule window
        # (quartered so a "short" window spans >= 4 buckets and rotates
        # smoothly), horizoned at the coarsest.
        self._counts: Dict[str, WindowedCounts] = {}
        for cls in self.classes:
            scaled = [
                (r.short_s * self.window_scale, r.long_s * self.window_scale)
                for r in cls.rules
            ] or [(self.window_s, self.window_s)]
            finest = min(s for s, _ in scaled)
            horizon = max(l for _, l in scaled)
            self._counts[cls.name] = WindowedCounts(
                horizon_s=max(horizon, finest),
                bucket_s=max(finest / 4.0, 1e-9),
                clock=clock,
            )

        # Alert state: (class, rule) -> firing record; plus a bounded
        # history tail and lifetime counters for /slo + metrics.
        self._active: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._history: List[Dict[str, Any]] = []
        self._alert_seq = 0
        self.alerts_fired = 0
        self.events_seen = 0

        if bus is not None:
            bus.subscribe(self.observe)

    # -- ingest -------------------------------------------------------

    def observe(self, record: Dict[str, Any]) -> None:
        """Bus subscriber: terminal req events feed sketches + budgets."""
        kind = record.get("event")
        if kind == _REJECT_KIND:
            if record.get("fleet") or "replica" not in record:
                self._observe_reject(record)
            return
        if kind not in TERMINAL_KINDS:
            return
        replica = record.get("replica")
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            self.events_seen += 1
            for metric in LATENCY_METRICS:
                val = record.get(metric)
                if isinstance(val, (int, float)):
                    self._fleet[metric].observe(float(val))
                    if replica is not None:
                        per = self._per_replica.get(int(replica))
                        if per is None:
                            per = self._per_replica[int(replica)] = (
                                self._make_windowed()
                            )
                        per[metric].observe(float(val))
            if kind in _CLASSIFIED_KINDS:
                for cls in self.classes:
                    bad_objective = self._classify_locked(cls, kind, record)
                    counts = self._counts[cls.name]
                    counts.add("events")
                    if bad_objective is not None:
                        counts.add("bad")
                        counts.add(f"bad_{bad_objective}")
                transitions = self._evaluate_locked(record)
        # Emission happens OUTSIDE the lock: the bus will call us back
        # re-entrantly for the slo_alert event we emit.
        for rec in transitions:
            self._announce(rec)

    def _observe_reject(self, record: Dict[str, Any]) -> None:
        """A client-visible 429: availability-bad for every class that
        promises availability; no latency fields to sketch."""
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            self.events_seen += 1
            for cls in self.classes:
                if not any(
                    o.metric == "availability" for o in cls.objectives
                ):
                    continue
                counts = self._counts[cls.name]
                counts.add("events")
                counts.add("bad")
                counts.add("bad_availability")
            transitions = self._evaluate_locked(record)
        for rec in transitions:
            self._announce(rec)

    @staticmethod
    def _classify_locked(
        cls: SLOClass, kind: str, record: Dict[str, Any]
    ) -> Optional[str]:
        """First violated objective's metric name, or None when good."""
        for obj in cls.objectives:
            if obj.metric == "availability":
                if kind != "req_done":
                    return "availability"
            else:
                val = record.get(obj.metric)
                if isinstance(val, (int, float)) and val > obj.threshold_s:
                    return obj.metric
        return None

    # -- burn-rate evaluation -----------------------------------------

    def _burn(
        self, counts: WindowedCounts, budget: float, last_s: float
    ) -> Tuple[float, float, float]:
        """(burn_rate, bad, events) over the trailing window."""
        sums = counts.sums(last_s)
        events = sums.get("events", 0.0)
        bad = sums.get("bad", 0.0)
        if events <= 0:
            return 0.0, bad, events
        return (bad / events) / budget, bad, events

    def _evaluate_locked(
        self, record: Dict[str, Any]
    ) -> List[Dict[str, Any]]:
        """Recompute every rule; return fire/resolve transition records."""
        now = self._clock()
        out: List[Dict[str, Any]] = []
        for cls in self.classes:
            counts = self._counts[cls.name]
            for rule in cls.rules:
                short_s = rule.short_s * self.window_scale
                long_s = rule.long_s * self.window_scale
                burn_short, bad_s, ev_s = self._burn(
                    counts, cls.budget, short_s
                )
                burn_long, bad_l, ev_l = self._burn(
                    counts, cls.budget, long_s
                )
                firing = (
                    burn_short >= rule.threshold
                    and burn_long >= rule.threshold
                )
                key = (cls.name, rule.name)
                active = self._active.get(key)
                if firing and active is None:
                    self._alert_seq += 1
                    self.alerts_fired += 1
                    alert = {
                        "alert_id": f"slo-{self._alert_seq}",
                        "state": "firing",
                        "slo_class": cls.name,
                        "rule": rule.name,
                        "severity": rule.severity,
                        "threshold": rule.threshold,
                        "burn_short": round(burn_short, 4),
                        "burn_long": round(burn_long, 4),
                        "window_short_s": short_s,
                        "window_long_s": long_s,
                        "bad_short": bad_s,
                        "events_short": ev_s,
                        "bad_long": bad_l,
                        "events_long": ev_l,
                        "budget": cls.budget,
                        "t_fired_s": now,
                    }
                    # The event that tipped the burn over: its trace_id
                    # (when present) is the alert->request lineage.
                    tid = record.get("trace_id")
                    if tid:
                        alert["trigger_trace_id"] = tid
                    if record.get("replica") is not None:
                        alert["trigger_replica"] = record["replica"]
                    self._active[key] = alert
                    self._push_history_locked(alert)
                    out.append(dict(alert))
                elif not firing and active is not None:
                    resolved = {
                        "alert_id": active["alert_id"],
                        "state": "resolved",
                        "slo_class": cls.name,
                        "rule": rule.name,
                        "severity": rule.severity,
                        "threshold": rule.threshold,
                        "burn_short": round(burn_short, 4),
                        "burn_long": round(burn_long, 4),
                        "t_fired_s": active["t_fired_s"],
                        "t_resolved_s": now,
                        "dur_s": now - active["t_fired_s"],
                    }
                    del self._active[key]
                    self._push_history_locked(resolved)
                    out.append(resolved)
        return out

    def _push_history_locked(self, rec: Dict[str, Any]) -> None:
        self._history.append(dict(rec))
        if len(self._history) > 256:
            del self._history[: len(self._history) - 256]

    def _announce(self, rec: Dict[str, Any]) -> None:
        if self.bus is not None:
            self.bus.emit("slo_alert", **rec)
        if self.decisions is not None and rec["state"] == "firing":
            self.decisions.record(
                "slo_alert",
                trace_id=rec.get("trigger_trace_id"),
                alert_id=rec["alert_id"],
                slo_class=rec["slo_class"],
                rule=rec["rule"],
                severity=rec["severity"],
                burn_short=rec["burn_short"],
                burn_long=rec["burn_long"],
                threshold=rec["threshold"],
            )

    # -- evaluation without traffic -----------------------------------

    def tick(self) -> List[Dict[str, Any]]:
        """Clock-driven re-evaluation (resolves alerts when traffic
        stops arriving; serve.py calls it from the health loop). Returns
        the transition records it announced."""
        with self._lock:
            transitions = self._evaluate_locked({})
        for rec in transitions:
            self._announce(rec)
        return transitions

    # -- surfaces -----------------------------------------------------

    def merged_sketch(self, metric: str) -> DigestSketch:
        with self._lock:
            return self._fleet[metric].merged()

    def snapshot(self) -> Dict[str, Any]:
        """The GET /slo body: distributions, budgets, alerts.

        Ticks first so a poller sees alerts resolve even when traffic
        has stopped arriving (no separate health thread required).
        """
        self.tick()
        with self._lock:
            now = self._clock()
            latency: Dict[str, Any] = {
                "fleet": {
                    m: self._fleet[m].summary() for m in LATENCY_METRICS
                },
                "replicas": {
                    str(i): {m: per[m].summary() for m in LATENCY_METRICS}
                    for i, per in sorted(self._per_replica.items())
                },
            }
            classes: Dict[str, Any] = {}
            for cls in self.classes:
                counts = self._counts[cls.name]
                totals = dict(counts.totals)
                events = totals.get("events", 0.0)
                bad = totals.get("bad", 0.0)
                bad_frac = bad / events if events else 0.0
                burn: Dict[str, Any] = {}
                for rule in cls.rules:
                    short_s = rule.short_s * self.window_scale
                    long_s = rule.long_s * self.window_scale
                    bs, _, _ = self._burn(counts, cls.budget, short_s)
                    bl, _, _ = self._burn(counts, cls.budget, long_s)
                    burn[rule.name] = {
                        "short": round(bs, 4),
                        "long": round(bl, 4),
                        "threshold": rule.threshold,
                        "window_short_s": short_s,
                        "window_long_s": long_s,
                        "firing": (cls.name, rule.name) in self._active,
                    }
                classes[cls.name] = {
                    "target": cls.target,
                    "budget": cls.budget,
                    "objectives": [
                        {
                            "metric": o.metric,
                            "target": o.target,
                            **(
                                {"threshold_s": o.threshold_s}
                                if o.metric != "availability" else {}
                            ),
                        }
                        for o in cls.objectives
                    ],
                    "events": int(events),
                    "bad": int(bad),
                    "bad_frac": round(bad_frac, 6),
                    "budget_spent_frac": round(
                        min(1.0, bad_frac / cls.budget), 6
                    ) if cls.budget else 1.0,
                    "bad_by_objective": {
                        k[len("bad_"):]: int(v)
                        for k, v in sorted(totals.items())
                        if k.startswith("bad_")
                    },
                    "burn": burn,
                }
            return {
                "t_mono": now,
                "window_s": self.window_s,
                "events_seen": self.events_seen,
                "latency": latency,
                "classes": classes,
                "alerts": {
                    "active": [dict(a) for a in self._active.values()],
                    "fired_total": self.alerts_fired,
                    "history_tail": [dict(r) for r in self._history[-32:]],
                },
            }
