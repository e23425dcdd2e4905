"""Capacity observability for the serving engine: where do decode-window
slots and KV-pool blocks actually go? (The JAX package's
``observability/capacity.py``.)

Two host-only instruments, both installed by the frontend (EngineLoop) and
both riding EXISTING sync points — the reap's wait for its window's event
is the only device pull on the decode hot path, and nothing here adds
another (tests/test_torch_port_capacity.py counts the reads):

``CapacitySampler``
    One occupancy record per reaped decode window: rows active vs. batch
    capacity, tokens committed vs. slot capacity (rows * steps), the pool
    split live / cold-cache / free, admission queue depth and outstanding-
    token budget, and host-blocked readback seconds. Records are plain
    host ints/floats, ring-buffered (bounded memory for long-lived
    servers), optionally emitted as ``cap_window`` run events, and
    mirrored into typed Gauges/Histograms on the metrics registry.

``DecisionLog``
    Every scheduler decision that costs a request something — admission
    reject (busy/infeasible), EWMA deadline shed, preemption (victim,
    why youngest-first chose it, blocks reclaimed), cold-cache eviction,
    spec-page reclaim, in-flight deadline expiry — becomes one typed
    record carrying ``trace_id`` so "why was trace X preempted/shed" is
    answerable offline by joining against the ``req_*`` event stream
    (``python -m pretraining_llm_tpu_torch.obs_report --capacity``).

Timestamps: records carry explicit ``time.perf_counter`` fields
(``t_dispatch_s``/``t_reap_s`` on windows, ``t_s`` on decisions) so the
offline waterfall does interval math on ONE clock; the bus's own
``t_mono``/``t_wall`` stamps are for cross-stream ordering only.

Thread safety: producers run on the engine/scheduling thread; the gateway
debug endpoints read ``tail()``/``counts`` from HTTP threads. A lock per
instrument covers the ring mutations; records themselves are immutable
once appended.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

# The decision vocabulary. obs_report --capacity labels segments and the
# strict CI gate joins these against traces, so producers keep to this
# list (mirrors EVENT_KINDS' role for run events).
DECISION_KINDS = (
    "reject_busy",        # admission: queue/budget full -> 429
    "reject_infeasible",  # admission: EWMA says deadline can't be met
    "preempt",            # pool dry: youngest victim recomputes on resume
    "evict_cold",         # cold prefix-cache blocks reclaimed for a live row
    "reclaim_spec",       # speculative page grants rolled back under pressure
    "expire_inflight",    # deadline passed mid-decode -> cancelled (504)
    "defer_prefill_chunk",  # chunk budget spent this tick; prompt waits a window

    # Fleet-tier decisions (frontend/router.py): each costs a request a
    # retry, a re-prefill, or its slot, so they live in the same ledger.
    "eject_replica",      # router declared a replica dead/wedged and stopped routing to it
    "redrive",            # an in-flight request failed over to a surviving replica
    "brownout_shed",      # fleet degraded: low-priority work shed at the router
    "fleet_drain",        # graceful shutdown: router stopped admitting (503s)
    "upgrade_refused",    # rolling upgrade failed probe vetting; rolled back

    # Output-integrity sentinel (resilience/integrity.py): a quarantine
    # costs every in-flight request on the replica a redrive, and a
    # dropped cache block costs its next hit a private re-prefill.
    "quarantine",          # sentinel pulled a divergent replica from service
    "drop_corrupt_block",  # cached KV block failed verify-on-acquire; dropped

    # Disaggregated prefill/decode (frontend/kv_transfer.py): migrating
    # a prefix's KV pages saves the decode tier that prefill; a rejected
    # page costs only a re-prefill, never a wrong token.
    "kv_migrate",           # prefill-tier pages pushed to a decode worker
    "kv_migration_reject",  # decode worker refused migrated pages (checksum/capacity/fence)

    # Live SLO engine (observability/slo.py): a fired burn-rate alert is
    # a decision — it is what an autoscaler or operator acts on — and
    # the record's alert_id joins it to the slo_alert event pair that
    # brackets the incident (trace_id, when present, is the request
    # that tipped the burn over threshold).
    "slo_alert",          # burn-rate alert fired: alert_id, slo_class, rule
)


class DecisionLog:
    """Bounded, typed log of scheduler decisions.

    ``record()`` appends one immutable dict to a ring buffer, bumps the
    per-kind count (counts survive ring eviction — they are the totals),
    and emits a ``decision`` run event when a bus is attached.
    """

    def __init__(self, maxlen: int = 256, bus: Optional[Any] = None) -> None:
        if maxlen < 1:
            raise ValueError(f"DecisionLog maxlen must be >= 1, got {maxlen}")
        self._ring: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.bus = bus
        self.counts: Dict[str, int] = {}

    def record(
        self,
        kind: str,
        *,
        rid: Optional[int] = None,
        trace_id: Optional[str] = None,
        **fields: Any,
    ) -> Dict[str, Any]:
        if kind not in DECISION_KINDS:
            raise ValueError(
                f"unknown decision kind {kind!r}; expected one of "
                f"{DECISION_KINDS}"
            )
        rec: Dict[str, Any] = {"decision": kind, "t_s": time.perf_counter()}
        if rid is not None:
            rec["rid"] = int(rid)
        if trace_id:
            rec["trace_id"] = trace_id
        rec.update(fields)
        with self._lock:
            self._ring.append(rec)
            self.counts[kind] = self.counts.get(kind, 0) + 1
        if self.bus is not None:
            self.bus.emit("decision", **rec)
        return rec

    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._ring)
        return items if n is None else items[-n:]

    def counts_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)


class CapacitySampler:
    """Per-window occupancy accounting, sampled at the reap sync point.

    The engine calls ``observe_window()`` once per reaped window with
    values it ALREADY holds on the host (row count, committed-token delta,
    allocator free count, queue depth) — no device access, no new syncs.
    """

    def __init__(
        self,
        rows_capacity: int,
        pool_total: int,
        *,
        maxlen: int = 512,
        bus: Optional[Any] = None,
        admission_snapshot_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        pool_layout: Optional[Dict[str, Any]] = None,
    ) -> None:
        if maxlen < 1:
            raise ValueError(
                f"CapacitySampler maxlen must be >= 1, got {maxlen}"
            )
        self.rows_capacity = int(rows_capacity)
        self.pool_total = int(pool_total)
        # Static pool byte/dtype identity (ServingEngine.pool_info()):
        # block COUNTS alone can't be compared across quantize modes — the
        # same HBM budget holds ~2x the int8-kv blocks — so every window
        # record carries the dtype and bytes-per-block it was sampled
        # under, and the offline waterfall can normalize to bytes.
        self.pool_layout = dict(pool_layout or {})
        self._ring: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.bus = bus
        # Injected by the frontend: () -> AdmissionController.snapshot().
        # Optional so the offline engine can sample without a frontend.
        self.admission_snapshot_fn = admission_snapshot_fn
        self.windows_sampled = 0
        # Typed series, bound via bind(); None until a registry exists.
        self._g_rows = None
        self._g_waiting = None
        self._g_pool: Dict[str, Any] = {}
        self._g_adm_depth = None
        self._g_adm_tokens = None
        self._h_occupancy = None
        self._h_slot_util = None

    def bind(self, registry: Any) -> None:
        """Create the cap_* typed series on ``registry`` and keep handles.
        Idempotent per registry (the registry dedupes by name+labels)."""
        self._g_rows = registry.gauge(
            "capacity_rows_active", "decode rows active at last reap"
        )
        registry.gauge(
            "capacity_rows_limit", "decode row slots (max_batch)"
        ).set(self.rows_capacity)
        self._g_waiting = registry.gauge(
            "capacity_waiting_requests",
            "requests queued in the engine awaiting a row",
        )
        for state in ("live", "cold", "free"):
            self._g_pool[state] = registry.gauge(
                "capacity_pool_blocks",
                "KV pool blocks by state at last reap",
                state=state,
            )
        registry.gauge(
            "capacity_pool_blocks_limit", "allocatable KV pool blocks"
        ).set(self.pool_total)
        self._h_occupancy = registry.histogram(
            "capacity_window_occupancy",
            "fraction of row slots active per reaped window",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
        )
        self._h_slot_util = registry.histogram(
            "capacity_slot_utilization",
            "tokens committed / slot capacity per reaped window",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
        )

    def observe_window(
        self,
        *,
        window: int,
        kind: str,
        t_dispatch_s: float,
        t_reap_s: float,
        steps: int,
        rows: int,
        tokens_committed: int,
        waiting: int,
        pool_free: int,
        pool_cold: int,
        host_blocked_s: float,
        cum_tokens: int,
        cum_prefill_tokens: int,
        cum_rework_prefill_tokens: int,
        cum_preemptions: int,
    ) -> Dict[str, Any]:
        pool_live = self.pool_total - pool_free - pool_cold
        slot_tokens = rows * steps
        rec: Dict[str, Any] = {
            "window": int(window),
            # "window_kind" not "kind": the bus reserves "kind" for the
            # event kind itself ("cap_window").
            "window_kind": kind,
            "t_dispatch_s": float(t_dispatch_s),
            "t_reap_s": float(t_reap_s),
            "dur_s": float(t_reap_s) - float(t_dispatch_s),
            "steps": int(steps),
            "rows": int(rows),
            "rows_capacity": self.rows_capacity,
            "slot_tokens": int(slot_tokens),
            "tokens_committed": int(tokens_committed),
            "waiting": int(waiting),
            "pool_free": int(pool_free),
            "pool_cold": int(pool_cold),
            "pool_live": int(pool_live),
            "pool_total": self.pool_total,
            "host_blocked_s": float(host_blocked_s),
            # Cumulative engine counters at this reap: the offline
            # waterfall diffs consecutive records to attribute gaps (e.g.
            # rework prefill between windows) without a second event kind.
            "cum_tokens": int(cum_tokens),
            "cum_prefill_tokens": int(cum_prefill_tokens),
            "cum_rework_prefill_tokens": int(cum_rework_prefill_tokens),
            "cum_preemptions": int(cum_preemptions),
        }
        if self.pool_layout:
            rec["kv_dtype"] = self.pool_layout.get("kv_dtype")
            rec["pool_bytes_per_block"] = self.pool_layout.get(
                "bytes_per_block"
            )
        if self.admission_snapshot_fn is not None:
            snap = self.admission_snapshot_fn()
            rec["admission_depth"] = int(snap.get("live_requests", 0))
            rec["admission_outstanding_tokens"] = int(
                snap.get("outstanding_tokens", 0)
            )
            if "max_queue_depth" in snap:
                rec["admission_depth_limit"] = int(snap["max_queue_depth"])
            if "max_outstanding_tokens" in snap:
                rec["admission_tokens_limit"] = int(
                    snap["max_outstanding_tokens"]
                )
        with self._lock:
            self._ring.append(rec)
            self.windows_sampled += 1
        if self._g_rows is not None:
            self._g_rows.set(rows)
            self._g_waiting.set(waiting)
            self._g_pool["live"].set(pool_live)
            self._g_pool["cold"].set(pool_cold)
            self._g_pool["free"].set(pool_free)
            self._h_occupancy.observe(
                rows / self.rows_capacity if self.rows_capacity else 0.0
            )
            self._h_slot_util.observe(
                tokens_committed / slot_tokens if slot_tokens else 0.0
            )
        if self.bus is not None:
            self.bus.emit("cap_window", **rec)
        return rec

    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._ring)
        return items if n is None else items[-n:]
