"""One restartable engine replica: engine factory + EngineLoop + identity
(the JAX package's ``frontend/replica.py``).

A ``Replica`` is the unit the fleet router schedules over: it owns an
engine built by ``engine_factory`` (so a crashed replica can be relaunched
with a FRESH engine — same supervisor semantics as the training side's
relaunch-from-checkpoint, except serving state is the requests themselves
and the router redrives those), the ``EngineLoop`` driving it, its own
per-replica ``AdmissionController`` (the replica budget; the router holds
the fleet budget), and its own ``MetricsRegistry`` carrying a constant
``replica`` label so N replicas share one metric vocabulary without
stomping each other (observability.metrics.render_merged joins them).

Lifecycle states (the ``replica_state`` event/gauge vocabulary):

  active    accepting and serving traffic;
  draining  alive but refusing new work (rolling restart: the router
            redrives its in-flight requests, then stops the loop);
  ejected   declared dead/wedged by the router's health loop; relaunch is
            scheduled with exponential backoff.

Observability: the replica wraps the shared fleet EventBus in a tagging
proxy that stamps ``replica=i`` onto every event the EngineLoop emits, so
per-replica ``req_*``/``cap_window``/``decision`` streams interleave in one
JSONL and obs_report --fleet can attribute them without new emit sites.

Fault injection: when a ``ServingFaultInjector`` is attached, accepted
submissions feed its request-count clock and ``engine.pipeline_tick`` is
shadowed by its shim (an instance attribute over the class method — the
same trick the throttle tests use), so ``replica_crash@req_n`` style plans
fire deterministically under a seeded load schedule.

Device memory: a relaunch drops every reference the replica holds to the
dead engine (its loop, the injector's handle) and collects the reference
cycles an engine failure leaves (the exception's traceback frames hold
the engine), so the dead engine's pools are freed before the fresh engine
allocates its own. Replicas of one process share the parameter tensors
their factory closes over.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Callable, Dict, Optional

from pretraining_llm_tpu_torch.frontend.admission import (
    AdmissionController,
    RejectedBusy,
)
from pretraining_llm_tpu_torch.frontend.engine_loop import (
    _TRACE_UNSET,
    EngineLoop,
    FrontendRequest,
)
from pretraining_llm_tpu_torch.frontend import kv_transfer
from pretraining_llm_tpu_torch.observability.metrics import MetricsRegistry

REPLICA_STATES = ("active", "draining", "ejected")

# Disaggregation roles: what traffic the router may place here.
#   both     the classic colocated replica (prefill + decode);
#   decode   serves client requests, receives migrated KV pages;
#   prefill  dedicated prefill tier — computes prompts (max_new=1 legs
#            via the direct loop lane) and ships the published pages;
#            the router never routes client decode traffic to it.
REPLICA_ROLES = ("prefill", "decode", "both")

# Gauge encoding for the typed ``replica_state`` metric: chosen so "is it
# taking traffic" is a simple ``== 1`` and alerting thresholds are stable.
REPLICA_STATE_VALUES = {"ejected": 0.0, "active": 1.0, "draining": 2.0}


class ReplicaUnavailable(Exception):
    """The replica is not accepting work (draining, ejected, or stopped);
    the router treats this as 'pick another replica', never a client
    error."""


class _TaggedBus:
    """EventBus proxy stamping ``replica=i`` on every emit. The EngineLoop
    keeps its single ``self.bus`` attribute and zero fleet knowledge."""

    def __init__(self, inner: Any, replica: int) -> None:
        self._inner = inner
        self.replica = int(replica)

    def emit(self, kind: str, *, step: Optional[int] = None, **fields: Any) -> Any:
        fields.setdefault("replica", self.replica)
        return self._inner.emit(kind, step=step, **fields)

    def subscribe(self, fn: Any) -> None:
        self._inner.subscribe(fn)

    def close(self) -> None:
        # The fleet bus outlives any one replica; closing is the owner's job.
        pass


class Replica:
    """See module docstring. ``engine_factory`` is called once per
    (re)launch and must return a fresh ServingEngine-compatible object;
    ``admission_factory(registry)`` likewise returns the replica's own
    AdmissionController (None = no per-replica admission).

    ``on_state(replica, state, reason)`` is the router's hook for keeping
    the fleet's typed ``replica_state`` gauge in step with transitions
    this object performs itself (start/drain/eject/relaunch).
    """

    def __init__(
        self,
        index: int,
        engine_factory: Callable[[], Any],
        *,
        bus: Any = None,
        tracer: Any = None,
        registry_prefix: str = "pllm_serving_",
        registry_labels: Optional[Dict[str, Any]] = None,
        admission_factory: Optional[Callable[[Any], AdmissionController]] = None,
        fault_injector: Any = None,
        clock: Any = time.monotonic,
        loop_kwargs: Optional[Dict[str, Any]] = None,
        role: str = "both",
    ) -> None:
        if role not in REPLICA_ROLES:
            raise ValueError(
                f"role must be one of {REPLICA_ROLES}, got {role!r}"
            )
        self.role = role
        self.index = int(index)
        self._engine_factory = engine_factory
        self._bus = bus
        self._tracer = tracer
        self._admission_factory = admission_factory
        self.faults = fault_injector
        self._clock = clock
        self._loop_kwargs = dict(loop_kwargs or {})
        # One registry per replica, same names fleet-wide, distinguished by
        # the constant label; survives relaunches so counters stay totals.
        # ``registry_labels`` carries fleet-wide constant labels (e.g. the
        # quant_dtype the whole fleet serves at); the replica index wins
        # any collision because it is what tells the series apart.
        self.registry = MetricsRegistry(
            registry_prefix,
            const_labels={**(registry_labels or {}), "replica": self.index},
        )
        self.state = "ejected"  # not launched yet; start() flips to active
        self.generation = 0     # bumped per (re)launch
        self.submits = 0        # accepted submissions (the fault clock)
        self.on_state: Optional[Callable[["Replica", str, str], None]] = None
        self._lock = threading.Lock()
        self.engine: Any = None
        self.admission: Optional[AdmissionController] = None
        self.loop: Optional[EngineLoop] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Replica":
        with self._lock:
            self._launch_locked("start")
        return self

    def relaunch(
        self, *, stop_timeout: float = 1.0, hold: bool = False
    ) -> "Replica":
        """Replace a dead/wedged/drained engine with a fresh one. The old
        loop is stopped best-effort (a wedged thread is abandoned — it is
        a daemon and EngineLoop.stop already failed its requests).

        ``hold=True`` parks the fresh engine in "draining" WITHOUT
        draining the loop: it accepts direct ``loop.submit`` work (the
        probe-vetting lane) but the router will not route traffic to it
        and the health loop leaves it alone — the rolling-upgrade
        vetting window. ``activate()`` promotes it."""
        with self._lock:
            old = self.loop
            if old is not None:
                try:
                    old.stop(timeout=stop_timeout)
                except Exception:
                    pass
            old = None  # the dead engine must be collectable at launch
            self._launch_locked("relaunch", hold=hold)
        return self

    def activate(self, reason: str = "activate") -> None:
        """Promote a held (vetting) replica to traffic-eligible."""
        with self._lock:
            self._set_state("active", reason)

    # -- live weight upgrades ------------------------------------------------

    def update_snapshot(self) -> Callable[[], Any]:
        """The current engine factory — hold this to roll an upgrade
        back (the process-mode twin snapshots the worker spec)."""
        return self._engine_factory

    def apply_update(
        self, update: Optional[Callable[[], Any]], *, replace: bool = False
    ) -> None:
        """Swap the engine factory (e.g. one closing over a new
        checkpoint's params); takes effect at the next (re)launch.
        ``None`` means relaunch-as-is. A factory is already a complete
        replacement, so ``replace`` (which process-mode spec patches
        need for rollback) changes nothing here."""
        if update is None:
            return
        with self._lock:
            self._engine_factory = update

    def _launch_locked(self, reason: str, hold: bool = False) -> None:
        if self.engine is not None:
            # A wedged loop thread keeps its engine alive whatever we drop;
            # a stopped or crashed one is released here.
            self.engine = self.admission = self.loop = None
            if self.faults is not None:
                self.faults.attach_engine(self.index, None)
            gc.collect()
        engine = self._engine_factory()
        if self.faults is not None:
            engine.pipeline_tick = self.faults.wrap_tick(
                self.index, engine.pipeline_tick
            )
            # Corruption faults (corrupt_kv_page/corrupt_weights/wrong_token)
            # mutate engine state directly; re-attached on every relaunch so
            # the injector never fires into a stopped engine's generation.
            self.faults.attach_engine(self.index, engine)
        admission = (
            self._admission_factory(self.registry)
            if self._admission_factory is not None
            else None
        )
        bus = _TaggedBus(self._bus, self.index) if self._bus is not None else None
        self.engine = engine
        self.admission = admission
        self.loop = EngineLoop(
            engine,
            admission=admission,
            bus=bus,
            tracer=self._tracer,
            registry=self.registry,
            clock=self._clock,
            **self._loop_kwargs,
        )
        self.loop.start()
        self.generation += 1
        self._set_state("draining" if hold else "active", reason)

    def drain(self) -> None:
        """Refuse new work; in-flight requests keep decoding (the router
        redrives them, then calls stop())."""
        with self._lock:
            if self.loop is not None:
                self.loop.begin_drain()
            self._set_state("draining", "drain")

    def eject(self, reason: str) -> None:
        """Router verdict: dead or wedged. Routing stops immediately; the
        loop (possibly a wedged daemon thread) is left to stop()/relaunch."""
        with self._lock:
            self._set_state("ejected", reason)

    def stop(self, timeout: float = 5.0) -> bool:
        """Stop the loop (outstanding requests get error terminals — see
        EngineLoop.stop). Returns False when the loop thread had to be
        abandoned wedged."""
        loop = self.loop
        if loop is None:
            return True
        return loop.stop(timeout=timeout)

    def _set_state(self, state: str, reason: str) -> None:
        assert state in REPLICA_STATES, state
        self.state = state
        if self._bus is not None:
            self._bus.emit(
                "replica_state", replica=self.index, state=state,
                reason=reason, generation=self.generation,
            )
        if self.on_state is not None:
            self.on_state(self, state, reason)

    # -- traffic ------------------------------------------------------------

    @property
    def accepting(self) -> bool:
        loop = self.loop
        return self.state == "active" and loop is not None and loop.running

    @property
    def alive(self) -> bool:
        loop = self.loop
        return loop is not None and loop.running

    def load(self) -> int:
        """Requests in this replica's system (inbox + engine), the spill
        signal for affinity routing."""
        loop = self.loop
        return loop.active_requests if loop is not None else 0

    def submit(
        self,
        prompt: Any,
        max_new_tokens: int,
        *,
        deadline_s: Optional[float] = None,
        trace: Any = _TRACE_UNSET,
        traceparent: Optional[str] = None,
        priority: int = 0,
    ) -> FrontendRequest:
        """Submit through the replica: availability gate, injected
        reject_storm gate, then the loop (validation + replica admission).

        ``traceparent`` exists for signature parity with RemoteReplica
        (the router hands every attempt both the trace object and its
        wire form) and is ignored here: an in-process replica records
        straight into the shared recorder through ``trace`` — there is
        no process boundary to carry a header across.
        The fault clock counts ACCEPTED submissions and arms only after
        the loop took the request, so an armed crash always fires with
        its triggering request in flight — the redrive path, not just
        routing, is what the drill exercises."""
        with self._lock:
            if not self.accepting:
                raise ReplicaUnavailable(
                    f"replica {self.index} is {self.state}"
                )
            if self.faults is not None and self.faults.should_reject(self.index):
                retry = (
                    self.admission.retry_after_s
                    if self.admission is not None else 1.0
                )
                raise RejectedBusy(
                    f"replica {self.index} refusing (injected reject_storm)",
                    retry,
                )
            req = self.loop.submit(
                prompt, max_new_tokens, deadline_s=deadline_s, trace=trace,
                priority=priority,
            )
            self.submits += 1
            nth = self.submits
        if self.faults is not None:
            self.faults.on_submit(self.index, nth)
        return req

    # -- KV-page migration (frontend/kv_transfer.py) ------------------------

    @property
    def kv_capable(self) -> bool:
        """Whether this replica can send/receive migrated KV pages: it
        needs a live engine with a prefix cache (the publish path the
        pages enter and leave through)."""
        eng = self.engine
        return (
            self.alive
            and eng is not None
            and getattr(eng, "prefix_cache", None) is not None
        )

    def fetch_kv_pages(
        self,
        prompt: Any,
        *,
        max_pages: Optional[int] = None,
        timeout: float = 30.0,
    ) -> Optional[Dict[str, Any]]:
        """Serialize the longest cached chain covering ``prompt`` from
        this replica's pool; None when nothing is cached. Round-trips
        through the frame codec even in-process so both fleet modes
        exercise the one serialization path the wire uses."""
        eng = self.engine
        if eng is None or not self.alive:
            return None
        xfer = kv_transfer.snapshot_chain(eng, prompt, max_pages=max_pages)
        if xfer is None:
            return None
        return kv_transfer.join_frames(kv_transfer.split_frames(xfer))

    def push_kv_pages(
        self, xfer: Dict[str, Any], *, timeout: float = 30.0
    ) -> Optional[Dict[str, Any]]:
        """Adopt migrated pages into this replica's pool (loop-thread
        insertion via run_on_loop). Returns adopt_chain's summary, or
        None when the replica cannot take pages right now. An armed
        ``corrupt_kv_migration`` fault flips bytes in the transfer
        in flight, exactly like the wire-level drill."""
        loop = self.loop
        if loop is None or not self.alive:
            return None
        take = getattr(self.faults, "take_kv_corruption", None)
        if take is not None and take(self.index):
            kv_transfer.corrupt_first_page(xfer)
            if self._bus is not None:
                self._bus.emit(
                    "fault_fired",
                    fault="corrupt_kv_migration",
                    replica=self.index,
                )
        eng = self.engine
        try:
            return loop.run_on_loop(
                lambda: kv_transfer.adopt_chain(eng, xfer), timeout=timeout
            )
        except (RuntimeError, TimeoutError):
            return None

    # -- introspection ------------------------------------------------------

    def debug_snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "replica": self.index,
            "state": self.state,
            "role": self.role,
            "generation": self.generation,
            "submits": self.submits,
            "alive": self.alive,
        }
        loop = self.loop
        if loop is not None:
            out["draining"] = loop.draining
            out["last_turn_age_s"] = round(loop.last_turn_age_s(), 6)
            out["active_requests"] = loop.active_requests
            if loop.failure is not None:
                out["failure"] = repr(loop.failure)
        return out

    def health_pull(self) -> Dict[str, Any]:
        """Surface parity with RemoteReplica.health_pull: the same gauge
        shape assembled locally (no wire hop, no sketches — in-process
        events land on the router's bus directly, so the router-side SLO
        engine already holds this replica's distributions)."""
        out = self.debug_snapshot()
        loop = self.loop
        if loop is None or not self.alive:
            out["proto_fallback"] = True
            return out
        out["running"] = bool(loop.running)
        out["fence"] = 0  # in-process replicas are never fenced
        gauges: Dict[str, Any] = {}
        eng = self.engine
        hg = getattr(eng, "health_gauges", None) if eng is not None else None
        if hg is not None:
            gauges.update(hg())
        gauges["active_requests"] = int(loop.active_requests)
        if loop.admission is not None:
            adm = loop.admission.snapshot()
            gauges["admission_depth"] = int(adm.get("live_requests", 0))
            gauges["admission_outstanding_tokens"] = int(
                adm.get("outstanding_tokens", 0)
            )
        out["gauges"] = gauges
        try:
            from pretraining_llm_tpu_torch.observability.device import (
                DeviceTelemetry,
            )

            hbm = DeviceTelemetry(bus=None).sample()
        except Exception:
            hbm = {}
        if hbm:
            out["hbm"] = hbm
        return out
