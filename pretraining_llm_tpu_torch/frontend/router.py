"""Fleet router: one serving surface over N engine replicas (the JAX
package's ``frontend/router.py``), in this process (``frontend/replica.py``)
or in worker processes (``frontend/remote_replica.py``).

The router duck-types the EngineLoop surface the gateway consumes
(``submit``/``cancel``/``metrics``/``last_turn_age_s``/``readiness``/
``debug_*``/``tracer``), so ``serve.py --replicas N`` swaps it in without
touching the HTTP layer. What it adds over a single loop:

Placement — prefix-affinity with spill. Requests route by rendezvous hash
of their prompt-prefix digest (first ``affinity_tokens`` tokens), so a hot
prefix keeps landing on the replica whose prefix cache already holds it;
when the affinity choice is ``spill_margin`` requests deeper than the
least-loaded healthy replica, load wins over affinity (a hot prefix must
not melt one replica while others idle).

Health — ejection with exponential backoff. The health thread watches each
active replica for a dead loop thread (engine crash) or a stale
``last_turn_age_s`` past ``wedged_after_s`` (the serving twin of the
training step watchdog: a wedged turn means a wedged device dispatch).
Either verdict ejects the replica (stops routing), schedules a relaunch
with doubling backoff, and redrives its work.

Redrive — the robustness core. Every router request owns its committed
token frontier (tokens already streamed to the client are never
retracted). When a replica crashes, hangs, or is drained, its queued AND
mid-decode requests fail over to survivors as ``prompt + committed_tokens``
with ``max_new`` reduced by what was delivered; greedy decoding makes the
continuation bit-identical to an undisturbed run, and the prefix cache
makes the re-prefill cheap (the dead replica's pages are gone, but shared
prefixes on survivors still hit). Failed-over requests keep their router
request id (``frid``) and fleet admission ticket; ``redrives_total`` and
per-request ``info["redrives"]`` account the cost.

Brownout — partial capacity sheds partially. When the healthy fraction
drops below ``brownout_min_healthy_frac``, the router sheds the work that
can best tolerate it — priority below ``brownout_min_priority``, or
deadline longer than ``brownout_max_deadline_s`` (longest-deadline work
has the most slack to retry later) — with 429 + Retry-After instead of
failing everything.

Lineage tracing — every client request is ONE trace tree across all its
placement attempts. The router owns the root span (``req.request``,
``finish_deferred`` keeps replica loops from closing it early) and mints
a child ``req.attempt`` span per placement, tagged (replica, fence
generation, redrive index, outcome). In-process attempts record their
engine spans straight into the shared recorder; remote attempts get a
``traceparent`` pointing at the attempt span, so the worker's local span
tree — shipped back in batched span-export frames and clock-aligned by
RemoteReplica — nests under it. Redrives and journal replays link into
the SAME tree: the journal's submit records carry ``trace_id``, so a
recovered router continues the original trace instead of minting an
orphan. The fleet event stream (``fleet_req_submit``/``redrive``/
``fleet_req_terminal`` keyed by ``frid``) remains the flat audit log the
trace tree is cross-checked against (obs_report --fleet-trace).
"""

from __future__ import annotations

import hashlib
import queue
import random
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

from pretraining_llm_tpu_torch.frontend import kv_transfer
from pretraining_llm_tpu_torch.frontend.admission import (
    AdmissionController,
    RejectedBusy,
    RejectedInfeasible,
    Ticket,
)
from pretraining_llm_tpu_torch.frontend.engine_loop import (
    _TRACE_UNSET,
    TERMINAL_STATUSES,
    FrontendRequest,
)
from pretraining_llm_tpu_torch.frontend.journal import FleetJournal
from pretraining_llm_tpu_torch.frontend.replica import (
    REPLICA_STATE_VALUES,
    Replica,
    ReplicaUnavailable,
)
from pretraining_llm_tpu_torch.observability.capacity import DecisionLog
from pretraining_llm_tpu_torch.observability.metrics import render_merged
from pretraining_llm_tpu_torch.observability.tracing import (
    RequestTrace,
    SpanContext,
    format_traceparent,
)


def prefix_digest(prompt: Any, n_tokens: int) -> bytes:
    """Stable digest of the routing prefix (first ``n_tokens`` ids)."""
    h = hashlib.blake2b(digest_size=8)
    for t in list(prompt)[:n_tokens]:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.digest()


def _rendezvous_score(digest: bytes, replica: int) -> int:
    h = hashlib.blake2b(
        digest + int(replica).to_bytes(4, "little"), digest_size=8
    )
    return int.from_bytes(h.digest(), "little")


class RouterRequest:
    """One request as the CLIENT sees it, stable across redrives: the
    stream surface mirrors FrontendRequest (``out_q`` carries
    ``("token", t)`` then one ``("end", status, info)``;
    ``events()``/``result()`` drain it), while ``_attempt`` — the current
    per-replica FrontendRequest — may be replaced under ``_lock`` when the
    router fails the request over."""

    def __init__(
        self,
        frid: int,
        prompt: List[int],
        max_new: int,
        *,
        deadline: Optional[float],
        submitted_s: float,
        priority: int = 0,
        ticket: Optional[Ticket] = None,
        trace: Any = None,
    ) -> None:
        self.frid = frid
        self.prompt = prompt
        self.max_new = max_new
        self.deadline = deadline  # absolute on the router clock, None = none
        self.submitted_s = submitted_s
        self.priority = priority
        self.ticket = ticket
        self.trace = trace
        self.out_q: "queue.Queue[Tuple]" = queue.Queue()
        self.status = "queued"
        self.tokens: List[int] = []  # committed frontier (streamed, final)
        self.info: Dict[str, Any] = {}
        self.cancel_requested = False
        self.redrives = 0
        self.replica: Optional[int] = None
        self._attempt: Optional[FrontendRequest] = None
        # Open placement-attempt span: (span_id, t0, replica, fence).
        # Spans are recorded at completion, so the router carries the
        # pre-minted id here until the attempt ends (terminal/redrive).
        self.attempt_span: Optional[Tuple[str, float, int, int]] = None
        self._lock = threading.Lock()

    def events(self, timeout: Optional[float] = None) -> Iterator[Tuple]:
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
        for _ in self.events(timeout=timeout):
            pass
        return self.status, self.tokens, self.info


class Router:
    """See module docstring. ``replicas`` are constructed outside (they
    carry the engine factories); the router starts/stops them with itself.

    ``admission`` is the FLEET budget (scope it with ``scope="fleet"`` on
    a shared registry); each replica's own controller still applies at its
    loop. ``registry`` holds the fleet-level typed series
    (``replica_state``, ``redrives_total``, brownout) and leads the merged
    exposition.
    """

    def __init__(
        self,
        replicas: List[Replica],
        *,
        admission: Optional[AdmissionController] = None,
        bus: Any = None,
        registry: Any = None,
        tracer: Any = None,
        clock: Any = time.monotonic,
        affinity_tokens: int = 32,
        spill_margin: int = 4,
        wedged_after_s: float = 0.0,
        eject_backoff_s: float = 0.5,
        eject_backoff_max_s: float = 8.0,
        backoff_jitter_frac: float = 0.25,
        backoff_seed: int = 0,
        redrive_max: int = 3,
        health_interval_s: float = 0.02,
        brownout_min_healthy_frac: float = 0.0,
        brownout_min_priority: int = 1,
        brownout_max_deadline_s: float = 0.0,
        probe_interval_s: float = 0.0,
        probe_count: int = 2,
        probe_max_new: int = 4,
        probe_timeout_s: float = 30.0,
        probe_set: Optional[List[Any]] = None,
        journal_path: str = "",
        journal_rotate_bytes: int = 0,
        recover: bool = False,
        kv_migrate_timeout_s: float = 30.0,
        kv_home_max: int = 4096,
        slo: Any = None,
    ) -> None:
        if not replicas:
            raise ValueError("Router needs at least one replica")
        if recover and not journal_path:
            raise ValueError("recover=True needs a journal_path")
        if journal_rotate_bytes < 0:
            raise ValueError(
                f"journal_rotate_bytes must be >= 0, got "
                f"{journal_rotate_bytes}"
            )
        if affinity_tokens < 1:
            raise ValueError(
                f"affinity_tokens must be >= 1, got {affinity_tokens}"
            )
        if spill_margin < 1:
            raise ValueError(f"spill_margin must be >= 1, got {spill_margin}")
        if redrive_max < 0:
            raise ValueError(f"redrive_max must be >= 0, got {redrive_max}")
        if not 0.0 <= brownout_min_healthy_frac <= 1.0:
            raise ValueError(
                f"brownout_min_healthy_frac must be in [0, 1], got "
                f"{brownout_min_healthy_frac}"
            )
        if probe_interval_s < 0:
            raise ValueError(
                f"probe_interval_s must be >= 0, got {probe_interval_s}"
            )
        if probe_count < 1:
            raise ValueError(f"probe_count must be >= 1, got {probe_count}")
        if probe_max_new < 1:
            raise ValueError(
                f"probe_max_new must be >= 1, got {probe_max_new}"
            )
        if probe_timeout_s <= 0:
            raise ValueError(
                f"probe_timeout_s must be > 0, got {probe_timeout_s}"
            )
        self.replicas = list(replicas)
        self.admission = admission
        self.bus = bus
        self.registry = registry
        self.tracer = tracer
        # Optional live SLO engine (observability/slo.py). The router
        # never feeds it — it subscribes to the bus on its own — but
        # holding the handle here lets the gateway serve GET /slo and
        # fleet_health() fold worker sketches into the same snapshot.
        self.slo = slo
        self._clock = clock
        self.affinity_tokens = int(affinity_tokens)
        self.spill_margin = int(spill_margin)
        self.wedged_after_s = float(wedged_after_s)
        self.eject_backoff_s = float(eject_backoff_s)
        self.eject_backoff_max_s = float(eject_backoff_max_s)
        if not 0.0 <= backoff_jitter_frac <= 1.0:
            raise ValueError(
                f"backoff_jitter_frac must be in [0, 1], got "
                f"{backoff_jitter_frac}"
            )
        self.backoff_jitter_frac = float(backoff_jitter_frac)
        # Seeded: a crash-looping FLEET must not relaunch in lockstep
        # (decorrelated thundering herds), yet drills stay reproducible.
        self._backoff_rng = random.Random(backoff_seed)
        self.redrive_max = int(redrive_max)
        self.health_interval_s = float(health_interval_s)
        self.brownout_min_healthy_frac = float(brownout_min_healthy_frac)
        self.brownout_min_priority = int(brownout_min_priority)
        self.brownout_max_deadline_s = float(brownout_max_deadline_s)
        # Output-integrity sentinel (resilience/integrity.py). 0 disables
        # the layer entirely: no probe set is built, the health loop never
        # probes, and no fingerprint is read. ``probe_set`` lets tests
        # inject pinned probes; production pins them in start() from the
        # first replica's reference greedy path.
        self.probe_interval_s = float(probe_interval_s)
        self.probe_count = int(probe_count)
        self.probe_max_new = int(probe_max_new)
        self.probe_timeout_s = float(probe_timeout_s)
        self._probe_set: Optional[List[Any]] = (
            list(probe_set) if probe_set is not None else None
        )
        self._probe_lock = threading.Lock()
        self._probe_inflight: Set[int] = set()
        self._last_probe_ok: Dict[int, bool] = {}
        self._last_probe_t: Dict[int, float] = {}
        self._probe_idx = 0
        self._next_probe_at = 0.0
        if kv_migrate_timeout_s <= 0:
            raise ValueError(
                f"kv_migrate_timeout_s must be > 0, got {kv_migrate_timeout_s}"
            )
        if kv_home_max < 1:
            raise ValueError(f"kv_home_max must be >= 1, got {kv_home_max}")
        self.kv_migrate_timeout_s = float(kv_migrate_timeout_s)
        self.kv_home_max = int(kv_home_max)
        # KV placement map: prefix digest -> replica index that most
        # recently ADOPTED migrated pages for that prefix. Generalizes
        # prefix-affinity: rendezvous hashing predicts where a prefix
        # SHOULD live; this records where its pages actually ARE, so
        # follow-up requests land on the warmed decode worker. Insertion
        # ordered, capped at kv_home_max (oldest entry evicted) — a
        # stale entry only costs a cold prefill, never correctness.
        self._kv_home: Dict[bytes, int] = {}
        self._kv_home_lock = threading.Lock()
        self.decisions = DecisionLog(maxlen=256, bus=bus)
        self._live: Dict[int, RouterRequest] = {}
        self._live_lock = threading.Lock()
        self._next_frid = 0
        self._stopping = False
        self._draining = False
        self._started = clock()
        self._stop_ev = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._backoff: Dict[int, float] = {}
        self._relaunch_at: Dict[int, float] = {}
        self.brownout_active = False
        self._counters_lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "submitted": 0, "completed": 0, "cancelled": 0, "expired": 0,
            "errors": 0, "redrives": 0, "brownout_shed": 0, "ejects": 0,
            "probes": 0, "probe_failures": 0, "quarantines": 0,
            "relaunches": 0, "upgrades": 0, "upgrades_refused": 0,
            "journal_replays": 0,
            "kv_migrations": 0, "kv_pages_migrated": 0,
            "kv_migration_rejects": 0,
        }
        self._g_state: Dict[int, Any] = {}
        self._g_backoff: Dict[int, Any] = {}
        self._c_redrives = self._c_shed = self._c_ejects = None
        self._c_probes = self._c_probe_fail = self._c_quarantines = None
        self._c_relaunches = None
        self._c_replays = None
        self._g_brownout = None
        self._c_kv_pages = self._c_kv_bytes = self._c_kv_rejects = None
        if registry is not None:
            for rep in self.replicas:
                self._g_state[rep.index] = registry.gauge(
                    "replica_state",
                    "replica lifecycle (0=ejected, 1=active, 2=draining)",
                    replica=rep.index,
                )
                self._g_backoff[rep.index] = registry.gauge(
                    "replica_backoff_s",
                    "currently scheduled relaunch backoff (0 = not backing "
                    "off) — a crash-looping replica shows as a climb to "
                    "the cap instead of silent retries",
                    replica=rep.index,
                )
            self._c_redrives = registry.counter(
                "redrives_total",
                "in-flight requests failed over to a surviving replica")
            self._c_shed = registry.counter(
                "brownout_shed_total",
                "requests shed at the router during brownout")
            self._c_ejects = registry.counter(
                "replica_ejects_total",
                "replicas declared dead/wedged by the health loop")
            self._c_relaunches = registry.counter(
                "replica_relaunch_total",
                "replica engines (re)launched after eject/drain/upgrade")
            self._g_brownout = registry.gauge(
                "brownout_active", "1 while the fleet is in brownout")
            self._c_probes = registry.counter(
                "integrity_probes_total",
                "golden probes completed against replicas")
            self._c_probe_fail = registry.counter(
                "integrity_probe_failures_total",
                "golden probes whose output diverged from the pinned reference")
            self._c_quarantines = registry.counter(
                "quarantines_total",
                "replicas quarantined by the integrity sentinel")
            self._c_replays = registry.counter(
                "router_journal_replays_total",
                "journaled in-flight requests redriven by a recovering "
                "router")
            self._c_kv_pages = registry.counter(
                "kv_pages_migrated_total",
                "KV pages adopted by decode workers from prefill-tier "
                "migrations")
            self._c_kv_bytes = registry.counter(
                "kv_migrated_bytes_total",
                "serialized bytes of KV transfers pushed to decode workers")
            self._c_kv_rejects = registry.counter(
                "kv_migration_rejects_total",
                "migrated KV pages a decode worker refused (checksum "
                "mismatch, capacity, stale fence, layout)")
        # Write-ahead fleet journal (crash-recoverable control plane).
        # With recover=True the previous router's journal is folded into
        # a recovery plan BEFORE this router touches any worker: fence
        # generations advance past everything the dead router granted,
        # so every frame its workers still hold in flight is stale by
        # construction, and frids continue past the old allocator.
        self.journal: Optional[FleetJournal] = None
        self.recovered: Dict[int, RouterRequest] = {}
        self._recover_plan: Optional[Dict[str, Any]] = None
        if journal_path:
            if recover:
                plan = FleetJournal.recovery_plan(
                    FleetJournal.load(journal_path)
                )
                self._recover_plan = plan
                self._next_frid = max(
                    self._next_frid, int(plan["next_frid"])
                )
                for rep in self.replicas:
                    if hasattr(rep, "fence"):
                        rep.fence = max(
                            rep.fence,
                            int(plan["fences"].get(rep.index, 0)) + 1,
                        )
            self.journal = FleetJournal(
                journal_path, rotate_bytes=int(journal_rotate_bytes)
            )
        for rep in self.replicas:
            rep.on_state = self._on_replica_state

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Router":
        for rep in self.replicas:
            if rep.loop is None:
                rep.start()
        if self.probe_interval_s > 0 and self._probe_set is None:
            # Pin the golden set once, from the REFERENCE generate path on
            # known-good weights (the loops are idle at this point; no
            # request has touched any engine yet). probe_len spans exactly
            # one full KV block past the boundary so probe #0 publishes the
            # shared prefix to the prefix cache and every later probe
            # re-acquires it — a corrupted cached page then surfaces as
            # probe divergence, not just as wrong client outputs.
            from pretraining_llm_tpu_torch.resilience.integrity import (
                GoldenProbe, build_probe_set,
            )
            engine = next(
                (r.engine for r in self.replicas if r.engine is not None),
                None,
            )
            if engine is None:
                raise RuntimeError(
                    "probe_interval_s > 0 needs a launched replica to pin "
                    "the golden probe set against"
                )
            if engine.temperature != 0.0:
                raise ValueError(
                    "golden probes compare outputs bit-for-bit and need "
                    "deterministic decode: probe_interval_s > 0 requires "
                    f"temperature=0, got {engine.temperature} (a sampling "
                    "engine draws fresh noise per decode, so every probe "
                    "would diverge and quarantine healthy replicas)"
                )
            # Clamp to the model context: a large serving block size on a
            # short-context model must not make the probe itself infeasible
            # (the cache-coverage property just degrades to a partial page).
            probe_len = min(
                engine.block_size + 1,
                engine.cfg.context_length - self.probe_max_new,
            )
            if probe_len < 2:
                raise ValueError(
                    f"context_length={engine.cfg.context_length} leaves no "
                    f"room for a probe with probe_max_new="
                    f"{self.probe_max_new}"
                )
            # Process-mode replicas expose a build_probe_set facade (the
            # params live in the worker); in-process engines fall through
            # to the local reference path.
            builder = getattr(engine, "build_probe_set", None)
            if builder is not None:
                self._probe_set = builder(
                    n_probes=self.probe_count,
                    probe_len=probe_len,
                    max_new=self.probe_max_new,
                )
            else:
                self._probe_set = build_probe_set(
                    engine.params, engine.cfg,
                    n_probes=self.probe_count,
                    probe_len=probe_len,
                    max_new=self.probe_max_new,
                )
            # Re-pin the expected tokens from the SERVING path itself. The
            # reference generate above vets the prompts, but at bf16 its
            # argmax near-ties can legitimately differ from the paged
            # serving engine's — a baseline from a different code path
            # would quarantine every healthy replica. Serving is
            # deterministic and identical across same-config replicas, so
            # the unanimous startup answer is the bit-exact contract every
            # healthy replica must keep; replicas that disagree before any
            # traffic means no trustworthy baseline exists at all. Each
            # probe is pinned through both prefill lanes it can take: a
            # prefix-cache miss (the monolithic prefill) and a hit (the
            # suffix lane over the cached block), whose bf16 roundings
            # differ on the port's kernels.
            self._probe_set = [
                GoldenProbe(prompt=p.prompt, expected=exp[0], alternates=exp[1:])
                for p, exp in zip(
                    self._probe_set,
                    self._pin_serving_baseline(self._probe_set),
                )
            ]
        if self.journal is not None:
            # Membership + fence baseline first, so even a journal with
            # zero requests lets the next recovery fence everything.
            for rep in self.replicas:
                self.journal.append({
                    "rec": "member",
                    "replica": rep.index,
                    "mode": getattr(rep, "mode", "inproc"),
                    "attach": getattr(rep, "attach", ""),
                    "generation": rep.generation,
                })
                self.journal.append({
                    "rec": "fence",
                    "replica": rep.index,
                    "fence": int(getattr(rep, "fence", 0)),
                })
        # Replay journaled in-flight requests BEFORE the health thread
        # starts interleaving ejects: the replicas are launched and
        # idle, so every replay places deterministically.
        self._replay_journal()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="router-health", daemon=True
        )
        self._health_thread.start()
        return self

    def _replay_journal(self) -> None:
        """Redrive every journaled in-flight request from its last
        committed frontier (recover=True). Replays bypass fleet
        admission — they were admitted by the previous router and their
        tickets died with it; re-gating them could deadlock recovery
        behind fresh traffic. Deadlines are not resurrected (they were
        absolute on the dead router's clock). Greedy decode from
        ``prompt + tokens`` makes each completion bit-identical to the
        undisturbed output."""
        plan = self._recover_plan
        if not plan or not plan["live"]:
            return
        for frid in sorted(plan["live"]):
            ent = plan["live"][frid]
            # Continue the ORIGINAL distributed trace, not a fresh one:
            # the journaled trace_id re-keys this request into the same
            # lineage tree its pre-crash spans already belong to (the
            # root span id is fresh — the old root died unrecorded with
            # the old router — but every grouping key matches).
            trace = None
            journaled_tid = ent.get("trace_id")
            if self.tracer is not None and journaled_tid:
                trace = RequestTrace(
                    self.tracer.recorder, str(journaled_tid)
                )
                trace.finish_deferred = True
            rreq = RouterRequest(
                int(frid), list(ent["prompt"]), int(ent["max_new"]),
                deadline=None, submitted_s=self._clock(),
                priority=int(ent["priority"]), trace=trace,
            )
            rreq.tokens = list(ent["tokens"])
            rreq.redrives = int(ent["redrives"])
            self.recovered[rreq.frid] = rreq
            with self._live_lock:
                self._live[rreq.frid] = rreq
            with self._counters_lock:
                self.counters["submitted"] += 1
                self.counters["journal_replays"] += 1
            if self._c_replays is not None:
                self._c_replays.inc()
            if self.bus is not None:
                fields = (
                    {"trace_id": trace.trace_id} if trace is not None else {}
                )
                self.bus.emit(
                    "fleet_req_submit", frid=rreq.frid, replica=None,
                    n_prompt=len(rreq.prompt), max_new=rreq.max_new,
                    priority=rreq.priority, replayed=True, **fields,
                )
            replica: Optional[int] = None
            with rreq._lock:
                if len(rreq.tokens) >= rreq.max_new:
                    # The journal frontier already covers the whole
                    # greedy output: the old router died between the
                    # last commit and its terminal bookkeeping.
                    self._finish_locked(
                        rreq, "done", {"completed_at_replay": True}
                    )
                else:
                    try:
                        replica = self._assign_locked(rreq, exclude=set())
                    except Exception as e:
                        self._finish_locked(
                            rreq, "error",
                            {"reason": f"journal replay failed: {e}"},
                        )
            if self.bus is not None:
                self.bus.emit(
                    "journal_replay", frid=rreq.frid, replica=replica,
                    n_committed=len(rreq.tokens), redrives=rreq.redrives,
                )

    def stop(self, timeout: float = 10.0) -> bool:
        """Stop the fleet. In-flight requests get error terminals (via
        each loop's shutdown path); returns False if any loop thread had
        to be abandoned wedged."""
        self._stopping = True
        self._stop_ev.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
            self._health_thread = None
        clean = True
        for rep in self.replicas:
            clean = rep.stop(timeout=timeout) and clean
        # Belt and suspenders: anything the loops could not terminate
        # (e.g. a request whose attempt was abandoned mid-redrive when
        # stop hit) gets its terminal here, so no client hangs.
        for rreq in self._live_snapshot():
            with rreq._lock:
                self._finish_locked(rreq, "error", {"reason": "router shutdown"})
        if self.journal is not None:
            self.journal.close()
        return clean

    def abort(self) -> None:
        """Simulate a router CRASH (the recovery drill's kill switch):
        no shutdown RPCs, no request terminals, no events — workers and
        clients are simply cut off, exactly as if the process died.
        Attached workers' leases expire and they park; a new Router
        built with ``recover=True`` on the same journal re-attaches,
        fences the old generation, and redrives the journaled work."""
        self._stopping = True
        self._stop_ev.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
            self._health_thread = None
        for rep in self.replicas:
            sever = getattr(rep, "sever", None)
            if sever is not None:
                sever()
        if self.journal is not None:
            self.journal.close()

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- submission ---------------------------------------------------------

    def submit(
        self,
        prompt: Any,
        max_new_tokens: int,
        *,
        deadline_s: Optional[float] = None,
        trace: Any = _TRACE_UNSET,
        priority: int = 0,
    ) -> RouterRequest:
        """Gateway-facing submit: validate, brownout gate, fleet
        admission, place on a replica, start the pump. Raises exactly what
        EngineLoop.submit raises (ValueError / RejectedBusy /
        RejectedInfeasible / RuntimeError) so the gateway's status mapping
        is unchanged."""
        if self._stopping:
            raise RuntimeError("Router is stopped")
        if self._draining:
            raise RuntimeError("Router is draining")
        if trace is _TRACE_UNSET:
            trace = (
                self.tracer.begin_request() if self.tracer is not None else None
            )
        if trace is not None:
            # The router owns the lineage-tree root: replica loops record
            # their spans into it but must not close it — an attempt-level
            # terminal (replica crash) is not the request's fate.
            trace.finish_deferred = True
        engine = next(
            (r.engine for r in self.replicas if r.engine is not None), None
        )
        if engine is None:
            raise RuntimeError("Router has no launched replica")
        try:
            max_new = engine.validate_request(prompt, max_new_tokens)
        except ValueError:
            if self.bus is not None:
                self.bus.emit("req_rejected", reason="invalid", fleet=True)
            if trace is not None:
                trace.finish("rejected", reason="invalid")
            raise
        prompt = [int(t) for t in prompt]
        if self.brownout_active and self._brownout_sheds(priority, deadline_s):
            retry = (
                self.admission.retry_after_s
                if self.admission is not None else 1.0
            )
            reason = (
                f"fleet brownout: shedding priority<"
                f"{self.brownout_min_priority} / long-deadline work"
            )
            with self._counters_lock:
                self.counters["brownout_shed"] += 1
            if self._c_shed is not None:
                self._c_shed.inc()
            self.decisions.record(
                "brownout_shed", priority=priority, deadline_s=deadline_s,
                trace_id=trace.trace_id if trace is not None else None,
            )
            if trace is not None:
                trace.finish("rejected", reason="brownout")
            raise RejectedBusy(reason, retry)
        ticket = None
        if self.admission is not None:
            cached = self._best_cached(prompt)
            try:
                ticket = self.admission.try_admit(
                    len(prompt), max_new, deadline_s=deadline_s,
                    cached_tokens=cached,
                )
            except (RejectedBusy, RejectedInfeasible):
                if self.bus is not None:
                    self.bus.emit(
                        "req_rejected", reason="fleet_budget", fleet=True,
                    )
                if trace is not None:
                    trace.finish("rejected", reason="fleet_budget")
                raise
        now = self._clock()
        with self._live_lock:
            frid = self._next_frid
            self._next_frid += 1
        if self.journal is not None:
            # Write-AHEAD of placement: a router that dies between this
            # record and the replica ack still redrives the request on
            # recovery (at-least-once into the fleet; the fence makes
            # delivery to the client at-most-once per generation).
            self.journal.append({
                "rec": "submit", "frid": frid, "prompt": prompt,
                "max_new": max_new, "priority": int(priority),
                "deadline_s": deadline_s,
                # Lineage across router restarts: a recovering router
                # CONTINUES this trace id instead of minting an orphan.
                "trace_id": trace.trace_id if trace is not None else None,
            })
        rreq = RouterRequest(
            frid, prompt, max_new,
            deadline=(now + deadline_s) if deadline_s is not None else None,
            submitted_s=now, priority=int(priority), ticket=ticket,
            trace=trace,
        )
        # Disaggregated prefill (no-op without a prefill tier): may
        # commit the first token and warm the decode target's cache, so
        # it runs before placement — _assign_locked then submits the
        # continuation exactly the way a redrive would.
        self._maybe_disaggregate(rreq)
        try:
            with rreq._lock:
                replica = self._assign_locked(rreq, exclude=set())
        except BaseException as e:
            if ticket is not None:
                self.admission.release(ticket)
            if self.journal is not None:
                # The client saw the rejection; recovery must not
                # resurrect it.
                self.journal.append(
                    {"rec": "terminal", "frid": frid, "status": "rejected"}
                )
            if self.bus is not None:
                # Every replica refused (busy, storming, or unavailable):
                # the client got a 429 the fleet COULD not absorb. The SLO
                # engine counts this as availability burn — per-replica
                # refusals that spill to a peer never reach here.
                self.bus.emit(
                    "req_rejected", reason="placement", fleet=True,
                    **(
                        {"trace_id": trace.trace_id}
                        if trace is not None else {}
                    ),
                )
            # Deferred-finish means no replica loop closed the root on
            # our behalf; the router must, or the tree never terminates.
            if trace is not None and not trace.finished:
                trace.finish("rejected", reason=f"placement failed: {e}")
            raise
        with self._live_lock:
            self._live[frid] = rreq
        with self._counters_lock:
            self.counters["submitted"] += 1
        if self.bus is not None:
            fields = {"trace_id": trace.trace_id} if trace is not None else {}
            self.bus.emit(
                "fleet_req_submit", frid=frid, replica=replica,
                n_prompt=len(prompt), max_new=max_new, priority=priority,
                **fields,
            )
        return rreq

    def cancel(self, rreq: RouterRequest) -> None:
        rreq.cancel_requested = True
        with rreq._lock:
            attempt, idx = rreq._attempt, rreq.replica
        if attempt is None or idx is None:
            return
        loop = self.replicas[idx].loop
        if loop is not None:
            loop.cancel(attempt)

    def _brownout_sheds(
        self, priority: int, deadline_s: Optional[float]
    ) -> bool:
        if priority < self.brownout_min_priority:
            return True
        if self.brownout_max_deadline_s > 0 and (
            deadline_s is None or deadline_s > self.brownout_max_deadline_s
        ):
            return True
        return False

    def _best_cached(self, prompt: List[int]) -> int:
        """Fleet admission's prefix-cache hint: the BEST hit any replica
        could serve (optimistic — affinity usually sends the request
        there, and an optimistic hint only discounts the token budget,
        never unsounds it)."""
        best = 0
        for rep in self.replicas:
            cache = getattr(rep.engine, "prefix_cache", None)
            if cache is not None and rep.accepting:
                try:
                    best = max(best, cache.peek(prompt))
                except Exception:
                    pass
        return best

    # -- disaggregated prefill/decode ---------------------------------------

    def _decode_holds_prefix(
        self, rep: Replica, prompt: List[int], block_size: int
    ) -> bool:
        """Would a migration to ``rep`` be redundant — does it already
        hold at least one full block of this prefix? In-process replicas
        answer from their cache; remote ones from the KV-placement map
        (the router's only view of a worker's cache contents)."""
        digest = prefix_digest(prompt, self.affinity_tokens)
        with self._kv_home_lock:
            if self._kv_home.get(digest) == rep.index:
                return True
        cache = getattr(rep.engine, "prefix_cache", None)
        if cache is None:
            return False
        try:
            return cache.peek(prompt) >= block_size
        except Exception:
            return False

    def _maybe_disaggregate(self, rreq: RouterRequest) -> None:
        """Disaggregated prefill: run the prompt's prefill (plus the
        first token) on a dedicated prefill-tier worker, migrate the
        resulting KV pages to the decode target, and commit the first
        token to the client — the continuation then decodes on the
        warmed target via the ordinary assignment path (``prompt +
        committed`` with ``max_new`` reduced, the same machinery
        redrives use).

        Strictly best-effort: every failure mode — no prefill tier, the
        prefill leg dying mid-flight, a torn/corrupt/rejected transfer —
        falls back to the colocated path with zero client-visible
        difference, because greedy decoding makes the first token
        correct regardless of where the pages ended up, and a decode
        worker without the pages simply re-prefills. Never raises."""
        if rreq.max_new < 2:
            return  # no decode phase to disaggregate
        prompt = rreq.prompt
        pre = [
            r for r in self.replicas
            if getattr(r, "role", "both") == "prefill"
            and r.accepting and getattr(r, "kv_capable", False)
        ]
        if not pre:
            return
        digest = prefix_digest(prompt, self.affinity_tokens)
        P = max(pre, key=lambda r: _rendezvous_score(digest, r.index))
        D = self._pick(prompt, set())
        if (
            D is None
            or D.index == P.index
            or not getattr(D, "kv_capable", False)
        ):
            return
        block_size = int(getattr(D.engine, "block_size", 0) or 0)
        if block_size < 1 or len(prompt) - 1 < block_size:
            return  # no full page would migrate; colocated is strictly better
        if self._decode_holds_prefix(D, prompt, block_size):
            return  # the target is already warm; migration saves nothing
        t_mig0 = time.perf_counter()
        # Prefill leg: loop lane (not client traffic — no fleet ticket,
        # no fault clock, no frid). max_new=1 so the leg both builds the
        # KV chain AND yields the greedy first token, which is correct
        # to commit no matter what happens to the pages.
        try:
            leg = P.loop.submit(
                list(prompt), 1, trace=None, priority=rreq.priority
            )
            status, tokens, _info = leg.result(
                timeout=self.kv_migrate_timeout_s
            )
        except Exception:
            return  # prefill tier died mid-leg: silent colocated fallback
        if status != "done" or len(tokens) != 1:
            return
        t0 = int(tokens[0])
        inserted = rejected = nbytes = 0
        reject_reason: Optional[str] = None
        try:
            xfer = P.fetch_kv_pages(prompt)
        except Exception:
            xfer = None
        if xfer is not None:
            nbytes = kv_transfer.transfer_bytes(xfer)
            try:
                res = D.push_kv_pages(
                    xfer, timeout=self.kv_migrate_timeout_s
                )
            except Exception:
                res = None
            if isinstance(res, dict):
                inserted = int(res.get("inserted", 0) or 0)
                rejected = int(res.get("rejected", 0) or 0)
                if res.get("reason"):
                    reject_reason = str(res["reason"])
        # Commit the prefill leg's token: it is the greedy t0 of this
        # prompt on fleet-identical weights, valid whether or not a
        # single page survived the trip.
        with rreq._lock:
            if rreq.status in TERMINAL_STATUSES or rreq.cancel_requested:
                return
            rreq.tokens.append(t0)
            rreq.out_q.put(("token", t0))
        if self.journal is not None:
            # Same frontier record redrives write: a router that dies
            # right here still resumes from prompt + [t0] on recovery.
            self.journal.append({
                "rec": "frontier", "frid": rreq.frid,
                "tokens": list(rreq.tokens), "redrives": rreq.redrives,
            })
        saved_tokens = inserted * block_size
        with self._counters_lock:
            self.counters["kv_migrations"] += 1
            self.counters["kv_pages_migrated"] += inserted
            self.counters["kv_migration_rejects"] += rejected
        if inserted and self._c_kv_pages is not None:
            self._c_kv_pages.inc(inserted)
        if nbytes and self._c_kv_bytes is not None:
            self._c_kv_bytes.inc(nbytes)
        if rejected and self._c_kv_rejects is not None:
            self._c_kv_rejects.inc(rejected)
        if rreq.trace is not None:
            rreq.trace.span(
                "req.kv_migrate", t_mig0,
                from_replica=P.index, to_replica=D.index,
                pages=inserted, bytes=nbytes, rejected=rejected,
                saved_tokens=saved_tokens,
            )
        tid = rreq.trace.trace_id if rreq.trace is not None else None
        self.decisions.record(
            "kv_migrate", frid=rreq.frid, from_replica=P.index,
            to_replica=D.index, pages=inserted, rejected=rejected,
            trace_id=tid,
        )
        if self.bus is not None:
            self.bus.emit(
                "kv_migrate", frid=rreq.frid, from_replica=P.index,
                to_replica=D.index, pages=inserted, bytes=nbytes,
                rejected=rejected, saved_tokens=saved_tokens,
            )
        if rejected:
            # Rejected pages are DROPPED pages — the decode worker
            # refused to adopt them (checksum mismatch, capacity, stale
            # fence). The request is unharmed (it re-prefills), but the
            # verdict must be auditable.
            self.decisions.record(
                "kv_migration_reject", frid=rreq.frid, replica=D.index,
                rejected=rejected, reason=reject_reason, trace_id=tid,
            )
            if self.bus is not None:
                self.bus.emit(
                    "kv_migration_reject", frid=rreq.frid,
                    replica=D.index, rejected=rejected,
                    reason=reject_reason,
                )
        if inserted:
            with self._kv_home_lock:
                self._kv_home[digest] = D.index
                while len(self._kv_home) > self.kv_home_max:
                    self._kv_home.pop(next(iter(self._kv_home)))

    # -- placement ----------------------------------------------------------

    def _pick(self, prompt: List[int], tried: Set[int]) -> Optional[Replica]:
        # Dedicated prefill workers never take client decode traffic —
        # their capacity is reserved for prefill legs. If the fleet is
        # SO degraded that only prefill workers accept, serve anyway
        # (colocated on the prefill worker beats a 429).
        cands = [
            r for r in self.replicas
            if r.index not in tried and r.accepting
            and getattr(r, "role", "both") != "prefill"
        ]
        if not cands:
            cands = [
                r for r in self.replicas
                if r.index not in tried and r.accepting
            ]
        if not cands:
            return None
        digest = prefix_digest(prompt, self.affinity_tokens)
        loads = {r.index: r.load() for r in cands}
        min_load = min(loads.values())
        # KV-placement affinity generalizes prefix-affinity: rendezvous
        # predicts where a prefix SHOULD live, but a completed migration
        # records where its pages actually ARE. Honor the recorded home
        # unless it is spill-margin deeper than the least-loaded
        # candidate (the same imbalance rule affinity itself obeys).
        with self._kv_home_lock:
            home = self._kv_home.get(digest)
        if home is not None:
            rep = next((r for r in cands if r.index == home), None)
            if (
                rep is not None
                and loads[rep.index] < min_load + self.spill_margin
            ):
                return rep
        by_score = sorted(
            cands, key=lambda r: _rendezvous_score(digest, r.index),
            reverse=True,
        )
        chosen = by_score[0]
        if loads[chosen.index] >= min_load + self.spill_margin:
            # Affinity lost to imbalance: take the least-loaded candidate,
            # rendezvous order breaking ties so the spill is deterministic.
            chosen = min(
                by_score, key=lambda r: (loads[r.index], by_score.index(r))
            )
        return chosen

    def _assign_locked(
        self, rreq: RouterRequest, exclude: Set[int]
    ) -> int:
        """Place ``rreq``'s next attempt (rreq._lock held). Walks replicas
        in affinity order, spilling past busy/unavailable ones; raises the
        last rejection when nobody can take it."""
        tried: Set[int] = set(exclude)
        last_exc: Optional[Exception] = None
        delivered = len(rreq.tokens)
        deadline_s = None
        if rreq.deadline is not None:
            deadline_s = rreq.deadline - self._clock()
            if deadline_s <= 0:
                raise RejectedInfeasible("deadline already expired", 0.0)
        # The continuation resumes from the committed frontier; greedy
        # decoding makes it bit-identical to the undisturbed suffix.
        prompt = rreq.prompt + rreq.tokens if delivered else rreq.prompt
        max_new = rreq.max_new - delivered
        trace = (
            rreq.trace
            if rreq.trace is not None and not rreq.trace.finished
            else None
        )
        while True:
            rep = self._pick(prompt, tried)
            if rep is None:
                raise last_exc if last_exc is not None else RejectedBusy(
                    "no replica available",
                    self.admission.retry_after_s
                    if self.admission is not None else 1.0,
                )
            tried.add(rep.index)
            # Every placement is a child span of the lineage root. The
            # span id is minted BEFORE the submit so the traceparent can
            # point at it: a remote worker parents its whole local span
            # tree under this attempt, and in-process loops record into
            # the same trace directly. The span itself is recorded when
            # the attempt ends (replicas that refuse record it here).
            span_id: Optional[str] = None
            tp: Optional[str] = None
            t_att0 = time.perf_counter()
            if trace is not None:
                span_id = trace.new_span_id()
                tp = format_traceparent(
                    SpanContext(trace.trace_id, span_id, sampled=True)
                )
            try:
                attempt = rep.submit(
                    prompt, max_new, deadline_s=deadline_s, trace=trace,
                    traceparent=tp, priority=rreq.priority,
                )
            except (ReplicaUnavailable, RuntimeError) as e:
                if trace is not None:
                    trace.span(
                        "req.attempt", t_att0, span_id=span_id,
                        outcome="unavailable", replica=rep.index,
                        redrive=rreq.redrives,
                    )
                last_exc = RejectedBusy(
                    str(e),
                    self.admission.retry_after_s
                    if self.admission is not None else 1.0,
                )
                continue
            except RejectedBusy as e:
                if trace is not None:
                    trace.span(
                        "req.attempt", t_att0, span_id=span_id,
                        outcome="busy", replica=rep.index,
                        redrive=rreq.redrives,
                    )
                last_exc = e
                continue
            rreq._attempt = attempt
            rreq.replica = rep.index
            if trace is not None and span_id is not None:
                rreq.attempt_span = (
                    span_id, t_att0, rep.index,
                    int(getattr(rep, "fence", 0)),
                )
            threading.Thread(
                target=self._pump,
                args=(rreq, attempt, rep.index),
                name=f"pump-{rreq.frid}.{rreq.redrives}",
                daemon=True,
            ).start()
            return rep.index

    # -- pump (one thread per attempt) --------------------------------------

    def _pump(
        self, rreq: RouterRequest, attempt: FrontendRequest, rep_index: int
    ) -> None:
        """Forward one attempt's stream to the router request, redriving
        on replica failure. Abandonment protocol: whoever replaces
        ``rreq._attempt`` under the lock owns the stream from then on; a
        pump that observes the mismatch exits silently (a non-event tuple
        pushed onto the old attempt's queue wakes a blocked pump)."""
        for ev in attempt.events():
            if ev[0] == "token":
                with rreq._lock:
                    if rreq._attempt is not attempt:
                        return
                    rreq.tokens.append(ev[1])
                    rreq.out_q.put(("token", ev[1]))
                continue
            if ev[0] != "end":  # abandonment wake-up marker
                with rreq._lock:
                    if rreq._attempt is not attempt:
                        return
                continue
            _, status, info = ev
            with rreq._lock:
                if rreq._attempt is not attempt:
                    return
                if (
                    status == "error"
                    and self._redrivable(info)
                    and not rreq.cancel_requested
                    and not self._stopping
                ):
                    reason = str(info.get("reason", "replica failure"))
                    if rreq.redrives < self.redrive_max:
                        if self._redrive_locked(rreq, rep_index, reason):
                            return
                    else:
                        # Attempt cap hit: the REQUEST is the poison (it
                        # has killed every replica it landed on). A clean
                        # terminal stops the redrive storm; the fleet
                        # recovers replica-by-replica behind it.
                        info = {
                            "reason": (
                                f"redrive budget exhausted after {reason}"
                            )
                        }
                self._finish_locked(rreq, status, info)
            return

    @staticmethod
    def _redrivable(info: Dict[str, Any]) -> bool:
        """Error terminals that mean 'the REPLICA failed, not the
        request': engine crash, loop shutdown under the request, wedged
        stop. Anything else (per-request validation fallback) stays an
        error to the client."""
        reason = str(info.get("reason", ""))
        return (
            reason.startswith("engine failure")
            or reason.startswith("shutdown")
            or reason.startswith("drain")
        )

    def _close_attempt_span(
        self, rreq: RouterRequest, outcome: str, **meta: Any
    ) -> None:
        """Record the open placement-attempt span (rreq._lock held):
        the attempt is over — terminal, redrive, or abandonment — so its
        pre-minted span id finally gets its [t0, now] extent, tagged with
        where it ran and how it ended."""
        ent, rreq.attempt_span = rreq.attempt_span, None
        if ent is None or rreq.trace is None:
            return
        span_id, t0, rep_idx, fence = ent
        rreq.trace.span(
            "req.attempt", t0, span_id=span_id, outcome=outcome,
            replica=rep_idx, fence=fence, redrive=rreq.redrives, **meta,
        )

    def _redrive_locked(
        self, rreq: RouterRequest, from_idx: int, reason: str
    ) -> bool:
        """Fail ``rreq`` over to a survivor (rreq._lock held). Returns
        True when the request found a new home (or finished outright);
        False means the caller should deliver the failure terminal."""
        delivered = len(rreq.tokens)
        self._close_attempt_span(
            rreq, "redriven", reason=reason, n_committed=delivered
        )
        # Abandon the old attempt unconditionally: every path below either
        # re-homes the request or terminates it, and a pump blocked on a
        # wedged replica's stream must be woken to exit either way.
        old_attempt = rreq._attempt
        rreq._attempt = None
        if old_attempt is not None:
            old_attempt.out_q.put(("abandoned", None))
        if rreq.deadline is not None and self._clock() >= rreq.deadline:
            self._finish_locked(
                rreq, "expired", {"reason": "deadline passed during redrive"}
            )
            return True
        if delivered >= rreq.max_new:
            # The replica died between the last committed token and its
            # finish bookkeeping: the client already has the whole greedy
            # output, so this IS completion.
            self._finish_locked(rreq, "done", {"completed_at_redrive": True})
            return True
        rreq.redrives += 1
        try:
            to_idx = self._assign_locked(rreq, exclude={from_idx})
        except (RejectedBusy, RejectedInfeasible, RuntimeError, ValueError) as e:
            self._finish_locked(
                rreq, "error",
                {"reason": f"redrive failed: {e}", "redrive_from": from_idx},
            )
            return True
        if self.journal is not None:
            # The committed frontier at the moment of failover — token
            # VALUES, not a count, so a recovering router can re-submit
            # ``prompt + tokens`` and greedy-decode the identical tail.
            self.journal.append({
                "rec": "frontier", "frid": rreq.frid,
                "tokens": list(rreq.tokens), "redrives": rreq.redrives,
            })
        with self._counters_lock:
            self.counters["redrives"] += 1
        if self._c_redrives is not None:
            self._c_redrives.inc()
        self.decisions.record(
            "redrive", frid=rreq.frid, from_replica=from_idx,
            to_replica=to_idx, n_committed=delivered, reason=reason,
            trace_id=rreq.trace.trace_id if rreq.trace is not None else None,
        )
        if self.bus is not None:
            self.bus.emit(
                "redrive", frid=rreq.frid, from_replica=from_idx,
                to_replica=to_idx, n_committed=delivered,
                n_prompt=len(rreq.prompt), reason=reason,
            )
        return True

    def _finish_locked(
        self, rreq: RouterRequest, status: str, info: Dict[str, Any]
    ) -> None:
        """Deliver the router-level terminal exactly once (rreq._lock
        held); later callers (a racing pump vs. shutdown sweep) no-op."""
        if rreq.status in TERMINAL_STATUSES:
            return
        rreq.status = status
        if self.journal is not None:
            self.journal.append(
                {"rec": "terminal", "frid": rreq.frid, "status": status}
            )
        info = dict(info)
        info["redrives"] = rreq.redrives
        info["n_tokens"] = len(rreq.tokens)
        # Which replica served the FINAL attempt — with redrives the
        # client-visible answer crossed hosts; the gateway surfaces this
        # alongside trace_id so a curl away from the trace tree.
        info.setdefault("replica", rreq.replica)
        # Router-level e2e spans ALL attempts; the attempt-local timings
        # (ttft/queue_wait) describe only the last one.
        info["e2e_s"] = self._clock() - rreq.submitted_s
        if rreq.trace is not None:
            info.setdefault("trace_id", rreq.trace.trace_id)
        rreq.info = info
        # Close the lineage tree: the last attempt span, then the root
        # (replica loops saw finish_deferred and left it open for us).
        self._close_attempt_span(rreq, status)
        if rreq.trace is not None and not rreq.trace.finished:
            rreq.trace.finish(
                status, n_tokens=len(rreq.tokens), redrives=rreq.redrives
            )
        if self.admission is not None and rreq.ticket is not None:
            self.admission.release(rreq.ticket)
        with self._live_lock:
            self._live.pop(rreq.frid, None)
        counter = {
            "done": "completed", "cancelled": "cancelled",
            "expired": "expired", "error": "errors",
        }[status]
        with self._counters_lock:
            self.counters[counter] += 1
        if self.bus is not None:
            self.bus.emit(
                "fleet_req_terminal", frid=rreq.frid, status=status,
                redrives=rreq.redrives, n_tokens=len(rreq.tokens),
                replica=rreq.replica, e2e_s=info["e2e_s"],
            )
        rreq.out_q.put(("end", status, info))

    def _live_snapshot(self) -> List[RouterRequest]:
        with self._live_lock:
            return list(self._live.values())

    # -- health / drain / brownout ------------------------------------------

    def _health_loop(self) -> None:
        while not self._stop_ev.wait(self.health_interval_s):
            now = self._clock()
            for rep in self.replicas:
                if rep.state == "active":
                    loop = rep.loop
                    if loop is None or not loop.running:
                        self._eject(rep, "loop dead (engine crash)")
                        continue
                    age = loop.last_turn_age_s()
                    if (
                        self.wedged_after_s > 0
                        and age > self.wedged_after_s
                        and loop.active_requests > 0
                    ):
                        self._eject(rep, f"wedged: last turn {age:.2f}s ago")
                elif rep.state == "ejected":
                    at = self._relaunch_at.get(rep.index)
                    if at is not None and now >= at:
                        self._relaunch_at.pop(rep.index, None)
                        try:
                            rep.relaunch(stop_timeout=0.5)
                            self._count_relaunch(rep.index)
                        except Exception:
                            backoff = self._next_backoff(rep.index)
                            self._relaunch_at[rep.index] = (
                                self._clock() + backoff
                            )
            self._sentinel_tick(now)
            self._update_brownout()

    def _next_backoff(self, index: int) -> float:
        cur = self._backoff.get(index, self.eject_backoff_s)
        self._backoff[index] = min(cur * 2.0, self.eject_backoff_max_s)
        cur *= 1.0 + self.backoff_jitter_frac * self._backoff_rng.random()
        gauge = self._g_backoff.get(index)
        if gauge is not None:
            gauge.set(cur)
        return cur

    def _count_relaunch(self, index: int) -> None:
        with self._counters_lock:
            self.counters["relaunches"] += 1
        if self._c_relaunches is not None:
            self._c_relaunches.inc()
        gauge = self._g_backoff.get(index)
        if gauge is not None:
            gauge.set(0.0)

    def _eject(self, rep: Replica, reason: str) -> None:
        rep.eject(reason)
        with self._counters_lock:
            self.counters["ejects"] += 1
        if self._c_ejects is not None:
            self._c_ejects.inc()
        self.decisions.record(
            "eject_replica", replica=rep.index, reason=reason,
            generation=rep.generation,
        )
        # Fence BEFORE redriving: from this point every frame the
        # ejected worker already produced (or will produce behind a
        # partition) is stale — the redriven copies on survivors own
        # the streams, so partition-then-heal cannot double-serve.
        bump = getattr(rep, "bump_fence", None)
        if bump is not None:
            fence = bump(reason)
            if self.journal is not None:
                self.journal.append(
                    {"rec": "fence", "replica": rep.index, "fence": fence}
                )
        backoff = self._next_backoff(rep.index)
        self._relaunch_at[rep.index] = self._clock() + backoff
        self._redrive_from(rep.index, reason)

    def _pin_serving_baseline(
        self, probes: List[Any]
    ) -> List[Tuple[Tuple[int, ...], ...]]:
        """Decode every probe on every launched replica (idle at startup)
        and return, per probe, the unanimous answers: the prefix-cache
        miss's first, then the hit's where it differs. With a prefix cache
        each replica's cache is flushed before a probe's first run (a
        miss), and the probe runs again (a hit on the block the first run
        published). Runs before the health thread starts, so plain
        blocking waits are fine."""
        live = [r for r in self.replicas if r.loop is not None]
        expected: List[Tuple[Tuple[int, ...], ...]] = []
        for probe in probes:
            per_probe: List[Tuple[int, Tuple[Tuple[int, ...], ...]]] = []
            for rep in live:
                cached = self._flush_prefix_cache(rep)
                answers = tuple(
                    self._startup_probe(rep, probe)
                    for _ in range(2 if cached else 1)
                )
                per_probe.append((rep.index, answers))
            base = per_probe[0][1]
            diverged = [i for i, t in per_probe if t != base]
            if diverged:
                raise RuntimeError(
                    "replicas disagree on a golden probe before any "
                    f"traffic (replica {per_probe[0][0]} vs {diverged}); "
                    "no trustworthy integrity baseline exists"
                )
            expected.append(tuple(dict.fromkeys(base)))
        return expected

    def _flush_prefix_cache(self, rep: Replica) -> bool:
        """Empty ``rep``'s prefix cache, if it has one (False if not): on
        the loop thread of an in-process engine, through the worker's
        ``prefix_flush`` op for a process replica (whose engine facade
        holds no cache of its own)."""
        cache = getattr(rep.engine, "prefix_cache", None)
        if cache is not None:
            rep.loop.run_on_loop(cache.flush, timeout=self.probe_timeout_s)
            return True
        if getattr(rep.engine, "has_prefix_cache", False):
            rep.engine.flush_prefix_cache(timeout=self.probe_timeout_s)
            return True
        return False

    def _startup_probe(self, rep: Replica, probe: Any) -> Tuple[int, ...]:
        attempt = rep.loop.submit(
            list(probe.prompt), len(probe.expected), priority=-1,
        )
        try:
            status, tokens, _info = attempt.result(
                timeout=self.probe_timeout_s
            )
        except TimeoutError:
            raise RuntimeError(
                f"replica {rep.index} did not answer a golden "
                f"probe within {self.probe_timeout_s}s at startup; "
                "cannot pin an integrity baseline"
            )
        if status != "done":
            raise RuntimeError(
                f"replica {rep.index} failed a golden probe at "
                f"startup (status={status!r}); cannot pin an "
                "integrity baseline"
            )
        return tuple(tokens)

    # -- integrity sentinel --------------------------------------------------
    #
    # Runs on the health thread. Two detectors per tick: (1) the live
    # weight fingerprint each loop thread computes between turns, compared
    # against the value it pinned at launch — drift means the weights the
    # replica is SERVING are not the weights it started with; (2) golden
    # probes — pinned greedy (prompt -> tokens) pairs injected through the
    # normal admission lane at strict-lowest priority, one outstanding per
    # replica, outputs compared bit-for-bit against the reference. Either
    # detector firing quarantines the replica: pull it from service via
    # the eject machinery (redrive its in-flight work onto survivors,
    # relaunch with fresh weights from the factory after backoff).
    # Quarantine means "the replica answered WRONG" — a probe that errors,
    # expires, or times out is recorded but left to the health checks
    # above, which own "the replica didn't answer".

    def _sentinel_tick(self, now: float) -> None:
        if self.probe_interval_s <= 0 or self._probe_set is None:
            return
        for rep in self.replicas:
            loop = rep.loop
            if rep.state != "active" or loop is None:
                continue
            fp0 = loop.weight_fingerprint0
            fp = loop.weight_fingerprint
            if fp0 is not None and fp is not None and fp != fp0:
                if self.bus is not None:
                    self.bus.emit(
                        "integrity_weight_mismatch", replica=rep.index,
                        pinned=fp0, current=fp,
                        fleet={
                            str(r.index): r.loop.weight_fingerprint
                            for r in self.replicas if r.loop is not None
                        },
                    )
                self._quarantine(
                    rep,
                    f"weight fingerprint drift ({fp0!r} -> {fp!r})",
                    None,
                )
        if now < self._next_probe_at:
            return
        self._next_probe_at = now + self.probe_interval_s
        probe = self._probe_set[self._probe_idx % len(self._probe_set)]
        self._probe_idx += 1
        for rep in self.replicas:
            loop = rep.loop
            if rep.state != "active" or loop is None or loop.draining:
                continue
            with self._probe_lock:
                if rep.index in self._probe_inflight:
                    continue  # one outstanding probe per replica
                self._probe_inflight.add(rep.index)
            generation = rep.generation
            try:
                # Straight to the loop: probes must not consume fleet
                # admission budget or count as client traffic (frid
                # conservation, fault clocks). priority=-1 is below every
                # client request, so brownout-style shedding hits probes
                # first. A busy replica skips this round — probes yield.
                attempt = loop.submit(
                    list(probe.prompt), len(probe.expected), priority=-1,
                )
            except Exception:
                with self._probe_lock:
                    self._probe_inflight.discard(rep.index)
                continue
            threading.Thread(
                target=self._probe_pump,
                args=(rep, attempt, probe, generation),
                name=f"probe-{rep.index}",
                daemon=True,
            ).start()

    def _probe_pump(
        self, rep: Replica, attempt: FrontendRequest, probe: Any,
        generation: int,
    ) -> None:
        # The replica's probe stays outstanding until its verdict has been
        # acted on. A probe started between a divergence and its
        # quarantine would run on the same wrong weights and could end
        # after the eject: a divergence that no quarantine answers.
        try:
            self._probe_verdict(rep, attempt, probe, generation)
        finally:
            with self._probe_lock:
                self._probe_inflight.discard(rep.index)

    def _probe_verdict(
        self, rep: Replica, attempt: FrontendRequest, probe: Any,
        generation: int,
    ) -> None:
        try:
            status, tokens, _info = attempt.result(
                timeout=self.probe_timeout_s
            )
        except TimeoutError:
            # Wedge/overload territory — the health loop's verdict, not
            # the sentinel's. Cancel so the probe can't complete into a
            # replaced inflight slot later.
            status, tokens = "timeout", []
            loop = rep.loop
            if loop is not None:
                try:
                    loop.cancel(attempt)
                except Exception:
                    pass
        ok = status == "done" and (
            tuple(tokens) == tuple(probe.expected)
            or tuple(tokens) in getattr(probe, "alternates", ())
        )
        with self._probe_lock:
            self._last_probe_ok[rep.index] = ok
            self._last_probe_t[rep.index] = self._clock()
        with self._counters_lock:
            self.counters["probes"] += 1
            if not ok:
                self.counters["probe_failures"] += 1
        if self._c_probes is not None:
            self._c_probes.inc()
        if not ok and self._c_probe_fail is not None:
            self._c_probe_fail.inc()
        trace = getattr(attempt, "trace", None)
        trace_id = trace.trace_id if trace is not None else None
        if self.bus is not None:
            fields = {"trace_id": trace_id} if trace_id is not None else {}
            self.bus.emit(
                "integrity_probe", replica=rep.index, ok=ok, status=status,
                n_tokens=len(tokens), **fields,
            )
        if ok or self._stopping:
            return
        if status != "done":
            return  # didn't answer — the health loop owns that verdict
        if rep.state != "active" or rep.generation != generation:
            return  # already ejected/relaunched under this probe
        self._quarantine(rep, "probe divergence", trace_id)

    def _quarantine(
        self, rep: Replica, reason: str, trace_id: Optional[str]
    ) -> None:
        with self._counters_lock:
            self.counters["quarantines"] += 1
        if self._c_quarantines is not None:
            self._c_quarantines.inc()
        self.decisions.record(
            "quarantine", replica=rep.index, reason=reason,
            generation=rep.generation, trace_id=trace_id,
        )
        if self.bus is not None:
            self.bus.emit(
                "integrity_quarantine", replica=rep.index, reason=reason,
            )
        self._eject(rep, f"quarantine: {reason}")

    def drain(self, index: int, *, stop_timeout: float = 5.0) -> bool:
        """Administrative drain: stop routing to the replica, redrive its
        in-flight work to survivors, then stop its loop. The replica
        stays ``draining`` (not-ready on /readyz) until ``restore``."""
        rep = self.replicas[index]
        rep.drain()
        self._redrive_from(index, "drain")
        return rep.stop(timeout=stop_timeout)

    def restore(self, index: int) -> None:
        """Bring a drained/ejected replica back with a fresh engine (the
        second half of a rolling restart) and reset its backoff."""
        rep = self.replicas[index]
        rep.relaunch()
        self._count_relaunch(index)
        self._backoff.pop(index, None)
        self._relaunch_at.pop(index, None)

    # -- fleet drain (graceful shutdown) -------------------------------------

    def begin_drain(self) -> None:
        """Fleet-level graceful shutdown gate (serve.py's SIGTERM path):
        stop admitting — the gateway 503s new submissions — while
        in-flight requests run to their terminals on their replicas;
        /readyz flips not-ready so load balancers stop sending."""
        self._draining = True
        self.decisions.record("fleet_drain")

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def active_requests(self) -> int:
        """Router-level in-flight count (the graceful-drain wait
        condition; mirrors EngineLoop.active_requests)."""
        with self._live_lock:
            return sum(
                1
                for r in self._live.values()
                if r.status not in TERMINAL_STATUSES
            )

    # -- rolling weight upgrades ---------------------------------------------

    def upgrade_replica(
        self,
        index: int,
        update: Any = None,
        *,
        stop_timeout: float = 5.0,
    ) -> bool:
        """One step of a rolling upgrade: drain replica ``index``
        (in-flight work redrives to survivors), apply ``update`` (a new
        engine factory in-process; a worker-spec patch such as
        ``{"model_path": ...}`` in process mode), relaunch HELD, and run
        the pinned golden probes against the fresh engine BEFORE it
        takes any traffic. Bit-exact probes promote it to active; any
        divergence, probe error, or crash inside the vetting window
        refuses the upgrade — the old weights are restored, re-vetted,
        and reactivated, and clients only ever saw the vetted fleet.

        Returns True when the upgrade took traffic, False when it was
        refused (the replica is back on its previous weights — or
        ejected into the health loop's backoff if even the rollback
        engine cannot come up)."""
        rep = self.replicas[index]
        old = rep.update_snapshot()
        with self._counters_lock:
            self.counters["upgrades"] += 1
        if self.bus is not None:
            self.bus.emit(
                "upgrade_start", replica=index, generation=rep.generation
            )
        self.drain(index, stop_timeout=stop_timeout)
        rep.apply_update(update)
        ok, detail = self._relaunch_vetted(rep)
        if ok:
            rep.activate("upgrade")
            self._count_relaunch(index)
            self._backoff.pop(index, None)
            self._relaunch_at.pop(index, None)
            if self.bus is not None:
                self.bus.emit(
                    "upgrade_vetted", replica=index, detail=detail,
                    generation=rep.generation,
                )
            return True
        with self._counters_lock:
            self.counters["upgrades_refused"] += 1
        self.decisions.record(
            "upgrade_refused", replica=index, reason=detail
        )
        if self.bus is not None:
            self.bus.emit("upgrade_refused", replica=index, reason=detail)
        rep.apply_update(old, replace=True)
        ok, detail = self._relaunch_vetted(rep)
        if ok:
            rep.activate("upgrade rollback")
            self._count_relaunch(index)
            self._backoff.pop(index, None)
            self._relaunch_at.pop(index, None)
        else:
            # Even the previous weights cannot come up vetted — hand the
            # replica to the health loop's eject/backoff machinery.
            rep.eject(f"upgrade rollback failed: {detail}")
            self._relaunch_at[index] = (
                self._clock() + self._next_backoff(index)
            )
        if self.bus is not None:
            self.bus.emit(
                "upgrade_rolled_back", replica=index, restored=ok,
                detail=detail,
            )
        return False

    def rolling_upgrade(
        self, updates: Any = None, *, stop_timeout: float = 5.0
    ) -> Dict[int, bool]:
        """Upgrade the fleet one replica at a time (i is fully vetted
        and back in traffic — or rolled back — before i+1 drains).
        ``updates``: one update for every replica, or a dict keyed by
        replica index (missing keys relaunch-as-is)."""
        results: Dict[int, bool] = {}
        for rep in self.replicas:
            up = (
                updates.get(rep.index)
                if isinstance(updates, dict)
                else updates
            )
            results[rep.index] = self.upgrade_replica(
                rep.index, up, stop_timeout=stop_timeout
            )
        return results

    def _relaunch_vetted(self, rep: Replica) -> Tuple[bool, str]:
        """Relaunch ``rep`` held out of traffic and decode every pinned
        probe on it, requiring bit-exact agreement with the fleet
        baseline. With no pinned set (sentinel off and no probe_set
        given) the launch is accepted unvetted — stated in the detail
        so the event stream records the weaker guarantee."""
        try:
            rep.relaunch(stop_timeout=0.5, hold=True)
        except Exception as e:
            return False, f"relaunch failed: {e!r}"
        probes = self._probe_set or []
        if not probes:
            return True, "unvetted (no probe set pinned)"
        for n, probe in enumerate(probes):
            try:
                attempt = rep.loop.submit(
                    list(probe.prompt), len(probe.expected), priority=-1
                )
                status, tokens, _info = attempt.result(
                    timeout=self.probe_timeout_s
                )
            except Exception as e:
                return False, f"vetting probe {n} failed: {e!r}"
            if status != "done":
                return False, f"vetting probe {n} status={status!r}"
            if list(tokens) != list(probe.expected):
                return False, (
                    f"vetting probe {n} diverged from the pinned reference"
                )
        return True, f"{len(probes)} probes bit-exact"

    def _redrive_from(self, index: int, reason: str) -> None:
        """Fail over every live request currently on ``index``. Races
        benignly with the pumps doing the same from the terminal side:
        both paths take rreq._lock, and whoever moves ``_attempt`` first
        wins (the loser sees the mismatch / the changed replica)."""
        for rreq in self._live_snapshot():
            with rreq._lock:
                if rreq.status in TERMINAL_STATUSES:
                    continue
                if rreq.replica != index or rreq._attempt is None:
                    continue
                if rreq.cancel_requested or self._stopping:
                    continue
                if rreq.redrives >= self.redrive_max:
                    self._finish_locked(
                        rreq, "error",
                        {"reason": f"redrive budget exhausted after {reason}"},
                    )
                    continue
                self._redrive_locked(rreq, index, reason)

    def _update_brownout(self) -> None:
        if self.brownout_min_healthy_frac <= 0:
            return
        total = len(self.replicas)
        healthy = sum(1 for r in self.replicas if r.accepting)
        want = (healthy / total) < self.brownout_min_healthy_frac
        if want == self.brownout_active:
            return
        self.brownout_active = want
        if self._g_brownout is not None:
            self._g_brownout.set(1.0 if want else 0.0)
        if self.bus is not None:
            self.bus.emit(
                "brownout", active=want, healthy=healthy, total=total
            )

    def _on_replica_state(self, rep: Replica, state: str, reason: str) -> None:
        g = self._g_state.get(rep.index)
        if g is not None:
            g.set(REPLICA_STATE_VALUES[state])

    # -- gateway surface (parity with EngineLoop) ----------------------------

    def last_turn_age_s(self) -> float:
        """Fleet liveness: the FRESHEST active replica's turn age — one
        healthy replica keeps /healthz green (capacity is /readyz's and
        brownout's business, not liveness's)."""
        ages = [
            rep.loop.last_turn_age_s()
            for rep in self.replicas
            if rep.state == "active" and rep.loop is not None
        ]
        if not ages:
            return max(0.0, self._clock() - self._started)
        return min(ages)

    def _integrity_snapshot(self) -> Dict[str, Any]:
        """Sentinel state for /readyz and /debug/engine: per-replica last
        probe verdict + age, quarantine count, fingerprint pair."""
        now = self._clock()
        with self._probe_lock:
            ok = dict(self._last_probe_ok)
            at = dict(self._last_probe_t)
        probes: Dict[str, Any] = {}
        for rep in self.replicas:
            rec: Dict[str, Any] = {"ok": ok.get(rep.index)}
            t = at.get(rep.index)
            rec["age_s"] = round(now - t, 6) if t is not None else None
            loop = rep.loop
            if loop is not None and loop.weight_fingerprint0 is not None:
                rec["fingerprint_pinned"] = loop.weight_fingerprint0
                rec["fingerprint"] = loop.weight_fingerprint
            probes[str(rep.index)] = rec
        with self._counters_lock:
            n_quar = self.counters["quarantines"]
            n_probes = self.counters["probes"]
            n_fail = self.counters["probe_failures"]
        return {
            "enabled": self.probe_interval_s > 0,
            "probes_run": n_probes,
            "probes_failed": n_fail,
            "quarantines": n_quar,
            "replicas": probes,
        }

    def readiness(self) -> Dict[str, Any]:
        per = {rep.index: rep.state for rep in self.replicas}
        ready = (
            any(rep.accepting for rep in self.replicas)
            and not self._draining
        )
        out = {
            "ready": ready,
            "replicas": per,
            "brownout": self.brownout_active,
            "draining": self._draining,
        }
        if self.probe_interval_s > 0:
            out["integrity"] = self._integrity_snapshot()
        return out

    def metrics(self) -> Dict[str, float]:
        """Aggregated counter snapshot (the /metrics extra-gauges path):
        fleet counters + per-replica loop counters summed + fleet
        admission, mirroring EngineLoop.metrics keys so /healthz and
        existing dashboards keep working."""
        with self._counters_lock:
            out: Dict[str, float] = dict(self.counters)
        agg: Dict[str, float] = {}
        active = 0
        for rep in self.replicas:
            loop = rep.loop
            if loop is None:
                continue
            if rep.accepting:
                active += 1
            for k, v in loop.metrics().items():
                if k.startswith("admission_"):
                    continue  # per-replica budgets; fleet budget below
                agg[k] = agg.get(k, 0.0) + v
        for k in ("active_requests", "tokens_streamed"):
            if k in agg:
                out[k] = agg[k]
        for k, v in agg.items():
            if k.startswith("engine_"):
                out[k] = v
        # "_count" not "_total": these are gauges and the exposition linter
        # reserves the _total suffix for counters.
        out["replicas_count"] = len(self.replicas)
        out["replicas_active"] = active
        out["brownout_active"] = 1.0 if self.brownout_active else 0.0
        if self.admission is not None:
            for k, v in self.admission.snapshot().items():
                out[f"admission_{k}"] = v
        return out

    def render_metrics(self, extra_gauges: Optional[Dict[str, float]] = None) -> str:
        """One merged exposition: the fleet registry leads, each
        replica's labeled registry follows (see metrics.render_merged)."""
        regs = []
        if self.registry is not None:
            regs.append(self.registry)
        regs.extend(rep.registry for rep in self.replicas)
        if not regs:
            from pretraining_llm_tpu_torch.observability.export import (
                prometheus_lines,
            )
            return prometheus_lines(
                extra_gauges or {}, prefix="pllm_serving_"
            )
        return render_merged(regs, extra_gauges)

    def debug_requests(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for rep in self.replicas:
            if rep.loop is None:
                continue
            for rec in rep.loop.debug_requests():
                rec["replica"] = rep.index
                out.append(rec)
        for rreq in self._live_snapshot():
            out.append({
                "frid": rreq.frid,
                "status": rreq.status,
                "replica": rreq.replica,
                "redrives": rreq.redrives,
                "n_tokens": len(rreq.tokens),
                "priority": rreq.priority,
                "fleet": True,
            })
        return out

    def debug_engine(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "fleet": {
                "replicas": [rep.debug_snapshot() for rep in self.replicas],
                "brownout_active": self.brownout_active,
                "live_requests": len(self._live_snapshot()),
                "counters": dict(self.counters),
                "decisions": {
                    "counts": self.decisions.counts_snapshot(),
                    "tail": self.decisions.tail(16),
                },
            },
        }
        if self.admission is not None:
            out["fleet"]["admission"] = self.admission.snapshot()
        if self.probe_interval_s > 0:
            out["fleet"]["integrity"] = self._integrity_snapshot()
        out["replicas"] = {
            str(rep.index): rep.loop.debug_engine()
            for rep in self.replicas
            if rep.loop is not None and rep.alive
        }
        return out

    def fleet_health(self) -> Dict[str, Any]:
        """One aggregated fleet health snapshot (the GET /slo ``fleet``
        section): per-replica ``health_pull`` gauges — KV pool
        occupancy, queue/admission depths, lease/fence generations,
        KV-migration counters, device HBM watermarks — plus fleet-wide
        sums, and the worker-side latency sketches merged order-
        invariantly (sketches.DigestSketch.merge_all) as a cross-check
        against the bus-fed SLO distributions. In-process replicas
        answer locally; process/attached workers answer over the wire
        (proto >= 4), older peers degrade to their cached health
        snapshot flagged ``proto_fallback``."""
        replicas: Dict[str, Any] = {}
        sums: Dict[str, float] = {}
        worker_sketches: Dict[str, List[Any]] = {}
        hbm_peak = 0.0
        active = 0
        max_fence = 0
        for rep in self.replicas:
            pull = getattr(rep, "health_pull", None)
            snap = pull() if pull is not None else rep.debug_snapshot()
            replicas[str(rep.index)] = snap
            if rep.accepting:
                active += 1
            max_fence = max(max_fence, int(snap.get("fence") or 0))
            for key, val in (snap.get("gauges") or {}).items():
                if isinstance(val, (int, float)):
                    sums[key] = sums.get(key, 0.0) + val
            for dev in (snap.get("hbm") or {}).values():
                hbm_peak = max(hbm_peak, float(dev.get("bytes_in_use", 0.0)))
            for metric, payload in (snap.get("sketches") or {}).items():
                worker_sketches.setdefault(metric, []).append(payload)
        with self._counters_lock:
            counters = dict(self.counters)
        fleet: Dict[str, Any] = {
            "replicas_total": len(self.replicas),
            "replicas_active": active,
            "brownout_active": self.brownout_active,
            "draining": self._draining,
            "max_fence": max_fence,
            "gauges": sums,
            "counters": counters,
        }
        if hbm_peak:
            fleet["hbm_peak_bytes_in_use"] = hbm_peak
        if worker_sketches:
            from pretraining_llm_tpu_torch.observability.sketches import (
                DigestSketch,
            )

            fleet["worker_sketches"] = {
                metric: DigestSketch.merge_all(
                    DigestSketch.from_dict(p) for p in payloads
                ).summary()
                for metric, payloads in sorted(worker_sketches.items())
            }
        return {"replicas": replicas, "fleet": fleet}

    def slo_snapshot(self) -> Dict[str, Any]:
        """The GET /slo body behind a fleet router: the SLO engine's
        distributions/budgets/alerts plus the aggregated fleet health."""
        out: Dict[str, Any] = (
            self.slo.snapshot() if self.slo is not None else {}
        )
        out["fleet_health"] = self.fleet_health()
        return out
