"""SLO load generator for the serving frontend (the JAX package's
``frontend/loadgen.py``), with the fleet plans that drive a ``Router``.

Two classic shapes:

  open-loop    arrivals follow a seeded Poisson process at ``rate_rps``,
               independent of the system's progress — the honest way to
               measure latency under load, because a slow server cannot
               slow the arrival process down (no coordinated omission);
  closed-loop  ``concurrency`` workers each keep exactly one request in
               flight, submitting the next the moment the previous one
               terminates — measures best-case pipeline throughput.

The whole workload is materialised up front by ``build_schedule`` from
``LoadSpec.seed`` (arrival offsets, prompt ids, lengths, token budgets),
so a given spec is ONE reproducible workload: same seed -> byte-identical
schedule, regardless of wall-clock, host, or which client runs it.

Clients: ``run_engine_loop`` drives an in-process EngineLoop; ``run_http`` drives a live gateway over HTTP with
stdlib urllib (no deps). Both produce a ``LoadReport`` with
TTFT/TPOT/e2e percentiles and goodput-under-SLO — completed requests
that met BOTH SLO bounds, per second of wall time; a server that answers
fast but late earns nothing.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from pretraining_llm_tpu_torch.frontend.admission import (
    RejectedBusy,
    RejectedInfeasible,
)


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One reproducible workload. ``vocab_size`` bounds the sampled token
    ids; prompt lengths and token budgets are uniform over the inclusive
    ranges. ``rate_rps`` is used in open-loop mode, ``concurrency`` in
    closed-loop. SLO bounds of 0 disable that bound."""

    n_requests: int = 32
    mode: str = "open"  # "open" | "closed"
    rate_rps: float = 8.0
    concurrency: int = 4
    vocab_size: int = 256
    prompt_len_min: int = 4
    prompt_len_max: int = 12
    max_new_min: int = 4
    max_new_max: int = 16
    deadline_s: Optional[float] = None
    slo_ttft_s: float = 0.0
    slo_e2e_s: float = 0.0
    seed: int = 0
    # Hot-prefix scenario (prefix-cache workloads): when
    # ``prefix_pool_size`` > 0, a pool of that many shared prefixes (each
    # ``prefix_len`` tokens, seeded like everything else) is materialised
    # and every request PREPENDS one, drawn zipf(s=``prefix_zipf``) over
    # pool rank — rank-1 is the hottest "system prompt", the tail is
    # cold. 0 (the default) leaves schedules byte-identical to specs
    # that predate these fields.
    prefix_pool_size: int = 0
    prefix_len: int = 0
    prefix_zipf: float = 1.0
    # HTTP client only: send a seeded W3C ``traceparent`` header per
    # request (sampled flag set), so the gateway joins trace ids the
    # workload chose — outcomes then correlate with the server's trace
    # export byte-for-byte. The in-process client instead reads back the
    # ids the loop's tracer minted.
    send_traceparent: bool = False
    # Fleet/brownout scenario: fraction of requests marked high priority
    # (``priority_hi``; the rest stay 0). Brownout shedding drops
    # low-priority work first, so a mixed-priority workload shows the
    # policy's selectivity. 0 (the default) consumes no rng — schedules
    # stay byte-identical to specs that predate this field.
    priority_hi_frac: float = 0.0
    priority_hi: int = 1

    def __post_init__(self) -> None:
        if self.mode not in ("open", "closed"):
            raise ValueError(f"mode must be 'open' or 'closed', got {self.mode!r}")
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {self.n_requests}")
        if self.mode == "open" and self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.mode == "closed" and self.concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got {self.concurrency}")
        if not 1 <= self.prompt_len_min <= self.prompt_len_max:
            raise ValueError(
                f"bad prompt length range "
                f"[{self.prompt_len_min}, {self.prompt_len_max}]"
            )
        if not 1 <= self.max_new_min <= self.max_new_max:
            raise ValueError(
                f"bad max_new range [{self.max_new_min}, {self.max_new_max}]"
            )
        if self.prefix_pool_size < 0:
            raise ValueError(
                f"prefix_pool_size must be >= 0, got {self.prefix_pool_size}"
            )
        if self.prefix_pool_size > 0 and self.prefix_len < 1:
            raise ValueError(
                f"prefix_len must be >= 1 with a prefix pool, got "
                f"{self.prefix_len}"
            )
        if self.prefix_zipf < 0:
            raise ValueError(
                f"prefix_zipf must be >= 0, got {self.prefix_zipf}"
            )
        if not 0.0 <= self.priority_hi_frac <= 1.0:
            raise ValueError(
                f"priority_hi_frac must be in [0, 1], got "
                f"{self.priority_hi_frac}"
            )


@dataclasses.dataclass(frozen=True)
class ScheduledRequest:
    index: int
    arrival_s: float  # offset from workload start; 0.0 in closed-loop
    prompt: List[int]
    max_new: int
    priority: int = 0


def build_schedule(spec: LoadSpec) -> List[ScheduledRequest]:
    """Materialise the workload. Pure function of ``spec`` (seeded PRNG,
    no wall clock): call it twice, get the same schedule."""
    rng = random.Random(spec.seed)
    # Shared-prefix pool + zipf-over-rank weights, materialised before
    # the request loop so the rng is consumed ONLY when the scenario is
    # on: pool-off schedules stay byte-identical to pre-pool specs.
    pool: List[List[int]] = []
    weights: List[float] = []
    if spec.prefix_pool_size > 0:
        pool = [
            [rng.randrange(spec.vocab_size) for _ in range(spec.prefix_len)]
            for _ in range(spec.prefix_pool_size)
        ]
        weights = [
            1.0 / (rank ** spec.prefix_zipf)
            for rank in range(1, spec.prefix_pool_size + 1)
        ]
    out: List[ScheduledRequest] = []
    t = 0.0
    for i in range(spec.n_requests):
        if spec.mode == "open":
            t += rng.expovariate(spec.rate_rps)
        n_prompt = rng.randint(spec.prompt_len_min, spec.prompt_len_max)
        prompt = [rng.randrange(spec.vocab_size) for _ in range(n_prompt)]
        if pool:
            prompt = pool[rng.choices(range(len(pool)), weights)[0]] + prompt
        max_new = rng.randint(spec.max_new_min, spec.max_new_max)
        priority = 0
        if spec.priority_hi_frac > 0:  # rng consumed only when the scenario is on
            if rng.random() < spec.priority_hi_frac:
                priority = spec.priority_hi
        out.append(
            ScheduledRequest(
                index=i,
                arrival_s=t if spec.mode == "open" else 0.0,
                prompt=prompt,
                max_new=max_new,
                priority=priority,
            )
        )
    return out


@dataclasses.dataclass
class RequestOutcome:
    index: int
    status: str  # done | cancelled | expired | error | rejected_busy | rejected_infeasible
    n_tokens: int = 0
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    e2e_s: Optional[float] = None
    trace_id: Optional[str] = None
    # Prompt tokens the engine served from the prefix cache (0 with the
    # cache off; accumulates across preemption re-admissions).
    cached_tokens: int = 0
    # Fleet client: how many times the router failed this request over to
    # another replica before it finished (0 on a single loop).
    redrives: int = 0
    # The tokens the server returned (None where none came back): the
    # port's addition, so a caller can hold the streams against a reference.
    tokens: Optional[List[int]] = None


def traceparent_for(spec: LoadSpec, index: int) -> str:
    """Deterministic per-request W3C traceparent (sampled): same spec ->
    same trace ids, so a rerun's trace export is join-comparable."""
    rng = random.Random((spec.seed << 20) ^ index)
    trace_id = f"{rng.getrandbits(128) or 1:032x}"
    span_id = f"{rng.getrandbits(64) or 1:016x}"
    return f"00-{trace_id}-{span_id}-01"


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank on a pre-sorted list; q in [0, 1]."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


@dataclasses.dataclass
class LoadReport:
    spec: LoadSpec
    wall_s: float
    outcomes: List[RequestOutcome]

    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for o in self.outcomes:
            c[o.status] = c.get(o.status, 0) + 1
        return c

    def percentiles(self, field: str) -> Dict[str, float]:
        vals = sorted(
            v for o in self.outcomes
            if (v := getattr(o, field)) is not None
        )
        return {
            "p50": _percentile(vals, 0.50),
            "p90": _percentile(vals, 0.90),
            "p99": _percentile(vals, 0.99),
        }

    def met_slo(self, o: RequestOutcome) -> bool:
        if o.status != "done":
            return False
        if self.spec.slo_ttft_s > 0 and (
            o.ttft_s is None or o.ttft_s > self.spec.slo_ttft_s
        ):
            return False
        if self.spec.slo_e2e_s > 0 and (
            o.e2e_s is None or o.e2e_s > self.spec.slo_e2e_s
        ):
            return False
        return True

    def summary(self) -> Dict[str, Any]:
        n_ok = sum(1 for o in self.outcomes if self.met_slo(o))
        n_done = sum(1 for o in self.outcomes if o.status == "done")
        tokens = sum(o.n_tokens for o in self.outcomes)
        wall = max(self.wall_s, 1e-9)
        return {
            "n_requests": len(self.outcomes),
            "counts": self.counts(),
            "wall_s": self.wall_s,
            "throughput_rps": n_done / wall,
            "throughput_tok_s": tokens / wall,
            "goodput_rps": n_ok / wall,
            "slo_attainment": (n_ok / len(self.outcomes)) if self.outcomes else 0.0,
            "cached_tokens_total": sum(o.cached_tokens for o in self.outcomes),
            "redrives_total": sum(o.redrives for o in self.outcomes),
            "ttft": self.percentiles("ttft_s"),
            "tpot": self.percentiles("tpot_s"),
            "e2e": self.percentiles("e2e_s"),
        }


# -- clients ---------------------------------------------------------------

# A client callable takes one ScheduledRequest and returns its outcome;
# _execute handles arrival pacing and the two loop shapes around it.
_Client = Callable[[ScheduledRequest], RequestOutcome]


def _execute(spec: LoadSpec, client: _Client) -> LoadReport:
    schedule = build_schedule(spec)
    outcomes: List[Optional[RequestOutcome]] = [None] * len(schedule)
    start = time.monotonic()

    if spec.mode == "open":
        def run_one(sr: ScheduledRequest) -> None:
            delay = start + sr.arrival_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            outcomes[sr.index] = client(sr)

        threads = [
            threading.Thread(target=run_one, args=(sr,), daemon=True)
            for sr in schedule
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    else:
        it = iter(schedule)
        it_lock = threading.Lock()

        def worker() -> None:
            while True:
                with it_lock:
                    sr = next(it, None)
                if sr is None:
                    return
                outcomes[sr.index] = client(sr)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(min(spec.concurrency, len(schedule)))
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    wall = time.monotonic() - start
    done = [o for o in outcomes if o is not None]
    return LoadReport(spec=spec, wall_s=wall, outcomes=done)


def run_engine_loop(loop: Any, spec: LoadSpec) -> LoadReport:
    """Drive an in-process EngineLoop (already started)."""

    def client(sr: ScheduledRequest) -> RequestOutcome:
        t0 = time.monotonic()
        try:
            req = loop.submit(
                sr.prompt, sr.max_new, deadline_s=spec.deadline_s,
                priority=sr.priority,
            )
        except RejectedBusy:
            return RequestOutcome(sr.index, "rejected_busy")
        except RejectedInfeasible:
            return RequestOutcome(sr.index, "rejected_infeasible")
        except (ValueError, RuntimeError):
            return RequestOutcome(sr.index, "error")
        status, tokens, info = req.result()
        # Client-side clock for TTFT/e2e (what a caller experiences);
        # engine-side marks live in info if finer attribution is needed.
        return RequestOutcome(
            sr.index,
            status,
            n_tokens=len(tokens),
            ttft_s=info.get("ttft_s"),
            tpot_s=info.get("tpot_s"),
            e2e_s=info.get("e2e_s", time.monotonic() - t0),
            trace_id=info.get("trace_id"),
            cached_tokens=int(info.get("cached_tokens", 0)),
            redrives=int(info.get("redrives", 0)),
            tokens=list(tokens),
        )

    return _execute(spec, client)


def run_http(base_url: str, spec: LoadSpec, timeout_s: float = 120.0) -> LoadReport:
    """Drive a live gateway over HTTP (non-streaming POSTs, stdlib only)."""
    url = base_url.rstrip("/") + "/v1/generate"

    def client(sr: ScheduledRequest) -> RequestOutcome:
        payload: Dict[str, Any] = {
            "prompt": sr.prompt,
            "max_new_tokens": sr.max_new,
        }
        if spec.deadline_s is not None:
            payload["deadline_s"] = spec.deadline_s
        if sr.priority:
            payload["priority"] = sr.priority
        data = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        trace_id = None
        if spec.send_traceparent:
            tp = traceparent_for(spec, sr.index)
            headers["traceparent"] = tp
            trace_id = tp.split("-")[1]
        t0 = time.monotonic()
        try:
            http_req = urllib.request.Request(url, data=data, headers=headers)
            with urllib.request.urlopen(http_req, timeout=timeout_s) as resp:
                body = json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            if e.code == 429:
                return RequestOutcome(sr.index, "rejected_busy")
            try:
                body = json.loads(e.read().decode())
            except (ValueError, OSError):
                body = {}
            status = body.get(
                "status", {504: "expired", 499: "cancelled"}.get(e.code, "error")
            )
            if e.code == 504 and "tokens" not in body:
                status = "rejected_infeasible"
            return RequestOutcome(
                sr.index,
                status,
                n_tokens=body.get("n_tokens", 0),
                ttft_s=body.get("ttft_s"),
                tpot_s=body.get("tpot_s"),
                e2e_s=body.get("e2e_s"),
                trace_id=body.get("trace_id", trace_id),
            )
        except (urllib.error.URLError, OSError, ValueError):
            return RequestOutcome(sr.index, "error", trace_id=trace_id)
        return RequestOutcome(
            sr.index,
            body.get("status", "done"),
            n_tokens=body.get("n_tokens", len(body.get("tokens", []))),
            ttft_s=body.get("ttft_s"),
            tpot_s=body.get("tpot_s"),
            e2e_s=body.get("e2e_s", time.monotonic() - t0),
            trace_id=body.get("trace_id", trace_id),
            cached_tokens=int(body.get("cached_tokens", 0)),
            redrives=int(body.get("redrives", 0)),
            tokens=body.get("tokens"),
        )

    return _execute(spec, client)


# -- fleet choreography ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetAction:
    """One timed operation against a fleet Router while load is running:

      kill     shadow the replica's live engine tick to raise (the loop
               thread dies mid-decode; the router's health loop ejects the
               replica and redrives its in-flight requests) — the
               wall-clock analogue of the injector's ``replica_crash@req_n``;
      drain    administrative drain: redrive in-flight work to survivors,
               stop the loop, hold the replica not-ready;
      restore  relaunch a drained/ejected replica with a fresh engine;
      upgrade  probe-vetted weight upgrade: drain, apply ``update`` to the
               replica's spec/factory, relaunch HELD, run golden probes,
               and only then take traffic (Router.upgrade_replica). The
               mid-upgrade-kill drill rides this action: an ``update``
               carrying ``kill_after_submits: 1`` makes the new worker die
               on its first vetting probe, which must roll the old weights
               back without clients ever seeing the unvetted checkpoint;
      partition, heal  act on process replicas' connections only (the JAX
               package's); an in-process replica has no wire to cut, so
               they do nothing here.
    """

    at_s: float
    kind: str  # "kill" | "drain" | "restore" | "upgrade" | "partition" | "heal"
    replica: int
    # Spec/factory delta applied before the upgrade relaunch (upgrade
    # only). None means "relaunch with the current spec" — still vetted.
    update: Optional[Dict[str, Any]] = None

    def __post_init__(self) -> None:
        if self.kind not in (
            "kill", "drain", "restore", "upgrade", "partition", "heal"
        ):
            raise ValueError(f"unknown fleet action kind {self.kind!r}")
        if self.at_s < 0:
            raise ValueError(f"at_s must be >= 0, got {self.at_s}")
        if self.update is not None and self.kind != "upgrade":
            raise ValueError(
                f"update only applies to upgrade actions, got {self.kind!r}"
            )


def rolling_restart_plan(
    n_replicas: int, *, start_s: float, step_s: float
) -> List[FleetAction]:
    """Drain replica i at ``start_s + i*step_s``, restore it one step
    later — at most one replica down at a time once ``step_s`` exceeds a
    drain's duration (the standard rolling-restart invariant)."""
    out: List[FleetAction] = []
    for i in range(n_replicas):
        t = start_s + i * step_s
        out.append(FleetAction(at_s=t, kind="drain", replica=i))
        out.append(FleetAction(at_s=t + step_s, kind="restore", replica=i))
    return out


def run_fleet_plan(router: Any, actions: List[FleetAction]) -> threading.Thread:
    """Execute a fleet plan against ``router`` on a daemon thread (offsets
    are from the call, so start it when the load run starts). Returns the
    thread; join it after the load run to be sure every action fired."""
    from pretraining_llm_tpu_torch.resilience.faults import InjectedFault

    plan = sorted(actions, key=lambda a: a.at_s)
    start = time.monotonic()

    def _kill(replica: int) -> None:
        rep = router.replicas[replica]
        # Out-of-process replica: the honest kill is SIGKILL to the worker
        # itself — the parent sees the socket die, exactly like a real
        # process death.
        proc = getattr(rep, "proc", None)
        if proc is not None:
            proc.kill()
            return
        eng = rep.engine
        if eng is None:
            return

        def _boom(*a: Any, **k: Any) -> None:
            raise InjectedFault(f"fleet plan killed replica {replica}")

        # Same instance-attribute shadowing as ServingFaultInjector.wrap_tick;
        # the loop thread dies on its next scheduler turn.
        eng.pipeline_tick = _boom

    def _run() -> None:
        for act in plan:
            delay = start + act.at_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            try:
                if act.kind == "kill":
                    _kill(act.replica)
                elif act.kind == "drain":
                    router.drain(act.replica)
                elif act.kind == "upgrade":
                    router.upgrade_replica(act.replica, act.update)
                elif act.kind in ("partition", "heal"):
                    # Process-mode replicas only (RemoteReplica.partition/
                    # heal); in-process replicas have no wire to cut.
                    fn = getattr(router.replicas[act.replica], act.kind, None)
                    if fn is not None:
                        fn()
                else:
                    router.restore(act.replica)
            except Exception:
                # The plan is chaos against live infrastructure; a replica
                # already down when its action fires is not a plan failure.
                pass

    th = threading.Thread(target=_run, name="fleet-plan", daemon=True)
    th.start()
    return th
