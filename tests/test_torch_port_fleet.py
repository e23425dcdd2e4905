"""The port's serving fleet in one process (``frontend/router.py``,
``frontend/replica.py``, ``frontend/journal.py``, the fleet plans of
``frontend/loadgen.py`` and the serving half of ``resilience/faults.py``)
against the JAX package's.

Mirrors ``tests/test_fleet.py`` and the journal cases of
``tests/test_multihost_fleet.py``. Where a JAX test asserts streams, counts
or a report, the JAX ``Router`` over JAX replicas and the port's over the
port's run the same load on the same weights: greedy streams are equal
(bit for bit, and equal to one undisturbed engine), and the redrive, eject
and drain outcomes are the same. Fault plans, fleet plans, the journal's
recovery plan, the rendezvous digest, the merged Prometheus text and the
Retry-After jitter are equal to the JAX package's. The tiny preset at fp32
(2 layers, d 32, V 256) with seeded numpy weights (std 0.3) given to both
packages through ``models/bridge.py``; the port runs the kernels' plain
versions. Every wait carries a timeout.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.frontend import journal as jjournal
from pretraining_llm_tpu.frontend import loadgen as jloadgen
from pretraining_llm_tpu.frontend import replica as jreplica
from pretraining_llm_tpu.frontend import router as jrouter
from pretraining_llm_tpu.generation import serving as jserving
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.observability import events as jevents
from pretraining_llm_tpu.observability import metrics as jmetrics
from pretraining_llm_tpu.resilience import faults as jfaults
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch import obs_report
from pretraining_llm_tpu_torch.frontend import journal as tjournal
from pretraining_llm_tpu_torch.frontend import loadgen as tloadgen
from pretraining_llm_tpu_torch.frontend import replica as treplica
from pretraining_llm_tpu_torch.frontend import router as trouter
from pretraining_llm_tpu_torch.frontend.admission import RejectedBusy
from pretraining_llm_tpu_torch.frontend.engine_loop import EngineLoop
from pretraining_llm_tpu_torch.frontend.gateway import ServingGateway
from pretraining_llm_tpu_torch.generation import serving as tserving
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.observability import events as tevents
from pretraining_llm_tpu_torch.observability import metrics as tmetrics
from pretraining_llm_tpu_torch.observability.export import lint_exposition
from pretraining_llm_tpu_torch.resilience import faults as tfaults

ROOT = Path(__file__).resolve().parent.parent
JCFG = dataclasses.replace(jcfg.get_preset("tiny").model, compute_dtype="float32")
CFG = tcfg.ModelConfig(**dict(dataclasses.asdict(JCFG), paged_attention_impl="kernel"))
WAIT = 120  # seconds any one result(), join() or poll may take

_spec = importlib.util.spec_from_file_location("obs_report_for_port_fleet", ROOT / "scripts" / "obs_report.py")
jobs_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jobs_report)

# One namespace per package: the same test body drives either fleet.
JAX = types.SimpleNamespace(name="jax", Router=jrouter.Router, Replica=jreplica.Replica,
                            Injector=jfaults.ServingFaultInjector, Engine=jserving.ServingEngine,
                            EventBus=jevents.EventBus, MetricsRegistry=jmetrics.MetricsRegistry, cfg=JCFG)
PORT = types.SimpleNamespace(name="torch", Router=trouter.Router, Replica=treplica.Replica,
                             Injector=tfaults.ServingFaultInjector, Engine=tserving.ServingEngine,
                             EventBus=tevents.EventBus, MetricsRegistry=tmetrics.MetricsRegistry, cfg=CFG)


@functools.lru_cache(maxsize=None)
def _weights():
    layout = jax.eval_shape(functools.partial(jtf.init_params, JCFG), jax.random.key(0))
    rng = np.random.default_rng(0)

    def leaf(path, spec):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.3, spec.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, layout)


@pytest.fixture(scope="module")
def params():
    return {"jax": jax.tree.map(jnp.asarray, _weights()),
            "torch": bridge.params_from_numpy(_weights(), CFG, device="cpu")}


def _prompts(n, lengths=(5, 9, 14, 7, 11, 3, 16, 6)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, CFG.vocab_size, size=int(lengths[i % len(lengths)])).tolist() for i in range(n)]


def _engine_factory(side, params, **kw):
    kw = {"max_batch": 2, "n_blocks": 24, "block_size": 8, "steps_per_sched": 4, "pipeline_depth": 2, **kw}
    if side is PORT:
        kw["device"] = "cpu"

    def factory():
        return side.Engine(params[side.name], side.cfg, temperature=0.0, **kw)

    return factory


def _undisturbed(side, params, prompts, n_new, **kw):
    """One engine, no fleet, no faults: THE answer any disturbed fleet run
    must reproduce."""
    eng = _engine_factory(side, params, **kw)()
    rids = {eng.submit(p, n_new): i for i, p in enumerate(prompts)}
    return {rids[rid]: list(toks) for rid, toks in eng.run().items()}


def _fleet(side, params, n=2, faults=None, bus=None, engine_kw=None, **router_kw):
    factory = _engine_factory(side, params, **(engine_kw or {}))
    reps = [side.Replica(i, factory, bus=bus, fault_injector=faults) for i in range(n)]
    router_kw.setdefault("eject_backoff_s", 0.1)
    return side.Router(reps, bus=bus, **router_kw)


def _run_both(params, body):
    """``body(side)`` on the JAX fleet and on the port's; returns both."""
    return body(JAX), body(PORT)


def _wait(pred, timeout, msg):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


# -- fault-plan parsing -----------------------------------------------------


def test_parse_serving_faults():
    spec = "replica_crash@req2:r0, slow_window@req5, reject_storm@req1:r1"
    got = tfaults.parse_serving_faults(spec)
    assert [dataclasses.astuple(f) for f in got] == [
        dataclasses.astuple(f) for f in jfaults.parse_serving_faults(spec)]
    assert got == [tfaults.ServingFault("replica_crash", 2, 0), tfaults.ServingFault("slow_window", 5, None),
                   tfaults.ServingFault("reject_storm", 1, 1)]
    assert tfaults.SERVING_FAULT_KINDS == jfaults.SERVING_FAULT_KINDS
    assert tfaults.PROCESS_SERVING_FAULT_KINDS == jfaults.PROCESS_SERVING_FAULT_KINDS
    for bad in ("", "chaos@req1", "replica_crash@2", "replica_crash@req2:rX", "replica_crash@req0"):
        with pytest.raises(ValueError) as want:
            jfaults.parse_serving_faults(bad)
        with pytest.raises(ValueError) as got_err:
            tfaults.parse_serving_faults(bad)
        assert str(got_err.value) == str(want.value)
    plan = "replica_crash@req1:r0,worker_kill@req2,corrupt_kv_migration@req3:r1"
    assert tfaults.split_serving_plan(plan) == jfaults.split_serving_plan(plan)


# -- redrive bit-identity ---------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("cache", [False, True], ids=["nocache", "cache"])
def test_redrive_bit_identity_after_crash(params, depth, cache):
    """A replica crashes with requests mid-decode: every request fails over
    to the survivor, resumes from its committed frontier and ends
    bit-identical to an undisturbed run, on the port's fleet as on the JAX
    fleet, with one eject on each."""
    prompts = _prompts(6)
    n_new = 8
    kw = dict(pipeline_depth=depth, prefix_cache=cache)
    ref = _undisturbed(PORT, params, prompts, n_new, **kw)
    assert ref == _undisturbed(JAX, params, prompts, n_new, **kw)

    def body(side):
        router = _fleet(side, params, faults=side.Injector("replica_crash@req2:r0"), engine_kw=kw)
        with router:
            results = [r.result(timeout=WAIT) for r in [router.submit(p, n_new) for p in prompts]]
        return results, dict(router.counters)

    (jres, jcount), (tres, tcount) = _run_both(params, body)
    for i, ((status, tokens, info), (jstatus, jtokens, _)) in enumerate(zip(tres, jres)):
        assert status == jstatus == "done", (i, status, info)
        assert tokens == jtokens == ref[i], f"request {i} diverged after redrive"
    assert tcount["ejects"] == jcount["ejects"] == 1
    assert tcount["redrives"] >= 1 and jcount["redrives"] >= 1
    assert sum(1 for _, _, inf in tres if inf["redrives"] > 0) >= 1


def test_redrive_preserves_committed_frontier(params):
    """A redriven request does not regenerate tokens it already streamed:
    every output is whole (n_new tokens) and equal to the undisturbed one."""
    prompts = _prompts(4)
    n_new = 10
    ref = _undisturbed(PORT, params, prompts, n_new)
    router = _fleet(PORT, params, faults=PORT.Injector("replica_crash@req2:r0", slow_ticks=0))
    with router:
        results = [r.result(timeout=WAIT) for r in [router.submit(p, n_new) for p in prompts]]
    for i, (status, tokens, _) in enumerate(results):
        assert status == "done" and tokens == ref[i] and len(tokens) == n_new


def test_redrive_lineage_joins_one_trace_tree(params):
    """With tracing on, a redriven request stays ONE lineage tree: one root
    owned by the router, a ``req.attempt`` child per placement (the crashed
    one ``redriven``, the survivor ``done``), one terminal; the port's
    ``obs_report`` and the JAX script find the same trees and the same
    lineage in the port's export."""
    from pretraining_llm_tpu_torch.observability.spans import SpanRecorder
    from pretraining_llm_tpu_torch.observability.tracing import Tracer

    prompts = _prompts(4)
    n_new = 8
    ref = _undisturbed(PORT, params, prompts, n_new)
    recorder = SpanRecorder(max_events=20000)
    router = _fleet(PORT, params, faults=PORT.Injector("replica_crash@req2:r0"),
                    tracer=Tracer(recorder, sample=1.0, seed=0))
    with router:
        results = [r.result(timeout=WAIT) for r in [router.submit(p, n_new) for p in prompts]]
    for i, (status, tokens, info) in enumerate(results):
        assert status == "done" and tokens == ref[i]
        assert "trace_id" in info and info["replica"] in (0, 1) and info["redrives"] >= 0
    assert any(info["redrives"] > 0 for _, _, info in results)

    trace = recorder.to_chrome_trace()
    groups = obs_report.group_request_spans(trace)
    assert len(groups) == len(prompts)
    assert all(obs_report.check_trace_tree(t, s) == [] for t, s in groups.items())
    report = obs_report.build_fleet_trace_report(trace)
    assert report == jobs_report.build_fleet_trace_report(trace)
    assert report["problems"] == [] and report["n_requests"] == len(prompts)
    assert report["redriven_requests"] >= 1
    redriven = next(r for r in report["requests"] if (r["redrives"] or 0) > 0)
    outcomes = [a["outcome"] for a in redriven["attempts"]]
    assert outcomes[-1] == "done" and "redriven" in outcomes[:-1]
    rd = [a["redrive"] for a in redriven["attempts"]]
    assert rd == sorted(rd) and rd[0] == 0 and rd[-1] == redriven["redrives"]
    assert abs(redriven["sum_error_s"]) <= 0.01 * redriven["e2e_s"] + 1e-9


def test_survivor_allocator_matches_undisturbed(params):
    """After the drill settles every block is back in both replicas'
    allocators, and the crashed replica was relaunched once."""
    router = _fleet(PORT, params, faults=PORT.Injector("replica_crash@req2:r0"))
    with router:
        for r in [router.submit(p, 8) for p in _prompts(5)]:
            assert r.result(timeout=WAIT)[0] == "done"
        _wait(lambda: all(rep.accepting for rep in router.replicas), 5.0, "relaunch")
        for rep in router.replicas:
            assert rep.engine.alloc.available == 24 - 1, rep.index
        assert router.replicas[0].generation == 2


def test_relaunch_frees_the_dead_engine(params, monkeypatch):
    """A relaunched replica drops its dead engine: no reference to the
    crashed engine (whose pools a card would otherwise keep) survives the
    relaunch. (pytest's own thread-exception hook would keep the crash's
    traceback, and with it the engine, until the test ends: the default
    hook's behaviour, print and drop, is restored here.)"""
    import weakref

    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    router = _fleet(PORT, params, faults=PORT.Injector("replica_crash@req1:r0"))
    with router:
        first = weakref.ref(router.replicas[0].engine)
        for r in [router.submit(p, 6) for p in _prompts(3)]:
            assert r.result(timeout=WAIT)[0] == "done"
        _wait(lambda: router.replicas[0].generation == 2 and router.replicas[0].accepting, 5.0, "relaunch")
        assert first() is None


# -- drain / rolling restart ------------------------------------------------


def _slow_ticks(router, s):
    for rep in router.replicas:
        orig = rep.engine.pipeline_tick

        def slow(orig=orig):
            time.sleep(s)
            return orig()

        rep.engine.pipeline_tick = slow


def test_drain_redrives_inflight_and_restore(params):
    """Administrative drain mid-decode: the drained replica's requests fail
    over and finish bit-identical; it refuses new work until restore()
    brings it back with a fresh engine. The same outcome on both fleets."""
    prompts = _prompts(4)
    n_new = 12
    ref = _undisturbed(PORT, params, prompts, n_new)

    def body(side):
        router = _fleet(side, params)
        unavailable = (treplica.ReplicaUnavailable if side is PORT else jreplica.ReplicaUnavailable)
        with router:
            _slow_ticks(router, 0.03)
            reqs = [router.submit(p, n_new) for p in prompts]
            time.sleep(0.08)
            victim = next((rr.replica for rr in reqs if rr.replica is not None), 0)
            router.drain(victim)
            rep = router.replicas[victim]
            state = rep.state
            with pytest.raises(unavailable):
                rep.submit([1, 2, 3], 4)
            results = [r.result(timeout=WAIT) for r in reqs]
            router.restore(victim)
            after = (rep.state, rep.generation, router.submit([1, 2, 3], 4).result(timeout=WAIT)[0])
        return state, [(s, t) for s, t, _ in results], after

    jout, tout = _run_both(params, body)
    assert tout[0] == jout[0] == "draining"
    assert tout[1] == jout[1] == [("done", ref[i]) for i in range(len(prompts))]
    assert tout[2] == jout[2] == ("active", 2, "done")


def test_rolling_restart_plan_shape():
    plan = tloadgen.rolling_restart_plan(3, start_s=1.0, step_s=0.5)
    want = jloadgen.rolling_restart_plan(3, start_s=1.0, step_s=0.5)
    assert [dataclasses.astuple(a) for a in plan] == [dataclasses.astuple(a) for a in want]
    assert [a.kind for a in plan] == ["drain", "restore"] * 3
    assert plan[4] == tloadgen.FleetAction(at_s=2.0, kind="drain", replica=2)
    for kw, match in ((dict(at_s=0.0, kind="reboot", replica=0), "unknown fleet action"),
                      (dict(at_s=-1.0, kind="kill", replica=0), "at_s"),
                      (dict(at_s=0.0, kind="drain", replica=0, update={}), "update")):
        with pytest.raises(ValueError, match=match):
            tloadgen.FleetAction(**kw)


def test_rolling_restart_under_load_bit_identical(params):
    """A rolling restart (drain then restore each replica in turn) while
    requests run: every stream equals the undisturbed one on both fleets,
    and every replica ends relaunched and active."""
    prompts = _prompts(8)
    n_new = 10
    ref = _undisturbed(PORT, params, prompts, n_new)

    def body(side):
        lg = tloadgen if side is PORT else jloadgen
        router = _fleet(side, params)
        with router:
            _slow_ticks(router, 0.01)
            th = lg.run_fleet_plan(router, lg.rolling_restart_plan(2, start_s=0.05, step_s=0.15))
            results = [r.result(timeout=WAIT) for r in [router.submit(p, n_new) for p in prompts]]
            th.join(timeout=WAIT)
            assert not th.is_alive()
            _wait(lambda: all(rep.accepting for rep in router.replicas), 10.0, "restore")
            gens = [rep.generation for rep in router.replicas]
        return [(s, t) for s, t, _ in results], gens

    jout, tout = _run_both(params, body)
    assert tout[0] == jout[0] == [("done", ref[i]) for i in range(len(prompts))]
    assert tout[1] == jout[1] == [2, 2]


def test_fleet_plan_kill_redrives(params):
    """``FleetAction(kind="kill")`` shadows a live engine's tick to raise:
    the health loop ejects, redrives and relaunches, streams unchanged."""
    prompts = _prompts(4)
    n_new = 10
    ref = _undisturbed(PORT, params, prompts, n_new)
    router = _fleet(PORT, params)
    with router:
        _slow_ticks(router, 0.02)
        reqs = [router.submit(p, n_new) for p in prompts]
        th = tloadgen.run_fleet_plan(router, [tloadgen.FleetAction(at_s=0.05, kind="kill", replica=0)])
        results = [r.result(timeout=WAIT) for r in reqs]
        th.join(timeout=WAIT)
    assert [(s, t) for s, t, _ in results] == [("done", ref[i]) for i in range(len(prompts))]
    assert router.counters["ejects"] == 1


# -- watchdog: hang detection ----------------------------------------------


def test_hang_watchdog_ejects_and_redrives(params):
    """replica_hang wedges the loop thread inside one scheduler turn; the
    router's watchdog ejects the replica and redrives. The hung thread is a
    daemon and ``Router.stop`` does not wait for it past its timeout."""
    prompts = _prompts(4)
    n_new = 8
    ref = _undisturbed(PORT, params, prompts, n_new)
    router = _fleet(PORT, params, faults=PORT.Injector("replica_hang@req2:r0"), wedged_after_s=0.3,
                    health_interval_s=0.02)
    try:
        router.start()
        results = [r.result(timeout=WAIT) for r in [router.submit(p, n_new) for p in prompts]]
        for i, (status, tokens, _) in enumerate(results):
            assert status == "done" and tokens == ref[i]
        assert router.counters["ejects"] >= 1 and router.counters["redrives"] >= 1
    finally:
        t0 = time.monotonic()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # the abandoned wedged thread
            router.stop(timeout=0.5)
        assert time.monotonic() - t0 < 30.0


# -- reject_storm, slow_window ---------------------------------------------


def test_reject_storm_spills_to_peer(params):
    """A replica in an injected 429 storm refuses; the router walks to the
    next candidate and every request completes, on both fleets alike."""
    prompts = _prompts(6)

    def body(side):
        router = _fleet(side, params, faults=side.Injector("reject_storm@req1:r0", storm_rejects=3))
        with router:
            statuses = [r.result(timeout=WAIT)[0] for r in [router.submit(p, 6) for p in prompts]]
        return statuses, router.replicas[1].submits >= 3

    jout, tout = _run_both(params, body)
    assert tout == jout == (["done"] * 6, True)


def test_slow_window_fault_completes(params):
    prompts = _prompts(3)
    ref = _undisturbed(PORT, params, prompts, 6)
    router = _fleet(PORT, params, faults=PORT.Injector("slow_window@req1:r0", slow_ticks=2, slow_s=0.02))
    with router:
        results = [r.result(timeout=WAIT) for r in [router.submit(p, 6) for p in prompts]]
    assert [(s, t) for s, t, _ in results] == [("done", ref[i]) for i in range(3)]
    assert router.counters["ejects"] == 0


# -- brownout ---------------------------------------------------------------


def test_brownout_sheds_low_priority(params):
    """Half the fleet drained with brownout armed: priority 0 is shed with
    429, priority 1 passes; restore ends the brownout."""
    router = _fleet(PORT, params, brownout_min_healthy_frac=0.6, brownout_min_priority=1,
                    health_interval_s=0.02)
    with router:
        router.drain(1)
        _wait(lambda: router.brownout_active, 5.0, "brownout")
        with pytest.raises(RejectedBusy, match="brownout"):
            router.submit([1, 2, 3], 4, priority=0)
        assert router.submit([1, 2, 3], 4, priority=1).result(timeout=WAIT)[0] == "done"
        assert router.counters["brownout_shed"] == 1
        router.restore(1)
        _wait(lambda: not router.brownout_active, 5.0, "brownout end")
        assert router.submit([1, 2, 3], 4, priority=0).result(timeout=WAIT)[0] == "done"


# -- prefix affinity --------------------------------------------------------


def test_prefix_affinity_stable_and_spills(params):
    """The rendezvous digest is the JAX package's byte for byte, so the
    same prefix picks the same replica on both fleets."""
    for prompt, n in (([1, 2, 3, 4, 5, 6], 4), ([9, 2, 3], 32), (list(range(40)), 32)):
        assert trouter.prefix_digest(prompt, n) == jrouter.prefix_digest(prompt, n)
        for r in range(4):
            digest = trouter.prefix_digest(prompt, n)
            assert trouter._rendezvous_score(digest, r) == jrouter._rendezvous_score(digest, r)
    digest = trouter.prefix_digest([1, 2, 3, 4, 5, 6], 4)
    assert digest == trouter.prefix_digest([1, 2, 3, 4, 99, 99], 4)
    assert digest != trouter.prefix_digest([9, 2, 3, 4, 5, 6], 4)

    def body(side):
        router = _fleet(side, params, affinity_tokens=4, spill_margin=2)
        with router:
            first = router.submit([7, 7, 7, 7, 1], 4)
            second = router.submit([7, 7, 7, 7, 2], 4)
            out = (first.replica, second.replica)
            assert [r.result(timeout=WAIT)[0] for r in (first, second)] == ["done", "done"]
        return out

    jout, tout = _run_both(params, body)
    assert tout == jout and tout[0] == tout[1]


# -- EngineLoop.stop -------------------------------------------------------


def test_stop_timeout_fails_outstanding_requests(params):
    eng = _engine_factory(PORT, params)()
    started = threading.Event()

    def wedged_tick(*a, **kw):
        started.set()
        time.sleep(60.0)
        return False

    eng.pipeline_tick = wedged_tick
    loop = EngineLoop(eng)
    loop.start()
    req = loop.submit([1, 2, 3], 8)
    assert started.wait(10.0)
    with pytest.warns(RuntimeWarning, match="still alive"):
        assert loop.stop(timeout=0.2) is False
    status, _, info = req.result(timeout=5.0)
    assert status == "error" and "shutdown timeout" in info["reason"]


def test_stop_clean_returns_true(params):
    loop = EngineLoop(_engine_factory(PORT, params)())
    loop.start()
    assert loop.submit([1, 2, 3], 4).result(timeout=WAIT)[0] == "done"
    assert loop.stop() is True


# -- /readyz ----------------------------------------------------------------


def _get(base, path, timeout=30):
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_readyz_distinct_from_healthz(params):
    loop = EngineLoop(_engine_factory(PORT, params)())
    gw = ServingGateway(loop, port=0)
    loop.start()
    gw.start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        assert _get(base, "/healthz")[0] == 200
        code, body = _get(base, "/readyz")
        assert code == 200 and body["status"] == "ready"
        loop.begin_drain()
        code, body = _get(base, "/readyz")
        assert code == 503 and body["status"] == "not-ready" and body["draining"] is True
        assert _get(base, "/healthz")[0] == 200
    finally:
        gw.stop()
        loop.stop()


def test_readyz_router_fleet(params):
    """Router readiness behind the gateway: ready while any replica accepts;
    the fleet /metrics text stays lint-clean with both replicas' series."""
    router = _fleet(PORT, params)
    gw = ServingGateway(router, port=0)
    router.start()
    gw.start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        code, body = _get(base, "/readyz")
        assert code == 200 and body["replicas"] == {"0": "active", "1": "active"}
        router.drain(0)
        assert _get(base, "/readyz")[0] == 200
        router.drain(1)
        assert _get(base, "/readyz")[0] == 503
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            text = r.read().decode()
        assert lint_exposition(text) == []
        assert 'replica="0"' in text and 'replica="1"' in text
    finally:
        gw.stop()
        router.stop()


# -- Retry-After jitter -----------------------------------------------------


def test_retry_after_jitter_deterministic_and_bounded(params):
    from pretraining_llm_tpu.frontend.gateway import ServingGateway as JaxGateway

    loop = EngineLoop(_engine_factory(PORT, params)())
    for seed in (7, 8):
        a = ServingGateway(loop, port=0, retry_jitter_frac=0.5, retry_jitter_seed=seed)
        j = JaxGateway(loop, port=0, retry_jitter_frac=0.5, retry_jitter_seed=seed)
        seq = [a.retry_after_header(4.0) for _ in range(20)]
        assert seq == [j.retry_after_header(4.0) for _ in range(20)]
        assert all(4 <= int(v) <= 6 for v in seq) and len(set(seq)) > 1
        a._server.server_close()
        j._server.server_close()
    with pytest.raises(ValueError, match="retry_jitter_frac"):
        ServingGateway(loop, port=0, retry_jitter_frac=1.5)


# -- typed fleet metrics ----------------------------------------------------


def test_render_merged_one_vocabulary():
    """``render_merged`` (no caller before the router) gives the JAX
    package's text on the same registries, and fails as it does on a
    conflicting kind."""
    texts = []
    for mod in (tmetrics, jmetrics):
        fleet = mod.MetricsRegistry("pllm_serving_")
        r0 = mod.MetricsRegistry("pllm_serving_", const_labels={"replica": 0})
        r1 = mod.MetricsRegistry("pllm_serving_", const_labels={"replica": 1})
        fleet.counter("redrives_total", "redrives").inc(2)
        for reg in (r0, r1):
            reg.counter("http_errors_total", "errors").inc(1)
            reg.gauge("queue_depth", "depth").set(3)
        texts.append(mod.render_merged([fleet, r0, r1], {"replicas_active": 2.0}))
        bad = mod.MetricsRegistry("pllm_serving_")
        bad.gauge("http_errors_total", "oops")
        with pytest.raises(ValueError, match="registered as"):
            mod.render_merged([r0, bad], None)
    text = texts[0]
    assert text == texts[1]
    assert lint_exposition(text) == []
    assert text.count("# TYPE pllm_serving_http_errors_total counter") == 1
    assert 'pllm_serving_queue_depth{replica="1"} 3' in text and "pllm_serving_replicas_active 2" in text


def test_fleet_typed_metrics_after_drill(params):
    registry = PORT.MetricsRegistry("pllm_serving_")
    router = _fleet(PORT, params, faults=PORT.Injector("replica_crash@req2:r0"), registry=registry)
    with router:
        for r in [router.submit(p, 6) for p in _prompts(5)]:
            assert r.result(timeout=WAIT)[0] == "done"
        text = router.render_metrics(router.metrics())
    assert lint_exposition(text) == []
    assert "pllm_serving_redrives_total" in text
    assert "pllm_serving_replica_ejects_total 1" in text
    assert 'pllm_serving_replica_state{replica="1"} 1' in text


# -- loadgen and config fleet fields ----------------------------------------


def test_loadspec_priority_rng_neutral():
    for kw in (dict(n_requests=12, seed=11), dict(n_requests=12, seed=11, priority_hi_frac=0.5, priority_hi=2)):
        got = tloadgen.build_schedule(tloadgen.LoadSpec(**kw))
        want = jloadgen.build_schedule(jloadgen.LoadSpec(**kw))
        assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
    base = tloadgen.build_schedule(tloadgen.LoadSpec(n_requests=12, seed=11))
    assert tloadgen.build_schedule(tloadgen.LoadSpec(n_requests=12, seed=11, priority_hi_frac=0.0)) == base
    with pytest.raises(ValueError, match="priority_hi_frac"):
        tloadgen.LoadSpec(priority_hi_frac=1.5)


def test_frontend_config_fleet_validation():
    assert tcfg.FrontendConfig(replicas=3, serving_faults="replica_crash@req2:r0").replicas == 3
    for kw in (dict(replicas=0), dict(spill_margin=0), dict(eject_backoff_s=2.0, eject_backoff_max_s=1.0),
               dict(brownout_min_healthy_frac=2.0), dict(retry_jitter_frac=-0.1), dict(journal_rotate_mb=-1.0),
               dict(probe_interval_s=-0.5), dict(probe_count=0)):
        with pytest.raises(ValueError) as want:
            jcfg.FrontendConfig(**kw)
        with pytest.raises(ValueError) as got:
            tcfg.FrontendConfig(**kw)
        assert str(got.value) == str(want.value)


# -- fleet observability ----------------------------------------------------


def _drill_events(side, params, tmp_path, n=6, n_new=8):
    path = tmp_path / f"events-{side.name}.jsonl"
    bus = side.EventBus(jsonl_path=str(path))
    router = _fleet(side, params, faults=side.Injector("replica_crash@req2:r0", bus=bus), bus=bus)
    with router:
        for r in [router.submit(p, n_new) for p in _prompts(n)]:
            assert r.result(timeout=WAIT)[0] == "done"
        _wait(lambda: all(rep.accepting for rep in router.replicas), 5.0, "relaunch")
    bus.close()
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def test_fleet_report_conservation_and_recovery(params, tmp_path):
    """The crash drill's events pass the fleet gate on both packages'
    streams; the port's ``obs_report`` and the JAX script give one report
    on the port's events; dropping a terminal is caught as a loss."""
    reports = {}
    for side in (JAX, PORT):
        events = _drill_events(side, params, tmp_path)
        report = obs_report.build_fleet_report(events)
        assert report == jobs_report.build_fleet_report(events)
        assert report["problems"] == [] and report["lost_requests"] == 0
        assert report["n_submitted"] == report["n_terminal"] == 6
        assert report["statuses"] == {"done": 6}
        assert report["redrive_cost"]["redrive_events"] >= 1
        ejected = [i for i in report["incidents"] if i["kind"] == "ejected" and i["recovery_s"] is not None]
        assert ejected and ejected[0]["replica"] == 0 and ejected[0]["recovery_s"] > 0
        reports[side.name] = report
        term = next(e for e in events if e.get("event") == "fleet_req_terminal")
        broken = obs_report.build_fleet_report([e for e in events if e is not term])
        assert any("LOST" in p for p in broken["problems"])
    for key in ("n_submitted", "n_terminal", "statuses", "lost_requests", "problems"):
        assert reports["torch"][key] == reports["jax"][key], key


def test_injected_crash_is_attributable(params, tmp_path):
    for side in (JAX, PORT):
        fired = [e for e in _drill_events(side, params, tmp_path, n=4, n_new=6)
                 if e.get("event") == "fault_injected"]
        assert [(e["fault"], e["replica"], e["req_n"]) for e in fired] == [("replica_crash", 0, 2)]


def test_router_stop_terminates_live_requests(params):
    router = _fleet(PORT, params)
    router.start()
    _slow_ticks(router, 0.05)
    reqs = [router.submit(p, 50) for p in _prompts(4)]
    time.sleep(0.1)
    router.stop(timeout=5.0)
    for r in reqs:
        status, _, info = r.result(timeout=5.0)
        assert status in ("done", "error")
        if status == "error":
            assert "shutdown" in info["reason"]


# -- the write-ahead journal ------------------------------------------------


def _journal_scenario(mod, path):
    j = mod.FleetJournal(path)
    j.append({"rec": "member", "replica": 0, "mode": "inproc"})
    j.append({"rec": "submit", "frid": 0, "prompt": [1, 2], "max_new": 4})
    j.close()
    j.append({"rec": "terminal", "frid": 0, "status": "done"})  # dropped: closed
    first = [r["rec"] for r in mod.FleetJournal.load(path)]
    j2 = mod.FleetJournal(path)
    j2.append({"rec": "terminal", "frid": 0, "status": "done"})
    j2.close()
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"rec": "frontier", "frid": 0, "tok')  # a torn final line
    return first, mod.FleetJournal.load(path)


def test_journal_roundtrip_torn_line_and_recovery_plan(tmp_path):
    got = _journal_scenario(tjournal, str(tmp_path / "t.jsonl"))
    assert got == _journal_scenario(jjournal, str(tmp_path / "j.jsonl"))
    assert got[0] == ["member", "submit"] and len(got[1]) == 3
    assert tjournal.FleetJournal.load(str(tmp_path / "missing.jsonl")) == []
    records = [
        {"rec": "member", "replica": 0, "mode": "attach"},
        {"rec": "fence", "replica": 0, "fence": 1}, {"rec": "fence", "replica": 0, "fence": 3},
        {"rec": "fence", "replica": 1, "fence": 0},
        {"rec": "submit", "frid": 0, "prompt": [1], "max_new": 4, "priority": 0, "deadline_s": None},
        {"rec": "submit", "frid": 1, "prompt": [2, 3], "max_new": 6, "priority": 1, "deadline_s": 2.0},
        {"rec": "submit", "frid": 2, "prompt": [4], "max_new": 4, "priority": 0, "deadline_s": None},
        {"rec": "frontier", "frid": 1, "tokens": [9, 8, 7], "redrives": 1},
        {"rec": "terminal", "frid": 0, "status": "done"},
    ]
    plan = tjournal.FleetJournal.recovery_plan(records)
    assert plan == jjournal.FleetJournal.recovery_plan(records)
    assert plan["fences"] == {0: 3, 1: 0} and plan["next_frid"] == 3 and sorted(plan["live"]) == [1, 2]
    with pytest.raises(ValueError, match="journal_path"):
        trouter.Router([treplica.Replica(0, lambda: None)], recover=True)


def _rotation_scenario(mod, path):
    with pytest.raises(ValueError, match="rotate_bytes"):
        mod.FleetJournal(path, rotate_bytes=-1)
    j = mod.FleetJournal(path, rotate_bytes=4096)
    j.append({"rec": "fence", "replica": 0, "fence": 2})
    j.append({"rec": "fence", "replica": 1, "fence": 5})
    for frid in range(24):
        j.append({"rec": "submit", "frid": frid, "prompt": list(range(64)), "max_new": 4,
                  "priority": frid % 3, "deadline_s": None, "trace_id": f"{frid:032x}"})
        if frid != 21:
            j.append({"rec": "terminal", "frid": frid, "status": "done"})
    j.append({"rec": "frontier", "frid": 21, "tokens": [9, 8], "redrives": 1})
    rotated = (j.rotations >= 1, os.path.getsize(path) < 4096, os.path.exists(path + ".rotate"))
    plan = mod.FleetJournal.recovery_plan(mod.FleetJournal.load(path))
    j.append({"rec": "terminal", "frid": 21, "status": "done"})
    j.close()
    return rotated, plan, mod.FleetJournal.recovery_plan(mod.FleetJournal.load(path))


def test_journal_rotation_compacts_to_recovery_plan(tmp_path):
    got = _rotation_scenario(tjournal, str(tmp_path / "t.jsonl"))
    assert got == _rotation_scenario(jjournal, str(tmp_path / "j.jsonl"))
    (rotated, plan, after) = got
    assert rotated == (True, True, False)
    assert plan["fences"] == {0: 2, 1: 5} and plan["next_frid"] == 24 and sorted(plan["live"]) == [21]
    assert plan["live"][21]["tokens"] == [9, 8] and plan["live"][21]["trace_id"] == f"{21:032x}"
    assert after["live"] == {} and after["next_frid"] == 24


def test_router_recovers_the_journal_bit_identical(params, tmp_path):
    """A router dies (``abort``) with requests in flight; a new router over
    fresh replicas recovers the journal and finishes exactly the requests
    that had no terminal, each from its journaled frontier, bit-identical
    to the undisturbed streams."""
    prompts = _prompts(6)
    n_new = 10
    ref = _undisturbed(PORT, params, prompts, n_new)
    journal = str(tmp_path / "fleet.jsonl")
    router1 = _fleet(PORT, params, journal_path=journal)
    router1.start()
    _slow_ticks(router1, 0.02)
    reqs = [router1.submit(p, n_new) for p in prompts]
    reqs[0].result(timeout=WAIT)
    router1.abort()
    for rep in router1.replicas:
        rep.stop(timeout=5.0)
    plan = tjournal.FleetJournal.recovery_plan(tjournal.FleetJournal.load(journal))
    pending = set(plan["live"])
    assert pending and 0 not in pending
    router2 = _fleet(PORT, params, journal_path=journal, recover=True)
    with router2:
        assert set(router2.recovered) == pending
        assert router2.counters["journal_replays"] == len(pending)
        for frid, rreq in router2.recovered.items():
            status, tokens, _ = rreq.result(timeout=WAIT)
            assert status == "done" and tokens == ref[frid], f"replayed request {frid} diverged"
    final = tjournal.FleetJournal.recovery_plan(tjournal.FleetJournal.load(journal))
    assert final["live"] == {}


# -- serve --http --replicas N ----------------------------------------------


def _post(base, payload, timeout=WAIT):
    req = urllib.request.Request(f"{base}/v1/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _start_serve(ckpt, extra, stderr_path):
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    err = open(stderr_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pretraining_llm_tpu_torch.serve", "--model_path", ckpt, "--http", "--port", "0",
         "--device", "cpu", "--temperature", "0", "--tokenizer", "byte", "--block_size", "8", "--n_blocks", "64",
         "--max_batch", "4", "--prefix_cache"] + extra,
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err, text=True)
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        text = Path(stderr_path).read_text()
        if "listening on " in text:
            return proc, text.split("listening on ")[1].split(" ")[0]
        assert proc.poll() is None, f"the server exited before listening:\n{text}"
        time.sleep(0.05)
    proc.kill()
    raise AssertionError("the server did not listen in time")


def _stop_serve(proc, stderr_path):
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=WAIT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
    return proc.returncode, Path(stderr_path).read_text()


def test_serve_fleet_subprocess_probes_journal_and_recover(tmp_path):
    """``python -m pretraining_llm_tpu_torch.serve --http --replicas 2`` with
    a journal, golden probes every 0.2 s and ``corrupt_weights@req4:r1``:
    traffic until the sentinel quarantines replica 1 (and it relaunches),
    then 16 requests whose streams equal the offline engine's; SIGTERM
    drains, the journal holds no live request, a ``--recover`` start
    replays none and serves; the port's ``obs_report --fleet --fleet-trace
    --integrity --strict`` passes on the files."""
    from pretraining_llm_tpu_torch.generation.generate import load_model_for_inference
    from pretraining_llm_tpu_torch.models import transformer
    from pretraining_llm_tpu_torch.training import checkpoint as ckpt

    model = dataclasses.replace(CFG, vocab_size=260)
    conf = tcfg.Config(model=model, data=tcfg.DataConfig(tokenizer_name="byte"))
    ckpt.save_checkpoint(str(tmp_path / "ck"), 0, {"params": transformer.init_params(model, 0, device="cpu")},
                         extra={"step": 0, "config": dataclasses.asdict(conf)})
    rng = np.random.default_rng(3)
    texts = ["".join(chr(97 + int(c)) for c in rng.integers(0, 26, size=int(n))) for n in rng.integers(3, 30, 16)]
    params, cfg = load_model_for_inference(str(tmp_path / "ck"), device="cpu")
    eng = tserving.ServingEngine(params, cfg.model, temperature=0.0, max_batch=4, n_blocks=64, block_size=8,
                                 device="cpu")
    rids = [eng.submit(list(t.encode()), 8) for t in texts]
    out = eng.run()
    ref = [out[r] for r in rids]

    journal, events, trace = tmp_path / "journal.jsonl", tmp_path / "events.jsonl", tmp_path / "trace.json"
    proc, base = _start_serve(str(tmp_path / "ck"), [
        "--replicas", "2", "--journal_path", str(journal), "--probe_interval_s", "0.2",
        "--serving_faults", "corrupt_weights@req4:r1",
        "--events", str(events), "--trace", str(trace)], tmp_path / "serve.err")
    try:
        sent = 0
        while sent < 64:
            _post(base, {"prompt": texts[sent % 16], "max_new_tokens": 8})
            sent += 1
            ready = json.loads(urllib.request.urlopen(f"{base}/readyz", timeout=30).read())
            if ready["integrity"]["quarantines"] >= 1:
                break
        assert ready["integrity"]["quarantines"] >= 1, ready
        _wait(lambda: json.loads(urllib.request.urlopen(f"{base}/readyz", timeout=30).read())["replicas"]
              == {"0": "active", "1": "active"}, 30.0, "the relaunch")
        got = [_post(base, {"prompt": t, "max_new_tokens": 8})[1] for t in texts]
        assert [b["status"] for b in got] == ["done"] * 16
        assert [b["tokens"] for b in got] == ref
    finally:
        rc, err = _stop_serve(proc, tmp_path / "serve.err")
    assert rc == 0, err
    assert "(2 replicas)" in err and "SIGTERM drain complete" in err
    kinds = [json.loads(ln) for ln in events.read_text().splitlines()]
    quars = [e for e in kinds if e["event"] == "integrity_quarantine"]
    assert quars and {e["replica"] for e in quars} == {1}
    assert tjournal.FleetJournal.recovery_plan(tjournal.FleetJournal.load(str(journal)))["live"] == {}
    import subprocess
    import sys

    res = subprocess.run([sys.executable, "-m", "pretraining_llm_tpu_torch.obs_report", "--json", "--strict",
                          "--fleet", "--fleet-trace", "--integrity", "--trace", str(trace), str(events)],
                         cwd=ROOT, capture_output=True, text=True, timeout=WAIT)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout)
    assert report["fleet"]["lost_requests"] == 0 and report["integrity"]["quarantines"] >= 1

    proc, base = _start_serve(str(tmp_path / "ck"), ["--replicas", "2", "--journal_path", str(journal),
                                                     "--recover"], tmp_path / "recover.err")
    try:
        assert _post(base, {"prompt": texts[0], "max_new_tokens": 8})[1]["tokens"] == ref[0]
    finally:
        rc, err = _stop_serve(proc, tmp_path / "recover.err")
    assert rc == 0, err
    assert "'journal_replays': 0" in err


def test_serve_fleet_roles_disaggregate(tmp_path):
    """``--replicas 2 --replica_roles prefill,decode``: the decode replica
    serves every request, KV pages migrate, and the streams equal the
    offline engine's."""
    from pretraining_llm_tpu_torch.generation.generate import load_model_for_inference
    from pretraining_llm_tpu_torch.models import transformer
    from pretraining_llm_tpu_torch.training import checkpoint as ckpt

    model = dataclasses.replace(CFG, vocab_size=260)
    conf = tcfg.Config(model=model, data=tcfg.DataConfig(tokenizer_name="byte"))
    ckpt.save_checkpoint(str(tmp_path / "ck"), 0, {"params": transformer.init_params(model, 1, device="cpu")},
                         extra={"step": 0, "config": dataclasses.asdict(conf)})
    texts = ["the same long prefix of the prompt " + s for s in ("a", "bb", "ccc", "dddd")]
    params, cfg = load_model_for_inference(str(tmp_path / "ck"), device="cpu")
    eng = tserving.ServingEngine(params, cfg.model, temperature=0.0, max_batch=4, n_blocks=64, block_size=8,
                                 device="cpu")
    rids = [eng.submit(list(t.encode()[-60:]), 4) for t in texts]
    out = eng.run()
    events = tmp_path / "events.jsonl"
    proc, base = _start_serve(str(tmp_path / "ck"), ["--replicas", "2", "--replica_roles", "prefill,decode",
                                                     "--events", str(events)], tmp_path / "serve.err")
    try:
        got = [_post(base, {"prompt": t, "max_new_tokens": 4})[1] for t in texts]
    finally:
        rc, err = _stop_serve(proc, tmp_path / "serve.err")
    assert rc == 0, err
    assert [b["tokens"] for b in got] == [out[r] for r in rids]
    migrations = [json.loads(ln) for ln in events.read_text().splitlines() if '"kv_migrate"' in ln]
    assert migrations and all(e["to_replica"] == 1 and e["from_replica"] == 0 for e in migrations)
    assert sum(e["pages"] for e in migrations) >= 1
