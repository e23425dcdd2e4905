"""The port's process replicas (``frontend/worker.py``,
``frontend/remote_replica.py``) under the router, against the JAX package's
in-process engine.

Mirrors ``tests/test_process_fleet.py``'s drills and the process cases of
``tests/test_kv_transfer.py``: port workers (real processes on the CPU,
loading the JAX package's tiny fp32 weights from a checkpoint) behind the
port's ``Router``. A worker SIGKILLed mid-decode, a dropped connection or
a wedged worker costs no request: every greedy stream equals the JAX
package's ``ServingEngine`` on the same weights, token for token. Rolling
upgrades are vetted by golden probes built in the worker; a corrupt (or
crashing) upgrade is refused and the old spec restored. Disaggregated
prefill migrates KV pages over TCP, a prefill worker killed mid-leg falls
back, and a page flipped in flight is rejected by digest. The serve CLI's
``--replica_mode process`` runs as a subprocess with a ``worker_kill``
drill, and the port's ``obs_report --fleet --fleet-trace --strict`` reads
its files (worker spans on the router's clock within their
``clock_err_s``) as the JAX script does. The kill grid's other cells are
``slow``, as in JAX.
"""

import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from contextlib import redirect_stdout

import pytest

import _torch_workers as W
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu_torch import obs_report
from pretraining_llm_tpu_torch.frontend.loadgen import FleetAction, run_fleet_plan
from pretraining_llm_tpu_torch.frontend.remote_replica import RemoteReplica
from pretraining_llm_tpu_torch.frontend.router import Router
from pretraining_llm_tpu_torch.observability.events import EventBus
from pretraining_llm_tpu_torch.observability.export import lint_exposition
from pretraining_llm_tpu_torch.observability.metrics import MetricsRegistry, render_merged
from pretraining_llm_tpu_torch.resilience.faults import ServingFaultInjector

_spec = importlib.util.spec_from_file_location("obs_report_for_port_proc_fleet", W.ROOT / "scripts" / "obs_report.py")
jobs_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jobs_report)


@pytest.fixture(scope="module", autouse=True)
def _worker_threads():
    saved = {k: os.environ.get(k) for k in W.WORKER_ENV}
    os.environ.update(W.WORKER_ENV)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return W.write_checkpoint(tmp_path_factory.mktemp("proc_fleet") / "ck")


def _proc_fleet(ckpt, n=2, faults=None, bus=None, engine_kw=None, replica_kw=None, specs=None, **router_kw):
    reps = [
        RemoteReplica(i, specs[i] if specs else W.worker_spec(ckpt, **(engine_kw or {})), bus=bus,
                      fault_injector=faults, spawn_timeout_s=W.SPAWN_S, **(replica_kw or {}))
        for i in range(n)
    ]
    W.start_all(reps)
    router_kw.setdefault("eject_backoff_s", 60.0)
    return Router(reps, bus=bus, **router_kw)


def _results(router, prompt_list, n_new):
    reqs = [router.submit(p, n_new) for p in prompt_list]
    return [r.result(timeout=W.WAIT) for r in reqs]


def _same(a, b):
    """Equal reports (NaN, where a percentile has no sample, equals NaN)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _assert_streams(results, ref):
    for i, (status, tokens, info) in enumerate(results):
        assert status == "done", (i, status, info)
        assert tokens == ref[i], f"request {i} diverged from the JAX engine"


# -- worker death mid-decode: zero lost, streams equal JAX's -----------------

# Tokens each drilled request decodes: the port's CPU engine decodes JAX's 6
# before the parent has handled the submit's reply, and the fault, fired
# right after that reply, would then find nothing in flight to redrive.
N_DRILL = 24

_KILL_GRID = [(1, False), (1, True), (2, True), (3, False), (3, True)]


@pytest.mark.slow
@pytest.mark.parametrize("depth,cache", _KILL_GRID)
def test_worker_kill9_streams_equal_jax(ckpt, depth, cache):
    """SIGKILL a worker with requests mid-decode: eject, redrive onto the
    survivor, every stream the JAX engine's at every depth, cache on/off."""
    prompt_list, n_new = W.prompts(4), N_DRILL
    kw = dict(pipeline_depth=depth, prefix_cache=cache)
    ref = W.undisturbed(prompt_list, n_new, **kw)
    router = _proc_fleet(ckpt, faults=ServingFaultInjector("worker_kill@req2:r0"), engine_kw=kw)
    with router:
        results = _results(router, prompt_list, n_new)
    _assert_streams(results, ref)
    assert router.counters["redrives"] >= 1 and router.counters["ejects"] == 1


def test_worker_death_obs_join_and_relaunch(ckpt, tmp_path):
    """The kill grid's (depth 2, cache off) cell: worker dies -> redrives
    (streams equal JAX's) -> a fresh worker process -> fleet healthy; the
    port's fleet report equals the JAX script's and joins the death to its
    redrives."""
    prompt_list, n_new = W.prompts(4), N_DRILL
    ref = W.undisturbed(prompt_list, n_new)
    path = tmp_path / "events.jsonl"
    bus = EventBus(jsonl_path=str(path))
    registry = MetricsRegistry("pllm_serving_")
    router = _proc_fleet(ckpt, faults=ServingFaultInjector("worker_kill@req2:r0", bus=bus), bus=bus,
                         registry=registry, eject_backoff_s=0.2)
    with router:
        _assert_streams(_results(router, prompt_list, n_new), ref)
        assert router.counters["redrives"] >= 1
        W.wait_until(lambda: all(rep.accepting for rep in router.replicas), 60, "the killed replica never came back")
        assert router.replicas[0].generation >= 2 and router.counters["relaunches"] >= 1
        text = render_merged([registry] + [rep.registry for rep in router.replicas])
        assert lint_exposition(text) == []
        assert "pllm_serving_worker_spawns_total" in text and "pllm_serving_replica_relaunch_total" in text
    bus.close()
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    report = obs_report.build_fleet_report(events)
    assert _same(report, jobs_report.build_fleet_report(events))
    assert report["problems"] == [] and report["lost_requests"] == 0
    assert report["statuses"] == {"done": 4}
    w = report["workers"]
    assert w["spawns"] >= 3 and w["exits_unclean"] >= 1
    deaths = [d for d in w["process_deaths"] if d["replica"] == 0]
    assert deaths and deaths[0]["redrives_caused"] >= 1 and deaths[0]["respawned"]


def test_conn_drop_redrives_without_killing_worker(ckpt):
    """A severed socket with a healthy worker behind it looks like death
    from the parent's side: eject, redrive, nothing lost."""
    prompt_list = W.prompts(4)
    ref = W.undisturbed(prompt_list, N_DRILL)
    router = _proc_fleet(ckpt, faults=ServingFaultInjector("conn_drop@req2:r0"))
    try:
        with router:
            results = _results(router, prompt_list, N_DRILL)
            assert router.replicas[0].state == "ejected"
            assert router.replicas[0].proc.poll() is None, "conn_drop must leave the worker alive"
            W.kill_worker(router.replicas[0])
    finally:
        for rep in router.replicas:
            W.kill_worker(rep)
    _assert_streams(results, ref)
    assert router.counters["redrives"] >= 1 and router.counters["ejects"] >= 1


def test_worker_stall_detected_by_rpc_timeout(ckpt):
    """A wedged worker (alive, never replying) is caught by RPC timeout and
    retry exhaustion, and its requests redrive: the timeout path."""
    prompt_list = W.prompts(4)
    ref = W.undisturbed(prompt_list, N_DRILL)
    router = _proc_fleet(ckpt, faults=ServingFaultInjector("worker_stall@req2:r0"),
                         replica_kw=dict(rpc_timeout_s=0.6, rpc_retries=1))
    try:
        with router:
            results = _results(router, prompt_list, N_DRILL)
            stalled = router.replicas[0]
            # The stalled worker's streams may finish before the next health
            # poll times out: the detection is waited for, bounded.
            W.wait_until(lambda: router.counters["ejects"] >= 1, 30, "the stalled worker was never ejected")
            assert stalled.registry.counter("worker_rpc_timeouts_total", "").value >= 1
            assert stalled.registry.counter("worker_rpc_retries_total", "").value >= 1
            W.kill_worker(stalled)
    finally:
        for rep in router.replicas:
            W.kill_worker(rep)
    _assert_streams(results, ref)
    assert router.counters["ejects"] >= 1


def test_worker_orphan_exits_when_parent_pipe_closes(ckpt):
    """A worker whose parent vanished (stdin EOF) drains and exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "pretraining_llm_tpu_torch.frontend.worker", "--spec-json",
         json.dumps(W.worker_spec(ckpt))],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=W.worker_env(), cwd=W.ROOT)
    try:
        assert json.loads(proc.stdout.readline())["worker"]["pid"] == proc.pid
        proc.stdin.close()
        assert proc.wait(timeout=60) == 0
    finally:
        W.kill_procs([proc])


def test_redrive_budget_exhaustion_is_terminal(ckpt):
    """With no redrive budget a killed worker's requests end in a clean
    error terminal, not a redrive storm; the others' streams are JAX's and
    the fleet heals."""
    prompt_list = W.prompts(5)
    ref = W.undisturbed(prompt_list, N_DRILL)
    router = _proc_fleet(ckpt, faults=ServingFaultInjector("worker_kill@req2:r0"), eject_backoff_s=0.1,
                         redrive_max=0)
    with router:
        results = _results(router, prompt_list, N_DRILL)
        exhausted = [info for status, _, info in results if status == "error"]
        assert exhausted, "the kill must have caught requests in flight"
        assert all("redrive budget exhausted" in info["reason"] for info in exhausted)
        assert router.counters["redrives"] == 0
        for i, (status, tokens, _) in enumerate(results):
            assert status in ("done", "error")
            if status == "done":
                assert tokens == ref[i]
        W.wait_until(lambda: all(rep.accepting for rep in router.replicas), 60, "the fleet did not heal")


# -- probe-vetted rolling upgrades --------------------------------------------


def test_rolling_upgrade_vetting_gates_traffic(ckpt, tmp_path):
    """Clean upgrade: drained, relaunched, probe-vetted, then active. A
    corrupt upgrade diverges on the held worker: refused, the old spec
    restored verbatim, back in service; clients never see it. The workers
    run the prefix cache, so the router pins each probe on a miss (the
    workers' caches flushed through ``prefix_flush``) and on a hit."""
    path = tmp_path / "events.jsonl"
    bus = EventBus(jsonl_path=str(path))
    prompt_list = W.prompts(3)
    ref = W.undisturbed(prompt_list, 6, prefix_cache=True)
    router = _proc_fleet(ckpt, bus=bus, probe_interval_s=60.0, engine_kw={"prefix_cache": True})
    with router:
        assert all(rep.engine.has_prefix_cache for rep in router.replicas)
        flushed = [rep.engine.flush_prefix_cache(timeout=W.WAIT) for rep in router.replicas]
        assert all(n >= 1 for n in flushed), flushed  # the pins' hits published the probe prefix
        assert router.upgrade_replica(0) is True
        rep = router.replicas[0]
        assert rep.state == "active" and rep.generation == 2
        assert router.upgrade_replica(0, {"corrupt_weights": True}) is False
        assert rep.state == "active" and "corrupt_weights" not in rep.spec
        assert router.counters["upgrades"] == 2 and router.counters["upgrades_refused"] == 1
        _assert_streams(_results(router, prompt_list, 6), ref)
    bus.close()
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    report = obs_report.build_fleet_report(events)
    assert _same(report, jobs_report.build_fleet_report(events))
    assert report["problems"] == []
    u = report["upgrades"]
    assert (u["started"], u["vetted"], u["refused"], u["rolled_back"], u["restored"]) == (2, 1, 1, 1, 1)


def test_mid_upgrade_kill_never_exposes_unvetted_weights(ckpt):
    """The upgraded worker carries corrupt weights and SIGKILLs itself on
    its first vetting probe while client traffic runs: refused, the old
    spec restored, every client stream JAX's."""
    prompt_list, n_new = W.prompts(6), 6
    ref = W.undisturbed(prompt_list, n_new)
    router = _proc_fleet(ckpt, probe_interval_s=60.0)
    with router:
        plan = run_fleet_plan(router, [FleetAction(at_s=0.3, kind="upgrade", replica=0,
                                                   update={"corrupt_weights": True, "kill_after_submits": 1})])
        results = _results(router, prompt_list, n_new)
        plan.join(timeout=W.WAIT)
        assert not plan.is_alive()
        rep = router.replicas[0]
        assert router.counters["upgrades_refused"] == 1 and rep.state == "active"
        assert "corrupt_weights" not in rep.spec and "kill_after_submits" not in rep.spec
        assert all(r.accepting for r in router.replicas)
    _assert_streams(results, ref)


# -- disaggregated prefill over TCP -------------------------------------------


def _disagg_specs(ckpt, **prefill_extra):
    pre = dict(W.worker_spec(ckpt, **W.KV_KW), role="prefill", **prefill_extra)
    return [pre, dict(W.worker_spec(ckpt, **W.KV_KW), role="decode")]


def test_process_disagg_streams_equal_jax(ckpt):
    prompt_list, n_new = W.shared_prefix_prompts(3, tail=3), 8
    ref = W.undisturbed(prompt_list, n_new, **W.KV_KW)
    router = _proc_fleet(ckpt, specs=_disagg_specs(ckpt))
    reps = router.replicas
    with router:
        assert reps[0].role == "prefill" and reps[1].role == "decode"
        assert reps[0].kv_capable and reps[1].kv_capable
        results = [router.submit(p, n_new).result(timeout=W.WAIT) for p in prompt_list]
        stats = reps[1].loop.debug_engine()["stats"]
    _assert_streams(results, ref)
    assert all(info["replica"] == 1 for _, _, info in results)
    assert router.counters["kv_migrations"] >= 1 and router.counters["kv_pages_migrated"] >= 1
    assert router.counters["kv_migration_rejects"] == 0
    assert stats.get("kv_pages_adopted", 0) >= 1


def test_process_prefill_kill_mid_leg_falls_back(ckpt):
    """The prefill worker SIGKILLs itself after acking its first submit,
    request 0's prefill leg: both requests finish on the decode tier with
    JAX's streams, and no page crosses."""
    prompt_list, n_new = W.distinct_prompts(2, seed=3), 6
    ref = W.undisturbed(prompt_list, n_new, **W.KV_KW)
    router = _proc_fleet(ckpt, specs=_disagg_specs(ckpt, kill_after_submits=1))
    with router:
        results = [router.submit(p, n_new).result(timeout=W.WAIT) for p in prompt_list]
    _assert_streams(results, ref)
    assert router.counters["kv_pages_migrated"] == 0


def test_process_corrupt_kv_migration_over_tcp(ckpt):
    """The parent flips a byte of a page as the transfer leaves; the decode
    worker's adoption catches the digest; the streams do not change."""
    prompt_list, n_new = W.distinct_prompts(3), 8
    ref = W.undisturbed(prompt_list, n_new, **W.KV_KW)
    events = []
    bus = EventBus()
    bus.subscribe(events.append)
    router = _proc_fleet(ckpt, specs=_disagg_specs(ckpt), bus=bus,
                         faults=ServingFaultInjector("corrupt_kv_migration@req1:r1", bus=bus))
    with router:
        results = [router.submit(p, n_new).result(timeout=W.WAIT) for p in prompt_list]
    _assert_streams(results, ref)
    assert router.counters["kv_migrations"] == 3 and router.counters["kv_migration_rejects"] >= 1
    rejects = [ev for ev in events if ev.get("event") == "kv_migration_reject"]
    assert rejects and rejects[0]["reason"] == "checksum_mismatch" and rejects[0]["replica"] == 1


# -- the serve CLI's process replicas ------------------------------------------


def test_serve_cli_process_replicas_with_a_worker_kill(ckpt, tmp_path):
    """``serve --http --replica_mode process --replicas 2`` with
    ``worker_kill@req2:r0``: every response's tokens are the JAX engine's,
    SIGTERM drains, and the port's ``obs_report --fleet --fleet-trace
    --strict`` passes over the events and the merged trace (worker spans on
    the router's clock), its ``--json`` equal to the JAX script's."""
    prompt_list, n_new = W.prompts(4), 6
    ref = W.undisturbed(prompt_list, n_new)
    events, trace = tmp_path / "events.jsonl", tmp_path / "trace.json"
    err = open(tmp_path / "stderr.txt", "w+")
    cmd = [sys.executable, "-m", "pretraining_llm_tpu_torch.serve", "--model_path", ckpt, "--http", "--port", "0",
           "--device", "cpu", "--tokenizer", "byte", "--temperature", "0", "--max_batch", "2", "--n_blocks", "24",
           "--block_size", "8", "--steps_per_sched", "4", "--pipeline_depth", "2", "--replica_mode", "process",
           "--replicas", "2", "--serving_faults", "worker_kill@req2:r0", "--events", str(events),
           "--trace", str(trace), "--seed", "5"]
    proc = subprocess.Popen(cmd, cwd=W.ROOT, env=W.worker_env(), stdout=subprocess.DEVNULL, stderr=err, text=True)
    try:
        W.wait_until(lambda: "listening on " in (tmp_path / "stderr.txt").read_text() or proc.poll() is not None,
                     W.WAIT, "the server did not listen")
        text = (tmp_path / "stderr.txt").read_text()
        assert proc.poll() is None, text[-3000:]
        base = text.split("listening on ", 1)[1].split(" ")[0]
        got = {}
        for i, p in enumerate(prompt_list):
            req = urllib.request.Request(base + "/v1/generate", data=json.dumps(
                {"prompt": p, "max_new_tokens": n_new}).encode(), headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=W.WAIT) as r:
                got[i] = json.loads(r.read())["tokens"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=W.WAIT) == 0
    finally:
        W.kill_procs([proc])
        err.close()
    text = (tmp_path / "stderr.txt").read_text()
    assert "(2 replicas)" in text and "SIGTERM drain complete" in text and "trace written" in text, text[-3000:]
    assert got == ref
    evs = [json.loads(ln) for ln in events.read_text().splitlines()]
    assert any(e["event"] == "fault_fired" and e.get("fault") == "worker_kill" for e in evs)
    remote = [ev for ev in json.loads(trace.read_text())["traceEvents"] if ev.get("args", {}).get("remote")]
    assert remote and all("clock_err_s" in ev["args"] for ev in remote)
    saved, sys.argv = sys.argv, ["obs_report", "--strict", "--fleet", "--fleet-trace", "--trace", str(trace),
                                 str(events)]
    try:
        with redirect_stdout(io.StringIO()) as buf:
            assert obs_report.main() == 0, buf.getvalue()[-3000:]
    finally:
        sys.argv = saved
    trace_obj = json.loads(trace.read_text())
    fleet, fleet_trace = obs_report.build_fleet_report(evs), obs_report.build_fleet_trace_report(trace_obj, evs)
    assert _same(fleet, jobs_report.build_fleet_report(evs))
    assert _same(fleet_trace, jobs_report.build_fleet_trace_report(trace_obj, evs))
    assert fleet["lost_requests"] == 0 and fleet["problems"] == []
    assert fleet_trace["n_worker_spans"] > 0 and fleet_trace["n_unaligned"] == 0 and fleet_trace["problems"] == []
