"""The port's attached workers (``--listen``/``--token``), leases, fencing,
router recovery from the journal and the fleet health snapshot over the
wire, against the JAX package's in-process engine.

Mirrors the subprocess drills of ``tests/test_multihost_fleet.py``: a
pre-spawned port worker refuses a wrong token and a wrong weight
fingerprint (the fingerprint this process takes of the same checkpoint is
the worker's own), survives a detach and serves the next attach; a silent
partition is caught by the lease, its requests are redriven and, after a
``heal`` from a fleet plan, the stale frames are counted and dropped by the
fence with no duplicate token; a router that dies mid-burst is recovered
from its journal by a new router over the same live workers, every
journaled request finishing once. ``serve --http --replica_mode process
--attach`` runs as a subprocess: SIGTERM parks the workers and a
``--recover`` restart re-attaches and serves. Every greedy stream equals
the JAX package's ``ServingEngine`` on the same weights, token for token.
The restart grid's other cells are ``slow``, as in JAX.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

import _torch_workers as W
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu_torch import obs_report
from pretraining_llm_tpu_torch.frontend.loadgen import FleetAction, run_fleet_plan
from pretraining_llm_tpu_torch.frontend.remote_replica import RemoteReplica
from pretraining_llm_tpu_torch.frontend.replica import ReplicaUnavailable
from pretraining_llm_tpu_torch.frontend.router import Router
from pretraining_llm_tpu_torch.generation.generate import cast_params_for_inference, load_model_for_inference
from pretraining_llm_tpu_torch.observability.events import EventBus
from pretraining_llm_tpu_torch.observability.export import lint_exposition
from pretraining_llm_tpu_torch.observability.metrics import render_merged
from pretraining_llm_tpu_torch.resilience.faults import ServingFaultInjector
from pretraining_llm_tpu_torch.resilience.integrity import weight_fingerprint

_spec = importlib.util.spec_from_file_location("obs_report_for_port_multihost", W.ROOT / "scripts" / "obs_report.py")
jobs_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jobs_report)

TOKEN = "s3cret"
FINGERPRINTS = {"weight_fingerprint_interval_s": 5.0}  # the worker pins its fingerprint at loop start


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
    return W.write_checkpoint(tmp_path_factory.mktemp("multihost") / "ck")


def _attach_spec(ckpt, address, token="", engine_kw=None, **extra):
    spec = W.worker_spec(ckpt, **(engine_kw or {}))
    spec["attach"] = address
    if token:
        spec["token"] = token
    spec.update(extra)
    return spec


def _listen(ckpt, n=1, token="", loop=None, **engine_extra):
    procs, addrs = [], []
    try:
        for _ in range(n):
            spec_extra = dict(engine_extra)
            proc, addr = W.spawn_listen_worker(ckpt, token=token, **spec_extra) if loop is None else \
                _spawn_with_loop(ckpt, token, loop, **spec_extra)
            procs.append(proc)
            addrs.append(addr)
    except Exception:
        W.kill_procs(procs)
        raise
    return procs, addrs


def _spawn_with_loop(ckpt, token, loop, **engine_extra):
    spec = dict(W.worker_spec(ckpt, **engine_extra), loop=loop)
    cmd = [sys.executable, "-m", "pretraining_llm_tpu_torch.frontend.worker", "--spec-json", json.dumps(spec),
           "--listen", "127.0.0.1:0"] + (["--token", token] if token else [])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=W.worker_env(), cwd=W.ROOT)
    try:
        port = int(json.loads(proc.stdout.readline())["worker"]["port"])
    except Exception:
        proc.kill()
        raise
    return proc, f"127.0.0.1:{port}"


def _fingerprint(ckpt):
    """This process's fingerprint of the checkpoint: the serve CLI's own
    load, cast and device rule, as the worker takes it."""
    params, cfg = load_model_for_inference(ckpt, device="cpu")
    return weight_fingerprint(cast_params_for_inference(params, cfg.model))


# -- attach handshake: token, fingerprint, detach-survival --------------------


def test_attach_handshake_token_fingerprint_and_detach(ckpt):
    """A wrong token and a wrong expected fingerprint are refused; this
    process's fingerprint of the checkpoint is accepted and the worker
    serves JAX's streams; a detach leaves it alive for the next attach."""
    prompt_list = W.prompts(2)
    ref = W.undisturbed(prompt_list, 4)
    procs, (addr,) = _listen(ckpt, token=TOKEN, loop=FINGERPRINTS)
    try:
        bad = RemoteReplica(0, _attach_spec(ckpt, addr, token="wrong"), spawn_timeout_s=W.SPAWN_S)
        with pytest.raises(Exception, match="unauthorized|token"):
            bad.start()
        finger = RemoteReplica(0, _attach_spec(ckpt, addr, token=TOKEN, expect_fingerprint="bogus"),
                               spawn_timeout_s=W.SPAWN_S)
        with pytest.raises(ReplicaUnavailable, match="fingerprint"):
            finger.start()

        rep = RemoteReplica(0, _attach_spec(ckpt, addr, token=TOKEN, expect_fingerprint=_fingerprint(ckpt)),
                            spawn_timeout_s=W.SPAWN_S)
        rep.start()
        assert rep.mode == "attach" and rep.proc is None
        for i, r in enumerate([rep.submit(p, 4) for p in prompt_list]):
            status, tokens, _ = r.result(timeout=W.WAIT)
            assert status == "done" and tokens == ref[i]
        rep.stop()
        assert procs[0].poll() is None, "a detach must not kill the worker"

        rep2 = RemoteReplica(0, _attach_spec(ckpt, addr, token=TOKEN), spawn_timeout_s=W.SPAWN_S)
        rep2.start()
        status, tokens, _ = rep2.submit(prompt_list[0], 4).result(timeout=W.WAIT)
        assert status == "done" and tokens == ref[0]
        rep2.stop()
        assert procs[0].poll() is None
    finally:
        W.kill_procs(procs)


# -- partition drill: lease expiry, fence drop, streams equal JAX's -----------


def test_partition_heal_fence_streams_equal_jax(ckpt, tmp_path):
    """Blackhole an attached worker mid-decode: the lease catches it, its
    requests redrive with JAX's streams, and after a fleet plan's ``heal``
    the frames it streamed into the void arrive with a stale fence: counted,
    dropped, no duplicate token. The port's fleet report equals the JAX
    script's and names the lease as the detector."""
    prompt_list, n_new = W.prompts(4), 24
    ref = W.undisturbed(prompt_list, n_new)
    path = tmp_path / "events.jsonl"
    bus = EventBus(jsonl_path=str(path))
    procs, addrs = _listen(ckpt, n=2)
    try:
        faults = ServingFaultInjector("partition@req2:r0", bus=bus)
        reps = W.start_all([RemoteReplica(i, _attach_spec(ckpt, addrs[i]), bus=bus, fault_injector=faults,
                                          lease_s=0.8, spawn_timeout_s=W.SPAWN_S) for i in range(2)])
        router = Router(reps, bus=bus, eject_backoff_s=60.0)
        with router:
            results = [r.result(timeout=W.WAIT) for r in [router.submit(p, n_new) for p in prompt_list]]
            for i, (status, tokens, info) in enumerate(results):
                assert status == "done", (i, status, info)
                assert tokens == ref[i], f"request {i} diverged"
            W.wait_until(lambda: router.counters["ejects"] >= 1, 30, "the lease never ejected the worker")
            assert router.counters["redrives"] >= 1
            assert reps[0]._c_lease.value >= 1 and reps[0].fence >= 1
            plan = run_fleet_plan(router, [FleetAction(at_s=0.0, kind="heal", replica=0)])
            plan.join(timeout=W.WAIT)
            W.wait_until(lambda: reps[0]._c_fenced.value >= 1, 30, "the healed backlog never hit the fence")
            assert all(len(tokens) == n_new for _, tokens, _ in results)
            text = render_merged([rep.registry for rep in reps])
            assert lint_exposition(text) == []
            assert "pllm_serving_lease_expiries_total" in text and "pllm_serving_fenced_frames_total" in text
    finally:
        W.kill_procs(procs)
    bus.close()
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    report = obs_report.build_fleet_report(events)
    assert json.dumps(report, sort_keys=True) == json.dumps(jobs_report.build_fleet_report(events), sort_keys=True)
    assert report["lost_requests"] == 0
    pt = report["partitions"]
    assert pt is not None and pt["injected"] == 1 and pt["healed"] == 1
    inc = pt["incidents"][0]
    assert inc["replica"] == 0 and inc["detected_by"] == "lease_expiry" and inc["redrives_caused"] >= 1
    assert not any("UNDETECTED" in p for p in report["problems"])


# -- router crash + journal recovery ------------------------------------------

_RESTART_GRID = [(1, False), (1, True), (2, False), (2, True), (3, False), (3, True)]


@pytest.mark.parametrize("depth,cache", [
    pytest.param(d, c, marks=() if (d, c) == (2, True) else pytest.mark.slow) for d, c in _RESTART_GRID])
def test_router_restart_recovers_journal(ckpt, tmp_path, depth, cache):
    """Kill the router mid-burst (no shutdown, no terminals) with attached
    workers alive. A new router on the journal re-attaches them, fences the
    old generation and finishes every journaled request once, with JAX's
    streams."""
    prompt_list, n_new = W.prompts(4), 24
    kw = dict(pipeline_depth=depth, prefix_cache=cache)
    ref = W.undisturbed(prompt_list, n_new, **kw)
    journal = str(tmp_path / "fleet.jsonl")
    procs, addrs = _listen(ckpt, n=2, token="journal-tok", **kw)
    try:
        reps1 = W.start_all([RemoteReplica(i, _attach_spec(ckpt, addrs[i], token="journal-tok", engine_kw=kw),
                                           lease_s=1.0, spawn_timeout_s=W.SPAWN_S) for i in range(2)])
        router1 = Router(reps1, eject_backoff_s=60.0, journal_path=journal)
        router1.start()
        reqs = [router1.submit(p, n_new) for p in prompt_list]
        time.sleep(0.05)
        router1.abort()
        fence_before = {rep.index: rep.fence for rep in reps1}
        finished = {i: list(r.tokens) for i, r in enumerate(reqs) if r.status == "done"}
        for i, tokens in finished.items():
            assert tokens == ref[i]
        pending = set(range(len(prompt_list))) - set(finished)
        assert all(p.poll() is None for p in procs), "workers must survive the router crash"

        # Launched by router2.start(), after the recovery plan advanced their
        # fences: the hello carries the new generation to the workers.
        reps2 = [RemoteReplica(i, _attach_spec(ckpt, addrs[i], token="journal-tok", engine_kw=kw),
                               lease_s=1.0, spawn_timeout_s=W.SPAWN_S) for i in range(2)]
        router2 = Router(reps2, eject_backoff_s=60.0, journal_path=journal, recover=True)
        try:
            router2.start()
            for rep in reps2:
                assert rep.fence > fence_before[rep.index]
            assert set(router2.recovered) == pending
            assert router2.counters["journal_replays"] == len(pending)
            for frid, rreq in router2.recovered.items():
                status, tokens, info = rreq.result(timeout=W.WAIT)
                assert status == "done", (frid, status, info)
                assert tokens == ref[frid], f"replayed request {frid} diverged after recovery"
        finally:
            router2.stop()
        assert all(p.poll() is None for p in procs)
    finally:
        W.kill_procs(procs)


# -- the fleet health snapshot over the wire ----------------------------------


def test_fleet_health_pulls_worker_gauges_and_sketches(ckpt):
    """``Router.fleet_health`` over attached workers: each replica's
    ``health_pull`` reply (proto 4) with its gauges, fence and latency
    sketches, which count the requests it served; the router's ``/slo``
    body folds the snapshot in."""
    prompt_list = W.prompts(4)
    ref = W.undisturbed(prompt_list, 6)
    procs, addrs = _listen(ckpt, n=2)
    try:
        reps = W.start_all([RemoteReplica(i, _attach_spec(ckpt, addrs[i]), spawn_timeout_s=W.SPAWN_S)
                            for i in range(2)])
        router = Router(reps, eject_backoff_s=60.0)
        with router:
            results = [r.result(timeout=W.WAIT) for r in [router.submit(p, 6) for p in prompt_list]]
            for i, (status, tokens, _) in enumerate(results):
                assert status == "done" and tokens == ref[i]
            fh = router.fleet_health()
    finally:
        W.kill_procs(procs)
    assert fh["fleet"]["replicas_total"] == 2 and fh["fleet"]["replicas_active"] == 2
    served = {str(i): sum(info["replica"] == i for _, _, info in results) for i in range(2)}
    for idx, snap in fh["replicas"].items():
        assert snap["proto"] == 4 and "proto_fallback" not in snap
        assert {"active_requests", "kv_stale_frames"} <= set(snap["gauges"])
        assert snap["sketches"]["e2e_s"]["count"] == served[idx]
    assert "hbm" not in fh["fleet"] or fh["fleet"]["hbm"] == {}


# -- the serve CLI over attached workers ---------------------------------------


def _serve(ckpt, tmp_path, name, addrs, extra):
    d = tmp_path / name
    d.mkdir()
    err = open(d / "stderr.txt", "w+")
    cmd = [sys.executable, "-m", "pretraining_llm_tpu_torch.serve", "--model_path", ckpt, "--http", "--port", "0",
           "--device", "cpu", "--tokenizer", "byte", "--temperature", "0", "--max_batch", "2", "--n_blocks", "24",
           "--block_size", "8", "--steps_per_sched", "4", "--replica_mode", "process", "--replicas", "2",
           "--attach", ",".join(addrs), "--attach_token", TOKEN, "--lease_s", "2",
           "--weight_fingerprint_interval_s", str(FINGERPRINTS["weight_fingerprint_interval_s"]), *extra]
    proc = subprocess.Popen(cmd, cwd=W.ROOT, env=W.worker_env(), stdout=subprocess.DEVNULL, stderr=err, text=True)
    return {"proc": proc, "err": err, "path": d / "stderr.txt"}


def _base(srv):
    W.wait_until(lambda: "listening on " in srv["path"].read_text() or srv["proc"].poll() is not None, W.WAIT,
                 "the server did not listen")
    text = srv["path"].read_text()
    assert srv["proc"].poll() is None, text[-3000:]
    return text.split("listening on ", 1)[1].split(" ")[0]


def _generate(base, prompt, n_new):
    req = urllib.request.Request(base + "/v1/generate", data=json.dumps({"prompt": prompt, "max_new_tokens": n_new})
                                 .encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=W.WAIT) as r:
        return json.loads(r.read())["tokens"]


def _sigterm(srv):
    srv["proc"].send_signal(signal.SIGTERM)
    rc = srv["proc"].wait(timeout=W.WAIT)
    srv["err"].close()
    return rc, srv["path"].read_text()


def test_serve_cli_attach_sigterm_parks_and_recover_reattaches(ckpt, tmp_path):
    """``serve --replica_mode process --attach`` over two pre-spawned
    workers with the token, a lease and fingerprints: JAX's streams;
    SIGTERM leaves both workers alive (parked); a ``--recover`` restart on
    the journal re-attaches, replays nothing and serves JAX's streams."""
    prompt_list, n_new = W.prompts(4), 6
    ref = W.undisturbed(prompt_list, n_new)
    journal = str(tmp_path / "journal.jsonl")
    procs, addrs = _listen(ckpt, n=2, token=TOKEN, loop=FINGERPRINTS)
    servers = []
    try:
        servers.append(_serve(ckpt, tmp_path, "first", addrs, ["--journal_path", journal]))
        base = _base(servers[-1])
        assert {i: _generate(base, p, n_new) for i, p in enumerate(prompt_list)} == ref
        rc, err = _sigterm(servers[-1])
        assert rc == 0 and "SIGTERM drain complete" in err, err[-3000:]
        assert all(p.poll() is None for p in procs), "the router's exit must leave attached workers alive"

        servers.append(_serve(ckpt, tmp_path, "recover", addrs, ["--journal_path", journal, "--recover"]))
        base = _base(servers[-1])
        assert _generate(base, prompt_list[1], n_new) == ref[1]
        rc, err = _sigterm(servers[-1])
        assert rc == 0 and "'journal_replays': 0" in err, err[-3000:]
        assert all(p.poll() is None for p in procs)
    finally:
        W.kill_procs([s["proc"] for s in servers] + procs)
        for s in servers:
            s["err"].close()
