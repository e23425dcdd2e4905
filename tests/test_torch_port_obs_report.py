"""The port's offline analyzer (``pretraining_llm_tpu_torch/obs_report.py``)
against the JAX package's ``scripts/obs_report.py``.

Both run on the same files in every mode (the run report, ``--strict`` on
bad lines, ``--trace --slo``, ``--trace --fleet-trace``, ``--capacity``,
``--fleet``, ``--integrity`` and ``--live``): their ``--json`` output is
equal (exactly: the same folds over the same records) and so are their
rcs and their text output. The files are the JAX tests' synthetic
fixtures (a training event stream with metrics, a stream with a bad
line, a cross-host lineage trace and its unaligned and orphaned variants)
and the port's own: a tiny ``train --obs-dir`` run's events, metrics and
spans, and the events and trace of tiny in-process fleet runs (a crash
drill and a corrupt-weights drill caught by the golden probes). The live
mode reads one snapshot of a running port gateway's ``/slo``; the port's
``--live`` also runs against the live server itself. The tiny preset at
fp32 (2 layers, d 32, V 256), seeded numpy weights (std 0.3) through
``models/bridge.py``.
"""

import dataclasses
import functools
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.config import get_preset as jax_preset
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu_torch import obs_report
from pretraining_llm_tpu_torch import train as train_cli
from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.frontend.gateway import ServingGateway
from pretraining_llm_tpu_torch.frontend.loadgen import LoadSpec, run_engine_loop
from pretraining_llm_tpu_torch.frontend.replica import Replica
from pretraining_llm_tpu_torch.frontend.router import Router
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.observability.capacity import DecisionLog
from pretraining_llm_tpu_torch.observability.events import EventBus
from pretraining_llm_tpu_torch.observability.slo import SLOEngine, default_slo_classes
from pretraining_llm_tpu_torch.observability.spans import SpanRecorder
from pretraining_llm_tpu_torch.observability.tracing import Tracer
from pretraining_llm_tpu_torch.resilience.faults import ServingFaultInjector

ROOT = Path(__file__).resolve().parent.parent
JCFG = dataclasses.replace(jax_preset("tiny").model, compute_dtype="float32")
CFG = ModelConfig(**dict(dataclasses.asdict(JCFG), paged_attention_impl="kernel"))
WAIT = 120

_spec = importlib.util.spec_from_file_location("obs_report_for_port_obs_report", ROOT / "scripts" / "obs_report.py")
jobs_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jobs_report)


@functools.lru_cache(maxsize=None)
def _weights():
    layout = jax.eval_shape(functools.partial(jtf.init_params, JCFG), jax.random.key(0))
    rng = np.random.default_rng(0)

    def leaf(path, spec):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.3, spec.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, layout)


# -- the fixtures -------------------------------------------------------------


def _ev(kind, t, **fields):
    return {"event": kind, "t_wall": float(t), "t_mono": float(t), **fields}


def _tev(name, ts_us, dur_us, trace_id, span_id, parent=None, **args):
    a = {"trace_id": trace_id, "span_id": span_id, **args}
    if parent is not None:
        a["parent_span_id"] = parent
    return {"ph": "X", "name": name, "ts": ts_us, "dur": dur_us, "pid": 1, "tid": 1, "args": a}


def _lineage_trace(clock_err_s=0.001, worker_shift_us=0.0, unaligned=False, orphan=False):
    """The JAX tests' redriven request: router root, two attempts (the first
    redriven, the second served by a remote worker), and the worker's
    subtree under attempt 2."""
    tid = "f" * 32
    evs = [
        _tev("req.request", 1_000_000, 200_000, tid, "r0", status="done", redrives=1),
        _tev("req.attempt", 1_010_000, 50_000, tid, "a1", parent="r0", outcome="redriven", replica=0, fence=1,
             redrive=0),
        _tev("req.attempt", 1_090_000, 100_000, tid, "a2", parent="r0", outcome="done", replica=1, fence=2,
             redrive=1),
        _tev("req.terminal", 1_199_000, 0, tid, "t0", parent="r0", status="done"),
    ]
    wargs = {"remote": True, "worker": 1}
    wargs.update({"unaligned": True} if unaligned else {"clock_err_s": clock_err_s})
    s = worker_shift_us
    evs += [
        _tev("req.request", 1_095_000 + s, 90_000, tid, "w0", parent="nonexistent" if orphan else "a2",
             status="done", **wargs),
        _tev("req.queue", 1_096_000 + s, 2_000, tid, "w1", parent="w0", **wargs),
        _tev("req.prefill", 1_098_000 + s, 10_000, tid, "w2", parent="w0", **wargs),
        _tev("req.window", 1_110_000 + s, 60_000, tid, "w3", parent="w0", **wargs),
        _tev("req.first_token", 1_112_000 + s, 0, tid, "w4", parent="w0", **wargs),
        _tev("req.terminal", 1_184_000 + s, 0, tid, "w5", parent="w0", status="done", **wargs),
    ]
    return {"traceEvents": evs, "otherData": {}}


def _write_jsonl(path, records):
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


def _engine_factory(params, **kw):
    kw = {"max_batch": 2, "n_blocks": 24, "block_size": 8, "steps_per_sched": 4, "pipeline_depth": 2, **kw}
    return lambda: ServingEngine(params, CFG, temperature=0.0, device="cpu", **kw)


def _fleet_run(d, params, faults, n=8, n_new=8, engine_kw=None, **router_kw):
    """A tiny two-replica fleet under ``faults``; returns (events, trace)
    paths and the router's counters."""
    events = d / "events.jsonl"
    bus = EventBus(jsonl_path=str(events))
    recorder = SpanRecorder(max_events=50000)
    factory = _engine_factory(params, **(engine_kw or {}))
    injector = ServingFaultInjector(faults, bus=bus)
    reps = [Replica(i, factory, bus=bus, fault_injector=injector, loop_kwargs=router_kw.pop("loop_kwargs", {}))
            for i in range(2)]
    router = Router(reps, bus=bus, tracer=Tracer(recorder, sample=1.0, seed=0), eject_backoff_s=0.1, **router_kw)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, CFG.vocab_size, size=int(rng.integers(3, 17))).tolist() for _ in range(n)]
    with router:
        for r in [router.submit(p, n_new) for p in prompts]:
            assert r.result(timeout=WAIT)[0] == "done"
        if router.probe_interval_s:
            deadline = time.monotonic() + 30.0
            while router.counters["quarantines"] < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
        deadline = time.monotonic() + 10.0
        while not all(rep.accepting for rep in router.replicas) and time.monotonic() < deadline:
            time.sleep(0.02)
        counters = dict(router.counters)
    bus.close()
    trace = d / "trace.json"
    trace.write_text(json.dumps(recorder.to_chrome_trace()))
    return str(events), str(trace), counters


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    out = {}
    out["events"] = _write_jsonl(d / "syn_events.jsonl", [
        _ev("run_start", 0.0, step=0, total=10), _ev("step_window", 5.0, step=5, steps=5, dur_s=5.0),
        _ev("ckpt_save", 6.0, step=5, dur_s=1.0), _ev("step_window", 11.0, step=10, steps=5, dur_s=5.0),
        _ev("run_end", 12.0, exit_reason="completed")])
    out["metrics"] = _write_jsonl(d / "syn_metrics.jsonl", [
        {"step": 5, "loss": 3.0, "step_ms": 100.0}, {"step": 10, "loss": 2.5, "step_ms": 120.0}])
    bad = d / "bad_metrics.jsonl"
    bad.write_text('{"step": 1, "loss": 2.0}\n{"step": 2, "loss": NaN}\n')
    out["bad"] = str(bad)
    for name, kw in (("lineage", {}), ("unaligned", {"unaligned": True}), ("orphan", {"orphan": True}),
                     ("shifted", {"worker_shift_us": 20_000})):
        p = d / f"{name}.json"
        p.write_text(json.dumps(_lineage_trace(**kw)))
        out[name] = str(p)
    out["redrive"] = _write_jsonl(d / "redrive.jsonl", [
        {"event": "redrive", "trace_id": "f" * 32, "reason": "crash", "t_wall": 1.07}])

    obs = d / "train"
    train_cli.main(["--preset", "tiny", "--data", "synthetic", "--device", "cpu", "--no-resume", "--obs-dir",
                    str(obs), "--override", "train.train_steps=6", "train.log_interval=2", "train.eval_interval=0",
                    "model.compute_dtype=float32", f"train.checkpoint_dir={d / 'ck'}",
                    f"train.metrics_path={obs / 'metrics.jsonl'}"])
    out["train_events"] = str(obs / "events.jsonl")
    out["train_metrics"] = str(obs / "metrics.jsonl")
    out["train_spans"] = str(obs / "spans.trace.json")

    params = bridge.params_from_numpy(_weights(), CFG, device="cpu")
    (d / "crash").mkdir()
    out["crash_events"], out["crash_trace"], out["crash_counters"] = _fleet_run(
        d / "crash", params, "replica_crash@req2:r0", engine_kw={"prefix_cache": True})
    (d / "integrity").mkdir()
    out["int_events"], out["int_trace"], out["int_counters"] = _fleet_run(
        d / "integrity", params, "corrupt_weights@req2:r1", probe_interval_s=0.05, probe_timeout_s=60.0,
        loop_kwargs={"weight_fingerprint_interval_s": 0.05})
    return out


def _run(module, monkeypatch, capsys, argv):
    """(rc, stdout) of ``module.main()`` on ``argv``; an exception out of
    main (the JAX script's own, e.g. a NaN in strict JSON) is returned as
    its type and message so the two analyzers can be held to the same one."""
    monkeypatch.setattr(sys, "argv", ["obs_report"] + argv)
    try:
        rc = module.main()
    except Exception as e:  # noqa: BLE001 - compared, not swallowed
        capsys.readouterr()
        return type(e).__name__, str(e)
    return rc, capsys.readouterr().out


# (name, argv over the fixture files' keys): every mode of main().
MODES = [
    ("run", ["events", "metrics"]),
    ("run-strict", ["--strict", "events", "metrics"]),
    ("bad-lines", ["bad"]),
    ("bad-lines-strict", ["--strict", "bad"]),
    ("train", ["--strict", "train_events", "train_metrics"]),
    ("train-trace", ["--trace", "train_spans", "train_events"]),
    ("lineage-slo", ["--slo", "--trace", "lineage"]),
    ("lineage-fleet-trace", ["--strict", "--fleet-trace", "--trace", "lineage", "redrive"]),
    ("unaligned-fleet-trace", ["--strict", "--fleet-trace", "--trace", "unaligned"]),
    ("orphan-fleet-trace", ["--strict", "--fleet-trace", "--trace", "orphan"]),
    ("shifted-fleet-trace", ["--strict", "--fleet-trace", "--trace", "shifted"]),
    ("crash-slo", ["--strict", "--slo", "--slo_ttft_s", "0.001", "--slo_e2e_s", "0.05", "--trace", "crash_trace"]),
    ("crash-capacity", ["--strict", "--capacity", "crash_events"]),
    ("crash-fleet", ["--strict", "--fleet", "crash_events"]),
    ("crash-fleet-trace", ["--strict", "--fleet-trace", "--trace", "crash_trace", "crash_events"]),
    ("crash-integrity", ["--strict", "--integrity", "crash_events"]),
    ("integrity", ["--strict", "--integrity", "--fleet", "int_events"]),
    ("integrity-trace", ["--strict", "--slo", "--trace", "int_trace", "int_events"]),
]


@pytest.mark.parametrize("argv", [m[1] for m in MODES], ids=[m[0] for m in MODES])
def test_json_text_and_rc_equal_to_the_jax_script(files, monkeypatch, capsys, argv):
    """The port's ``main()`` and the JAX script's on the same files: equal
    ``--json`` objects, equal text output, equal rcs."""
    args = [files.get(a, a) for a in argv]
    t_rc, t_json = _run(obs_report, monkeypatch, capsys, ["--json"] + args)
    j_rc, j_json = _run(jobs_report, monkeypatch, capsys, ["--json"] + args)
    if j_rc == "ValueError" and "not JSON compliant" in j_json:
        # The settled difference: where a report holds a NaN (a percentile
        # over no values) the JAX script raises; the port writes null. Held
        # to the JAX report with its NaNs as nulls.
        with monkeypatch.context() as m:
            m.setattr(jobs_report, "json", types.SimpleNamespace(
                dumps=lambda o, **kw: json.dumps(obs_report._finite_or_null(o), **kw), loads=json.loads))
            j_rc, j_json = _run(jobs_report, monkeypatch, capsys, ["--json"] + args)
    assert t_rc == j_rc
    assert json.loads(t_json) == json.loads(j_json)
    t_rc2, t_text = _run(obs_report, monkeypatch, capsys, args)
    j_rc2, j_text = _run(jobs_report, monkeypatch, capsys, args)
    assert (t_rc2, t_text) == (j_rc2, j_text)


def test_the_fixtures_say_what_the_modes_check(files, monkeypatch, capsys):
    """The strict gates hold on the clean runs and fire on the broken
    fixtures, so the parity cases above compare both verdicts."""
    def rc(*argv):
        return _run(obs_report, monkeypatch, capsys, [files.get(a, a) for a in argv])[0]

    assert rc("--strict", "bad") == 1 and rc("bad") == 0
    assert rc("--strict", "--fleet-trace", "--trace", "unaligned") == 1
    assert rc("--strict", "--fleet-trace", "--trace", "orphan") == 1
    assert rc("--strict", "--fleet-trace", "--trace", "shifted") == 1
    assert rc("--strict", "--fleet", "--fleet-trace", "--capacity", "--trace", "crash_trace", "crash_events") == 0
    assert files["crash_counters"]["redrives"] >= 1 and files["crash_counters"]["ejects"] == 1
    assert files["int_counters"]["quarantines"] >= 1
    rep = json.loads(_run(obs_report, monkeypatch, capsys, ["--json", "--integrity", files["int_events"]])[1])
    assert rep["integrity"]["corruptions_fired"] >= 1 and rep["integrity"]["quarantines"] >= 1
    assert rep["integrity"]["detections"][0]["fault"] == "corrupt_weights"
    rep = json.loads(_run(obs_report, monkeypatch, capsys, ["--json", "--fleet", files["crash_events"]])[1])
    assert rep["fleet"]["lost_requests"] == 0 and rep["fleet"]["n_submitted"] == 8


def test_missing_inputs_are_usage_errors(monkeypatch, capsys):
    for argv in ([], ["--slo"], ["--fleet-trace"], ["--capacity"], ["--fleet"], ["--integrity"]):
        for module in (obs_report, jobs_report):
            monkeypatch.setattr(sys, "argv", ["obs_report"] + argv)
            with pytest.raises(SystemExit) as e:
                module.main()
            assert e.value.code == 2
        capsys.readouterr()


@pytest.fixture(scope="module")
def live_server(files):
    """A port fleet behind the gateway with the live SLO engine, after 24
    requests (enough for the rank reconciliation)."""
    params = bridge.params_from_numpy(_weights(), CFG, device="cpu")
    d = Path(files["events"]).parent / "live"
    d.mkdir()
    events = d / "events.jsonl"
    bus = EventBus(jsonl_path=str(events))
    slo = SLOEngine(classes=default_slo_classes(), bus=bus, decisions=DecisionLog(bus=bus), window_s=600.0)
    factory = _engine_factory(params)
    router = Router([Replica(i, factory, bus=bus) for i in range(2)], bus=bus, slo=slo).start()
    gw = ServingGateway(router, port=0, slo=slo)
    gw.start()
    report = run_engine_loop(router, LoadSpec(n_requests=24, rate_rps=200.0, seed=0, prompt_len_min=3,
                                              prompt_len_max=12, max_new_min=4, max_new_max=8,
                                              vocab_size=CFG.vocab_size))
    assert report.counts() == {"done": 24}
    deadline = time.monotonic() + 10.0
    while slo.snapshot().get("events_seen", 0) < 24 and time.monotonic() < deadline:
        time.sleep(0.02)
    yield f"http://127.0.0.1:{gw.port}", str(events)
    gw.stop()
    router.stop()
    bus.close()


def test_live_report_equal_on_one_snapshot(live_server, monkeypatch, capsys):
    """``--live`` folds one ``/slo`` snapshot: both analyzers, given the same
    snapshot and events, give the same JSON, text and rc."""
    url, events = live_server
    snap = obs_report.fetch_live(url)
    for module in (obs_report, jobs_report):
        monkeypatch.setattr(module, "fetch_live", lambda u, timeout_s=5.0: snap)
    outs = []
    for module in (obs_report, jobs_report):
        rc, out = _run(module, monkeypatch, capsys, ["--json", "--strict", "--live", url, events])
        rc2, text = _run(module, monkeypatch, capsys, ["--live", url, events])
        outs.append((rc, json.loads(out), rc2, text))
    assert outs[0] == outs[1]
    live = outs[0][1]["live"]
    assert outs[0][0] == 0 and live["problems"] == [] and live["events_seen"] >= 24
    assert any(row["checked"] for row in live["reconcile"].values())


def test_live_against_the_running_server(live_server):
    """``python -m pretraining_llm_tpu_torch.obs_report --live`` against the
    running gateway, as a user runs it: rc 0 under ``--strict``, and the
    process imports neither JAX nor torch."""
    url, events = live_server
    code = ("import runpy, sys; sys.argv = ['obs_report', '--json', '--strict', '--live', %r, %r]\n"
            "try:\n    runpy.run_module('pretraining_llm_tpu_torch.obs_report', run_name='__main__')\n"
            "except SystemExit as e:\n    rc = e.code\n"
            "assert 'jax' not in sys.modules and 'torch' not in sys.modules, 'imports'\n"
            "sys.exit(rc)" % (url, events))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=WAIT)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["live"]["problems"] == []
