"""The port's observability hub (``pretraining_llm_tpu_torch/observability/``)
against the JAX package's, and the trainer's and the serving engine's use
of it.

Held against JAX on the same inputs: ``sanitize_record`` and the JSONL
line, the goodput fold of the same event streams (equal summaries), the
Prometheus rendering of the same values and registrations, JAX's
``lint_exposition`` on the port's textfile (and the port's lint on
malformed texts), histogram percentiles, and ``scripts/obs_report.py
--strict`` (a subprocess) over a port ``Trainer``'s event and metrics
streams. Port-side: spans and their Chrome trace, the build telemetry
(``recompile`` events after warm-up, suppressed scopes), no device memory
sample on the CPU, the trainer's event stream (run_start with the sampler,
step windows, eval, saves, run_end; a rollback lowering goodput; the
exception path), no metric sync between log boundaries, the serving
engine's three spans, the train CLI's ``--obs-dir`` and the supervisor's
relaunch events.
"""

import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.observability import events as jevents
from pretraining_llm_tpu.observability import export as jexport
from pretraining_llm_tpu.observability import metrics as jmetrics
from pretraining_llm_tpu.observability.goodput import GoodputAccountant as JGoodput
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch import train as tcli
from pretraining_llm_tpu_torch.observability import device as tdevice
from pretraining_llm_tpu_torch.observability import events as tevents
from pretraining_llm_tpu_torch.observability import export as texport
from pretraining_llm_tpu_torch.observability import metrics as tmetrics
from pretraining_llm_tpu_torch.observability import spans as tspans
from pretraining_llm_tpu_torch.observability.goodput import CATEGORIES, GoodputAccountant
from pretraining_llm_tpu_torch.observability.hub import ObservabilityHub
from pretraining_llm_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
OBS_REPORT = ROOT / "scripts" / "obs_report.py"


def _ev(kind, t, **fields):
    return {"event": kind, "t_wall": t, "t_mono": t, "seq": 0, **fields}


# ------------------------------------------------------------------ events


@pytest.mark.parametrize("record", [
    {"loss": float("nan"), "grad_norm": float("inf"), "lr": -float("inf"), "step": 3},
    {"event": "x", "ok": True, "nested": {"a": 1}, "v": 1.5},
])
def test_sanitize_and_json_line_match_jax(record):
    assert tevents.sanitize_record(record) == jevents.sanitize_record(record)
    assert tevents.json_line(record) == jevents.json_line(record)
    assert tevents.EVENT_KINDS == jevents.EVENT_KINDS


def test_event_bus_stamps_sinks_and_is_thread_safe(tmp_path):
    path = tmp_path / "e.jsonl"
    seen = []
    bus = tevents.EventBus(str(path), clock=lambda: 5.0, wall=lambda: 100.0)
    bus.subscribe(seen.append)
    bus.emit("run_start", step=0, total=4)
    threads = [threading.Thread(target=lambda: [bus.emit("eval", dur_s=0.1) for _ in range(50)])
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    bus.emit("run_end", loss=float("nan"))
    bus.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == len(seen) == 202
    assert sorted(r["seq"] for r in lines) == list(range(202))
    assert lines[0] == {"event": "run_start", "seq": 0, "t_wall": 100.0, "t_mono": 5.0, "step": 0, "total": 4}
    assert lines[-1]["loss"] is None and lines[-1]["loss_nonfinite"] == "nan"
    bus.emit("eval", dur_s=0.2)  # reopens after close
    assert len(path.read_text().splitlines()) == 203


# ------------------------------------------------------------------- spans


def test_spans_nest_summarize_export_and_bound(tmp_path):
    rec = tspans.SpanRecorder(max_events=3)
    with rec.span("outer", a=1) as meta:
        with rec.span("inner"):
            pass
        meta["b"] = 2
    with pytest.raises(ValueError):
        with rec.span("boom"):
            raise ValueError("x")
    with rec.span("dropped"):
        pass
    summary = rec.summary()
    assert set(summary) == {"outer", "inner", "boom"} and rec.dropped == 1
    trace = json.loads(Path(rec.export(str(tmp_path / "t.json"))).read_text())
    by_name = {e["name"]: e for e in trace["traceEvents"]}
    assert by_name["outer"]["args"] == {"depth": 0, "a": 1, "b": 2} and by_name["inner"]["args"]["depth"] == 1
    assert by_name["outer"]["ts"] <= by_name["inner"]["ts"] and by_name["spans_dropped"]["args"]["dropped"] == 1
    assert trace["otherData"]["dropped_spans"] == 1


# ----------------------------------------------------------------- goodput


def _streams():
    rollback = [
        _ev("run_start", 0.0, step=0, total=12), _ev("step_window", 4.0, step=4, steps=4, dur_s=4.0),
        _ev("ckpt_save", 5.0, step=4, dur_s=1.0), _ev("step_window", 9.0, step=8, steps=4, dur_s=4.0),
        _ev("rollback", 10.5, step=8, from_step=8, to_step=4, dur_s=1.5),
        _ev("step_window", 14.5, step=8, steps=4, dur_s=4.0), _ev("step_window", 17.0, step=10, steps=2, dur_s=2.0),
        _ev("recompile", 17.5, dur_s=0.5), _ev("step_window", 19.0, step=12, steps=2, dur_s=2.0),
        _ev("run_end", 19.5, exit_reason="completed"),
    ]
    relaunch = [
        _ev("run_start", 0.0, step=0, total=10), _ev("step_window", 5.0, step=5, steps=5, dur_s=5.0),
        _ev("preempt", 5.1, step=5), _ev("ckpt_save", 6.0, step=5, dur_s=0.9),
        _ev("run_end", 6.1, exit_reason="preempted"), _ev("relaunch", 6.2, rc=43, supervisor=True),
        _ev("ckpt_restore", 9.0, step=5, dur_s=1.5), _ev("run_start", 9.1, step=5, total=10),
        _ev("eval", 10.0, step=6, dur_s=0.4), _ev("step_window", 15.0, step=10, steps=5, dur_s=5.0),
        _ev("run_end", 15.5, exit_reason="completed"),
    ]
    rng = np.random.default_rng(0)
    random, t, step = [_ev("run_start", 0.0, step=0, total=50)], 0.0, 0
    for _ in range(30):
        t += float(rng.uniform(0.1, 2.0))
        kind = str(rng.choice(["step_window", "eval", "ckpt_save", "rollback", "wedge", "bogus"]))
        dur = float(rng.uniform(0.0, 1.0))
        if kind == "step_window":
            n = int(rng.integers(0, 4))
            step = max(0, step + int(rng.integers(-3, 5)))
            random.append(_ev(kind, t, step=step, steps=n, dur_s=dur))
        else:
            random.append(_ev(kind, t, step=step, dur_s=dur))
    random.append({"event": "no_clock", "step": 3})
    return {"rollback": rollback, "relaunch": relaunch, "random": random}


@pytest.mark.parametrize("name", sorted(_streams()))
def test_goodput_fold_equals_jax(name):
    events = _streams()[name]
    got, want = GoodputAccountant.fold(events), JGoodput.fold(events)
    assert got == want
    assert abs(sum(got["categories"].values()) + got["accounting_error_s"] - got["total_s"]) < 1e-9
    if name == "rollback":
        assert got["categories"]["replay"] == 4.0 and got["rollbacks"] == 1 and got["recompiles"] == 1
    assert tuple(got["categories"]) == CATEGORIES


# -------------------------------------------------------------- Prometheus


def test_prometheus_rendering_matches_jax(tmp_path):
    metrics = {"loss": 2.5, "mfu": 0.4, "nan_metric": float("nan"), "skip": "text", "flag": True,
               "steps": 7, "weird key-1": 3.0}
    types = {"steps": "counter"}
    assert texport.prometheus_lines(metrics, types=types, labels={"run": 'a"b'}) == \
        jexport.prometheus_lines(metrics, types=types, labels={"run": 'a"b'})

    def fill(mod):
        reg = mod.MetricsRegistry(prefix="pllm_", const_labels={"host": 0})
        reg.counter("tokens_total", "tokens", kind="train").inc(5)
        reg.gauge("depth").set(3)
        h = reg.histogram("window_seconds", "w", buckets=mod.log_buckets(0.01, 10))
        for v in (0.005, 0.02, 0.3, 3.0, 40.0):
            h.observe(v)
        return reg, h

    (treg, th), (jreg, jh) = fill(tmetrics), fill(jmetrics)
    assert treg.render(extra_gauges={"goodput": 0.5}) == jreg.render(extra_gauges={"goodput": 0.5})
    assert treg.snapshot() == jreg.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 1.0):
        assert th.percentile(q) == jh.percentile(q)
    path = texport.write_textfile(str(tmp_path / "m.prom"), {"goodput": 0.5}, registry=treg)
    text = Path(path).read_text()
    assert jexport.lint_exposition(text) == [] and "pllm_last_write_seconds" in text
    assert not [p.name for p in tmp_path.iterdir() if p.name.endswith(".tmp")]


@pytest.mark.parametrize("text", [
    "# TYPE a_total counter\na_total 1\n# TYPE a_total counter\n",
    "# TYPE g gauge\ng 1\n# TYPE x counter\nx 2\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 3\nh_bucket{le=\"+Inf\"} 2\nh_sum 1\nh_count 2\n",
    "# TYPE g gauge\nstray 1\nbad line\n",
    "# TYPE g_total gauge\ng_total 1\n",
])
def test_lint_matches_jax(text):
    assert texport.lint_exposition(text) == jexport.lint_exposition(text) != []


# ----------------------------------------------------- device and builds


def test_build_telemetry_and_no_memory_sample_on_the_cpu():
    bus = tevents.EventBus()
    seen = []
    bus.subscribe(seen.append)
    watcher = tdevice.CompileWatcher(bus).start()
    try:
        tdevice.note_build("nvcc", "flash_fwd_tc", 12.0)  # before warm-up: expected
        watcher.mark_warm(1)
        with watcher.suppress():
            tdevice.note_build("cxx", "batcher", 0.5)
        watcher.at_step(8)
        tdevice.note_build("nvcc", "paged_decode", 3.0)
    finally:
        watcher.stop()
    tdevice.note_build("nvcc", "after_stop", 1.0)
    assert [(e["event"], e["step"], e["what"]) for e in seen] == [("recompile", 8, "nvcc:paged_decode")]
    summary = watcher.summary()
    assert (summary["compiles"], summary["recompiles"], summary["compile_s"]) == (3, 1, 15.5)
    assert tdevice.DeviceTelemetry(bus).sample(3) == {} and len(seen) == 1  # no card, no sample


def test_hub_timed_event_and_textfile(tmp_path):
    cfg = tcfg.ObservabilityConfig(events_path=str(tmp_path / "e.jsonl"), prometheus_path=str(tmp_path / "m.prom"),
                                   spans_path=str(tmp_path / "s.json"))
    hub = ObservabilityHub(cfg)
    assert tspans.get_recorder() is hub.spans  # the module default slot
    hub.start_run(0, 4, sampler="native")
    with hub.timed_event("eval", step=2) as ev:
        ev["val_loss"] = 1.25
    extra = hub.on_log_boundary(2, {"window_s": 0.5, "window_steps": 2.0}, {"loss": 2.0})
    assert extra == {"goodput": hub.goodput.summary()["goodput"]} and extra["goodput"] > 0
    record = hub.end_run("completed", step=4)
    events = [json.loads(line) for line in (tmp_path / "e.jsonl").read_text().splitlines()]
    assert [e["event"] for e in events] == ["run_start", "eval", "step_window", "run_end"]
    assert events[0]["sampler"] == "native" and events[1]["val_loss"] == 1.25 and events[1]["dur_s"] >= 0
    assert record["spans"]["eval"]["count"] == 1 and "compile" in record
    assert jexport.lint_exposition((tmp_path / "m.prom").read_text()) == []
    assert "eval" in {e["name"] for e in json.loads((tmp_path / "s.json").read_text())["traceEvents"]}


# ----------------------------------------------------------------- trainer


def _obs_cfg(tmp_path, **over):
    tmp_path.mkdir(parents=True, exist_ok=True)
    base = {"model.compute_dtype": "float32", "train.train_steps": 8, "train.log_interval": 2,
            "train.eval_interval": 4, "train.eval_iters": 1, "train.checkpoint_interval": 4,
            "train.checkpoint_dir": str(tmp_path / "ck"), "train.metrics_path": str(tmp_path / "metrics.jsonl"),
            "obs.events_path": str(tmp_path / "events.jsonl"), "obs.spans_path": str(tmp_path / "spans.json"),
            "obs.prometheus_path": str(tmp_path / "metrics.prom")}
    return tcfg.get_preset("tiny").with_overrides({**base, **over})


def _lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_trainer_event_stream_and_obs_report(tmp_path):
    """A port Trainer's streams: coherent, folded to a closed budget, and
    accepted by ``scripts/obs_report.py --strict``, whose goodput is the
    port's own fold."""
    t = Trainer(_obs_cfg(tmp_path), synthetic_data=True, resume=False, device="cpu")
    t.train()
    events = _lines(tmp_path / "events.jsonl")
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end" and "recompile" not in kinds
    assert events[0]["sampler"] == "synthetic" and {"step_window", "eval", "ckpt_save"} <= set(kinds)
    assert events[-1]["exit_reason"] == "completed" and 0.0 < events[-1]["goodput"] <= 1.0
    summary = GoodputAccountant.fold(events)
    assert summary == JGoodput.fold(events) and summary["categories"]["productive"] > 0
    assert abs(sum(summary["categories"].values()) - summary["total_s"]) <= 0.01 * summary["total_s"]
    assert any("goodput" in m for m in _lines(tmp_path / "metrics.jsonl"))
    names = {e["name"] for e in json.loads((tmp_path / "spans.json").read_text())["traceEvents"]}
    assert {"ckpt_save", "checkpoint/write_leaves", "eval"} <= names
    assert jexport.lint_exposition((tmp_path / "metrics.prom").read_text()) == []
    res = subprocess.run([sys.executable, str(OBS_REPORT), "--json", "--strict", str(tmp_path / "events.jsonl"),
                          str(tmp_path / "metrics.jsonl")], capture_output=True, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout)
    assert report["bad_lines"] == 0 and report["goodput"]["goodput"] == pytest.approx(summary["goodput"])
    assert report["step_time"]["count"] >= 3


def test_rollback_lowers_goodput_and_exception_closes_the_stream(tmp_path):
    cfg = _obs_cfg(tmp_path / "rb", **{"train.train_steps": 12, "train.eval_interval": 0,
                                       "train.checkpoint_interval": 2, "resilience.anomaly_detection": True,
                                       "resilience.faults": "nan@5", "resilience.cooldown_steps": 2,
                                       "resilience.skip_batches": 1})
    t = Trainer(cfg, synthetic_data=True, resume=False, device="cpu")
    t.train()
    assert t.exit_reason == "completed"
    events = _lines(tmp_path / "rb" / "events.jsonl")
    rb = next(e for e in events if e["event"] == "rollback")
    assert rb["to_step"] < rb["from_step"] and rb["dur_s"] > 0
    summary = GoodputAccountant.fold(events)
    assert summary["rollbacks"] == 1 and summary["categories"]["replay"] > 0 and summary["categories"]["restore"] > 0
    assert summary["goodput"] < 1.0 and summary["max_step"] == 12

    bad = Trainer(_obs_cfg(tmp_path / "ex", **{"train.eval_interval": 0, "train.checkpoint_interval": 0,
                                               "train.save_final": False}),
                  synthetic_data=True, resume=False, device="cpu")
    real, n = bad.step_fn, [0]

    def exploding(state, batch):
        n[0] += 1
        if n[0] == 3:
            raise ValueError("boom")
        return real(state, batch)

    bad.step_fn = exploding
    with pytest.raises(ValueError):
        bad.train()
    events = _lines(tmp_path / "ex" / "events.jsonl")
    assert "failure" in [e["event"] for e in events]
    assert events[-1]["event"] == "run_end" and events[-1]["exit_reason"] == "exception"


def test_no_metric_sync_between_log_boundaries(tmp_path):
    """The hub, the detector and the watchdog on: step metrics reach the
    host (``float``) only at the log boundaries, 4 and 8."""
    cfg = _obs_cfg(tmp_path, **{"train.log_interval": 4, "train.eval_interval": 0, "train.checkpoint_interval": 0,
                                "train.save_final": False, "resilience.anomaly_detection": True,
                                "resilience.watchdog_timeout_s": 60.0})
    t = Trainer(cfg, synthetic_data=True, resume=False, device="cpu")
    conversions = []

    class Tracked:
        def __init__(self, val, step):
            self._val, self._step = val, step

        def __float__(self):
            conversions.append(self._step)
            return float(self._val)

    real, n = t.step_fn, [0]

    def wrapped(state, batch):
        state, metrics = real(state, batch)
        n[0] += 1
        return state, {k: Tracked(v, n[0]) for k, v in metrics.items()}

    t.step_fn = wrapped
    t.train()
    assert set(conversions) == {4, 8}


# ----------------------------------------------------------------- serving


def test_serving_engine_records_the_jax_engine_s_spans():
    """The pipelined scheduler records a dispatch span per window, a reap
    span (with its host_blocked_s) and a host-blocked span per reap, as
    the JAX engine's pipelined path does; the synchronous scheduler, whose
    JAX counterpart records none of them, records none."""
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import transformer

    cfg = tcfg.get_preset("tiny").model
    params = transformer.init_params(cfg, 0, device="cpu")
    rec = tspans.SpanRecorder()
    tspans.set_recorder(rec)
    for pipeline in (False, True):
        rec.clear()
        eng = ServingEngine(params, cfg, max_batch=2, n_blocks=16, block_size=8, steps_per_sched=4, device="cpu")
        for i in range(3):
            eng.submit(list(range(1, 6 + i)), max_new_tokens=6)
        eng.run(pipeline=pipeline)
        summary = rec.summary()
        if not pipeline:
            assert not any(name.startswith("serving.") for name in summary)
            continue
        assert summary["serving.dispatch_window"]["count"] == eng.stats["windows"]
        assert summary["serving.reap_window"]["count"] == summary["serving.host_blocked"]["count"] \
            == eng.stats["windows_reaped"] > 0
        reaps = [e for e in rec.to_chrome_trace()["traceEvents"] if e["name"] == "serving.reap_window"]
        assert all("host_blocked_s" in e["args"] for e in reaps)
        assert sum(e["args"]["host_blocked_s"] for e in reaps) == pytest.approx(eng.stats["host_blocked_s"],
                                                                                abs=1e-4)


# ------------------------------------------------------ CLI and supervisor


def test_train_cli_obs_dir_and_supervisor_events(tmp_path):
    final = tcli.main(["--preset", "tiny", "--data", "synthetic", "--device", "cpu", "--no-resume", "--obs-dir",
                       str(tmp_path / "obs"), "--override", "train.train_steps=4", "train.log_interval=2",
                       f"train.checkpoint_dir={tmp_path / 'ck'}", "train.eval_interval=0"])
    assert math.isfinite(final["loss"])
    assert sorted(p.name for p in (tmp_path / "obs").iterdir()) == ["events.jsonl", "metrics.prom",
                                                                     "spans.trace.json"]
    res = subprocess.run([sys.executable, "-m", "pretraining_llm_tpu_torch.supervisor", "--max-restarts", "1",
                          "--backoff-base", "0.01", "--events", str(tmp_path / "sup.jsonl"), "--", sys.executable,
                          "-c", "import sys; sys.exit(7)"], cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert res.returncode == 7
    events = _lines(tmp_path / "sup.jsonl")
    assert [e["event"] for e in events] == ["relaunch", "failure"]
    assert events[0]["rc"] == 7 and events[0]["why"].startswith("crash") and events[1]["why"] == "restart_budget"
    assert all("t_wall" in e and "t_mono" in e and e["supervisor"] is True for e in events)
