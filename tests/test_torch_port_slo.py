"""The port's serving observability against the JAX package's: the
percentile sketches, the request tracer, the SLO engine, ``render_merged``
and the weight fingerprint.

Mirrors the sketch and SLO tests of ``tests/test_observability.py``,
``tests/test_fleet.py::test_render_merged_one_vocabulary`` and the
fingerprint tests of ``tests/test_integrity.py``. The bar: the sketches keep
their rank-error bound, merge in any order to the same centroids, and their
``to_dict`` is the JAX sketch's JSON byte for byte; windowed sketches and
counts rotate as JAX's under one fake clock; ``traceparent`` parsing and
formatting, the tracer's seeded ids and its span records (virtual tracks
in the Chrome export) are JAX's; the port's trace-tree check finds
``scripts/obs_report.py``'s problems on the same traces; the SLO engine fires and resolves the JAX
engine's alerts, with the same ids and snapshot, on the same record stream;
``render_merged`` renders JAX's text; and ``weight_fingerprint`` equals
JAX's on the same tree within fp32 rounding and moves on a corrupted leaf.
"""

import bisect
import copy
import dataclasses
import functools
import importlib.util
import itertools
import json
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.models import quantize as jquantize
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.observability import capacity as jcapacity
from pretraining_llm_tpu.observability import events as jevents
from pretraining_llm_tpu.observability import metrics as jmetrics
from pretraining_llm_tpu.observability import sketches as jsketches
from pretraining_llm_tpu.observability import slo as jslo
from pretraining_llm_tpu.observability import spans as jspans
from pretraining_llm_tpu.observability import tracing as jtracing
from pretraining_llm_tpu.resilience import integrity as jintegrity
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.models import quantize as tquantize
from pretraining_llm_tpu_torch.observability import capacity as tcapacity
from pretraining_llm_tpu_torch.observability import events as tevents
from pretraining_llm_tpu_torch.observability import metrics as tmetrics
from pretraining_llm_tpu_torch.observability import sketches as tsketches
from pretraining_llm_tpu_torch.observability import slo as tslo
from pretraining_llm_tpu_torch.observability import spans as tspans
from pretraining_llm_tpu_torch.observability import tracing as ttracing
from pretraining_llm_tpu_torch.observability.export import lint_exposition
from pretraining_llm_tpu_torch.resilience import integrity as tintegrity

JCFG = dataclasses.replace(jcfg.get_preset("tiny").model, compute_dtype="float32")
CFG = tcfg.ModelConfig(**dataclasses.asdict(JCFG))


def _rank_error(sorted_vals, value, q):
    lo = bisect.bisect_left(sorted_vals, value) / len(sorted_vals)
    hi = bisect.bisect_right(sorted_vals, value) / len(sorted_vals)
    if lo <= q <= hi:
        return 0.0
    return min(abs(q - lo), abs(q - hi))


_DISTS = {
    "uniform": lambda rng: rng.random(),
    "normal": lambda rng: rng.gauss(0.0, 1.0),
    "lognormal": lambda rng: rng.lognormvariate(0.0, 1.5),
}


# -- sketches ---------------------------------------------------------------------


@pytest.mark.parametrize("dist", sorted(_DISTS))
def test_digest_sketch_rank_error_bound_and_wire_equal_to_jax(dist):
    rng = random.Random(7)
    vals = [_DISTS[dist](rng) for _ in range(20000)]
    sk, jsk = tsketches.DigestSketch(compression=64), jsketches.DigestSketch(compression=64)
    for v in vals:
        sk.observe(v)
        jsk.observe(v)
    sv = sorted(vals)
    for q in (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.999):
        bound = 2.0 * q * (1.0 - q) / 64 + 1.0 / len(vals)
        assert _rank_error(sv, sk.quantile(q), q) <= bound
        assert sk.quantile(q) == jsk.quantile(q)
    assert (sk.quantile(0.0), sk.quantile(1.0)) == (min(vals), max(vals))
    assert abs(sk.mean - sum(vals) / len(vals)) <= 1e-6 * max(1.0, abs(sum(vals) / len(vals)))
    assert len(sk.centroids()) <= 8 * 64
    assert json.dumps(sk.to_dict()) == json.dumps(jsk.to_dict())
    # Either package reads the other's wire form.
    back = tsketches.DigestSketch.from_dict(json.loads(json.dumps(jsk.to_dict())))
    assert back.centroids() == sk.centroids() and back.summary() == jsk.summary()


def test_digest_sketch_merge_order_invariance():
    rng = random.Random(3)
    vals = [rng.lognormvariate(0.0, 1.5) for _ in range(8000)]
    parts = [tsketches.DigestSketch(compression=64) for _ in range(5)]
    jparts = [jsketches.DigestSketch(compression=64) for _ in range(5)]
    for i, v in enumerate(vals):
        parts[i % 5].observe(v)
        jparts[i % 5].observe(v)
    merges = [tsketches.DigestSketch.merge_all(p) for p in itertools.permutations(parts)]
    ref = merges[0].centroids()
    assert all(m.centroids() == ref for m in merges[1:])
    assert ref == jsketches.DigestSketch.merge_all(jparts).centroids()
    sv = sorted(vals)
    for q in (0.5, 0.9, 0.99):
        assert _rank_error(sv, merges[0].quantile(q), q) <= 2.0 * q * (1.0 - q) / 64 + 1.0 / len(vals)
    assert merges[0].count == len(vals)
    empty = tsketches.DigestSketch.from_dict(json.loads(json.dumps(tsketches.DigestSketch().to_dict())))
    assert empty.count == 0 and empty.summary() == {"count": 0}


def test_windowed_sketch_and_counts_rotate_as_jax():
    for mod in (tsketches, jsketches):
        t = [0.0]
        ws = mod.WindowedSketch(window_s=6.0, buckets=3, clock=lambda: t[0])
        for _ in range(10):
            ws.observe(100.0)
        assert ws.count == 10
        t[0] = 3.0
        ws.observe(1.0)
        assert ws.count == 11
        t[0] = 7.9
        assert ws.count == 1 and ws.quantile(0.5) == 1.0
        t[0] = 100.0
        assert ws.count == 0 and ws.total_count == 11 and ws.summary()["count"] == 0
        t[0] = 0.0
        wc = mod.WindowedCounts(horizon_s=40.0, bucket_s=1.0, clock=lambda: t[0])
        wc.add("events")
        wc.add("bad")
        t[0] = 10.0
        for _ in range(4):
            wc.add("events")
        assert wc.sums(5.0) == {"events": 4.0}
        assert wc.sums(40.0) == {"events": 5.0, "bad": 1.0}
        t[0] = 60.0
        wc.add("events")
        assert wc.sums(40.0) == {"events": 1.0}
        assert wc.totals == {"events": 6.0, "bad": 1.0}


# -- request tracing -----------------------------------------------------------------


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01", "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01", f"00-{'0' * 32}-b7ad6b7169203331-01",
    f"00-0af7651916cd43dd8448eb211c80319c-{'0' * 16}-01", "garbage", "", None, " 00-" + "a" * 32 + "-" + "b" * 16 + "-03 ",
])
def test_traceparent_parse_and_format_equal_jax(header):
    got, want = ttracing.parse_traceparent(header), jtracing.parse_traceparent(header)
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert ttracing.format_traceparent(got) == jtracing.format_traceparent(want)


def _trace_export(mod_tracing, mod_spans):
    """Two seeded requests (one joining a caller's trace, one unsampled)
    through a Tracer: the Chrome export's request spans, timestamps cut."""
    rec = mod_spans.SpanRecorder()
    tracer = mod_tracing.Tracer(rec, sample=1.0, seed=11)
    a = tracer.begin_request("00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01")
    b = tracer.begin_request()
    assert tracer.begin_request(f"00-{'c' * 32}-{'d' * 16}-00") is None
    for tr in (a, b):
        tr.span("req.queue", tr.t0, n_prompt=3)
        tr.event("req.first_token")
        assert tr.finish("done", n_tokens=2) and not tr.finish("error")
    events = rec.to_chrome_trace()["traceEvents"]
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")} for e in events]


def test_tracer_spans_equal_jax():
    got, want = _trace_export(ttracing, tspans), _trace_export(jtracing, jspans)
    assert got == want
    names = [e["args"]["name"] for e in got if e["ph"] == "M"]
    assert len(names) == 2 and all(n.startswith("req ") for n in names)
    roots = [e for e in got if e["name"] == "req.request"]
    assert roots[0]["args"]["parent_span_id"] == "b7ad6b7169203331"
    with pytest.raises(ValueError, match="sample"):
        ttracing.Tracer(tspans.SpanRecorder(), sample=1.5)


def test_span_recorder_record_bounds_and_tracks():
    rec = tspans.SpanRecorder(max_events=3)
    for i in range(5):
        rec.record("x", float(i), 0.5, meta={"i": i}, track="req a" if i % 2 else None)
    trace = rec.to_chrome_trace()
    assert rec.dropped == 2 and trace["otherData"]["dropped_spans"] == 2
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [e["args"]["i"] for e in xs] == [0, 1, 2]
    assert all("_track" not in e["args"] for e in xs)
    assert len({e["tid"] for e in xs}) == 2


def _obs_report():
    spec = importlib.util.spec_from_file_location(
        "obs_report_for_port_slo", Path(__file__).resolve().parent.parent / "scripts" / "obs_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _request_traces():
    """A done, a chunked done, a rejected and a cancelled request through
    the port's Tracer, as a Chrome export."""
    rec = tspans.SpanRecorder()
    tracer = ttracing.Tracer(rec, sample=1.0, seed=5)
    for status, names in (("done", ("req.queue", "req.prefill", "req.window", "req.window")),
                          ("done", ("req.queue", "req.prefill_chunk", "req.prefill_chunk", "req.window")),
                          ("rejected", ("req.admission",)), ("cancelled", ("req.queue",))):
        tr = tracer.begin_request()
        for name in names:
            tr.span(name, tr.t0)
        if status == "done":
            tr.event("req.first_token")
        tr.finish(status)
    return rec.to_chrome_trace()


def _mutate(trace, how):
    trace = copy.deepcopy(trace)
    evs = trace["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    first = xs[0]["args"]["trace_id"]
    mine = [e for e in xs if e["args"]["trace_id"] == first]
    root = next(e for e in mine if e["name"] == "req.request")
    if how == "no_window":
        evs[:] = [e for e in evs if not (e in mine and e["name"] == "req.window")]
    elif how == "two_terminals":
        evs.append(copy.deepcopy(next(e for e in mine if e["name"] == "req.terminal")))
    elif how == "terminal_status":
        next(e for e in mine if e["name"] == "req.terminal")["args"]["status"] = "error"
    elif how == "orphan":
        next(e for e in mine if e["name"] == "req.queue")["args"]["parent_span_id"] = "f" * 16
    elif how == "no_root":
        evs.remove(root)
    elif how.startswith("remote"):
        sid = root["args"]["span_id"]
        attempt = dict(copy.deepcopy(root), name="req.attempt")
        attempt["args"].update(span_id="a" * 16, parent_span_id=sid)
        wroot = copy.deepcopy(root)
        wroot["args"].update(span_id="b" * 16, remote=True, worker=1,
                             parent_span_id="c" * 16 if how == "remote_unparented" else "a" * 16)
        child = copy.deepcopy(next(e for e in mine if e["name"] == "req.window"))
        child["args"].update(span_id="d" * 16, remote=True,
                             parent_span_id="e" * 16 if how == "remote_stray_child" else "b" * 16)
        evs.extend([attempt, wroot, child])
    return trace


@pytest.mark.parametrize("how", ["complete", "no_window", "two_terminals", "terminal_status", "orphan",
                                 "no_root", "remote_under_attempt", "remote_unparented", "remote_stray_child"])
def test_trace_tree_check_equals_obs_reports(how):
    """``tracing.group_request_spans``/``check_trace_tree`` (the port's
    copies) find ``scripts/obs_report.py``'s problems on the same traces,
    whole and broken."""
    obs_report = _obs_report()
    trace = _mutate(_request_traces(), how)
    got, want = ttracing.group_request_spans(trace), obs_report.group_request_spans(trace)
    assert got == want and len(got) == 4
    problems = {t: ttracing.check_trace_tree(t, s) for t, s in got.items()}
    assert problems == {t: obs_report.check_trace_tree(t, s) for t, s in want.items()}
    broken = how not in ("complete", "remote_under_attempt", "remote_stray_child")
    assert sum(bool(p) for p in problems.values()) == int(broken), problems


# -- the SLO engine -------------------------------------------------------------------


def _slo_run(mods, stream, **kw):
    """Feed ``stream`` ((dt, kind, fields) records) to one package's SLO
    engine under a fake clock: (alerts, decision tail, snapshot after the
    stream, snapshot after rolling past the windows)."""
    m_events, m_capacity, m_slo = mods
    t = [100.0]
    clock = lambda: t[0]  # noqa: E731
    bus = m_events.EventBus(clock=clock, wall=clock)
    dec = m_capacity.DecisionLog(bus=bus)
    classes = m_slo.default_slo_classes(ttft_s=kw.pop("ttft_s", 0.5), e2e_s=kw.pop("e2e_s", 2.0),
                                        target=kw.pop("target", 0.99))
    slo = m_slo.SLOEngine(classes=classes, bus=bus, decisions=dec, clock=clock, window_scale=0.01, **kw)
    alerts = []
    bus.subscribe(lambda r: alerts.append(r) if r.get("event") == "slo_alert" else None)
    for dt, kind, fields in stream:
        t[0] += dt
        bus.emit(kind, **fields)
    mid = slo.snapshot()
    t[0] += 5.0
    end = slo.snapshot()
    # Decision records carry the process's perf_counter (t_s), not the fake clock.
    ledger = [{k: v for k, v in r.items() if k != "t_s"} for r in dec.tail()]
    return alerts, ledger, mid, end


def _stream():
    out = [(0.001, "req_done", dict(replica=0, trace_id=f"ok{i}", ttft_s=0.01, tpot_s=0.005, e2e_s=0.1,
                                    queue_wait_s=0.0)) for i in range(20)]
    out += [(0.001, "req_done", dict(replica=1, trace_id=f"slow{i}", ttft_s=5.0, tpot_s=0.1, e2e_s=6.0,
                                     queue_wait_s=0.5)) for i in range(5)]
    out += [(0.01, "req_cancelled", dict(replica=0, e2e_s=9.0, queue_wait_s=4.0)),
            (0.01, "req_rejected", dict(replica=1, reason="busy")),
            (0.01, "req_rejected", dict(fleet=True, reason="placement")),
            (0.01, "req_rejected", dict(reason="queue_full")),
            (0.01, "req_expired", dict(replica=0, trace_id="late", e2e_s=3.0, queue_wait_s=1.0)),
            (0.01, "req_error", dict(replica=1, trace_id="boom", e2e_s=0.2))]
    return out


def test_slo_engine_fires_and_resolves_the_jax_alerts():
    got = _slo_run((tevents, tcapacity, tslo), _stream())
    want = _slo_run((jevents, jcapacity, jslo), _stream())
    assert got[0] == want[0]  # every slo_alert event, firing and resolved
    assert got[1] == want[1]  # the decision ledger
    assert got[2] == want[2] and got[3] == want[3]  # the GET /slo bodies
    alerts, decisions, _, end = got
    fast = [a for a in alerts if a["state"] == "firing" and a["rule"] == "fast_burn"]
    assert len(fast) == 1 and fast[0]["trigger_trace_id"] == "slow3" and fast[0]["trigger_replica"] == 1
    assert fast[0]["alert_id"] in [d["alert_id"] for d in decisions if d["decision"] == "slo_alert"]
    assert end["alerts"]["active"] == []
    assert fast[0]["alert_id"] in {a["alert_id"] for a in alerts if a["state"] == "resolved"}
    assert end["latency"]["fleet"]["e2e_s"]["count"] == 28  # the 60 s sketch window still holds them
    json.dumps(end)


def test_slo_per_replica_sketches_and_validation():
    stream = [(0.001, "req_done", dict(replica=i % 2, ttft_s=0.01 + (i % 2) * 1.0, e2e_s=0.1, queue_wait_s=0.0,
                                       tpot_s=0.005)) for i in range(50)]
    _, _, mid, _ = _slo_run((tevents, tcapacity, tslo), stream)
    per = mid["latency"]["replicas"]
    assert set(per) == {"0", "1"} and per["0"]["ttft_s"]["p99"] < 0.1 < per["1"]["ttft_s"]["p99"]
    assert mid == _slo_run((jevents, jcapacity, jslo), stream)[2]
    for ctor, kw in ((tslo.SLOObjective, dict(metric="ttft_s", target=1.5)),
                     (tslo.SLOObjective, dict(metric="nope", target=0.9)),
                     (tslo.SLOEngine, dict(window_scale=0.0))):
        jctor = getattr(jslo, ctor.__name__)
        with pytest.raises(ValueError) as want:
            jctor(**kw)
        with pytest.raises(ValueError) as got:
            ctor(**kw)
        assert str(got.value) == str(want.value)


# -- render_merged ----------------------------------------------------------------------


def _merged(mod):
    fleet = mod.MetricsRegistry("pllm_serving_")
    r0 = mod.MetricsRegistry("pllm_serving_", const_labels={"replica": 0})
    r1 = mod.MetricsRegistry("pllm_serving_", const_labels={"replica": 1})
    fleet.counter("redrives_total", "redrives").inc(2)
    for reg in (r0, r1):
        reg.counter("http_errors_total", "errors").inc(1)
        reg.gauge("queue_depth", "depth").set(3)
        h = reg.histogram("e2e_seconds", "e2e")
        for v in (0.01, 0.2, 3.0):
            h.observe(v)
    text = mod.render_merged([fleet, r0, r1], {"replicas_active": 2.0, "redrives_total": 9.0, "flag": True})
    bad = mod.MetricsRegistry("pllm_serving_")
    bad.gauge("http_errors_total", "oops")
    with pytest.raises(ValueError, match="registered as"):
        mod.render_merged([r0, bad], None)
    with pytest.raises(ValueError, match="at least one"):
        mod.render_merged([], None)
    return text


def test_render_merged_equal_to_jax():
    text = _merged(tmetrics)
    assert text == _merged(jmetrics)
    assert lint_exposition(text) == []
    assert text.count("# TYPE pllm_serving_http_errors_total counter") == 1
    assert 'pllm_serving_queue_depth{replica="1"} 3' in text and "pllm_serving_replicas_active 2" in text


# -- weight fingerprint ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights():
    layout = jax.eval_shape(functools.partial(jtf.init_params, JCFG), jax.random.key(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map_with_path(
        lambda path, spec: rng.normal(0, 0.3, spec.shape).astype(np.float32), layout)


def test_weight_fingerprint_equals_jax_within_fp32_rounding():
    tree = _weights()
    params = bridge.params_from_numpy(tree, CFG, device="cpu")
    got, want = tintegrity.weight_fingerprint(params), jintegrity.weight_fingerprint(jax.tree.map(jnp.asarray, tree))
    scale = sum((i + 1) * float(np.abs(leaf).sum()) for i, leaf in enumerate(jax.tree.leaves(tree)))
    assert abs(got - want) <= 1e-6 * scale
    assert got == tintegrity.weight_fingerprint(params)  # deterministic
    # Quantized trees: the int8 codes count too.
    qt = tquantize.quantize_params_for_serving(params, CFG)
    jq = jquantize.quantize_params_for_serving(jax.tree.map(jnp.asarray, tree), JCFG)
    qgot, qwant = tintegrity.weight_fingerprint(qt), jintegrity.weight_fingerprint(jq)
    qscale = sum((i + 1) * float(np.abs(np.asarray(leaf, np.float32)).sum()) for i, leaf in enumerate(jax.tree.leaves(jq)))
    assert abs(qgot - qwant) <= 1e-6 * qscale
    # Corruption of one value moves it.
    bad = {**params, "final_norm": {**params["final_norm"], "scale": params["final_norm"]["scale"].clone()}}
    bad["final_norm"]["scale"][0] += 1.0
    assert tintegrity.weight_fingerprint(bad) != got


def test_engine_loop_pins_and_refreshes_the_fingerprint():
    from pretraining_llm_tpu_torch.frontend.engine_loop import EngineLoop
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine

    params = bridge.params_from_numpy(_weights(), CFG, device="cpu")
    eng = ServingEngine(params, CFG, device="cpu", max_batch=2, n_blocks=16, block_size=8)
    with pytest.raises(ValueError, match="weight_fingerprint_interval_s"):
        EngineLoop(eng, weight_fingerprint_interval_s=-1.0)
    with EngineLoop(eng, weight_fingerprint_interval_s=0.01) as loop:
        assert loop.submit([1, 2, 3], 4).result(timeout=120)[0] == "done"
        assert loop.weight_fingerprint0 == tintegrity.weight_fingerprint(params)
        assert loop.weight_fingerprint == loop.weight_fingerprint0
    assert torch.get_num_threads() == 1
