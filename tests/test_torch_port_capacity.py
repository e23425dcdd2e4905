"""The port's capacity observability (``observability/capacity.py`` and the
engine's sampler and decision-log sites) against the JAX package's.

Mirrors ``tests/test_capacity.py``. The bar: the instruments ride reads the
reap already makes, so greedy outputs stay bit-identical with the layer on
and off at every pipeline depth, and an instrumented run reads back as many
tensors as a plain one; the decision vocabulary and the sampler's records
are the JAX package's; on the same pool-pressure workload the port's
decision counts (preemptions, evictions) equal the JAX engine's; every
preemption carries a trace id the ``req_*`` stream knows; and
``scripts/obs_report.py --capacity --strict`` accepts the port's events
JSONL, its report identical with the layer on and off. The tiny preset at
fp32 with seeded numpy weights (std 0.3) given to both packages through
``models/bridge.py``; a pool of 8 blocks of 8 slots, so that preemption
and cold-cache eviction fire.
"""

import dataclasses
import functools
import importlib.util
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.generation.serving import ServingEngine as JaxEngine
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.observability import capacity as jcapacity
from pretraining_llm_tpu.observability.events import EventBus as JaxBus
from pretraining_llm_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.frontend.admission import AdmissionController
from pretraining_llm_tpu_torch.frontend.engine_loop import EngineLoop
from pretraining_llm_tpu_torch.frontend.gateway import ServingGateway
from pretraining_llm_tpu_torch.frontend.loadgen import LoadSpec, run_engine_loop
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.observability import capacity as tcapacity
from pretraining_llm_tpu_torch.observability.capacity import DECISION_KINDS, DecisionLog
from pretraining_llm_tpu_torch.observability.events import EVENT_KINDS, EventBus
from pretraining_llm_tpu_torch.observability.metrics import MetricsRegistry
from pretraining_llm_tpu_torch.observability.spans import SpanRecorder
from pretraining_llm_tpu_torch.observability.tracing import Tracer

ROOT = Path(__file__).resolve().parent.parent
JCFG = dataclasses.replace(jcfg.get_preset("tiny").model, compute_dtype="float32")
CFG = tcfg.ModelConfig(**dict(dataclasses.asdict(JCFG), paged_attention_impl="kernel"))
WAIT = 120  # seconds any one stream event, socket read or subprocess may take

_spec = importlib.util.spec_from_file_location("obs_report_for_port_capacity", ROOT / "scripts" / "obs_report.py")
obs_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(obs_report)


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
    return bridge.params_from_numpy(_weights(), CFG, device="cpu")


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(jnp.asarray, _weights())


def _prompts(n, lengths=(12, 10, 11, 12)):
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG.vocab_size, size=int(lengths[i % len(lengths)])).tolist() for i in range(n)]


POOL_KW = dict(max_batch=2, n_blocks=8, block_size=8, steps_per_sched=4, pipeline_depth=2, prefix_cache=True)


def _tiny_pool_engine(params, **kw):
    """A pool small enough that preemption and cold-cache eviction fire."""
    return ServingEngine(params, CFG, device="cpu", temperature=0.0, **{**POOL_KW, **kw})


def _instrument(eng, mod, bus=None, registry=None):
    """Install the capacity layer (sampler, decision log, preemption
    counters) of package ``mod`` on an engine of either package."""
    eng.capacity = mod.CapacitySampler(eng.max_batch, eng.alloc.n_blocks - 1, bus=bus)
    eng.decisions = mod.DecisionLog(bus=bus)
    if registry is not None:
        eng.capacity.bind(registry)
        eng.preempt_counter = registry.counter("preemptions_total", "preemptions")
        eng.preempt_tokens_counter = registry.counter("preempted_tokens_recomputed_total", "rework")


# -- the instruments ---------------------------------------------------------


def test_decision_log_kinds_and_ring():
    log = DecisionLog(maxlen=3)
    with pytest.raises(ValueError, match="unknown decision kind"):
        log.record("coffee_break")
    for i in range(5):
        log.record("preempt", rid=i)
    assert [r["rid"] for r in log.tail()] == [2, 3, 4]
    assert log.counts_snapshot() == {"preempt": 5}
    assert log.tail(1)[0]["rid"] == 4
    with pytest.raises(ValueError, match="maxlen"):
        DecisionLog(maxlen=0)


def test_capacity_event_kinds_documented():
    assert "cap_window" in EVENT_KINDS and "decision" in EVENT_KINDS
    assert DECISION_KINDS == jcapacity.DECISION_KINDS


def _sampler_records(mod):
    events = []
    bus = mod_bus(mod)
    bus.subscribe(events.append)
    samp = mod.CapacitySampler(4, 23, maxlen=2, bus=bus, admission_snapshot_fn=lambda: {"live_requests": 3})
    recs = [samp.observe_window(
        window=0, kind="decode", t_dispatch_s=1.0, t_reap_s=1.5, steps=4, rows=3, tokens_committed=10,
        waiting=1, pool_free=5, pool_cold=2, host_blocked_s=0.1, cum_tokens=10, cum_prefill_tokens=30,
        cum_rework_prefill_tokens=0, cum_preemptions=0,
    )]
    for i in range(3):
        recs.append(samp.observe_window(
            window=i + 1, kind="decode", t_dispatch_s=2.0 + i, t_reap_s=2.5 + i, steps=4, rows=1,
            tokens_committed=4, waiting=0, pool_free=7, pool_cold=0, host_blocked_s=0.0, cum_tokens=14 + 4 * i,
            cum_prefill_tokens=30, cum_rework_prefill_tokens=0, cum_preemptions=0,
        ))
    strip = ("t_wall", "t_mono", "seq", "pid", "host")
    return recs, [{k: v for k, v in e.items() if k not in strip} for e in events], samp


def mod_bus(mod):
    return JaxBus() if mod is jcapacity else EventBus()


def test_sampler_record_schema_and_bus():
    recs, events, samp = _sampler_records(tcapacity)
    jrecs, jevents, _ = _sampler_records(jcapacity)
    assert recs == jrecs and events == jevents
    assert recs[0]["pool_live"] == 23 - 5 - 2
    assert recs[0]["slot_tokens"] == 12 and recs[0]["dur_s"] == pytest.approx(0.5)
    assert events[0]["event"] == "cap_window" and events[0]["rows_capacity"] == 4
    json.dumps(events[0], allow_nan=False)
    assert len(samp.tail()) == 2 and samp.windows_sampled == 4


# -- decisions and trace linkage under pool pressure --------------------------


SPEC = dict(n_requests=4, mode="closed", concurrency=4, seed=11, vocab_size=256, prompt_len_min=10,
            prompt_len_max=12, max_new_min=20, max_new_max=24)


def _pressured_run(params, *, registry=None, events=None, capacity_ring=512):
    """Seeded load against the tiny-pool engine behind the loop (admission,
    tracing, bus): (loop, engine, report)."""
    eng = _tiny_pool_engine(params)
    bus = EventBus()
    if events is not None:
        bus.subscribe(events.append)
    loop = EngineLoop(eng, admission=AdmissionController(max_queue_depth=8, registry=registry), bus=bus,
                      tracer=Tracer(SpanRecorder(), sample=1.0, seed=3), registry=registry,
                      capacity_ring=capacity_ring)
    with loop:
        report = run_engine_loop(loop, LoadSpec(**SPEC))
    return loop, eng, report


def test_decision_log_preemption_and_eviction_with_trace_linkage(params):
    events = []
    loop, eng, report = _pressured_run(params, events=events)
    assert all(o.status == "done" for o in report.outcomes)
    counts = loop.decisions.counts_snapshot()
    assert counts.get("preempt", 0) >= 1 and counts.get("evict_cold", 0) >= 1, counts
    assert eng.stats["preemptions"] == counts["preempt"]
    assert eng.stats.get("preempted_tokens_recomputed", 0) >= 1
    known = {e["trace_id"] for e in events if e["event"].startswith("req_") and "trace_id" in e}
    assert len(known) == 4
    for rec in (r for r in loop.decisions.tail() if r["decision"] == "preempt"):
        assert rec["trace_id"] in known and rec["blocks_reclaimed"] >= 1 and rec["victim_admit_order"] >= 0
    assert len([e for e in events if e["event"] == "decision"]) == sum(counts.values())
    caps = [e for e in events if e["event"] == "cap_window"]
    assert len(caps) == eng.stats["windows_reaped"]
    assert all(c["rows_capacity"] == 2 and c["pool_total"] == 7 for c in caps)


def test_capacity_report_on_pressured_run(params):
    """``build_capacity_report`` of ``scripts/obs_report.py`` over the port's
    events: segments sum to wall time within 1%, a binding constraint is
    named, every decision joins."""
    events = []
    _pressured_run(params, events=events)
    cap = obs_report.build_capacity_report(events)
    assert cap["problems"] == []
    assert cap["n_windows"] >= 1
    assert abs(sum(cap["segments"].values()) - cap["wall_s"]) <= 0.01 * cap["wall_s"]
    assert cap["binding_constraint"] in cap["constraint_scores"]
    assert cap["decisions"].get("preempt", 0) >= 1 and cap["decisions_by_trace"]


def _report_cli(path, *flags):
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "obs_report.py"), *flags, "--strict", "--json",
                           str(path)], capture_output=True, text=True, timeout=WAIT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout)


def test_obs_report_capacity_strict_over_port_events(params, tmp_path):
    """``scripts/obs_report.py --capacity --strict`` passes over the port's
    events JSONL (every decision joins a request, the waterfall sums), and
    the served tokens are the same with the capacity layer on and off (off:
    the events pass ``--strict`` and hold no capacity records)."""
    from pretraining_llm_tpu_torch.frontend.loadgen import build_schedule

    schedule = build_schedule(LoadSpec(**SPEC))
    served, kinds = {}, {}
    for ring in (512, 0):
        path = tmp_path / f"events_{ring}.jsonl"
        bus = EventBus(jsonl_path=str(path))
        with EngineLoop(_tiny_pool_engine(params), bus=bus, tracer=Tracer(SpanRecorder(), sample=1.0, seed=3),
                        capacity_ring=ring) as loop:
            reqs = [loop.submit(sr.prompt, sr.max_new) for sr in schedule]
            served[ring] = [req.result(timeout=WAIT) for req in reqs]
        bus.close()
        assert all(status == "done" for status, _, _ in served[ring])
        kinds[ring] = [json.loads(ln)["event"] for ln in path.read_text().splitlines()]
        report = _report_cli(path, *(("--capacity",) if ring else ()))
        if ring:
            assert report["capacity"]["problems"] == [] and report["capacity"]["n_windows"] >= 1
            assert report["capacity"]["decisions"].get("preempt", 0) >= 1
    assert [toks for _, toks, _ in served[512]] == [toks for _, toks, _ in served[0]]
    assert kinds[512].count("req_done") == kinds[0].count("req_done") == len(schedule)
    assert "cap_window" in kinds[512] and "cap_window" not in kinds[0] and "decision" not in kinds[0]


def test_capacity_report_strict_catches_unjoinable_decision():
    """A decision the port's log records for a trace no request event
    knows is flagged by the analyzer's join."""
    events = []
    bus = EventBus()
    bus.subscribe(events.append)
    DecisionLog(bus=bus).record("preempt", trace_id="feedfacefeedfacefeedfacefeedface", rid=0)
    cap = obs_report.build_capacity_report(events)
    assert any("no matching req_*" in p for p in cap["problems"])
    assert any("no cap_window" in p for p in cap["problems"])


# -- bit identity and no added reads ----------------------------------------------


def _run_instrumented(eng, mod, prompts, n_new, instrument):
    bus = mod_bus(mod) if instrument else None
    if instrument:
        reg = (JaxRegistry if mod is jcapacity else MetricsRegistry)("pllm_serving_")
        _instrument(eng, mod, bus=bus, registry=reg)
    for p in prompts:
        eng.submit(p, n_new)
    return eng.run(pipeline=True)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_outputs_identical_with_capacity_layer(params, jparams, depth):
    """Greedy outputs with the capacity layer installed equal a plain run
    through the preemption/eviction workload at every depth, and the JAX
    engine's under its own layer: same streams, same decision counts."""
    prompts, n_new = _prompts(2, lengths=(12, 10)), 24
    out_plain = _run_instrumented(_tiny_pool_engine(params, pipeline_depth=depth), None, prompts, n_new, False)
    eng = _tiny_pool_engine(params, pipeline_depth=depth)
    out_inst = _run_instrumented(eng, tcapacity, prompts, n_new, True)
    jeng = JaxEngine(jparams, JCFG, temperature=0.0, **{**POOL_KW, "pipeline_depth": depth})
    jout = _run_instrumented(jeng, jcapacity, prompts, n_new, True)
    assert out_inst == out_plain == jout
    assert eng.stats["preemptions"] >= 1
    assert eng.decisions.counts_snapshot() == jeng.decisions.counts_snapshot()
    assert eng.decisions.counts_snapshot().get("preempt", 0) >= 1
    assert eng.preempt_counter.value == eng.stats["preemptions"] == jeng.stats["preemptions"]
    assert eng.capacity.windows_sampled == eng.stats["windows_reaped"] == jeng.capacity.windows_sampled


def _count_reads(fn):
    """``fn()`` under a mode that counts every tensor read back to the host
    (the calls that wait for the stream on the card)."""
    reads = ("cpu", "item", "tolist", "numpy", "__int__", "__bool__", "__float__", "nonzero")
    seen = []

    class Spy(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in reads:
                seen.append(func.__name__)
            return func(*args, **(kwargs or {}))

    with Spy():
        out = fn()
    return out, len(seen)


def test_capacity_sampling_adds_no_device_syncs(params):
    prompts = _prompts(2, lengths=(12, 10))
    runs = {}
    for instrument in (False, True):
        eng = _tiny_pool_engine(params)
        runs[instrument] = _count_reads(lambda: _run_instrumented(eng, tcapacity, prompts, 24, instrument)) + (eng,)
    (out_plain, reads_plain, _), (out_inst, reads_inst, eng) = runs[False], runs[True]
    assert out_inst == out_plain
    assert reads_inst == reads_plain > 0
    assert eng.capacity.windows_sampled == eng.stats["windows_reaped"]
    assert eng.decisions.counts_snapshot().get("preempt", 0) >= 1


# -- typed gauges and counters ----------------------------------------------------


def test_admission_gauges_and_preemption_counters(params):
    reg = MetricsRegistry("pllm_serving_")
    loop, eng, _ = _pressured_run(params, registry=reg)
    text = reg.render(extra_gauges=loop.metrics())
    for line in ("# TYPE pllm_serving_admission_queue_depth gauge", "pllm_serving_admission_queue_depth_limit 8.0",
                 "# TYPE pllm_serving_admission_outstanding_tokens gauge",
                 "# TYPE pllm_serving_preemptions_total counter",
                 "# TYPE pllm_serving_preempted_tokens_recomputed_total counter",
                 'pllm_serving_deadline_shed_total{kind="admission"} 0.0',
                 "# TYPE pllm_serving_capacity_rows_active gauge", 'pllm_serving_capacity_pool_blocks{state="free"}',
                 "pllm_serving_capacity_pool_blocks_limit 7.0",
                 "# TYPE pllm_serving_capacity_window_occupancy histogram",
                 "# TYPE pllm_serving_prefix_cache_hits_total counter"):
        assert line in text, line
    assert eng.preempt_counter.value == eng.stats["preemptions"] >= 1
    m = loop.metrics()
    assert m["admission_live_requests"] == 0 and m["admission_outstanding_tokens"] == 0


def test_frontend_config_capacity_ring_validation():
    assert tcfg.FrontendConfig().capacity_ring == 512
    with pytest.raises(ValueError) as want:
        jcfg.FrontendConfig(capacity_ring=-1)
    with pytest.raises(ValueError, match="capacity_ring") as got:
        tcfg.FrontendConfig(capacity_ring=-1)
    assert str(got.value) == str(want.value)


def test_engine_loop_capacity_ring_zero_disables(params):
    eng = _tiny_pool_engine(params)
    loop = EngineLoop(eng, capacity_ring=0)
    assert loop.capacity is None and loop.decisions is None
    assert eng.capacity is None and eng.decisions is None
    with pytest.raises(ValueError, match="capacity_ring"):
        EngineLoop(eng, capacity_ring=-1)


# -- /debug endpoints ---------------------------------------------------------------


def test_debug_endpoints_pool_accounting(params):
    eng = _tiny_pool_engine(params)
    loop = EngineLoop(eng, admission=AdmissionController(max_queue_depth=8))
    gw = ServingGateway(loop, port=0)
    loop.start()
    gw.start()
    base = f"http://127.0.0.1:{gw.port}"

    def get(path):
        with urllib.request.urlopen(f"{base}{path}", timeout=WAIT) as r:
            return json.loads(r.read())

    try:
        dbg = get("/debug/engine")
        pool = dbg["pool"]
        assert pool["total"] == eng.alloc.n_blocks - 1 == 7
        assert pool["free"] == eng.alloc.available
        assert pool["free"] + pool["cold"] + pool["live"] == pool["total"]
        assert dbg["rows"] == {"active": 0, "capacity": 2}
        assert dbg["admission"]["max_queue_depth"] == 8 and dbg["decisions"]["counts"] == {}
        assert get("/debug/requests")["requests"] == []
        run_engine_loop(loop, LoadSpec(**SPEC))
        dbg = get("/debug/engine?tail=8")
        assert dbg["decisions"]["counts"].get("preempt", 0) >= 1
        last = dbg["occupancy"][-1]
        assert last["rows_capacity"] == 2 and last["pool_total"] == 7
        assert dbg["windows_sampled"] == eng.stats["windows_reaped"]
        pool = dbg["pool"]
        assert pool["free"] + pool["cold"] + pool["live"] == pool["total"]
        assert pool["free"] == eng.alloc.available
        assert dbg["prefix_cache"]["cold"] == eng.prefix_cache.evictable
        gauges = eng.health_gauges()
        assert (gauges["pool_free"], gauges["pool_cold"]) == (pool["free"], pool["cold"])
    finally:
        gw.stop()
        loop.stop(timeout=WAIT)


def test_debug_requests_live_state(params):
    eng = _tiny_pool_engine(params)
    orig = eng.pipeline_tick

    def slow_tick():
        time.sleep(0.05)
        return orig()

    eng.pipeline_tick = slow_tick
    loop = EngineLoop(eng).start()
    try:
        h = loop.submit(_prompts(1)[0], 32, deadline_s=300.0)
        deadline = time.monotonic() + 30.0
        seen = None
        while time.monotonic() < deadline and seen is None:
            seen = next((r for r in loop.debug_requests() if r.get("phase") == "decode"), None)
            time.sleep(0.01)
        assert seen is not None, "request never observed on a row"
        assert seen["row"] in (0, 1) and seen["blocks_held"] >= 1
        assert seen["status"] == "active" and seen["deadline_remaining_s"] > 0
        h.result(timeout=WAIT)
    finally:
        loop.stop(timeout=WAIT)


def test_pool_info_matches_jax(params, jparams):
    """The layout ``/debug/engine`` and the pool gauges report."""
    for quantize in ("none", "int8-kv"):
        got = ServingEngine(params, CFG, device="cpu", quantize=quantize, n_blocks=8, block_size=8).pool_info()
        want = JaxEngine(jparams, JCFG, quantize=quantize, n_blocks=8, block_size=8).pool_info()
        assert got == want
    assert torch.get_num_threads() == 1
