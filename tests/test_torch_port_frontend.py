"""The port's online front end (``frontend/``: engine loop, admission,
gateway, load generator) and the engine's frontend hooks, against the JAX
package's.

Mirrors ``tests/test_frontend.py``. The bar: greedy tokens that go through
the port's ``EngineLoop`` (arriving, cancelled and expiring mid-decode)
equal the port's offline ``ServingEngine.run()`` and the JAX ``EngineLoop``
on the same weights; a request cancelled while windows are in flight leaves
every survivor's stream bit-identical to a run without it and to the JAX
engine under the same cancel, at depths 1-3, with its blocks back in the
allocator; the port's ``AdmissionController``, ``build_schedule``,
``LoadReport.summary`` and ``frontend`` section make the JAX package's
decisions and numbers; the gateway answers every endpoint with the JAX
gateway's status codes (400, 404, 429, 499, 503, 504), SSE and
``traceparent``; every terminal leaves a complete trace tree (the checker
of ``scripts/obs_report.py``); tracing and metrics add no host reads; and
``python -m pretraining_llm_tpu_torch.serve --http --device cpu`` answers
and drains on SIGTERM. The tiny preset at fp32 (2 layers, d 32, V 256)
with seeded numpy weights (std 0.3) given to both packages through
``models/bridge.py``; the port runs the kernels' plain versions.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.frontend import admission as jadmission
from pretraining_llm_tpu.frontend import loadgen as jloadgen
from pretraining_llm_tpu.frontend.engine_loop import EngineLoop as JaxLoop
from pretraining_llm_tpu.generation.serving import ServingEngine as JaxEngine
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.frontend.admission import AdmissionController, RejectedBusy, RejectedInfeasible
from pretraining_llm_tpu_torch.frontend.engine_loop import EngineLoop
from pretraining_llm_tpu_torch.frontend.gateway import ServingGateway
from pretraining_llm_tpu_torch.frontend.loadgen import (
    LoadReport, LoadSpec, RequestOutcome, build_schedule, run_engine_loop, run_http,
)
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.observability.events import EventBus
from pretraining_llm_tpu_torch.observability.export import lint_exposition
from pretraining_llm_tpu_torch.observability.metrics import MetricsRegistry
from pretraining_llm_tpu_torch.observability.spans import SpanRecorder
from pretraining_llm_tpu_torch.observability import tracing as ttracing
from pretraining_llm_tpu_torch.observability.tracing import Tracer

ROOT = Path(__file__).resolve().parent.parent
JCFG = dataclasses.replace(jcfg.get_preset("tiny").model, compute_dtype="float32")
CFG = tcfg.ModelConfig(**dict(dataclasses.asdict(JCFG), paged_attention_impl="kernel"))
POOL = 24  # the engines' blocks; block 0 is the reserved scratch block
WAIT = 120  # seconds any one stream event, socket read or thread join may take

_spec = importlib.util.spec_from_file_location("obs_report_for_port_frontend", ROOT / "scripts" / "obs_report.py")
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
def jparams():
    return jax.tree.map(jnp.asarray, _weights())


@pytest.fixture(scope="module")
def params():
    return bridge.params_from_numpy(_weights(), CFG, device="cpu")


def _prompts(n, lengths=(5, 9, 14, 7, 11, 3, 16, 6)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, CFG.vocab_size, size=int(lengths[i % len(lengths)])).tolist() for i in range(n)]


def _kw(kw):
    kw = dict(kw)
    for key, value in (("max_batch", 2), ("n_blocks", POOL), ("block_size", 8), ("steps_per_sched", 4),
                       ("pipeline_depth", 2)):
        kw.setdefault(key, value)
    return kw


def _engine(params, **kw):
    return ServingEngine(params, CFG, device="cpu", temperature=0.0, **_kw(kw))


def _jengine(jparams, **kw):
    return JaxEngine(jparams, JCFG, temperature=0.0, **_kw(kw))


def _offline(eng, prompts, n_new):
    rids = [eng.submit(p, n_new) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@functools.lru_cache(maxsize=None)
def _reference(prompt, n_new):
    """The port's offline engine, one request alone (greedy)."""
    params = bridge.params_from_numpy(_weights(), CFG, device="cpu")
    return _offline(_engine(params), [list(prompt)], n_new)[0]


def _throttle(eng, delay=0.05):
    """Slow every scheduler turn, so that mid-generation is a state a test
    can act in (the tiny model decodes a request in milliseconds)."""
    orig = eng.pipeline_tick

    def slow_tick():
        time.sleep(delay)
        return orig()

    eng.pipeline_tick = slow_tick


# -- submit-time validation -------------------------------------------------


BAD_SUBMITS = [([], 4), ([1, 2], 0), ([1, 2], -3), ([1, 2], 2.5), ([1, 2], "8"), ([0.5, 1.5], 4),
               ([0, 256], 4), ([-1, 3], 4), ([1] * 10, 64), ([[1], [2]], 4)]


def test_submit_validation_rejects_clearly(params, jparams):
    """Every bad request raises the JAX engine's ``ValueError`` message and
    queues nothing."""
    eng, jeng = _engine(params), _jengine(jparams)
    for prompt, max_new in BAD_SUBMITS:
        with pytest.raises(ValueError) as want:
            jeng.submit(prompt, max_new)
        with pytest.raises(ValueError) as got:
            eng.submit(prompt, max_new)
        assert str(got.value) == str(want.value), (prompt, max_new)
    assert not eng.waiting and eng.stats["tokens"] == 0


def test_submit_validation_rejects_nested_prompt(params):
    eng = _engine(params)
    with pytest.raises(ValueError, match="flat"):
        eng.submit([[1], [2]], 4)
    with pytest.raises(ValueError, match="flat"):
        eng.submit(np.array([[1, 2], [3, 4]]), 4)
    with pytest.raises(ValueError):
        eng.submit([[1], [2, 3]], 4)  # ragged: numpy's message
    assert not eng.waiting and not eng.req_timing


def test_submit_validation_pool_capacity(params):
    eng = _engine(params, n_blocks=3, block_size=8)  # 2 usable blocks
    with pytest.raises(ValueError, match="blocks"):
        eng.submit(list(range(17)), 8)


def test_validate_request_is_pure(params):
    eng = _engine(params)
    assert eng.validate_request([1, 2, 3], 5) == 5
    assert not eng.waiting and not eng.req_timing


# -- engine-level cancellation ----------------------------------------------


def test_cancel_waiting_request(params, jparams):
    prompts = _prompts(5)
    outs = []
    for eng in (_engine(params), _jengine(jparams)):
        rids = [eng.submit(p, 6) for p in prompts]
        assert eng.cancel(rids[3])  # more requests than rows: rid 3 waits
        out = eng.run()
        assert set(out) == set(rids) - {rids[3]}
        assert eng.alloc.available == POOL - 1
        assert eng.stats["cancelled"] == 1
        assert not eng.cancel(rids[3])  # already gone
        outs.append(out)
    assert outs[0] == outs[1]
    for rid, out in outs[0].items():
        assert out == _reference(tuple(prompts[rid]), 6)


def _cancel_mid_window(eng, prompts, n_new, ticks):
    rids = [eng.submit(p, n_new) for p in prompts]
    for _ in range(ticks):  # rows mid-generation, windows in flight
        if eng.has_work() or eng._inflight:
            eng.pipeline_tick()
    victim = next(r.rid for r in eng.rows if r is not None)
    live = eng.cancel(victim)
    while eng.has_work() or eng._inflight:
        eng.pipeline_tick()
    return rids, victim, live


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_cancel_running_mid_window_survivors_bit_identical(params, jparams, depth):
    """Cancel a running request while windows are in flight: the flush
    before the free keeps every survivor's stream equal to a run that never
    had the victim and to the JAX engine under the same cancel; the
    victim's pages return to the allocator."""
    prompts, n_new = _prompts(5), 10
    eng = _engine(params, pipeline_depth=depth)
    rids, victim, live = _cancel_mid_window(eng, prompts, n_new, 2)
    jeng = _jengine(jparams, pipeline_depth=depth)
    jrids, jvictim, jlive = _cancel_mid_window(jeng, prompts, n_new, 2)
    assert (victim, live) == (jvictim, jlive)
    assert eng.finished == jeng.finished
    assert eng.stats["flushes"] == jeng.stats["flushes"]
    assert eng.alloc.available == POOL - 1
    if live:
        assert victim not in eng.finished and eng.stats["cancelled"] == 1
    survivors = [r for r in rids if r != victim or not live]
    assert set(eng.finished) == set(survivors)
    peer = _offline(_engine(params, pipeline_depth=depth), [prompts[r] for r in survivors], n_new)
    assert [eng.finished[r] for r in survivors] == peer


def test_cancel_running_under_preemption_pressure(params, jparams):
    """Cancellation inside the preemption churn of a pool too small for all
    rows: no survivor changes and no block leaks (the JAX engine's streams
    under the same sequence)."""
    prompts, n_new = _prompts(4, lengths=(12, 14, 10, 13)), 12
    got = []
    for eng in (_engine(params, n_blocks=9), _jengine(jparams, n_blocks=9)):
        rids = [eng.submit(p, n_new) for p in prompts]
        for _ in range(3):
            if eng.has_work() or eng._inflight:
                eng.pipeline_tick()
        victim = [r.rid for r in eng.rows if r is not None][-1]
        live = eng.cancel(victim)
        while eng.has_work() or eng._inflight:
            eng.pipeline_tick()
        assert eng.alloc.available == 9 - 1
        got.append((victim, live, dict(eng.finished), eng.stats["preemptions"]))
    assert got[0] == got[1]
    victim, live, finished, _ = got[0]
    for rid in range(len(prompts)):
        if rid == victim and live:
            assert rid not in finished
        else:
            assert finished[rid] == _reference(tuple(prompts[rid]), n_new)


def test_timing_summary_lifecycle(params):
    eng = _engine(params)
    rids = [eng.submit(p, 5) for p in _prompts(3)]
    eng.run()
    for rid in rids:
        t = eng.timing_summary(rid)
        assert set(t) == {"queue_wait_s", "ttft_s", "e2e_s"}
        assert 0 <= t["queue_wait_s"] <= t["ttft_s"] <= t["e2e_s"]
    assert eng.timing_summary(10_000) == {}


def test_health_gauges_tie_out(params, jparams):
    """``health_gauges`` has the JAX engine's keys and values mid-run, and
    its pool accounting ties out against the allocator."""
    eng, jeng = _engine(params), _jengine(jparams)
    for e in (eng, jeng):
        for p in _prompts(4):
            e.submit(p, 8)
        e.pipeline_tick()
    got, want = eng.health_gauges(), jeng.health_gauges()
    assert got == want
    assert got["pool_free"] + got["pool_cold"] + got["pool_live"] == got["pool_total"] == POOL - 1
    assert got["rows_active"] == 2 and got["waiting"] == 2


# -- EngineLoop: online == offline -----------------------------------------


def _drain(loop, prompts, n_new):
    reqs = [loop.submit(p, n_new) for p in prompts]
    streamed = []
    for req in reqs:
        toks = []
        for ev in req.events(timeout=WAIT):
            if ev[0] == "token":
                toks.append(ev[1])
            else:
                assert ev[1] == "done", ev
        streamed.append(toks)
    return reqs, streamed


def test_engine_loop_stream_identity(params, jparams):
    """Requests submitted through the loop give the offline engine's greedy
    tokens and the JAX ``EngineLoop``'s on the same weights; the stream
    concatenates to the final output."""
    prompts, n_new = _prompts(5), 8
    offline = _offline(_engine(params), prompts, n_new)
    eng = _engine(params)
    with EngineLoop(eng) as loop:
        reqs, streamed = _drain(loop, prompts, n_new)
    with JaxLoop(_jengine(jparams)) as jloop:
        jreqs, _ = _drain(jloop, prompts, n_new)
    for req, toks, off, jreq in zip(reqs, streamed, offline, jreqs):
        assert req.status == "done"
        assert req.tokens == off == jreq.tokens
        assert toks == req.tokens
        assert req.info["n_tokens"] == n_new
        assert 0 <= req.info["queue_wait_s"] <= req.info["ttft_s"] <= req.info["e2e_s"]
        assert set(req.info) == set(jreq.info)
    assert eng.alloc.available == POOL - 1
    assert loop.counters == {**jloop.counters}
    assert loop.counters["completed"] == len(prompts)
    assert loop.counters["tokens_streamed"] == n_new * len(prompts)
    assert not eng.req_timing and not eng.finished


def test_engine_loop_mid_decode_admission(params):
    first, second = _prompts(2)
    eng = _engine(params)
    _throttle(eng, 0.02)
    with EngineLoop(eng) as loop:
        r1 = loop.submit(first, 24)
        for _ in r1.events(timeout=WAIT):
            break  # generation is under way
        r2 = loop.submit(second, 6)
        s2, t2, _ = r2.result(timeout=WAIT)
        s1, t1, _ = r1.result(timeout=WAIT)
    assert (s1, s2) == ("done", "done")
    assert t1 == _reference(tuple(first), 24)
    assert t2 == _reference(tuple(second), 6)


def test_engine_loop_cancel_mid_generation(params):
    eng = _engine(params)
    _throttle(eng)
    bus = EventBus()
    seen = []
    bus.subscribe(lambda rec: seen.append(rec["event"]))
    with EngineLoop(eng, bus=bus) as loop:
        req = loop.submit(_prompts(1)[0], 48)
        assert next(iter(req.events(timeout=WAIT)))[0] == "token"
        loop.cancel(req)
        status, tokens, _ = req.result(timeout=WAIT)
    assert status == "cancelled"
    assert 1 <= len(tokens) < 48
    assert eng.alloc.available == POOL - 1
    assert all(r is None for r in eng.rows)
    assert loop.counters["cancelled"] == 1
    assert "req_submit" in seen and "req_cancelled" in seen


def test_engine_loop_deadline_expiry_frees_blocks(params):
    eng = _engine(params)
    bus = EventBus()
    seen = []
    bus.subscribe(lambda rec: seen.append(rec["event"]))
    with EngineLoop(eng, bus=bus) as loop:
        req = loop.submit(_prompts(1)[0], 48, deadline_s=5.0)
        assert next(iter(req.events(timeout=WAIT)))[0] == "token"
        loop._clock = lambda: time.monotonic() + 100.0  # past the deadline
        status, tokens, _ = req.result(timeout=WAIT)
    assert status == "expired"
    assert 1 <= len(tokens) < 48
    assert eng.alloc.available == POOL - 1
    assert loop.counters["expired"] == 1
    assert "req_expired" in seen


def test_engine_loop_shutdown_fails_inflight(params):
    eng = _engine(params)
    loop = EngineLoop(eng).start()
    req = loop.submit(_prompts(1)[0], 48)
    assert loop.stop(timeout=WAIT)
    status, _, info = req.result(timeout=WAIT)
    assert status == "error" and info.get("reason") == "shutdown"
    assert eng.alloc.available == POOL - 1
    with pytest.raises(RuntimeError):
        loop.submit([1, 2], 4)


def test_engine_loop_submit_failure_releases_ticket(params):
    eng = _engine(params)
    adm = AdmissionController(max_queue_depth=1)

    class _BoomBus:
        def emit(self, *a, **k):
            raise RuntimeError("bus exploded")

    # No capacity sampler: it would emit on the exploding bus from the loop.
    with EngineLoop(eng, admission=adm, bus=_BoomBus(), capacity_ring=0) as loop:
        with pytest.raises(RuntimeError, match="bus exploded"):
            loop.submit([1, 2, 3], 4)
        assert adm.live == 0 and adm.outstanding_tokens == 0
        loop.bus = None
        assert loop.submit([1, 2, 3], 4).result(timeout=WAIT)[0] == "done"


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_engine_loop_engine_failure_terminates_requests(params):
    """An engine exception gives every live request an error terminal,
    releases the tickets and is kept on ``loop.failure``; submits raise."""
    eng = _engine(params)
    adm = AdmissionController(max_queue_depth=8)

    def boom():
        raise RuntimeError("device on fire")

    eng.pipeline_tick = boom
    loop = EngineLoop(eng, admission=adm).start()
    req = loop.submit(_prompts(1)[0], 8)
    status, _, info = req.result(timeout=WAIT)
    assert status == "error"
    assert "engine failure" in info["reason"] and "device on fire" in info["reason"]
    assert adm.live == 0 and adm.outstanding_tokens == 0
    with pytest.raises(RuntimeError):
        loop.submit([1, 2], 4)
    loop.stop(timeout=WAIT)
    assert isinstance(loop.failure, RuntimeError)


# -- admission controller ----------------------------------------------------


def test_admission_depth_limit():
    adm = AdmissionController(max_queue_depth=2, retry_after_s=3.0)
    t1 = adm.try_admit(4, 4, None)
    t2 = adm.try_admit(4, 4, None)
    with pytest.raises(RejectedBusy) as exc:
        adm.try_admit(4, 4, None)
    assert exc.value.retry_after_s == 3.0
    adm.release(t1)
    adm.try_admit(4, 4, None)
    adm.release(t2)
    adm.release(t2)  # idempotent
    assert adm.live == 1 and adm.stats["rejected_busy"] == 1


def test_admission_token_budget():
    adm = AdmissionController(max_queue_depth=100, max_outstanding_tokens=100)
    adm.try_admit(50, 40, None)
    with pytest.raises(RejectedBusy, match="token budget"):
        adm.try_admit(10, 10, None)
    adm.try_admit(5, 5, None)
    assert adm.outstanding_tokens == 100


def test_admission_deadline_shedding():
    adm = AdmissionController(max_queue_depth=100)
    with pytest.raises(RejectedInfeasible):
        adm.try_admit(4, 8, deadline_s=0.0)
    t = adm.try_admit(4, 8, deadline_s=0.001)  # no TPOT estimate yet
    adm.release(t, tpot_s=0.1)
    with pytest.raises(RejectedInfeasible):
        adm.try_admit(4, 100, deadline_s=1.0)
    adm.try_admit(4, 100, deadline_s=60.0)
    assert adm.stats["rejected_infeasible"] == 2
    assert adm.snapshot()["tpot_ewma_s"] == pytest.approx(0.1)


def _admission_trace(mod, rng_seed):
    """One seeded sequence of admits (with cache hints and deadlines) and
    releases (with TPOTs) on ``mod.AdmissionController``: each step's
    outcome and the final snapshot."""
    rng = np.random.default_rng(rng_seed)
    adm = mod.AdmissionController(max_queue_depth=5, max_outstanding_tokens=300, retry_after_s=2.0,
                                  tpot_ewma_alpha=0.3)
    live, trace = [], []
    for _ in range(200):
        if live and rng.random() < 0.45:
            t = live.pop(int(rng.integers(len(live))))
            tpot = float(rng.choice([0.0, 0.01, 0.2]))
            adm.release(t, tpot_s=tpot or None)
            trace.append(("release", t.cost_tokens))
            continue
        n_prompt, max_new = int(rng.integers(1, 60)), int(rng.integers(1, 80))
        deadline = None if rng.random() < 0.5 else float(rng.choice([0.0, 0.5, 5.0, 60.0]))
        try:
            t = adm.try_admit(n_prompt, max_new, deadline, cached_tokens=int(rng.integers(0, 70)))
        except (mod.RejectedBusy, mod.RejectedInfeasible) as e:
            trace.append((type(e).__name__, e.reason))
            continue
        live.append(t)
        trace.append(("admit", t.cost_tokens))
    return trace, adm.snapshot()


def test_admission_makes_the_jax_controllers_decisions():
    from pretraining_llm_tpu_torch.frontend import admission as tadmission

    for seed in range(3):
        assert _admission_trace(tadmission, seed) == _admission_trace(jadmission, seed)


def test_engine_loop_applies_admission(params):
    eng = _engine(params)
    _throttle(eng, 0.02)
    adm = AdmissionController(max_queue_depth=1)
    with EngineLoop(eng, admission=adm) as loop:
        req = loop.submit(_prompts(1)[0], 16)
        with pytest.raises(RejectedBusy):
            loop.submit([1, 2, 3], 4)
        req.result(timeout=WAIT)
        assert loop.submit([1, 2, 3], 4).result(timeout=WAIT)[0] == "done"
    assert adm.live == 0 and adm.outstanding_tokens == 0


# -- HTTP gateway -------------------------------------------------------------


def _post(base, payload, timeout=WAIT, headers=None):
    req = urllib.request.Request(f"{base}/v1/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=WAIT) as r:
        return r.status, r.read().decode()


class _Gateway:
    def __init__(self, params, adm=None, loop_kw=None, **gw_kw):
        self.eng = _engine(params)
        self.loop = EngineLoop(self.eng, admission=adm, **(loop_kw or {}))
        self.gw = ServingGateway(self.loop, port=0, **gw_kw)

    def __enter__(self):
        self.loop.start()
        self.gw.start()
        self.base = f"http://127.0.0.1:{self.gw.port}"
        return self

    def __exit__(self, *exc):
        self.gw.stop()
        self.loop.stop(timeout=WAIT)


def test_gateway_healthz_generate_and_metrics(params):
    ref = _reference((1, 2, 3), 6)
    with _Gateway(params) as g:
        assert json.loads(_get(g.base, "/healthz")[1])["status"] == "ok"
        status, body = _post(g.base, {"prompt": [1, 2, 3], "max_new_tokens": 6})
        assert status == 200 and body["status"] == "done"
        assert body["tokens"] == ref and body["n_tokens"] == 6
        assert body["ttft_s"] <= body["e2e_s"]
        assert json.loads(_get(g.base, "/readyz")[1]) == {
            "ready": True, "running": True, "draining": False, "status": "ready"}
        text = _get(g.base, "/metrics")[1]
        z = json.loads(_get(g.base, "/metricsz")[1])
    assert "# TYPE pllm_serving_completed gauge" in text
    assert "pllm_serving_completed 1" in text.replace(".0", "")
    assert "pllm_serving_http_requests_total" in text and "pllm_serving_engine_tokens" in text
    assert lint_exposition(text) == []
    assert z["gauges"]["completed"] == 1 and z["http"]["http_responses_200"] >= 2


def test_gateway_sse_streaming(params):
    ref = _reference((4, 5, 6), 7)
    with _Gateway(params) as g:
        req = urllib.request.Request(
            f"{g.base}/v1/generate",
            data=json.dumps({"prompt": [4, 5, 6], "max_new_tokens": 7, "stream": True}).encode(),
            headers={"Content-Type": "application/json"},
        )
        toks, final, done_marker = [], None, False
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                if line == "data: [DONE]":
                    done_marker = True
                    continue
                ev = json.loads(line[len("data: "):])
                if ev.get("done"):
                    final = ev
                else:
                    assert ev["index"] == len(toks)
                    toks.append(ev["token"])
        _, full = _post(g.base, {"prompt": [4, 5, 6], "max_new_tokens": 7})
    assert toks == ref == full["tokens"]
    assert done_marker
    assert final["status"] == "done" and final["n_tokens"] == 7


def test_gateway_validation_400s(params):
    with _Gateway(params) as g:
        def expect_400(payload, match):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(g.base, payload)
            assert exc.value.code == 400
            assert match in json.loads(exc.value.read())["error"]

        expect_400({"max_new_tokens": 4}, "missing 'prompt'")
        expect_400({"prompt": [1]}, "missing 'max_new_tokens'")
        expect_400({"prompt": [], "max_new_tokens": 4}, "empty prompt")
        expect_400({"prompt": [1], "max_new_tokens": 0}, ">= 1")
        expect_400({"prompt": [1], "max_new_tokens": 2.5}, "integer")
        expect_400({"prompt": [1], "max_new_tokens": 4, "max_tokens": 4}, "unknown request keys")
        expect_400({"prompt": [CFG.vocab_size], "max_new_tokens": 4}, "token ids must be in")
        expect_400({"prompt": "text", "max_new_tokens": 4}, "tokenizer")
        expect_400({"prompt": [1], "max_new_tokens": 4, "deadline_s": -1}, "deadline_s")
        req = urllib.request.Request(f"{g.base}/v1/generate", data=b"{not json",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=WAIT)
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{g.base}/nope", timeout=WAIT)
        assert exc.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{g.base}/slo", timeout=WAIT)  # no SLO engine wired
        assert exc.value.code == 404


def test_gateway_nested_prompt_400_no_admission_leak(params):
    adm = AdmissionController(max_queue_depth=1)
    with _Gateway(params, adm=adm) as g:
        for _ in range(3):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(g.base, {"prompt": [[1], [2]], "max_new_tokens": 4})
            assert exc.value.code == 400
            assert "flat" in json.loads(exc.value.read())["error"]
        assert adm.live == 0
        status, body = _post(g.base, {"prompt": [1, 2], "max_new_tokens": 4})
        assert status == 200 and body["status"] == "done"


def _raw_http_exchange(port, request_bytes):
    s = socket.create_connection(("127.0.0.1", port), timeout=WAIT)
    try:
        s.sendall(request_bytes)
        s.settimeout(10)
        buf = b""
        while True:
            try:
                chunk = s.recv(4096)
            except socket.timeout:
                return buf, False
            if not chunk:
                return buf, True
            buf += chunk
    finally:
        s.close()


def test_gateway_unread_body_closes_connection(params):
    body = json.dumps({"prompt": [1], "max_new_tokens": 4}).encode()
    with _Gateway(params) as g:
        raw = (b"POST /nope HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
               b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
        head, closed = _raw_http_exchange(g.gw.port, raw)
        assert head.startswith(b"HTTP/1.1 404") and b"connection: close" in head.lower() and closed
        raw = (b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
               b"Content-Length: 999999999\r\n\r\n")
        head, closed = _raw_http_exchange(g.gw.port, raw)
        assert head.startswith(b"HTTP/1.1 400") and b"connection: close" in head.lower() and closed
        assert _post(g.base, {"prompt": [1, 2], "max_new_tokens": 4})[0] == 200


def _wait_for(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def test_gateway_full_response_disconnect_counts_499(params):
    gobj = _Gateway(params)
    _throttle(gobj.eng)
    with gobj as g:
        body = json.dumps({"prompt": [7, 7], "max_new_tokens": 24}).encode()
        s = socket.create_connection(("127.0.0.1", g.gw.port), timeout=WAIT)
        s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
                  b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
        time.sleep(0.2)  # the handler blocks on result()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))  # RST on close
        s.close()
        assert _wait_for(lambda: g.gw.http_counters.get("http_responses_499", 0) >= 1)
        assert g.gw.http_counters.get("http_responses_200", 0) == 0
        assert _post(g.base, {"prompt": [1, 2], "max_new_tokens": 4})[0] == 200
    assert g.eng.alloc.available == POOL - 1


def test_gateway_backpressure_429(params):
    adm = AdmissionController(max_queue_depth=1, retry_after_s=2.0)
    gobj = _Gateway(params, adm=adm)
    _throttle(gobj.eng)
    with gobj as g:
        occupier = g.loop.submit(_prompts(1)[0], 32)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(g.base, {"prompt": [1, 2], "max_new_tokens": 4})
        assert exc.value.code == 429
        assert exc.value.headers["Retry-After"] in ("2", "3")  # base 2 s, jitter up to +25%
        assert "overloaded" in json.loads(exc.value.read())["error"]
        occupier.result(timeout=WAIT)
        status, body = _post(g.base, {"prompt": [1, 2], "max_new_tokens": 4})
        assert status == 200 and body["status"] == "done"


def test_gateway_retry_after_jitter_matches_jax(params):
    from pretraining_llm_tpu.frontend.gateway import ServingGateway as JaxGateway

    got = ServingGateway(EngineLoop(_engine(params)), port=0, retry_jitter_frac=1.0, retry_jitter_seed=5)
    want = JaxGateway(EngineLoop(_engine(params)), port=0, retry_jitter_frac=1.0, retry_jitter_seed=5)
    try:
        assert [got.retry_after_header(3.0) for _ in range(20)] == [
            want.retry_after_header(3.0) for _ in range(20)]
    finally:
        for gw in (got, want):
            gw._server.server_close()


def test_gateway_504_and_503(params):
    """A deadline the TPOT estimate says cannot be met is a 504 at submit;
    a submit into a stopped loop is a 503."""
    adm = AdmissionController(max_queue_depth=8)
    with _Gateway(params, adm=adm) as g:
        assert _post(g.base, {"prompt": [1, 2], "max_new_tokens": 8})[0] == 200  # teaches a TPOT
        assert adm.snapshot()["tpot_ewma_s"] > 0
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(g.base, {"prompt": [1, 2], "max_new_tokens": 60, "deadline_s": 1e-9})
        assert exc.value.code == 504
        assert "deadline cannot be met" in json.loads(exc.value.read())["error"]
        g.loop.stop(timeout=WAIT)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(g.base, {"prompt": [1, 2], "max_new_tokens": 4})
        assert exc.value.code == 503
    assert g.gw.http_counters["http_responses_504"] == 1 and g.gw.http_counters["http_responses_503"] == 1


def test_gateway_client_disconnect_cancels(params):
    gobj = _Gateway(params)
    _throttle(gobj.eng)
    with gobj as g:
        body = json.dumps({"prompt": [9, 9, 9], "max_new_tokens": 48, "stream": True}).encode()
        s = socket.create_connection(("127.0.0.1", g.gw.port), timeout=WAIT)
        s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
                  b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
        buf = b""
        while b"data: " not in buf:  # the first committed token arrived
            chunk = s.recv(4096)
            assert chunk, f"server closed early: {buf!r}"
            buf += chunk
        s.close()
        assert _wait_for(lambda: g.loop.counters["cancelled"] + g.loop.counters["completed"] >= 1
                         and g.eng.alloc.available == POOL - 1)
        assert g.eng.alloc.available == POOL - 1
        assert g.loop.counters["cancelled"] == 1
        dbg = json.loads(_get(g.base, "/debug/engine")[1])
        assert dbg["pool"]["free"] == POOL - 1 and dbg["rows"]["active"] == 0
    assert g.gw.http_counters.get("http_responses_499", 0) == 1


# -- tracing and typed metrics through the serving path ----------------------


def _traced_loop_kw(seed=7):
    recorder = SpanRecorder()
    return recorder, {"tracer": Tracer(recorder, sample=1.0, seed=seed), "registry": MetricsRegistry("pllm_serving_")}


def test_gateway_traceparent_and_typed_metrics(params):
    caller_trace, caller_span = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"
    recorder, loop_kw = _traced_loop_kw()
    with _Gateway(params, loop_kw=loop_kw) as g:
        _, body = _post(g.base, {"prompt": [1, 2, 3], "max_new_tokens": 4},
                        headers={"traceparent": f"00-{caller_trace}-{caller_span}-01"})
        assert body["status"] == "done" and body["trace_id"] == caller_trace
        _, body2 = _post(g.base, {"prompt": [4, 5], "max_new_tokens": 4},
                         headers={"traceparent": f"00-{'c' * 32}-{'d' * 16}-00"})  # unsampled
        assert body2["status"] == "done" and "trace_id" not in body2
        text = _get(g.base, "/metrics")[1]
    assert lint_exposition(text) == []
    assert 'pllm_serving_requests_terminal_total{status="done"} 2.0' in text
    assert "pllm_serving_e2e_seconds_count 2.0" in text
    assert "# TYPE pllm_serving_ttft_seconds histogram" in text
    assert "# TYPE pllm_serving_window_seconds histogram" in text
    assert "# TYPE pllm_serving_http_requests_total counter" in text
    groups = obs_report.group_request_spans(recorder.to_chrome_trace())
    assert set(groups) == {caller_trace}
    assert obs_report.check_trace_tree(caller_trace, groups[caller_trace]) == []
    root = [s for s in groups[caller_trace] if s["name"] == "req.request"]
    assert root[0]["args"]["parent_span_id"] == caller_span


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_trace_trees_complete_for_every_terminal(params, depth):
    """Every terminal (done, cancelled, expired, error at shutdown, and a
    rejection) leaves a complete span tree, at every depth; the done
    request's waterfall sums to its e2e."""
    recorder, loop_kw = _traced_loop_kw(seed=depth)
    eng = _engine(params, pipeline_depth=depth)
    _throttle(eng, 0.02)
    adm = AdmissionController(max_queue_depth=2, shed_infeasible=False)
    with EngineLoop(eng, admission=adm, **loop_kw) as loop:
        r_cancel = loop.submit(_prompts(1)[0], 48)
        r_expire = loop.submit(_prompts(2)[1], 48, deadline_s=5.0)
        with pytest.raises(RejectedBusy):
            loop.submit([1, 2, 3], 4)
        assert next(iter(r_cancel.events(timeout=WAIT)))[0] == "token"
        loop.cancel(r_cancel)
        assert r_cancel.result(timeout=WAIT)[0] == "cancelled"
        loop._clock = lambda: time.monotonic() + 100.0
        assert r_expire.result(timeout=WAIT)[0] == "expired"
        r_done = loop.submit([7, 8, 9], 6)
        assert r_done.result(timeout=WAIT)[0] == "done"
        r_err = loop.submit(_prompts(3)[2], 48)  # left in flight for the stop
        assert next(iter(r_err.events(timeout=WAIT)))[0] == "token"
    assert r_err.result(timeout=WAIT)[0] == "error"
    metrics_text = loop_kw["registry"].render(extra_gauges=loop.metrics())
    groups = ttracing.group_request_spans(recorder.to_chrome_trace())
    assert groups == obs_report.group_request_spans(recorder.to_chrome_trace())
    statuses = {}
    for tid, spans in groups.items():
        assert ttracing.check_trace_tree(tid, spans) == obs_report.check_trace_tree(tid, spans) == [], tid
        root = next(s for s in spans if s["name"] == "req.request")
        statuses[root["args"]["status"]] = tid
    assert set(statuses) == {"done", "cancelled", "expired", "error", "rejected"}
    wf = obs_report.request_waterfall(statuses["done"], groups[statuses["done"]])
    assert wf["e2e_s"] > 0 and wf["n_windows"] >= 1
    assert abs(wf["sum_error_s"]) <= max(1e-6, 0.01 * wf["e2e_s"])
    assert lint_exposition(metrics_text) == []
    for status in ("done", "cancelled", "expired", "error"):
        assert f'pllm_serving_requests_terminal_total{{status="{status}"}} 1.0' in metrics_text
    assert "pllm_serving_e2e_seconds_count 4.0" in metrics_text


def test_healthz_staleness_503(params):
    with pytest.raises(ValueError, match="healthz_stale_after_s"):
        ServingGateway(EngineLoop(_engine(params)), port=0, healthz_stale_after_s=-0.5)
    with _Gateway(params, healthz_stale_after_s=5.0) as g:
        body = json.loads(_get(g.base, "/healthz")[1])
        assert body["status"] == "ok" and body["engine_loop_last_turn_age_s"] < 5.0
        g.loop.last_turn_age_s = lambda: 10.0  # a wedged loop stops turning
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{g.base}/healthz", timeout=WAIT)
        assert exc.value.code == 503 and json.loads(exc.value.read())["status"] == "stale"
    with _Gateway(params) as g:
        g.loop.last_turn_age_s = lambda: 999.0  # 0 disables the check
        assert json.loads(_get(g.base, "/healthz")[1])["status"] == "ok"


READS = ("cpu", "item", "tolist", "numpy", "__int__", "__bool__", "__float__", "nonzero")


def _count_reads(fn):
    """``fn()`` under a mode that counts every tensor read back to the host
    (the calls that wait for the stream on the card)."""
    seen = []

    class Spy(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in READS:
                seen.append(func.__name__)
            return func(*args, **(kwargs or {}))

    with Spy():
        out = fn()
    return out, len(seen)


def test_tracing_and_metrics_add_no_device_syncs(params):
    """Histograms, traces, the capacity sampler and the decision log ride
    the reap's existing reads: an instrumented run reads back exactly as
    many tensors as a plain one."""
    from pretraining_llm_tpu_torch.observability.capacity import CapacitySampler, DecisionLog

    prompts = _prompts(4)

    def run(instrument):
        eng = _engine(params)
        reg = None
        if instrument:
            reg = MetricsRegistry("pllm_serving_")
            eng.window_hist = reg.histogram("window_seconds", "decode window wall seconds")
            eng.host_blocked_hist = reg.histogram("host_blocked_seconds", "host blocked awaiting a window")
            eng.capacity = CapacitySampler(eng.max_batch, eng.alloc.n_blocks - 1, bus=EventBus())
            eng.decisions = DecisionLog(bus=EventBus())
            tracer = Tracer(SpanRecorder(), sample=1.0, seed=0)
        rids = [eng.submit(p, 6) for p in prompts]
        if instrument:
            for rid in rids:
                eng.set_trace(rid, tracer.begin_request())
        out, reads = _count_reads(lambda: eng.run(pipeline=True))
        return out, reads, eng.stats["windows_reaped"], reg

    out_plain, reads_plain, windows_plain, _ = run(False)
    out_inst, reads_inst, windows_inst, reg = run(True)
    assert out_inst == out_plain
    assert windows_inst == windows_plain
    assert reads_inst == reads_plain > 0
    assert reg.histogram("window_seconds", "decode window wall seconds").count == windows_inst


def test_hooks_off_by_default(params):
    eng = _engine(params)
    assert eng.on_token is None and eng.on_finish is None and eng.traces == {}
    assert all(getattr(eng, name) is None for name in (
        "window_hist", "host_blocked_hist", "capacity", "decisions", "preempt_counter", "preempt_tokens_counter",
        "chunk_counter", "chunk_tokens_counter", "chunk_interleaved_counter", "chunk_dedicated_counter",
        "invalid_token_counter", "kv_mismatch_counter"))
    eng.set_trace(0, None)
    assert eng.traces == {} and eng.pop_trace(0) is None


# -- load generator -------------------------------------------------------------


LOAD_SPECS = [
    dict(n_requests=16, mode="open", rate_rps=50.0, seed=7),
    dict(n_requests=5, mode="closed", concurrency=2, seed=3),
    dict(n_requests=12, mode="open", rate_rps=8.0, vocab_size=256, prompt_len_min=17, prompt_len_max=900,
         max_new_min=16, max_new_max=64, seed=0, send_traceparent=True),
    dict(n_requests=8, prefix_pool_size=2, prefix_len=384, seed=1, priority_hi_frac=0.5),
]


@pytest.mark.parametrize("kw", LOAD_SPECS)
def test_build_schedule_equals_jax(kw):
    spec, jspec = LoadSpec(**kw), jloadgen.LoadSpec(**kw)
    got = build_schedule(spec)
    assert got == build_schedule(spec)  # same seed, same workload
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in jloadgen.build_schedule(jspec)]
    if spec.mode == "open":
        arrivals = [sr.arrival_s for sr in got]
        assert arrivals == sorted(arrivals) and arrivals[0] > 0
    else:
        assert all(sr.arrival_s == 0.0 for sr in got)
    from pretraining_llm_tpu_torch.frontend.loadgen import traceparent_for

    assert [traceparent_for(spec, i) for i in range(4)] == [jloadgen.traceparent_for(jspec, i) for i in range(4)]


@pytest.mark.parametrize("kw", [dict(mode="sideways"), dict(mode="open", rate_rps=0.0),
                                dict(prompt_len_min=9, prompt_len_max=4), dict(max_new_min=0),
                                dict(prefix_pool_size=2, prefix_len=0), dict(priority_hi_frac=2.0)])
def test_load_spec_validation(kw):
    with pytest.raises(ValueError) as want:
        jloadgen.LoadSpec(**kw)
    with pytest.raises(ValueError) as got:
        LoadSpec(**kw)
    assert str(got.value) == str(want.value)


def test_load_report_summary_and_goodput():
    outcomes = [(0, "done", 8, 0.1, 0.01, 1.0), (1, "done", 8, 0.9, 0.01, 1.0),
                (2, "done", 8, 0.1, 0.01, 3.0), (3, "rejected_busy", 0, None, None, None)]
    reports = []
    for mod in (jloadgen, sys.modules[LoadReport.__module__]):
        spec = mod.LoadSpec(n_requests=4, slo_ttft_s=0.5, slo_e2e_s=2.0)
        outs = [mod.RequestOutcome(i, s, n, ttft_s=a, tpot_s=b, e2e_s=c) for i, s, n, a, b, c in outcomes]
        reports.append(mod.LoadReport(spec=spec, wall_s=2.0, outcomes=outs).summary())
    s = reports[1]
    assert s == reports[0]
    assert s["counts"] == {"done": 3, "rejected_busy": 1}
    assert s["goodput_rps"] == pytest.approx(0.5) and s["slo_attainment"] == pytest.approx(0.25)
    assert s["ttft"]["p50"] == pytest.approx(0.1) and s["throughput_tok_s"] == pytest.approx(12.0)
    assert RequestOutcome(0, "done").cached_tokens == 0


def test_loadgen_against_engine_loop_and_http(params):
    spec = LoadSpec(n_requests=4, mode="closed", concurrency=2, vocab_size=CFG.vocab_size, prompt_len_min=3,
                    prompt_len_max=8, max_new_min=4, max_new_max=6, seed=11, send_traceparent=True)
    with _Gateway(params, loop_kw={"tracer": Tracer(SpanRecorder(), sample=1.0, seed=1)}) as g:
        report = run_engine_loop(g.loop, spec)
        over_http = run_http(g.base, spec, timeout_s=WAIT)
    for rep in (report, over_http):
        s = rep.summary()
        assert s["counts"] == {"done": 4} and s["slo_attainment"] == 1.0
        assert s["ttft"]["p50"] > 0 and s["e2e"]["p99"] >= s["e2e"]["p50"]
    from pretraining_llm_tpu_torch.frontend.loadgen import traceparent_for

    # The HTTP client's seeded traceparents are the ids the gateway joined.
    assert [o.trace_id for o in over_http.outcomes] == [traceparent_for(spec, i).split("-")[1] for i in range(4)]
    by_index = {sr.index: sr for sr in build_schedule(spec)}
    for o in report.outcomes + over_http.outcomes:  # the streams each client got back
        sr = by_index[o.index]
        assert o.n_tokens == sr.max_new and o.tokens == _reference(tuple(sr.prompt), sr.max_new)


# -- config and the serve CLI ----------------------------------------------------


def test_frontend_config_roundtrip_and_overrides():
    over = {"frontend.port": 0, "frontend.max_queue_depth": 8, "frontend.default_deadline_s": 2.5}
    cfg = tcfg.Config().with_overrides(over)
    want = jcfg.Config().with_overrides(over)
    assert dataclasses.asdict(cfg.frontend) == dataclasses.asdict(want.frontend)
    as_json = lambda c: json.loads(json.dumps(dataclasses.asdict(c)))  # noqa: E731 (a checkpoint's config)
    assert tcfg.Config.from_dict(as_json(cfg)).frontend == cfg.frontend
    assert tcfg.Config.from_dict(json.loads(want.to_json())).frontend == cfg.frontend
    raw = as_json(tcfg.Config())
    del raw["frontend"]  # a config written before the section
    assert tcfg.Config.from_dict(raw).frontend == tcfg.FrontendConfig()
    with pytest.raises(KeyError):
        cfg.with_overrides({"frontend.nope": 1})
    for kw in (dict(max_queue_depth=0), dict(port=70000), dict(trace_sample=2.0), dict(replicas=0),
               dict(retry_after_s=0.0), dict(weight_fingerprint_interval_s=-1.0)):
        with pytest.raises(ValueError) as w:
            jcfg.FrontendConfig(**kw)
        with pytest.raises(ValueError) as g:
            tcfg.FrontendConfig(**kw)
        assert str(g.value) == str(w.value)


def test_serve_http_subprocess_answers_and_drains_on_sigterm(tmp_path):
    """``python -m pretraining_llm_tpu_torch.serve --http --device cpu`` on
    port 0: a generate and an SSE request, then SIGTERM drains, writes the
    trace and the events, and exits 0."""
    from pretraining_llm_tpu_torch.training import checkpoint as ckpt

    model = dataclasses.replace(CFG, vocab_size=260)
    conf = tcfg.Config(model=model, data=tcfg.DataConfig(tokenizer_name="byte"))
    from pretraining_llm_tpu_torch.models import transformer

    ckpt.save_checkpoint(str(tmp_path / "ck"), 0, {"params": transformer.init_params(model, 0, device="cpu")},
                         extra={"step": 0, "config": dataclasses.asdict(conf)})
    events, trace = tmp_path / "events.jsonl", tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pretraining_llm_tpu_torch.serve", "--model_path", str(tmp_path / "ck"), "--http",
         "--port", "0", "--device", "cpu", "--temperature", "0", "--events", str(events), "--trace", str(trace)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = ""
        deadline = time.monotonic() + WAIT
        while "listening on" not in line and time.monotonic() < deadline:
            line = proc.stderr.readline()
            assert line or proc.poll() is None, "the server exited before listening"
        base = line.split("listening on ")[1].split(" ")[0]
        status, body = _post(base, {"prompt": "hello", "max_new_tokens": 5})
        assert status == 200 and body["status"] == "done" and len(body["tokens"]) == 5
        assert isinstance(body["text"], str) and body["trace_id"]
        assert json.loads(_get(base, "/readyz")[1])["ready"] is True
        slo = json.loads(_get(base, "/slo")[1])
        assert slo["latency"]["fleet"]["ttft_s"]["count"] == 1
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=WAIT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
    assert proc.returncode == 0, err
    assert "SIGTERM drain complete" in err and "trace written" in err
    groups = obs_report.group_request_spans(json.loads(trace.read_text()))
    assert len(groups) == 1 and all(obs_report.check_trace_tree(t, s) == [] for t, s in groups.items())
    kinds = [json.loads(ln)["event"] for ln in events.read_text().splitlines()]
    assert kinds.count("req_done") == 1 and "cap_window" in kinds
