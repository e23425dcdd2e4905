"""The port's pipelined serving scheduler against its synchronous one and
the JAX engine's pipelined scheduler.

Mirrors ``tests/test_serving_pipeline.py``. The bar: greedy tokens are
identical to the port's ``run(pipeline=False)`` and to the JAX engine's
``run(pipeline=True)`` at the same depth, at every depth 1-3, through
admission churn, a stop token, preemption and replay, and ``max_new=1``;
the scheduler's counters (windows dispatched and reaped, flushes, steps,
preemptions) equal the JAX engine's. The tiny preset at fp32 (2 layers, d
32, V 256) with seeded numpy weights (std 0.3, so that greedy streams
vary) passed to both packages through ``models/bridge.py``; the port runs
the kernels' plain versions (``paged_attention_impl="kernel"``), JAX the
gather path.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.config import get_preset as jax_preset
from pretraining_llm_tpu.generation.serving import ServingEngine as JaxEngine
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.generation import serving as tserving
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch.models import bridge

JCFG = dataclasses.replace(jax_preset("tiny").model, compute_dtype="float32")
CFG = ModelConfig(**dict(dataclasses.asdict(JCFG), paged_attention_impl="kernel"))
DEPTHS = [1, 2, 3]
COUNTERS = ("windows", "windows_reaped", "flushes", "steps", "tokens", "preemptions", "admissions")


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
def tparams():
    return bridge.params_from_numpy(_weights(), CFG, device="cpu")


def _prompts(n, lengths=(5, 9, 14, 7, 11, 3, 16, 6)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, CFG.vocab_size, size=int(lengths[i % len(lengths)])).tolist() for i in range(n)]


def _serve(eng, prompts, n_new, pipeline):
    rids = [eng.submit(p, n_new) for p in prompts]
    out = eng.run(pipeline=pipeline)
    return [out[r] for r in rids]


def _trio(jparams, tparams, prompts, n_new, depth, **kw):
    """The port's sync and pipelined runs and the JAX pipelined run of one
    workload: (sync, piped, jax streams, port piped engine, JAX engine)."""
    sync = _serve(ServingEngine(tparams, CFG, device="cpu", **kw), prompts, n_new, False)
    teng = ServingEngine(tparams, CFG, device="cpu", pipeline_depth=depth, **kw)
    piped = _serve(teng, prompts, n_new, True)
    jeng = JaxEngine(jparams, JCFG, pipeline_depth=depth, **kw)
    want = _serve(jeng, prompts, n_new, True)
    return sync, piped, want, teng, jeng


def _same_counters(teng, jeng):
    for key in COUNTERS:
        assert teng.stats[key] == jeng.stats[key], key


@pytest.mark.parametrize("depth", DEPTHS)
def test_depth_identity_admission_churn(jparams, tparams, depth):
    """More requests than rows: rows free and re-admit while windows carry
    surplus tokens for finished rows and admission merges land mid-queue."""
    sync, piped, want, teng, jeng = _trio(
        jparams, tparams, _prompts(6), 9, depth, max_batch=2, n_blocks=24, block_size=8, steps_per_sched=4,
    )
    assert piped == sync == want
    assert teng.stats["windows_reaped"] == teng.stats["windows"] > 0
    _same_counters(teng, jeng)


@pytest.mark.parametrize("depth", DEPTHS)
def test_depth_identity_early_finish_stop_token(jparams, tparams, depth):
    """A stop token landing mid-window finishes rows early while deeper
    queues keep dispatching surplus windows for them: the surplus is
    dropped at reap."""
    prompts = _prompts(3)
    kw = dict(max_batch=2, n_blocks=32, block_size=8, steps_per_sched=4)
    plain = _serve(ServingEngine(tparams, CFG, device="cpu", **kw), prompts, 12, False)
    stop = plain[0][4]
    sync, piped, want, teng, jeng = _trio(jparams, tparams, prompts, 12, depth, stop_token=stop, **kw)
    assert piped == sync == want
    assert len(piped[0]) == plain[0].index(stop)
    _same_counters(teng, jeng)


@pytest.mark.parametrize("depth", DEPTHS)
def test_depth_identity_preemption_replay(jparams, tparams, depth):
    """A pool too small for both rows: the queue flushes before the
    eviction, and the victim resumes from its exact prefix."""
    prompts = [_prompts(1, lengths=(12,))[0], _prompts(1, lengths=(10,))[0]]
    sync, piped, want, teng, jeng = _trio(
        jparams, tparams, prompts, 24, depth, max_batch=2, n_blocks=8, block_size=8, steps_per_sched=4,
    )
    assert piped == sync == want
    assert teng.stats["preemptions"] >= 1 and teng.stats["flushes"] >= 1
    _same_counters(teng, jeng)


@pytest.mark.parametrize("depth", [2, 3])
def test_depth_identity_max_new_one(jparams, tparams, depth):
    """max_new=1 finishes on the deferred admission token alone: the row
    frees without joining a decode window."""
    sync, piped, want, teng, jeng = _trio(
        jparams, tparams, _prompts(3), 1, depth, max_batch=1, n_blocks=16, block_size=8, steps_per_sched=4,
    )
    assert piped == sync == want and all(len(s) == 1 for s in piped)
    _same_counters(teng, jeng)


def test_admit_batch_defers_then_batches(jparams, tparams):
    """admit_batch=3 with rows running: admissions wait until three can
    share one prefill; no token moves."""
    kw = dict(max_batch=4, n_blocks=48, block_size=8, steps_per_sched=4, admit_batch=3)
    sync, piped, want, teng, jeng = _trio(jparams, tparams, _prompts(6), 8, 2, **kw)
    assert piped == sync == want
    for key in ("admit_batches", "admit_deferrals"):
        assert teng.stats.get(key, 0) == jeng.stats.get(key, 0), key
    assert teng.stats.get("admit_deferrals", 0) >= 1
    assert teng.stats.get("admit_batches", 0) + teng.stats.get("admit_deferrals", 0) >= 1


def test_admit_batch_idle_engine_never_deadlocks(tparams):
    """An idle engine admits whatever fits even below admit_batch."""
    prompts = _prompts(2)
    kw = dict(max_batch=4, n_blocks=32, block_size=8)
    eng = ServingEngine(tparams, CFG, device="cpu", pipeline_depth=2, admit_batch=8, **kw)
    got = _serve(eng, prompts, 6, True)
    assert got == _serve(ServingEngine(tparams, CFG, device="cpu", **kw), prompts, 6, False)
    assert "admit_batches" not in eng.stats  # no row ran, so the gate never engaged


def test_host_blocked_counter_monotonic(tparams, monkeypatch):
    """windows_reaped grows by one per reap and host_blocked_s never
    decreases."""
    seen = []
    orig = ServingEngine._reap_window

    def spy(self, w):
        orig(self, w)
        seen.append((self.stats["windows_reaped"], self.stats["host_blocked_s"]))

    monkeypatch.setattr(ServingEngine, "_reap_window", spy)
    eng = ServingEngine(tparams, CFG, device="cpu", max_batch=2, n_blocks=32, block_size=8, steps_per_sched=4)
    _serve(eng, _prompts(4), 8, True)
    assert len(seen) >= 2
    assert [n for n, _ in seen] == list(range(1, len(seen) + 1))
    blocked = [b for _, b in seen]
    assert all(b2 >= b1 >= 0.0 for b1, b2 in zip(blocked, blocked[1:]))
    assert eng.stats["host_blocked_s"] == blocked[-1]


@pytest.mark.parametrize("pipeline", [False, True])
def test_unfused_lane_equals_fused(tparams, pipeline):
    """fused_sampling=False brings every step's (B, V) fp32 logits to the
    host and samples them in a second call: the same greedy tokens, and
    ``logits_bytes_host`` counts the transfer (0 on the fused lane)."""
    kw = dict(max_batch=2, n_blocks=24, block_size=8, steps_per_sched=4)
    fused_eng = ServingEngine(tparams, CFG, device="cpu", **kw)
    fused = _serve(fused_eng, _prompts(4), 9, pipeline)
    eng = ServingEngine(tparams, CFG, device="cpu", fused_sampling=False, **kw)
    assert _serve(eng, _prompts(4), 9, pipeline) == fused
    assert fused_eng.stats["logits_bytes_host"] == 0
    assert eng.stats["logits_bytes_host"] == eng.stats["steps"] * 2 * CFG.vocab_size * 4


def test_dispatch_reads_nothing_back(tparams, monkeypatch):
    """No dispatch brings a tensor to the host (the calls that would wait
    for the stream on the card): on the CPU the spy sees every tensor
    method the dispatch and the model it runs call."""
    reads = ("cpu", "item", "tolist", "numpy", "__int__", "__bool__", "__float__", "nonzero")
    seen = []

    class Spy(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in reads:
                seen.append(name)
            return func(*args, **(kwargs or {}))

    for method in ("_dispatch_window", "_dispatch_spec_round"):
        orig = getattr(ServingEngine, method)

        def spied(self, *a, _orig=orig):
            with Spy():
                return _orig(self, *a)

        monkeypatch.setattr(ServingEngine, method, spied)
    kw = dict(max_batch=2, n_blocks=32, block_size=8, steps_per_sched=4, temperature=0.7, top_k=20)
    _serve(ServingEngine(tparams, CFG, device="cpu", **kw), _prompts(4), 8, True)
    spec = dict(max_batch=2, n_blocks=32, block_size=8, draft_params=tparams, draft_cfg=CFG, spec_k=2)
    _serve(ServingEngine(tparams, CFG, device="cpu", **spec), _prompts(3), 8, True)
    assert seen == []


def test_pipeline_knob_validation(tparams):
    with pytest.raises(ValueError, match="pipeline_depth"):
        ServingEngine(tparams, CFG, device="cpu", pipeline_depth=0)
    with pytest.raises(ValueError, match="admit_batch"):
        ServingEngine(tparams, CFG, device="cpu", admit_batch=-1)
    eng = ServingEngine(tparams, CFG, device="cpu")
    assert (eng.pipeline_depth, eng.admit_batch, eng.fused_sampling) == (2, 0, True)


def test_readback_waits_only_for_its_own_copy():
    """The reap's readback holds the tensors (CPU) or pinned copies and an
    event (CUDA); on the CPU it hands back the values as they are."""
    x, y = torch.arange(6, dtype=torch.int32).reshape(2, 3), torch.tensor([1, 2], dtype=torch.int32)
    rb = tserving._Readback(x, y)
    assert rb.event is None
    a, b = rb.wait()
    assert a.tolist() == x.tolist() and b.tolist() == [1, 2]
