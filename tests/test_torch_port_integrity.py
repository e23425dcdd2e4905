"""The port's KV page digests and verify-on-acquire against the JAX
package's ``resilience/integrity.py`` and its engine.

Mirrors the KV-checksum cases of ``tests/test_integrity.py``:
``kv_block_digest`` hex-equal to JAX's on the same pool contents (bf16
pools, int8 pools with bf16 and fp32 scale pages, per-layer and stacked
leaves); the prefix cache's checksum bookkeeping and ``drop_block`` in every
refcount state; a published page flipped between two bursts is caught at
acquire, dropped and re-prefilled privately, with every stream equal to the
cache-off run and to the JAX engine's under the same fault, at depths 1-3
and under the synchronous scheduler; and no digest is taken while
``kv_checksum`` is off.

Mirrors the golden-probe and sentinel cases of ``tests/test_integrity.py``
too: the probe prompts and the pinned set equal the JAX package's; the
corruption drills (``corrupt_kv_page``, ``corrupt_weights``,
``wrong_token``) hit only the engine they fire on; a forged token is
redriven to bit-identical streams on both fleets; the probe sentinel
quarantines the replica with the flipped page (the same replica on the
JAX fleet), the fingerprint sentinel the replica with negated weights,
and readiness and the debug view carry the integrity snapshot. The tiny
preset at fp32 (2 layers, d 32, V 256), seeded numpy weights (std 0.3)
through ``models/bridge.py``.
"""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.config import get_preset as jax_preset
from pretraining_llm_tpu.generation.serving import ServingEngine as JaxEngine
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.resilience import integrity as jintegrity
from pretraining_llm_tpu.resilience.faults import ServingFaultInjector
from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.generation import serving as tserving
from pretraining_llm_tpu_torch.generation.paged import BlockAllocator
from pretraining_llm_tpu_torch.generation.prefix_cache import PrefixCache
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.resilience import integrity

JCFG = dataclasses.replace(jax_preset("tiny").model, compute_dtype="float32")
CFG = ModelConfig(**dict(dataclasses.asdict(JCFG), paged_attention_impl="kernel"))
BS = 8
N_BLOCKS = 24


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


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _pool_leaves(kind: str, rng):
    """{name: numpy array} of one layer's pool leaves (n_blocks 6, block 8,
    2 KV heads, Dh 4)."""
    shape = (6, 8, 2, 4)
    if kind == "bf16":
        return {n: rng.normal(size=shape).astype(ml_dtypes.bfloat16) for n in ("k_pool", "v_pool")}
    scale_dtype = ml_dtypes.bfloat16 if kind == "int8-bf16-scales" else np.float32
    out = {n: rng.integers(-127, 128, size=shape).astype(np.int8) for n in ("k_pool", "v_pool")}
    out.update({n: rng.uniform(0.01, 2.0, size=shape[:-1] + (1,)).astype(scale_dtype)
                for n in ("k_scale_pool", "v_scale_pool")})
    return out


@pytest.mark.parametrize("stacked", [False, True], ids=["per-layer", "stacked"])
@pytest.mark.parametrize("kind", ["bf16", "int8-bf16-scales", "int8-fp32-scales"])
def test_kv_block_digest_matches_jax(kind, stacked):
    rng = np.random.default_rng(3)
    layers = [_pool_leaves(kind, rng) for _ in range(2)]
    if stacked:  # (L, n_blocks, ...) leaves: the JAX package's stacked layout
        arrays = {n: np.stack([lyr[n] for lyr in layers]) for n in layers[0]}
        jpools = {n: jnp.asarray(a) for n, a in arrays.items()}
        tpools = {n: _to_torch(a) for n, a in arrays.items()}
    else:
        jpools = {"layers": tuple({n: jnp.asarray(a) for n, a in lyr.items()} for lyr in layers)}
        tpools = {"layers": [{n: _to_torch(a) for n, a in lyr.items()} for lyr in layers]}
    for block in range(6):
        assert integrity.kv_block_digest(tpools, block) == jintegrity.kv_block_digest(jpools, block)
    assert len({integrity.kv_block_digest(tpools, b) for b in range(6)}) == 6


def test_digest_moves_only_the_flipped_page():
    rng = np.random.default_rng(5)
    pools = {"layers": [{n: _to_torch(a) for n, a in _pool_leaves("int8-bf16-scales", rng).items()}]}
    before = [integrity.kv_block_digest(pools, b) for b in range(6)]
    pools["layers"][0]["v_scale_pool"][2, 3, 1, 0] *= 2
    after = [integrity.kv_block_digest(pools, b) for b in range(6)]
    assert [b != a for b, a in zip(before, after)] == [b == 2 for b in range(6)]


def test_drop_block_accounting():
    """drop_block in every refcount state: cold -> freed now; shared ->
    unreachable, freed at its last deref (never cold-listed again);
    idempotent. Eviction forgets a block's checksum."""
    alloc = BlockAllocator(16)
    cache = PrefixCache(alloc, BS)
    hist = list(range(24))
    blocks = alloc.alloc(3)
    published = cache.release_row(hist, blocks, 0, len(hist))
    assert published == blocks == cache.cached_block_ids()
    for b in published:
        cache.set_checksum(b, f"d{b}")
    assert [cache.checksum_of(b) for b in published] == [f"d{b}" for b in published]
    avail0 = alloc.available
    cold = cache.cached_block_ids()[-1]
    cache.drop_block(cold)
    assert alloc.available == avail0 + 1 and cold not in cache.cached_block_ids()
    assert cache.checksum_of(cold) is None
    cached, ids = cache.acquire(hist)
    assert cached == 2 * BS and len(ids) == 2
    victim = ids[1]
    cache.drop_block(victim)
    assert victim not in cache.cached_block_ids()
    avail1 = alloc.available
    cache.drop_block(victim)  # idempotent
    assert alloc.available == avail1
    cache.release_shared(ids)  # the last deref frees only the dropped block
    assert alloc.available == avail1 + 1
    cached2, ids2 = cache.acquire(hist)
    assert victim not in ids2 and cached2 == BS
    cache.release_shared(ids2)
    cache.set_checksum(ids2[0], "x")
    assert cache.evict(1) == 1 and cache.checksum_of(ids2[0]) is None
    cache.set_checksum(999, "ignored")  # not indexed: nothing recorded
    assert cache.checksum_of(999) is None


def _shared_prefix_prompts(n, prefix_blocks=2, tail=(3, 5, 2, 6, 4, 1)):
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, CFG.vocab_size, size=prefix_blocks * BS).tolist()
    return [prefix + rng.integers(0, CFG.vocab_size, size=int(tail[i % len(tail)])).tolist() for i in range(n)]


def _run(eng, prompts, n_new, pipeline, offset=0):
    rids = {eng.submit(p, n_new): offset + i for i, p in enumerate(prompts)}
    out = eng.run(pipeline=pipeline)
    return {rids[r]: t for r, t in out.items() if r in rids}


def _poison_port_page(eng) -> int:
    """Overwrite every pool leaf of the lowest cached block (the JAX fault
    drill's target) with garbage."""
    block = eng.prefix_cache.cached_block_ids()[0]
    for layer in eng.pools["layers"]:
        for leaf in layer.values():
            leaf[block] = (leaf[block].float() * -3.0 + 1.0).to(leaf.dtype)
    return block


@pytest.mark.parametrize("depth", [0, 1, 2, 3], ids=["sync", "depth1", "depth2", "depth3"])
def test_verify_on_acquire_bit_identity(jparams, tparams, depth):
    """Flip a published shared page between two bursts: the checksum
    catches it at acquire, the block is dropped and the request prefills
    privately; every stream equals the cache-off run's and the JAX
    engine's under the same fault, with the same mismatch count."""
    prompts = _shared_prefix_prompts(4)
    n_new, pipeline = 6, bool(depth)
    kw = dict(max_batch=2, n_blocks=N_BLOCKS, block_size=BS, steps_per_sched=4,
              **(dict(pipeline_depth=depth) if depth else {}))
    ref = _run(ServingEngine(tparams, CFG, device="cpu", **kw), prompts * 2, n_new, pipeline)

    eng = ServingEngine(tparams, CFG, device="cpu", prefix_cache=True, kv_checksum=True, **kw)
    out = _run(eng, prompts, n_new, pipeline)
    _poison_port_page(eng)
    out.update(_run(eng, prompts, n_new, pipeline, offset=len(prompts)))
    assert out == ref
    assert eng.stats["kv_mismatches"] >= 1
    cache = eng.prefix_cache
    for b in cache.cached_block_ids():  # no poisoned page is left to hit
        assert integrity.kv_block_digest(eng.pools, b) == cache.checksum_of(b)
    assert eng.alloc.available + eng.prefix_cache.cached_blocks == N_BLOCKS - 1

    jeng = JaxEngine(jparams, JCFG, prefix_cache=True, kv_checksum=True, **kw)
    jout = _run(jeng, prompts, n_new, pipeline)
    assert ServingFaultInjector._fire_corrupt_kv_page(jeng)
    jout.update(_run(jeng, prompts, n_new, pipeline, offset=len(prompts)))
    assert jout == out
    assert jeng.stats["kv_mismatches"] == eng.stats["kv_mismatches"]
    assert jeng.stats["prefill_tokens"] == eng.stats["prefill_tokens"]


def test_kv_digest_never_runs_with_checksum_off(tparams, monkeypatch):
    """kv_checksum defaults off and costs nothing then: the digest (a copy
    of every pool leaf's page to the host) is never taken."""
    calls = [0]
    real = integrity.kv_block_digest

    def counting(pools, block):
        calls[0] += 1
        return real(pools, block)

    monkeypatch.setattr(integrity, "kv_block_digest", counting)
    prompts = _shared_prefix_prompts(3)
    kw = dict(max_batch=2, n_blocks=N_BLOCKS, block_size=BS, steps_per_sched=4, prefix_cache=True)
    _run(ServingEngine(tparams, CFG, device="cpu", **kw), prompts, 6, True)
    assert calls[0] == 0
    eng = ServingEngine(tparams, CFG, device="cpu", kv_checksum=True, **kw)
    _run(eng, prompts, 6, True)
    assert calls[0] > 0  # the knob is what gates it
    assert eng.stats.get("kv_mismatches", 0) == 0


def test_integrity_error_is_the_resilience_module_s():
    assert tserving.IntegrityError is integrity.IntegrityError
    assert issubclass(integrity.IntegrityError, RuntimeError)


# -- golden probes, corruption drills and the fleet sentinel ----------------

from pretraining_llm_tpu.frontend.replica import Replica as JaxReplica  # noqa: E402
from pretraining_llm_tpu.frontend.router import Router as JaxRouter  # noqa: E402
from pretraining_llm_tpu_torch.frontend.replica import Replica  # noqa: E402
from pretraining_llm_tpu_torch.frontend.router import Router  # noqa: E402
from pretraining_llm_tpu_torch.observability.events import EventBus  # noqa: E402
from pretraining_llm_tpu_torch.resilience.faults import ServingFaultInjector as TInjector  # noqa: E402

WAIT = 120


def _prompts(n, lengths=(5, 9, 14, 7, 11, 3, 16, 6)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, CFG.vocab_size, size=int(lengths[i % len(lengths)])).tolist() for i in range(n)]


def _factory(params, **kw):
    kw = {"max_batch": 2, "n_blocks": N_BLOCKS, "block_size": BS, "steps_per_sched": 4, "pipeline_depth": 2, **kw}
    return lambda: ServingEngine(params, CFG, temperature=0.0, device="cpu", **kw)


def _jax_factory(params, **kw):
    kw = {"max_batch": 2, "n_blocks": N_BLOCKS, "block_size": BS, "steps_per_sched": 4, "pipeline_depth": 2, **kw}
    return lambda: JaxEngine(params, JCFG, temperature=0.0, **kw)


def _fleet(factory, faults=None, bus=None, loop_kwargs=None, jax_side=False, **router_kw):
    rep, router = (JaxReplica, JaxRouter) if jax_side else (Replica, Router)
    reps = [rep(i, factory, bus=bus, fault_injector=faults, loop_kwargs=loop_kwargs) for i in range(2)]
    router_kw.setdefault("eject_backoff_s", 0.1)
    return router(reps, bus=bus, **router_kw)


def _undisturbed(params, prompts, n_new, **kw):
    eng = _factory(params, **kw)()
    rids = {eng.submit(p, n_new): i for i, p in enumerate(prompts)}
    return {rids[r]: t for r, t in eng.run().items()}


def _wait(pred, timeout, msg):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def test_probes_refuse_sampling_engine(tparams):
    """Bit-exact probes mean nothing against sampled decode: the router
    refuses at start, before pinning a baseline."""
    def sampling():
        return ServingEngine(tparams, CFG, temperature=0.8, max_batch=2, n_blocks=N_BLOCKS, block_size=BS,
                             device="cpu")

    router = Router([Replica(0, sampling)], probe_interval_s=0.2)
    try:
        with pytest.raises(ValueError, match="temperature"):
            router.start()
    finally:
        router.stop()


def test_probe_prompts_match_jax():
    a = integrity.probe_prompts(4, 9, CFG.vocab_size)
    assert a == jintegrity.probe_prompts(4, 9, CFG.vocab_size) == integrity.probe_prompts(4, 9, CFG.vocab_size)
    assert all(len(p) == 9 and p[:-1] == a[0][:-1] for p in a) and len({tuple(p) for p in a}) == 4
    for args, match in (((0, 9, 256), "n_probes"), ((2, 1, 256), "probe_len")):
        with pytest.raises(ValueError, match=match):
            integrity.probe_prompts(*args)


def test_build_probe_set_matches_jax(jparams, tparams):
    """The pinned set from the port's reference ``generate`` equals the JAX
    package's on the same weights (fp32: greedy argmax ties aside, which
    these draws do not have), and the serving engine agrees with it."""
    probes = integrity.build_probe_set(tparams, CFG, n_probes=2, probe_len=9, max_new=4)
    want = jintegrity.build_probe_set(jparams, JCFG, n_probes=2, probe_len=9, max_new=4)
    assert [(p.prompt, p.expected) for p in probes] == [(p.prompt, p.expected) for p in want]
    assert probes == integrity.build_probe_set(tparams, CFG, n_probes=2, probe_len=9, max_new=4)
    out = _undisturbed(tparams, [list(p.prompt) for p in probes], 4)
    assert [out[i] for i in range(2)] == [list(p.expected) for p in probes]


def test_corrupt_weights_hits_one_engine_only(tparams):
    """Two engines on one parameter tree: ``corrupt_weights`` moves the
    fingerprint of the engine it fires on and nothing else (the shared
    tensors are untouched; the negated leaf is that engine's own copy)."""
    a, b = _factory(tparams)(), _factory(tparams)()
    fp0 = integrity.weight_fingerprint(a.params)
    assert fp0 == integrity.weight_fingerprint(b.params) == integrity.weight_fingerprint(a.params)
    before = [t.clone() for t in integrity._leaves(tparams)]
    assert TInjector._fire_corrupt_weights(a)
    assert integrity.weight_fingerprint(a.params) != fp0
    assert integrity.weight_fingerprint(b.params) == fp0 == integrity.weight_fingerprint(tparams)
    assert all(torch.equal(t, u) for t, u in zip(integrity._leaves(tparams), before))
    changed = [i for i, (t, u) in enumerate(zip(integrity._leaves(a.params), before)) if not torch.equal(t, u)]
    assert len(changed) == 1  # the largest float leaf (the first, in the JAX order, of the largest)
    i = changed[0]
    assert torch.equal(list(integrity._leaves(a.params))[i], -before[i])
    assert before[i].numel() == max(t.numel() for t in before)


def test_kv_block_digest_detects_page_flip(jparams, tparams):
    """``corrupt_kv_page`` poisons the lowest cached block in place, the JAX
    drill's target: only that page's digest moves."""
    prompts = [list(range(16)) + [1, 2, 3]] * 2
    eng, jeng = _factory(tparams, prefix_cache=True)(), _jax_factory(jparams, prefix_cache=True)()
    for e in (eng, jeng):
        for p in prompts:
            e.submit(p, 6)
        e.run()
    cached = eng.prefix_cache.cached_block_ids()
    assert cached and cached == jeng.prefix_cache.cached_block_ids()
    before = {b: integrity.kv_block_digest(eng.pools, b) for b in cached}
    assert TInjector._fire_corrupt_kv_page(eng)
    after = {b: integrity.kv_block_digest(eng.pools, b) for b in cached}
    assert [after[b] != before[b] for b in cached] == [b == cached[0] for b in cached]
    assert not TInjector._fire_corrupt_kv_page(_factory(tparams, prefix_cache=True)())  # nothing cached yet


def test_wrong_token_fails_engine_before_streaming(tparams):
    eng = _factory(tparams, n_blocks=8)()
    streamed = []
    eng.on_token = lambda rid, tok: streamed.append(tok)
    eng.submit(_prompts(1)[0], 6)
    assert TInjector._fire_wrong_token(eng)
    with pytest.raises(integrity.IntegrityError, match="invalid token"):
        eng.run()
    assert eng.stats.get("invalid_tokens", 0) == 1
    assert all(0 <= t < CFG.vocab_size for t in streamed)


def test_wrong_token_redrives_bit_identical(jparams, tparams):
    """The guard turns a forged commit into an engine failure; the router
    redrives and every stream equals the undisturbed one, on the port's
    fleet as on the JAX fleet."""
    prompts = _prompts(6)
    n_new = 8
    ref = _undisturbed(tparams, prompts, n_new)
    events = []
    bus = EventBus()
    bus.subscribe(events.append)
    router = _fleet(_factory(tparams), faults=TInjector("wrong_token@req1:r0", bus=bus), bus=bus)
    with router:
        results = [r.result(timeout=WAIT) for r in [router.submit(p, n_new) for p in prompts]]
    jrouter = _fleet(_jax_factory(jparams), faults=ServingFaultInjector("wrong_token@req1:r0"), jax_side=True)
    with jrouter:
        jresults = [r.result(timeout=WAIT) for r in [jrouter.submit(p, n_new) for p in prompts]]
    assert [(s, t) for s, t, _ in results] == [(s, t) for s, t, _ in jresults] == [
        ("done", ref[i]) for i in range(len(prompts))]
    assert router.counters["redrives"] >= 1 and jrouter.counters["redrives"] >= 1
    kinds = [e.get("event") for e in events]
    assert "integrity_invalid_token" in kinds and "fault_fired" in kinds
    inv = next(e for e in events if e.get("event") == "integrity_invalid_token")
    assert inv["token"] >= CFG.vocab_size


def test_probe_sentinel_quarantines_corrupt_kv_page(jparams, tparams):
    """The probes' shared cached page flipped on replica 0, kv_checksum off:
    the sentinel quarantines replica 0 from probe divergence alone, no
    client request is lost or wrong, and the integrity report (the port's
    obs_report, equal to the JAX script's) attributes the detection. The
    JAX fleet quarantines the same replica for the same reason."""
    from pretraining_llm_tpu_torch import obs_report

    prompts = _prompts(6)
    n_new = 8
    ref = _undisturbed(tparams, prompts, n_new, prefix_cache=True)
    outcome = {}
    for side in ("torch", "jax"):
        events = []
        bus = EventBus()
        bus.subscribe(events.append)
        if side == "torch":
            faults, factory = TInjector("corrupt_kv_page@req1:r0", bus=bus), _factory(tparams, prefix_cache=True)
        else:
            faults, factory = ServingFaultInjector("corrupt_kv_page@req1:r0"), _jax_factory(jparams,
                                                                                            prefix_cache=True)
        router = _fleet(factory, faults=faults, bus=bus if side == "torch" else None, jax_side=side == "jax",
                        probe_interval_s=0.05, probe_timeout_s=60.0)
        with router:
            _wait(lambda: (router.replicas[0].engine is not None
                           and router.replicas[0].engine.prefix_cache.cached_block_ids()), 30.0,
                  "probe prefix block published on r0")
            results = [r.result(timeout=WAIT) for r in [router.submit(p, n_new) for p in prompts]]
            _wait(lambda: router.counters["quarantines"] >= 1, 30.0, "quarantine")
        assert [(s, t) for s, t, _ in results] == [("done", ref[i]) for i in range(len(prompts))]
        assert router.counters["probes"] >= 1 and router.counters["probe_failures"] >= 1
        quars = [d for d in router.decisions.tail() if d["decision"] == "quarantine"]
        outcome[side] = (quars[0]["replica"], "probe divergence" in quars[0]["reason"])
        if side == "torch":
            seen = list(events)  # a probe thread may still emit after stop
            report = obs_report.build_integrity_report(seen)
            jreport = jintegrity_report().build_integrity_report(seen)
            assert report == jreport
            assert report["problems"] == [] and report["quarantines"] >= 1 and report["corruptions_fired"] >= 1
            det = report["detections"]
            assert det and det[0]["fault"] == "corrupt_kv_page" and det[0]["detected"]
            snap = router._integrity_snapshot()
            assert snap["enabled"] and snap["quarantines"] >= 1
    assert outcome["torch"] == outcome["jax"] == (0, True)


def jintegrity_report():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "obs_report_for_port_integrity", Path(__file__).resolve().parent.parent / "scripts" / "obs_report.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_weight_fingerprint_sentinel_quarantines(tparams):
    """In-place weight corruption on replica 0: the loop's fingerprint
    drifts and the sentinel quarantines; after the relaunch (fresh weights
    from the factory: the corruption was that engine's own copy) every
    stream is bit-identical again."""
    prompts = _prompts(4)
    n_new = 6
    ref = _undisturbed(tparams, prompts, n_new)
    events = []
    bus = EventBus()
    bus.subscribe(events.append)
    router = _fleet(_factory(tparams), faults=TInjector("corrupt_weights@req1:r0", bus=bus), bus=bus,
                    loop_kwargs=dict(weight_fingerprint_interval_s=0.05), probe_interval_s=0.2,
                    probe_timeout_s=60.0)
    with router:
        for r in [router.submit(p, n_new) for p in prompts]:
            assert r.result(timeout=WAIT)[0] == "done"  # the exposure window: no identity claim
        _wait(lambda: router.counters["quarantines"] >= 1, 30.0, "quarantine")
        _wait(lambda: all(rep.accepting for rep in router.replicas), 30.0, "relaunch")
        results = [r.result(timeout=WAIT) for r in [router.submit(p, n_new) for p in prompts]]
    assert [(s, t) for s, t, _ in results] == [("done", ref[i]) for i in range(len(prompts))]
    assert any(e.get("event") == "integrity_weight_mismatch"
               or (e.get("event") == "integrity_probe" and not e.get("ok", True)) for e in events)
    assert integrity.weight_fingerprint(router.replicas[1].engine.params) == integrity.weight_fingerprint(tparams)
    from pretraining_llm_tpu_torch import obs_report

    report = obs_report.build_integrity_report(events)
    assert report["quarantines"] >= 1 and report["corruptions_fired"] >= 1
    assert report["detections"] and report["detections"][0]["detected"]


def test_readyz_and_debug_surface_integrity(tparams):
    router = _fleet(_factory(tparams), probe_interval_s=0.05, probe_timeout_s=60.0)
    with router:
        _wait(lambda: all(r["ok"] for r in router._integrity_snapshot()["replicas"].values())
              and len(router._integrity_snapshot()["replicas"]) == 2, 30.0, "a passing probe on every replica")
        ready = router.readiness()
        dbg = router.debug_engine()
    per = ready["integrity"]["replicas"]
    assert set(per) == {"0", "1"} and all(s["ok"] is True and s["age_s"] >= 0.0 for s in per.values())
    assert ready["integrity"]["quarantines"] == 0
    assert dbg["fleet"]["integrity"]["probes_run"] >= 2
    router2 = _fleet(_factory(tparams))
    with router2:
        assert "integrity" not in router2.readiness()
        assert router2.counters["probes"] == 0


def test_no_probe_starts_between_a_divergence_and_its_quarantine():
    """A health tick that lands while a diverged probe's quarantine is
    still pending starts no second probe on that replica: it would run on
    the same wrong weights and could end after the eject, a divergence no
    quarantine answers (``obs_report --strict`` refuses it)."""
    import types

    submits = {0: 0, 1: 0}

    class Loop:
        draining = False
        weight_fingerprint0 = weight_fingerprint = None

        def __init__(self, index, tokens):
            self.index, self.tokens = index, tokens

        def submit(self, prompt, n, priority=0):
            submits[self.index] += 1
            return types.SimpleNamespace(result=lambda timeout=None: ("done", list(self.tokens), {}), trace=None)

    probe = integrity.GoldenProbe((5, 6, 7), (1, 2))
    reps = [types.SimpleNamespace(index=i, loop=Loop(i, toks), state="active", generation=1)
            for i, toks in ((0, (9, 9)), (1, (1, 2)))]
    router = Router(reps, probe_interval_s=0.5, probe_set=[probe])
    quarantined = []

    def quarantine(rep, reason, trace_id):
        router._sentinel_tick(router._next_probe_at + 1.0)  # a health tick inside the window
        quarantined.append((rep.index, reason, submits[0]))
        rep.state = "ejected"

    router._quarantine = quarantine
    router._probe_inflight.add(0)
    router._probe_pump(reps[0], reps[0].loop.submit(probe.prompt, 2), probe, 1)
    assert quarantined == [(0, "probe divergence", 1)] and submits[1] == 1
    _wait(lambda: not router._probe_inflight, 10.0, "every probe's verdict")
    assert router.counters["probe_failures"] == 1


def test_probes_pin_both_prefill_lanes():
    """The router pins each probe through a prefix-cache miss (the cache
    flushed first) and a hit (a second run), unanimous across replicas,
    and keeps the hit's answer as an alternate where the lanes round
    differently; replicas that disagree on either lane leave no baseline."""
    import types

    class Loop:
        def __init__(self, answers):
            self.answers = list(answers)

        def submit(self, prompt, n, priority=0):
            toks = self.answers.pop(0)
            return types.SimpleNamespace(result=lambda timeout=None: ("done", list(toks), {}))

        def run_on_loop(self, fn, timeout=None):
            return fn()

    flushes = []

    def replica(i, answers):
        cache = types.SimpleNamespace(flush=lambda: flushes.append(i) or 0)
        return types.SimpleNamespace(index=i, loop=Loop(answers), engine=types.SimpleNamespace(prefix_cache=cache))

    probe = integrity.GoldenProbe((5, 6, 7), (0, 0))
    router = Router([replica(i, [(1, 2), (1, 3)]) for i in range(2)])
    assert router._pin_serving_baseline([probe]) == [((1, 2), (1, 3))] and flushes == [0, 1]
    same = Router([replica(i, [(4, 4), (4, 4)]) for i in range(2)])
    assert same._pin_serving_baseline([probe]) == [((4, 4),)]
    split = Router([replica(0, [(1, 2), (1, 3)]), replica(1, [(1, 2), (9, 9)])])
    with pytest.raises(RuntimeError, match="disagree"):
        split._pin_serving_baseline([probe])
    pinned = integrity.GoldenProbe(probe.prompt, (1, 2), alternates=((1, 3),))
    assert pinned.alternates == ((1, 3),) and integrity.GoldenProbe((1,), (2,)).alternates == ()
