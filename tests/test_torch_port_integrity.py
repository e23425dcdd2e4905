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
``kv_checksum`` is off. The tiny preset at fp32 (2 layers, d 32, V 256),
seeded numpy weights (std 0.3) through ``models/bridge.py``.
"""

import dataclasses
import functools

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
