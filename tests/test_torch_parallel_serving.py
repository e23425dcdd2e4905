"""The port's ``ServingEngine(mesh=)`` on 4 gloo ranks at (fsdp 2, tensor
2), from ``shard_params_for_inference``'s blocks of the tiny preset at fp32
and 2 layers, against the JAX package (``test_paged.py``'s sharded case):
greedy streams equal to JAX's dense-cache greedy on the monolithic lane,
to JAX's engine on the chunked, prefix-cached, int8-kv lane through the
kernel route (with prefix-cache hits), and under speculative serving (the
model as its own draft), on every rank; the pools hold each rank's
kv_heads/tp heads, and with kv_heads not dividing tp they are replicated,
with the JAX engine's warning word for word."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parallel_jax import tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401

from pretraining_llm_tpu.generation.generate import generate as jgenerate
from pretraining_llm_tpu.generation.serving import ServingEngine as JServingEngine
from pretraining_llm_tpu.models import transformer as jtf

SIZES = (1, 2, 2, 1, 1, 1)


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


def _params(cfg, seed=0):
    return jax.tree.map(np.asarray, jtf.init_params(cfg.model, jax.random.key(seed)))


def _prompts(n, vocab, lengths=(5, 9, 14, 7, 11, 3)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, vocab, size=lengths[i % len(lengths)]).tolist() for i in range(n)]


LANES = {
    "monolithic": ({}, dict(max_batch=2, n_blocks=24, block_size=8, steps_per_sched=4)),
    "chunked-prefix-int8kv": (dict(paged_attention_impl="kernel"),
                              dict(max_batch=2, n_blocks=24, block_size=8, prefill_chunk_tokens=8,
                                   prefix_cache=True, quantize="int8-kv")),
    "replicated-pool": (dict(pos_embed="rope", n_heads=6, n_kv_heads=3, d_model=48, paged_attention_impl="kernel"),
                        dict(max_batch=2, n_blocks=24, block_size=8)),
    "speculative": ({}, dict(max_batch=2, n_blocks=24, block_size=8)),
}


@pytest.mark.parametrize("lane", list(LANES))
def test_serving_engine_on_a_mesh_matches_jax(ranks, lane):
    model, engine_kw = LANES[lane]
    cfg = tiny_config(**model)
    params = _params(cfg)
    prompts = _prompts(4, cfg.model.vocab_size)
    if lane == "chunked-prefix-int8kv":
        prompts[1] = list(prompts[2])  # admitted first: its full block is published
        prompts[3] = prompts[2][:9] + [1, 2, 3]  # and this one's first block hits it
        eng = JServingEngine(jax.tree.map(jnp.asarray, params), cfg.model, temperature=0.0, **engine_kw)
        rids = [eng.submit(p, 8) for p in prompts]
        out = eng.run()
        want = [out[r] for r in rids]
    else:
        want = [np.asarray(jgenerate(jax.tree.map(jnp.asarray, params), cfg.model, jnp.asarray([p], jnp.int32),
                                         8, jax.random.key(7), temperature=0.0))[0].tolist() for p in prompts]
    results = ranks.run("_torch_parallel_cases:serve_on_mesh", cfg_dict=dataclasses.asdict(cfg), params_np=params,
                        prompts=prompts, n_new=8, sizes=SIZES, engine_kw=engine_kw,
                        spec_k=2 if lane == "speculative" else 0)
    g = cfg.model.kv_heads
    for r in results:
        assert r["tokens"] == want
        assert (r["cached_tokens"] > 0) == bool(engine_kw.get("prefix_cache"))
        if g % 2:
            assert r["pool_heads"] == g
            with warnings.catch_warnings(record=True):
                assert (f"serving KV pool: kv_heads={g} not divisible by tensor=2; pool REPLICATED over the "
                        f"tensor axis (2x KV HBM per shard). Choose tp dividing kv_heads.") in r["warnings"]
        else:
            assert r["pool_heads"] == g // 2 and not any("REPLICATED" in w for w in r["warnings"])
