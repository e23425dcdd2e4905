"""The port's speculative decoding against the JAX package's.

Mirrors ``tests/test_speculative.py`` and the speculative cases of
``tests/test_serving_pipeline.py``: ``paged.paged_spec_round`` against
JAX's on the same pools and tables (emit and n_emit equal, every pool leaf
within 1e-5), the serving engine's spec rounds (synchronous and pipelined
at depths 2 and 3, exact and int8-kv pools) equal to target-only serving
and to the JAX spec engine, a self-draft accepting every proposal, the
dense ``generate_speculative`` equal to JAX's and to ``generate``, and the
accept/reject rule's output distribution equal to the target's (a
chi-square test over 20,000 seeded draws at V = 16). The tiny preset at
fp32 (2 layers, d 32, V 256), seeded numpy weights (std 0.3) through
``models/bridge.py``, with two drafts: a 1-layer d 16 model of its own
weights (which seldom agrees with the target) and the target's first layer
with its embeddings, final norm and head (which often does).
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
from pretraining_llm_tpu.generation import paged as jpaged
from pretraining_llm_tpu.generation.serving import ServingEngine as JaxEngine
from pretraining_llm_tpu.generation.speculative import generate_speculative as jax_generate_speculative
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.generation import paged, speculative
from pretraining_llm_tpu_torch.generation.generate import generate
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch.models import bridge, quantize

JCFG = dataclasses.replace(jax_preset("tiny").model, compute_dtype="float32")
JDRAFT = dataclasses.replace(JCFG, n_layers=1, d_model=16, n_heads=2)
JSHALLOW = dataclasses.replace(JCFG, n_layers=1)
CFG = ModelConfig(**dict(dataclasses.asdict(JCFG), paged_attention_impl="kernel"))
DRAFT = ModelConfig(**dict(dataclasses.asdict(JDRAFT), paged_attention_impl="kernel"))
SHALLOW = ModelConfig(**dict(dataclasses.asdict(JSHALLOW), paged_attention_impl="kernel"))
POOL_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _weights(which: str):
    if which == "shallow":  # the target's first block (blocks are stacked on axis 0)
        tree = dict(_weights("target"))
        tree["blocks"] = jax.tree.map(lambda x: x[:1], tree["blocks"])
        return tree
    jc, seed = (JCFG, 0) if which == "target" else (JDRAFT, 9)
    layout = jax.eval_shape(functools.partial(jtf.init_params, jc), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.3, spec.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, layout)


@pytest.fixture(scope="module")
def models():
    """{name: (JAX params, port params)} for the target and both drafts."""
    return {
        name: (jax.tree.map(jnp.asarray, _weights(name)),
               bridge.params_from_numpy(_weights(name), cfg, device="cpu"))
        for name, cfg in (("target", CFG), ("draft", DRAFT), ("shallow", SHALLOW))
    }


def _prompts(n, lengths=(5, 9, 14, 7, 11, 3, 16, 6)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, CFG.vocab_size, size=int(lengths[i % len(lengths)])).tolist() for i in range(n)]


def _serve(eng, prompts, n_new, pipeline):
    rids = [eng.submit(p, n_new) for p in prompts]
    out = eng.run(pipeline=pipeline)
    return [out[r] for r in rids]


def _pool_arrays(cfg, n_blocks, bs, seed):
    rng = np.random.default_rng(seed)
    shape = (n_blocks, bs, cfg.kv_heads, cfg.head_dim)
    return [{name: rng.normal(size=shape).astype(np.float32) for name in ("k_pool", "v_pool")}
            for _ in range(cfg.n_layers)]


def test_paged_spec_round_matches_jax(models):
    """One greedy round over random pools and fragmented tables: the same
    emissions, counts and pool contents as JAX's ``paged_spec_round``."""
    (jt, tt), (jd, td) = models["target"], models["draft"]
    n_blocks, bs, k = 12, 8, 3
    t_np, d_np = _pool_arrays(JCFG, n_blocks, bs, 1), _pool_arrays(JDRAFT, n_blocks, bs, 2)
    tables = np.array([[3, 7, 1, 0], [2, 5, 9, 11], [4, 6, 0, 0]], np.int32)
    seq = np.array([9, 20, 15], np.int32)
    tokens = np.array([17, 200, 3], np.int32)

    def jax_pools(arrs):
        return {"layers": tuple({n: jnp.asarray(a) for n, a in layer.items()} for layer in arrs)}

    def port_pools(arrs):
        return {"layers": [{n: torch.from_numpy(a.copy()) for n, a in layer.items()} for layer in arrs]}

    j_emit, j_n, j_t, j_d = jpaged.paged_spec_round(
        jt, jax_pools(t_np), jax_pools(d_np), jd, jnp.asarray(tokens), jnp.asarray(tables),
        jnp.asarray(seq), jax.random.key(0), cfg_t=JCFG, cfg_d=JDRAFT, k=k, temperature=0.0,
    )
    emit, n_emit, t_pools, d_pools = paged.paged_spec_round(
        tt, port_pools(t_np), port_pools(d_np), td, torch.from_numpy(tokens), torch.from_numpy(tables),
        torch.from_numpy(seq), None, CFG, DRAFT, k, 0.0,
    )
    np.testing.assert_array_equal(emit.numpy(), np.asarray(j_emit))
    np.testing.assert_array_equal(n_emit.numpy(), np.asarray(j_n))
    assert emit.shape == (3, k + 1) and (n_emit >= 1).all() and (n_emit <= k + 1).all()
    for j_pools, t in ((j_t, t_pools), (j_d, d_pools)):
        for jl, tl in zip(j_pools["layers"], t["layers"]):
            for name in ("k_pool", "v_pool"):
                np.testing.assert_allclose(tl[name].numpy(), np.asarray(jl[name]), atol=POOL_TOL, rtol=0)


def test_spec_next_inputs_chains_the_last_emission():
    emit = torch.tensor([[5, 6, 7], [8, 0, 0]], dtype=torch.int32)
    n_emit = torch.tensor([3, 1], dtype=torch.int32)
    nxt, seq = speculative.spec_next_inputs(emit, n_emit, torch.tensor([10, 4], dtype=torch.int32))
    assert nxt.tolist() == [7, 8] and seq.tolist() == [13, 5]


@pytest.mark.parametrize("depth", [0, 2, 3], ids=["sync", "depth2", "depth3"])
def test_spec_serving_matches_target_only_and_jax(models, depth):
    """Spec rounds (k 3, the shallow draft: some proposals accepted, some
    not) through the synchronous scheduler or the in-flight queue:
    target-only serving's tokens and the JAX spec engine's, with the same
    counts."""
    (jt, tt), (jd, td) = models["target"], models["shallow"]
    prompts = _prompts(4)
    kw = dict(max_batch=2, n_blocks=32, block_size=8)
    depth_kw = dict(pipeline_depth=depth) if depth else {}
    want = _serve(ServingEngine(tt, CFG, device="cpu", **kw), prompts, 10, False)
    teng = ServingEngine(tt, CFG, device="cpu", draft_params=td, draft_cfg=SHALLOW, spec_k=3, **kw, **depth_kw)
    got = _serve(teng, prompts, 10, bool(depth))
    jeng = JaxEngine(jt, JCFG, draft_params=jd, draft_cfg=JSHALLOW, spec_k=3, **kw, **depth_kw)
    assert got == want == _serve(jeng, prompts, 10, bool(depth))
    for key in ("spec_rounds", "spec_proposed", "spec_accepted", "windows", "flushes"):
        assert teng.stats.get(key, 0) == jeng.stats.get(key, 0), key
    assert 0 < teng.stats["spec_accepted"] < teng.stats["spec_proposed"]


def test_spec_pipelined_self_draft_accepts_everything(models):
    """Draft = target at depth 2: every proposal is accepted, and surplus
    rounds of finished rows are not counted."""
    tt = models["target"][1]
    p = _prompts(1)[0]
    eng = ServingEngine(tt, CFG, device="cpu", max_batch=1, n_blocks=32, block_size=8,
                        draft_params=tt, draft_cfg=CFG, spec_k=2, pipeline_depth=2)
    got = _serve(eng, [p], 9, True)
    assert got == _serve(ServingEngine(tt, CFG, device="cpu", max_batch=1, n_blocks=32, block_size=8),
                         [p], 9, False)
    assert eng.stats["spec_accepted"] == eng.stats["spec_proposed"] > 0


def test_spec_int8_kv_matches_target_only_and_jax(models):
    """int8-kv spec serving: both pools int8 with bf16 scale pages, every
    attention through the ragged lane (the verify at q_lens = k + 1); the
    draft tree is quantized with the target's."""
    (jt, tt), (jd, td) = models["target"], models["draft"]
    prompts = _prompts(3)
    kw = dict(max_batch=2, n_blocks=32, block_size=8, quantize="int8-kv")
    want = _serve(ServingEngine(tt, CFG, device="cpu", **kw), prompts, 8, False)
    teng = ServingEngine(tt, CFG, device="cpu", draft_params=td, draft_cfg=DRAFT, spec_k=2, **kw)
    got = _serve(teng, prompts, 8, True)
    jeng = JaxEngine(jt, JCFG, draft_params=jd, draft_cfg=JDRAFT, spec_k=2, **kw)
    assert got == want == _serve(jeng, prompts, 8, True)
    assert teng.d_pools["layers"][0]["k_pool"].dtype == torch.int8
    assert teng.d_pools["layers"][0]["k_scale_pool"].dtype == torch.bfloat16
    assert quantize.is_quantized(teng.draft_params)


def test_spec_engine_validation(models):
    tt, td = models["target"][1], models["draft"][1]
    base = dict(device="cpu", n_blocks=8, block_size=8)
    with pytest.raises(ValueError, match="spec_k must be"):
        ServingEngine(tt, CFG, spec_k=-1, **base)
    with pytest.raises(ValueError, match="all three"):
        ServingEngine(tt, CFG, spec_k=2, **base)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(tt, CFG, draft_params=td, draft_cfg=dataclasses.replace(DRAFT, vocab_size=255),
                      spec_k=2, **base)
    with pytest.raises(ValueError, match="temperature-only"):
        ServingEngine(tt, CFG, draft_params=td, draft_cfg=DRAFT, spec_k=2, top_k=5, **base)
    with pytest.raises(ValueError, match="fused decode path"):
        ServingEngine(tt, CFG, draft_params=td, draft_cfg=DRAFT, spec_k=2, fused_sampling=False, **base)


@pytest.mark.parametrize("k", [1, 3])
def test_generate_speculative_greedy_matches_jax(models, k):
    """Batch-1 dense-cache speculative decoding: JAX's tokens and the
    target's own greedy ``generate``."""
    (jt, tt), (jd, td) = models["target"], models["draft"]
    prompt = np.random.default_rng(1).integers(0, CFG.vocab_size, (1, 8))
    want, jstats = jax_generate_speculative(jt, JCFG, jd, JDRAFT, jnp.asarray(prompt, jnp.int32), 12,
                                            jax.random.key(3), k=k, temperature=0.0)
    got, stats = speculative.generate_speculative(tt, CFG, td, DRAFT, prompt, 12, 0, k=k, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == generate(tt, CFG, prompt, 12, 0, temperature=0.0)[0].tolist()
    assert stats == jstats


def test_generate_speculative_self_draft_and_guards(models):
    tt, td = models["target"][1], models["draft"][1]
    prompt = np.random.default_rng(4).integers(0, CFG.vocab_size, (1, 6))
    got, stats = speculative.generate_speculative(tt, CFG, tt, CFG, prompt, 12, 0, k=3)
    assert got.tolist() == generate(tt, CFG, prompt, 12, 0, temperature=0.0)[0].tolist()
    assert stats["accepted"] == stats["proposed"] and stats["rounds"] == -(-(12 - 1) // 4)
    sampled, sstats = speculative.generate_speculative(tt, CFG, td, DRAFT, prompt, 10, 0, k=4, temperature=1.0)
    assert sampled.shape == (10,) and ((sampled >= 0) & (sampled < CFG.vocab_size)).all()
    assert sstats["proposed"] == sstats["rounds"] * 4
    zero = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match="vocab"):
        speculative.generate_speculative(tt, CFG, td, dataclasses.replace(DRAFT, vocab_size=257), zero, 4)
    with pytest.raises(ValueError, match="batch-1"):
        speculative.generate_speculative(tt, CFG, td, DRAFT, np.zeros((2, 4), np.int64), 4)
    with pytest.raises(ValueError, match="context"):
        speculative.generate_speculative(tt, CFG, td, DRAFT, zero, CFG.context_length)
    with pytest.raises(ValueError, match="k must be"):
        speculative.generate_speculative(tt, CFG, td, DRAFT, zero, 4, k=0)


def test_accept_reject_keeps_the_target_distribution():
    """Draft proposals drawn from q, accepted with min(1, p/q), a rejection
    resampled from norm(max(p - q, 0)): the first emitted token follows p.
    Chi-square over 20,000 seeded rows at V = 16 (15 degrees of freedom,
    37.70 is the 0.1% critical value); the same statistic against q fails."""
    v, n = 16, 20_000
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(v))
    q = rng.dirichlet(np.ones(v))
    gen = torch.Generator().manual_seed(0)
    drafts = torch.multinomial(torch.from_numpy(q).float(), n, replacement=True, generator=gen)
    p_dists = torch.from_numpy(p).float().expand(n, 2, v)
    q_dists = torch.from_numpy(q).float().expand(n, 1, v)
    emit, n_emit = speculative.accept_reject(p_dists, q_dists, drafts[:, None].to(torch.int32), gen, 1.0)
    counts = np.bincount(emit[:, 0].numpy(), minlength=v)

    def chi2(dist):
        expected = n * dist
        return float(((counts - expected) ** 2 / expected).sum())

    assert chi2(p) < 37.70, chi2(p)
    assert chi2(q) > 37.70
    assert ((n_emit == 1) | (n_emit == 2)).all()
    accepted = (n_emit == 2).float().mean().item()
    assert abs(accepted - np.minimum(p, q).sum()) < 0.02  # P(accept) = sum min(p, q)
