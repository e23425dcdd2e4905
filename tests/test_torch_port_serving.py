"""The PyTorch port's serving engine, allocator and sampling against the JAX
package's.

Greedy token streams must be identical between the two engines on the same
weights (fp32). Sampled streams are compared by support and frequency only:
the port draws from a ``torch.Generator``, JAX from its own PRNG.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretraining_llm_tpu.config import ModelConfig as JaxModelConfig
from pretraining_llm_tpu.generation import sampling as jsampling
from pretraining_llm_tpu.generation.serving import ServingEngine as JaxServingEngine
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.generation import paged, sampling
from pretraining_llm_tpu_torch.generation.serving import IntegrityError, ServingEngine
from pretraining_llm_tpu_torch.models import bridge

TINY = dict(
    vocab_size=64, context_length=64, d_model=32, n_heads=4, n_layers=2,
    activation="gelu", norm="layernorm", pos_embed="learned",
    tie_embeddings=True, qkv_bias=True, mlp_bias=True,
    compute_dtype="float32", attention_impl="flash",
)


@functools.lru_cache(maxsize=None)
def _weights():
    """Seeded numpy weights in the JAX ``init_params`` layout, scaled up so
    that greedy streams vary from token to token."""
    jc = JaxModelConfig(**TINY)
    layout = jax.eval_shape(functools.partial(jtf.init_params, jc), jax.random.key(0))
    rng = np.random.default_rng(0)

    def leaf(path, spec):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.3, spec.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, layout)


def _requests():
    rng = np.random.default_rng(2)
    return [
        (rng.integers(0, 64, size=int(rng.integers(3, 30))).tolist(), int(rng.integers(4, 20)))
        for _ in range(7)
    ]


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("sps", [1, 4])
def test_engine_greedy_streams_match_jax(sps, impl):
    """More requests than rows, ragged prompts, a stop token and a pool
    small enough to force preemption: both engines emit the same tokens."""
    tree = _weights()
    kw = dict(max_batch=3, n_blocks=9, block_size=8, steps_per_sched=sps, stop_token=7)
    jeng = JaxServingEngine(
        jax.tree.map(jnp.asarray, tree), JaxModelConfig(**TINY), pipeline_depth=1, **kw
    )
    cfg = ModelConfig(**dict(TINY, paged_attention_impl=impl))
    teng = ServingEngine(bridge.params_from_numpy(tree, cfg, device="cpu"), cfg, device="cpu", **kw)
    for prompt, max_new in _requests():
        assert jeng.submit(prompt, max_new) == teng.submit(prompt, max_new)
    want = jeng.run(pipeline=False)
    got = teng.run()
    assert got == want
    assert teng.stats["preemptions"] == jeng.stats["preemptions"] > 0
    assert any(len(out) < max_new for out, (_, max_new) in zip(got.values(), _requests()))
    for key in ("steps", "tokens", "admissions", "prefill_tokens"):
        assert teng.stats[key] == jeng.stats[key], key
    assert set(teng.timing_summary(0)) == {"queue_wait_s", "ttft_s", "e2e_s"}


def test_engine_validates_requests():
    tree = _weights()
    cfg = ModelConfig(**TINY)
    eng = ServingEngine(bridge.params_from_numpy(tree, cfg, device="cpu"), cfg,
                        max_batch=2, n_blocks=4, block_size=8, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], 4)
    with pytest.raises(ValueError, match=r"\[0, 64\)"):
        eng.submit([1, 64], 4)
    with pytest.raises(ValueError, match="integer"):
        eng.submit([1, 2], 2.5)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit([1] * 60, 10)
    with pytest.raises(ValueError, match="pool only has 3"):
        eng.submit([1] * 20, 10)


def test_engine_records_prefill_shapes():
    """Each admission prefills its rows padded to its longest prompt's
    whole pages; the engine records (rows, padded length) per admission."""
    cfg = ModelConfig(**TINY)
    eng = ServingEngine(bridge.params_from_numpy(_weights(), cfg, device="cpu"), cfg,
                        max_batch=2, n_blocks=16, block_size=8, device="cpu")
    for n in (3, 17, 9):
        eng.submit([1] * n, 2)
    eng.run()
    assert eng.prefill_shapes == [(2, 24), (1, 16)]


def test_engine_fails_loudly_on_corrupt_state():
    """NaN weights make the sampler return -1; the engine refuses to emit
    it, already for the first token sampled at admission."""
    cfg = ModelConfig(**TINY)
    params = bridge.params_from_numpy(_weights(), cfg, device="cpu")
    params = dict(params, final_norm={"scale": torch.full((32,), float("nan")),
                                      "bias": params["final_norm"]["bias"]})
    eng = ServingEngine(params, cfg, n_blocks=4, block_size=8, temperature=1.0, device="cpu")
    eng.submit([1, 2, 3], 4)
    with pytest.raises(IntegrityError, match="invalid token id -1"):
        eng.run()
    assert eng.stats["invalid_tokens"] == 1


def test_paged_decode_step_is_one_step_of_the_window():
    """prefill_into_pool_batched then paged_decode_step gives the same tokens
    as a two-step window, and the window's second step continues the first."""
    cfg = ModelConfig(**TINY)
    params = bridge.params_from_numpy(_weights(), cfg, device="cpu")
    from pretraining_llm_tpu_torch.models import transformer

    prompts = [[1, 2, 3, 4, 5], list(range(10, 30))]
    tables = torch.tensor([[1, 0, 0], [2, 3, 4]], dtype=torch.int32)
    rows = [[1], [2, 3, 4]]

    def fresh():
        pools = transformer.make_paged_kv_pool(cfg, 6, 8, device="cpu")
        first, pools = paged.prefill_into_pool_batched(params, cfg, pools, prompts, rows)
        return first, pools

    seq = torch.tensor([5, 20], dtype=torch.int32)
    first, pools = fresh()
    one, pools = paged.paged_decode_step(params, pools, first, tables, seq, None, cfg)
    two, _ = paged.paged_decode_step(params, pools, one, tables, seq + 1, None, cfg)
    first, pools = fresh()
    window, lp, _ = paged.paged_decode_steps(params, pools, first, tables, seq, None, cfg, 2,
                                             logprobs_k=3)
    assert window.tolist() == torch.stack([one, two], 1).tolist()
    assert lp[0].shape == (2, 2, 3) and lp[1].dtype == torch.int32


def test_block_allocator_semantics():
    alloc = paged.BlockAllocator(5)
    assert alloc.available == 4
    a = alloc.alloc(3)
    assert a == [1, 2, 3] and 0 not in a  # block 0 is reserved
    assert alloc.alloc(2) is None  # all or nothing
    assert alloc.available == 1
    alloc.free([2])
    assert alloc.alloc(1) == [2]  # LIFO reuse
    with pytest.raises(ValueError, match="double free"):
        alloc.free([4])
    alloc.free([1])
    with pytest.raises(ValueError, match="double free"):
        alloc.free([1])
    with pytest.raises(ValueError):
        paged.BlockAllocator(1)
    assert paged.required_blocks(17, 8) == 3
    with pytest.raises(ValueError, match="capacity"):
        paged.check_paged_bounds(np.zeros((2, 2), np.int32), np.array([3, 16]), 8)


def test_greedy_and_logprobs_match_jax():
    logits = np.random.default_rng(2).normal(size=(4, 50)).astype(np.float32)
    want_tok, (want_v, want_i) = jsampling.sample_logits_fused(
        jnp.asarray(logits), jax.random.key(0), temperature=0.0, logprobs_k=5
    )
    tok, (vals, ids) = sampling.sample_logits_fused(torch.from_numpy(logits), None,
                                                    temperature=0.0, logprobs_k=5)
    assert tok.dtype == torch.int32 and ids.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want_tok), tok.numpy())
    np.testing.assert_array_equal(np.asarray(want_i), ids.numpy())
    np.testing.assert_allclose(np.asarray(want_v), vals.numpy(), atol=1e-5)
    assert sampling.sample_logits_fused(torch.from_numpy(logits), None, temperature=0.0)[1] is None


def test_sampling_flags_nan_and_inf_rows():
    logits = torch.zeros(3, 10)
    logits[1, 3] = float("nan")
    logits[2, 5] = float("inf")
    tok = sampling.sample_logits(logits, torch.Generator().manual_seed(0), temperature=1.0)
    assert tok[0] >= 0 and tok[1] == -1 and tok[2] == -1


@pytest.mark.parametrize(
    "kw", [dict(top_k=3), dict(top_p=0.6), dict(min_p=0.3), dict(top_k=4, top_p=0.8)]
)
def test_filtered_sampling_support_and_frequency_match_jax(kw):
    """Both frameworks sample only inside the same filtered support, with
    frequencies that agree to sampling noise (4,000 draws each)."""
    logits = np.log(np.array([[0.3, 0.25, 0.15, 0.12, 0.08, 0.05, 0.03, 0.02]], np.float32))
    n = 4000
    rows = np.repeat(logits, n, axis=0)
    want = np.asarray(jsampling.sample_logits(
        jnp.asarray(rows), jax.random.key(0), temperature=1.0, **kw
    ))
    got = sampling.sample_logits(
        torch.from_numpy(rows), torch.Generator().manual_seed(0), temperature=1.0, **kw
    ).numpy()
    assert set(np.unique(got)) == set(np.unique(want))
    f_want = np.bincount(want, minlength=8) / n
    f_got = np.bincount(got, minlength=8) / n
    assert np.abs(f_want - f_got).max() < 0.04  # ~5 sigma at p=0.5, n=4000
    assert sampling.sample_logits(torch.from_numpy(logits), None, temperature=1.0, top_k=100).shape == (1,)
