"""The PyTorch port's model against the JAX package's, on the same weights.

The JAX package initialises the parameters; seeded numpy noise is added to
every leaf (so biases and norm parameters are not trivially 0 or 1); the
same numpy tree goes to both frameworks. Tolerances: fp32 logits within
1e-4 max-abs (accumulation order only); bf16 within 3e-2 (the two
frameworks round matmul outputs and GELU at different points).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretraining_llm_tpu.config import ModelConfig as JaxModelConfig
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.models import transformer as ttf

GPT2 = dict(
    vocab_size=97, context_length=64, d_model=32, n_heads=4, n_layers=2,
    activation="gelu", norm="layernorm", pos_embed="learned",
    tie_embeddings=True, qkv_bias=True, mlp_bias=True,
    compute_dtype="float32", attention_impl="flash",
)
LLAMA_GQA = dict(
    vocab_size=97, context_length=64, d_model=32, n_heads=4, n_kv_heads=2,
    n_layers=2, activation="swiglu", norm="rmsnorm", pos_embed="rope",
    tie_embeddings=False, qkv_bias=False, mlp_bias=False,
    compute_dtype="float32", attention_impl="flash",
)
FLAVOURS = {"gpt2": GPT2, "llama_gqa": LLAMA_GQA}
FP32_TOL = 1e-4
BF16_TOL = 3e-2
# One compiled program per shape instead of op-by-op dispatch.
_jax_forward = jax.jit(jtf.forward, static_argnames=("cfg", "cache_index"))


def _both(kw, seed=0):
    return _both_cached(tuple(sorted(kw.items())), seed)


@functools.lru_cache(maxsize=None)
def _both_cached(items, seed):
    """(jax cfg, jax params, port cfg, port params, numpy tree): seeded
    numpy values laid out as the JAX ``init_params`` tree (norm scales
    near 1, everything else N(0, 0.05)). Callers must not mutate them."""
    kw = dict(items)
    jc, tc = JaxModelConfig(**kw), ModelConfig(**kw)
    layout = jax.eval_shape(functools.partial(jtf.init_params, jc), jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.05, spec.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, layout)
    return jc, jax.tree.map(jnp.asarray, tree), tc, bridge.params_from_numpy(tree, tc, device="cpu"), tree


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def test_params_from_numpy_round_trips_the_jax_init_tree():
    jc = JaxModelConfig(**LLAMA_GQA)
    tc = ModelConfig(**LLAMA_GQA)
    tree = jax.tree.map(np.asarray, jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.key(0)))
    back = bridge.params_to_numpy(bridge.params_from_numpy(tree, tc, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert tc.num_params() == jc.num_params() == sum(x.size for _, x in flat_a)


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_params_from_numpy_refuses_a_wrong_leaf(flavour):
    _, _, tc, _, tree = _both(FLAVOURS[flavour])
    assert tc.num_params() == JaxModelConfig(**FLAVOURS[flavour]).num_params()
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["mlp"]["w2"] = bad["blocks"]["mlp"]["w2"][:, :-1]
    with pytest.raises(ValueError, match="blocks.mlp.w2"):
        bridge.params_from_numpy(bad, tc, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["attn"]["extra"] = bad["blocks"]["mlp"]["w2"]
    with pytest.raises(ValueError, match="blocks.attn"):
        bridge.params_from_numpy(bad, tc, device="cpu")


def test_port_init_params_matches_jax_tree_layout():
    kw = FLAVOURS["llama_gqa"]
    jc, _, tc, _, tree = _both(kw)
    port = bridge.params_to_numpy(ttf.init_params(tc, torch.Generator().manual_seed(3), device="cpu"))
    assert jax.tree.map(np.shape, port) == jax.tree.map(np.shape, tree)
    assert np.all(port["final_norm"]["scale"] == 1.0)


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_forward_no_cache_matches_jax(flavour):
    jc, jp, tc, tp, _ = _both(FLAVOURS[flavour])
    toks = np.random.default_rng(1).integers(0, 97, (2, 24))
    want, _ = _jax_forward(jp, jnp.asarray(toks), cfg=jc)
    got, cache = ttf.forward(tp, torch.from_numpy(toks), tc)
    assert cache is None and got.dtype == torch.float32
    assert _max_err(want, got) <= FP32_TOL


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_forward_prefill_at_index_zero_matches_jax(flavour):
    jc, jp, tc, tp, _ = _both(FLAVOURS[flavour])
    toks = np.random.default_rng(2).integers(0, 97, (3, 20))
    jcache = jtf.make_kv_cache(dataclasses.replace(jc, decode_cache_layout="stacked"), 3, 32)
    want, jcache = _jax_forward(jp, jnp.asarray(toks), cfg=jc, kv_cache=jcache, cache_index=0)
    tcache = ttf.make_kv_cache(tc, 3, 32, device="cpu")
    got, tcache = ttf.forward(tp, torch.from_numpy(toks), tc, kv_cache=tcache, cache_index=0)
    assert _max_err(want, got) <= FP32_TOL
    for name in ("k", "v"):
        assert _max_err(jcache[name], tcache[name]) <= FP32_TOL


def _fragmented_tables(rng, b, n_blocks, max_blocks, bs, t):
    perm = rng.permutation(np.arange(1, n_blocks)).tolist()
    tables = np.zeros((b, max_blocks), np.int32)
    seq = np.zeros((b,), np.int32)
    for i in range(b):
        n_pages = int(rng.integers(1, max_blocks + 1))
        tables[i, :n_pages] = [perm.pop() for _ in range(n_pages)]
        seq[i] = int(rng.integers(0, n_pages * bs - t + 1)) if i else 0  # row 0: seq 0
    return tables, seq


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_paged_decode_steps_match_jax(flavour, impl):
    """Three paged decode steps over random pool contents and fragmented
    tables: the JAX gather lane is the oracle for both port lanes."""
    kw = dict(FLAVOURS[flavour], sliding_window=0)
    jc, jp, tc, tp, _ = _both(kw)
    tc = dataclasses.replace(tc, paged_attention_impl=impl)
    rng = np.random.default_rng(4)
    b, n_blocks, bs, max_blocks, steps = 3, 12, 8, 3, 3
    tables, seq = _fragmented_tables(rng, b, n_blocks, max_blocks, bs, steps)
    jpools = jtf.make_paged_kv_pool(jc, n_blocks, bs)
    tpools = ttf.make_paged_kv_pool(tc, n_blocks, bs, device="cpu")
    for layer in range(jc.n_layers):
        for name in ("k_pool", "v_pool"):
            vals = rng.normal(size=tpools["layers"][layer][name].shape).astype(np.float32)
            tpools["layers"][layer][name].copy_(torch.from_numpy(vals))
    jpools = {"layers": tuple(
        {name: jnp.asarray(tpools["layers"][i][name].numpy()) for name in ("k_pool", "v_pool")}
        for i in range(jc.n_layers)
    )}
    toks = rng.integers(0, 97, (b,))
    for step in range(steps):
        s = seq + step
        want, jpools = _jax_forward(
            jp, jnp.asarray(toks)[:, None], cfg=jc, kv_cache=jpools,
            paged=jtf.PagedInfo(jnp.asarray(tables), jnp.asarray(s)),
        )
        got, tpools = ttf.forward(
            tp, torch.from_numpy(toks)[:, None], tc, kv_cache=tpools,
            paged=ttf.PagedInfo(torch.from_numpy(tables), torch.from_numpy(s)),
        )
        assert _max_err(want, got) <= FP32_TOL, f"step {step}"
        toks = np.array(want[:, 0].argmax(-1))
    for layer in range(jc.n_layers):
        for name in ("k_pool", "v_pool"):
            assert _max_err(jpools["layers"][layer][name], tpools["layers"][layer][name]) <= FP32_TOL


def test_paged_overshoot_writes_go_to_scratch_block():
    """A write at or past table capacity lands in block 0, never on the
    row's last page."""
    tc = ModelConfig(**GPT2)
    tp = ttf.init_params(tc, 0, device="cpu")
    pools = ttf.make_paged_kv_pool(tc, 6, 8, device="cpu")
    tables = torch.tensor([[3, 4]], dtype=torch.int32)
    before = [p["k_pool"].clone() for p in pools["layers"]]
    ttf.forward(tp, torch.tensor([[5, 6]]), tc, kv_cache=pools,
                paged=ttf.PagedInfo(tables, torch.tensor([15], dtype=torch.int32)))
    for layer, pool in enumerate(pools["layers"]):
        changed = (pool["k_pool"] != before[layer]).flatten(1).any(1)
        # Slot 15 (block 4, slot 7) is in range; slot 16 overshoots to block 0.
        assert changed.tolist() == [True, False, False, False, True, False]


def test_bf16_forward_within_stated_bound():
    kw = dict(GPT2, compute_dtype="bfloat16")
    jc, jp, tc, tp, _ = _both(kw)
    tp = bridge.cast_params_for_inference(tp, tc)
    assert tp["blocks"]["attn"]["wqkv"].dtype == torch.bfloat16
    assert tp["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert tp["final_norm"]["bias"].dtype == torch.float32
    toks = np.random.default_rng(5).integers(0, 97, (2, 24))
    want, _ = _jax_forward(jp, jnp.asarray(toks), cfg=jc)
    got, _ = ttf.forward(tp, torch.from_numpy(toks), tc)
    assert _max_err(want, got) <= BF16_TOL
