"""int8 serving in the port against the JAX package: weight quantization,
the int8 KV cache and pools, and the quantized serving engine.

- ``quantize_weight``, ``quantize_params_for_serving`` and the KV
  ``_kv_quantize``/``_kv_dequantize`` give the JAX package's codes and
  scales bit for bit (both round half to even).
- A quantized forward is within 1e-4 of JAX's at fp32 (2 layers, narrow).
- Greedy streams of the port's engine equal the JAX engine's with
  ``quantize="int8"``, ``"int8-kv"`` and ``kv_cache_dtype="int8"``, through
  preemption and a stop token, and within the port the int8-kv streams are
  the same with the prefix cache and chunked prefill on or off (mirroring
  ``test_quantize.py::test_int8_kv_bit_identity_grid``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.config import ModelConfig as JaxModelConfig
from pretraining_llm_tpu.generation.serving import ServingEngine as JaxServingEngine
from pretraining_llm_tpu.models import quantize as jquant
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch.models import bridge, quantize, transformer

BS = 8
TINY = dict(
    vocab_size=64, context_length=64, d_model=32, n_heads=4, n_layers=2,
    activation="gelu", norm="layernorm", pos_embed="learned",
    tie_embeddings=True, qkv_bias=True, mlp_bias=True,
    compute_dtype="float32", attention_impl="flash",
)
GQA = dict(TINY, n_kv_heads=2, activation="swiglu", norm="rmsnorm", pos_embed="rope",
           tie_embeddings=False, qkv_bias=False, mlp_bias=False)


@functools.lru_cache(maxsize=None)
def _weights(kind="tiny"):
    jc = JaxModelConfig(**(TINY if kind == "tiny" else GQA))
    layout = jax.eval_shape(functools.partial(jtf.init_params, jc), jax.random.key(0))
    rng = np.random.default_rng(0)

    def leaf(path, spec):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.3, spec.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, layout)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _grid_weight(case, shape, rng):
    w = rng.normal(size=shape).astype(np.float32)
    if case == "outlier":
        w.reshape(-1, shape[-1])[0] *= 1e4
    elif case == "zero":
        w[..., : shape[-1] // 2] = 0.0
    return w


@pytest.mark.parametrize("case", ["normal", "outlier", "zero"])
@pytest.mark.parametrize("shape,axes", [
    ((16, 24), (0,)), ((3, 10, 2, 4, 6), (1,)), ((2, 4, 6, 12), (1, 2)),
])
def test_quantize_weight_bits_match_jax(case, shape, axes):
    w = _grid_weight(case, shape, np.random.default_rng(len(shape)))
    wq, ws = jquant.quantize_weight(jnp.asarray(w), axes)
    q, s = quantize.quantize_weight(torch.from_numpy(w), axes)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert _bits_equal(wq, q.numpy()) and _bits_equal(ws, s.numpy())
    deq = quantize.dequantize_weight(q, s, torch.float32)
    assert _bits_equal(jquant.dequantize_weight(wq, ws, jnp.float32), deq.numpy())
    # Half a scale step per element, at most.
    assert (np.abs(deq.numpy() - w) <= s.numpy() / 2 + 1e-6 * np.abs(w)).all()


def test_kv_quantize_bits_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero (token, head): the eps floor
    x[1, 0, 0, :4] = [127.0, 2.5, 3.5, -2.5]  # ties round half to even
    x[1, 0, 0, 4:] = 0.0
    jq, js = jtf._kv_quantize(jnp.asarray(x))
    q, s = transformer._kv_quantize(torch.from_numpy(x))
    assert _bits_equal(jq, q.numpy()) and _bits_equal(js, s.numpy())
    assert q[1, 0, 0, :4].tolist() == [127, 2, 4, -2]
    for scale_dtype in (jnp.float32, jnp.bfloat16):
        js_t = js.astype(scale_dtype)
        s_t = torch.from_numpy(np.array(js_t.astype(jnp.float32))).to(
            torch.bfloat16 if scale_dtype == jnp.bfloat16 else torch.float32)
        want = jtf._kv_dequantize(jq, js_t, jnp.float32)
        assert _bits_equal(want, transformer._kv_dequantize(q, s_t, torch.float32).numpy())


@pytest.mark.parametrize("kind", ["tiny", "gqa"])
def test_quantize_params_and_bridge_match_jax(kind):
    """The quantized tree: same leaves, names, dtypes and bits; the bridge
    carries a JAX-quantized tree across and back, and the serving cast keeps
    the scales fp32."""
    cfg = ModelConfig(**(TINY if kind == "tiny" else GQA))
    tree = _weights(kind)
    want = jax.tree.map(np.asarray, jquant.quantize_params_for_serving(
        jax.tree.map(jnp.asarray, tree), JaxModelConfig(**(TINY if kind == "tiny" else GQA))))
    got = quantize.quantize_params_for_serving(bridge.params_from_numpy(tree, cfg, device="cpu"), cfg)
    assert quantize.is_quantized(got) and not quantize.is_quantized(bridge.params_from_numpy(tree, cfg, device="cpu"))
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), got))[0])
    assert set(map(str, flat_w)) == set(map(str, flat_g))
    for (path, w), (_, g) in zip(sorted(flat_w.items(), key=str), sorted(flat_g.items(), key=str)):
        assert _bits_equal(w, g), path
    carried = bridge.params_from_numpy(want, cfg, device="cpu")
    back = bridge.params_to_numpy(carried)
    assert all(_bits_equal(a, b) for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(back)))
    cast = bridge.cast_params_for_inference(carried, dataclasses.replace(cfg, compute_dtype="bfloat16"))
    assert cast["blocks"]["attn"]["wo"].dtype == torch.int8
    assert cast["blocks"]["attn"]["wo_scale"].dtype == torch.float32
    assert quantize.param_bytes(got) < quantize.param_bytes(bridge.params_from_numpy(tree, cfg, device="cpu"))
    bad = jax.tree.map(lambda a: a, want)
    bad["blocks"]["mlp"]["w2_scale"] = np.ones((2, 1, 1), np.float32)
    with pytest.raises(ValueError, match="w2_scale"):
        bridge.params_from_numpy(bad, cfg, device="cpu")


def test_quantize_rejects_moe():
    cfg = ModelConfig(**TINY)
    params = bridge.params_from_numpy(_weights(), cfg, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        quantize.quantize_params_for_serving(params, dataclasses.replace(cfg, n_experts=4))


@pytest.mark.parametrize("kind", ["tiny", "gqa"])
def test_quantized_forward_matches_jax(kind):
    base = TINY if kind == "tiny" else GQA
    jq = jquant.quantize_params_for_serving(jax.tree.map(jnp.asarray, _weights(kind)), JaxModelConfig(**base))
    cfg = ModelConfig(**base)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jq), cfg, device="cpu")
    tok = np.random.default_rng(0).integers(0, 64, size=(2, 12))
    want, _ = jtf.forward(jq, jnp.asarray(tok, jnp.int32), JaxModelConfig(**base))
    got, _ = transformer.forward(params, torch.from_numpy(tok), cfg)
    assert float(np.abs(np.asarray(want) - got.numpy()).max()) <= 1e-4


def test_int8_pool_layout_capacity_and_validation():
    cfg = ModelConfig(**dict(TINY, d_model=256))
    assert cfg.head_dim == 64
    q8 = dataclasses.replace(cfg, kv_cache_dtype="int8")

    def nbytes(pools):
        return sum(x.numel() * x.element_size() for lyr in pools["layers"] for x in lyr.values())

    bf16 = transformer.make_paged_kv_pool(cfg, 4, BS, dtype=torch.bfloat16, device="cpu")
    kv = transformer.make_paged_kv_pool(q8, 4, BS, scale_dtype="bfloat16", device="cpu")
    assert kv["layers"][0]["k_pool"].dtype == torch.int8
    assert kv["layers"][0]["v_scale_pool"].shape == (4, BS, cfg.kv_heads, 1)
    assert nbytes(bf16) / nbytes(kv) >= 1.9
    f32s = transformer.make_paged_kv_pool(q8, 4, BS, device="cpu")
    assert f32s["layers"][0]["k_scale_pool"].dtype == torch.float32
    assert nbytes(bf16) / nbytes(f32s) < 1.9
    with pytest.raises(ValueError, match="conflicts"):
        transformer.make_paged_kv_pool(q8, 4, BS, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="scale_dtype"):
        transformer.make_paged_kv_pool(cfg, 4, BS, scale_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="scale_dtype"):
        transformer.make_paged_kv_pool(q8, 4, BS, scale_dtype=torch.float16, device="cpu")
    dense = transformer.make_kv_cache(q8, 2, 16, device="cpu")
    assert sorted(dense) == ["k", "k_scale", "v", "v_scale"]
    assert dense["k"].dtype == torch.int8 and dense["k_scale"].shape == (cfg.n_layers, 2, 16, cfg.kv_heads, 1)


def _port(kw, impl="kernel", params=None):
    cfg = ModelConfig(**dict(TINY, paged_attention_impl=impl, kv_cache_dtype=kw.pop("kv_cache_dtype", "compute")))
    if params is None:
        params = bridge.params_from_numpy(_weights(), cfg, device="cpu")
    return ServingEngine(params, cfg, device="cpu", **kw)


def _jax_engine(kw):
    kw = dict(kw)
    cfg = JaxModelConfig(**dict(TINY, kv_cache_dtype=kw.pop("kv_cache_dtype", "compute")))
    return JaxServingEngine(jax.tree.map(jnp.asarray, _weights()), cfg, pipeline_depth=1, **kw)


def _requests():
    rng = np.random.default_rng(2)
    return [(rng.integers(0, 64, size=int(rng.integers(3, 30))).tolist(), int(rng.integers(4, 20)))
            for _ in range(7)]


def _serve(eng, requests):
    rids = [eng.submit(p, n) for p, n in requests]
    out = eng.run(pipeline=False)  # the synchronous scheduler of either engine
    return [out[r] for r in rids]


@pytest.mark.parametrize("stop", [False, True], ids=["preempt", "stop"])
@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("mode", [
    dict(quantize="int8"), dict(quantize="int8-kv"), dict(kv_cache_dtype="int8"),
    dict(quantize="int8-kv", prefix_cache=True, prefill_chunk_tokens=6),
], ids=["int8", "int8-kv", "kv_cache_dtype-int8", "int8-kv-cache-chunked"])
def test_engine_greedy_streams_match_jax(mode, impl, stop):
    """More requests than rows and a pool small enough to preempt (or a stop
    token): the port's quantized engine emits the JAX engine's tokens."""
    # The JAX engine's streams with the prefix cache and chunks on move
    # under preemption (see test_cache_and_chunks_keep_streams_under_preemption):
    # that mode is compared on a pool that does not preempt.
    cached = bool(mode.get("prefix_cache"))
    kw = dict(max_batch=3, n_blocks=24 if cached else 9, block_size=BS, steps_per_sched=4, **mode)
    requests = _requests()
    if stop:
        kw["stop_token"] = _serve(_port(dict(kw), impl), requests)[1][2]
    jeng, teng = _jax_engine(kw), _port(dict(kw), impl)
    got = _serve(teng, requests)
    assert got == _serve(jeng, requests)
    if stop:
        assert any(len(out) < n for out, (_, n) in zip(got, requests))
    elif not cached:
        assert teng.stats["preemptions"] > 0
    for key in ("steps", "tokens", "admissions", "prefill_tokens", "preemptions"):
        assert teng.stats[key] == jeng.stats[key], key


def test_cache_and_chunks_keep_streams_under_preemption():
    """With the prefix cache and chunked prefill on and a pool that
    preempts, the port's int8-kv streams equal its cache-off, monolithic
    streams and the JAX engine's int8-kv streams in that plain mode. (The
    JAX engine's own streams move in this mode, and differ across its
    pipeline depths: ROADMAP Queue C.)"""
    requests = _requests()
    kw = dict(max_batch=3, n_blocks=9, block_size=BS, steps_per_sched=4, quantize="int8-kv")
    eng = _port(dict(kw, prefix_cache=True, prefill_chunk_tokens=6))
    got = _serve(eng, requests)
    assert eng.stats["preemptions"] > 0 and eng.stats["prefix_cache_hits"] > 0
    assert got == _serve(_port(dict(kw)), requests) == _serve(_jax_engine(kw), requests)


def test_int8_kv_identity_grid_and_pool_info():
    """Within the int8-kv graph, streams do not depend on the prefix cache
    or chunked prefill, and pre-quantized params give the same streams."""
    requests = _requests()[:4]
    kw = dict(max_batch=2, n_blocks=24, block_size=BS, steps_per_sched=4, quantize="int8-kv")
    base = _serve(_port(dict(kw)), requests)
    for pfx in (False, True):
        for chunk in (0, BS):
            assert _serve(_port(dict(kw, prefix_cache=pfx, prefill_chunk_tokens=chunk)), requests) == base
    cfg = ModelConfig(**dict(TINY, paged_attention_impl="kernel"))
    pre = quantize.quantize_params_for_serving(bridge.params_from_numpy(_weights(), cfg, device="cpu"), cfg)
    eng = _port(dict(kw), params=pre)
    assert _serve(eng, requests) == base
    info = eng.pool_info()
    assert (info["quantize"], info["kv_dtype"], info["kv_scale_dtype"]) == ("int8-kv", "int8", "bfloat16")
    assert info["pool_bytes"] == info["bytes_per_block"] * 24
    exact = _port(dict(max_batch=2, n_blocks=24, block_size=BS)).pool_info()
    assert exact["quantize"] == "none" and exact["kv_scale_dtype"] is None
    assert exact["bytes_per_block"] > info["bytes_per_block"]
    with pytest.raises(ValueError, match="quantize"):
        _port(dict(quantize="fp8"))
