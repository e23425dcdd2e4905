"""The port's ``forward(return_hidden=True)`` and ``Config``'s ``replace``,
``to_json`` and ``from_json`` against the JAX package's.

``return_hidden`` runs both forwards at fp32 on the same bridged weights
(2 layers, narrow widths): the block outputs and the final-norm hidden
states within 1e-5, and the logits unchanged by the option (as JAX's own
``tests/test_model.py::test_return_hidden_activations`` holds them). A
pipe mesh refuses the option with JAX's message. The JSON form is JAX's
byte for byte for every preset, and each package reads the other's.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jconfig
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.parallel.sharding import activation_mesh as jax_activation_mesh
from pretraining_llm_tpu_torch import config as tconfig
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.models import transformer as ttf
from pretraining_llm_tpu_torch.parallel.sharding import activation_mesh

HIDDEN_TOL = 1e-5  # fp32, accumulation order only
FLAVOURS = {
    "tiny": dict(dataclasses.asdict(jconfig.get_preset("tiny").model), compute_dtype="float32"),
    "llama_gqa": dict(
        vocab_size=97, context_length=32, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
        activation="swiglu", norm="rmsnorm", pos_embed="rope", tie_embeddings=False, qkv_bias=False,
        mlp_bias=False, compute_dtype="float32",
    ),
}
PIPE = dict(vocab_size=97, context_length=32, d_model=32, n_heads=4, n_layers=4, pipeline_stages=4,
            pipeline_microbatches=2, compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _bridged(name):
    """(jax cfg, jax params, port cfg, port params): the JAX init from seed
    0 plus seeded numpy noise on every leaf, the same tree in both."""
    kw = FLAVOURS[name]
    jc, tc = jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)
    tree = jax.tree.map(np.asarray, jax.jit(jtf.init_params, static_argnums=0)(jc, jax.random.key(0)))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: (a + rng.normal(0, 0.02, a.shape)).astype(np.float32), tree)
    return jc, jax.tree.map(jnp.asarray, tree), tc, bridge.params_from_numpy(tree, tc, device="cpu")


@pytest.mark.parametrize("name", sorted(FLAVOURS))
def test_return_hidden_matches_jax(name):
    jc, jparams, tc, tparams = _bridged(name)
    tokens = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    jlogits, _, jhidden = jax.jit(functools.partial(jtf.forward, cfg=jc, return_hidden=True))(
        jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tok = torch.from_numpy(tokens)
        logits, cache, hidden = ttf.forward(tparams, tok, tc, return_hidden=True)
        plain_logits, _ = ttf.forward(tparams, tok, tc)
    assert cache is None
    assert hidden["block_outputs"].shape == (tc.n_layers, 2, 16, tc.d_model)
    assert hidden["final_hidden"].shape == (2, 16, tc.d_model)
    for key in ("block_outputs", "final_hidden"):
        err = float(np.abs(hidden[key].numpy() - np.asarray(jhidden[key])).max())
        assert err <= HIDDEN_TOL, (key, err)
    # Collecting the block outputs changes nothing of the logits.
    assert torch.equal(logits, plain_logits)
    assert float(np.abs(logits.numpy() - np.asarray(jlogits)).max()) <= 1e-4


def test_return_hidden_orders_extras_as_jax():
    """(logits, cache, hidden, aux), and a cached call has no block outputs."""
    _, _, tc, tparams = _bridged("tiny")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with torch.no_grad():
        out = ttf.forward(tparams, tok, tc, return_hidden=True, return_aux=True)
        cache = ttf.make_kv_cache(tc, 1, 8, device="cpu")
        _, _, hidden = ttf.forward(tparams, tok, tc, kv_cache=cache, return_hidden=True)
    assert len(out) == 4 and set(out[2]) == {"block_outputs", "final_hidden"}
    assert out[3].shape == () and float(out[3]) == 0.0
    assert hidden["block_outputs"] is None and hidden["final_hidden"].shape == (1, 4, tc.d_model)


def test_pipe_mesh_refuses_return_hidden_with_jax_message():
    jc, tc = jconfig.ModelConfig(**PIPE), tconfig.ModelConfig(**PIPE)
    tokens = np.zeros((4, 8), np.int32)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 1, 1, 1, 1, 4),
                ("data", "fsdp", "tensor", "seq", "expert", "pipe"))
    shapes = jax.eval_shape(functools.partial(jtf.init_params, jc), jax.random.key(0))
    with pytest.raises(ValueError) as want, jax_activation_mesh(mesh):  # raised while tracing
        jax.eval_shape(functools.partial(jtf.forward, cfg=jc, return_hidden=True), shapes, jnp.asarray(tokens))
    params = ttf.init_params(tc, 0, device="cpu")
    with pytest.raises(ValueError) as got, activation_mesh({"data": 2, "pipe": 4}):
        ttf.forward(params, torch.from_numpy(tokens), tc, return_hidden=True)
    assert str(got.value) == str(want.value) == "return_hidden is not supported with pipeline parallelism"


@pytest.mark.parametrize("preset", sorted(tconfig.list_presets()))
def test_to_json_is_jax_byte_for_byte(preset):
    assert sorted(tconfig.list_presets()) == sorted(jconfig.list_presets())
    text = tconfig.get_preset(preset).to_json()
    assert text == jconfig.get_preset(preset).to_json()
    # Each package reads the other's text back to an equal config.
    back = tconfig.Config.from_json(jconfig.get_preset(preset).to_json())
    assert back == tconfig.get_preset(preset)
    assert isinstance(back.mesh.axis_names, tuple)
    assert jconfig.Config.from_json(text) == jconfig.get_preset(preset)


def test_from_json_accepts_text_without_the_later_sections():
    for pkg in (tconfig, jconfig):
        raw = json.loads(pkg.get_preset("tiny").to_json())
        for section in ("resilience", "obs", "serving", "frontend"):
            del raw[section]
        cfg = pkg.Config.from_json(json.dumps(raw))
        assert cfg.resilience == pkg.ResilienceConfig() and cfg.frontend == pkg.FrontendConfig()
        assert cfg.serving == pkg.ServingConfig() and cfg.obs == pkg.ObservabilityConfig()
        assert cfg.model == pkg.get_preset("tiny").model


def test_replace_is_dataclasses_replace():
    cfg = tconfig.get_preset("tiny")
    train = dataclasses.replace(cfg.train, batch_size=3)
    new = cfg.replace(train=train, name="x")
    assert new == dataclasses.replace(cfg, train=train, name="x")
    assert cfg.train.batch_size == 8  # frozen: the original stays
    assert new.to_json() == jconfig.get_preset("tiny").replace(
        train=dataclasses.replace(jconfig.get_preset("tiny").train, batch_size=3), name="x").to_json()
