"""Adafactor, Muon and the in-place AdamW and clip of the PyTorch port,
against the JAX package's ``training/optimizer.py``.

Three steps of each optimizer from the same parameters, states and
gradients (seeded numpy noise on a 2-layer GQA llama tree with a biased
untied head, and a gpt2 tree) give the JAX states and parameters; the
state trees (names, shapes, leaf classification) equal the JAX package's
for every port preset; Newton-Schulz equals the JAX iteration on random
batches of both orientations; AdamW and the clip keep the JAX results while
writing into the tensors they were given (``data_ptr`` unchanged); and
Adafactor and Muon states round-trip through checkpoints both ways
(JAX -> port -> JAX). Tolerances (fp32): each state and parameter leaf
within 1e-5 of its largest |value| (at least 1e-6); Newton-Schulz 1e-5
max-abs; AdamW and clip 1e-6 (as ``test_torch_port_training.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.training import checkpoint as jckpt
from pretraining_llm_tpu.training import optimizer as jopt
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.models import transformer as ttf
from pretraining_llm_tpu_torch.training import checkpoint as tckpt
from pretraining_llm_tpu_torch.training import optimizer as topt

LLAMA_GQA = dict(
    vocab_size=97, context_length=32, d_model=32, n_heads=4, n_kv_heads=2,
    n_layers=2, activation="swiglu", norm="rmsnorm", pos_embed="rope",
    tie_embeddings=False, lm_head_bias=True, qkv_bias=False, mlp_bias=False,
    compute_dtype="float32", attention_impl="flash",
)
GPT2 = dict(
    vocab_size=97, context_length=32, d_model=32, n_heads=4, n_layers=2,
    activation="gelu", norm="layernorm", pos_embed="learned",
    tie_embeddings=True, qkv_bias=True, mlp_bias=True,
    compute_dtype="float32", attention_impl="flash",
)
FLAVOURS = {"llama_gqa": LLAMA_GQA, "gpt2": GPT2}
TRAIN = dict(lr=1e-3, weight_decay=0.1, adam_b1=0.9, adam_b2=0.95, adam_eps=1e-8, muon_momentum=0.95)
RTOL, ATOL = 1e-5, 1e-6
NS_TOL = 1e-5
OPT_TOL = 1e-6


def _tree(kw, seed):
    jc = jcfg.ModelConfig(**kw)
    layout = jax.eval_shape(functools.partial(jtf.init_params, jc), jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.05, spec.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, layout)


def _noise(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32), tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.asarray(tree).dtype, copy=True))


def _flat(tree):
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return {"/".join(p): t.numpy() for p, t in topt.tree_leaves(tree)}
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_close(want_tree, got_tree, what):
    want, got = _flat(want_tree), _flat(got_tree)
    assert want.keys() == got.keys(), what
    for name in want:
        tol = max(RTOL * float(np.abs(want[name]).max()), ATOL)
        assert float(np.abs(want[name].astype(np.float64) - got[name]).max()) <= tol, (what, name)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_update(grads, state, params, lr, *, cfg):
    return jopt.optimizer_update(grads, state, params, lr, cfg)


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
@pytest.mark.parametrize("name", ["adafactor", "muon"])
def test_three_steps_match_jax(name, flavour):
    """Three updates from the same params and zero state with fresh
    gradients each step: every state leaf and parameter equals JAX's."""
    kw = FLAVOURS[flavour]
    jt, tt = jcfg.TrainConfig(optimizer=name, **TRAIN), tcfg.TrainConfig(optimizer=name, **TRAIN)
    tree = _tree(kw, 3)
    jparams, jstate = jax.tree.map(jnp.asarray, tree), jopt.optimizer_init(jax.tree.map(jnp.asarray, tree), jt)
    tparams = _to_torch(tree)
    tstate = topt.optimizer_init(tparams, tt)
    for i in range(3):
        grads = _noise(tree, 10 + i, 0.3)
        lr = 1e-3 * (i + 1)
        jparams, jstate = _jax_update(jax.tree.map(jnp.asarray, grads), jstate, jparams, jnp.float32(lr), cfg=jt)
        tparams, tstate = topt.optimizer_update(_to_torch(grads), tstate, tparams, torch.tensor(lr), tt)
    assert int(tstate["count"]) == int(jstate["count"]) == 3
    key = "v" if name == "adafactor" else "s"
    _assert_close(jstate[key], tstate[key], f"{name} state")
    _assert_close(jparams, tparams, f"{name} params")


@pytest.mark.parametrize("preset", tcfg.list_presets())
def test_state_trees_and_leaf_classes_match_jax(preset):
    """Mirrors ``test_optimizer.py``'s Adafactor factoring and Muon
    classification tests on every port preset: the state tree of each
    optimizer has the JAX package's leaf names and shapes (so the factored
    and full second moments, and the momentum-only and Adam leaves, fall on
    the same parameters)."""
    jmodel = jcfg.get_preset(preset).model
    layout = jax.eval_shape(functools.partial(jtf.init_params, jmodel), jax.random.key(0))
    meta = {}
    for path, shape in topt.tree_leaves(ttf.param_shapes(tcfg.get_preset(preset).model)):
        node = meta
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(shape, device="meta")
    for name in ("adamw", "adafactor", "muon"):
        want = jax.eval_shape(lambda p: jopt.optimizer_init(p, jcfg.TrainConfig(optimizer=name)), layout)
        got = topt.optimizer_init(meta, tcfg.TrainConfig(optimizer=name))
        assert {"/".join(str(getattr(p, "key", p)) for p in path): tuple(x.shape)
                for path, x in jax.tree_util.tree_leaves_with_path(want)} == {
            "/".join(p): tuple(t.shape) for p, t in topt.tree_leaves(got)}, (preset, name)
    if preset == "tiny":  # the JAX test's spot checks
        v = topt.adafactor_init(meta)["v"]
        assert set(v["blocks"]["attn"]["wqkv"]) == {"r", "c"} and set(v["tok_embed"]["embedding"]) == {"r", "c"}
        assert set(v["blocks"]["ln1"]["scale"]) == {"full"}
        s = topt.muon_init(meta)["s"]
        assert set(s["blocks"]["attn"]["wqkv"]) == set(s["blocks"]["mlp"]["w1"]) == {"m"}
        assert set(s["tok_embed"]["embedding"]) == set(s["blocks"]["ln1"]["scale"]) == {"mu", "nu"}


@pytest.mark.parametrize("shape", [(3, 8, 16), (3, 16, 8), (2, 12, 12)])
def test_newton_schulz_matches_jax(shape):
    m = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    want = np.asarray(jopt.newton_schulz_orthogonalize(jnp.asarray(m)))
    got = topt.newton_schulz_orthogonalize(torch.from_numpy(m)).numpy()
    assert got.shape == want.shape and float(np.abs(got - want).max()) <= NS_TOL
    assert [topt._matrix_view(("blocks", "attn", n), (2, 32, 3, 4, 8)) for n in ("wqkv", "wo")] == [
        jopt._matrix_view(tuple(jax.tree_util.DictKey(k) for k in ("blocks", "attn", n)), (2, 32, 3, 4, 8))
        for n in ("wqkv", "wo")]


def test_adamw_and_clip_update_in_place():
    """The AdamW step and the clip give the JAX results and write them
    into the tensors they were handed: no leaf of params, mu, nu or the
    gradients moves (``data_ptr``), and no new tree is built."""
    tree = _tree(LLAMA_GQA, 5)
    grads = _noise(tree, 6, 0.3)
    mu = _noise(tree, 7, 0.01)
    nu = jax.tree.map(np.abs, _noise(tree, 8, 1e-4))
    jt, tt = jcfg.TrainConfig(**TRAIN), tcfg.TrainConfig(**TRAIN)
    j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    want_g, want_norm = jopt.clip_by_global_norm(j(grads), 1.0)
    want_p, want_s = jopt.adamw_update(want_g, {"mu": j(mu), "nu": j(nu), "count": jnp.asarray(2, jnp.int32)},
                                       j(tree), jnp.float32(7e-4), jt)
    tg, tp = _to_torch(grads), _to_torch(tree)
    ts = {"mu": _to_torch(mu), "nu": _to_torch(nu), "count": torch.tensor(2, dtype=torch.int32)}
    ptrs = [t.data_ptr() for tr in (tg, tp, ts["mu"], ts["nu"]) for _, t in topt.tree_leaves(tr)]
    got_g, got_norm = topt.clip_by_global_norm(tg, 1.0)
    got_p, got_s = topt.adamw_update(got_g, ts, tp, torch.tensor(7e-4), tt)
    assert got_g is tg and got_p is tp and got_s["mu"] is ts["mu"] and got_s["nu"] is ts["nu"]
    assert [t.data_ptr() for tr in (tg, tp, ts["mu"], ts["nu"]) for _, t in topt.tree_leaves(tr)] == ptrs
    assert abs(float(got_norm) - float(want_norm)) <= OPT_TOL * float(want_norm)
    for want, got in ((want_g, got_g), (want_p, got_p), (want_s["mu"], got_s["mu"]), (want_s["nu"], got_s["nu"])):
        w, g = _flat(want), _flat(got)
        for name in w:
            assert float(np.abs(w[name] - g[name]).max()) <= OPT_TOL, name


@pytest.mark.parametrize("name", ["adafactor", "muon"])
def test_optimizer_state_round_trips_jax_checkpoints(tmp_path, name):
    """A JAX checkpoint of an Adafactor or Muon train state restores in the
    port leaf for leaf; the port writes it back, and JAX's loader reads the
    same values."""
    tree = _tree(GPT2, 4)
    jt = jcfg.TrainConfig(optimizer=name, **TRAIN)
    params = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": params, "opt": jopt.optimizer_init(params, jt), "step": jnp.asarray(1, jnp.int32)}
    params, jstate["opt"] = _jax_update(jax.tree.map(jnp.asarray, _noise(tree, 9, 0.3)), jstate["opt"], params,
                                        jnp.float32(1e-3), cfg=jt)
    jstate["params"] = params
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    tparams = _to_torch(tree)
    template = {"params": tparams, "opt": topt.optimizer_init(tparams, tcfg.TrainConfig(optimizer=name)),
                "step": torch.zeros((), dtype=torch.int32)}
    got, _ = tckpt.load_checkpoint(str(tmp_path / "jax" / "step-1"), template)
    want = _flat(jstate)
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    tckpt.save_checkpoint(str(tmp_path / "port"), 1, got)
    back, _ = jckpt.load_checkpoint(str(tmp_path / "port" / "step-1"), jstate)
    for k, v in _flat(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
