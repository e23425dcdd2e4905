"""The port's parallelism in one process: ``pretraining_llm_tpu_torch/
parallel`` and the mesh section against the JAX package.

The partition rules of every preset's tree equal JAX's spec for spec; a
rank's block of a leaf is the block JAX's ``NamedSharding`` gives the
device at the same coordinates; ``MeshConfig.sizes`` and its errors, the
zigzag permutation, the grouped-KV predicates of ring and Ulysses, the
config round trip with the mesh section; with no seq axis (or a world of
one rank) ring and Ulysses are JAX's naive attention; the tensor, expert
and pipe axes are ported (no axis is refused); shard files in
JAX's checkpoint layout reassemble. The multi-rank cases are in
``test_torch_parallel_{attention,train,train_ring,checkpoint}.py``.
"""

import dataclasses
import functools
import json
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_threads import _one_torch_thread  # noqa: F401
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.parallel import ring_attention as jring
from pretraining_llm_tpu.parallel import sharding as jsh
from pretraining_llm_tpu.parallel import ulysses as julysses
from pretraining_llm_tpu.parallel import zigzag as jzz
from pretraining_llm_tpu.training import checkpoint as jckpt
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.models import transformer as ttf
from pretraining_llm_tpu_torch.parallel import mesh as pmesh
from pretraining_llm_tpu_torch.parallel import ring_attention as tring
from pretraining_llm_tpu_torch.parallel import sharding as tsh
from pretraining_llm_tpu_torch.parallel import ulysses as tulysses
from pretraining_llm_tpu_torch.parallel import zigzag as tzz
from pretraining_llm_tpu_torch.training import checkpoint as tckpt
from pretraining_llm_tpu_torch.training import train_step as tts

AXES = ("data", "fsdp", "tensor", "seq", "expert", "pipe")
LOSS_RTOL = 1e-5


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _meta(shapes):
    return {k: _meta(v) if isinstance(v, dict) else torch.empty(v, device="meta") for k, v in shapes.items()}


@pytest.mark.parametrize("tensor_size", [1, 2])
@pytest.mark.parametrize("name", tcfg.list_presets())
def test_param_pspec_tree_equals_jax(name, tensor_size):
    """Every preset's parameter tree (and AdamW's moments, which reuse it)
    gets JAX's spec, leaf for leaf."""
    port_cfg, jax_cfg = tcfg.get_preset(name), jcfg.get_preset(name)
    layout = jax.eval_shape(functools.partial(jtf.init_params, jax_cfg.model), jax.random.key(0))
    want = {"/".join(str(p.key) for p in path): (_padded(spec, leaf.ndim), leaf.shape)
            for (path, spec), (_, leaf) in zip(
                jax.tree_util.tree_leaves_with_path(jsh.param_pspec_tree(layout, tensor_size=tensor_size),
                                                    is_leaf=lambda x: isinstance(x, PartitionSpec)),
                jax.tree_util.tree_leaves_with_path(layout))}
    params = _meta(ttf.param_shapes(port_cfg.model))
    got_tree = tsh.param_pspec_tree(params, tensor_size=tensor_size)
    got = {"/".join(path): spec for path, spec in tts._spec_leaves(got_tree)}
    assert set(got) == set(want)
    for k, (spec, shape) in want.items():
        assert got[k] == spec, k
    state = {"params": params, "opt": {"mu": params, "nu": params, "count": None}, "step": None}
    specs = tts.state_pspec_tree(state, tensor_size=tensor_size)
    assert specs["opt"]["mu"] == got_tree and specs["opt"]["nu"] == got_tree and specs["step"] == ()


MESHES = [(2, 2, 1, 2, 1, 1), (1, 4, 1, 2, 1, 1), (2, 1, 2, 2, 1, 1), (1, 2, 1, 1, 4, 1)]
SPECS = [((None, "fsdp", None, "tensor", None), (2, 8, 3, 4, 6)), ((("data", "fsdp"), "seq"), (8, 16)),
         (("tensor", "fsdp"), (8, 4)), ((None, "expert", "fsdp", "tensor"), (2, 4, 8, 6)), ((), (3,))]


@pytest.mark.parametrize("sizes", MESHES)
def test_local_slices_match_named_sharding(sizes):
    """A rank's block under a spec is the block JAX's ``NamedSharding``
    gives the device at the same mesh coordinates."""
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(sizes), AXES)
    shape_of = dict(zip(AXES, sizes))
    for spec, shape in SPECS:
        index = NamedSharding(mesh, PartitionSpec(*spec)).devices_indices_map(shape)
        for coords in np.ndindex(*sizes):
            dev = mesh.devices[coords]
            want = tuple(slice(sl.start or 0, dim if sl.stop is None else sl.stop)
                         for sl, dim in zip(index[dev], shape))
            got = tsh.local_slices(spec, shape, shape_of, coord=dict(zip(AXES, coords)))
            assert got == want, (spec, coords)


def test_mesh_config_sizes_and_errors():
    for kw in ({}, {"data": 2, "fsdp": 4}, {"fsdp": 2, "seq": 2}, {"seq": 4}, {"data": 1, "fsdp": 8}):
        for n in (1, 2, 4, 8, 16):
            want, got = None, None
            try:
                want = jcfg.MeshConfig(**kw).sizes(n)
            except ValueError as e:
                with pytest.raises(ValueError) as err:
                    tcfg.MeshConfig(**kw).sizes(n)
                assert str(err.value) == str(e)
                continue
            got = tcfg.MeshConfig(**kw).sizes(n)
            assert got == want
    assert tcfg.MeshConfig().axis_names == jcfg.MeshConfig().axis_names == AXES
    # A meshed preset on one rank raises as JAX's does on one device; a
    # one-device mesh override runs it.
    fsdp = tcfg.get_preset("gpt2-1p3b-fsdp")
    assert pmesh.needs_mesh(fsdp.mesh) and not pmesh.needs_mesh(fsdp.with_overrides({"mesh.fsdp": 1}).mesh)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.build_mesh(fsdp.mesh)


@pytest.mark.parametrize("t,n", [(16, 2), (32, 4), (64, 4), (8192, 4), (24, 3)])
def test_zigzag_perm_and_inverse(t, n):
    perm = tzz.zigzag_perm(t, n)
    np.testing.assert_array_equal(perm, jzz.zigzag_perm(t, n))
    np.testing.assert_array_equal(tzz.inverse_perm(perm), jzz.inverse_perm(perm))
    np.testing.assert_array_equal(perm[tzz.inverse_perm(perm)], np.arange(t))
    with pytest.raises(ValueError, match="for zigzag"):
        tzz.zigzag_perm(t + 2, n)


def test_grouped_predicates_grid():
    """``ring_supports_grouped`` and ``ulysses_supports_grouped`` equal
    JAX's over a grid of heads, KV heads, tensor and seq sizes."""
    for h in (4, 8, 12, 16):
        for g in (1, 2, 3, 4, 8, 12, 16):
            if g > h or h % g:
                continue
            for tp in (1, 2, 4):
                for n in (1, 2, 4):
                    shape = {"data": 1, "fsdp": 1, "tensor": tp, "seq": n, "expert": 1, "pipe": 1}
                    jmesh = types.SimpleNamespace(shape=shape)
                    for port, ref in ((tring.ring_supports_grouped, jring.ring_supports_grouped),
                                      (tulysses.ulysses_supports_grouped, julysses.ulysses_supports_grouped)):
                        assert port(shape, h, g) == ref(jmesh, h, g), (port.__name__, h, g, tp, n)
    assert tring.ring_supports_grouped(None, 12, 3) and tulysses.ulysses_supports_grouped(None, 12, 3)


def test_config_round_trip_with_mesh():
    """The mesh section reads from a JAX config dict, overrides like any
    section, and a port config's dict builds the JAX config."""
    for name in ("gpt2-8k-sp", "gpt2-8k-gqa", "gpt2-1p3b-fsdp", "moe-8x350m"):
        want = jcfg.get_preset(name)
        got = tcfg.Config.from_dict(json.loads(want.to_json()))
        assert dataclasses.asdict(got.mesh) == dataclasses.asdict(want.mesh)
        assert got.model == tcfg.ModelConfig(**dataclasses.asdict(want.model))
        back = jcfg.Config.from_json(json.dumps(dataclasses.asdict(got)))
        assert back.mesh == want.mesh and back.model == want.model
    over = {"mesh.fsdp": 2, "mesh.seq": 2, "model.attention_impl": "ulysses"}
    assert dataclasses.asdict(tcfg.get_preset("tiny").with_overrides(over).mesh) == dataclasses.asdict(
        jcfg.get_preset("tiny").with_overrides(over).mesh)
    with pytest.raises(KeyError, match="mesh.nope"):
        tcfg.get_preset("tiny").with_overrides({"mesh.nope": 1})
    raw = dataclasses.asdict(jcfg.get_preset("tiny"))
    del raw["mesh"]  # a port checkpoint written before the section existed
    assert tcfg.Config.from_dict(raw).mesh == tcfg.MeshConfig()


@pytest.fixture()
def world_of_one():
    """A process group of this process alone (destroyed after the test)."""
    mesh = pmesh.single_device_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


SMALL = dict(vocab_size=97, context_length=32, d_model=32, n_heads=4, n_layers=2, compute_dtype="float32",
             pos_embed="rope")


@pytest.mark.parametrize("impl,g", [("ring", 4), ("ring", 2), ("ulysses", 4), ("ulysses", 2)])
def test_world_of_one_is_naive_attention(world_of_one, impl, g):
    """Without a seq axis above 1, ring and Ulysses are JAX's naive
    attention: the loss equals JAX's model of the same config, with no
    mesh and under a mesh of one rank, and the loss and every gradient are
    the port's naive model's bit for bit."""
    jm = jcfg.ModelConfig(**SMALL, n_kv_heads=g, attention_impl=impl)
    tm = tcfg.ModelConfig(**SMALL, n_kv_heads=g, attention_impl=impl)
    rng = np.random.default_rng(3)
    layout = jax.eval_shape(functools.partial(jtf.init_params, jm), jax.random.key(0))
    tree = jax.tree_util.tree_map_with_path(
        lambda p, s: ((1.0 if p[-1].key == "scale" else 0.0) + rng.normal(0, 0.05, s.shape)).astype(np.float32),
        layout)
    toks = rng.integers(0, SMALL["vocab_size"], (2, SMALL["context_length"] + 1)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    want = float(jax.jit(lambda p: jtf.loss_fn(p, x, y, jm))(tree))
    naive = dataclasses.replace(tm, attention_impl="naive")

    def port_loss(cfg, mesh):
        params = tts.opt.tree_map(lambda p: p.requires_grad_(True), bridge.params_from_numpy(tree, cfg, device="cpu"))
        with tsh.activation_mesh(mesh):
            loss = ttf.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y), cfg)
        loss.backward()
        return float(loss.detach()), {"/".join(p): t.grad for p, t in tts.opt.tree_leaves(params)}

    ref, ref_grads = port_loss(naive, None)
    for mesh in (None, world_of_one):
        got, grads = port_loss(tm, mesh)
        assert abs(got - want) <= LOSS_RTOL * abs(want)
        assert got == ref
        for k, g in grads.items():
            assert torch.equal(g, ref_grads[k]), k


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("option", ["window", "segments"])
def test_sequence_parallel_backstops_match_jax(impl, option):
    """A sliding window or document segments on the ring and Ulysses paths
    raise JAX's ValueError, word for word, whatever the mesh."""
    from pretraining_llm_tpu.ops.attention import multihead_attention as jmha
    from pretraining_llm_tpu_torch.ops.attention import multihead_attention as tmha

    q = np.zeros((1, 8, 2, 4), np.float32)
    seg = np.zeros((1, 8), np.int32)
    kw = {"window": 4} if option == "window" else {}
    with pytest.raises(ValueError) as want:
        jmha(q, q, q, impl=impl, segments=seg if option == "segments" else None, **kw)
    tq = torch.from_numpy(q)
    with pytest.raises(ValueError) as got:
        tmha(tq, tq, tq, impl=impl, segments=torch.from_numpy(seg) if option == "segments" else None, **kw)
    assert str(got.value) == str(want.value)


def test_unported_axes_and_pipeline_raise():
    """Every axis is ported: the mesh module keeps no list of unported
    axes, and a ``pipeline_stages`` = 2 model (refused before) builds its
    parameters as JAX's init does and, off a pipe mesh, runs the plain
    layer loop: JAX's plain scan's logits."""
    assert not hasattr(pmesh, "UNPORTED_AXES") and not hasattr(pmesh, "check_ported_axes")
    cfg = tcfg.ModelConfig(**dict(SMALL, pos_embed="learned"), pipeline_stages=2)
    params = ttf.init_params(cfg, 0, device="cpu")
    jcfg_model = jcfg.ModelConfig(**dict(SMALL, pos_embed="learned"), pipeline_stages=2)
    jparams = jax.tree.map(lambda a: jax.numpy.asarray(a.numpy()), params)
    tokens = np.arange(16, dtype=np.int32)[None] % cfg.vocab_size
    want, _ = jtf.forward(jparams, tokens, jcfg_model)
    got, _ = ttf.forward(params, torch.from_numpy(tokens).long(), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_sharded_leaf_reassembly(tmp_path, dtype):
    """JAX's multi-process shard file format (``test_training.py``'s
    reassembly case): split leaves reassemble exactly in the port, and the
    port's block writer produces files JAX's loader reassembles."""
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    for p, sl in enumerate([slice(0, 2), slice(2, 4)]):
        np.save(tmp_path / f"w.p{p}_0.npy", arr[sl])
        (tmp_path / f"w.p{p}_0.npy.idx").write_text(json.dumps([[sl.start, sl.stop], [0, 6]]))
    np.save(tmp_path / "wide.p0_0.npy", arr)  # a leaf whose name extends "w" is not a block of it
    (tmp_path / "wide.p0_0.npy.idx").write_text(json.dumps([[0, 4], [0, 6]]))
    entry = {"name": "w", "shape": [4, 6], "dtype": "float32", "sharded": True}
    np.testing.assert_array_equal(tckpt._load_leaf(str(tmp_path), entry).numpy(), arr)

    out = tmp_path / "port"
    out.mkdir()
    full = torch.arange(48, dtype=torch.float32).reshape(8, 6).to(getattr(torch, dtype))
    for p, (lo, hi) in enumerate([(0, 4), (4, 8)]):
        info = tckpt.ShardedLeaf((8, 6), (slice(lo, hi), slice(0, 6)), write=True)
        entry = tckpt._save_shard(str(out), "x", full[lo:hi], info, p)
    assert entry == {"name": "x", "shape": [8, 6], "dtype": dtype, "sharded": True}
    got = tckpt._load_leaf(str(out), entry)
    assert got.dtype == full.dtype and torch.equal(got, full)
    if dtype == "float32":
        np.testing.assert_array_equal(jckpt._load_leaf(str(out), entry), full.numpy())
