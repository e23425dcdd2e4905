"""The port's pipe axis composed with the other axes, on 4 gloo ranks
against the JAX package's ``build_train_step`` on the same mesh shape
(conftest's virtual CPU devices), JAX's ``tests/test_pipeline.py`` cases
at 4 devices: the tiny preset, fp32, 4 layers, 2 AdamW steps, the bars of
``_torch_parallel_jax.check_against_jax`` (loss rtol 1e-5, grad norm rtol
1e-4, the ranks' blocks against JAX's state rtol 1e-3 / atol 1e-4; JAX's
state of an interleaved pipeline is in the baked rank-major layout, and so
are the ranks' blocks):

- data 2 x pipe 2 with V 2 (the baked layout), then the checkpoint the
  ranks write: depth-major, loaded by JAX's ``load_checkpoint`` at a world
  of one and by the port on one process bit for bit alike, and equal to
  JAX's state de-interleaved;
- tensor 2 x pipe 2 with V 2 (fsdp and expert x pipe on a MoE model are
  ``test_torch_parallel_pipeline_moe.py``'s);
- the port's ``Trainer`` on data 2 x pipe 2 with V 2: its checkpoint
  resumes on data 4 (no pipe) with every leaf bit for bit, and its eval
  loss is the one-process trainer's; it resumes on data 2 x pipe 2 with
  V 2 and with V 1, and from a copy written in the interleaved layout
  (``block_layout`` "interleaved", read back as the JAX trainer reads
  it), each rank's blocks the file's in its own layout bit for bit and
  the next step's loss the data 4 resume's."""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
from _torch_parallel_jax import PARAM_TOL, check_against_jax, jax_run, tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401

from pretraining_llm_tpu.parallel import pipeline as jpipe
from pretraining_llm_tpu.training import checkpoint as jckpt
from pretraining_llm_tpu.training import train_step as jts
from pretraining_llm_tpu_torch.training import checkpoint as tckpt

DATA2_PIPE2 = (2, 1, 1, 1, 1, 2)
TENSOR2_PIPE2 = (1, 1, 2, 1, 1, 2)
V2 = dict(n_layers=4, pipeline_stages=2, pipeline_interleave=2, pipeline_microbatches=2)


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


def _named(tree):
    return {"__".join(str(p.key) for p in path): np.asarray(x) for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def test_baked_v2_steps_and_depth_major_checkpoint(ranks, tmp_path):
    cfg = tiny_config(**V2)
    final = []
    params_np, x, y, metrics, flat = jax_run(cfg, DATA2_PIPE2, final_state=final)
    ck = str(tmp_path / "ck")
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=DATA2_PIPE2, save_dir=ck)
    check_against_jax(results, metrics, flat)
    path = os.path.join(ck, "step-2")
    files = set(os.listdir(path))
    # Each pipe rank of data coordinate 0 writes its 2 chunks as 2 blocks.
    assert {"params__blocks__attn__wqkv.p0_0.npy", "params__blocks__attn__wqkv.p0_1.npy",
            "params__blocks__attn__wqkv.p1_0.npy", "params__blocks__attn__wqkv.p1_1.npy"} <= files
    assert json.load(open(os.path.join(path, "params__blocks__attn__wqkv.p1_1.npy.idx")))[0] == [3, 4]
    template = jax.eval_shape(lambda: jts.init_train_state(cfg, jax.random.key(0)))
    jstate, _ = jckpt.load_checkpoint(path, template)
    tstate, extra = tckpt.load_checkpoint(path, template)
    assert extra["block_layout"] == "depth_major"
    want = _named(jts.bake_state_layout(final[0], cfg, forward=False))
    got_j, got_t = _named(jstate), {"__".join(p): t.numpy() for p, t in _port_leaves(tstate)}
    for name, arr in want.items():
        if name == "step":
            continue
        np.testing.assert_array_equal(got_t[name], got_j[name], err_msg=name)
        np.testing.assert_allclose(got_j[name], arr, err_msg=name, **PARAM_TOL)


def _port_leaves(tree):
    from pretraining_llm_tpu_torch.training.optimizer import tree_leaves

    return tree_leaves(tree)


@pytest.mark.parametrize("sizes,model", [(TENSOR2_PIPE2, V2)], ids=["tensor2-pipe2-v2"])
def test_pipe_composes_with_other_axes(ranks, sizes, model):
    cfg = tiny_config(**model)
    params_np, x, y, metrics, flat = jax_run(cfg, sizes)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=sizes)
    check_against_jax(results, metrics, flat)
    name = "params/blocks/attn/wqkv"
    for r in results:
        block, sl = r["blocks"][name]
        assert sl[0] in ([0, 2], [2, 4])  # the pipe split of the layer dim
        assert block.shape != flat[name].shape[:1] + block.shape[1:]  # and another axis splits too


def test_trainer_on_a_pipe_mesh_resumes_without_pipe(ranks, tmp_path):
    ck = str(tmp_path / "ck")
    cfg = tiny_config(**V2)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, train_steps=2, checkpoint_dir=ck, checkpoint_interval=0,
                                                eval_interval=0, log_interval=1))
    over = {"mesh.data": 2, "mesh.pipe": 2}
    piped = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg), overrides=over,
                      resume=False, eval_iters=2)
    back = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                     overrides={"mesh.data": 4}, steps=2, eval_iters=2)
    template = jax.eval_shape(lambda: jts.init_train_state(cfg, jax.random.key(0)))
    tstate, _ = tckpt.load_checkpoint(os.path.join(ck, "step-2"), template)
    saved = {"__".join(p): t.numpy() for p, t in _port_leaves(tstate)}
    for r in back:
        assert r["start"] == 2
        for name, arr in r["state"].items():
            np.testing.assert_array_equal(arr, saved[name.replace("/", "__")], err_msg=name)
    for r in piped:
        np.testing.assert_allclose(r["last"]["eval"], back[0]["last"]["eval"], rtol=1e-5)


@pytest.fixture(scope="module")
def pipe_checkpoint(ranks, tmp_path_factory):
    """The data 2 x pipe 2 V 2 trainer's step-2 checkpoint, its leaves as
    the port loads them at a world of one, and the step-3 loss of a resume
    on data 4."""
    root = tmp_path_factory.mktemp("pipe_ck")
    cfg = _trainer_config(str(root / "ck"))
    ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
              overrides={"mesh.data": 2, "mesh.pipe": 2}, resume=False)
    template = jax.eval_shape(lambda: jts.init_train_state(cfg, jax.random.key(0)))
    tstate, _ = tckpt.load_checkpoint(str(root / "ck" / "step-2"), template)
    shutil.copytree(root / "ck", root / "data4")
    back = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                     overrides={"mesh.data": 4, "train.checkpoint_dir": str(root / "data4")}, steps=3)
    return root, tstate, back[0]["last"]["loss"]


def _trainer_config(ck):
    cfg = tiny_config(**V2)
    return cfg.replace(train=dataclasses.replace(cfg.train, train_steps=2, checkpoint_dir=ck, checkpoint_interval=0,
                                                 eval_interval=0, log_interval=1))


@pytest.mark.parametrize("interleave,file_layout", [(2, "depth_major"), (1, "depth_major"), (2, "interleaved")],
                         ids=["pipe2-v2", "pipe2-v1", "pipe2-v2-interleaved-file"])
def test_trainer_resumes_a_pipe_checkpoint_on_pipe_meshes(ranks, pipe_checkpoint, tmp_path, interleave, file_layout):
    root, tstate, want_loss = pipe_checkpoint
    cfg = _trainer_config(str(root / "ck"))
    ck = tmp_path / "ck"
    if file_layout == "depth_major":
        shutil.copytree(root / "ck", ck)
    else:  # the whole state's blocks in the rank-major layout of S 2, V 2
        from pretraining_llm_tpu_torch.training import train_step as tts

        baked = tts.bake_state_layout(tstate, cfg, forward=True)
        path = tckpt.save_checkpoint(str(ck), 2, baked, extra={"step": 2, "block_layout": "interleaved"})
        for name in os.listdir(root / "ck" / "step-2"):  # each rank's sampler state
            if name.startswith("local.p"):
                shutil.copy(root / "ck" / "step-2" / name, path)
    over = {"mesh.data": 2, "mesh.pipe": 2, "model.pipeline_interleave": interleave, "train.checkpoint_dir": str(ck)}
    results = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg), overrides=over,
                        steps=3)
    saved = {"/".join(p): t.numpy() for p, t in _port_leaves(tstate)}
    n = cfg.model.n_layers // 2
    for r in results:
        assert r["start"] == 2
        p = r["coord"]["pipe"]
        for name, arr in r["restored"].items():
            want = saved[name]
            if "blocks" in name.split("/"):
                if interleave > 1:
                    want = np.asarray(jpipe.interleave_layout(want, 2, interleave))
                want = want[p * n:(p + 1) * n]
            np.testing.assert_array_equal(arr, want, err_msg=name)
        np.testing.assert_allclose(r["last"]["loss"], want_loss, rtol=1e-5)


def test_compile_only_reports_a_pipe_ranks_blocks(ranks):
    """``train --compile-only`` on data 2 x pipe 2 with V 2 sizes one rank:
    the bytes of JAX's per-device shard shapes under its pipeline specs."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    cfg = tiny_config(**V2)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(DATA2_PIPE2), ("data", "fsdp", "tensor", "seq", "expert", "pipe"))
    shapes = jax.eval_shape(lambda: jts.init_train_state(cfg, jax.random.key(0)))
    specs = jts.state_pspec_tree(shapes, pipeline=True)
    want = sum(int(np.prod(NamedSharding(mesh, spec).shard_shape(leaf.shape))) * leaf.dtype.itemsize
               for spec, leaf in zip(jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec)),
                                     jax.tree.leaves(shapes)))
    got = ranks.run("_torch_parallel_cases:compile_only_sizes", cfg_dict=dataclasses.asdict(cfg), sizes=DATA2_PIPE2)
    for r in got:
        assert r["state"] == want
