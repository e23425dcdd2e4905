"""Sharded checkpoints of leaves split over two and three mesh axes, on 4
gloo ranks, against the JAX package's checkpoint module:

- a 4-rank (fsdp 2, tensor 2) run of the port's ``Trainer`` writes each
  rank's blocks of the fsdp x tensor leaves (``<name>.p<rank>_0.npy`` +
  ``.idx``, ``local.p<rank>.json``); JAX's ``load_checkpoint`` restores
  what the port restores on one device, bit for bit, the ranks' live
  blocks are pieces of it, and the ranks resume it on another mesh
  (tensor 4) bit for bit;
- a JAX checkpoint of a MoE model rewritten in JAX's multi-process layout
  for an (expert 2, tensor 2) mesh (expert x fsdp x tensor blocks, as
  ``test_training.py``'s reassembly case writes shards) restores in the
  port on one device and on the ranks' (expert 2, tensor 2) mesh, bit for
  bit.
"""

import dataclasses
import itertools
import json
import os

import jax
import numpy as np
import pytest
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401

from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.parallel.sharding import param_pspec
from pretraining_llm_tpu.training import checkpoint as jckpt
from pretraining_llm_tpu.training import train_step as jts
from pretraining_llm_tpu.training.metrics import MetricsLogger as JMetricsLogger
from pretraining_llm_tpu.training.trainer import Trainer as JTrainer
from pretraining_llm_tpu_torch.training import checkpoint as tckpt


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


def _config(model=None, **train):
    cfg = jcfg.get_preset("tiny")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32", context_length=32, **(model or {})),
        train=dataclasses.replace(cfg.train, batch_size=8, eval_interval=0, log_interval=1, **train))


def _flat_np(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(x) for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _flat_port(tree):
    from pretraining_llm_tpu_torch.training.optimizer import tree_leaves

    return {"/".join(p): t.numpy() for p, t in tree_leaves(tree)}


def _blocks_cover(results, full, name):
    """Each rank's block of a leaf is an aligned piece of the full leaf
    (split along any dims), and together they cover it."""
    seen = np.zeros(full.shape, bool)
    for r in results:
        block = r["state"][name]
        options = [range(f // b) for b, f in zip(block.shape, full.shape)]
        for ks in itertools.product(*options):
            idx = tuple(slice(k * b, (k + 1) * b) for k, b in zip(ks, block.shape))
            if np.array_equal(full[idx], block):
                seen[idx] = True
                break
        else:
            raise AssertionError(f"{name}: a rank's block is no piece of the leaf")
    assert seen.all(), name


def test_fsdp_tensor_checkpoint_crosses_to_jax_and_other_meshes(ranks, tmp_path):
    ck = str(tmp_path / "ck")
    cfg = _config(train_steps=2, checkpoint_dir=ck, checkpoint_interval=0)
    out = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                    overrides={"mesh.fsdp": 2, "mesh.tensor": 2}, resume=False)
    path = os.path.join(ck, "step-2")
    meta = json.load(open(os.path.join(path, "metadata.json")))
    assert meta["n_processes"] == 4
    files = set(os.listdir(path))
    # wqkv is fsdp x tensor: four distinct blocks, one from each rank.
    assert {f"params__blocks__attn__wqkv.p{p}_0.npy" for p in range(4)} <= files
    for p in range(4):
        assert f"local.p{p}.json" in files
    template = jax.eval_shape(lambda: jts.init_train_state(cfg, jax.random.key(0)))
    want = _flat_np(jckpt.load_checkpoint(path, template)[0])
    got = _flat_port(tckpt.load_checkpoint(path, template)[0])
    assert set(got) == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
        _blocks_cover(out, arr, name)
    back = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                     overrides={"mesh.tensor": 4}, steps=2)
    for r in back:
        assert r["start"] == 2
    for name, arr in want.items():
        _blocks_cover(back, arr, name)


def _shard_jax_checkpoint(path, sizes):
    """Rewrite a single-process JAX checkpoint's split leaves in JAX's
    multi-process layout for a mesh of ``sizes`` ({axis: size}): each
    distinct block once, from the first process that holds it."""
    meta = json.load(open(os.path.join(path, "metadata.json")))
    axes = ("data", "fsdp", "tensor", "seq", "expert", "pipe")
    shape = [sizes.get(a, 1) for a in axes]
    n = 0
    for entry in meta["manifest"]:
        parts = entry["name"].split("__")
        names = tuple(parts[2:]) if parts[0] == "opt" else tuple(parts[1:])
        if parts[0] not in ("params", "opt") or parts[-1] == "count":
            continue
        spec = tuple(param_pspec(names, len(entry["shape"]), shape=tuple(entry["shape"]),
                                 tensor_size=sizes.get("tensor", 1)))
        spec = spec + (None,) * (len(entry["shape"]) - len(spec))
        if not any(e is not None and sizes.get(e, 1) > 1 for e in spec):
            continue
        arr = np.load(os.path.join(path, entry["name"] + ".npy"))
        written = set()
        for p, coord in enumerate(itertools.product(*(range(s) for s in shape))):
            c = dict(zip(axes, coord))
            idx = []
            for d, e in enumerate(spec):
                k = sizes.get(e, 1) if e is not None else 1
                b = arr.shape[d] // k
                i = c[e] if e is not None and k > 1 else 0
                idx.append((i * b, (i + 1) * b))
            if tuple(idx) in written:
                continue
            written.add(tuple(idx))
            np.save(os.path.join(path, f"{entry['name']}.p{p}_0.npy"), arr[tuple(slice(a, b) for a, b in idx)])
            with open(os.path.join(path, f"{entry['name']}.p{p}_0.npy.idx"), "w") as f:
                json.dump([list(i) for i in idx], f)
        os.remove(os.path.join(path, entry["name"] + ".npy"))
        entry["sharded"] = True
        del entry["checksum"]
        n += 1
    meta["n_processes"] = int(np.prod(shape))
    json.dump(meta, open(os.path.join(path, "metadata.json"), "w"))
    return n


def test_jax_expert_tensor_checkpoint_restores_in_the_port(ranks, tmp_path):
    ck = str(tmp_path / "jck")
    cfg = _config(model=dict(n_experts=4, experts_per_token=2, expert_capacity_factor=4.0), train_steps=2,
                  checkpoint_dir=ck, checkpoint_interval=0)
    JTrainer(cfg, synthetic_data=True, resume=False, logger=JMetricsLogger()).train()
    path = os.path.join(ck, "step-2")
    template = jax.eval_shape(lambda: jts.init_train_state(cfg, jax.random.key(0)))
    want = _flat_np(jckpt.load_checkpoint(path, template)[0])
    assert _shard_jax_checkpoint(path, {"tensor": 2, "expert": 2}) >= 10
    assert os.path.exists(os.path.join(path, "params__blocks__mlp__experts__w1.p3_0.npy"))
    np.testing.assert_equal(_flat_np(jckpt.load_checkpoint(path, template)[0]), want)
    got = _flat_port(tckpt.load_checkpoint(path, template)[0])
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    out = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                    overrides={"mesh.tensor": 2, "mesh.expert": 2}, steps=2)
    for r in out:
        assert r["start"] == 2
    for name, arr in want.items():
        _blocks_cover(out, arr, name)
