"""Sharded checkpoints and the multi-rank drills of the port's trainer on
2 gloo ranks, against the JAX package's checkpoint module.

- A 2-rank fsdp run of the port's ``Trainer`` writes its sharded leaves in
  blocks (``<name>.p<rank>_0.npy`` + ``.idx``); JAX's ``load_checkpoint``
  restores the same leaves the port restores on one device, and the ranks'
  live blocks are slices of them, bit for bit; the 2 ranks resume it on
  another mesh (data 2) bit for bit.
- A JAX checkpoint with sharded leaves in JAX's multi-process layout
  (built from a JAX trainer's checkpoint the way ``test_training.py``'s
  reassembly case writes shards) restores on the ranks' fsdp mesh and on
  one device, bit for bit.
- The drills of ``test_multiprocess.py``: a 2-rank run stopped after its
  step-3 checkpoint and resumed equals the straight run's loss bit for
  bit (and the one-process run's loss and eval within rtol 1e-5); a SIGTERM to one rank stops both at the same step with one common
  checkpoint.
"""

import dataclasses
import io
import json
import os

import numpy as np
import pytest
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401

from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.training import checkpoint as jckpt
from pretraining_llm_tpu.training import train_step as jts
from pretraining_llm_tpu.training.metrics import MetricsLogger as JMetricsLogger
from pretraining_llm_tpu.training.trainer import Trainer as JTrainer
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.training import checkpoint as tckpt
from pretraining_llm_tpu_torch.training.metrics import MetricsLogger as TMetricsLogger
from pretraining_llm_tpu_torch.training.trainer import Trainer as TTrainer

import jax


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(2)
    yield group
    group.close()


def _config(**train):
    cfg = jcfg.get_preset("tiny")
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32", context_length=32),
                               train=dataclasses.replace(cfg.train, batch_size=8, eval_interval=0,
                                                         log_interval=1, **train))


def _flat_np(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(x) for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _flat_port(tree):
    from pretraining_llm_tpu_torch.training.optimizer import tree_leaves

    return {"/".join(p): t.numpy() for p, t in tree_leaves(tree)}


def _blocks_cover(results, full, name):
    """The ranks' blocks of one leaf: each a slice of the full leaf, and
    together the whole of it."""
    seen = np.zeros(full.shape, bool)
    for r in results:
        block = r["state"][name]
        if block.shape == full.shape:
            np.testing.assert_array_equal(block, full, err_msg=name)
            seen[...] = True
            continue
        dim = next(d for d, (a, b) in enumerate(zip(block.shape, full.shape)) if a != b)
        k = next(i for i in range(full.shape[dim] // block.shape[dim])
                 if np.array_equal(np.take(full, range(i * block.shape[dim], (i + 1) * block.shape[dim]), dim),
                                   block))
        idx = [slice(None)] * full.ndim
        idx[dim] = slice(k * block.shape[dim], (k + 1) * block.shape[dim])
        seen[tuple(idx)] = True
    assert seen.all(), name


def test_port_sharded_checkpoint_crosses_to_jax_and_other_meshes(ranks, tmp_path):
    ck = str(tmp_path / "ck")
    cfg = _config(train_steps=2, checkpoint_dir=ck, checkpoint_interval=0)
    out = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                    overrides={"mesh.fsdp": 2}, resume=False)
    path = os.path.join(ck, "step-2")
    meta = json.load(open(os.path.join(path, "metadata.json")))
    assert meta["n_processes"] == 2
    sharded = [e["name"] for e in meta["manifest"] if e["sharded"]]
    assert "params__blocks__mlp__w1" in sharded and "opt__mu__blocks__mlp__w1" in sharded
    for name in sharded:
        assert {f for f in os.listdir(path) if f.startswith(name + ".p") and f.endswith(".npy")} == {
            f"{name}.p0_0.npy", f"{name}.p1_0.npy"}
    assert os.path.exists(os.path.join(path, "local.p0.json")) and os.path.exists(os.path.join(path, "local.p1.json"))

    # JAX restores what the port restores on one device, bit for bit.
    template = jax.eval_shape(lambda: jts.init_train_state(cfg, jax.random.key(0)))
    jstate, _ = jckpt.load_checkpoint(path, template)
    tstate, extra = tckpt.load_checkpoint(path, template)
    want = _flat_np(jstate)
    got = _flat_port(tstate)
    assert set(got) == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
        _blocks_cover(out, arr, name)
    assert extra["step"] == 2

    # Resumed on another mesh (data 2: every leaf whole on both ranks).
    back = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                     overrides={"mesh.data": 2}, steps=2)
    for r in back:
        assert r["start"] == 2
        for name, arr in want.items():
            np.testing.assert_array_equal(r["state"][name], arr, err_msg=name)


def _shard_jax_checkpoint(path):
    """Rewrite a single-process JAX checkpoint's fsdp leaves in JAX's
    multi-process layout: two blocks along the fsdp dim, ``sharded`` in the
    manifest (no checksum), as two processes of a JAX fsdp-2 mesh write
    them."""
    from pretraining_llm_tpu.parallel.sharding import param_pspec

    meta = json.load(open(os.path.join(path, "metadata.json")))
    n = 0
    for entry in meta["manifest"]:
        parts = entry["name"].split("__")
        names = tuple(parts[2:]) if parts[0] == "opt" else tuple(parts[1:])
        if parts[0] not in ("params", "opt") or parts[-1] == "count":
            continue
        spec = tuple(param_pspec(names, len(entry["shape"]), shape=tuple(entry["shape"])))
        if "fsdp" not in spec:
            continue
        dim = spec.index("fsdp")
        arr = np.load(os.path.join(path, entry["name"] + ".npy"))
        half = arr.shape[dim] // 2
        for p in range(2):
            idx = [slice(None)] * arr.ndim
            idx[dim] = slice(p * half, (p + 1) * half)
            np.save(os.path.join(path, f"{entry['name']}.p{p}_0.npy"), arr[tuple(idx)])
            with open(os.path.join(path, f"{entry['name']}.p{p}_0.npy.idx"), "w") as f:
                json.dump([[s.start or 0, arr.shape[d] if s.stop is None else s.stop]
                           for d, s in enumerate(idx)], f)
        os.remove(os.path.join(path, entry["name"] + ".npy"))
        entry["sharded"] = True
        del entry["checksum"]
        n += 1
    meta["n_processes"] = 2
    json.dump(meta, open(os.path.join(path, "metadata.json"), "w"))
    return n


def test_jax_sharded_checkpoint_restores_in_the_port(ranks, tmp_path):
    ck = str(tmp_path / "jck")
    cfg = _config(train_steps=2, checkpoint_dir=ck, checkpoint_interval=0)
    JTrainer(cfg, synthetic_data=True, resume=False, logger=JMetricsLogger()).train()
    path = os.path.join(ck, "step-2")
    template = jax.eval_shape(lambda: jts.init_train_state(cfg, jax.random.key(0)))
    want = _flat_np(jckpt.load_checkpoint(path, template)[0])
    assert _shard_jax_checkpoint(path) >= 10
    np.testing.assert_equal(_flat_np(jckpt.load_checkpoint(path, template)[0]), want)
    got = _flat_port(tckpt.load_checkpoint(path, template)[0])  # one device
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    out = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                    overrides={"mesh.fsdp": 2}, steps=2)
    for r in out:
        assert r["start"] == 2
    for name, arr in want.items():
        _blocks_cover(out, arr, name)


def test_two_rank_kill_resume_equals_straight_run(ranks, tmp_path):
    cfg = _config(train_steps=6, checkpoint_interval=3)
    over = {"mesh.fsdp": 2}
    straight = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                         overrides={**over, "train.checkpoint_dir": str(tmp_path / "straight")}, resume=False,
                         eval_iters=2)
    resumed_dir = str(tmp_path / "resumed")
    part1 = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                      overrides={**over, "train.checkpoint_dir": resumed_dir}, steps=3, resume=False)
    assert [r["last"]["loss"] for r in part1][0] == part1[1]["last"]["loss"]
    for p in (0, 1):  # every rank wrote its data-sampler state
        assert os.path.exists(os.path.join(resumed_dir, "step-3", f"local.p{p}.json"))
    part2 = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                      overrides={**over, "train.checkpoint_dir": resumed_dir})
    assert [r["start"] for r in part2] == [3, 3]
    assert straight[0]["rows"] == [0, 4] and straight[1]["rows"] == [4, 8]
    for s, r in zip(straight, part2):
        assert r["last"]["loss"] == s["last"]["loss"] == straight[0]["last"]["loss"]
        for name, arr in s["state"].items():
            np.testing.assert_array_equal(r["state"][name], arr, err_msg=name)
    # The same run in one process (no mesh): the same losses and eval up
    # to summation order.
    one = tcfg.Config.from_dict(dataclasses.asdict(cfg)).with_overrides(
        {"train.checkpoint_dir": str(tmp_path / "one")})
    trainer = TTrainer(one, synthetic_data=True, resume=False, device="cpu",
                       logger=TMetricsLogger("", stream=io.StringIO()))
    last = trainer.train()
    np.testing.assert_allclose(straight[0]["last"]["loss"], last["loss"], rtol=1e-5)
    np.testing.assert_allclose(straight[0]["last"]["eval"], trainer.evaluate(2), rtol=1e-5)


def test_two_rank_asymmetric_sigterm_saves_one_common_step(ranks, tmp_path):
    ck = str(tmp_path / "preempt")
    cfg = _config(train_steps=20, checkpoint_interval=0, checkpoint_dir=ck)
    out = ranks.run("_torch_parallel_cases:trainer_run", cfg_dict=dataclasses.asdict(cfg),
                    overrides={"mesh.fsdp": 2, "train.log_interval": 2}, resume=False,
                    faults_on_rank=(1, "sigterm@3"))
    assert [r["exit_reason"] for r in out] == ["preempted", "preempted"]
    steps = sorted(os.listdir(ck))
    assert steps == ["step-4"], steps  # the log boundary after the signal, on both ranks
    for p in (0, 1):
        assert os.path.exists(os.path.join(ck, "step-4", f"local.p{p}.json"))
