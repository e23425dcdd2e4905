"""Checkpoints and the trainer of the PyTorch port, against the JAX package.

A checkpoint written by the JAX package restores in the port (and the next
train step matches the JAX package's), a checkpoint written by the port
loads with the JAX ``load_checkpoint``, bf16 leaves are written byte for
byte as the JAX package writes them, a corrupt newest step falls back to
the previous one, retention keeps the newest K, and a resumed ``Trainer``
reproduces the uninterrupted run bit for bit (``tests/test_training.py``'s
resume test, on the port). Tolerances: the step after a restore within
1e-5 (loss relative, params max-abs) of the JAX package's; everything read
back from a checkpoint exactly.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.training import checkpoint as jckpt
from pretraining_llm_tpu.training import train_step as jts
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch import train as tcli
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.training import checkpoint as tckpt
from pretraining_llm_tpu_torch.training import optimizer as topt
from pretraining_llm_tpu_torch.training import train_step as tts
from pretraining_llm_tpu_torch.training.metrics import MetricsLogger
from pretraining_llm_tpu_torch.training.trainer import Trainer
from pretraining_llm_tpu_torch.utils import debug as tdebug

MODEL = dict(
    vocab_size=97, context_length=32, d_model=32, n_heads=4, n_layers=2,
    activation="gelu", norm="layernorm", pos_embed="learned",
    tie_embeddings=True, qkv_bias=False, mlp_bias=True,
    compute_dtype="float32", attention_impl="flash",
)
TRAIN = dict(batch_size=4, lr=1e-3, train_steps=10, warmup_frac=0.2)
TOL = 1e-5


def _configs():
    jc = jcfg.Config(model=jcfg.ModelConfig(**MODEL), train=jcfg.TrainConfig(**TRAIN))
    tc = tcfg.Config(model=tcfg.ModelConfig(**MODEL), train=tcfg.TrainConfig(**TRAIN))
    return jc, tc


def _batch(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, MODEL["vocab_size"], (4, MODEL["context_length"] + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _leaves_np(tree):
    """{name: numpy} of a port or JAX state, named as the checkpoints name
    their leaves."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return {n: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
                for n, t in tckpt._flatten_with_names(tree)}
    return {jckpt._leaf_name(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_state_after(jc, steps):
    state = jts.init_train_state(jc, jax.random.key(3))
    step = jts.build_train_step(jc)
    for i in range(steps):
        x, y = _batch(100 + i)
        state, _ = step(state, (jnp.asarray(x), jnp.asarray(y)))
    return state, step


def test_jax_checkpoint_restores_in_port_and_next_step_matches(tmp_path):
    jc, tc = _configs()
    jstate, jstep = _jax_state_after(jc, 2)
    path = jckpt.save_checkpoint(str(tmp_path), 2, jstate, extra={"step": 2},
                                 local_extra={"data_rng": {"bit_generator": "x"}})
    template = tts.init_train_state(tc, 0, device="cpu")
    state, extra = tckpt.load_checkpoint(path, template)
    assert extra["step"] == 2 and extra["data_rng"] == {"bit_generator": "x"}
    want = _leaves_np(jax.device_get(jstate))
    got = _leaves_np(state)
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_array_equal(want[name], got[name], err_msg=name)
    assert state["step"].dtype == torch.int32 and state["opt"]["count"].dtype == torch.int32

    x, y = _batch(200)
    jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
    state, tm = tts.build_train_step(tc)(state, (torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * float(jm["loss"])
    want, got = _leaves_np(jax.device_get(jstate["params"])), _leaves_np(state["params"])
    for name in want:
        assert float(np.abs(want[name] - got[name]).max()) <= TOL, name


def test_port_checkpoint_loads_in_jax(tmp_path):
    jc, tc = _configs()
    state = tts.init_train_state(tc, 5, device="cpu")
    step = tts.build_train_step(tc)
    for i in range(2):
        x, y = _batch(300 + i)
        state, _ = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    path = tckpt.save_checkpoint(str(tmp_path), 2, state, extra={"step": 2})
    template = jax.eval_shape(lambda: jts.init_train_state(jc, jax.random.key(0)))
    jstate, extra = jckpt.load_checkpoint(path, template)
    assert extra["step"] == 2
    want, got = _leaves_np(state), _leaves_np(jstate)
    assert want.keys() == got.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(want[name], got[name], err_msg=name)


def test_bf16_leaf_is_written_as_the_jax_package_writes_it(tmp_path):
    values = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(values, jnp.bfloat16), "b": jnp.asarray(values[0])}
    ttree = {"w": torch.from_numpy(values).to(torch.bfloat16), "b": torch.from_numpy(values[0])}
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 1, jtree)
    tpath = tckpt.save_checkpoint(str(tmp_path / "port"), 1, ttree)
    for name in ("w", "b"):
        with open(os.path.join(jpath, f"{name}.npy"), "rb") as a, open(os.path.join(tpath, f"{name}.npy"), "rb") as b:
            assert a.read() == b.read(), name
    jmeta = json.load(open(os.path.join(jpath, "metadata.json")))
    tmeta = json.load(open(os.path.join(tpath, "metadata.json")))
    assert jmeta["manifest"] == tmeta["manifest"]
    assert jmeta["format_version"] == tmeta["format_version"] == 2
    for path in (jpath, tpath):
        got, _ = tckpt.load_checkpoint(path, ttree)
        assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], ttree["w"])
        assert torch.equal(got["b"], ttree["b"])


def test_corrupt_newest_step_falls_back(tmp_path):
    _, tc = _configs()
    state = tts.init_train_state(tc, 0, device="cpu")
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 1, state)
    newer = topt.tree_map(lambda x: x + 1, state)
    tckpt.save_checkpoint(d, 2, newer)
    os.makedirs(os.path.join(d, "tmp-3"))  # a partial write of a killed run
    leaf = os.path.join(d, "step-2", "params__blocks__mlp__w1.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0xFF  # one flipped byte: the file still parses
    open(leaf, "wb").write(bytes(raw))
    skipped = []
    restored = tckpt.restore_latest(d, state, on_skip=lambda p, e: skipped.append((p, e)))
    assert restored is not None
    got, _, step = restored
    assert step == 1 and len(skipped) == 1 and isinstance(skipped[0][1], tckpt.IntegrityError)
    assert torch.equal(got["params"]["blocks"]["mlp"]["w1"], state["params"]["blocks"]["mlp"]["w1"])
    assert not os.path.exists(os.path.join(d, "tmp-3"))
    os.remove(os.path.join(d, "step-1", "metadata.json"))
    assert tckpt.restore_latest(d, state) is None


def test_retention_and_shape_mismatch(tmp_path):
    _, tc = _configs()
    state = tts.init_train_state(tc, 0, device="cpu")
    for s in (1, 2, 3, 4):
        tckpt.save_checkpoint(str(tmp_path), s, state, keep=2)
    assert sorted(tckpt._list_steps(str(tmp_path))) == [3, 4]
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith("step-4")
    bigger = tcfg.Config(model=tcfg.ModelConfig(**dict(MODEL, d_model=64)), train=tc.train)
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_checkpoint(tckpt.latest_checkpoint(str(tmp_path)),
                              tts.init_train_state(bigger, 0, device="cpu"))


def _tiny(tmp_path, **train):
    return tcfg.get_preset("tiny").with_overrides({
        "model.compute_dtype": "float32",
        **{f"train.{k}": v for k, v in dict(dict(train_steps=10, checkpoint_interval=5,
                                                  checkpoint_dir=str(tmp_path / "ck"), lr=1e-3,
                                                  log_interval=5), **train).items()},
    })


def test_trainer_resume_is_exact(tmp_path):
    """Mirrors ``test_training.py``'s exact-resume test: a run resumed from
    step 5 reproduces the uninterrupted run's final params bit for bit
    (same batches through the saved sampler RNG)."""
    cfg = _tiny(tmp_path)
    logger = MetricsLogger()
    t1 = Trainer(cfg, synthetic_data=True, resume=False, logger=logger, device="cpu")
    t1.train()
    final_a = _leaves_np(t1.state["params"])
    latest = tckpt.latest_checkpoint(str(tmp_path / "ck"))
    assert latest is not None and latest.endswith("step-10")
    shutil.rmtree(latest)
    t2 = Trainer(cfg, synthetic_data=True, resume=True, logger=logger, device="cpu")
    assert t2.start_step == 5 and int(t2.state["step"]) == 5
    t2.train()
    final_b = _leaves_np(t2.state["params"])
    for name in final_a:
        np.testing.assert_array_equal(final_a[name], final_b[name], err_msg=name)


def test_trainer_eval_metrics_and_cli(tmp_path, capsys):
    cfg = _tiny(tmp_path, train_steps=6, eval_interval=3, eval_iters=2, log_interval=2,
                checkpoint_interval=0, metrics_path=str(tmp_path / "m.jsonl"))
    t = Trainer(cfg, synthetic_data=True, resume=False, device="cpu")
    last = t.train()
    assert {"loss", "grad_norm", "lr", "val_loss", "step_ms", "tokens_per_sec"} <= set(last)
    assert "mfu" not in last  # no peak for a CPU: no guessed MFU
    lines = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r["step"] for r in lines if "loss" in r] == [2, 4, 6]
    assert [r["step"] for r in lines if "val_loss" in r] == [3, 6]
    assert t.evaluate() == t.evaluate()  # the same eval batches every call
    assert tckpt.latest_checkpoint(str(tmp_path / "ck")).endswith("step-6")  # save_final

    final = tcli.main(["--preset", "tiny", "--data", "synthetic", "--device", "cpu", "--steps", "2",
                       "--no-resume", "--override", f"train.checkpoint_dir={tmp_path / 'cli'}",
                       "train.log_interval=1", "train.save_final=False"])
    assert final["loss"] > 0 and "step 2" in capsys.readouterr().out
    # --compile-only is ported: the JAX script's JSON line, and no step runs.
    report = tcli.main(["--preset", "tiny", "--device", "cpu", "--compile-only"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert set(report) == {"compile_s", "devices", "per_device_GiB"}


@pytest.mark.parametrize("key,value", [("train.checkpoint_async", True), ("train.profile_dir", "p"),
                                       ("train.debug_nans", True)])
def test_trainer_refuses_unported_options(tmp_path, key, value):
    """These options were refused before they were ported; now the Trainer
    takes each and does what it asks: an async save writes the synchronous
    save's bytes, the profiler writes its window's trace, and NaN checks
    are on for the step."""
    if key == "train.profile_dir":
        value = str(tmp_path / value)
    cfg = _tiny(tmp_path, train_steps=4, checkpoint_interval=4, profile_start=1, profile_steps=2,
                save_final=False).with_overrides({key: value})
    try:
        t = Trainer(cfg, synthetic_data=True, resume=False, device="cpu")
        t.train()
        if key == "train.debug_nans":
            assert tdebug.nan_checks_enabled()
    finally:
        tdebug.enable_nan_checks(False)
    if key == "train.profile_dir":
        assert os.listdir(value) == ["trace-1-3.json"]
    ref = Trainer(_tiny(tmp_path / "ref", train_steps=4, checkpoint_interval=4, save_final=False),
                  synthetic_data=True, resume=False, device="cpu")
    ref.train()
    got, want = (_leaves_np(tckpt.load_checkpoint(tckpt.latest_checkpoint(str(d)), ref.state)[0])
                 for d in (tmp_path / "ck", tmp_path / "ref" / "ck"))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_config_overrides():
    cfg = tcfg.get_preset("gpt2-124m")
    assert (cfg.train.batch_size, cfg.train.train_steps, cfg.train.lr) == (12, 5000, 6e-4)
    assert (cfg.train.eval_interval, cfg.train.eval_iters) == (250, 20)
    assert cfg.with_overrides({"train.lr": 1e-4}).train.lr == 1e-4
    with pytest.raises(KeyError, match="unknown config key"):
        cfg.with_overrides({"train.nope": 1})
    with pytest.raises(KeyError, match="unknown config section"):
        cfg.with_overrides({"nope.x": 1})
    assert cfg.with_overrides({"mesh.fsdp": 2}).mesh == tcfg.MeshConfig(fsdp=2)
    with pytest.raises(KeyError, match="unknown config key mesh.nope"):
        cfg.with_overrides({"mesh.nope": 2})
    with pytest.raises(ValueError, match="grad_dtype"):
        tcfg.TrainConfig(grad_dtype="int8")
    with pytest.raises(ValueError, match="microbatches"):
        tcfg.TrainConfig(batch_size=6, microbatches=4)
