"""The trainer options of the PyTorch port, against the JAX package where it
defines the behaviour.

``checkpoint_async`` writes what a synchronous save writes and resumes bit
for bit, and a failed write comes back at ``join_pending_save``; the step
profiler writes its window's trace and closes idempotently; ``debug_nans``
makes a poisoned step raise ``FloatingPointError``, as JAX's does;
``checked_loss`` reports the JAX function's three failures; mixture specs
draw the JAX iterator's batches and resume through ``state``/``set_state``;
the prefetched trainer (``data.prefetch``) gives the synchronous one's
losses and resumes as it does. Everything is compared exactly.
"""

import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.data import loader as jloader
from pretraining_llm_tpu.training import train_step as jts
from pretraining_llm_tpu.utils import debug as jdebug
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.data import loader as tloader
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.training import checkpoint as tckpt
from pretraining_llm_tpu_torch.training.metrics import MetricsLogger
from pretraining_llm_tpu_torch.training.trainer import Trainer
from pretraining_llm_tpu_torch.utils import debug as tdebug
from pretraining_llm_tpu_torch.utils.profiling import StepProfiler

PARITY = Path(__file__).resolve().parent.parent / "data" / "parity"


def _tiny(tmp_path, **train):
    base = dict(train_steps=6, checkpoint_interval=3, checkpoint_dir=str(tmp_path / "ck"), lr=1e-3,
                log_interval=1, eval_interval=0)
    return tcfg.get_preset("tiny").with_overrides({
        "model.compute_dtype": "float32", "data.prefetch": 0,
        **{f"train.{k}": v for k, v in dict(base, **train).items()},
    })


class _Records(MetricsLogger):
    def __init__(self):
        super().__init__("")
        self.records = []

    def log(self, record):
        self.records.append(dict(record))


def _train(cfg, resume=False, **kw):
    logger = _Records()
    t = Trainer(cfg, synthetic_data=True, resume=resume, logger=logger, device="cpu", **kw)
    t.train()
    return t, [r["loss"] for r in logger.records if "loss" in r]


def _leaves(path, template):
    state, extra = tckpt.load_checkpoint(path, template)
    return {n: t.numpy() for n, t in tckpt._flatten_with_names(state)}, extra


def _assert_same_params(a, b):
    for (name, x), (_, y) in zip(tckpt._flatten_with_names(a.state["params"]),
                                 tckpt._flatten_with_names(b.state["params"])):
        assert torch.equal(x, y), name


def test_async_checkpoint_equals_sync_and_resumes(tmp_path):
    sync, sync_losses = _train(_tiny(tmp_path / "sync"))
    cfg = _tiny(tmp_path / "async", checkpoint_async=True)
    full, losses = _train(cfg)
    assert losses == sync_losses
    for step in (3, 6):
        want, want_extra = _leaves(str(tmp_path / "sync" / "ck" / f"step-{step}"), sync.state)
        got, got_extra = _leaves(str(tmp_path / "async" / "ck" / f"step-{step}"), sync.state)
        assert want.keys() == got.keys() and got_extra["data_rng"] == want_extra["data_rng"]
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    shutil.rmtree(tmp_path / "async" / "ck" / "step-6")
    resumed, _ = _train(cfg, resume=True)
    _assert_same_params(resumed, full)


def test_async_write_error_surfaces_at_join(tmp_path, monkeypatch):
    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "save_checkpoint", fail)
    t = Trainer(_tiny(tmp_path, checkpoint_async=True), synthetic_data=True, resume=False,
                logger=_Records(), device="cpu")
    t.save(0)
    with pytest.raises(RuntimeError, match="async checkpoint write failed") as err:
        t.join_pending_save()
    assert isinstance(err.value.__cause__, OSError)
    t.join_pending_save()  # the error is reported once
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        t.train(3)  # a write at step 3 fails: train() raises when it joins


def test_step_profiler_writes_its_window_and_closes_idempotently(tmp_path):
    prof = StepProfiler(str(tmp_path / "p"), 1, 2)
    x = torch.randn(64, 64)
    for step in range(5):
        prof.step(step)
        x = torch.tanh(x @ x)
    assert os.listdir(tmp_path / "p") == ["trace-1-3.json"]
    events = json.loads((tmp_path / "p" / "trace-1-3.json").read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    prof.close()
    prof.close()
    # Closed mid-window (an exception in the loop): the trace is written.
    mid = StepProfiler(str(tmp_path / "q"), 0, 10)
    mid.step(0)
    torch.tanh(x)
    mid.close()
    mid.close()
    assert os.listdir(tmp_path / "q") == ["trace-0-10.json"]
    StepProfiler("", 0, 1).close()  # no logdir: nothing to do


def test_debug_nans_raises_like_jax(tmp_path):
    """A NaN in one weight: the JAX step under ``jax_debug_nans`` and the
    port's Trainer under ``train.debug_nans`` both raise
    ``FloatingPointError``; the port leaves the parameters untouched."""
    jc = jcfg.get_preset("tiny")
    state = jts.init_train_state(jc, jax.random.key(0))
    state["params"]["blocks"]["mlp"]["w1"] = state["params"]["blocks"]["mlp"]["w1"].at[0, 0, 0].set(jnp.nan)
    x = jnp.zeros((jc.train.batch_size, jc.model.context_length), jnp.int32)
    try:
        jdebug.enable_nan_checks()
        with pytest.raises(FloatingPointError):
            jts.build_train_step(jc)(state, (x, x))
    finally:
        jdebug.enable_nan_checks(False)
    cfg = _tiny(tmp_path, debug_nans=True)
    try:
        t = Trainer(cfg, synthetic_data=True, resume=False, logger=_Records(), device="cpu")
        t.state["params"]["blocks"]["mlp"]["w1"][0, 0, 0] = float("nan")
        before = {n: p.clone() for n, p in tckpt._flatten_with_names(t.state["params"])}
        with pytest.raises(FloatingPointError, match="non-finite"):
            t.train(2)
        for name, p in tckpt._flatten_with_names(t.state["params"]):
            assert torch.equal(p, before[name]) or name == "blocks__mlp__w1", name
        assert int(t.state["step"]) == 0
    finally:
        tdebug.enable_nan_checks(False)
    # Without the option the NaN step runs through.
    t = Trainer(_tiny(tmp_path / "off"), synthetic_data=True, resume=False, logger=_Records(), device="cpu")
    t.state["params"]["blocks"]["mlp"]["w1"][0, 0, 0] = float("nan")
    t.train(1)


@pytest.mark.parametrize("case", ["negative", "out_of_range", "non_finite", "ok"])
def test_checked_loss_fails_as_jax_does(case):
    jc = jcfg.get_preset("tiny").model
    tc = tcfg.get_preset("tiny").model
    from pretraining_llm_tpu.models import transformer as jtf

    jparams = jtf.init_params(jc, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(0).integers(0, jc.vocab_size, (2, jc.context_length)).astype(np.int32)
    if case == "negative":
        tokens[1, 3] = -1
    elif case == "out_of_range":
        tokens[0, 5] = jc.vocab_size
    elif case == "non_finite":
        tree["final_norm"]["scale"] = np.full_like(tree["final_norm"]["scale"], np.nan)
    targets = np.roll(tokens, -1, 1).clip(0, jc.vocab_size - 1)
    jerr, jloss = jdebug.checked_loss(jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), jnp.asarray(targets), jc)
    terr, tloss = tdebug.checked_loss(bridge.params_from_numpy(tree, tc, device="cpu"),
                                      torch.from_numpy(tokens).long(), torch.from_numpy(targets).long(), tc)
    if case == "ok":
        assert jerr.get() is None and terr.get() is None
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * float(jloss)
        terr.throw()
        return
    assert terr.get() is not None and terr.get() in jerr.get()
    with pytest.raises(RuntimeError, match=terr.get()):
        terr.throw()


def test_mixture_batches_and_resume_match_jax():
    spec = f"{PARITY / 'train.bin'}:3,{PARITY / 'val.bin'}:1"
    assert tloader.parse_mixture(spec) == jloader.parse_mixture(spec)
    assert tloader.parse_mixture("a.bin,c:/b.bin:2") == jloader.parse_mixture("a.bin,c:/b.bin:2")
    for bad in ("a.bin:", ",", ":3"):
        with pytest.raises(ValueError):
            tloader.parse_mixture(bad)
        with pytest.raises(ValueError):
            jloader.parse_mixture(bad)
    jit_, tit = (m.get_batch_iterator(spec, 8, 128, seed=5) for m in (jloader, tloader))
    assert isinstance(tit, tloader.MixtureIterator)
    for _ in range(3):
        for a, b in zip(next(jit_), next(tit)):
            np.testing.assert_array_equal(a, b)
    saved = json.loads(json.dumps(tit.state()))
    want = [next(jit_) for _ in range(2)]
    fresh = tloader.get_batch_iterator(spec, 8, 128, seed=99)
    fresh.set_state(saved)
    for w, g in zip(want, (next(fresh) for _ in range(2))):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)


def test_prefetcher_gives_the_synchronous_batches_and_frontier():
    source = tloader.synthetic_iterator(97, 16, 4, seed=3)
    ref = tloader.synthetic_iterator(97, 16, 4, seed=3)
    feed = tloader.DevicePrefetcher(source, lambda b: (b, None), depth=2)
    for _ in range(3):
        got, want = next(feed), next(ref)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert feed.state() == ref.state()  # the consumed frontier, not the source's
    assert feed.close()


def test_prefetched_trainer_matches_synchronous_and_resumes(tmp_path):
    sync, sync_losses = _train(_tiny(tmp_path / "sync"))
    cfg = _tiny(tmp_path / "pre").with_overrides({"data.prefetch": 2})
    full, losses = _train(cfg)
    assert losses == sync_losses
    _assert_same_params(full, sync)
    shutil.rmtree(tmp_path / "pre" / "ck" / "step-6")
    resumed, resumed_losses = _train(cfg, resume=True)
    assert resumed_losses == sync_losses[3:]
    _assert_same_params(resumed, sync)
    # A second train() call continues the stream where the first stopped.
    t = Trainer(cfg.with_overrides({"train.checkpoint_dir": str(tmp_path / "two")}), synthetic_data=True,
                resume=False, logger=_Records(), device="cpu")
    t.train(3)
    t.train(6)
    _assert_same_params(t, sync)
