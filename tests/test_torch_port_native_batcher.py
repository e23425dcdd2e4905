"""The port's native batch gatherer (``pretraining_llm_tpu_torch/data/
native_batcher.py``, built from ``csrc/batcher.cpp``) against the JAX
package's (``pretraining_llm_tpu/data/native_batcher.py``), and the
trainer's choice of sampler.

Batch for batch equal to JAX's at several seeds, sizes and shards; its state
(one counter) round-trips in both directions; the thread pool gives the
single thread's batches; a trainer on a token file samples through it (and
evaluates through it, as the JAX trainer does), resumes exactly from its
counter, and takes the numpy sampler for a mixture, with the flag off, when
the library cannot be built, or when a checkpoint of the other sampler is
resumed (which starts that stream afresh, as JAX does).
"""

from pathlib import Path

import numpy as np
import pytest

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.data.native_batcher import NativeBatchIterator as JNative
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.data import _native, loader as tloader
from pretraining_llm_tpu_torch.data import native_batcher
from pretraining_llm_tpu_torch.data.native_batcher import NativeBatchIterator
from pretraining_llm_tpu_torch.training import optimizer as topt
from pretraining_llm_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
PARITY_TRAIN = str(ROOT / "data" / "parity" / "train.bin")  # bytes: the tiny preset's vocabulary


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    tokens = np.random.default_rng(0).integers(0, 60000, size=100_000, dtype=np.uint16)
    path = tmp_path_factory.mktemp("tokens") / "train.bin"
    tokens.tofile(path)
    return str(path), tokens


@pytest.mark.parametrize("batch,t,seed,shard", [(8, 32, 1, (0, 1)), (3, 257, 1337, (0, 1)), (16, 64, 7, (1, 3)),
                                                (4, 1024, 0, (2, 3))])
def test_batches_equal_jax_s(token_file, batch, t, seed, shard):
    path, tokens = token_file
    got = NativeBatchIterator(path, batch, t, seed=seed, shard_index=shard[0], shard_count=shard[1])
    want = JNative(path, batch, t, seed=seed, shard_index=shard[0], shard_count=shard[1])
    assert got.n_tokens == want.n_tokens
    flat = tokens.astype(np.int32)
    for _ in range(4):
        (x, y), (wx, wy) = next(got), next(want)
        assert x.dtype == np.int32 and x.shape == (batch, t)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
        np.testing.assert_array_equal(x[:, 1:], y[:, :-1])  # y is x shifted by one
    row = x[0]
    starts = np.nonzero(flat[: len(flat) - t] == row[0])[0]
    assert any(np.array_equal(flat[s:s + t], row) for s in starts)  # a verbatim window


def test_state_round_trips_with_jax(token_file):
    path, _ = token_file
    a, b = NativeBatchIterator(path, 4, 16, seed=7), JNative(path, 4, 16, seed=7)
    for _ in range(3):
        next(a)
    assert a.state() == {"native_counter": 3, "seed": 7}
    b.set_state(a.state())
    np.testing.assert_array_equal(next(a)[0], next(b)[0])
    c = NativeBatchIterator(path, 4, 16, seed=99)
    c.set_state(b.state())
    np.testing.assert_array_equal(next(c)[0], next(b)[0])
    c.set_state({"bit_generator": {}})  # the numpy sampler's state: ignored, as in JAX
    assert c.counter == 5 and c.seed == 7


def test_threads_give_the_single_thread_s_batches(tmp_path):
    """Big enough that the pool fans out (batch x T >= threads x 2^20)."""
    path = tmp_path / "big.bin"
    np.random.default_rng(1).integers(0, 50000, size=300_000, dtype=np.uint16).tofile(path)
    one = NativeBatchIterator(str(path), 64, 32768, seed=3, n_threads=1)
    two = NativeBatchIterator(str(path), 64, 32768, seed=3, n_threads=2)
    jax_two = JNative(str(path), 64, 32768, seed=3, n_threads=2)
    for _ in range(2):
        (x1, y1), (x2, y2), (x3, _) = next(one), next(two), next(jax_two)
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)
        np.testing.assert_array_equal(x1, x3)


def test_too_small_a_file_is_refused(tmp_path):
    path = tmp_path / "tiny.bin"
    np.arange(8, dtype=np.uint16).tofile(path)
    with pytest.raises(ValueError, match="could not open"):
        NativeBatchIterator(str(path), 1, 64)


def test_build_writes_only_under_build(tmp_path, monkeypatch):
    """Built from the port's copy of the source into ``build/native/``."""
    assert _native.library_path("batcher").parent == ROOT / "build" / "native"
    assert (ROOT / "pretraining_llm_tpu_torch" / "csrc" / "batcher.cpp").exists()
    build_dir = tmp_path / "build" / "native"
    monkeypatch.setattr(_native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_native, "_cache", {})
    lib, why = native_batcher.load_library()
    assert lib is not None, why
    assert why.startswith("native (libbatcher-")
    assert [p.name for p in build_dir.iterdir() if not p.name.startswith(".")] == [
        _native.library_path("batcher").name]


def _cfg(tmp_path, path, **over):
    return tcfg.get_preset("tiny").with_overrides({
        "model.compute_dtype": "float32", "data.train_path": path,
        "data.val_path": path, "train.train_steps": 6, "train.checkpoint_interval": 3, "train.eval_interval": 0,
        "train.eval_iters": 2, "train.log_interval": 3, "train.checkpoint_dir": str(tmp_path / "ck"), **over})


def test_trainer_samples_evaluates_and_resumes_through_it(tmp_path):
    path = PARITY_TRAIN
    cfg = _cfg(tmp_path, path)
    t = Trainer(cfg, resume=False, device="cpu")
    assert t.sampler == "native" and isinstance(t.train_iterator, NativeBatchIterator)
    assert isinstance(t._fresh_val_iterator(), NativeBatchIterator)  # eval batches too, as in JAX
    want = JNative(path, cfg.train.batch_size, cfg.model.context_length, seed=cfg.data.sample_seed)
    np.testing.assert_array_equal(next(iter(t._make_iterator(path, cfg.data.sample_seed)))[0], next(want)[0])
    t.train()
    final = {k: v.clone() for k, v in topt.tree_leaves(t.state["params"])}
    assert t.train_iterator.state() == {"native_counter": 6, "seed": cfg.data.sample_seed}
    import shutil

    shutil.rmtree(tmp_path / "ck" / "step-6")
    t2 = Trainer(cfg, resume=True, device="cpu")
    assert t2.start_step == 3 and t2.train_iterator.counter == 3
    t2.train()
    for k, v in topt.tree_leaves(t2.state["params"]):
        assert bool((v == final[k]).all()), k


@pytest.mark.parametrize("case", ["mixture", "flag_off", "no_library"])
def test_trainer_takes_the_numpy_sampler(tmp_path, monkeypatch, case):
    path = PARITY_TRAIN
    over = {}
    if case == "mixture":
        over["data.train_path"] = f"{path}:3,{path}:1"
    elif case == "flag_off":
        over["data.use_native_batcher"] = False
    else:
        monkeypatch.setattr(native_batcher, "load_library", lambda: (None, "no compiler"))
    t = Trainer(_cfg(tmp_path, path, **over), resume=False, device="cpu")
    assert t.sampler == "numpy"
    assert isinstance(t.train_iterator, (tloader.BatchIterator, tloader.MixtureIterator))


def test_a_checkpoint_of_the_other_sampler_starts_the_stream_afresh(tmp_path):
    """Written under the numpy sampler, resumed under the native one (and
    back): the saved state belongs to the other backend, so the stream
    starts from its beginning, as the JAX trainer's does."""
    path = PARITY_TRAIN
    numpy_cfg = _cfg(tmp_path, path, **{"data.use_native_batcher": False, "train.train_steps": 3})
    Trainer(numpy_cfg, resume=False, device="cpu").train()
    native = Trainer(_cfg(tmp_path, path, **{"train.train_steps": 5}), resume=True, device="cpu")
    assert native.start_step == 3 and native.sampler == "native" and native.train_iterator.counter == 0
    native.train()
    back = Trainer(numpy_cfg.with_overrides({"train.train_steps": 7}), resume=True, device="cpu")
    fresh = tloader.get_batch_iterator(path, 8, numpy_cfg.model.context_length, seed=numpy_cfg.data.sample_seed)
    assert back.start_step == 5 and back.train_iterator.state() == fresh.state()
