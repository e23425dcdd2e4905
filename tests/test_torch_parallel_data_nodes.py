"""File data on several nodes: 2 gloo ranks, each its own node
(``LOCAL_WORLD_SIZE=1``), train the port's ``Trainer`` on data 2 from
``data/parity``'s token files. Each node samples its contiguous shard of
the token stream (plus ``context_length`` tokens of overlap) with the seed
``sample_seed + 7919 * node``, batch for batch as the JAX package's
samplers do for a JAX process with ``shard_index`` = the node and
``shard_count`` = 2: the numpy sampler (``get_batch_iterator``) and, where
it builds, the native one (``NativeBatchIterator``), for the train batches
and the eval set alike; each rank's rows are its node's whole batch."""

import dataclasses
import os

import numpy as np
import pytest
from _torch_ranks import ROOT, RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401

from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.data import loader as jloader
from pretraining_llm_tpu.data import native_batcher as jnative

TRAIN = str(ROOT / "data" / "parity" / "train.bin")
VAL = str(ROOT / "data" / "parity" / "val.bin")
EVAL_SEED_OFFSET = 104729  # the trainers' eval seed offset


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(2)
    yield group
    group.close()


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_each_node_samples_its_shard_as_jax(ranks, tmp_path, native):
    if native and not jnative.native_available():
        pytest.skip("the JAX package's native batcher does not build here")
    cfg = jcfg.get_preset("tiny")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=8, checkpoint_dir=str(tmp_path)))
    over = {"mesh.data": 2, "data.train_path": TRAIN, "data.val_path": VAL, "data.use_native_batcher": native}
    results = ranks.run("_torch_parallel_cases:node_batches", cfg_dict=dataclasses.asdict(cfg), overrides=over)
    t, seed = cfg.model.context_length, cfg.data.sample_seed
    for r, got in enumerate(results):
        assert (got["node"], got["nodes"], got["rows"]) == (r, 2, [0, 4])
        assert got["sampler"] == ("native" if native else "numpy")
        kw = dict(seed=seed, shard_index=r, shard_count=2)
        want = (jnative.NativeBatchIterator(TRAIN, 4, t, **kw) if native
                else jloader.get_batch_iterator(TRAIN, 4, t, **kw))
        for batch in got["train"]:
            for a, b in zip(batch, next(want)):
                np.testing.assert_array_equal(a, b)
        kw["seed"] = seed + EVAL_SEED_OFFSET
        want_val = (jnative.NativeBatchIterator(VAL, 4, t, **kw) if native
                    else jloader.get_batch_iterator(VAL, 4, t, **kw))
        for a, b in zip(got["val"], next(want_val)):
            np.testing.assert_array_equal(a, b)
    # The two nodes read different shards.
    assert not np.array_equal(results[0]["train"][0][0], results[1]["train"][0][0])
    assert os.path.getsize(TRAIN) // 2 > 2 * (t + 1)
