"""The port's mesh train step on 4 gloo ranks against the JAX package's
``build_train_step(cfg, mesh)`` on the same mesh shape (conftest's virtual
CPU devices): (data 2, fsdp 2), and (fsdp 2, seq 2) with Ulysses attention
and sequence parallelism. Tiny preset, 2 layers, fp32, 2 AdamW steps: the
loss within rtol 1e-5 at each step, the parameters and AdamW's moments
assembled from the ranks' blocks within rtol 1e-3 / atol 1e-4. Each fsdp
rank holds 1/n of every sharded leaf, as JAX's
``test_fsdp_actually_shards_params`` checks. The ring cases are in
``test_torch_parallel_train_ring.py``."""

import dataclasses

import pytest
from _torch_parallel_jax import check_against_jax, jax_run, tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


@pytest.mark.parametrize("sizes,model", [
    ((2, 2, 1, 1, 1, 1), {}),
    ((1, 2, 1, 2, 1, 1), dict(attention_impl="ulysses", sequence_parallel=True, pos_embed="rope")),
], ids=["data2-fsdp2", "fsdp2-seq2-ulysses"])
def test_train_steps_match_jax_mesh(ranks, sizes, model):
    cfg = tiny_config(**model)
    params_np, x, y, metrics, flat = jax_run(cfg, sizes)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=sizes)
    check_against_jax(results, metrics, flat)
    # Each fsdp rank holds half of w1's D rows, and the moments match it.
    d = cfg.model.d_model
    for r in results:
        w1, sl = r["blocks"]["params/blocks/mlp/w1"]
        assert w1.shape[1] == d // 2 and sl[1][1] - sl[1][0] == d // 2
        assert r["blocks"]["opt/mu/blocks/mlp/w1"][0].shape == w1.shape
        ln, _ = r["blocks"]["params/blocks/ln1/scale"]
        assert ln.shape == (cfg.model.n_layers, d)  # replicated


def test_compile_only_reports_a_ranks_blocks(ranks):
    """``train --compile-only`` on a mesh sizes one rank: its blocks of the
    state (the bytes of JAX's per-device shard shapes on the same mesh)
    and its rows of the batch."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from pretraining_llm_tpu.training import train_step as jts

    sizes = (2, 2, 1, 1, 1, 1)
    cfg = tiny_config()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(sizes), ("data", "fsdp", "tensor", "seq", "expert", "pipe"))
    shapes = jax.eval_shape(lambda: jts.init_train_state(cfg, jax.random.key(0)))
    specs = jts.state_pspec_tree(shapes)
    want = sum(int(np.prod(NamedSharding(mesh, spec).shard_shape(leaf.shape))) * leaf.dtype.itemsize
               for spec, leaf in zip(jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec)),
                                     jax.tree.leaves(shapes)))
    got = ranks.run("_torch_parallel_cases:compile_only_sizes", cfg_dict=dataclasses.asdict(cfg), sizes=sizes)
    for r in got:
        assert r["state"] == want
        assert r["batch"] == 2 * (cfg.train.batch_size // 4) * cfg.model.context_length * 4
