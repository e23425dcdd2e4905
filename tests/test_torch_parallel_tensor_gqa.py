"""The port's tensor axis with grouped KV heads and swiglu on 4 gloo
ranks against the JAX package's ``build_train_step(cfg, mesh)`` on the
same mesh shape (conftest's virtual CPU devices), at
``test_torch_parallel_tensor.py``'s bars: RoPE with grouped KV heads that
divide tp (fsdp 2, tensor 2), grouped KV heads that do not, so that
``wkv`` is replicated and each rank takes its heads' K/V (data 2, tensor
2: G 3 on tp 2), and swiglu with RMSNorm and an untied head (fsdp 2,
tensor 2). ``train --compile-only`` sizes one rank's blocks on a tensor
and on an expert mesh as JAX's per-device shard shapes."""

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


FSDP_TP = (1, 2, 2, 1, 1, 1)
DATA_TP = (2, 1, 2, 1, 1, 1)
MODELS = {
    "rope-gqa": dict(pos_embed="rope", n_heads=8, n_kv_heads=2),
    "gqa-replicated-wkv": dict(pos_embed="rope", n_heads=6, n_kv_heads=3, d_model=48),
    "swiglu": dict(activation="swiglu", norm="rmsnorm", tie_embeddings=False, mlp_bias=False, qkv_bias=False),
}


@pytest.mark.parametrize("sizes,model", [
    (FSDP_TP, "rope-gqa"), (DATA_TP, "gqa-replicated-wkv"), (FSDP_TP, "swiglu"),
], ids=["fsdp2-tensor2-gqa", "data2-tensor2-gqa-g3", "fsdp2-tensor2-swiglu"])
def test_tensor_train_steps_match_jax_mesh(ranks, sizes, model):
    cfg = tiny_config(**MODELS[model])
    params_np, x, y, metrics, flat = jax_run(cfg, sizes)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=sizes)
    check_against_jax(results, metrics, flat)
    m = cfg.model
    for r in results:
        wo, sl = r["blocks"]["params/blocks/attn/wo"]
        assert wo.shape[1] == m.n_heads // 2 and sl[1][1] - sl[1][0] == m.n_heads // 2
        w2, _ = r["blocks"]["params/blocks/mlp/w2"]
        assert w2.shape[1] == m.d_ff // 2
        emb, _ = r["blocks"]["params/tok_embed/embedding"]
        assert emb.shape[0] == m.vocab_size // 2
        if model == "gqa-replicated-wkv":  # G 3 on tp 2: every rank holds all KV heads
            assert r["blocks"]["params/blocks/attn/wkv"][0].shape[3] == m.kv_heads


@pytest.mark.parametrize("sizes,model", [(FSDP_TP, {}), ((1, 1, 1, 1, 4, 1), dict(n_experts=4))],
                         ids=["fsdp2-tensor2", "expert4"])
def test_compile_only_reports_a_ranks_tensor_and_expert_blocks(ranks, sizes, model):
    """``train --compile-only`` on a tensor or expert mesh sizes one rank:
    the bytes of JAX's per-device shard shapes on the same mesh, and the
    rows of its data x fsdp block."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from pretraining_llm_tpu.training import train_step as jts

    cfg = tiny_config(**model)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(sizes), ("data", "fsdp", "tensor", "seq", "expert", "pipe"))
    shapes = jax.eval_shape(lambda: jts.init_train_state(cfg, jax.random.key(0)))
    specs = jts.state_pspec_tree(shapes, tensor_size=sizes[2])
    want = sum(int(np.prod(NamedSharding(mesh, spec).shard_shape(leaf.shape))) * leaf.dtype.itemsize
               for spec, leaf in zip(jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec)),
                                     jax.tree.leaves(shapes)))
    got = ranks.run("_torch_parallel_cases:compile_only_sizes", cfg_dict=dataclasses.asdict(cfg), sizes=sizes)
    rows = cfg.train.batch_size // (sizes[0] * sizes[1])
    for r in got:
        assert r["state"] == want
        assert r["batch"] == 2 * rows * cfg.model.context_length * 4
