"""The port's pipe axis with a MoE model, on 4 gloo ranks against the JAX
package's ``build_train_step`` on the same mesh shape (conftest's virtual
CPU devices), JAX's ``tests/test_pipeline.py`` fsdp and expert cases at 4
devices: the tiny preset at fp32, 4 layers, 2 experts (top 1, capacity
factor 1: choices are dropped), 2 pipeline microbatches, 2 AdamW steps,
``_torch_parallel_jax.check_against_jax``'s bars (loss rtol 1e-5, the
ranks' blocks against JAX's state rtol 1e-3 / atol 1e-4). The router's aux
loss flows out of the pipeline (summed over the stages, averaged over the
microbatches); under fsdp 2 x pipe 2 each global microbatch is split over
the fsdp ranks as in JAX (the ranks exchange token ids so that a rank
holds its part of every global microbatch), so the routing groups,
capacity drops and aux are the global microbatch's; expert 2 x pipe 2
splits the experts inside each stage."""

import dataclasses

import pytest
from _torch_parallel_jax import check_against_jax, jax_run, tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401

FSDP2_PIPE2 = (1, 2, 1, 1, 1, 2)
EXPERT2_PIPE2 = (1, 1, 1, 1, 2, 2)
MOE = dict(n_layers=4, pipeline_stages=2, pipeline_microbatches=2, n_experts=2, experts_per_token=1,
           expert_capacity_factor=1.0)


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


@pytest.mark.parametrize("sizes", [FSDP2_PIPE2, EXPERT2_PIPE2], ids=["fsdp2-pipe2-moe", "expert2-pipe2-moe"])
def test_pipe_composes_with_fsdp_and_experts(ranks, sizes):
    cfg = tiny_config(**MOE)
    params_np, x, y, metrics, flat = jax_run(cfg, sizes)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=sizes)
    check_against_jax(results, metrics, flat)
    name = "params/blocks/mlp/experts/w1"
    for r in results:
        block, sl = r["blocks"][name]
        assert sl[0] in ([0, 2], [2, 4])  # the pipe split of the layer dim
        assert block.shape != flat[name].shape[:1] + block.shape[1:]  # and another axis splits too
