"""A MoE model with ring attention in the zigzag layout over seq 2 (x
expert 2), on 4 gloo ranks against the JAX package's ``build_train_step``
on the same mesh shape (conftest's virtual CPU devices): the routing
groups are cut in the permuted token order the model sees, as in JAX, with
capacity drops; the bars of ``_torch_parallel_jax.check_against_jax``
(loss rtol 1e-5, grad norm rtol 1e-4, the ranks' blocks after 2 steps rtol
1e-3 / atol 1e-4)."""

import dataclasses

import pytest
from _torch_parallel_jax import check_against_jax, jax_run, tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401

SEQ_EXPERT = (1, 1, 1, 2, 2, 1)
MOE = dict(n_experts=4, experts_per_token=2)


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


def test_moe_with_zigzag_ring_attention_matches_jax(ranks):
    """A MoE model with ring attention in the zigzag layout over seq 2 (x
    expert 2): the routing groups follow the permuted token order, as in
    JAX."""
    cfg = tiny_config(**MOE, attention_impl="ring", ring_layout="zigzag", sequence_parallel=True, pos_embed="rope",
                      expert_capacity_factor=1.0, moe_group_size=64)
    params_np, x, y, metrics, flat = jax_run(cfg, SEQ_EXPERT)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg), params_np=params_np,
                        x=x, y=y, sizes=SEQ_EXPERT)
    check_against_jax(results, metrics, flat)
