"""The port's expert axis on 4 gloo ranks against the JAX package on the
same mesh shape (conftest's virtual CPU devices), the tiny preset with 4
experts, top-2, at 2 layers and fp32:

- ``build_train_step(cfg, mesh)``, 2 AdamW steps, at (expert 4) and (data
  2, expert 2) with ample capacity (``test_moe.py``'s mesh-invariance
  case), at (data 2, expert 2) with capacity drops, and at (expert 2,
  tensor 2): loss rtol 1e-5 per step, the parameters and moments from the
  ranks' blocks rtol 1e-3 / atol 1e-4. Each expert rank holds E/ep
  experts.
The routing cases are in ``test_torch_parallel_expert_routing.py``.
"""

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


EXPERT4 = (1, 1, 1, 1, 4, 1)
DATA_EXPERT = (2, 1, 1, 1, 2, 1)
EXPERT_TP = (1, 1, 2, 1, 2, 1)
MOE = dict(n_experts=4, experts_per_token=2)


@pytest.mark.parametrize("sizes,capacity", [
    (EXPERT4, 4.0), (DATA_EXPERT, 4.0), (DATA_EXPERT, 1.0), (EXPERT_TP, 4.0),
], ids=["expert4", "data2-expert2", "data2-expert2-drops", "expert2-tensor2"])
def test_expert_train_steps_match_jax_mesh(ranks, sizes, capacity):
    cfg = tiny_config(**MOE, expert_capacity_factor=capacity)
    params_np, x, y, metrics, flat = jax_run(cfg, sizes)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=sizes)
    check_against_jax(results, metrics, flat)
    ep = sizes[4]
    for r in results:
        w1, sl = r["blocks"]["params/blocks/mlp/experts/w1"]
        assert w1.shape[1] == MOE["n_experts"] // ep and sl[1][1] - sl[1][0] == MOE["n_experts"] // ep
