"""The port's mesh train step with ring attention on 4 gloo ranks (seq 4)
against the JAX package's ``build_train_step(cfg, mesh)`` on a seq-4 mesh:
gpt2-8k-sp's settings (RoPE, ring attention in the zigzag layout, sequence
parallel, the save_attn remat policy) at tiny widths, 2 layers, fp32, 2
AdamW steps: loss rtol 1e-5 per step, parameters and moments rtol 1e-3 /
atol 1e-4. gpt2-8k-gqa's settings are in
``test_torch_parallel_train_gqa.py`` (each JAX compile takes 13-18 s)."""

import dataclasses

import pytest
from _torch_parallel_jax import check_against_jax, jax_run, tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401

SIZES = (1, 1, 1, 4, 1, 1)
RING_8K = dict(attention_impl="ring", ring_layout="zigzag", sequence_parallel=True, pos_embed="rope",
               remat="save_attn")


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


@pytest.mark.parametrize("kv", [None], ids=["gpt2-8k-sp"])
def test_ring_train_steps_match_jax_mesh(ranks, kv):
    cfg = tiny_config(**RING_8K, n_kv_heads=kv)
    params_np, x, y, metrics, flat = jax_run(cfg, SIZES)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=SIZES)
    check_against_jax(results, metrics, flat)
