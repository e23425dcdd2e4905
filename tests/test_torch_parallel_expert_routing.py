"""The port's MoE routing on an expert mesh, on 4 gloo ranks, against the
JAX package's ``moe_mlp`` on the global batch (conftest's virtual CPU
devices): one MoE layer (4 experts, top-2, swiglu, fp32) on the ranks'
rows with capacity drops, at (data 2, expert 2) with routing groups that
lie within a rank and one group that spans the ranks, and at (expert 4):
the same outputs, so the same kept choices, on every expert rank alike,
and the global batch's load-balance loss on every rank; at (seq 2, expert
2) with Ulysses attention each rank holds half of every row's tokens, and
the groups are cut in the global (B, T) token order. A MoE model with
Ulysses attention trains on (seq 2, expert 2) as JAX's mesh step does
(``check_against_jax``'s bars: loss rtol 1e-5, the ranks' blocks after 2
steps rtol 1e-3 / atol 1e-4); with ring attention in the zigzag layout in
``test_torch_parallel_moe_ring.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parallel_jax import check_against_jax, jax_run, tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401

from pretraining_llm_tpu.models import moe as jmoe


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


EXPERT4 = (1, 1, 1, 1, 4, 1)
DATA_EXPERT = (2, 1, 1, 1, 2, 1)
SEQ_EXPERT = (1, 1, 1, 2, 2, 1)
MOE = dict(n_experts=4, experts_per_token=2)
ULYSSES = dict(attention_impl="ulysses", sequence_parallel=True, pos_embed="rope")


@pytest.mark.parametrize("sizes,group_size,attn", [(DATA_EXPERT, 64, {}), (DATA_EXPERT, 0, {}), (EXPERT4, 48, {}),
                                                   (SEQ_EXPERT, 48, ULYSSES)],
                         ids=["groups-within-ranks", "one-group-over-ranks", "expert4-groups", "seq2-ulysses-groups"])
def test_moe_layer_routing_matches_jax(ranks, sizes, group_size, attn):
    cfg = tiny_config(**MOE, expert_capacity_factor=1.0, moe_group_size=group_size, activation="swiglu", **attn)
    m = cfg.model
    rng = np.random.default_rng(3)
    h = rng.standard_normal((8, 24, m.d_model)).astype(np.float32)
    mlp = {"router": (rng.standard_normal((m.d_model, 4)) * 0.5).astype(np.float32),
           "experts": {"w1": (rng.standard_normal((4, m.d_model, 2, m.d_ff)) * 0.1).astype(np.float32),
                       "b1": (rng.standard_normal((4, 2, m.d_ff)) * 0.1).astype(np.float32),
                       "w2": (rng.standard_normal((4, m.d_ff, m.d_model)) * 0.1).astype(np.float32),
                       "b2": (rng.standard_normal((4, m.d_model)) * 0.1).astype(np.float32)}}
    want_y, want_aux = jax.jit(lambda p, x: jmoe.moe_mlp(p, x, m))(jax.tree.map(jnp.asarray, mlp), jnp.asarray(h))
    want_y = np.asarray(want_y)
    ample = dataclasses.replace(m, expert_capacity_factor=4.0)
    ample_y, _ = jmoe.moe_mlp(jax.tree.map(jnp.asarray, mlp), jnp.asarray(h), ample)
    assert not np.allclose(want_y, np.asarray(ample_y)), "no choice was dropped"
    results = ranks.run("_torch_parallel_cases:moe_layer", cfg_dict=dataclasses.asdict(cfg), mlp_np=mlp, h=h,
                        sizes=sizes)
    got = np.full_like(want_y, np.nan)
    for r in results:
        block = (slice(*r["rows"]), slice(*r["cols"]))
        if np.isnan(got[block]).all():
            got[block] = r["y"]
        np.testing.assert_allclose(r["y"], got[block], rtol=0, atol=0)  # expert ranks agree
        np.testing.assert_allclose(r["aux"], float(want_aux), rtol=1e-6)
    np.testing.assert_allclose(got, want_y, rtol=1e-5, atol=1e-6)


def test_moe_with_sequence_sharded_attention_raises(ranks):
    """Refused until ported: a MoE model with Ulysses attention over seq 2
    (x expert 2) now trains as JAX's mesh step does."""
    cfg = tiny_config(**MOE, **ULYSSES, expert_capacity_factor=1.0)
    params_np, x, y, metrics, flat = jax_run(cfg, SEQ_EXPERT)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg), params_np=params_np,
                        x=x, y=y, sizes=SEQ_EXPERT)
    check_against_jax(results, metrics, flat)

