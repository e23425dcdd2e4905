"""The port's tensor axis with Ulysses sequence parallelism, on 4 gloo
ranks at (tensor 2, seq 2), against the JAX package on the same mesh
shape (conftest's virtual CPU devices): heads split by tensor, then by
seq. ``build_train_step(cfg, mesh)`` over the tiny preset at 2 layers,
fp32, 2 AdamW steps, for MHA, grouped KV heads that split over tensor x
seq and grouped KV heads that do not (expanded per query head): loss rtol
1e-5 per step, the parameters and moments from the ranks' blocks rtol
1e-3 / atol 1e-4. ``ulysses_attention`` raises JAX's ``ValueError``s,
word for word, on heads that do not split."""

import dataclasses

import jax
import numpy as np
import pytest
from _torch_parallel_jax import AXES, check_against_jax, jax_run, tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401
from jax.sharding import Mesh

from pretraining_llm_tpu.parallel.ulysses import ulysses_attention as jax_ulysses


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


SIZES = (1, 1, 2, 2, 1, 1)
ULYSSES = dict(attention_impl="ulysses", sequence_parallel=True, pos_embed="rope")


@pytest.mark.parametrize("heads", [(4, 4), (8, 4), (8, 2)], ids=["mha", "gqa-grouped", "gqa-expanded"])
def test_tensor_ulysses_train_steps_match_jax_mesh(ranks, heads):
    cfg = tiny_config(**ULYSSES, n_heads=heads[0], n_kv_heads=heads[1])
    params_np, x, y, metrics, flat = jax_run(cfg, SIZES)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=SIZES)
    check_against_jax(results, metrics, flat)


@pytest.mark.parametrize("h,g", [(6, 6), (8, 2), (4, 4)])
def test_tensor_ulysses_errors_match_jax(ranks, h, g):
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(SIZES), AXES)
    q = np.zeros((1, 16, h, 8), np.float32)
    kv = np.zeros((1, 16, g, 8), np.float32)
    try:
        jax_ulysses(q, kv, kv, mesh)
        want = None
    except ValueError as e:
        want = str(e)
    got = ranks.run("_torch_parallel_cases:attention_error", impl="ulysses", sizes=SIZES, h=h, g=g)
    assert all(m == want for m in got), (got, want)
    assert (want is None) == (h == 4)
