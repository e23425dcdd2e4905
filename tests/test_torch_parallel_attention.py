"""Ring (contiguous and zigzag) and Ulysses attention on 4 gloo ranks
against the JAX package's ``ring_attention`` and ``ulysses_attention`` on a
seq-4 mesh of conftest's virtual CPU devices, forward and every gradient,
MHA and GQA, at fp32 with JAX's own bars (``test_ring_attention.py``,
``test_ulysses.py``): outputs rtol/atol 1e-5, gradients rtol 1e-4 / atol
1e-5. Each rank holds its sequence chunk of the (zigzag-permuted) inputs;
the ranks' outputs concatenate to JAX's global output. One group of ranks
serves every case of the file (``_torch_ranks.RankGroup``)."""

import jax
import numpy as np
import pytest
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401
from jax.sharding import Mesh

from pretraining_llm_tpu.parallel.ring_attention import ring_attention as jax_ring
from pretraining_llm_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from pretraining_llm_tpu.parallel.zigzag import zigzag_perm

AXES = ("data", "fsdp", "tensor", "seq", "expert", "pipe")
SIZES = (1, 1, 1, 4, 1, 1)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, T, D = 2, 32, 8


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.array(jax.devices()[:4]).reshape(SIZES), AXES)


def _inputs(h, g, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, T, h, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, T, g, D)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _jax_reference(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, q, k, v)
    return (np.asarray(out),) + tuple(np.asarray(x) for x in vjp(do))


def _check(results, want):
    got = [np.concatenate([r[name] for r in results], axis=1) for name in ("o", "dq", "dk", "dv")]
    np.testing.assert_allclose(got[0], want[0], **OUT_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("h,g", [(4, 4), (4, 2)])
@pytest.mark.parametrize("layout,causal", [("contiguous", True), ("contiguous", False), ("zigzag", True)])
def test_ring_attention_matches_jax(ranks, jax_mesh, layout, causal, h, g):
    """Causal hops skip, diagonal hops mask, zigzag balances; GQA rotates
    only the G KV heads; dK/dV travel home with the shards."""
    q, k, v, do = _inputs(h, g, seed=h * 10 + g + (layout == "zigzag"))
    if layout == "zigzag":
        perm = zigzag_perm(T, 4)
        q, k, v, do = (a[:, perm] for a in (q, k, v, do))
    want = _jax_reference(jax.jit(lambda q, k, v: jax_ring(q, k, v, jax_mesh, causal=causal, layout=layout,
                                                           block_kv=4)), q, k, v, do)
    _check(ranks.run("_torch_parallel_cases:attention", impl="ring", q=q, k=k, v=v, do=do, sizes=SIZES,
                     causal=causal, layout=layout, block_kv=4), want)


@pytest.mark.parametrize("h,g", [(4, 4), (8, 4)])
def test_ulysses_attention_matches_jax(ranks, jax_mesh, h, g):
    """Two all-to-alls around the flash route's plain version; GQA
    exchanges G/n KV heads per rank."""
    q, k, v, do = _inputs(h, g, seed=h + g)
    want = _jax_reference(jax.jit(lambda q, k, v: jax_ulysses(q, k, v, jax_mesh, causal=True, use_flash=False)),
                          q, k, v, do)
    _check(ranks.run("_torch_parallel_cases:attention", impl="ulysses", q=q, k=k, v=v, do=do, sizes=SIZES,
                     causal=True), want)


@pytest.mark.parametrize("impl,h,g,match", [
    ("ulysses", 6, 6, "per-device heads \\(6\\) divisible by seq axis size \\(4\\)"),
    ("ulysses", 8, 2, "grouped ulysses needs kv heads \\(2\\)"),
    ("ring", 6, 4, "kv heads \\(4\\) must divide query heads \\(6\\)"),
    ("ring", 8, 2, None),
])
def test_indivisible_heads_are_rejected(ranks, impl, h, g, match):
    """JAX's errors on heads that do not split over the seq ranks (ring
    takes any G | H: it rotates whole KV heads)."""
    import re

    got = ranks.run("_torch_parallel_cases:attention_error", impl=impl, sizes=SIZES, h=h, g=g)
    assert all(m == got[0] for m in got)
    if match is None:
        assert got[0] is None
    else:
        assert got[0] is not None and re.search(match, got[0]), got[0]


def test_unported_axes_raise_on_ranks(ranks):
    """No axis is refused any more: on real ranks the tensor, expert and
    pipe axes (the last refused until the pipeline was ported) build, each
    mesh with its sizes."""
    for axis in ("tensor", "expert", "pipe"):
        got = ranks.run("_torch_parallel_cases:build_mesh_error", **{axis: 2, "data": 2})
        assert all(m is None for m in got), got
