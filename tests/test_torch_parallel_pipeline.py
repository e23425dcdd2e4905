"""The port's pipe axis (``parallel/pipeline.py``) on 4 gloo ranks against
the JAX package's pipeline on the same mesh shape (conftest's virtual CPU
devices), the cases of JAX's ``tests/test_pipeline.py``:

- ``schedule_ticks``, ``bubble_fraction`` and the interleaved layout
  against JAX's functions (a round trip, and rank r's chunks);
- pipe 4, V 1, 4 layers, 4 microbatches: the pipelined forward's logits
  against JAX's pipelined forward and the plain scan (1e-4), the ranks'
  gradients summed against JAX's (rtol 2e-3, atol 1e-5: JAX's own bars);
  every chunk run and hop counted against the schedule at V 1 and V 2;
- pipe 2 x data 2 train steps against JAX's ``build_train_step`` on the
  same mesh (``_torch_parallel_jax.check_against_jax``: loss rtol 1e-5,
  the ranks' blocks against JAX's state rtol 1e-3 / atol 1e-4);
- the refusals in JAX's words.

The baked layout, checkpoints, tensor, fsdp and expert compositions are in
``test_torch_parallel_pipeline_mesh.py``."""

import dataclasses

import jax
import numpy as np
import pytest
from _torch_parallel_jax import AXES, check_against_jax, jax_run, tiny_config
from _torch_ranks import RankGroup
from _torch_threads import _one_torch_thread  # noqa: F401
from jax.sharding import Mesh

from pretraining_llm_tpu.config import ModelConfig as JModelConfig
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.parallel import pipeline as jpp
from pretraining_llm_tpu.parallel.sharding import activation_mesh
from pretraining_llm_tpu_torch.config import ModelConfig as TModelConfig
from pretraining_llm_tpu_torch.parallel import pipeline as tpp

PIPE4 = (1, 1, 1, 1, 1, 4)
DATA2_PIPE2 = (2, 1, 1, 1, 1, 2)


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


@pytest.mark.parametrize("n_micro,stages,v", [(4, 2, 1), (1, 1, 1), (32, 2, 1), (4, 4, 2), (8, 4, 4), (2, 2, 3)])
def test_schedule_and_layout_match_jax(n_micro, stages, v):
    assert tpp.schedule_ticks(n_micro, stages, v) == jpp.schedule_ticks(n_micro, stages, v)
    assert tpp.bubble_fraction(n_micro, stages, v) == jpp.bubble_fraction(n_micro, stages, v)
    import torch

    n_layers = stages * v * 2
    a = np.arange(n_layers * 3, dtype=np.float32).reshape(n_layers, 3)
    tree = {"blocks": {"w": a}}
    want = jax.tree.map(np.asarray, jpp.interleave_layout(tree, stages, v))
    got = tpp.interleave_layout({"blocks": {"w": torch.from_numpy(a)}}, stages, v)
    np.testing.assert_array_equal(got["blocks"]["w"].numpy(), want["blocks"]["w"])
    back = tpp.deinterleave_layout(got, stages, v)
    np.testing.assert_array_equal(back["blocks"]["w"].numpy(), a)
    np.testing.assert_array_equal(
        np.asarray(jpp.deinterleave_layout(want, stages, v)["blocks"]["w"]), a)
    lpl = n_layers // stages
    for r in range(stages):  # rank r's block of the rank-major stack is its chunks in depth order
        rows = [i for lo, hi in tpp.depth_chunks(r, n_layers, stages, v) for i in range(lo, hi)]
        np.testing.assert_array_equal(want["blocks"]["w"][r * lpl:(r + 1) * lpl], a[rows])


def _model(**kw):
    base = dict(vocab_size=97, context_length=32, d_model=32, n_heads=4, n_layers=4, pipeline_stages=4,
                pipeline_microbatches=4, param_dtype="float32", compute_dtype="float32")
    base.update(kw)
    return base


def _jax_mesh(sizes):
    return Mesh(np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes), AXES)


def test_pipe4_forward_and_grads_match_jax(ranks):
    """Pipe 4 over 4 ranks, V 1: every rank's logits equal JAX's pipelined
    forward and the plain scan; the ranks' gradients, summed, equal JAX's
    pipelined and plain gradients. (V 2 is held to JAX's train step in
    ``test_torch_parallel_pipeline_mesh.py`` and
    ``test_torch_parallel_optim.py``.)"""
    model = {}
    jcfg = JModelConfig(**_model(**model))
    params = jtf.init_params(jcfg, jax.random.key(0))
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (8, 32), 0, 97), np.int32)
    targets = np.roll(tokens, -1, axis=1)
    mesh = _jax_mesh(PIPE4)

    def piped(p, t):
        with activation_mesh(mesh):
            return jtf.forward(p, t, jcfg)[0]

    want_pipe = np.asarray(jax.jit(piped)(params, tokens))
    want_plain = np.asarray(jax.jit(lambda p, t: jtf.forward(p, t, jcfg)[0])(params, tokens))

    def piped_loss(p):
        with activation_mesh(mesh):
            return jtf.loss_fn(p, tokens, targets, jcfg)

    g_pipe = jax.jit(jax.grad(piped_loss))(params)
    g_plain = jax.jit(jax.grad(lambda p: jtf.loss_fn(p, tokens, targets, jcfg)))(params)
    cfg = tiny_config().replace(model=TModelConfig(**_model(**model)))
    results = ranks.run("_torch_pipeline_cases:pipelined_forward_and_grads", cfg_dict=dataclasses.asdict(cfg),
                        params_np=jax.tree.map(np.asarray, params), tokens=tokens, targets=targets, sizes=PIPE4)
    assert sorted(r["pipe"] for r in results) == [0, 1, 2, 3]
    for r in results:
        np.testing.assert_allclose(r["logits"], want_pipe, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["logits"], want_plain, rtol=1e-4, atol=1e-4)
    loss = sum(r["loss"] for r in results)
    np.testing.assert_allclose(loss, float(jax.jit(piped_loss)(params)), rtol=1e-5)
    for want in (g_pipe, g_plain):
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            name = "/".join(str(p.key) for p in path)
            got = sum(r["grads"][name] for r in results)
            np.testing.assert_allclose(got, np.asarray(leaf), rtol=2e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("stages,v,n_micro", [(4, 1, 4), (4, 2, 4), (2, 2, 2)], ids=["s4v1", "s4v2", "s2v2"])
def test_chunk_runs_and_hops_follow_the_schedule(ranks, stages, v, n_micro):
    """Each rank runs its chunk once per item (V n_micro chunk runs of L /
    (S V) layers in the forward, no bubble tick), sends every item but the
    final laps on (the last rank of a chain sends nothing, the first
    receives nothing), and the backward runs the same hops reversed; the
    input's gradient and the output equal the plain product."""
    cfg = tiny_config().replace(model=TModelConfig(**_model(
        n_layers=stages * v * 2, pipeline_stages=stages, pipeline_interleave=v, pipeline_microbatches=n_micro)))
    sizes = (1, 1, 1, 1, 4 // stages, stages)
    results = ranks.run("_torch_pipeline_cases:hop_counts", cfg_dict=dataclasses.asdict(cfg), sizes=sizes,
                        n_rows=n_micro)
    lpc = 2
    for i, r in enumerate(results):
        rank = i % stages
        items = v * n_micro
        sends = items - (n_micro if rank == stages - 1 else 0) if (v > 1 or rank < stages - 1) else 0
        recvs = items - (n_micro if rank == 0 else 0) if (v > 1 or rank > 0) else 0
        assert r["forward"] == {"layers": items * lpc, "sends": sends, "recvs": recvs}, (rank, r["forward"])
        assert r["total"]["sends"] == sends + recvs and r["total"]["recvs"] == sends + recvs
        np.testing.assert_allclose(r["x_grad"], np.ones_like(r["x_grad"]) if rank == 0 else 0 * r["x_grad"])
        np.testing.assert_allclose(r["y"], np.ones_like(r["y"]))


def test_pipe2_data2_train_steps_match_jax_mesh(ranks):
    """Two AdamW steps at data 2 x pipe 2 (the tiny preset, 4 layers, 2
    microbatches) against JAX's ``build_train_step`` on the same mesh."""
    cfg = tiny_config(n_layers=4, pipeline_stages=2, pipeline_microbatches=2)
    params_np, x, y, metrics, flat = jax_run(cfg, DATA2_PIPE2)
    results = ranks.run("_torch_parallel_cases:train_steps", cfg_dict=dataclasses.asdict(cfg),
                        params_np=params_np, x=x, y=y, sizes=DATA2_PIPE2)
    check_against_jax(results, metrics, flat)
    for r in results:
        wqkv, sl = r["blocks"]["params/blocks/attn/wqkv"]
        assert wqkv.shape[0] == 2 and sl[0][1] - sl[0][0] == 2


def test_refusals_in_jax_words(ranks):
    """JAX's words for the configs it refuses (pipe with ring, Ulysses,
    sequence_parallel or doc masks; an interleave without stages or with
    too few microbatches), for a batch that does not split into the
    microbatches, and for ``blocks_baked`` without the pipelined path."""
    bad = [dict(n_layers=4, pipeline_stages=3), dict(n_layers=4, pipeline_stages=2, attention_impl="ring"),
           dict(n_layers=4, pipeline_stages=2, sequence_parallel=True),
           dict(n_layers=4, pipeline_stages=2, attention_impl="ulysses"),
           dict(n_layers=4, pipeline_stages=2, doc_mask_token=3),
           dict(n_layers=4, pipeline_stages=2, pipeline_interleave=3),
           dict(n_layers=8, pipeline_stages=4, pipeline_interleave=2, pipeline_microbatches=2),
           dict(n_layers=4, pipeline_stages=1, pipeline_interleave=2)]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            JModelConfig(**kw)
        with pytest.raises(ValueError) as got:
            TModelConfig(**kw)
        assert str(got.value) == str(want.value), kw
    # B 4 over data 2: a local batch of 2 does not split into 4 microbatches.
    jcfg = JModelConfig(**_model(pipeline_stages=2))
    params = jtf.init_params(jcfg, jax.random.key(0))
    tokens = np.zeros((4, 32), np.int32)
    with pytest.raises(ValueError) as want:
        with activation_mesh(_jax_mesh(DATA2_PIPE2)):
            jtf.forward(params, tokens, jcfg)
    cfg = tiny_config().replace(model=TModelConfig(**_model(pipeline_stages=2)))
    got = ranks.run("_torch_pipeline_cases:forward_error", cfg_dict=dataclasses.asdict(cfg),
                    params_np=jax.tree.map(np.asarray, params), tokens=tokens, sizes=DATA2_PIPE2)
    assert "pipeline_microbatches=4" in str(want.value)
    assert all(g == ("ValueError", str(want.value)) for g in got), (got, str(want.value))
    with pytest.raises(ValueError) as want:
        jtf.forward(params, tokens, jcfg, blocks_baked=True)
    import torch

    from pretraining_llm_tpu_torch.models import bridge
    from pretraining_llm_tpu_torch.models import transformer as ttf

    tm = TModelConfig(**_model(pipeline_stages=2))
    with pytest.raises(ValueError) as got:
        ttf.forward(bridge.params_from_numpy(jax.tree.map(np.asarray, params), tm, device="cpu"),
                    torch.zeros((4, 32), dtype=torch.long), tm, blocks_baked=True)
    assert str(got.value) == str(want.value)
