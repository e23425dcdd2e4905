"""Packed-document masking (``doc_mask_token``) in the port, against the
JAX package.

Mirrors ``test_doc_mask.py``: naive attention with segments against JAX's
naive attention; the flash path's plain versions (forward and all three
gradients, through ``FlashAttention``) against the Pallas kernel in
interpret mode, on the one-pass and the split backward; cross-document
isolation through the model; flash against naive under the mask; the
first steps of doc-masked training against the JAX trainer; and the cached
forward's refusal. Inputs are seeded numpy arrays handed to both
frameworks.

Tolerances: attention outputs within 2e-5 and gradients within 2e-4
max-abs (the JAX test's bars: summation order only); isolation exact, as
in JAX (masked probabilities are exact zeros); model logits within 1e-4
of JAX (the port's fp32 logits bar); training losses within 1e-5 relative
and parameters within 1e-5 after 3 steps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.ops.attention import naive_attention as jax_naive
from pretraining_llm_tpu.ops.pallas_flash import pallas_flash_attention
from pretraining_llm_tpu.training import train_step as jts
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.data import loader as tloader
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.models import transformer as ttf
from pretraining_llm_tpu_torch.ops import cuda_flash
from pretraining_llm_tpu_torch.ops.attention import naive_attention
from pretraining_llm_tpu_torch.ops.flash_attention import flash_attention
from pretraining_llm_tpu_torch.training import optimizer as topt
from pretraining_llm_tpu_torch.training import train_step as tts

ATTN_TOL = 2e-5
GRAD_TOL = 2e-4
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5


@pytest.fixture(scope="module")
def qkv_seg():
    """test_doc_mask.py's shapes and boundaries: row 0 has two documents,
    row 1 three."""
    b, t, h, g, d = 2, 256, 4, 2, 32
    rng = np.random.default_rng(1)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, g, d)).astype(np.float32)
    v = rng.normal(size=(b, t, g, d)).astype(np.float32)
    do = rng.normal(size=(b, t, h, d)).astype(np.float32)
    pos = np.arange(t)
    seg = np.stack([np.where(pos < 100, 0, 1), np.searchsorted([60, 177], pos, side="right")]).astype(np.int32)
    return q, k, v, do, seg


def test_naive_segments_match_jax(qkv_seg):
    q, k, v, _, seg = qkv_seg
    want = jax_naive(*(jnp.asarray(x) for x in (q, k, v)), segments=jnp.asarray(seg))
    got = naive_attention(*(torch.from_numpy(x) for x in (q, k, v)), segments=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)
    with pytest.raises(ValueError, match="Tq == Tk"):
        naive_attention(torch.from_numpy(q[:, :8]), torch.from_numpy(k), torch.from_numpy(v),
                        segments=torch.from_numpy(seg))


@functools.partial(jax.jit, static_argnames=("block_q", "block_kv"))
def _pallas_vjp(q, k, v, seg, do, *, block_q, block_kv):
    def f(q, k, v):
        return pallas_flash_attention(q, k, v, segments=seg, block_q=block_q, block_kv=block_kv,
                                      interpret=True)

    out, vjp = jax.vjp(f, q, k, v)
    return (out,) + vjp(do)


@pytest.mark.parametrize("blocks", [(0, 0), (128, 128)])
def test_flash_segments_match_pallas_fwd_and_grad(qkv_seg, blocks):
    """Forward and dq, dk, dv: blocks (0, 0) take the one-pass backward,
    (128, 128) the dQ + dK/dV pair, in both packages."""
    q, k, v, do, seg = qkv_seg
    bq, bk = blocks
    assert cuda_flash.backward_is_one_pass(256, bq, bk) == (blocks == (0, 0))
    want = _pallas_vjp(*(jnp.asarray(x) for x in (q, k, v, seg, do)), block_q=bq, block_kv=bk)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, block_q=bq, block_kv=bk, segments=torch.from_numpy(seg))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want[0]), atol=ATTN_TOL)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_TOL)


def test_flash_plain_versions_take_segments_as_the_kernels_do(qkv_seg):
    """The plain forward with segments equals naive attention under the
    same mask, and the (B, T) int32 contract is checked."""
    q, k, v, _, seg = qkv_seg
    b, t, h, d = q.shape
    fold = lambda x: torch.from_numpy(x).permute(0, 2, 1, 3).reshape(-1, t, d).contiguous()  # noqa: E731
    tseg = torch.from_numpy(seg)
    o, lse = cuda_flash.flash_attention_fwd(fold(q), fold(k), fold(v), h, k.shape[2], segments=tseg)
    want = naive_attention(*(torch.from_numpy(x) for x in (q, k, v)), segments=tseg)
    np.testing.assert_allclose(o.reshape(b, h, t, d).permute(0, 2, 1, 3).numpy(), want.numpy(), atol=ATTN_TOL)
    assert lse.shape == (b * h, t)
    with pytest.raises(ValueError, match="int32"):
        cuda_flash.flash_attention_fwd(fold(q), fold(k), fold(v), h, k.shape[2], segments=tseg.long())
    with pytest.raises(ValueError, match="segments must be"):
        cuda_flash.flash_attention_fwd(fold(q), fold(k), fold(v), h, k.shape[2], segments=tseg[:1])


def _tiny(impl, **kw):
    return dataclasses.replace(tcfg.get_preset("tiny").model, compute_dtype="float32", attention_impl=impl,
                               doc_mask_token=0, **kw)


def _packed_tokens(cfg, seed, n_prefix):
    """Tokens with a separator (id 0) at position n_prefix - 1."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (1, cfg.context_length))
    toks[0, n_prefix - 1] = cfg.doc_mask_token
    return toks


def _jax_params(cfg):
    """The JAX init tree of ``cfg`` (key 0) as numpy."""
    jc = jcfg.ModelConfig(**dataclasses.asdict(cfg))
    return jc, jax.tree.map(np.asarray, jtf.init_params(jc, jax.random.key(0)))


@pytest.mark.parametrize("impl,blocks", [("naive", 0), ("flash", 0), ("flash", 16)])
def test_model_cross_document_isolation(impl, blocks):
    """The second document's logits are identical whatever the first
    document holds, equal JAX's, and differ without doc masking."""
    cfg = _tiny(impl, flash_block_q=blocks, flash_block_kv=blocks)
    jc, tree = _jax_params(cfg)
    params = bridge.params_from_numpy(tree, cfg, device="cpu")
    cut = 20  # separator at index 19; document 2 starts at 20
    a = _packed_tokens(cfg, 1, cut)
    b = a.copy()
    b[0, : cut - 1] = np.random.default_rng(2).integers(1, cfg.vocab_size, cut - 1)
    la, _ = ttf.forward(params, torch.from_numpy(a), cfg)
    lb, _ = ttf.forward(params, torch.from_numpy(b), cfg)
    np.testing.assert_array_equal(la[0, cut:].numpy(), lb[0, cut:].numpy())
    want, _ = jtf.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(a), jc)
    np.testing.assert_allclose(la.numpy(), np.asarray(want), atol=LOGIT_TOL)
    off = dataclasses.replace(cfg, doc_mask_token=-1)
    la_off, _ = ttf.forward(params, torch.from_numpy(a), off)
    lb_off, _ = ttf.forward(params, torch.from_numpy(b), off)
    assert float((la_off[0, cut:] - lb_off[0, cut:]).abs().max()) > 1e-4


def test_model_flash_equals_naive_with_doc_mask():
    logits = {}
    toks = torch.from_numpy(_packed_tokens(_tiny("naive"), 5, 13))
    for impl in ("naive", "flash"):
        cfg = _tiny(impl)
        _, tree = _jax_params(cfg)
        logits[impl], _ = ttf.forward(bridge.params_from_numpy(tree, cfg, device="cpu"), toks, cfg)
    np.testing.assert_allclose(logits["naive"].numpy(), logits["flash"].numpy(), atol=2e-4, rtol=1e-4)


def test_doc_mask_segments_are_the_exclusive_cumsum(monkeypatch):
    """Token i's document is the count of separators strictly before it (a
    separator is the last token of its document); every layer's flash call
    gets those ids as a (B, T) int32 tensor."""
    cfg = _tiny("flash")
    params = ttf.init_params(cfg, 0, device="cpu")
    toks = np.random.default_rng(4).integers(0, 4, (2, cfg.context_length))  # many separators (id 0)
    seen = []
    real = ttf.flash_attention

    def spy(*args, segments=None, **kw):
        seen.append(segments)
        return real(*args, segments=segments, **kw)

    monkeypatch.setattr(ttf, "flash_attention", spy)
    ttf.forward(params, torch.from_numpy(toks), cfg)
    want = np.array([[(row[:i] == 0).sum() for i in range(len(row))] for row in toks])
    assert len(seen) == cfg.n_layers
    assert all(s.dtype == torch.int32 and np.array_equal(s.numpy(), want) for s in seen)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _tiny_train(**model):
    """The JAX test's run: the tiny preset with doc_mask_token 0, lr 3e-3,
    batch 8, in both packages."""
    jtiny, ttiny = jcfg.get_preset("tiny"), tcfg.get_preset("tiny")
    model = dict(model, doc_mask_token=0)
    train = dict(lr=3e-3, batch_size=8)
    jc = jtiny.replace(model=dataclasses.replace(jtiny.model, **model),
                       train=dataclasses.replace(jtiny.train, **train))
    tc = dataclasses.replace(ttiny, model=dataclasses.replace(ttiny.model, **model),
                             train=dataclasses.replace(ttiny.train, **train))
    return jc, tc


def test_doc_mask_training_matches_jax():
    """Three AdamW steps at fp32 on batches with ~10% separators, from the
    same weights (the JAX init tree with seeded noise on every leaf, so no
    gradient is 0 up to rounding) in both packages: losses within 1e-5
    relative, parameters within 1e-5. Without the QKV bias, whose key part
    has a true gradient of 0 and rounding noise that Adam's normalisation
    blows up to +-lr (as ``test_torch_port_training.py::TRAIN_MODEL``)."""
    jc, tc = _tiny_train(compute_dtype="float32", qkv_bias=False)
    jstate = jts.init_train_state(jc, jax.random.key(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: ((1.0 if path[-1].key == "scale" else 0.0) + rng.normal(0, 0.05, x.shape)).astype(np.float32),
        jstate["params"])
    jstate["params"] = jax.tree.map(jnp.asarray, tree)
    tstate = tts.init_train_state(tc, device="cpu")
    tstate["params"] = bridge.params_from_numpy(tree, tc.model, device="cpu")
    tstate["opt"] = topt.adamw_init(tstate["params"])
    jstep, tstep = jts.build_train_step(jc, None), tts.build_train_step(tc)
    for i in range(3):
        toks = rng.integers(1, tc.model.vocab_size, (8, tc.model.context_length + 1))
        toks[rng.random(toks.shape) < 0.1] = 0
        x, y = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
        tstate, tm = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y)))
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * float(jm["loss"]), i
    got = dict(topt.tree_leaves(bridge.params_to_numpy(tstate["params"])))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jstate["params"]):
        key = tuple(p.key for p in path)
        assert float(np.abs(np.asarray(leaf) - got[key]).max()) <= PARAM_TOL, key


def test_doc_mask_trains():
    """The JAX test's run on the port: the tiny preset as it stands (bf16
    compute) with doc masking, from the JAX init (key 0), 15 steps on the
    synthetic stream give a finite loss more than 0.3 below the first."""
    jc, tc = _tiny_train()
    state = tts.init_train_state(tc, device="cpu")
    tree = jax.tree.map(np.asarray, jts.init_train_state(jc, jax.random.key(0))["params"])
    state["params"] = bridge.params_from_numpy(tree, tc.model, device="cpu")
    state["opt"] = topt.adamw_init(state["params"])
    step = tts.build_train_step(tc)
    it = tloader.synthetic_iterator(tc.model.vocab_size, tc.model.context_length, 8, seed=0)
    losses = []
    for _ in range(15):
        x, y = next(it)
        state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0] - 0.3, losses


def test_doc_mask_validation_and_decode_rejection():
    with pytest.raises(ValueError, match="ring/ulysses"):
        tcfg.ModelConfig(attention_impl="ring", doc_mask_token=0)
    with pytest.raises(ValueError, match="pipeline"):
        tcfg.ModelConfig(pipeline_stages=2, n_layers=12, doc_mask_token=0)
    with pytest.raises(ValueError, match="vocab"):
        tcfg.ModelConfig(vocab_size=100, doc_mask_token=100)
    cfg = _tiny("flash")
    params = ttf.init_params(cfg, 0, device="cpu")
    toks = torch.ones((1, 4), dtype=torch.long)
    cache = ttf.make_kv_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="doc_mask"):
        ttf.forward(params, toks, cfg, kv_cache=cache, cache_index=0)
    pool = ttf.make_paged_kv_pool(cfg, 4, 8, device="cpu")
    paged = ttf.PagedInfo(torch.tensor([[1]], dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="doc_mask"):
        ttf.forward(params, toks[:, :1], cfg, kv_cache=pool, paged=paged)


def test_doc_mask_model_still_serves():
    """A model trained with packing masks serves: the engine runs a decode
    session as one document (as the JAX engine and ``generate()`` do), with
    the same greedy tokens as the unmasked config."""
    cfg = _tiny("flash")
    params = ttf.init_params(cfg, 0, device="cpu")
    prompts = np.random.default_rng(9).integers(1, cfg.vocab_size, (2, 8)).tolist()
    outs = []
    for c in (cfg, dataclasses.replace(cfg, doc_mask_token=-1)):
        eng = ServingEngine(params, c, n_blocks=16, block_size=8, device="cpu")
        rids = [eng.submit(p, 8) for p in prompts]
        out = eng.run()
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1]
