"""The seven remat policies of the PyTorch port (``ops/remat.py``).

For every policy, a 2-layer model's loss and gradients equal remat
``"none"``'s (max-abs 1e-5, as ``tests/test_model.py``'s remat test) and
the JAX package's under the same policy (loss 1e-5 relative, gradients 1e-4
of each leaf's largest |g|), for a gpt2 flavour (one fused QKV product) and
a GQA llama flavour (two). The backward's recompute is counted: the flash
forward (K1's plain version on the CPU) reruns once per layer under
``full``, ``dots_saveable`` and ``save_attn`` and never under ``none``,
``save_attn_res``, ``save_qkv_attn`` and ``save_big``; the QKV projection's
products rerun under ``full``, ``save_attn`` and ``save_attn_res`` only.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.models import transformer as ttf
from pretraining_llm_tpu_torch.ops import cuda_flash, remat
from pretraining_llm_tpu_torch.training import optimizer as topt
from pretraining_llm_tpu_torch.training import train_step as tts

GPT2 = dict(
    vocab_size=97, context_length=32, d_model=32, n_heads=4, n_layers=2,
    activation="gelu", norm="layernorm", pos_embed="learned",
    tie_embeddings=True, qkv_bias=True, mlp_bias=True,
    compute_dtype="float32", attention_impl="flash",
)
LLAMA_GQA = dict(  # Dh 16: the projections' widths (64) differ from D (32)
    vocab_size=97, context_length=32, d_model=32, n_heads=4, n_kv_heads=2, d_head=16,
    n_layers=2, activation="swiglu", norm="rmsnorm", pos_embed="rope",
    tie_embeddings=False, lm_head_bias=True, qkv_bias=False, mlp_bias=False,
    compute_dtype="float32", attention_impl="flash",
)
FLAVOURS = {"gpt2": GPT2, "llama_gqa": LLAMA_GQA}
BATCH = 4
NONE_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
K1_RERUNS = {"none": 0, "full": 1, "dots_saveable": 1, "save_attn": 1, "save_attn_res": 0,
             "save_qkv_attn": 0, "save_big": 0}
QKV_RERUNS = {"none": 0, "full": 1, "dots_saveable": 0, "save_attn": 1, "save_attn_res": 1,
              "save_qkv_attn": 0, "save_big": 0}


def test_policies_are_the_jax_packages():
    from pretraining_llm_tpu.ops import remat as jremat

    assert remat.POLICIES == jremat.POLICIES == tcfg._REMAT_POLICIES
    assert (remat._SAVE_ATTN, remat._SAVE_ATTN_RES, remat._SAVE_QKV_ATTN, remat._SAVE_BIG) == (
        jremat._SAVE_ATTN, jremat._SAVE_ATTN_RES, jremat._SAVE_QKV_ATTN, jremat._SAVE_BIG)


def _inputs(kw, seed=0):
    layout = jax.eval_shape(functools.partial(jtf.init_params, jcfg.ModelConfig(**kw)), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, s: ((1.0 if p[-1].key == "scale" else 0.0) + rng.normal(0, 0.05, s.shape)).astype(np.float32),
        layout)
    toks = rng.integers(0, kw["vocab_size"], (BATCH, kw["context_length"] + 1)).astype(np.int32)
    return tree, toks[:, :-1], toks[:, 1:]


def _port_loss_and_grads(tree, x, y, kw, policy):
    cfg = tcfg.Config(model=tcfg.ModelConfig(**dict(kw, remat=policy)), train=tcfg.TrainConfig(batch_size=BATCH))
    params = bridge.params_from_numpy(tree, cfg.model, device="cpu")
    loss, grads = tts.loss_and_grads(params, torch.from_numpy(x), torch.from_numpy(y), cfg)
    return float(loss), {"/".join(str(k) for k in path): a for path, a in _leaves(bridge.params_to_numpy(grads))}


def _leaves(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path + (k,))
        else:
            yield path + (k,), np.asarray(tree[k], np.float32)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_loss_and_grads(params, x, y, *, cfg):
    return jax.value_and_grad(lambda p: jtf.loss_fn(p, x, y, cfg))(params)


@pytest.mark.parametrize("policy", remat.POLICIES)
@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_policy_gives_none_and_jax_gradients(flavour, policy):
    kw = FLAVOURS[flavour]
    tree, x, y = _inputs(kw)
    loss, grads = _port_loss_and_grads(tree, x, y, kw, policy)
    ref_loss, ref_grads = _port_loss_and_grads(tree, x, y, kw, "none")
    assert abs(loss - ref_loss) <= NONE_ATOL
    for name, g in grads.items():
        assert float(np.abs(g - ref_grads[name]).max()) <= NONE_ATOL, name
    want_loss, want = _jax_loss_and_grads(tree, x, y, cfg=jcfg.ModelConfig(**dict(kw, remat=policy)))
    assert abs(loss - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    want = {"/".join(str(p.key) for p in path): np.asarray(a) for path, a in jax.tree_util.tree_leaves_with_path(want)}
    assert want.keys() == grads.keys()
    for name, g in grads.items():
        scale = max(float(np.abs(want[name]).max()), 1e-12)
        assert float(np.abs(g - want[name]).max()) <= GRAD_RTOL * scale, name


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products of the given (lhs, rhs) shapes whose rhs
    is a contiguous weight (a gradient product's rhs is a transposed view)."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.count = shapes, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func is torch.ops.aten.mm.default and args[1].is_contiguous()
                and (tuple(args[0].shape), tuple(args[1].shape)) in self.shapes):
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", remat.POLICIES)
@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_backward_recomputes_what_the_policy_drops(flavour, policy, monkeypatch):
    """Counted during ``backward()`` only: K1 calls (through
    ``FlashAttention``) and the QKV projection's forward products (their
    (B*T, D) x (D, n) operand shapes, n != D, with the weight contiguous:
    no other product has them)."""
    kw = FLAVOURS[flavour]
    cfg = tcfg.ModelConfig(**dict(kw, remat=policy))
    tree, x, y = _inputs(kw)
    params = bridge.params_from_numpy(tree, cfg, device="cpu")
    leaves = tts._grad_leaves(params, topt.tree_map(torch.zeros_like, params))
    loss = ttf.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y), cfg)
    k1 = {"n": 0}
    fwd = cuda_flash.flash_attention_fwd

    def counted(*a, **k):
        k1["n"] += 1
        return fwd(*a, **k)

    monkeypatch.setattr(cuda_flash, "flash_attention_fwd", counted)
    s, d, h, g, dh = BATCH * cfg.context_length, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    shapes = {((s, d), (d, 3 * h * dh))} if g == h else {((s, d), (d, h * dh)), ((s, d), (d, 2 * g * dh))}
    n_proj = 1 if g == h else 2  # the fused wqkv product, or wq and wkv
    products = _CountProducts(shapes)
    with products:
        loss.backward()
    assert k1["n"] == K1_RERUNS[policy] * cfg.n_layers
    assert products.count == QKV_RERUNS[policy] * cfg.n_layers * n_proj
