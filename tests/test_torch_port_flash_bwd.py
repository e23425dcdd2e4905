"""The port's flash-attention backward against the JAX package's.

``cuda_flash.flash_attention_bwd_reference`` (the plain version of the
three CUDA backward kernels) and the gradients of ``FlashAttention``
(autograd through the port's ``flash_attention``) are held against
``jax.vjp`` of ``pallas_flash_attention`` run in interpret mode, as
``test_pallas_flash.py`` runs it on the CPU. One-pass shapes (one block)
and split shapes (``block_q``/``block_kv`` below T) both run, with GQA
n_rep 1/2/4, a window of 0 or one that cuts, and Dh 32/64. Inputs are seeded
numpy arrays handed to both frameworks. Tolerances: fp32 within 2e-5
max-abs (accumulation order only); bf16 within 2^-6 of each output row's
largest |value| (the two round dS and P at the same points; a sum taken in
another order can flip one bf16 rounding, 1 to 4 ulps of the row's
largest value). A row whose largest |value| is below 2^-8 of the whole
output's (a cancellation: the first query row's dQ is dS = P(dP - D) with
dP and D equal up to summation order) is held at that floor instead.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.ops import pallas_flash
from pretraining_llm_tpu_torch.ops import cuda_flash
from pretraining_llm_tpu_torch.ops.flash_attention import flash_attention

FP32_TOL = 2e-5
BF16_ROW_RTOL = 2.0**-6


@functools.partial(jax.jit, static_argnames=("window", "block_q", "block_kv"))
def _jax_vjp(q, k, v, do, *, window, block_q, block_kv):
    def f(q, k, v):
        return pallas_flash.pallas_flash_attention(
            q, k, v, causal=True, block_q=block_q, block_kv=block_kv, window=window,
            interpret=True,
        )

    out, vjp = jax.vjp(f, q, k, v)
    return (out,) + vjp(do)


def _inputs(seed, b, t, h, g, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, g, d)).astype(np.float32)
    v = rng.normal(size=(b, t, g, d)).astype(np.float32)
    do = rng.normal(size=(b, t, h, d)).astype(np.float32)
    return q, k, v, do


def _fold(x):
    b, t, n, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * n, t, d)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


CASES = [  # (g, window, t, d, block_q, block_kv)
    (4, 0, 64, 32, 0, 0),     # one pass, n_rep 1
    (2, 0, 64, 64, 0, 0),     # one pass, n_rep 2
    (1, 24, 64, 32, 0, 0),    # one pass, n_rep 4, window
    (4, 0, 64, 32, 16, 16),   # split, n_rep 1
    (2, 24, 80, 32, 16, 16),  # split, n_rep 2, window, T not a multiple of 64
    (1, 0, 64, 64, 32, 16),   # split, n_rep 4, unequal blocks
    (1, 40, 96, 32, 32, 0),   # split by q blocks only, window
    (2, 0, 48, 64, 0, 16),    # split by kv blocks only
]


@pytest.mark.parametrize("g,window,t,d,block_q,block_kv", CASES)
def test_bwd_plain_version_and_function_match_pallas(g, window, t, d, block_q, block_kv):
    b, h = 2, 4
    q, k, v, do = _inputs(g * 1000 + window * 10 + t + d, b, t, h, g, d)
    want_o, want_dq, want_dk, want_dv = _jax_vjp(
        *(jnp.asarray(x) for x in (q, k, v, do)), window=window, block_q=block_q,
        block_kv=block_kv,
    )

    # The plain version on the folds, with K1's plain version for (o, lse).
    qf, kf, vf, dof = (torch.from_numpy(_fold(x)) for x in (q, k, v, do))
    o, lse = cuda_flash.flash_attention_fwd(qf, kf, vf, h, g, window=window)
    dq, dk, dv = cuda_flash.flash_attention_bwd(
        qf, kf, vf, o, lse, dof, h, g, window=window, block_q=block_q, block_kv=block_kv)
    assert _err(_fold(np.asarray(want_dq)), dq) <= FP32_TOL
    assert _err(_fold(np.asarray(want_dk)), dk) <= FP32_TOL
    assert _err(_fold(np.asarray(want_dv)), dv) <= FP32_TOL

    # Autograd through the (B, T, H, Dh) entry: the Function's backward.
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(qt, kt, vt, window=window, block_q=block_q, block_kv=block_kv)
    assert _err(want_o, out.detach()) <= FP32_TOL
    out.backward(torch.from_numpy(do))
    assert _err(want_dq, qt.grad) <= FP32_TOL
    assert _err(want_dk, kt.grad) <= FP32_TOL
    assert _err(want_dv, vt.grad) <= FP32_TOL


@functools.partial(jax.jit, static_argnames=("window", "block"))
def _jax_vjp_seg(q, k, v, seg, do, *, window, block):
    def f(q, k, v):
        return pallas_flash.pallas_flash_attention(
            q, k, v, causal=True, block_q=block, block_kv=block, window=window, segments=seg, interpret=True)

    out, vjp = jax.vjp(f, q, k, v)
    return vjp(do)


@pytest.mark.parametrize("t,d,window,seg,block", [(200, 128, 0, False, 40), (264, 32, 200, True, 24)])
def test_bwd_plain_version_matches_pallas_at_tile_edges(t, d, window, seg, block):
    """The tensor-core dK/dV kernel's edges, scaled down, on the split
    backward (blocks below T): T not a multiple of 64 (200, 264), Dh 128
    and 32, n_rep 4, a window of 200 with document segments. dq, dk, dv of
    the plain version against ``jax.vjp`` of the Pallas kernel in interpret
    mode."""
    b, h, g = 1, 4, 1
    q, k, v, do = _inputs(t + d, b, t, h, g, d)
    rng = np.random.default_rng(t)
    segments = np.cumsum(rng.random((b, t)) < 0.05, axis=1).astype(np.int32) if seg else None
    assert not cuda_flash.backward_is_one_pass(t, block, block)
    want = _jax_vjp_seg(*(jnp.asarray(x) for x in (q, k, v)),
                        None if segments is None else jnp.asarray(segments), jnp.asarray(do),
                        window=window, block=block)
    qf, kf, vf, dof = (torch.from_numpy(_fold(x)) for x in (q, k, v, do))
    tseg = None if segments is None else torch.from_numpy(segments)
    o, lse = cuda_flash.flash_attention_fwd(qf, kf, vf, h, g, window=window, segments=tseg)
    got = cuda_flash.flash_attention_bwd(qf, kf, vf, o, lse, dof, h, g, window=window, block_q=block,
                                         block_kv=block, segments=tseg)
    for w, x in zip(want, got):
        assert _err(_fold(np.asarray(w)), x) <= FP32_TOL


@pytest.mark.parametrize("t,d,g,window,seg", [(200, 64, 2, 0, False), (136, 128, 1, 0, False),
                                             (264, 32, 1, 200, True)])
def test_one_pass_plain_version_matches_pallas_at_tile_edges(t, d, g, window, seg):
    """The tensor-core one-pass kernel's edges, scaled down, on the one pass
    (``block_q = block_kv = T``): T not a multiple of 64 (200, 136, 264),
    Dh 128 with n_rep 4, Dh 32 with a window of 200 and document segments.
    dq, dk, dv of the plain version against ``jax.vjp`` of the Pallas kernel
    in interpret mode."""
    b, h = 1, 4
    q, k, v, do = _inputs(2 * t + d, b, t, h, g, d)
    rng = np.random.default_rng(2 * t)
    segments = np.cumsum(rng.random((b, t)) < 0.05, axis=1).astype(np.int32) if seg else None
    assert cuda_flash.backward_is_one_pass(t, t, t)
    want = _jax_vjp_seg(*(jnp.asarray(x) for x in (q, k, v)),
                        None if segments is None else jnp.asarray(segments), jnp.asarray(do),
                        window=window, block=t)
    qf, kf, vf, dof = (torch.from_numpy(_fold(x)) for x in (q, k, v, do))
    tseg = None if segments is None else torch.from_numpy(segments)
    o, lse = cuda_flash.flash_attention_fwd(qf, kf, vf, h, g, window=window, segments=tseg)
    got = cuda_flash.flash_attention_bwd(qf, kf, vf, o, lse, dof, h, g, window=window, block_q=t, block_kv=t,
                                         segments=tseg)
    for w, x in zip(want, got):
        assert _err(_fold(np.asarray(w)), x) <= FP32_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"])
def test_backward_wrappers_route_by_dtype(monkeypatch, kernel, dtype):
    """Each backward wrapper launches the tensor-core kernel
    (``csrc/flash_bwd_tc.cu``) for bf16 and the CUDA-core one
    (``csrc/flash_bwd.cu``) for fp32, counting the launch on its route; the
    tensor-core one pass gets an fp32 dQ buffer and zeroed int32 turn
    counters, one per (head, 64-query tile) and the ticket. The launch
    itself is replaced by a recorder: no card here."""
    calls = []

    def record(symbol, n_out, what, q, k, v, do, lse, delta, outs, h, g, window, segments, lib="flash_bwd"):
        calls.append((symbol, lib, [(tuple(x.shape), x.dtype, x.count_nonzero().item()) for x in outs]))

    monkeypatch.setattr(cuda_flash, "_bwd_call", record)
    fn = getattr(cuda_flash, kernel)
    bh, t, d, h, g = 8, 200, 64, 4, 2
    q, do = torch.zeros(bh, t, d, dtype=dtype), torch.zeros(bh, t, d, dtype=dtype)
    k, v = torch.zeros(bh // 2, t, d, dtype=dtype), torch.zeros(bh // 2, t, d, dtype=dtype)
    lse = delta = torch.zeros(bh, t)
    before = (fn.launches, fn.launches_tc, fn.launches_fp32)
    fn(q, k, v, do, lse, delta, h, g)
    tc = dtype == torch.bfloat16
    assert (fn.launches, fn.launches_tc, fn.launches_fp32) == (
        before[0] + 1, before[1] + tc, before[2] + (not tc))
    (symbol, lib, outs), = calls
    assert lib == ("flash_bwd_tc" if tc else "flash_bwd")
    assert symbol == f"pllm_{kernel}" + ("_tc" if tc else "")
    if kernel == "flash_bwd_fused" and tc:
        assert outs[3][:2] == ((bh, t, d), torch.float32)
        assert outs[4] == ((bh * -(-t // 64) + 1,), torch.int32, 0)


@pytest.mark.parametrize("g,window,block", [(2, 0, 0), (1, 24, 16)])
def test_bwd_bf16_within_stated_bound(g, window, block):
    b, h, t, d = 2, 4, 64, 32
    q, k, v, do = _inputs(7 + g + window, b, t, h, g, d)
    as_j = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    _, *want = _jax_vjp(*(as_j(x) for x in (q, k, v, do)), window=window, block_q=block,
                        block_kv=block)
    as_t = lambda x: torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)  # noqa: E731
    qt, kt, vt = (as_t(x) for x in (q, k, v))
    out = flash_attention(qt, kt, vt, window=window, block_q=block, block_kv=block)
    out.backward(torch.from_numpy(do).to(torch.bfloat16))
    for w, got in zip(want, (qt.grad, kt.grad, vt.grad)):
        assert got.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        err = np.abs(w - got.float().numpy())
        row = np.maximum(np.abs(w).max(axis=-1, keepdims=True), 2.0**-8 * np.abs(w).max())
        limit = BF16_ROW_RTOL * row
        assert (err <= limit).all(), float((err / np.maximum(limit, 1e-30)).max())


@pytest.mark.parametrize("t", [1, 7, 64, 256, 1024, 1536, 2048, 4096])
@pytest.mark.parametrize("block_q,block_kv", [(0, 0), (512, 0), (0, 512), (128, 256), (2048, 2048), (3, 5)])
def test_backward_algorithm_matches_jax_dispatch(t, block_q, block_kv):
    """The port runs the one-pass kernel exactly where ``_bwd`` runs
    ``_bwd_fused_kernel`` (nq == nk == 1), with the same block sizes."""
    bq, bk = pallas_flash._block_sizes(t, block_q, block_kv)
    assert cuda_flash._block_sizes(t, block_q, block_kv) == (bq, bk)
    assert cuda_flash.backward_is_one_pass(t, block_q, block_kv) == (t // bq == 1 and t // bk == 1)


def test_gpt2_training_shapes_pick_the_jax_algorithms():
    """gpt2-124m (T 1024, auto blocks) is one pass; llama3-1b-gqa (T 2048)
    and any block below T split."""
    assert cuda_flash.backward_is_one_pass(1024)
    assert not cuda_flash.backward_is_one_pass(2048)
    assert not cuda_flash.backward_is_one_pass(1024, 512, 0)
    assert cuda_flash.backward_is_one_pass(256)


def test_bwd_wrapper_validates_shapes():
    q = torch.zeros(8, 16, 32)
    kv = torch.zeros(4, 16, 32)
    lse = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="fold"):
        cuda_flash.flash_attention_bwd(q, torch.zeros(3, 16, 32), torch.zeros(3, 16, 32), q, lse, q, 4, 2)
    with pytest.raises(ValueError, match="do not match"):
        cuda_flash.flash_attention_bwd(q, kv, kv, q, torch.zeros(8, 15), q, 4, 2)
    with pytest.raises(ValueError, match="do not match"):
        cuda_flash.flash_attention_bwd(q, kv, kv, q[:, :8], lse, q, 4, 2)
