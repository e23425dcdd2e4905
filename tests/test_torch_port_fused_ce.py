"""The port's fused cross-entropy head against the JAX package's.

Mirrors ``test_pallas_ce.py``: the plain versions of the three fused CE
kernels (``ops/ce_reference.py``, run by ``ops/cuda_ce.py`` for CPU
tensors) and ``FusedCE`` gradients are held against
``pallas_ce.fused_cross_entropy(..., interpret=True)`` on the same
numpy-seeded inputs; then ``loss_fn(ce_impl="fused")``, the biased-head
degradation and AdamW train steps against the JAX package. The JAX side is
jitted so that interpret mode stays fast.

Tolerances: fp32 forward within 1e-5 (rtol and atol, the JAX test's bar:
summation order only); gradients rtol 1e-4, atol 1e-5; bf16 inputs: loss
and lse within 1e-5 of max(1, |value|) (both form fp32 logits from the same
bf16 operands), dH and dW within 2^-6 of each output row's largest |value|
(both round p~ to bf16 at the same point; a sum in another order can flip a
rounding); model loss within 1e-6 relative, gradient leaves rtol 1e-4 and
atol 1e-5; train steps as ``test_torch_port_training.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.ops import pallas_ce
from pretraining_llm_tpu.training import train_step as jts
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch import train as train_cli
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.models import transformer as ttf
from pretraining_llm_tpu_torch.ops import ce_reference, cuda_ce
from pretraining_llm_tpu_torch.ops.fused_ce import FusedCE, fused_cross_entropy
from pretraining_llm_tpu_torch.training import optimizer as topt
from pretraining_llm_tpu_torch.training import train_step as tts

FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BF16_ROW_RTOL = 2.0**-6
BLOCKS = dict(block_s=16, block_v=128)  # the JAX kernel's tiles (tests/test_pallas_ce.py)


def _inputs(seed, s=64, d=32, v=200):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(s, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.2).astype(np.float32)
    labels = rng.integers(0, v, (s,)).astype(np.int32)
    return h, w, labels


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


@functools.partial(jax.jit, static_argnames=("dtype",))
def _jax_fwd(h, w, labels, *, dtype):
    h, w = h.astype(_jdt(dtype)), w.astype(_jdt(dtype))
    loss, (_, _, _, lse) = pallas_ce._ce_fwd(h, w, labels, 16, 128, True)
    return loss, lse[:, 0]


@functools.partial(jax.jit, static_argnames=("dtype",))
def _jax_bwd(h, w, labels, g, *, dtype):
    h, w = h.astype(_jdt(dtype)), w.astype(_jdt(dtype))
    _, residuals = pallas_ce._ce_fwd(h, w, labels, 16, 128, True)
    dh, dw, _ = pallas_ce._ce_bwd(16, 128, True, residuals, g)
    return dh, dw


@jax.jit
def _jax_grads(h, w, labels, weights):
    def f(h, w):
        losses = pallas_ce.fused_cross_entropy(h, w, labels, interpret=True, **BLOCKS)
        return jnp.sum(losses * weights)

    return jax.grad(f, (0, 1))(h, w)


def _rows_close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    limit = rtol * np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= np.maximum(limit, 1e-30)), float(np.abs(got - want).max())


# ---------------------------------------------------------------------------
# Kernel plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v", [200, 256, 384])  # incl. non-multiple-of-128
def test_forward_matches_jax_kernel(v):
    h, w, labels = _inputs(0, v=v)
    want_loss, want_lse = _jax_fwd(h, w, labels, dtype="float32")
    got = fused_cross_entropy(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_loss), rtol=FWD_TOL, atol=FWD_TOL)
    loss, lse = cuda_ce.fused_ce_fwd(torch.from_numpy(h), torch.from_numpy(w).t(), torch.from_numpy(labels))
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=FWD_TOL, atol=FWD_TOL)
    assert torch.equal(loss, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v", [200, 384])
def test_backward_plain_versions_match_jax_kernels(v, dtype):
    """dH and dW with a non-uniform cotangent, from the JAX forward's lse,
    against ``_ce_bwd``'s two kernels; W passed as its (V, D) transpose, as
    the CUDA kernels read it."""
    h, w, labels = _inputs(1, s=48, d=32, v=v)
    g = np.linspace(0.0, 2.0, 48).astype(np.float32)
    want_dh, want_dw = _jax_bwd(h, w, labels, g, dtype=dtype)
    _, want_lse = _jax_fwd(h, w, labels, dtype=dtype)
    th, tw = (torch.from_numpy(x).to(_tdt(dtype)) for x in (h, w))
    lse, tg, tl = torch.tensor(np.asarray(want_lse)), torch.from_numpy(g), torch.from_numpy(labels)
    dh = cuda_ce.fused_ce_dh(th, tw.t(), tl, lse, tg)
    dw = cuda_ce.fused_ce_dw(th, tw.t(), tl, lse, tg)
    assert dh.dtype == dw.dtype == _tdt(dtype) and dw.shape == (v, 32)
    for got, want in ((dh, want_dh), (dw.t(), want_dw)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_RTOL, atol=GRAD_ATOL)
        else:
            _rows_close(got.float().numpy(), np.asarray(want, np.float32), BF16_ROW_RTOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_match_jax(weighted):
    """``FusedCE`` through autograd: the mean (uniform cotangent) and a
    per-token weighted sum (non-uniform)."""
    h, w, labels = _inputs(2, s=32, d=16, v=160)
    weights = (np.linspace(0.0, 2.0, 32) if weighted else np.full(32, 1 / 32)).astype(np.float32)
    want = _jax_grads(h, w, labels, weights)
    th, tw = (torch.from_numpy(x).requires_grad_(True) for x in (h, w))
    losses = fused_cross_entropy(th, tw, torch.from_numpy(labels))
    (losses * torch.from_numpy(weights)).sum().backward()
    for got, ref in zip((th.grad, tw.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_bf16_inputs_match_jax_kernel():
    h, w, labels = _inputs(3)
    want_loss, want_lse = _jax_fwd(h, w, labels, dtype="bfloat16")
    th, tw = (torch.from_numpy(x).to(torch.bfloat16) for x in (h, w))
    loss, lse = cuda_ce.fused_ce_fwd(th, tw.t(), torch.from_numpy(labels))
    for got, ref in ((loss, want_loss), (lse, want_lse)):
        ref = np.asarray(ref)
        assert np.all(np.abs(got.numpy() - ref) <= FWD_TOL * np.maximum(1.0, np.abs(ref)))


def test_plain_version_tiles_do_not_change_the_result():
    """The walk over the JAX default vocabulary tiles (V 2304: nine tiles
    of 256) moves only the summation order against one dense pass."""
    h, w, labels = (torch.from_numpy(x) for x in _inputs(4, v=2304))
    assert ce_reference._tiles(64, 2304, 0, 0)[1:] == (256, 2304, 1, 9)
    loss, lse = ce_reference.fused_ce_fwd_reference(h, w, labels)
    logits = h @ w
    want_lse = torch.logsumexp(logits, dim=1)
    want_loss = want_lse - logits.gather(1, labels.long()[:, None])[:, 0]
    assert float((loss - want_loss).abs().max()) <= 1e-5 and float((lse - want_lse).abs().max()) <= 1e-5
    assert ce_reference._tiles(64, 200, 16, 128) == (16, 128, 256, 4, 2)
    assert ce_reference._tiles(12 * 1024, 50304, 0, 0) == (256, 128, 50304, 48, 393)  # 50304 = 393 * 128


def test_bf16_p_rounds_the_label_term_of_the_mean_up():
    """The reference's rounding point: p~ in bf16 before the products. For
    the mean over S = 12 * 1024 tokens each label term g * (p - 1) is about
    -1/12288 = -(4/3) 2^-14, which bf16 rounds up in magnitude by 0.195%,
    alike for every token while p ~ 1/V is small; so near init (the label
    term dominant) the bf16-p~ dH is about 0.2% larger in norm than the
    fp32-p~ one."""
    s, d, v = 12 * 1024, 32, 4096
    assert float(torch.tensor(-1.0 / s).to(torch.bfloat16)) / (-1.0 / s) - 1 == pytest.approx(0.00195, abs=1e-5)
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(size=(s, d)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(d, v)) * 0.02).astype(np.float32)).to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, v, (s,)).astype(np.int32))
    g = torch.full((s,), 1.0 / s)
    _, lse = ce_reference.fused_ce_fwd_reference(h, w, labels)
    dh = ce_reference.fused_ce_dh_reference(h, w, labels, lse, g).float()
    p = torch.exp(h.float() @ w.float() - lse[:, None])
    p[torch.arange(s), labels.long()] -= 1.0
    dh32 = (p * g[:, None]) @ w.float().T
    term = -(1 - 1 / v) / s  # the label term at p = 1/V
    up = float(torch.tensor(term).to(torch.bfloat16)) / term - 1
    assert float(dh.norm() / dh32.norm() - 1) == pytest.approx(up, rel=0.1)


def test_bias_rejected():
    h, w, labels = (torch.from_numpy(x) for x in _inputs(4))
    with pytest.raises(ValueError, match="bias"):
        fused_cross_entropy(h, w, labels, bias=torch.zeros(w.shape[1]))


def test_cuda_wrappers_check_their_inputs():
    h, w, labels = (torch.from_numpy(x) for x in _inputs(5))
    with pytest.raises(ValueError, match="expected h"):
        cuda_ce.fused_ce_fwd(h, w, labels)  # w not transposed to (V, D)
    with pytest.raises(ValueError, match="lse and g"):
        cuda_ce.fused_ce_dh(h, w.t(), labels, torch.zeros(3), torch.zeros(64))


# ---------------------------------------------------------------------------
# The bf16 forward on the tensor cores (csrc/fused_ce_tc.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"), (torch.float32, "fp32")])
def test_ce_route(dtype, want):
    assert cuda_ce.ce_route(dtype) == want


def test_ce_route_raises_on_other_dtypes():
    with pytest.raises(TypeError):
        cuda_ce.ce_route(torch.float16)


@pytest.mark.parametrize("s,v", [(12288, 50304), (1000, 50257), (300, 200), (129, 1000), (65536, 128256)])
def test_ce_partitions_cover_every_vocabulary_tile_once(s, v):
    """The partitions hold every 256-column tile once and none is empty;
    T3's head (96 token tiles) fills the 132 SMs in whole waves."""
    parts, per = cuda_ce.ce_partitions(s, v, 132)
    n_vt = -(-v // cuda_ce.TC_BN)
    assert 1 <= parts <= cuda_ce.MAX_PARTITIONS and (parts - 1) * per < n_vt <= parts * per
    if (s, v) == (12288, 50304):
        assert (-(-s // cuda_ce.TC_BM) * parts) % 132 == 0


def _b9_model(h, w, labels, parts, per):
    """The tensor-core forward's arithmetic: fp32 logits of the bf16
    operands in 256-column tiles, an online (m, l) and the label's logit per
    partition of ``per`` tiles, the vocabulary tail at NEG_INF, then the
    partials merged in partition order."""
    s, v = h.shape[0], w.shape[1]
    logits = h.float() @ w.float()  # (S, V)
    bn = cuda_ce.TC_BN
    n_vt = -(-v // bn)
    m_p, l_p, gold_p = [], [], []
    for part in range(parts):
        m = torch.full((s,), -1e30)
        l = torch.zeros(s)
        gold = torch.zeros(s)
        for vt in range(part * per, min(n_vt, (part + 1) * per)):
            cols = torch.arange(vt * bn, vt * bn + bn)
            tile = torch.full((s, bn), -1e30)
            tile[:, cols < v] = logits[:, vt * bn:min(v, vt * bn + bn)]
            hit = cols[None, :] == labels.long()[:, None]
            gold = gold + (tile * hit).sum(1)
            m_new = torch.maximum(m, tile.amax(1))
            l = l * torch.exp(m - m_new) + torch.exp(tile - m_new[:, None]).sum(1)
            m = m_new
        m_p.append(m), l_p.append(l), gold_p.append(gold)
    m = torch.stack(m_p).amax(0)
    l = sum(lp * torch.exp(mp - m) for mp, lp in zip(m_p, l_p))
    lse = m + torch.log(l)
    return lse - sum(gold_p), lse


@pytest.mark.parametrize("s,d,v,parts", [(200, 64, 600, 1), (200, 64, 600, 2), (200, 64, 600, 3),
                                         (130, 128, 300, 2)])
def test_b9_partition_merge_matches_pallas(s, d, v, parts):
    """The partition merge of the bf16 forward, with token and vocabulary
    tails, against the Pallas forward in interpret mode: loss and lse
    within 1e-4 of max(1, |value|), the card's bar."""
    h, w, labels = _inputs(40 + parts, s=s, d=d, v=v)
    want_loss, want_lse = (np.asarray(x) for x in _jax_fwd(h, w, labels, dtype="bfloat16"))
    th = torch.from_numpy(h).bfloat16()
    tw = torch.from_numpy(w).bfloat16()
    n_vt = -(-v // cuda_ce.TC_BN)
    per = -(-n_vt // parts)
    loss, lse = _b9_model(th, tw, torch.from_numpy(labels), -(-n_vt // per), per)
    for got, want in ((loss.numpy(), want_loss), (lse.numpy(), want_lse)):
        assert np.all(np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want)))


def test_tc_kernel_source_and_wrapper_agree_on_shared_memory():
    """``tc_smem_bytes`` is ``Smem::ALLOC`` of ``csrc/fused_ce_tc.cu``, the
    tile constants are the source's, and one block fits."""
    import re
    from pathlib import Path

    src = (Path(cuda_ce.__file__).parent.parent / "csrc" / "fused_ce_tc.cu").read_text()
    env = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
           for name in ("BM", "BN", "BK", "STAGES")}
    assert (env["BM"], env["BN"], env["BK"], env["STAGES"]) == (
        cuda_ce.TC_BM, cuda_ce.TC_BN, cuda_ce.TC_BK, cuda_ce.TC_STAGES)
    body = src[src.index("struct Smem {"):]
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body[:body.index("};")]):
        env[name] = eval(expr, {}, env)
    assert env["ALLOC"] == cuda_ce.tc_smem_bytes() <= 232448


# ---------------------------------------------------------------------------
# The bf16 dH and dW on the tensor cores (csrc/fused_ce_bwd_tc.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"), (torch.float32, "fp32")])
def test_ce_bwd_route(dtype, want):
    assert cuda_ce.ce_bwd_route(dtype) == want


def test_ce_bwd_route_raises_on_other_dtypes():
    with pytest.raises(TypeError):
        cuda_ce.ce_bwd_route(torch.float16)


@pytest.mark.parametrize("dtype,d,ok", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 320, True), (torch.bfloat16, 768, True),
    (torch.bfloat16, 2048, True), (torch.bfloat16, 96, False), (torch.bfloat16, 0, False),
    (torch.float32, 768, True), (torch.float32, 64, True), (torch.float32, 1024, True),
    (torch.float32, 2048, True), (torch.float32, 320, True), (torch.float32, 96, False),
])
def test_hidden_width_gate(dtype, d, ok):
    """Both dtypes take any positive multiple of 64 (llama3-1b-gqa's 2048,
    moe-8x350m's 1024 in fp32 included): every fused CE kernel streams D."""
    assert cuda_ce.hidden_dim_ok(dtype, d) is ok


@pytest.mark.parametrize("kind", ["dh", "dw"])
@pytest.mark.parametrize("s,v,d", [(12288, 50304, 768), (2048, 32000, 2048), (1000, 50257, 1024),
                                   (136, 300, 320), (2500, 1000, 256), (100, 100, 64)])
def test_ce_bwd_plan_covers_every_walked_tile_and_column_once(kind, s, v, d):
    """The chunks cover D with no empty chunk, the partitions hold every
    walked tile once with none empty, and the scratch stays bounded."""
    dc, chunks, parts, per = cuda_ce.ce_bwd_plan(kind, s, v, d, 132)
    n_wt = -(-(v if kind == "dh" else s) // cuda_ce.BWD_BN)
    assert dc in cuda_ce.BWD_CHUNKS and chunks == -(-d // dc) and (chunks - 1) * dc < d
    assert 1 <= parts <= cuda_ce.MAX_BWD_PARTITIONS and (parts - 1) * per < n_wt <= parts * per
    if (s, v, d) == (2048, 32000, 2048):  # llama3-1b-gqa's head: no partial scratch
        assert parts == 1


def test_ce_bwd_plan_rejects_other_kinds():
    with pytest.raises(ValueError):
        cuda_ce.ce_bwd_plan("dx", 128, 128, 64, 132)


def _bwd_tc_model(kind, h, w_vd, labels, lse, g, dc, parts):
    """The tensor-core dH / dW kernel's arithmetic: per output chunk of dc
    columns and partition of whole 128-row walked tiles, each logits tile
    summed over 64-column slices of D in the kernel's order (ascending from
    the slice after the chunk, so the chunk's come last), p~ =
    g * (exp2(logit log2 e - lse log2 e) - onehot) in fp32 rounded to bf16,
    the chunk summed over the walked tiles in order, the partitions' sums
    added in partition order; written in bf16. Returns (S, D) for "dh",
    (V, D) for "dw"."""
    log2e = 1.4426950408889634
    (s, d), v = h.shape, w_vd.shape[0]
    res, walk = (h.float(), w_vd.float()) if kind == "dh" else (w_vd.float(), h.float())
    bn, bk = cuda_ce.BWD_BN, 64
    n_k, n_wt = d // bk, -(-walk.shape[0] // bn)
    per = -(-n_wt // parts)
    ls, lab = lse.float() * log2e, labels.long()
    out = torch.zeros(res.shape[0], d)
    for k_lo in range(0, n_k, dc // bk):
        nc = min(dc // bk, n_k - k_lo)
        order = [(k_lo + nc + i) % n_k for i in range(n_k)]
        cols = slice(k_lo * bk, (k_lo + nc) * bk)
        total = None
        for part in range(-(-n_wt // per)):
            acc = torch.zeros(res.shape[0], nc * bk)
            for wt in range(part * per, min(n_wt, (part + 1) * per)):
                js = torch.arange(wt * bn, min(walk.shape[0], (wt + 1) * bn))
                logits = torch.zeros(res.shape[0], len(js))
                for k in order:
                    logits += res[:, k * bk:(k + 1) * bk] @ walk[js, k * bk:(k + 1) * bk].T
                if kind == "dh":
                    p = torch.exp2(logits * log2e - ls[:, None]) - (js[None, :] == lab[:, None]).float()
                    p = p * g[:, None]
                else:
                    p = torch.exp2(logits * log2e - ls[None, js]) - (torch.arange(v)[:, None] == lab[None, js]).float()
                    p = p * g[None, js]
                acc += p.to(torch.bfloat16).float() @ walk[js, cols]
            total = acc if total is None else total + acc
        out[:, cols] = total
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("s,d,v,dc,parts", [(136, 320, 300, 256, 1), (136, 320, 300, 128, 2),
                                             (200, 192, 260, 192, 3)])
def test_bwd_tc_walk_matches_pallas(s, d, v, dc, parts):
    """The walk of csrc/fused_ce_bwd_tc.cu (D-chunks, a last chunk narrower
    than DC at D 320, the rotated slice order, partitions, token and
    vocabulary tails, labels in the last vocabulary tile, a non-uniform g)
    against ``_bwd_dh_kernel`` and ``_bwd_dw_kernel`` in interpret mode:
    each output row within BF16_ROW_RTOL of its largest |value|."""
    h, w, labels = _inputs(50 + dc, s=s, d=d, v=v)
    labels[::3] = v - 1 - labels[::3] % 40  # a third of the labels in the last 128-row vocabulary tile
    g = np.linspace(0.25, 2.0, s).astype(np.float32)
    want_dh, want_dw = _jax_bwd(h, w, labels, g, dtype="bfloat16")
    _, lse = _jax_fwd(h, w, labels, dtype="bfloat16")
    th = torch.from_numpy(h).bfloat16()
    tw = torch.from_numpy(w).bfloat16().t().contiguous()
    args = (torch.from_numpy(labels), torch.tensor(np.asarray(lse)), torch.from_numpy(g))
    dh = _bwd_tc_model("dh", th, tw, *args, dc, parts)
    dw = _bwd_tc_model("dw", th, tw, *args, dc, parts)
    _rows_close(dh.float().numpy(), np.asarray(want_dh, np.float32), BF16_ROW_RTOL)
    _rows_close(dw.float().numpy(), np.asarray(want_dw, np.float32).T, BF16_ROW_RTOL)


def test_tc_bwd_kernel_source_and_wrapper_agree():
    """``tc_bwd_smem_bytes(dc)`` is ``Smem<DC>::ALLOC`` of
    ``csrc/fused_ce_bwd_tc.cu`` and one block fits at every chunk width the
    source instantiates, which are the wrapper's; so are the tile
    constants."""
    import re
    from pathlib import Path

    src = (Path(cuda_ce.__file__).parent.parent / "csrc" / "fused_ce_bwd_tc.cu").read_text()
    env = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
           for name in ("BM", "BN", "BK", "STAGES")}
    assert (env["BM"], env["BN"], env["BK"], env["STAGES"]) == (
        cuda_ce.BWD_BM, cuda_ce.BWD_BN, cuda_ce.TC_BK, cuda_ce.BWD_STAGES)
    body = src[src.index("struct Smem {"):]
    for dc in cuda_ce.BWD_CHUNKS:
        env["DC"] = dc
        for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body[:body.index("};")]):
            env[name] = eval(expr, {}, env)
        assert env["ALLOC"] == cuda_ce.tc_bwd_smem_bytes(dc) <= 232448
    for mode in ("DH", "DW"):
        assert tuple(int(x) for x in re.findall(rf"PLLM_CE_BWD\({mode}, (\d+)\)", src)) == cuda_ce.BWD_CHUNKS


def test_ablation_edits_apply_to_the_kernel_source():
    """``utils/ce_bwd_ablation.py`` times copies of the kernel with one part
    taken out; each of its edits must still find its text in the source."""
    from pretraining_llm_tpu_torch.ops import _build
    from pretraining_llm_tpu_torch.utils import ce_bwd_ablation

    src = (_build.CSRC / "fused_ce_bwd_tc.cu").read_text()
    assert set(ce_bwd_ablation.VARIANTS) >= {"kernel", "no_products", "no_resident_loads"}
    for name, edits in ce_bwd_ablation.VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) >= 1, (name, old)


# ---------------------------------------------------------------------------
# Through the model
# ---------------------------------------------------------------------------

GPT2 = dict(
    vocab_size=97, context_length=32, d_model=32, n_heads=4, n_layers=2,
    activation="gelu", norm="layernorm", pos_embed="learned",
    tie_embeddings=True, qkv_bias=True, mlp_bias=True,
    compute_dtype="float32", attention_impl="flash",
)
LLAMA_GQA = dict(
    vocab_size=97, context_length=32, d_model=32, n_heads=4, n_kv_heads=2,
    n_layers=2, activation="swiglu", norm="rmsnorm", pos_embed="rope",
    tie_embeddings=False, qkv_bias=False, mlp_bias=False,
    compute_dtype="float32", attention_impl="flash",
)
FLAVOURS = {"gpt2": GPT2, "llama_gqa": LLAMA_GQA}


def _tree(kw, seed=0):
    """The JAX init tree of ``kw`` with seeded noise on every leaf (norm
    scales near 1), as numpy float32."""
    jc = jcfg.ModelConfig(**kw)
    layout = jax.eval_shape(functools.partial(jtf.init_params, jc), jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.05, spec.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, layout)


def _batch(kw, b, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, kw["vocab_size"], (b, kw["context_length"] + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x, np.float32)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_value_and_grad(params, x, y, *, cfg):
    return jax.value_and_grad(lambda p: jtf.loss_fn(p, x, y, cfg))(params)


_jax_eval_loss = jax.jit(functools.partial(jtf.loss_fn, include_aux=False), static_argnames=("cfg",))


def _port_value_and_grad(params, x, y, cfg):
    leaves = topt.tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    loss = ttf.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y), cfg)
    loss.backward()
    return loss.detach(), topt.tree_map(lambda p: p.grad, leaves)


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_loss_fn_fused_matches_jax(flavour):
    """``loss_fn(ce_impl="fused")`` in both packages: the tied head (W read
    through the embedding's transpose) and an untied, biasless one."""
    kw = dict(FLAVOURS[flavour], ce_impl="fused")
    tree = _tree(kw)
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    x, y = _batch(kw, 3, seed=1)
    params = bridge.params_from_numpy(tree, tc, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    want, want_g = _jax_value_and_grad(jparams, jnp.asarray(x), jnp.asarray(y), cfg=jc)
    calls = cuda_ce.fused_ce_fwd.launches
    got, got_g = _port_value_and_grad(params, x, y, tc)
    assert cuda_ce.fused_ce_fwd.launches == calls  # CPU tensors: the plain versions, no launch
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    w, g = _flat(want_g), _flat(bridge.params_to_numpy(got_g))
    assert w.keys() == g.keys()
    for name in w:
        np.testing.assert_allclose(g[name], w[name], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
    with torch.no_grad():
        got_eval = ttf.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y), tc, include_aux=False)
    want_eval = _jax_eval_loss(jparams, jnp.asarray(x), jnp.asarray(y), cfg=jc)
    np.testing.assert_allclose(float(got_eval), float(want_eval), rtol=1e-6)


def test_fused_head_runs_the_fused_function_not_the_chunked_head(monkeypatch):
    """An unbiased head under ``ce_impl="fused"`` goes through ``FusedCE``
    and never through the chunked head."""
    kw = dict(GPT2, ce_impl="fused")
    tc = tcfg.ModelConfig(**kw)
    params = bridge.params_from_numpy(_tree(kw), tc, device="cpu")
    x, y = _batch(kw, 2, seed=3)

    def refuse(*a, **k):
        raise AssertionError("the chunked head ran under ce_impl='fused'")

    monkeypatch.setattr(ttf._LseSavedCE, "apply", refuse)
    params = topt.tree_map(lambda p: p.requires_grad_(True), params)
    loss = ttf.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y), tc)
    node = loss.grad_fn
    while node is not None and "FusedCE" not in type(node).__name__:
        node = node.next_functions[0][0]
    assert node is not None


def test_biased_head_warns_and_equals_chunked():
    """A biased head asked for the fused kernel degrades loudly to the
    chunked head, as the JAX package does, and gives its loss."""
    kw = dict(LLAMA_GQA, lm_head_bias=True)
    tc = tcfg.ModelConfig(**kw)
    params = bridge.params_from_numpy(_tree(kw), tc, device="cpu")
    x, y = (torch.from_numpy(a) for a in _batch(kw, 2, seed=2))
    want = ttf.loss_fn(params, x, y, tc)
    with pytest.warns(UserWarning, match="fused.*degraded to chunked"):
        got = ttf.loss_fn(params, x, y, tcfg.ModelConfig(**dict(kw, ce_impl="fused")))
    assert float(got) == float(want)
    with pytest.warns(UserWarning, match="fused.*degraded to chunked"):
        jloss = jtf.loss_fn(jax.tree.map(jnp.asarray, _tree(kw)), jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                            jcfg.ModelConfig(**dict(kw, ce_impl="fused")))
    np.testing.assert_allclose(float(got), float(jloss), rtol=1e-5)


def test_fused_ce_with_z_loss_is_refused_by_the_config():
    with pytest.raises(ValueError, match="z_loss_coef"):
        tcfg.ModelConfig(**dict(GPT2, ce_impl="fused", z_loss_coef=1e-4))


# ---------------------------------------------------------------------------
# Train steps (the model of ``test_torch_port_training.py::TRAIN_MODEL``:
# no QKV bias, whose true gradient is 0 and whose rounding noise Adam's
# normalisation blows up in either package)
# ---------------------------------------------------------------------------

TRAIN_MODEL = dict(GPT2, qkv_bias=False, ce_impl="fused")
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_fused_match_jax(microbatches):
    """Two AdamW steps of ``build_train_step`` in both packages under
    ``ce_impl="fused"``, then the eval loop (no grad)."""
    train_kw = dict(batch_size=4, lr=1e-3, train_steps=10, warmup_frac=0.2, microbatches=microbatches)
    jc = jcfg.Config(model=jcfg.ModelConfig(**TRAIN_MODEL), train=jcfg.TrainConfig(**train_kw))
    tc = tcfg.Config(model=tcfg.ModelConfig(**TRAIN_MODEL), train=tcfg.TrainConfig(**train_kw))
    tree = _tree(TRAIN_MODEL, 1)
    jstate = jts.init_train_state(jc, jax.random.key(0))
    jstate["params"] = jax.tree.map(jnp.asarray, tree)
    tstate = tts.init_train_state(tc, device="cpu")
    tstate["params"] = bridge.params_from_numpy(tree, tc.model, device="cpu")
    tstate["opt"] = topt.adamw_init(tstate["params"])
    jstep, tstep = jts.build_train_step(jc), tts.build_train_step(tc)
    for i in range(2):
        x, y = _batch(TRAIN_MODEL, 4, seed=10 + i)
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tm = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y)))
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= LOSS_RTOL * abs(float(jm[key])), (i, key)
    w, g = _flat(jstate["params"]), _flat(bridge.params_to_numpy(tstate["params"]))
    for name in w:
        assert float(np.abs(w[name] - g[name]).max()) <= PARAM_TOL, name
    xs, ys = (np.stack(a) for a in zip(*(_batch(TRAIN_MODEL, 4, seed=20 + i) for i in range(2))))
    want = float(jts.build_eval_loop(jc)(jstate, (jnp.asarray(xs), jnp.asarray(ys))))
    got = float(tts.build_eval_loop(tc)(tstate, (torch.from_numpy(xs), torch.from_numpy(ys))))
    assert abs(got - want) <= LOSS_RTOL * abs(want)


def test_fused_ce_output_keeps_w_transposed_without_a_copy():
    """The tied head hands ``FusedCE`` the embedding's transpose; its
    (V, D) view is the embedding's storage (no copy of the table), and the
    gradient reaches the embedding in its own layout."""
    emb = torch.randn(50, 16, requires_grad=True)
    h = torch.randn(8, 16, requires_grad=True)
    labels = torch.randint(0, 50, (8,), dtype=torch.int32)
    w = emb.T
    assert w.t().is_contiguous() and w.t().data_ptr() == emb.data_ptr()
    loss = FusedCE.apply(h, w, labels)
    loss.sum().backward()
    dense = torch.nn.functional.cross_entropy(h.detach() @ emb.detach().T, labels.long(), reduction="none")
    assert float((loss.detach() - dense).abs().max()) <= 1e-5
    assert emb.grad.shape == emb.shape and h.grad.shape == h.shape


def test_cli_trains_with_the_fused_head_and_document_masks(tmp_path):
    """``python -m pretraining_llm_tpu_torch.train`` with ``ce_impl=fused``
    and ``doc_mask_token`` on the CPU (the kernels' plain versions)."""
    final = train_cli.main([
        "--preset", "tiny", "--data", "synthetic", "--no-resume", "--device", "cpu", "--override",
        "model.ce_impl='fused'", "model.doc_mask_token=0", "model.compute_dtype='float32'",
        "train.train_steps=3", "train.eval_interval=0", f"train.checkpoint_dir='{tmp_path}'",
    ])
    assert np.isfinite(final["loss"])
