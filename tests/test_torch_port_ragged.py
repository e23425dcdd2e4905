"""The port's ragged paged attention against the JAX package's.

The plain version (``ops/cuda_ragged.py::ragged_gather_attention``, what the
wrapper runs on CPU tensors) is held against the Pallas ragged kernel in
interpret mode, in its one-pass and KV-split forms and in the classic and
AMLA forms, and against JAX's own ``ragged_gather_attention``, over exact
and int8 pools (fp32 and bf16 scale pages), GQA, sliding windows and rows
mixing q_len 0, 1, a few and the whole T. Inputs are seeded numpy arrays
handed to both frameworks. Tolerances: 2e-5 max-abs against the classic
form and the gather (accumulation order only), 2e-4 against the AMLA form
(its integer-quantized base-2 running max, the JAX package's own AMLA bar).
The model's routing to the ragged kernel is checked with a spy.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.ops import pallas_ragged
from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.models import transformer
from pretraining_llm_tpu_torch.ops import cuda_ragged

TOL = 2e-5
AMLA_TOL = 2e-4
B, T, H, D, BS, N_BLOCKS, MAX_BLOCKS = 5, 7, 4, 16, 8, 40, 6


def _state(rng, g, pool):
    """Fragmented tables with dead tails; rows with q_len 0, 1, a few and T,
    at offsets from 0 to the table's capacity."""
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    shape = (N_BLOCKS, BS, g, D)
    scales = None
    if pool == "exact":
        kp = rng.normal(size=shape).astype(np.float32)
        vp = rng.normal(size=shape).astype(np.float32)
    else:
        kp = rng.integers(-127, 128, size=shape).astype(np.int8)
        vp = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = (np.abs(rng.normal(size=shape[:-1] + (1,))) + 0.05).astype(np.float32)
        vs = (np.abs(rng.normal(size=shape[:-1] + (1,))) + 0.05).astype(np.float32)
        if pool == "int8-bf16":  # values a bf16 scale page can hold exactly
            ks = torch.from_numpy(ks).bfloat16().float().numpy()
            vs = torch.from_numpy(vs).bfloat16().float().numpy()
        scales = (ks, vs)
    q_lens = np.array([0, 1, 3, T, 2], np.int32)
    seq = np.array([5, 0, 17, MAX_BLOCKS * BS - T, 30], np.int32)
    perm = rng.permutation(np.arange(1, N_BLOCKS)).tolist()
    tables = np.zeros((B, MAX_BLOCKS), np.int32)
    for i in range(B):
        n_pages = (int(seq[i]) + max(int(q_lens[i]), 1) - 1) // BS + 1
        tables[i, :n_pages] = [perm.pop() for _ in range(n_pages)]
    return q, kp, vp, tables, seq, q_lens, scales


def _jax(x, bf16=False):
    return jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)


def _torch(x, bf16=False):
    t = torch.from_numpy(x)
    return t.bfloat16() if bf16 else t


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


_POOLS = ["exact", "int8-f32", "int8-bf16"]
_CASES = [
    (splits, amla, pool)
    for splits in (1, 2, 3, None)
    for amla in (False, True)
    for pool in _POOLS
]


@pytest.mark.parametrize("splits,amla,pool", _CASES)
def test_ragged_plain_version_matches_pallas(splits, amla, pool):
    """Window and GQA vary with the case: every (splits, form, pool) meets
    G = H and a GQA group, and a window, across the grid."""
    i = _CASES.index((splits, amla, pool))
    g = (4, 2, 1)[i % 3]
    window = 12 if i % 2 else 0
    rng = np.random.default_rng(i)
    q, kp, vp, tables, seq, q_lens, scales = _state(rng, g, pool)
    bf16 = pool == "int8-bf16"
    kw = {}
    tkw = {}
    if scales is not None:
        kw = dict(k_scale=_jax(scales[0], bf16), v_scale=_jax(scales[1], bf16))
        tkw = dict(k_scale=_torch(scales[0], bf16), v_scale=_torch(scales[1], bf16))
    args = (q, kp, vp, tables, seq, q_lens)
    want = pallas_ragged.ragged_paged_attention(
        *map(_jax, args), window=window, interpret=True, kv_splits=splits, amla=amla, **kw
    )
    gather = pallas_ragged.ragged_gather_attention(*map(_jax, args), window=window, **kw)
    got = cuda_ragged.ragged_paged_attention(
        *map(_torch, args), window=window, kv_splits=splits, amla=amla, **tkw
    )
    assert got.shape == q.shape and got.dtype == torch.float32
    assert _err(want, got) <= (AMLA_TOL if amla else TOL)
    assert _err(gather, got) <= TOL
    # Pad queries and the q_len-0 row come back as zeros.
    got = got.numpy()
    assert not got[0].any()
    for row, n in enumerate(q_lens):
        assert not got[row, n:].any()


def test_plain_version_in_bf16_matches_jax_gather():
    """bf16 queries and exact bf16 pools: fp32 math inside, q's dtype out."""
    rng = np.random.default_rng(7)
    q, kp, vp, tables, seq, q_lens, _ = _state(rng, 2, "exact")
    args = (q, kp, vp, tables, seq, q_lens)
    bf = [True, True, True, False, False, False]
    want = pallas_ragged.ragged_gather_attention(*(_jax(a, f) for a, f in zip(args, bf)), window=0)
    got = cuda_ragged.ragged_gather_attention(*(_torch(a, f) for a, f in zip(args, bf)))
    assert got.dtype == torch.bfloat16
    assert _err(np.asarray(want, np.float32), got.float()) <= 2.0**-8


def test_auto_kv_splits_matches_jax():
    for nb in range(1, 48):
        for b in range(1, 16):
            assert cuda_ragged._auto_kv_splits(nb, b) == pallas_ragged._auto_kv_splits(nb, b), (nb, b)


def test_ragged_wrapper_validation():
    q3 = torch.zeros(2, 4, 16)
    kp = torch.zeros(8, 8, 2, 16)
    tbl = torch.zeros(2, 2, dtype=torch.int32)
    seq = torch.zeros(2, dtype=torch.int32)
    ql = torch.ones(2, dtype=torch.int32)
    q = torch.zeros(2, 3, 4, 16)
    f = cuda_ragged.ragged_paged_attention
    with pytest.raises(ValueError, match="B, T, H, Dh"):
        f(q3, kp, kp, tbl, seq, ql)
    with pytest.raises(ValueError, match="divide"):
        f(q, torch.zeros(8, 8, 3, 16), torch.zeros(8, 8, 3, 16), tbl, seq, ql)
    with pytest.raises(ValueError, match="batch"):
        f(q, kp, kp, torch.zeros(3, 2, dtype=torch.int32), torch.zeros(3, dtype=torch.int32), ql)
    with pytest.raises(ValueError, match="q_lens"):
        f(q, kp, kp, tbl, seq, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="mismatch"):
        f(q, kp, torch.zeros(8, 8, 2, 8), tbl, seq, ql)
    with pytest.raises(ValueError, match="both"):
        f(q, kp, kp, tbl, seq, ql, k_scale=torch.ones(8, 8, 2, 1))
    with pytest.raises(ValueError, match="scale pools"):
        f(q, kp, kp, tbl, seq, ql, k_scale=torch.ones(8, 8, 2), v_scale=torch.ones(8, 8, 2))
    with pytest.raises(ValueError, match="kv_splits"):
        f(q, kp, kp, tbl, seq, ql, kv_splits=0)
    assert f(q, kp, kp, tbl, seq, ql, kv_splits=64).shape == q.shape  # clamped to nb


def test_kernel_source_and_wrapper_agree_on_shared_memory():
    """The wrapper's shared-memory formula is the source's, and the main
    path's chunk (256 queries) fits for GQA n_rep 4 at Dh 128."""
    from pathlib import Path

    src = (Path(cuda_ragged.__file__).parent.parent / "csrc" / "ragged_paged.cu").read_text()
    assert "rows * D + bs * (D + 1) + bs * D + rows * bs +\n" in src
    assert "rows * D + 3 * rows + 2 * bs" in src
    for n_rep in (1, 3, 4, 8):
        tq = cuda_ragged.queries_per_tile(n_rep, 256)
        assert cuda_ragged.smem_bytes(tq * n_rep, 128, 64) <= cuda_ragged.MAX_SMEM_BYTES


_TINY = dict(
    vocab_size=64, context_length=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=1,
    activation="gelu", norm="layernorm", pos_embed="learned", tie_embeddings=True,
    compute_dtype="float32", attention_impl="flash", paged_attention_impl="kernel",
)


@pytest.mark.parametrize("kv_dtype,t,with_q_lens,want", [
    ("compute", 1, False, "paged"),
    ("compute", 3, False, "paged"),
    ("compute", 3, True, "ragged"),
    ("int8", 1, False, "ragged"),
    ("int8", 3, False, "ragged"),
    ("int8", 3, True, "ragged"),
])
def test_model_routes_paged_attention_as_jax(monkeypatch, kv_dtype, t, with_q_lens, want):
    """The kernel lane: int8 pools take the ragged kernel for every query
    shape (q_lens = T unless given), exact pools only for ragged calls."""
    cfg = ModelConfig(**dict(_TINY, kv_cache_dtype=kv_dtype, ragged_kv_splits=2, ragged_amla=True))
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, args[5] if name == "ragged" else None, kw))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(transformer, "ragged_paged_attention",
                        spy("ragged", transformer.ragged_paged_attention))
    monkeypatch.setattr(transformer, "paged_decode_attention",
                        spy("paged", transformer.paged_decode_attention))
    params = transformer.init_params(cfg, 0, device="cpu")
    pools = transformer.make_paged_kv_pool(cfg, 8, 8, device="cpu")
    q_lens = torch.tensor([t, 1], dtype=torch.int32) if with_q_lens else None
    info = transformer.PagedInfo(torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
                                 torch.tensor([2, 5], dtype=torch.int32), q_lens=q_lens)
    logits, _ = transformer.forward(params, torch.ones(2, t, dtype=torch.long), cfg,
                                    kv_cache=pools, paged=info)
    assert logits.shape == (2, t, 64) and torch.isfinite(logits).all()
    assert [c[0] for c in calls] == [want]
    if want == "ragged":
        name, lens, kw = calls[0]
        assert lens.tolist() == ([t, 1] if with_q_lens and t > 1 else [t, t])
        assert kw["kv_splits"] == 2 and kw["amla"] is True
        assert ("k_scale" in kw) == (kv_dtype == "int8")


# ---------------------------------------------------------------------------
# The tensor-core route (csrc/ragged_paged_tc.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_dtype,kv_dtype,d,bs,n_rep,want", [
    (torch.bfloat16, torch.bfloat16, 64, 64, 1, "wgmma"),    # paths 2 and 3: gpt2, exact pools
    (torch.bfloat16, torch.int8, 64, 64, 1, "wgmma"),        # int8 pools (fp32 or bf16 scales)
    (torch.bfloat16, torch.bfloat16, 128, 64, 4, "wgmma"),   # GQA n_rep 4 at Dh 128
    (torch.bfloat16, torch.int8, 128, 16, 8, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 64, 128, 1, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 64, 96, 64, "wgmma"),
    (torch.float32, torch.float32, 64, 64, 1, "fp32"),       # TF32 would miss the fp32 bar
    (torch.float32, torch.int8, 128, 64, 4, "fp32"),
    (torch.bfloat16, torch.bfloat16, 32, 64, 1, "fp32"),     # other bf16 shapes: the CUDA-core kernel
    (torch.bfloat16, torch.bfloat16, 16, 8, 1, "fp32"),
    (torch.bfloat16, torch.bfloat16, 64, 8, 1, "fp32"),
    (torch.bfloat16, torch.bfloat16, 64, 40, 1, "fp32"),
    (torch.bfloat16, torch.int8, 64, 256, 1, "fp32"),
    (torch.bfloat16, torch.bfloat16, 64, 64, 128, "fp32"),
])
def test_ragged_route(q_dtype, kv_dtype, d, bs, n_rep, want):
    assert cuda_ragged.ragged_route(q_dtype, kv_dtype, d, bs, n_rep) == want


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float16, torch.float16), (torch.bfloat16, torch.float32), (torch.bfloat16, torch.float16),
    (torch.int8, torch.int8),
])
def test_ragged_route_raises_on_other_dtypes(q_dtype, kv_dtype):
    with pytest.raises(TypeError):
        cuda_ragged.ragged_route(q_dtype, kv_dtype, 64, 64)


def _source_smem(d, bs, quantized):
    """Evaluates the ``Smem`` struct of ``csrc/ragged_paged_tc.cu`` for one
    shape: each ``static constexpr int NAME = expr;`` line, C's ternaries
    read as Python's."""
    import re
    from pathlib import Path

    src = (Path(cuda_ragged.__file__).parent.parent / "csrc" / "ragged_paged_tc.cu").read_text()
    body = src[src.index("struct Smem {"):]
    body = body[:body.index("};")]
    env = {"D": d, "BSM": 64 if bs <= 64 else 128, "QUANT": quantized, "ROWS": cuda_ragged.TILE_ROWS,
           "round1k": lambda x: (x + 1023) // 1024 * 1024}
    env["RING_BUDGET"] = eval(re.search(r"RING_BUDGET = ([^;]+);", src).group(1))
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body):
        m = re.fullmatch(r"(.+?)\s*\?\s*(.+?)\s*:\s*(.+)", expr)
        if m:
            expr = f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))"
        env[name] = eval(expr, {}, env)
    return env["ALLOC"]


@pytest.mark.parametrize("d", (64, 128))
@pytest.mark.parametrize("bs", (16, 32, 64, 96, 128))
@pytest.mark.parametrize("quantized", (False, True))
def test_tc_kernel_source_and_wrapper_agree_on_shared_memory(d, bs, quantized):
    """The wrapper's formula is the source's, every shape the route takes
    fits a block, and the main path's (gpt2: Dh 64, bs 64, n_rep 1; GQA
    n_rep 4 at Dh 128, bs 64) fit several blocks to an SM."""
    need = cuda_ragged.tc_smem_bytes(d, bs, quantized)
    assert need == _source_smem(d, bs, quantized)
    assert need <= cuda_ragged.MAX_SMEM_BYTES
    assert cuda_ragged.ragged_route(torch.bfloat16, torch.int8 if quantized else torch.bfloat16, d, bs,
                                    4 if d == 128 else 1) == "wgmma"
    if bs == 64:
        per_sm = 233472 // (need + 1024)  # the SM's shared memory, 1 KB reserved per block
        assert per_sm >= (3 if d == 64 else 1)


def _exp2_mul_add(x, k):
    """``x * 2^k`` as the kernels compute it: an add to the fp32 exponent
    field, zeros, subnormals and underflows to zero."""
    bits = x.view(torch.int32)
    field = (bits >> 23) & 0xFF
    ok = (field > 0) & (field + k > 0)
    return torch.where(ok, (bits + k * (1 << 23)).view(torch.float32), torch.zeros_like(x))


def _tc_int8_model(q, kp, vp, ks, vs, tables, seq, q_lens, *, splits, amla):
    """The tensor-core route's arithmetic over int8 pools, page by page:
    bf16 codes against bf16 q in fp32, K's scale (f32(scale) * (1/127)) on
    the score columns after the dot, the classic or AMLA online softmax,
    P * vs / 127 rounded to bf16 against the bf16 codes, fp32 partials
    merged by the wrapper's combine, bf16 out."""
    b, t, h, d = q.shape
    g, bs, nb = kp.shape[2], kp.shape[1], tables.shape[1]
    n_rep = h // g
    scale = d ** -0.5 * (cuda_ragged.LOG2E if amla else 1.0)
    nb_split = -(-nb // splits)
    qf = q.float()
    out = torch.zeros(b, t, h, d)
    for row in range(b):
        qlen, s0 = int(q_lens[row]), int(seq[row])
        pos = s0 + torch.arange(t)
        real = (torch.arange(t) < qlen)[:, None, None]  # (T, 1, 1)
        parts = []
        for part in range(splits):
            acc = torch.zeros(t, h, d)
            m = torch.full((t, h, 1), cuda_ragged.NEG_INF)
            l = torch.zeros(t, h, 1)
            last = (s0 + qlen - 1) // bs if qlen > 0 else -1
            for j in range(part * nb_split, min(nb, (part + 1) * nb_split, last + 1)):
                blk = int(tables[row, j])
                codes_k = kp[blk].float().repeat_interleave(n_rep, dim=1)  # (bs, H, D), exact
                codes_v = vp[blk].float().repeat_interleave(n_rep, dim=1)
                sk = (ks[blk].float() * (1.0 / 127.0)).repeat_interleave(n_rep, dim=1)[..., 0]  # (bs, H)
                sv = (vs[blk].float() * (1.0 / 127.0)).repeat_interleave(n_rep, dim=1)[..., 0]
                s = torch.einsum("thd,shd->ths", qf[row], codes_k) * scale * sk.T[None]
                lin = j * bs + torch.arange(bs)
                ok = (lin[None, :] <= pos[:, None])[:, None, :] & real
                s = torch.where(ok, s, torch.full_like(s, cuda_ragged.NEG_INF))
                mx = s.amax(-1, keepdim=True)
                if amla:
                    mn = torch.maximum(m, torch.ceil(mx))
                    delta = torch.clamp(m - mn, -126.0, 0.0).to(torch.int32)
                    p = torch.where(ok, torch.exp2(s - mn), torch.zeros_like(s))
                    l = _exp2_mul_add(l, delta) + p.sum(-1, keepdim=True)
                    acc = _exp2_mul_add(acc, delta)
                else:
                    mn = torch.maximum(m, mx)
                    alpha = torch.exp(m - mn)
                    p = torch.where(ok, torch.exp(s - mn), torch.zeros_like(s))
                    l = l * alpha + p.sum(-1, keepdim=True)
                    acc = acc * alpha
                m = mn
                pv = (p * sv.T[None]).bfloat16().float()
                acc = acc + torch.einsum("ths,shd->thd", pv, codes_v)
            parts.append((acc, m, l))
        acc = torch.stack([x[0] for x in parts])
        m = torch.stack([x[1] for x in parts])
        l = torch.stack([x[2] for x in parts])
        w = torch.exp2(m - m.amax(0)) if amla else torch.exp(m - m.amax(0))
        l_tot = (l * w).sum(0)
        acc_tot = (acc * w).sum(0)
        out[row] = acc_tot / torch.where(l_tot == 0.0, torch.ones_like(l_tot), l_tot)
    return out.bfloat16()


@pytest.mark.parametrize("splits,amla,scale_pool", [
    (1, False, "int8-f32"), (1, True, "int8-bf16"), (2, False, "int8-bf16"), (2, True, "int8-f32"),
])
def test_tc_int8_rounding_points_within_the_card_bar(splits, amla, scale_pool, capsys):
    """The tensor-core route's int8 rounding points (bf16 codes, K's scale
    after the dot, P * vs / 127 in bf16) against the Pallas kernel in
    interpret mode (fp32 P against the dequantized fp32 V), bf16 q, at the
    bf16 bar ``chip_smoke.py`` holds the card to: per output row, 2^-6 of
    the row's largest |value|. The worst use of the bar is printed."""
    rng = np.random.default_rng(100 + splits + 2 * amla)
    q, kp, vp, tables, seq, q_lens, (ks, vs) = _state(rng, 2, scale_pool)
    q = torch.from_numpy(q).bfloat16()
    bf16_scales = scale_pool == "int8-bf16"
    want = pallas_ragged.ragged_paged_attention(
        _jax(q.float().numpy(), True), *map(_jax, (kp, vp, tables, seq, q_lens)), interpret=True,
        kv_splits=splits, amla=amla, k_scale=_jax(ks, bf16_scales), v_scale=_jax(vs, bf16_scales))
    want = torch.from_numpy(np.asarray(want, np.float32))
    tks, tvs = _torch(ks, bf16_scales), _torch(vs, bf16_scales)
    got = _tc_int8_model(q, torch.from_numpy(kp), torch.from_numpy(vp), tks, tvs, tables, seq, q_lens,
                         splits=splits, amla=amla).float()
    limit = 2.0**-6 * want.abs().amax(-1, keepdim=True)
    use = ((got - want).abs() / limit.clamp_min(1e-30)).max().item()
    with capsys.disabled():
        print(f"\n[tc int8 model] splits={splits} amla={amla} {scale_pool}: worst use of the bf16 bar {use:.4f}")
    assert use <= 1.0
    # Pad queries come back as zeros in both.
    for row, n in enumerate(q_lens):
        assert not got[row, n:].any() and not want[row, n:].any()
