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
