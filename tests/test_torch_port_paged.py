"""The paged decode kernel's split route (K2) against the JAX package's.

``csrc/paged_decode.cu``'s split page stream cuts each row's block table
into partitions, one block each, walks each partition's live pages with an
online softmax, and merges the partitions' fp32 partials in partition order
inside the same launch. ``_split_model`` repeats that arithmetic in torch
(fp32 scores and stats, P rounded to V's dtype before P.V, empty
partitions as (m = NEG_INF, l = 0), partials with l = 0 skipped in the
merge) and is held against ``pallas_paged.paged_decode_attention`` in
interpret mode on numpy-seeded inputs. Tolerances: fp32 1e-4 max-abs (the
card's bar; sums in another order), bf16 2^-6 of each output row's largest
|value| (the card's bar; a rounding flip of P or of the output). Then the
host side the CPU can reach: the partition plan, the route rule, the
shared-memory arithmetic against the source and the arrival counters'
cache.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.ops.pallas_paged import paged_decode_attention as jax_paged
from pretraining_llm_tpu_torch.ops import cuda_paged

FP32_TOL = 1e-4
NEG_INF = -1e30  # the kernels' finite NEG_INF
BF16_ROW_RTOL = 2.0**-6
H, BS, NB, N_BLOCKS = 12, 64, 4, 24  # the split route's page size; 256-slot tables


def _state(rng, seqs, t):
    """Fragmented tables holding each row's pages up to seq + t - 1, with
    dead (zero) tails."""
    perm = rng.permutation(np.arange(1, N_BLOCKS)).tolist()
    tables = np.zeros((len(seqs), NB), np.int32)
    for i, s in enumerate(seqs):
        n_pages = (s + t - 1) // BS + 1
        tables[i, :n_pages] = [perm.pop() for _ in range(n_pages)]
    return tables, np.asarray(seqs, np.int32)


def _partition_pages(seq, t, window, bs, nb, part, per):
    """The table entries partition ``part`` of a row reads, as the split
    kernel computes them: its ``per`` entries, cut to the live pages j with
    j * bs <= seq + t - 1 and, with a window, j * bs + bs - 1 > seq -
    window."""
    lo, hi = part * per, min(nb - 1, (seq + t - 1) // bs, part * per + per - 1)
    if window > 0 and seq - window - bs + 1 >= 0:
        lo = max(lo, (seq - window - bs + 1) // bs + 1)
    return range(lo, hi + 1)


def _split_model(q, kp, vp, tables, seqs, window, parts, per):
    """The split kernel's arithmetic: q (B, T, H, D), pools (n_blocks, bs,
    G, D) of one dtype; per (row, KV head, partition) an online softmax
    over the partition's live pages, then the partials merged in order."""
    b, t, h, d = q.shape
    g = kp.shape[2]
    n_rep = h // g
    out = torch.zeros(b, t, h, d)
    for row in range(b):
        seq = int(seqs[row])
        front = seq + torch.arange(t)  # query t's own slot, inclusive
        for grp in range(g):
            heads = slice(grp * n_rep, (grp + 1) * n_rep)
            qg = q[row, :, heads].float()  # (T, n_rep, D)
            partials = []
            for part in range(parts):
                acc = torch.zeros(t, n_rep, d)
                m = torch.full((t, n_rep, 1), NEG_INF)
                l = torch.zeros(t, n_rep, 1)
                for j in _partition_pages(seq, t, window, BS, NB, part, per):
                    blk = int(tables[row, j])
                    k = kp[blk, :, grp].float()  # (bs, D)
                    v = vp[blk, :, grp]
                    s = torch.einsum("trd,sd->trs", qg, k) * d**-0.5
                    lin = j * BS + torch.arange(BS)
                    ok = lin[None, :] <= front[:, None]
                    if window:
                        ok = ok & (lin[None, :] > front[:, None] - window)
                    ok = ok[:, None, :]
                    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    p = torch.where(ok, torch.exp(s - m_new), torch.zeros_like(s))
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    acc = acc * alpha + torch.einsum("trs,sd->trd", p.to(v.dtype).float(), v.float())
                    m = m_new
                partials.append((acc, m, l))
            m_tot = torch.stack([m for _, m, _ in partials]).amax(0)
            l_tot = torch.zeros_like(m_tot)
            acc_tot = torch.zeros(t, n_rep, d)
            for acc, m, l in partials:
                w = torch.where(l != 0.0, torch.exp(m - m_tot), torch.zeros_like(m))
                l_tot = l_tot + l * w
                acc_tot = acc_tot + torch.where(l != 0.0, acc * w, torch.zeros_like(acc))
            out[row, :, heads] = acc_tot / torch.where(l_tot == 0.0, torch.ones_like(l_tot), l_tot)
    return out.to(q.dtype)


_CASES = [  # (dtype, T, G, Dh, window, seq_lens, partitions): per = ceil(NB / partitions)
    ("float32", 1, 12, 64, 0, [0, 63, 200], 2),
    ("bfloat16", 1, 12, 64, 0, [0, 63, 200], 2),
    ("float32", 4, 4, 128, 0, [60, 64, 121], 2),
    ("bfloat16", 4, 4, 128, 64, [124, 188, 252], 4),  # windows ending on page edges
    ("bfloat16", 1, 4, 64, 0, [0, 5, 70], 4),  # more partitions than live pages
    ("float32", 1, 12, 128, 100, [255, 150, 64], 4),
    ("bfloat16", 4, 12, 64, 0, [252, 63, 64], 1),  # a full table, one partition
]


@pytest.mark.parametrize("dtype,t,g,d,window,seqs,parts", _CASES)
def test_split_model_matches_pallas(dtype, t, g, d, window, seqs, parts):
    rng = np.random.default_rng(7 * t + g + d + window + parts)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q = torch.from_numpy(rng.normal(size=(len(seqs), t, H, d)).astype(np.float32)).to(tdt)
    kp = torch.from_numpy(rng.normal(size=(N_BLOCKS, BS, g, d)).astype(np.float32)).to(tdt)
    vp = torch.from_numpy(rng.normal(size=(N_BLOCKS, BS, g, d)).astype(np.float32)).to(tdt)
    tables, seq = _state(rng, seqs, t)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax_paged(*(jnp.asarray(x.float().numpy(), jdt) for x in (q, kp, vp)), jnp.asarray(tables),
                     jnp.asarray(seq), window=window, interpret=True)
    want = torch.from_numpy(np.array(want, np.float32))
    per = -(-NB // parts)
    got = _split_model(q, kp, vp, tables, seq, window, -(-NB // per), per).float()
    if dtype == "float32":
        assert (got - want).abs().max().item() <= FP32_TOL
    else:
        limit = BF16_ROW_RTOL * want.abs().amax(-1, keepdim=True)
        assert ((got - want).abs() <= limit).all()


def _live(seq, t, window, bs, nb):
    last = min(nb - 1, (seq + t - 1) // bs)
    return [j for j in range(last + 1) if not (window > 0 and j * bs + bs - 1 <= seq - window)]


@pytest.mark.parametrize("b,g,nb", [(8, 12, 16), (1, 12, 16), (3, 4, 16), (8, 4, 32), (2, 12, 10), (8, 12, 1)])
def test_kv_partitions_cover_every_live_page_once(b, g, nb):
    """Every live page of a row lies in exactly one partition, partitions in
    page order, no partition without a table entry; the main path's decode
    step (8 rows x 12 heads, 16-entry tables) fills two blocks per SM."""
    parts, per = cuda_paged._kv_partitions(b, g, nb, 132)
    assert 1 <= parts <= nb and (parts - 1) * per < nb <= parts * per
    for seq, t, window in [(0, 1, 0), (63, 1, 0), (64, 1, 0), (nb * 64 - 1, 1, 0), (nb * 64 - 4, 4, 0),
                           (500, 1, 128), (300, 4, 64), (191, 1, 128)]:
        if seq + t > nb * 64:
            continue
        pages = [j for p in range(parts) for j in _partition_pages(seq, t, window, 64, nb, p, per)]
        assert pages == _live(seq, t, window, 64, nb)
    if (b, g, nb) == (8, 12, 16):
        assert b * g * parts >= 2 * 132


@pytest.mark.parametrize("dtype,d,bs,rows,want", [
    (torch.bfloat16, 64, 64, 1, "split"), (torch.float32, 64, 64, 1, "split"),
    (torch.bfloat16, 128, 64, 3, "split"), (torch.bfloat16, 128, 64, 16, "split"),
    (torch.float32, 128, 64, 12, "split"), (torch.bfloat16, 64, 64, 24, "loop"),
    (torch.bfloat16, 32, 64, 1, "loop"), (torch.bfloat16, 64, 32, 1, "loop"),
    (torch.float32, 64, 128, 1, "loop"), (torch.bfloat16, 96, 64, 1, "loop"),
])
def test_paged_route(dtype, d, bs, rows, want):
    assert cuda_paged.paged_route(dtype, d, bs, rows) == want


def test_paged_route_raises_on_other_dtypes():
    with pytest.raises(TypeError):
        cuda_paged.paged_route(torch.float16, 64, 64, 1)


def _c_expr(expr):
    """A C integer expression as Python: ``/`` as ``//`` and a chain of
    ternaries ``a ? b : c ? d : e`` (right-associative) as Python's."""
    parts = re.split(r"[?:]", expr.replace("/", "//"))
    out = parts[-1]
    for cond, val in reversed(list(zip(parts[:-1:2], parts[1:-1:2]))):
        out = f"({val}) if ({cond}) else ({out})"
    return out


def _source_split_smem(esz, d, rt):
    """Evaluates ``SplitSmem`` of ``csrc/paged_decode.cu`` for one shape:
    each ``static constexpr int NAME = expr;`` line."""
    src = (Path(cuda_paged.__file__).parent.parent / "csrc" / "paged_decode.cu").read_text()
    body = src[src.index("struct SplitSmem {"):]
    body = body[:body.index("};")]
    env = {"ESZ": esz, "D": d, "RT": rt}
    for name in ("SPLIT_THREADS", "SPLIT_BS", "RING_BUDGET"):
        env[name] = eval(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1))
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body):
        env[name] = eval(_c_expr(expr), {}, env)
    return env["ALLOC"]


@pytest.mark.parametrize("esz", (2, 4))
@pytest.mark.parametrize("d", (64, 128))
@pytest.mark.parametrize("rt", (1, 4, 16))
def test_split_kernel_source_and_wrapper_agree_on_shared_memory(esz, d, rt):
    """The wrapper's formula is the source's, every shape of the route fits
    a block, and the main path's (bf16, Dh 64, one row) fits three blocks
    to an SM."""
    need = cuda_paged.split_smem_bytes(esz, d, rt)
    assert need == _source_split_smem(esz, d, rt)
    assert need <= cuda_paged.MAX_SMEM_BYTES
    if (esz, d, rt) == (2, 64, 1):
        assert 233472 // (need + 1024) >= 3  # the SM's shared memory, 1 KB reserved per block


def test_arrival_counters_are_kept_per_stream_and_grow(monkeypatch):
    """The split kernels' arrival counters: zeros, one buffer per (device,
    stream) handed out again while it is large enough, a new zeroed one
    when a launch needs more."""
    from pretraining_llm_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_COUNTERS", {})
    cpu = torch.device("cpu")
    a = _build.counters(cpu, 1, 96)
    assert a.dtype == torch.int32 and a.numel() >= 96 and not a.any()
    assert _build.counters(cpu, 1, 50) is a
    assert _build.counters(cpu, 2, 50) is not a
    big = _build.counters(cpu, 1, a.numel() + 1)
    assert big.numel() > a.numel() and not big.any() and _build.counters(cpu, 1, 8) is big
