"""Ring attention: context parallelism over the 'seq' mesh axis.

Counterpart of ``pretraining_llm_tpu/parallel/ring_attention.py``. Each seq
rank holds its shard of the sequence, (B, T/n, H, Dh) of q and
(B, T/n, G, Dh) of k and v; its q stays put while the K/V shards rotate
around the seq ranks (``dist.batch_isend_irecv`` to the next rank, from
the previous), one hop per step, n hops:

  - each hop is a blockwise online-softmax pass over ``block_kv`` tiles of
    the visiting shard (``_partial_flash``), giving unnormalized (o, m, l)
    partials that ``_merge_stats`` folds into the running ones: no dense
    (T/n, T/n) score tensor is ever built;
  - a causal hop that contributes nothing is skipped, not computed and
    masked; the diagonal hop is masked within the chunk;
  - ``layout="zigzag"``: the global sequence was split into 2n chunks and
    rank i holds chunks (i, 2n-1-i) (``parallel.zigzag``, applied by
    ``models.transformer.loss_fn``), so every causal hop costs every rank
    two half-chunk partials.

The JAX package computes the hops with einsums (no Pallas kernel) and
gets the backward from autodiff through ``ppermute`` over checkpointed
hops. Here the hops are torch einsums with fp32 products (bf16 operands are
widened exactly; P is rounded to V's dtype before P.V, as in JAX), and the
backward is ``_RingAttention``'s own: it keeps q, k, v, the output and the
global log-sum-exp, and rotates the K/V shards again; each hop recomputes
its probabilities against the global statistics, adds its dQ locally, and
adds the visiting shard's dK/dV into buffers that travel with it, so after
n rotations every shard's dK/dV is back at its owner. Skipped hops are
skipped in the backward too.

``ring_attention`` takes the rank's local shards (the JAX function takes the
global view inside ``shard_map``) and returns the rank's output shard.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pretraining_llm_tpu_torch.ops import remat
from pretraining_llm_tpu_torch.parallel.mesh import AxisGroup, axis_group, mesh_shape

NEG_INF = -1e30

# Modes for one (q-chunk, kv-chunk) partial-attention call.
_SKIP, _CAUSAL, _FULL = 0, 1, 2

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _empty_stats(b: int, t: int, h: int, d: int, device: torch.device) -> Stats:
    """Identity element of the online-softmax merge: (o=0, m=NEG_INF, l=0)."""
    return (
        torch.zeros((b, t, h, d), dtype=torch.float32, device=device),
        torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=device),
        torch.zeros((b, h, t), dtype=torch.float32, device=device),
    )


def _merge_stats(o, m, l, o2, m2, l2) -> Stats:
    """Online-softmax merge of two unnormalized partials. o: (B, t, H, D)
    fp32; m, l: (B, H, t) fp32. exp(NEG_INF - x) underflows to exactly 0
    for any finite x, and is 1 when both sides are still empty."""
    m_new = torch.maximum(m, m2)
    a1 = torch.exp(m - m_new)
    a2 = torch.exp(m2 - m_new)
    l_new = l * a1 + l2 * a2
    o_new = o * a1.transpose(1, 2)[..., None] + o2 * a2.transpose(1, 2)[..., None]
    return o_new, m_new, l_new


def _kv_block(tk: int, block_kv: int) -> int:
    bk = min(block_kv, tk)
    while tk % bk != 0:
        bk //= 2
    return bk


def _scores(qg: torch.Tensor, kb: torch.Tensor, scale: float, causal: bool, k0: int) -> torch.Tensor:
    """(B, G, rep, tq, bk) fp32 scores of grouped queries (B, tq, G, rep, D)
    against keys (B, bk, G, D) at chunk offset k0; causal masks a key past
    its query (q and k are the same aligned chunk)."""
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb.float()) * scale
    if causal:
        tq, bk = qg.shape[1], kb.shape[1]
        q_ids = torch.arange(tq, device=s.device)
        k_pos = k0 + torch.arange(bk, device=s.device)
        s = s.masked_fill(~(q_ids[:, None] >= k_pos[None, :]), NEG_INF)
    return s


def _partial_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mode: int, *,
                   block_kv: int = 512) -> Stats:
    """Blockwise partial attention returning unnormalized online-softmax
    stats. q: (B, tq, H, D); k, v: (B, tk, G, D) with G | H (each group's
    H/G query heads attend its shared KV head; K/V are never expanded).
    ``_SKIP`` returns empty stats without a product, ``_CAUSAL`` masks
    assuming q and k cover the same aligned chunk, ``_FULL`` attends
    unmasked. Returns (o (B, tq, H, D), m (B, H, tq), l (B, H, tq)), fp32."""
    b, tq, h, d = q.shape
    tk, g = k.shape[1], k.shape[2]
    if mode == _SKIP:
        return _empty_stats(b, tq, h, d, q.device)
    rep = h // g
    scale = 1.0 / (d**0.5)
    bk = _kv_block(tk, block_kv)
    qg = q.float().reshape(b, tq, g, rep, d)
    o, m, l = _empty_stats(b, tq, h, d, q.device)
    for j in range(tk // bk):
        kb, vb = k[:, j * bk:(j + 1) * bk], v[:, j * bk:(j + 1) * bk]
        s = _scores(qg, kb, scale, mode == _CAUSAL, j * bk).reshape(b, h, tq, bk)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum(
            "bgrqk,bkgd->bqgrd", p.reshape(b, g, rep, tq, bk).to(v.dtype).float(), vb.float()
        ).reshape(b, tq, h, d)
        o = o * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    return o, m, l


def _partial_grads(q, k, v, do, lse, delta, mode: int, block_kv: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of one (q-chunk, kv-chunk) partial against the global
    statistics: probabilities P = exp(S - lse), dV = P^T dO, dS = P (dO V^T
    - delta), dQ = dS K scale, dK = dS^T Q scale. Returns fp32 (dq (B, tq,
    H, D), dk (B, tk, G, D), dv (B, tk, G, D)); None for a skipped pair."""
    b, tq, h, d = q.shape
    tk, g = k.shape[1], k.shape[2]
    rep = h // g
    scale = 1.0 / (d**0.5)
    bk = _kv_block(tk, block_kv)
    qg = q.float().reshape(b, tq, g, rep, d)
    dog = do.float().reshape(b, tq, g, rep, d)
    lse_g = lse.reshape(b, g, rep, tq)[..., None]
    delta_g = delta.reshape(b, g, rep, tq)[..., None]
    dq = torch.zeros((b, tq, g, rep, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, tk, g, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, tk, g, d), dtype=torch.float32, device=q.device)
    for j in range(tk // bk):
        kb, vb = k[:, j * bk:(j + 1) * bk], v[:, j * bk:(j + 1) * bk]
        s = _scores(qg, kb, scale, mode == _CAUSAL, j * bk)
        p = torch.exp(s - lse_g)
        dv[:, j * bk:(j + 1) * bk] = torch.einsum("bgrqk,bqgrd->bkgd", p.to(v.dtype).float(), dog)
        dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vb.float())
        ds = p * (dp - delta_g)
        dq += torch.einsum("bgrqk,bkgd->bqgrd", ds, kb.float()) * scale
        dk[:, j * bk:(j + 1) * bk] = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg) * scale
    return dq.reshape(b, tq, h, d), dk, dv


def _chunk_mode(q_chunk: int, k_chunk: int) -> int:
    """Causal relation of two equal-size chunks by global chunk index."""
    if q_chunk == k_chunk:
        return _CAUSAL
    return _FULL if q_chunk > k_chunk else _SKIP


def _parts(tl: int, my: int, src: int, n: int, causal: bool, zigzag: bool
           ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]], List[List[int]]]:
    """(q parts, k parts, modes[qi][ki]) of one hop: each part a (start,
    stop) of the local shard. Zigzag: the halves hold chunks (i, 2n-1-i)."""
    if zigzag:
        c = tl // 2
        halves = [(0, c), (c, tl)]
        q_chunks = (my, 2 * n - 1 - my)
        k_chunks = (src, 2 * n - 1 - src)
        return halves, halves, [[_chunk_mode(qc, kc) for kc in k_chunks] for qc in q_chunks]
    mode = _chunk_mode(my, src) if causal else _FULL
    return [(0, tl)], [(0, tl)], [[mode]]


def _rotate(tensors: Sequence[torch.Tensor], grp: AxisGroup) -> List[torch.Tensor]:
    """Send each tensor to the next seq rank and receive the previous
    rank's: one ``batch_isend_irecv`` for all of them."""
    nxt = grp.ranks[(grp.index + 1) % grp.size]
    prv = grp.ranks[(grp.index - 1) % grp.size]
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, grp.group))
        ops.append(dist.P2POp(dist.irecv, r, prv, grp.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _ring_forward(q, k, v, grp: Optional[AxisGroup], causal: bool, zigzag: bool, block_kv: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B, tl, H, D) fp32 normalized, lse (B, H, tl) fp32) of the rank's
    queries over every rank's keys."""
    b, tl, h, d = q.shape
    n = 1 if grp is None else grp.size
    my = 0 if grp is None else grp.index
    qparts = _parts(tl, my, my, n, causal, zigzag)[0]
    stats = [_empty_stats(b, hi - lo, h, d, q.device) for lo, hi in qparts]
    kc, vc = k, v
    for r in range(n):
        src = (my - r) % n
        qp, kp, modes = _parts(tl, my, src, n, causal, zigzag)
        for qi, (qlo, qhi) in enumerate(qp):
            for ki, (klo, khi) in enumerate(kp):
                part = _partial_flash(q[:, qlo:qhi], kc[:, klo:khi], vc[:, klo:khi], modes[qi][ki],
                                      block_kv=block_kv)
                stats[qi] = _merge_stats(*stats[qi], *part)
        if r < n - 1:
            kc, vc = _rotate((kc, vc), grp)
    o = torch.cat([s[0] for s in stats], dim=1)
    m = torch.cat([s[1] for s in stats], dim=2)
    l = torch.cat([s[2] for s in stats], dim=2)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = o / safe_l.transpose(1, 2)[..., None]
    lse = m + torch.log(safe_l)
    return o, lse


def _ring_backward(q, k, v, o, lse, do, grp: Optional[AxisGroup], causal: bool, zigzag: bool,
                   block_kv: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, tl, h, d = q.shape
    n = 1 if grp is None else grp.size
    my = 0 if grp is None else grp.index
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)  # (B, H, tl)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kc, vc = k, v
    dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for r in range(n):
        src = (my - r) % n
        qp, kp, modes = _parts(tl, my, src, n, causal, zigzag)
        for qi, (qlo, qhi) in enumerate(qp):
            for ki, (klo, khi) in enumerate(kp):
                if modes[qi][ki] == _SKIP:
                    continue
                gq, gk, gv = _partial_grads(
                    q[:, qlo:qhi], kc[:, klo:khi], vc[:, klo:khi], do[:, qlo:qhi],
                    lse[:, :, qlo:qhi], delta[:, :, qlo:qhi], modes[qi][ki], block_kv)
                dq[:, qlo:qhi] += gq
                dkc[:, klo:khi] += gk
                dvc[:, klo:khi] += gv
        if n > 1:
            if r < n - 1:
                kc, vc, dkc, dvc = _rotate((kc, vc, dkc, dvc), grp)
            else:  # the last rotation brings every shard's dK/dV home
                dkc, dvc = _rotate((dkc, dvc), grp)
    return dq, dkc, dvc


class _RingAttention(torch.autograd.Function):
    """Differentiable ring attention over the seq group. ``apply(q, k, v,
    grp, causal, zigzag, block_kv)``; only q, k and v get gradients. Inside
    a checkpointed layer a named remat policy may hand back the first run's
    output (and statistics), as for the flash forward (``ops/remat.py``);
    the rotation and the products run unrecorded by the selective policy."""

    @staticmethod
    def forward(ctx, q, k, v, grp, causal, zigzag, block_kv):
        o, lse = remat.kept_attention()
        if lse is None:
            with remat.unrecorded():
                o_run, lse = _ring_forward(q, k, v, grp, causal, zigzag, block_kv)
            o = o_run.to(q.dtype) if o is None else o
        remat.keep_attention(o, lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = (grp, causal, zigzag, block_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grp, causal, zigzag, block_kv = ctx.meta
        with remat.unrecorded():
            dq, dk, dv = _ring_backward(q, k, v, o, lse, do, grp, causal, zigzag, block_kv)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_supports_grouped(
    mesh: Any,
    n_heads: int,
    n_kv_heads: int,
    *,
    seq_axis: str = "seq",
    head_axis: Optional[str] = "tensor",
) -> bool:
    """Whether grouped (un-expanded) KV can be fed to the ring dispatch:
    True when ring won't run (no seq axis: the naive fallback is grouped
    anyway) or when every head-axis shard holds whole KV groups. ``mesh``
    is a ``DeviceMesh`` or a mapping of axis sizes."""
    shape = mesh_shape(mesh)
    if mesh is None or shape.get(seq_axis, 1) <= 1:
        return True
    tp = shape.get(head_axis, 1) if head_axis else 1
    return n_kv_heads % tp == 0 or n_kv_heads == n_heads


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Any,
    *,
    causal: bool = True,
    seq_axis: str = "seq",
    batch_axes: Tuple[str, ...] = ("data", "fsdp"),
    head_axis: Optional[str] = "tensor",
    layout: str = "contiguous",
    block_kv: int = 512,
) -> torch.Tensor:
    """The rank's shards q (B, T/n, H/tp, Dh), k/v (B, T/n, G/tp, Dh) with
    G | H -> its output shard (B, T/n, H/tp, Dh), over the ``seq_axis``
    ranks of ``mesh`` (tp the ``head_axis`` size: the heads are split by
    tensor, and the head counts in JAX's checks are the global ones). With ``layout="zigzag"`` (causal only, as in JAX) the caller
    permuted the sequence with ``parallel.zigzag.zigzag_perm`` and fed the
    matching positions. ``batch_axes`` is JAX's argument and changes
    nothing here (each rank holds its rows already)."""
    del batch_axes
    n = mesh_shape(mesh)[seq_axis]
    if layout == "zigzag" and q.shape[1] % 2 != 0:
        raise ValueError("zigzag layout needs an even per-device sequence length")
    tp = mesh_shape(mesh).get(head_axis, 1) if head_axis else 1
    h, g = q.shape[2] * tp, k.shape[2] * tp
    if h % g != 0:
        raise ValueError(f"kv heads ({g}) must divide query heads ({h})")
    if g < h and not ring_supports_grouped(mesh, h, g, seq_axis=seq_axis, head_axis=head_axis):
        raise ValueError(
            f"grouped ring attention needs kv heads ({g}) divisible by the "
            f"'{head_axis}' mesh axis; expand K/V to full heads instead"
        )
    grp = axis_group(mesh, (seq_axis,)) if n > 1 else None
    return _RingAttention.apply(q, k, v, grp, causal, layout == "zigzag" and causal, int(block_kv))
