"""Ulysses-style sequence parallelism: all-to-all seq<->head exchange.

Counterpart of ``pretraining_llm_tpu/parallel/ulysses.py``. Instead of
rotating KV shards around the ring, one all-to-all over the seq ranks
re-shards activations from sequence-split to head-split, each rank runs
full-sequence attention for its share of the heads, and a second
all-to-all swaps back:

    (B, T/n, H,  D)  --all_to_all-->  (B, T, H/n, D)
          attention over the full sequence, H/n heads
    (B, T, H/n, D)  --all_to_all-->  (B, T/n, H,  D)

Both exchanges are ``dist.all_to_all_single`` inside autograd Functions
whose backward is the inverse exchange. The inner attention is the port's
flash route (``ops/flash_attention.py``: the CUDA forward kernel and the
backward kernels on the card, their plain versions on the CPU); that route
is causal, so a non-causal call (or ``use_flash=False``) runs
``naive_attention``. GQA: q and k/v exchange independently (H/n and G/n
heads per rank); the contiguous head split is group-aligned, so rank j's
query heads cover exactly its KV groups.

With a tensor axis (``head_axis``) the heads are split by tensor first,
then by seq: the rank's shards carry its H/tp query heads and G/tp KV
heads (the model expands K/V per query head where G does not split over
tensor x seq), and the head counts in JAX's checks and messages are the
global ones, H = tp x the shard's heads.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from pretraining_llm_tpu_torch.ops import remat
from pretraining_llm_tpu_torch.ops.attention import naive_attention
from pretraining_llm_tpu_torch.parallel.mesh import AxisGroup, axis_group, mesh_shape
from pretraining_llm_tpu_torch.parallel.tensor import all_to_all_single


def _exchange(x: torch.Tensor, grp: Optional[AxisGroup]) -> torch.Tensor:
    """all_to_all_single over the seq group: block j of dim 0 goes to the
    group's rank j; the result's block j came from rank j."""
    if grp is None:
        return x
    out = torch.empty_like(x)
    with remat.unrecorded():
        all_to_all_single(out, x, grp.group)
    return out


def _seq_to_heads(x: torch.Tensor, grp: Optional[AxisGroup]) -> torch.Tensor:
    """(B, T/n, H, D) -> (B, T, H/n, D): split heads, concat sequence."""
    n = 1 if grp is None else grp.size
    b, tl, h, d = x.shape
    blocks = x.reshape(b, tl, n, h // n, d).permute(2, 0, 1, 3, 4)  # (n, B, tl, H/n, D)
    got = _exchange(blocks.contiguous(), grp)  # got[j]: rank j's sequence chunk, my heads
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * tl, h // n, d)


def _heads_to_seq(x: torch.Tensor, grp: Optional[AxisGroup]) -> torch.Tensor:
    """(B, T, H/n, D) -> (B, T/n, H, D): the inverse of ``_seq_to_heads``."""
    n = 1 if grp is None else grp.size
    b, t, hn, d = x.shape
    blocks = x.reshape(b, n, t // n, hn, d).permute(1, 0, 2, 3, 4)  # (n, B, tl, H/n, D)
    got = _exchange(blocks.contiguous(), grp)  # got[j]: rank j's heads, my chunk
    return got.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * hn, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _seq_to_heads(x, grp)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.grp), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _heads_to_seq(x, grp)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.grp), None


def seq_to_heads(x: torch.Tensor, grp: Optional[AxisGroup]) -> torch.Tensor:
    return _SeqToHeads.apply(x, grp)


def heads_to_seq(x: torch.Tensor, grp: Optional[AxisGroup]) -> torch.Tensor:
    return _HeadsToSeq.apply(x, grp)


def ulysses_supports_grouped(
    mesh: Any,
    n_heads: int,
    n_kv_heads: int,
    *,
    seq_axis: str = "seq",
    head_axis: Optional[str] = "tensor",
) -> bool:
    """Whether grouped (un-expanded) KV can ride the all-to-all exchange:
    True when ulysses won't run (no seq axis) or when the KV heads split
    evenly over both the head (tensor) shards and the seq ranks. ``mesh``
    is a ``DeviceMesh`` or a mapping of axis sizes."""
    shape = mesh_shape(mesh)
    if mesh is None or shape.get(seq_axis, 1) <= 1:
        return True
    if n_kv_heads == n_heads:
        return True
    tp = shape.get(head_axis, 1) if head_axis else 1
    n = shape[seq_axis]
    return n_kv_heads % tp == 0 and (n_kv_heads // tp) % n == 0


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Any,
    *,
    causal: bool = True,
    seq_axis: str = "seq",
    batch_axes: Tuple[str, ...] = ("data", "fsdp"),
    head_axis: Optional[str] = "tensor",
    use_flash: bool = True,
    block_q: int = 0,
    block_kv: int = 0,
) -> torch.Tensor:
    """The rank's shards q (B, T/n, H/tp, Dh), k/v (B, T/n, G/tp, Dh) with
    G | H -> its output shard (B, T/n, H/tp, Dh), over the ``seq_axis``
    ranks of ``mesh`` (tp the ``head_axis`` size). ``batch_axes`` is JAX's
    argument and changes nothing here."""
    del batch_axes
    shape = mesh_shape(mesh)
    n = shape[seq_axis]
    tp = shape.get(head_axis, 1) if head_axis else 1
    h, g = q.shape[2] * tp, k.shape[2] * tp
    if h % g != 0:
        raise ValueError(f"kv heads ({g}) must divide query heads ({h})")
    h_local = h // tp
    if h_local % n != 0:
        raise ValueError(
            f"ulysses needs per-device heads ({h_local}) divisible by seq axis size ({n})"
        )
    if g < h and not ulysses_supports_grouped(mesh, h, g, seq_axis=seq_axis, head_axis=head_axis):
        raise ValueError(
            f"grouped ulysses needs kv heads ({g}) divisible by "
            f"{head_axis} x {seq_axis} shards; expand K/V to full heads instead"
        )
    grp = axis_group(mesh, (seq_axis,))
    if grp.group is None:
        grp = None
    qh, kh, vh = seq_to_heads(q, grp), seq_to_heads(k, grp), seq_to_heads(v, grp)
    if use_flash and causal:
        from pretraining_llm_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(qh, kh, vh, block_q=block_q, block_kv=block_kv)
    else:
        out = naive_attention(qh, kh, vh, causal=causal)
    return heads_to_seq(out, grp)
