"""Tensor and expert parallelism: the collectives the layers issue.

The JAX package has no module like this one: its weights carry
``PartitionSpec``s and its activations ``constrain`` annotations, and XLA
inserts the collectives. The port runs explicit SPMD: each rank holds the
block of every leaf that ``parallel.sharding.local_slices`` gives it, and
the layers issue their collectives themselves, Megatron's way:

  - ``copy_to_group``: the identity forward, an all-reduce of the gradient
    backward. It marks where a replicated activation enters a
    column-parallel product (each rank's input gradient is partial);
  - ``sum_over_group``: an all-reduce forward, the identity backward. It
    closes a row-parallel product (each rank's output is partial).

The same pair serves the tensor axis (heads, the MLP hidden dim and the
vocabulary split over 'tensor') and the expert axis (each rank runs its
E/ep experts on the tokens that every expert rank routes alike). Around
them: the vocabulary-parallel embedding lookup and log-sum-exp of the
head (``vocab_embed``, ``vocab_lse``, ``vocab_label``), the all-gather
of the head's logits for sampling (``gather_last``), and the all-gather
of the router's logits over the token ranks (``gather_rows``).

The collectives take the tensors where they live: NCCL's on the cards,
gloo's on the CPU, and gloo's on CUDA tensors too when ranks share one card
(chip_smoke's X2 probes each one it uses there).
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

from pretraining_llm_tpu_torch.parallel.mesh import AxisGroup, axis_group, mesh_shape

def all_reduce(x: torch.Tensor, group: Any, op: Any = None) -> torch.Tensor:
    """Sum (or ``op``) ``x`` over ``group`` in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return x


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group: Any) -> torch.Tensor:
    """``out`` (n * rows, ...) = the group's ``x`` stacked in rank order."""
    with warnings.catch_warnings():  # newer torch names a successor that older torch lacks
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group: Any) -> torch.Tensor:
    """``out`` = this rank's block of dim 0 of ``x`` summed over the group."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def all_to_all_single(out: torch.Tensor, x: torch.Tensor, group: Any) -> torch.Tensor:
    """``out``'s block j = rank j's block of dim 0 of ``x`` for this rank.
    Under gloo a CUDA tensor is staged through host memory (gloo's
    all-to-all takes CPU tensors)."""
    if dist.get_backend(group) == "gloo" and x.is_cuda:
        host = torch.empty(out.shape, dtype=out.dtype)
        dist.all_to_all_single(host, x.contiguous().cpu(), group=group)
        return out.copy_(host)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def gather_dim(x: torch.Tensor, dim: int, grp: AxisGroup) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank order."""
    t = x.movedim(dim, 0).contiguous()
    out = torch.empty((grp.size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    return all_gather_into(out, t, grp.group).movedim(0, dim)


def scatter_dim(x: torch.Tensor, dim: int, grp: AxisGroup) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` summed over the group."""
    t = x.movedim(dim, 0).contiguous()
    out = torch.empty((t.shape[0] // grp.size,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    return reduce_scatter_into(out, t, grp.group).movedim(0, dim)


# ---------------------------------------------------------------------------
# The groups the layers read
# ---------------------------------------------------------------------------


def layer_group(mesh: Any, axes: tuple) -> Optional[AxisGroup]:
    """The group over ``axes`` of ``mesh`` when it holds more than this
    rank, else None (no mesh, or every axis of size 1). Cached on the mesh:
    the layers ask for it in every call."""
    if mesh is None:
        return None
    cache = mesh.__dict__.setdefault("_layer_groups", {})
    if axes not in cache:
        shape = mesh_shape(mesh)
        cache[axes] = None if all(shape.get(a, 1) == 1 for a in axes) else axis_group(mesh, axes)
    return cache[axes]


def tensor_group(mesh: Any) -> Optional[AxisGroup]:
    return layer_group(mesh, ("tensor",))


# ---------------------------------------------------------------------------
# Megatron's pair
# ---------------------------------------------------------------------------


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.grp.group), None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return all_reduce(x.contiguous().clone(), grp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, grp: Optional[AxisGroup]) -> torch.Tensor:
    """Identity forward; backward sums the gradient over ``grp``."""
    return x if grp is None else _CopyToGroup.apply(x, grp)


def sum_over_group(x: torch.Tensor, grp: Optional[AxisGroup]) -> torch.Tensor:
    """Sum over ``grp`` forward; identity backward."""
    return x if grp is None else _SumOverGroup.apply(x, grp)


class _GatherLast(torch.autograd.Function):
    """The group's blocks along the last dim, concatenated; the backward
    keeps this rank's block of the gradient (every rank holds the same
    full gradient)."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp, ctx.n = grp, x.shape[-1]
        return gather_dim(x, x.dim() - 1, grp)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.grp.index * ctx.n
        return g[..., lo:lo + ctx.n].contiguous(), None


def gather_last(x: torch.Tensor, grp: Optional[AxisGroup]) -> torch.Tensor:
    """The full last dim from each rank's block of it (the head's logits
    over the vocabulary before sampling)."""
    return x if grp is None else _GatherLast.apply(x, grp)


class _GatherRows(torch.autograd.Function):
    """The group's rows concatenated in rank order; the backward sums the
    gradient over the group and keeps this rank's rows (each rank's loss is
    its part of the global objective)."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return gather_dim(x, 0, grp)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, 0, ctx.grp), None


def gather_rows(x: torch.Tensor, grp: Optional[AxisGroup]) -> torch.Tensor:
    return x if grp is None else _GatherRows.apply(x, grp)


# ---------------------------------------------------------------------------
# The vocabulary-parallel embedding and head
# ---------------------------------------------------------------------------


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, grp: Optional[AxisGroup],
                dtype: torch.dtype) -> torch.Tensor:
    """Rows of a (V, D) table for ``tokens``, each rank holding a (V/tp, D)
    block: the rank looks up the tokens in its block, zeros the others, and
    the ranks' rows are summed (one term each, so the sum is exact)."""
    if grp is None:
        return table[tokens].to(dtype)
    vl = table.shape[0]
    local = tokens.long() - grp.index * vl
    mine = (local >= 0) & (local < vl)
    rows = table[local.clamp(0, vl - 1)].to(dtype) * mine[..., None].to(dtype)
    return sum_over_group(rows.float(), grp).to(dtype)


def vocab_lse(logits: torch.Tensor, grp: Optional[AxisGroup]) -> torch.Tensor:
    """logsumexp over the last dim of the full (S, V) logits from each
    rank's (S, V/tp) columns: the max and the sum of exponentials are
    reduced over the group (no autograd: the CE heads' custom backward
    uses the saved result)."""
    if grp is None:
        return torch.logsumexp(logits, dim=-1)
    m = all_reduce(logits.amax(dim=-1), grp.group, dist.ReduceOp.MAX)
    s = all_reduce(torch.exp(logits - m[:, None]).sum(dim=-1), grp.group)
    return torch.log(s) + m


def vocab_label(logits: torch.Tensor, targets: torch.Tensor, grp: Optional[AxisGroup]) -> torch.Tensor:
    """logits[i, targets[i]] from each rank's columns: taken on the rank
    that owns the column (``targets`` already shifted into the rank's
    block, out-of-range elsewhere), zero on the others, summed."""
    if grp is None:
        return logits.gather(1, targets[:, None])[:, 0]
    vl = logits.shape[1]
    mine = (targets >= 0) & (targets < vl)
    label = logits.gather(1, targets.clamp(0, vl - 1)[:, None])[:, 0] * mine
    return all_reduce(label, grp.group)
