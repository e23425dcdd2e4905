"""Pipeline parallelism: layer stages over the 'pipe' mesh axis.

Counterpart of ``pretraining_llm_tpu/parallel/pipeline.py``. The JAX
package runs the whole pipeline as one SPMD program: a ``lax.scan`` over
ticks inside a ``shard_map`` manual over 'pipe', one ``ppermute`` hop per
tick, and ``jax.grad`` transposes the loop. Here each pipe rank is a
process that runs the same tick loop on its own layers, and the hops are
point-to-point messages on the pipe group (``dist.batch_isend_irecv``):

  - the stacked block params' leading layer dim is split over 'pipe'
    (``parallel.sharding.param_pspec(..., pipeline=True)``); a rank holds
    ``L / S`` layers. With ``interleave=V > 1`` (Megatron's virtual stages)
    rank r hosts the depth chunks r, S + r, 2S + r, ..., each of
    ``L / (S V)`` layers, and the train state keeps them in that rank-major
    order (``interleave_layout``, baked once by
    ``training.train_step.shard_train_state``);
  - on tick t rank r works on item u = t - r of the m-major (microbatch m,
    lap v) stream: rank 0 injects microbatch m (lap 0) or the activation
    that lapped the ring (its wrap buffer), the others take what arrived
    from rank r - 1; the rank runs its chunk v through ``block_fn`` (each
    layer under ``ops.remat.checkpoint_wrap(block_fn, remat)``); the last
    rank banks microbatch m's final lap; the activation hops one rank on
    (a chain for V = 1, a ring with a wrap edge from rank S - 1 to rank 0
    for V > 1). ``schedule_ticks`` ticks drain the pipe;
  - where JAX runs every rank's chunk on every tick and masks the bubble's
    results, a rank here runs no chunk on a tick without an item, and the
    hops carry only activations that their receiver uses: both ends read
    that from the static schedule, so every send meets its receive in the
    same tick;
  - the backward is JAX's transpose of the loop, driven by the schedule
    rather than left to autograd's order: ``_Pipeline``'s backward walks
    the ticks in reverse, each tick first running the reverse hop (the
    gradient of what a rank received goes back to its sender, the
    transpose of ``ppermute``) and then the backward of that tick's chunk.
    Every rank runs the same hops in the same order, whichever of its
    outputs autograd reached first;
  - after the loop the output (the last rank's bank, zeros elsewhere) is
    reduce-scattered over 'pipe' along the sequence dim (JAX's
    ``psum_scatter(..., scatter_dimension=1)``), so each rank's final
    norm, head and loss run on its T / S columns; the backward
    all-gathers. The MoE aux loss is summed over 'pipe' and divided by the
    microbatch count; its backward is the same sum.

Microbatch m is the global batch's rows [m mb, (m + 1) mb), split over the
data x fsdp ranks, as in JAX: a rank's own rows are its contiguous block
of the global batch, so where the rows of a microbatch matter (a MoE
model's routing groups and capacity) ``microbatch_rows`` gives each rank
its part of every global microbatch (``models.transformer.forward``
exchanges the token ids and maps the output back).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pretraining_llm_tpu_torch.parallel.mesh import AxisGroup, axis_group, backend
from pretraining_llm_tpu_torch.parallel.tensor import all_reduce, gather_dim, scatter_dim

BlockFn = Callable[[Any, torch.Tensor], Tuple[torch.Tensor, Optional[torch.Tensor]]]


def schedule_ticks(n_micro: int, n_stages: int, interleave: int = 1) -> int:
    """Ticks the schedule runs: interleave * n_micro + n_stages - 1 (the
    GPipe minimum for V = 1; with V > 1 a tick costs 1/V of a GPipe tick)."""
    return interleave * n_micro + n_stages - 1


def bubble_fraction(n_micro: int, n_stages: int, interleave: int = 1) -> float:
    """(S - 1) / ticks: the share of a rank's ticks without an item."""
    return (n_stages - 1) / schedule_ticks(n_micro, n_stages, interleave)


def _permute_layers(a: torch.Tensor, outer: int, inner: int) -> torch.Tensor:
    lpc = a.shape[0] // (outer * inner)
    return a.reshape(outer, inner, lpc, *a.shape[1:]).transpose(0, 1).reshape(a.shape)


def _tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def interleave_layout(blocks: Any, n_stages: int, interleave: int) -> Any:
    """Stacked block params depth-major -> rank-major chunk order: depth
    chunk j = v S + r lives on rank r, and the order (r, v, k) makes rank
    r's contiguous ``pipe`` block hold exactly its V chunks."""
    if interleave <= 1:
        return blocks
    return _tree_map(lambda a: _permute_layers(a, interleave, n_stages), blocks)


def deinterleave_layout(blocks: Any, n_stages: int, interleave: int) -> Any:
    """Inverse of ``interleave_layout``: rank-major -> depth-major."""
    if interleave <= 1:
        return blocks
    return _tree_map(lambda a: _permute_layers(a, n_stages, interleave), blocks)


def depth_chunks(rank: int, n_layers: int, n_stages: int, interleave: int) -> List[Tuple[int, int]]:
    """[start, stop) in depth order of each of rank ``rank``'s V chunks,
    in the order the rank holds them (its rank-major block)."""
    lpc = n_layers // (n_stages * interleave)
    return [((v * n_stages + rank) * lpc, (v * n_stages + rank + 1) * lpc) for v in range(interleave)]


def check_schedule(global_batch: int, seq_len: int, *, n_micro: int, n_stages: int, interleave: int,
                   batch_shards: int) -> None:
    """The JAX package's checks on a pipelined call, in its words."""
    if global_batch % n_micro != 0 or (global_batch // n_micro) % batch_shards != 0:
        raise ValueError(
            f"global batch {global_batch} must split into pipeline_microbatches="
            f"{n_micro} of a size divisible by the {batch_shards} data shards"
        )
    if seq_len % n_stages != 0:
        raise ValueError(
            f"sequence length {seq_len} must divide by n_stages="
            f"{n_stages} (the output reduce-scatter slices the sequence dim)"
        )
    if interleave > 1 and n_micro < n_stages:
        raise ValueError(
            f"pipeline_interleave={interleave} needs pipeline_microbatches "
            f">= pipeline_stages ({n_micro} < {n_stages})"
        )


def microbatch_rows(n_rows: int, n_micro: int, n_shards: int, shard: int) -> torch.Tensor:
    """The global rows a data x fsdp shard holds when the global batch of
    ``n_rows * n_shards`` rows is cut into ``n_micro`` microbatches and each
    microbatch is split over the shards (JAX's layout inside the pipeline):
    microbatch m's q = rows / (n_micro shards) rows of shard k are global
    rows m mb + k q ... m mb + (k + 1) q, with mb = n_shards q."""
    q = n_rows // n_micro
    m = torch.arange(n_micro)[:, None]
    i = torch.arange(q)[None, :]
    return (m * (n_shards * q) + shard * q + i).reshape(-1)


# ---------------------------------------------------------------------------
# The hops
# ---------------------------------------------------------------------------


_JOINED: set = set()  # the pipe groups that ran a collective before their first hop


def _join(grp: AxisGroup, device: torch.device) -> None:
    """One all-reduce on the pipe group before its first hop: NCCL wants
    every rank of a group in its first collective, and a tick's hops
    involve only some ranks."""
    key = (id(grp.group), grp.ranks)  # a mesh keeps its groups alive
    if key not in _JOINED:
        all_reduce(torch.zeros(1, device=device), grp.group)
        _JOINED.add(key)


def _p2p(send: Optional[Tuple[torch.Tensor, int]], recv: Optional[Tuple[torch.Tensor, int]],
         group: Any) -> None:
    """One tick's hop on this rank: ``send`` = (tensor, global peer),
    ``recv`` = (buffer, global peer), either None. Both are posted at once
    (``batch_isend_irecv``) and waited on. Under gloo a CUDA tensor is
    staged through host memory (gloo's point-to-point takes CPU tensors)."""
    staged = backend() == "gloo"
    ops = []
    out = None
    if send is not None:
        t = send[0].contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if staged and t.is_cuda else t, send[1], group))
    if recv is not None:
        buf = recv[0]
        out = torch.empty(buf.shape, dtype=buf.dtype) if staged and buf.is_cuda else buf
        ops.append(dist.P2POp(dist.irecv, out, recv[1], group))
    if not ops:
        return
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if recv is not None and out is not recv[0]:
        recv[0].copy_(out)


class _Schedule:
    """The static schedule of one rank: for tick t, its item (m, v) or
    None, and whether it sends or receives an activation."""

    def __init__(self, rank: int, n_stages: int, n_micro: int, interleave: int) -> None:
        self.rank, self.s, self.n, self.v = rank, n_stages, n_micro, interleave
        self.ticks = schedule_ticks(n_micro, n_stages, interleave)
        self.ring = interleave > 1

    def item(self, t: int, rank: Optional[int] = None) -> Optional[Tuple[int, int]]:
        u = t - (self.rank if rank is None else rank)
        if not 0 <= u < self.v * self.n:
            return None
        return u % self.n, u // self.n

    def sends(self, t: int, rank: Optional[int] = None) -> bool:
        """Whether ``rank`` (default this one) sends its tick-t output on:
        every rank but the last along the chain; the last rank only before
        an item's final lap (the wrap edge)."""
        rank = self.rank if rank is None else rank
        it = self.item(t, rank)
        if it is None:
            return False
        return rank < self.s - 1 or (self.ring and it[1] < self.v - 1)

    def receives(self, t: int) -> bool:
        prev = (self.rank - 1) % self.s
        if self.rank == 0 and not self.ring:
            return False
        return self.sends(t, prev)


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _rebuild(tree: Any, it: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


class _Run:
    """One pipelined call's state on this rank: the schedule, the layers,
    the peers, and (with grad) each tick's chunk input and output."""

    def __init__(self, layers: List[Any], x: torch.Tensor, grp: AxisGroup, block_fn: BlockFn, *,
                 n_micro: int, remat: str, interleave: int) -> None:
        from pretraining_llm_tpu_torch.ops.remat import checkpoint_wrap

        self.layers, self.grp = layers, grp
        self.sched = _Schedule(grp.index, grp.size, n_micro, interleave)
        s = grp.size
        self.next = grp.ranks[(grp.index + 1) % s]
        self.prev = grp.ranks[(grp.index - 1) % s]
        self.lpc = len(layers) // interleave
        self.body = checkpoint_wrap(block_fn, remat) if torch.is_grad_enabled() else block_fn
        self.shape = (x.shape[0] // n_micro,) + tuple(x.shape[1:])
        self.n_micro = n_micro

    def chunk(self, v: int, a: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        aux = None
        for blk in self.layers[v * self.lpc:(v + 1) * self.lpc]:
            a, aux_i = self.body(blk, a)
            if aux_i is not None:
                aux = aux_i if aux is None else aux + aux_i
        return a, aux

    def forward(self, x: torch.Tensor, record: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor], list]:
        """The tick loop. Returns (bank: the final laps in microbatch order,
        zeros off the last rank; this rank's aux sum; with ``record`` each
        tick's (t, m, v, chunk input leaf, output, aux, source))."""
        sched, last = self.sched, self.grp.index == self.grp.size - 1
        mbs = x.reshape((self.n_micro,) + self.shape)
        bank = torch.zeros_like(mbs)
        wrap: Dict[int, Tuple[torch.Tensor, int]] = {}
        recv: Optional[Tuple[torch.Tensor, int]] = None  # (activation, the tick it arrived)
        aux_sum: Optional[torch.Tensor] = None
        records = []
        for t in range(sched.ticks):
            it = sched.item(t)
            y = None
            if it is not None:
                m, v = it
                if self.grp.index > 0:
                    src, a = ("recv", recv[1]), recv[0]
                elif v == 0:
                    src, a = ("input", m), mbs[m]
                else:
                    a, tick_in = wrap.pop(m)
                    src = ("recv", tick_in)
                if record:
                    a = a.detach().requires_grad_(True)
                y, aux = self.chunk(v, a)
                if aux is not None:
                    aux_sum = aux if aux_sum is None else aux_sum + aux
                if last and v == sched.v - 1:
                    bank[m] = y.detach() if record else y
                if record:
                    records.append((t, m, v, a, y, aux, src))
            out = (y.detach(), self.next) if sched.sends(t) else None
            inbox = (torch.empty(self.shape, dtype=x.dtype, device=x.device), self.prev) if sched.receives(t) else None
            _p2p(out, inbox, self.grp.group)
            recv = None if inbox is None else (inbox[0], t)
            if recv is not None and self.grp.index == 0:  # the wrap edge: bank the lapped activation
                wrap[sched.item(t, self.grp.size - 1)[0]] = recv
        return bank.reshape(x.shape), aux_sum, records

    def backward(self, records: list, g_bank: torch.Tensor, g_aux: Optional[torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
        """The transposed tick loop: gradients flow to each chunk's inputs
        and the layers' leaves (their ``.grad``); returns the input's."""
        sched, last = self.sched, self.grp.index == self.grp.size - 1
        g_bank = g_bank.reshape((self.n_micro,) + self.shape)
        dx = torch.zeros((self.n_micro,) + self.shape, dtype=x.dtype, device=x.device)
        g_recv: Dict[int, torch.Tensor] = {}
        by_tick = {r[0]: r for r in records}
        for t in reversed(range(sched.ticks)):
            # The reverse hop of tick t: the gradient of what this rank
            # received goes back to its sender; the gradient of what it
            # sent arrives from its receiver.
            back = (g_recv.pop(t), self.prev) if sched.receives(t) else None
            inbox = (torch.empty(self.shape, dtype=x.dtype, device=x.device), self.next) if sched.sends(t) else None
            _p2p(back, inbox, self.grp.group)
            rec = by_tick.get(t)
            if rec is None:
                continue
            _, m, v, a, y, aux, src = rec
            g_y = inbox[0] if inbox is not None else None
            if last and v == sched.v - 1:
                g_y = g_bank[m] if g_y is None else g_y + g_bank[m]
            outs, grads = [y], [torch.zeros_like(y) if g_y is None else g_y]
            if aux is not None and g_aux is not None:
                outs.append(aux)
                grads.append(g_aux.to(aux.dtype))
            torch.autograd.backward(outs, grads)
            g_a = a.grad if a.grad is not None else torch.zeros_like(a)
            if src[0] == "input":
                dx[src[1]] += g_a
            else:
                g_recv[src[1]] = g_recv[src[1]] + g_a if src[1] in g_recv else g_a
        return dx.reshape(x.shape)


class _Pipeline(torch.autograd.Function):
    """The pipelined layer stack of one rank with its output collectives:
    forward (x, *layer leaves) -> (this rank's T / S columns of the output,
    the aux loss summed over pipe / n_micro); backward all-gathers the
    columns' gradient, sums the aux's, and runs the transposed ticks."""

    @staticmethod
    def forward(ctx, run, layers_template, x, *leaves):
        ctx.run = run
        detached = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        run.layers = _unflatten_layers(layers_template, detached)
        x_in = x.detach()
        with torch.enable_grad():
            bank, aux, records = run.forward(x_in, record=True)
        ctx.records, ctx.leaves, ctx.x = records, detached, x_in
        cols = scatter_dim(bank, 1, run.grp)
        aux_total = _aux_total(aux, run, x)
        return cols, aux_total

    @staticmethod
    def backward(ctx, g_cols, g_aux):
        run = ctx.run
        # Every pipe rank runs both collectives (autograd materializes an
        # unused output's gradient as zeros), then the same reverse hops.
        g_bank = gather_dim(g_cols, 1, run.grp)
        g_aux = all_reduce(g_aux.detach().float().clone(), run.grp.group) / run.n_micro
        dx = run.backward(ctx.records, g_bank, g_aux, ctx.x)
        grads = [p.grad for p in ctx.leaves]
        ctx.records = ctx.leaves = None
        return (None, None, dx) + tuple(grads)


def _aux_total(aux: Optional[torch.Tensor], run: _Run, like: torch.Tensor) -> torch.Tensor:
    """The aux loss summed over the pipe ranks' chunks, averaged over the
    microbatches (every rank gets the total; zero for a dense model)."""
    total = torch.zeros((), dtype=torch.float32, device=like.device)
    if aux is not None:
        total = total + aux.detach().float()
    return all_reduce(total, run.grp.group) / run.n_micro


def _flatten_layers(layers: List[Any]) -> List[torch.Tensor]:
    return [p for blk in layers for p in _leaves(blk)]


def _unflatten_layers(template: List[Any], leaves: Sequence[torch.Tensor]) -> List[Any]:
    it = iter(leaves)
    return [_rebuild(blk, it) for blk in template]


def pipeline_apply(
    layers: List[Any],
    x: torch.Tensor,
    mesh: Any,
    block_fn: BlockFn,
    *,
    n_micro: int,
    remat: str = "none",
    interleave: int = 1,
    batch_shards: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run this rank's layers as its stage of the pipeline.

    ``layers``: the rank's ``L / S`` layers, a list of per-layer trees, in
    rank-major order (its V chunks one after the other;
    ``interleave_layout``). ``x``: (B, T, D)
    the rank's embedded rows (every pipe rank passes them; rank 0's are
    used), laid out so that rows [m B / n_micro, (m + 1) B / n_micro) are
    its part of microbatch m. ``block_fn``: (layer params, h) -> (h, aux or
    None) for ONE layer. ``batch_shards``: the data x fsdp ranks that
    split the global batch (JAX's divisibility check).

    Returns (this rank's (B, T / S, D) columns of the stack's output: the
    columns [r T / S, (r + 1) T / S) of pipe rank r; the aux loss summed
    over layers and averaged over microbatches, fp32, 0 for a dense
    model), as JAX's ``pipeline_apply`` returns them under ``P(None,
    'pipe')`` and ``P()``."""
    grp = axis_group(mesh, ("pipe",))
    s = grp.size
    check_schedule(x.shape[0] * batch_shards, x.shape[1], n_micro=n_micro, n_stages=s,
                   interleave=interleave, batch_shards=batch_shards)
    if len(layers) % interleave:
        raise ValueError(f"this rank's {len(layers)} layers do not split into pipeline_interleave={interleave} chunks")
    _join(grp, x.device)
    run = _Run(layers, x, grp, block_fn, n_micro=n_micro, remat=remat, interleave=interleave)
    leaves = _flatten_layers(layers)
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in leaves)):
        return _Pipeline.apply(run, layers, x, *leaves)
    bank, aux, _ = run.forward(x, record=False)
    return scatter_dim(bank, 1, grp), _aux_total(aux, run, x)


class _GatherColumns(torch.autograd.Function):
    """The pipe ranks' column blocks concatenated along dim 1; the backward
    keeps this rank's block of the gradient (each rank holds the same full
    output and the same gradient of it)."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp, ctx.n = grp, x.shape[1]
        return gather_dim(x, 1, grp)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.grp.index * ctx.n
        return g[:, lo:lo + ctx.n].contiguous(), None


def gather_columns(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """(B, T / S, ...) column blocks of the pipe ranks -> (B, T, ...)."""
    return _GatherColumns.apply(x, axis_group(mesh, ("pipe",)))


def rank_columns(a: torch.Tensor, mesh: Any) -> torch.Tensor:
    """This pipe rank's T / S columns of a (B, T, ...) tensor."""
    grp = axis_group(mesh, ("pipe",))
    n = a.shape[1] // grp.size
    return a[:, grp.index * n:(grp.index + 1) * n]
