"""The train step: grads -> clip -> optimizer -> metrics.

Counterpart of ``pretraining_llm_tpu/training/train_step.py``. The state is a plain dict {'params', 'opt', 'step'} (+ 'ema'), the
same tree as the JAX package's, so checkpoints of either package restore
in the other. PyTorch runs eagerly: ``loss.backward()`` takes the place of
``jax.value_and_grad`` and a Python loop over microbatches the place of the
``lax.scan``. Metrics stay tensors on the device (no host sync in a step).
Where JAX donates the state, the port updates it in place: the backward
adds into one gradient tree, the clip scales it, and the optimizer writes
the parameters and its state where they are (``training/optimizer.py``).

On a mesh (``build_train_step(cfg, mesh)``, ``parallel/``) each rank runs
the step on its rows of the global batch (and, with ring or Ulysses
attention, its share of the columns; ``models.transformer.loss_fn``) and
holds its block of every leaf that ``state_pspec_tree`` shards over fsdp,
tensor or expert (JAX's spec tree: parameters, AdamW's moments and the
EMA alike; ``shard_train_state``). The tensor and expert ranks of a data
group hold the same rows; the layers' own collectives (``parallel/
tensor.py``) make their blocks' gradients whole. Where JAX's one SPMD
program gets its collectives from XLA, ``MeshPlan`` issues the rest:

  - an fsdp-sharded parameter is all-gathered over the fsdp ranks for use
    (``_GatherShard``, once per microbatch, outside the layers' remat
    regions) and its gradient reduce-scattered back in the backward;
    tensor and expert blocks stay the rank's own;
  - the loss is each rank's part of the global token mean, so the
    gradient is a partial sum over the token axes (data, fsdp, and seq
    when it splits the tokens), never over tensor or expert: fsdp blocks
    are summed over the other token axes, every other leaf over all of
    them. Leaves replicated over 'tensor' (norms, ``bo``, ``b2``) come
    out equal on every tensor rank; the two whose gradient is partial
    there, a replicated GQA ``wkv``/``bkv`` (G not dividing tp) and the
    experts' ``b2``, are also summed over 'tensor'. Nothing averages by
    the world size;
  - the global norm sums each leaf's squares over the axes that split it,
    once (replicas hold the same block);
  - AdamW and the EMA update each rank's blocks in place. Adafactor keeps
    JAX's replicated statistics: for a split leaf the rank sums its block
    of the gradient's squares into row and column sums, sums those over
    the ranks that split the summed dim, updates its block of the
    statistics and gathers the rest (``MeshPlan.split``); the update's RMS
    sums the squares over every rank of the leaf, stacked layers
    included. Muon's momentum is
    sharded like its parameter; the momentum-corrected matrix is gathered
    over the fsdp and tensor ranks that cut each (layer, expert) matrix,
    orthogonalized on every rank, and the rank keeps its block (pipe and
    expert splits cut the batch of matrices and stay local).

With ``pipeline_stages`` > 1 on a mesh whose pipe axis is above 1
(``_is_pipelined``, JAX's rule) the block leaves' layer dim is split over
'pipe' (``param_pspec_tree(..., pipeline=True)``) and the layers run as
``parallel/pipeline.py``'s stages. With V = ``pipeline_interleave`` > 1 the
state keeps its block leaves in the rank-major order of
``pipeline.interleave_layout`` (``bake_state_layout``, once, in
``shard_train_state``), as JAX bakes it; checkpoints stay depth-major
(``checkpoint_layout`` writes each rank's V chunks where they lie in depth
order, ``save_view`` de-interleaves the replicated leaves). Every leaf
outside ``blocks`` is replicated over 'pipe' and its gradient summed there
(the input's gradient reaches rank 0 only, each rank's head sees its own
columns); the block leaves' gradients are not.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from pretraining_llm_tpu_torch.config import Config
from pretraining_llm_tpu_torch.models import transformer
from pretraining_llm_tpu_torch.parallel import pipeline as pp
from pretraining_llm_tpu_torch.parallel.mesh import AxisGroup, axis_group, axis_size, coordinate, mesh_shape
from pretraining_llm_tpu_torch.parallel.sharding import (
    _entry_axes, activation_mesh, is_sharded, local_slices, param_pspec_tree, shard_tree,
)
from pretraining_llm_tpu_torch.parallel.tensor import all_gather_into, all_reduce, reduce_scatter_into
from pretraining_llm_tpu_torch.training import optimizer as opt
from pretraining_llm_tpu_torch.training.checkpoint import ShardedLeaf
from pretraining_llm_tpu_torch.utils import debug
from pretraining_llm_tpu_torch.utils.device import DeviceLike, resolve_device

TrainState = Dict[str, Any]
Batch = Tuple[torch.Tensor, torch.Tensor]


def init_train_state(
    cfg: Config, generator: Union[torch.Generator, int, None] = None, *, device: DeviceLike = None,
    mesh: Any = None,
) -> TrainState:
    """Fresh params (``transformer.init_params`` from ``generator``, by
    default ``cfg.train.seed``), the zero state of ``train.optimizer``, step
    0, and an fp32 EMA copy of the params when ``train.ema_decay`` > 0. On
    a ``mesh`` every rank draws the same full parameters and keeps its
    blocks (in the baked layout of an interleaved pipeline); the optimizer
    state is made from the blocks, except Adafactor's statistics, which are
    replicated (JAX's spec) and so made whole."""
    dev = resolve_device(device)
    seed = cfg.train.seed if generator is None else generator
    params = transformer.init_params(cfg.model, seed, device=dev)
    opt_state = opt.optimizer_init(params, cfg.train) if cfg.train.optimizer == "adafactor" else None
    if mesh is not None:
        if uses_baked_layout(cfg, mesh):
            params = dict(params, blocks=_bake(params["blocks"], cfg, True))
        specs = param_pspec_tree(params, _is_pipelined(cfg, mesh), tensor_size=axis_size(mesh, "tensor"))
        params = shard_tree(params, specs, mesh)
    state: TrainState = {
        "params": params,
        "opt": opt_state if opt_state is not None else opt.optimizer_init(params, cfg.train),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if cfg.train.ema_decay > 0:
        state["ema"] = opt.tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def state_pspec_tree(state: TrainState, pipeline: bool = False, *, tensor_size: int = 1) -> Any:
    """Specs for the full train state (moments mirror params), JAX's tree:
    Adafactor's factored statistics are replicated, Muon's and AdamW's
    per-leaf state is sharded like its parameter."""
    kw = {"tensor_size": tensor_size}
    pspecs = param_pspec_tree(state["params"], pipeline, **kw)
    if "v" in state["opt"]:
        opt_pspecs = {"v": opt.tree_map(lambda x: (), state["opt"]["v"]), "count": ()}
    elif "s" in state["opt"]:
        opt_pspecs = {"s": {k: _mirror(pspecs[k], state["opt"]["s"][k]) for k in pspecs}, "count": ()}
    else:
        opt_pspecs = {
            "mu": param_pspec_tree(state["opt"]["mu"], pipeline, **kw),
            "nu": param_pspec_tree(state["opt"]["nu"], pipeline, **kw),
            "count": (),
        }
    out = {"params": pspecs, "opt": opt_pspecs, "step": ()}
    if "ema" in state:
        out["ema"] = param_pspec_tree(state["ema"], pipeline, **kw)
    return out


def _mirror(spec_tree: Any, state_tree: Any) -> Any:
    """Muon's per-leaf state dicts ({"m"} or {"mu", "nu"}) under each
    parameter's spec."""
    if isinstance(spec_tree, dict):
        return {k: _mirror(spec_tree[k], state_tree[k]) for k in spec_tree}
    return {k: spec_tree for k in state_tree}


def shard_train_state(state: TrainState, mesh: Any, cfg: Config) -> TrainState:
    """Each leaf of a full (depth-major) train state replaced by this
    rank's block under ``state_pspec_tree`` at the mesh's tensor size
    (leaves that are not split stay as they are). When ``cfg`` pipelines
    on ``mesh`` the block leaves split over 'pipe', in the baked rank-major
    layout for an interleaved pipeline, as JAX's ``shard_train_state``
    does."""
    pipelined = _is_pipelined(cfg, mesh)
    if pipelined and uses_baked_layout(cfg, mesh):
        state = bake_state_layout(state, cfg, forward=True)
    return shard_tree(state, state_pspec_tree(state, pipelined, tensor_size=axis_size(mesh, "tensor")), mesh)


def _is_pipelined(cfg: Config, mesh: Any) -> bool:
    """JAX's rule: ``pipeline_stages`` > 1 on a mesh whose pipe axis is
    above 1."""
    return transformer.use_pipeline(cfg.model, mesh)


def uses_baked_layout(cfg: Config, mesh: Any) -> bool:
    """Whether the train state keeps its block leaves in the rank-major
    layout of an interleaved pipeline (baked once by ``shard_train_state``
    instead of permuted every step)."""
    return _is_pipelined(cfg, mesh) and cfg.model.pipeline_interleave > 1


def _bake(blocks: Any, cfg: Config, forward: bool) -> Any:
    s, v = cfg.model.pipeline_stages, cfg.model.pipeline_interleave
    return (pp.interleave_layout if forward else pp.deinterleave_layout)(blocks, s, v)


def bake_state_layout(state: TrainState, cfg: Config, forward: bool = True) -> TrainState:
    """Block leaves between depth-major and the interleaved rank-major
    layout (``forward=True``: depth -> rank-major), for the params, every
    optimizer container that holds ``blocks`` (AdamW ``mu``/``nu``,
    Adafactor ``v``, Muon ``s``) and the EMA. Whole leaves only."""
    out = dict(state)
    out["params"] = dict(state["params"], blocks=_bake(state["params"]["blocks"], cfg, forward))
    if "opt" in state:
        out["opt"] = {k: dict(sub, blocks=_bake(sub["blocks"], cfg, forward))
                      if isinstance(sub, dict) and "blocks" in sub else sub for k, sub in state["opt"].items()}
    if "ema" in state:
        out["ema"] = dict(state["ema"], blocks=_bake(state["ema"]["blocks"], cfg, forward))
    return out


def save_view(state: TrainState, cfg: Config, mesh: Any) -> TrainState:
    """The state as a checkpoint holds it: depth-major. In the baked layout
    the leaves split over 'pipe' are written where their chunks lie
    (``checkpoint_layout``); the replicated block leaves (Adafactor's
    statistics) are de-interleaved here."""
    if mesh is None or not uses_baked_layout(cfg, mesh):
        return state
    if "v" not in state["opt"]:
        return state
    return dict(state, opt=dict(state["opt"], v=dict(state["opt"]["v"], blocks=_bake(
        state["opt"]["v"]["blocks"], cfg, False))))


def state_template(cfg: Config) -> TrainState:
    """The full train state's tree as meta tensors: its global shapes for a
    checkpoint template, nothing allocated."""
    params = _meta(transformer.param_shapes(cfg.model))
    state: TrainState = {"params": params, "opt": opt.optimizer_init(params, cfg.train),
                         "step": torch.empty((), device="meta")}
    if cfg.train.ema_decay > 0:
        state["ema"] = params
    return state


def checkpoint_layout(template: TrainState, mesh: Any, cfg: Config) -> Optional[Dict[str, Any]]:
    """{leaf name: ``checkpoint.ShardedLeaf``} of a state of ``template``'s
    global shapes on ``mesh``: this rank's block of each sharded leaf, which
    it writes when it holds the replica-0 copy (coordinate 0 on every axis
    that does not split the leaf). None when nothing is sharded. When
    ``cfg`` pipelines on ``mesh`` the block leaves split over 'pipe'; in the baked
    layout a rank's block is its V chunks, each written at its depth-major
    place, so the file is depth-major."""
    coord = coordinate(mesh)
    layout = {}
    pipelined = _is_pipelined(cfg, mesh)
    specs = state_pspec_tree(template, pipelined, tensor_size=axis_size(mesh, "tensor"))
    baked = pipelined and uses_baked_layout(cfg, mesh)
    for (path, leaf), (_, spec) in zip(opt.tree_leaves(template), _spec_leaves(specs)):
        if not is_sharded(spec, mesh):
            continue
        used = {a for e in spec for a in _entry_axes(e)}
        write = all(c == 0 for a, c in coord.items() if a not in used)
        name = "__".join(path)
        index = local_slices(spec, tuple(leaf.shape), mesh, name=name)
        pieces = None
        if baked and spec and spec[0] == "pipe":
            m = cfg.model
            lpc = m.n_layers // (m.pipeline_stages * m.pipeline_interleave)
            pieces = [((slice(lo, hi),) + index[1:], slice(v * lpc, (v + 1) * lpc)) for v, (lo, hi) in enumerate(
                pp.depth_chunks(coord["pipe"], m.n_layers, m.pipeline_stages, m.pipeline_interleave))]
        layout[name] = ShardedLeaf(leaf.shape, index, write, pieces)
    return layout or None


def _grad_leaves(params: Any, grads: Any) -> Any:
    """Leaves for one backward whose ``.grad`` is the matching tensor of
    ``grads``, so that autograd adds into it in place. Block parameters
    become one leaf per layer (views of the stacked tensors), each with its
    slice of the stacked gradient: a backward through views of a stacked
    leaf would build a full-size zero gradient per layer."""
    def leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        t = p.detach().requires_grad_(True)
        t.grad = g
        return t

    out = {k: opt.tree_map(leaf, v, grads[k]) for k, v in params.items() if k != "blocks"}
    n_layers = opt.tree_leaves(params["blocks"])[0][1].shape[0]
    out["blocks"] = [opt.tree_map(lambda p, g: leaf(p[i], g[i]), params["blocks"], grads["blocks"])
                     for i in range(n_layers)]
    return out


def loss_and_grads(params: Any, x: torch.Tensor, y: torch.Tensor, cfg: Config,
                   grads: Optional[Any] = None, plan: Optional["MeshPlan"] = None) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of one microbatch. The backward adds into ``grads`` (a
    tree like ``params``; fresh zeros by default) in place. Under
    ``train.grad_dtype="bfloat16"`` each fp32 grad leaf is rounded to bf16
    once after the backward (a new tree). With a ``plan`` the loss and the
    gradients are this rank's parts (``MeshPlan``)."""
    if grads is None:
        grads = opt.tree_map(torch.zeros_like, params)
    leaves = _grad_leaves(params, grads)
    if plan is not None:
        leaves = plan.gather(leaves)
    loss = transformer.loss_fn(leaves, x, y, cfg.model, blocks_baked=plan is not None and plan.baked)
    loss.backward()
    if cfg.train.grad_dtype == "bfloat16":
        grads = opt.tree_map(lambda g: g.to(torch.bfloat16) if g.dtype == torch.float32 else g, grads)
    return loss.detach(), grads


def compute_grads(state: TrainState, batch: Batch, cfg: Config,
                  plan: Optional["MeshPlan"] = None) -> Tuple[torch.Tensor, Any]:
    """Mean loss and mean grads over ``train.microbatches`` slices of the
    batch. fp32 grads: every microbatch's backward adds into one tree, in
    microbatch order (the JAX package's zeros + g1 + g2 ..., bit for bit),
    then divides in place. bf16 grads: each microbatch's grads are rounded
    to bf16 and summed in a bf16 accumulator, as in the JAX package. With
    a ``plan`` the batch is this rank's rows, and the loss and gradients
    are summed over the ranks after the last microbatch."""
    x, y = batch
    n_micro = cfg.train.microbatches
    if n_micro == 1:
        loss, grads = loss_and_grads(state["params"], x, y, cfg, plan=plan)
        if plan is not None:
            loss, grads = plan.reduce_loss(loss), plan.reduce_grads(grads)
        return loss, grads
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"this rank's {b} rows do not split into {n_micro} microbatches")
    xm = x.reshape(n_micro, b // n_micro, -1)
    ym = y.reshape(n_micro, b // n_micro, -1)
    bf16 = cfg.train.grad_dtype == "bfloat16"
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    grad_sum = opt.tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.bfloat16 if (bf16 and p.dtype == torch.float32) else p.dtype),
        state["params"],
    )
    for i in range(n_micro):
        if bf16:
            loss, grads = loss_and_grads(state["params"], xm[i], ym[i], cfg, plan=plan)
            grad_sum = opt.tree_map(torch.add, grad_sum, grads)
        else:
            loss, grad_sum = loss_and_grads(state["params"], xm[i], ym[i], cfg, grad_sum, plan=plan)
        loss_sum = loss_sum + loss
    if plan is not None:
        loss_sum, grad_sum = plan.reduce_loss(loss_sum), plan.reduce_grads(grad_sum)
    with torch.no_grad():
        for _, g in opt.tree_leaves(grad_sum):
            g.div_(n_micro)
    return loss_sum / n_micro, grad_sum


def train_step(state: TrainState, batch: Batch, cfg: Config,
               plan: Optional["MeshPlan"] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step. Returns (new state, {'loss', 'grad_norm', 'lr'})."""
    tcfg = cfg.train
    loss, grads = compute_grads(state, batch, cfg, plan)
    if debug.nan_checks_enabled():
        debug.check_finite(f"train step {int(state['step'])}",
                           [("loss", loss)] + [("grad " + "/".join(p), g) for p, g in opt.tree_leaves(grads)])
    with torch.no_grad():
        norm_fn = opt.global_norm if plan is None else plan.global_norm
        if tcfg.grad_clip > 0:
            grads, grad_norm = opt.clip_by_global_norm(grads, tcfg.grad_clip, norm_fn)
        else:
            grad_norm = norm_fn(grads)
        lr = opt.learning_rate(state["step"], tcfg)
        update = opt.optimizer_update if plan is None else plan.optimizer_update
        new_params, new_opt = update(grads, state["opt"], state["params"], lr, tcfg)
        new_state: TrainState = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        if "ema" in state:
            d = tcfg.ema_decay
            new_state["ema"] = opt.tree_map(
                lambda e, p: d * e + (1.0 - d) * p.float(), state["ema"], new_params
            )
    return new_state, {"loss": loss, "grad_norm": grad_norm, "lr": lr}


def build_train_step(cfg: Config, mesh: Any = None
                     ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, (x, y))``, x and y (B, T) int tensors on the state's
    device, B = ``train.batch_size``. The step updates ``state``'s tensors
    in place and returns them in a new dict. On a ``mesh`` the state is
    ``shard_train_state``'s and x, y are this rank's rows (every column);
    the metrics are the global step's."""
    if mesh is None:
        return lambda state, batch: train_step(state, batch, cfg)
    plan = MeshPlan(cfg, mesh)

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        plan.check_state(state)
        with plan.active():
            return train_step(state, batch, cfg, plan)

    return step


def build_eval_loop(cfg: Config, mesh: Any = None) -> Callable[[TrainState, Batch], torch.Tensor]:
    """Mean eval loss (pure cross-entropy, ``include_aux=False``) over
    stacked batches (x, y), each (N, B, T); on a ``mesh`` this rank's rows
    of each batch, the loss summed over the ranks."""
    plan = None if mesh is None else MeshPlan(cfg, mesh)

    @torch.no_grad()
    def eval_many(state: TrainState, batches: Batch) -> torch.Tensor:
        xs, ys = batches
        params = state["params"] if plan is None else plan.gather_full(state["params"])
        total = torch.zeros((), dtype=torch.float32, device=xs.device)
        with contextlib.nullcontext() if plan is None else plan.active():
            for x, y in zip(xs, ys):
                total = total + transformer.loss_fn(params, x, y, cfg.model, include_aux=False,
                                                    blocks_baked=plan is not None and plan.baked)
        if plan is not None:
            total = plan.reduce_loss(total)
        return total / xs.shape[0]

    return eval_many


# ---------------------------------------------------------------------------
# The collectives of a step on a mesh
# ---------------------------------------------------------------------------


def _all_gather(shard: torch.Tensor, dim: int, group: Any, n: int) -> torch.Tensor:
    x = shard.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return all_gather_into(out, x, group).movedim(0, dim)


def _reduce_scatter(full: torch.Tensor, dim: int, group: Any, n: int) -> torch.Tensor:
    x = full.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return reduce_scatter_into(out, x, group).movedim(0, dim)


class _GatherShard(torch.autograd.Function):
    """A parameter block all-gathered along ``dim`` over the fsdp group;
    the backward reduce-scatters (sums) the full gradient back to the
    block, so the rank's block gradient sums every fsdp rank's
    contribution."""

    @staticmethod
    def forward(ctx, shard, dim, group, n):
        ctx.meta = (dim, group, n)
        return _all_gather(shard, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.meta
        return _reduce_scatter(g, dim, group, n), None, None, None


class MeshPlan:
    """What one rank does to run the JAX package's global step on ``mesh``:
    which leaves are fsdp blocks (and along which dim), which axes split
    each leaf, and the process groups the loss and each gradient are
    summed over (``parallel.mesh``)."""

    def __init__(self, cfg: Config, mesh: Any) -> None:
        shape = self.shape = mesh_shape(mesh)
        self.cfg, self.mesh = cfg, mesh
        self.n_seq = transformer.sequence_shards(cfg.model, mesh)
        self.pipelined = _is_pipelined(cfg, mesh)
        self.baked = uses_baked_layout(cfg, mesh)
        shapes = self.full_shapes = transformer.param_shapes(cfg.model)
        tp = shape.get("tensor", 1)
        specs = param_pspec_tree(_meta(shapes), self.pipelined, tensor_size=tp)
        token_axes = ("data", "fsdp") + (("seq",) if self.n_seq > 1 else ()) + (("pipe",) if self.pipelined else ())
        # {leaf path: its spec}, {leaf path: the dim split over fsdp},
        # {leaf path: the axes that split it}, {leaf path: the group its
        # gradient is summed over}.
        self.specs: Dict[Tuple[str, ...], Any] = {}
        self.fsdp_dims: Dict[Tuple[str, ...], int] = {}
        self.split_axes: Dict[Tuple[str, ...], Tuple[str, ...]] = {}
        self.grad_groups: Dict[Tuple[str, ...], Any] = {}
        for path, spec in _spec_leaves(specs):
            self.specs[path] = spec
            axes = tuple(a for e in spec for a in _entry_axes(e) if shape.get(a, 1) > 1)
            if axes:
                self.split_axes[path] = axes
            if "fsdp" in axes:
                self.fsdp_dims[path] = next(d for d, e in enumerate(spec) if "fsdp" in _entry_axes(e))
            summed = tuple(a for a in token_axes if a not in axes)
            if tp > 1 and "tensor" not in axes and (
                    path[-1] in ("wkv", "bkv") or ("experts" in path and path[-1] == "b2")):
                summed += ("tensor",)  # partial on each tensor rank
            self.grad_groups[path] = axis_group(mesh, summed)
        self.fsdp = axis_group(mesh, ("fsdp",))
        self.tokens = axis_group(mesh, token_axes)  # the loss
        self.norm_groups = {axes: axis_group(mesh, axes) for axes in sorted(set(self.split_axes.values()))}
        # Each split leaf's dims for Adafactor (every split) and the dims
        # Muon gathers (the fsdp and tensor splits), their groups made
        # here, on every rank.
        self._splits = {path: _LeafSplit(dict(self._gather_dims(path, None)), self.norm_groups[axes])
                        for path, axes in self.split_axes.items()}
        self._muon_dims = {path: self._gather_dims(path, ("fsdp", "tensor")) for path in self.split_axes}

    def _gather_dims(self, path: Tuple[str, ...], keep: Optional[Tuple[str, ...]]) -> List[Tuple[int, AxisGroup]]:
        """(dim, group) of each dim of a leaf split over axes all in
        ``keep`` (None: any)."""
        out = []
        for d, e in enumerate(self.specs[path]):
            axes = tuple(a for a in _entry_axes(e) if self.shape.get(a, 1) > 1)
            if axes and (keep is None or all(a in keep for a in axes)):
                out.append((d, axis_group(self.mesh, axes)))
        return out

    def split(self, path: Tuple[str, ...]) -> opt.LeafSplit:
        """Adafactor's ``splits`` hook: how this rank's block of the leaf
        lies in the whole."""
        return self._splits.get(path) or opt.LeafSplit()

    def whole(self, path: Tuple[str, ...], t: torch.Tensor) -> Any:
        """Muon's ``whole`` hook: for a matrix cut over fsdp or tensor, (the
        leaf gathered from the ranks' blocks along those dims, full -> this
        rank's block); None for the rest."""
        todo = self._muon_dims.get(path)
        if not todo:
            return None
        full = t
        for d, grp in todo:
            full = _all_gather(full, d, grp.group, grp.size)
        return full, lambda u: _block(u, todo)

    def optimizer_update(self, grads: Any, state: Any, params: Any, lr: torch.Tensor, tcfg: Any) -> Any:
        return opt.optimizer_update(grads, state, params, lr, tcfg, splits=self.split, whole=self.whole)

    def active(self) -> Any:
        return activation_mesh(self.mesh)

    def check_state(self, state: TrainState) -> None:
        """Refuse a full (unsharded) state: a mesh step takes blocks."""
        for path in list(self.split_axes)[:1]:
            if tuple(_get(state["params"], path).shape) == tuple(_get(self.full_shapes, path)):
                raise ValueError(
                    f"params/{'/'.join(path)} is the full leaf; a mesh step takes "
                    "shard_train_state's blocks")

    def _gather_leaf(self, leaf: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherShard.apply(leaf, dim, self.fsdp.group, self.fsdp.size)

    def gather(self, leaves: Any) -> Any:
        """The differentiable parameters from ``_grad_leaves``' tree (its
        blocks entry a per-layer list): fsdp blocks gathered, tensor and
        expert blocks as they are."""
        out = {}
        for k, v in leaves.items():
            if k == "blocks":
                out[k] = [self._gather_tree(layer, ("blocks",), -1) for layer in v]
            else:
                out[k] = self._gather_tree(v, (k,), 0)
        return out

    def _gather_tree(self, tree: Any, path: Tuple[str, ...], shift: int) -> Any:
        if isinstance(tree, dict):
            return {k: self._gather_tree(v, path + (k,), shift) for k, v in tree.items()}
        dim = self.fsdp_dims.get(path)
        return tree if dim is None else self._gather_leaf(tree, dim + shift)

    def gather_full(self, params: Any) -> Any:
        """The parameters with fsdp blocks gathered (no gradient), for eval."""
        def walk(tree: Any, path: Tuple[str, ...]) -> Any:
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            dim = self.fsdp_dims.get(path)
            return tree if dim is None else _all_gather(tree, dim, self.fsdp.group, self.fsdp.size)

        return walk(params, ())

    def reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        if self.tokens.group is None:
            return loss
        return all_reduce(loss.detach().clone(), self.tokens.group)

    @torch.no_grad()
    def reduce_grads(self, grads: Any) -> Any:
        """Sum the partial gradients over each leaf's group."""
        for path, g in opt.tree_leaves(grads):
            grp = self.grad_groups[path]
            if grp.group is not None:
                all_reduce(g, grp.group)
        return grads

    @torch.no_grad()
    def global_norm(self, grads: Any) -> torch.Tensor:
        """sqrt of the sum of squares of the global gradient: a block's
        squares summed over the ranks of the axes that split its leaf,
        replicated leaves once."""
        device = opt.tree_leaves(grads)[0][1].device
        parts = {axes: torch.zeros((), dtype=torch.float32, device=device) for axes in self.norm_groups}
        rep = torch.zeros((), dtype=torch.float32, device=device)
        for path, g in opt.tree_leaves(grads):
            sq = g.float().square().sum()
            axes = self.split_axes.get(path)
            if axes is None:
                rep = rep + sq
            else:
                parts[axes] = parts[axes] + sq
        total = rep
        for axes, part in parts.items():
            grp = self.norm_groups[axes]
            total = total + (part if grp.group is None else all_reduce(part, grp.group))
        return torch.sqrt(total)


def _block(t: torch.Tensor, dims: List[Tuple[int, AxisGroup]]) -> torch.Tensor:
    """This rank's block (a view) of ``t`` along each (dim, group)."""
    idx = [slice(None)] * t.dim()
    for d, grp in dims:
        n = t.shape[d] // grp.size
        idx[d] = slice(grp.index * n, (grp.index + 1) * n)
    return t[tuple(idx)]


class _LeafSplit(opt.LeafSplit):
    """A split leaf's ``optimizer.LeafSplit`` on a mesh: {leaf dim: the
    group of the axes that split it}, and the group of all of them."""

    def __init__(self, dims: Dict[int, AxisGroup], every: AxisGroup) -> None:
        self.dims, self.every = dims, every

    def _along(self, dims: Sequence[int]) -> List[Tuple[int, AxisGroup]]:
        return [(i, self.dims[d]) for i, d in enumerate(dims) if d in self.dims]

    def sum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        grp = self.dims.get(dim)
        return t if grp is None else all_reduce(t, grp.group)

    def gather(self, t: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
        for i, grp in self._along(dims):
            t = _all_gather(t, i, grp.group, grp.size)
        return t

    def block(self, t: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
        return _block(t, self._along(dims))

    def total(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.every.group)

    def numel(self, block: torch.Tensor) -> int:
        return block.numel() * self.every.size


def _meta(shapes: Any) -> Any:
    return {k: _meta(v) if isinstance(v, dict) else torch.empty(v, device="meta") for k, v in shapes.items()}


def _spec_leaves(specs: Any, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    out: List[Tuple[Tuple[str, ...], Any]] = []
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            out += _spec_leaves(v, path + (k,))
        else:
            out.append((path + (k,), v))
    return out


def _get(tree: Any, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree
