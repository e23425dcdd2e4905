"""AdamW, Adafactor, Muon, gradient clipping and LR schedules over the
port's nested-dict parameter trees.

An own copy of ``pretraining_llm_tpu/training/optimizer.py``: decoupled
weight decay on weight matrices and embeddings only (selected by leaf name,
never by rank), every update in fp32 with the arithmetic and its order as
written there, the three optimizers with the JAX package's state trees
(AdamW ``mu``/``nu``; Adafactor ``v`` of ``{r, c}`` or ``{full}``; Muon ``s``
of ``{m}`` or ``{mu, nu}``; each with ``count``), and the three schedules.
Trees are walked in sorted-key order, the JAX package's flatten order, so
sums over leaves (the global norm) add in the same order.

JAX donates the train state, so XLA updates it in place. Here the updates
and the clip write into the existing parameter, state and gradient tensors
one leaf at a time (elementwise math in flat slices), run under
``torch.no_grad()``, and return the same trees: a step's peak holds no
second copy of the parameters or the moments.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch

from pretraining_llm_tpu_torch.config import TrainConfig

OptState = Dict[str, Any]
Tree = Dict[str, Any]

# Every weight-matrix leaf across all model variants (decayed).
_DECAY_LEAVES = frozenset(
    {"wqkv", "wq", "wkv", "wo", "w1", "w2", "kernel", "embedding", "router"}
)
# Norm parameters and biases (never decayed); several bias leaves are >= 2-D.
_NO_DECAY_LEAVES = frozenset(
    {"scale", "bias", "bqkv", "bq", "bkv", "bo", "b1", "b2"}
)


def tree_leaves(tree: Tree, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in sorted-key order (the JAX flatten order)."""
    out: List[Tuple[Tuple[str, ...], Any]] = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out += tree_leaves(val, path + (key,))
        else:
            out.append((path + (key,), val))
    return out


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over matching leaves of trees of one structure."""
    return {
        k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
        for k, v in tree.items()
    }


def decay_mask(params: Tree) -> Tree:
    """True for leaves that receive weight decay, keyed on the leaf name."""
    return {
        k: decay_mask(v) if isinstance(v, dict) else k in _DECAY_LEAVES
        for k, v in params.items()
    }


# Elementwise updates walk a leaf in flat slices of this many elements, so
# a step's temporaries stay at two slices whatever the leaf's size.
_SLICE = 1 << 24


def _slices(*leaves: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching flat slices of same-shaped contiguous leaves."""
    n = leaves[0].numel()
    flat = [t.view(-1) for t in leaves]
    for lo in range(0, n, _SLICE):
        yield tuple(t[lo:lo + _SLICE] for t in flat)


def _apply(p: torch.Tensor, u: torch.Tensor, lr: torch.Tensor, decay: bool, wd: float,
           tmp: torch.Tensor) -> None:
    """p <- p - lr * (u + wd * p) (the decay term on decayed leaves only),
    in place, as the JAX package rounds it: u is overwritten."""
    if decay and wd > 0:
        torch.mul(p, wd, out=tmp)
        u.add_(tmp)
    u.mul_(lr)
    p.sub_(u)


def adamw_init(params: Tree) -> OptState:
    zeros = lambda p: torch.zeros_like(p)  # noqa: E731
    device = tree_leaves(params)[0][1].device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def global_norm(tree: Tree) -> torch.Tensor:
    total = None
    for _, g in tree_leaves(tree):
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float,
                        norm_fn: Callable[[Tree], torch.Tensor] = global_norm) -> Tuple[Tree, torch.Tensor]:
    """Scales every leaf of ``grads`` in place by min(1, max_norm / (norm +
    1e-9)); returns (grads, norm). ``norm_fn`` computes the norm (under a
    mesh, the train step's, which counts every shard of a sharded leaf
    once)."""
    norm = norm_fn(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for _, g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _bias_corrections(count: torch.Tensor, cfg: TrainConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    c = count.float()
    bc1 = 1.0 - torch.pow(torch.full((), cfg.adam_b1, dtype=torch.float32, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.full((), cfg.adam_b2, dtype=torch.float32, device=c.device), c)
    return bc1, bc2


def _adam_leaf(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, p: torch.Tensor, bc1: torch.Tensor,
               bc2: torch.Tensor, lr: torch.Tensor, decay: bool, cfg: TrainConfig) -> None:
    """One leaf's AdamW step in place, slice by slice, in the JAX package's
    fp32 arithmetic and order: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 -
    b2) g^2, u = (mu / bc1) / (sqrt(nu / bc2) + eps) (+ wd p), p -= lr u."""
    b1, b2, eps = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps
    if not all(t.dtype == torch.float32 and t.is_contiguous() for t in (g, mu, nu, p)):
        # Other storage dtypes: the same math on fp32 copies, written back.
        g32, m32, n32, p32 = (t.float().contiguous().clone() for t in (g, mu, nu, p))
        _adam_leaf(g32, m32, n32, p32, bc1, bc2, lr, decay, cfg)
        for dst, src in ((mu, m32), (nu, n32), (p, p32)):
            dst.copy_(src)
        return
    for gs, ms, ns, ps in _slices(g, mu, nu, p):
        tmp = gs * (1 - b1)
        ms.mul_(b1).add_(tmp)
        torch.square(gs, out=tmp)
        ns.mul_(b2).add_(tmp.mul_(1 - b2))
        torch.div(ns, bc2, out=tmp)
        tmp.sqrt_().add_(eps)
        u = ms / bc1
        u.div_(tmp)
        _apply(ps, u, lr, decay, cfg.weight_decay, tmp)


@torch.no_grad()
def adamw_update(
    grads: Tree, state: OptState, params: Tree, lr: torch.Tensor, cfg: TrainConfig,
) -> Tuple[Tree, OptState]:
    """One AdamW step, in place: the parameter, mu and nu tensors are
    updated where they are, one leaf (and slice) at a time, so the step
    holds no second copy of them. Returns (params, state); all math in
    fp32, in the JAX package's order."""
    count = state["count"] + 1
    bc1, bc2 = _bias_corrections(count, cfg)
    leaves = zip(tree_leaves(grads), tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                 tree_leaves(params), tree_leaves(decay_mask(params)))
    for (_, g), (_, mu), (_, nu), (_, p), (_, decay) in leaves:
        _adam_leaf(g, mu, nu, p, bc1, bc2, lr, decay, cfg)
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count}


# ---------------------------------------------------------------------------
# Adafactor (the JAX package's variant: beta1 = 0, beta2 = 1 - t^-0.8, update
# RMS clipped at 1, decoupled weight decay, the trainer's lr schedule)
# ---------------------------------------------------------------------------
#
# Factored second moments by leaf position and rank (the stacked-layer axis
# of a blocks leaf is a batch axis):
#   - ndim >= 3           -> factored over the last two axes (r: shape[:-1],
#                            c: shape[:-2] + (cols,))
#   - ndim == 2 top-level -> factored (embeddings, lm_head)
#   - ndim == 2 in blocks -> full v (stacked norm scales and biases)
#   - ndim <= 1           -> full v
_ADAFACTOR_EPS1 = 1e-30  # inside the second moment: g^2 + eps1
_ADAFACTOR_CLIP = 1.0  # update-RMS clipping threshold


def _adafactor_factored(path: Tuple[str, ...], leaf: torch.Tensor) -> bool:
    return leaf.ndim >= 3 or (leaf.ndim == 2 and path[0] != "blocks")


def _tree_map_path(fn: Callable[..., Any], tree: Tree, *rest: Tree, path: Tuple[str, ...] = ()) -> Tree:
    return {
        k: _tree_map_path(fn, v, *(r[k] for r in rest), path=path + (k,)) if isinstance(v, dict)
        else fn(path + (k,), v, *(r[k] for r in rest))
        for k, v in tree.items()
    }


def _zeros(shape: Tuple[int, ...], like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def adafactor_init(params: Tree) -> OptState:
    def init_leaf(path: Tuple[str, ...], p: torch.Tensor) -> Dict[str, torch.Tensor]:
        if _adafactor_factored(path, p):
            return {"r": _zeros(p.shape[:-1], p), "c": _zeros(p.shape[:-2] + p.shape[-1:], p)}
        return {"full": _zeros(p.shape, p)}

    device = tree_leaves(params)[0][1].device
    return {"v": _tree_map_path(init_leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


# A mesh step's ``whole`` hook (Muon): (path, a rank's block of a leaf) ->
# None when the rank holds the leaf whole, else (the whole leaf gathered
# from the ranks' blocks, whole -> this rank's block).
Whole = Callable[[Tuple[str, ...], torch.Tensor], Any]


def _no_whole(path: Tuple[str, ...], t: torch.Tensor) -> None:
    return None


class LeafSplit:
    """How a rank's block of one leaf lies in the whole leaf, for
    Adafactor's statistics on a mesh (``train_step.MeshPlan`` makes it).
    ``dims`` names, for each dim of a tensor, the leaf dim it stands for.
    The default is a leaf the rank holds whole: every method is the
    identity."""

    def sum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t``, a sum over the rank's part of leaf dim ``dim``, summed
        over the ranks that split that dim."""
        return t

    def gather(self, t: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
        """The whole tensor from the ranks' blocks ``t``."""
        return t

    def block(self, t: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
        """This rank's block (a view) of the whole tensor ``t``."""
        return t

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over every rank that holds a block of the leaf."""
        return t

    def numel(self, block: torch.Tensor) -> int:
        """The whole leaf's element count, from the rank's block."""
        return block.numel()


# (path) -> the leaf's ``LeafSplit``.
Splits = Callable[[Tuple[str, ...]], LeafSplit]


def _whole_leaves(path: Tuple[str, ...]) -> LeafSplit:
    return LeafSplit()


@torch.no_grad()
def adafactor_update(
    grads: Tree, state: OptState, params: Tree, lr: torch.Tensor, cfg: TrainConfig,
    splits: Splits = _whole_leaves,
) -> Tuple[Tree, OptState]:
    """One Adafactor step, in place on the parameters and the second-moment
    statistics: v = b2t v + (1 - b2t)(g^2 + eps1) (factored: its row and
    column sums), u = g / sqrt(v_hat) with v_hat = (r / sum r) c floored at
    1e-37, u /= max(1, rms(u) / 1), p -= lr (u + wd p). All fp32. On a mesh
    (``splits``) the statistics are the whole leaf's, replicated as JAX's
    spec has them, while the rank holds a block of the gradient: r and c
    are the block's sums, summed over the ranks that split the summed dim,
    each rank updates its block of the statistics and gathers the rest
    (O(rows + cols) traffic), and rms(u) sums the squares over every rank
    of the leaf, the stacked-layer dim included."""
    count = state["count"] + 1
    b2t = 1.0 - count.float() ** -0.8
    wd = cfg.weight_decay

    def update_stat(split: LeafSplit, stat: torch.Tensor, part: torch.Tensor, dims: Sequence[int]) -> None:
        mine = split.block(stat, dims)
        mine.mul_(b2t).add_(part.mul_(1.0 - b2t))
        whole = split.gather(mine, dims)
        if whole is not mine:
            stat.copy_(whole)

    def leaf_update(path: Tuple[str, ...], g: torch.Tensor, v: Dict[str, torch.Tensor], p: torch.Tensor,
                    decay: bool) -> None:
        split = splits(path)
        g32 = g.float()
        nd = g32.dim()
        g2 = torch.square(g32).add_(_ADAFACTOR_EPS1)
        if "full" in v:
            update_stat(split, v["full"], g2, range(nd))
            u = torch.rsqrt(split.block(v["full"], range(nd))).mul_(g32)
        else:
            r_dims, c_dims = range(nd - 1), [*range(nd - 2), nd - 1]
            update_stat(split, v["r"], split.sum(g2.sum(-1), nd - 1), r_dims)
            update_stat(split, v["c"], split.sum(g2.sum(-2), nd - 2), c_dims)
            # Normalize r before the outer product: r and c are O(eps1) for
            # zero-gradient slices, and eps1^2 underflows fp32.
            r_hat = split.block(v["r"] / v["r"].sum(-1, keepdim=True), r_dims)
            u = torch.mul(r_hat[..., :, None], split.block(v["c"], c_dims)[..., None, :], out=g2)
            u.clamp_min_(1e-37).rsqrt_().mul_(g32)
        rms_u = torch.sqrt(split.total(torch.square(u).sum()) / split.numel(u))
        u.div_(torch.clamp(rms_u / _ADAFACTOR_CLIP, min=1.0))
        p32 = p if p.dtype == torch.float32 else p.float()
        _apply(p32, u, lr, decay, wd, torch.empty_like(u) if decay and wd > 0 else u)
        if p32 is not p:
            p.copy_(p32)

    _tree_map_path(leaf_update, grads, state["v"], params, decay_mask(params))
    return params, {"v": state["v"], "count": count}


# ---------------------------------------------------------------------------
# Muon (nesterov momentum -> Newton-Schulz orthogonalization -> RMS match)
# for hidden weight matrices; AdamW for every other leaf
# ---------------------------------------------------------------------------
#
# A blocks leaf (L, ...) is a batch of L per-layer matrices: wqkv (L, D, 3,
# H, Dh) maps D -> 3*H*Dh (rows = axis 1, cols = the rest); wo (L, H, Dh, D)
# maps H*Dh -> D (cols = the last axis, rows = the middle). The update is
# scaled by 0.2 * sqrt(max(rows, cols)) to match AdamW's update RMS, so the
# lr and weight decay are AdamW's.
#
# Precision: Newton-Schulz runs in fp32 torch.matmul, as the JAX package
# computes it in plain XLA. On the card that is full fp32 while
# torch.backends.cuda.matmul.allow_tf32 is False (PyTorch's default; the
# caller may turn TF32 on for the whole process, and then these products
# run on TF32 too).
_MUON_LEAVES = frozenset({"wqkv", "wq", "wkv", "wo", "w1", "w2", "router"})
_NS_COEFFS = (3.4445, -4.7750, 2.0315)  # quintic Newton-Schulz (Jordan 2024)
_NS_STEPS = 5
_MUON_RMS_MATCH = 0.2


def _muon_leaf(path: Tuple[str, ...], leaf: Any) -> bool:
    return path[-1] in _MUON_LEAVES and len(leaf.shape) >= 2


def _matrix_view(path: Tuple[str, ...], leaf_shape: Tuple[int, ...]) -> Tuple[int, int, int]:
    """(batch, rows, cols) of the leaf's 2-D matrix view: the leading batch
    axes are the stacked-layer axis (plus the expert axis under an
    "experts" path); wo contracts everything before its last axis, every
    other name maps its first post-batch axis to the rest."""
    shape = tuple(leaf_shape)
    n_batch = min(1 + ("experts" in path), len(shape) - 2)
    b = math.prod(shape[:n_batch])
    if path[-1] == "wo":
        return b, math.prod(shape[n_batch:-1]), shape[-1]
    return b, shape[n_batch], math.prod(shape[n_batch + 1:])


def newton_schulz_orthogonalize(m: torch.Tensor, steps: int = _NS_STEPS) -> torch.Tensor:
    """Batched (B, r, c) quintic Newton-Schulz iteration toward the nearest
    semi-orthogonal matrix, in the smaller dimension, fp32."""
    a, b, c = _NS_COEFFS
    transpose = m.shape[-2] > m.shape[-1]
    x = m.transpose(-1, -2) if transpose else m
    x = x / (torch.linalg.matrix_norm(x, keepdim=True) + 1e-7)
    for _ in range(steps):
        xxt = x @ x.transpose(-1, -2)
        y = b * xxt + c * (xxt @ xxt)
        x = a * x + y @ x
    return x.transpose(-1, -2) if transpose else x


def muon_init(params: Tree) -> OptState:
    def init_leaf(path: Tuple[str, ...], p: torch.Tensor) -> Dict[str, torch.Tensor]:
        if _muon_leaf(path, p):
            return {"m": _zeros(p.shape, p)}
        return {"mu": _zeros(p.shape, p), "nu": _zeros(p.shape, p)}

    device = tree_leaves(params)[0][1].device
    return {"s": _tree_map_path(init_leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def muon_update(
    grads: Tree, state: OptState, params: Tree, lr: torch.Tensor, cfg: TrainConfig, whole: Whole = _no_whole,
) -> Tuple[Tree, OptState]:
    """One Muon step, in place: hidden matrices take m = mu m + g, u =
    NS(g + mu m) * 0.2 sqrt(max(rows, cols)); every other leaf AdamW's
    math; then p -= lr (u + wd p) on decayed leaves. All fp32. On a mesh
    (``whole``) a matrix cut over ranks is gathered after the momentum
    (each rank's momentum is its block), orthogonalized whole and the
    rank's block of the update kept."""
    count = state["count"] + 1
    bc1, bc2 = _bias_corrections(count, cfg)
    mu_m = cfg.muon_momentum

    def leaf_update(path: Tuple[str, ...], g: torch.Tensor, s: Dict[str, torch.Tensor], p: torch.Tensor,
                    decay: bool) -> None:
        if "m" not in s:
            _adam_leaf(g, s["mu"], s["nu"], p, bc1, bc2, lr, decay, cfg)
            return
        g32 = g.float()
        s["m"].mul_(mu_m).add_(g32)
        u_in = torch.add(g32, s["m"] * mu_m)  # nesterov
        split = whole(path, u_in)
        full = u_in if split is None else split[0]
        bsz, rows, cols = _matrix_view(path, full.shape)
        u = newton_schulz_orthogonalize(full.reshape(bsz, rows, cols))
        u = u.mul_(_MUON_RMS_MATCH * float(max(rows, cols)) ** 0.5).reshape(full.shape)
        if split is not None:
            u = split[1](u).contiguous()
        p32 = p if p.dtype == torch.float32 else p.float()
        _apply(p32, u, lr, decay, cfg.weight_decay, u_in.view(p.shape))
        if p32 is not p:
            p.copy_(p32)

    _tree_map_path(leaf_update, grads, state["s"], params, decay_mask(params))
    return params, {"s": state["s"], "count": count}


def optimizer_init(params: Tree, cfg: TrainConfig) -> OptState:
    """The state of ``cfg.optimizer`` ('adamw' | 'adafactor' | 'muon')."""
    if cfg.optimizer == "adafactor":
        return adafactor_init(params)
    if cfg.optimizer == "muon":
        return muon_init(params)
    return adamw_init(params)


def optimizer_update(
    grads: Tree, state: OptState, params: Tree, lr: torch.Tensor, cfg: TrainConfig,
    splits: Splits = _whole_leaves, whole: Whole = _no_whole,
) -> Tuple[Tree, OptState]:
    """One in-place step of ``cfg.optimizer``; returns (params, state).
    ``splits`` (Adafactor) and ``whole`` (Muon) are a mesh step's hooks for
    the optimizers that look across a leaf; AdamW is elementwise."""
    if cfg.optimizer == "adafactor":
        return adafactor_update(grads, state, params, lr, cfg, splits)
    if cfg.optimizer == "muon":
        return muon_update(grads, state, params, lr, cfg, whole)
    return adamw_update(grads, state, params, lr, cfg)


@torch.no_grad()
def learning_rate(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """The JAX package's schedules, in fp32: linear warmup over
    max(warmup_frac * train_steps, 1) steps, then constant, cosine to
    ``min_lr_frac * lr``, or warmup-stable-decay (linear over the final
    ``decay_frac`` of the run). Constants are filled on the step's device
    (``torch.full``), not copied from the host: no sync in a step."""
    f32 = dict(dtype=torch.float32, device=step.device)
    s = step.to(torch.float32)
    warmup = torch.full((), max(cfg.warmup_frac * cfg.train_steps, 1.0), **f32)
    warm_lr = cfg.lr * (s + 1.0) / warmup
    if cfg.lr_schedule == "warmup_constant":
        return torch.minimum(warm_lr, torch.full((), cfg.lr, **f32))
    min_lr = cfg.lr * cfg.min_lr_frac
    if cfg.lr_schedule == "warmup_stable_decay":
        decay_start = torch.maximum(torch.full((), cfg.train_steps * (1.0 - cfg.decay_frac), **f32), warmup)
        frac = torch.clamp(
            (s - decay_start) / torch.clamp(cfg.train_steps - decay_start, min=1.0), 0.0, 1.0,
        )
        stable_or_decay = cfg.lr + (min_lr - cfg.lr) * frac
        return torch.where(s < warmup, warm_lr, stable_or_decay)
    progress = torch.clamp((s - warmup) / torch.clamp(cfg.train_steps - warmup, min=1.0), 0.0, 1.0)
    cos_lr = min_lr + 0.5 * (cfg.lr - min_lr) * (1.0 + torch.cos(math.pi * progress))
    return torch.where(s < warmup, warm_lr, cos_lr)
