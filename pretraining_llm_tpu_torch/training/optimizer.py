"""AdamW, gradient clipping and LR schedules over the port's nested-dict
parameter trees.

An own copy of the AdamW part of ``pretraining_llm_tpu/training/
optimizer.py``: decoupled weight decay on weight matrices and embeddings
only (selected by leaf name, never by rank), every update in fp32 with the
bias corrections as written there, and the three schedules. Trees are
walked in sorted-key order, the JAX package's flatten order, so sums over
leaves (the global norm) add in the same order. Functions return new trees
and run under ``torch.no_grad()``. Adafactor and Muon are not ported.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

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


def check_optimizer(cfg: TrainConfig) -> None:
    if cfg.optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer={cfg.optimizer!r} is not ported to PyTorch yet (AdamW only)"
        )


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
def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(
    grads: Tree, state: OptState, params: Tree, lr: torch.Tensor, cfg: TrainConfig,
) -> Tuple[Tree, OptState]:
    """One AdamW step. Returns (new_params, new_state). All math in fp32."""
    count = state["count"] + 1
    b1, b2, eps, wd = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps, cfg.weight_decay
    c = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)
    mask = decay_mask(params)
    new_p: Tree = {}
    new_mu: Tree = {}
    new_nu: Tree = {}

    def leaf_update(path, g, mu, nu, p, decay):
        g32 = g.float()
        mu_new = b1 * mu.float() + (1 - b1) * g32
        nu_new = b2 * nu.float() + (1 - b2) * g32.square()
        step = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
        if decay and wd > 0:
            step = step + wd * p.float()
        p_new = p.float() - lr * step
        for tree, val in ((new_p, p_new.to(p.dtype)), (new_mu, mu_new.to(mu.dtype)),
                          (new_nu, nu_new.to(nu.dtype))):
            for key in path[:-1]:
                tree = tree.setdefault(key, {})
            tree[path[-1]] = val

    leaves = zip(tree_leaves(grads), tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                 tree_leaves(params), tree_leaves(mask))
    for (path, g), (_, mu), (_, nu), (_, p), (_, d) in leaves:
        leaf_update(path, g, mu, nu, p, d)
    return new_p, {"mu": new_mu, "nu": new_nu, "count": count}


@torch.no_grad()
def learning_rate(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """The JAX package's schedules, in fp32: linear warmup over
    max(warmup_frac * train_steps, 1) steps, then constant, cosine to
    ``min_lr_frac * lr``, or warmup-stable-decay (linear over the final
    ``decay_frac`` of the run)."""
    f32 = dict(dtype=torch.float32, device=step.device)
    s = step.to(torch.float32)
    warmup = torch.tensor(max(cfg.warmup_frac * cfg.train_steps, 1.0), **f32)
    warm_lr = cfg.lr * (s + 1.0) / warmup
    if cfg.lr_schedule == "warmup_constant":
        return torch.minimum(warm_lr, torch.tensor(cfg.lr, **f32))
    min_lr = cfg.lr * cfg.min_lr_frac
    if cfg.lr_schedule == "warmup_stable_decay":
        decay_start = torch.maximum(torch.tensor(cfg.train_steps * (1.0 - cfg.decay_frac), **f32), warmup)
        frac = torch.clamp(
            (s - decay_start) / torch.clamp(cfg.train_steps - decay_start, min=1.0), 0.0, 1.0,
        )
        stable_or_decay = cfg.lr + (min_lr - cfg.lr) * frac
        return torch.where(s < warmup, warm_lr, stable_or_decay)
    progress = torch.clamp((s - warmup) / torch.clamp(cfg.train_steps - warmup, min=1.0), 0.0, 1.0)
    cos_lr = min_lr + 0.5 * (cfg.lr - min_lr) * (1.0 + torch.cos(math.pi * progress))
    return torch.where(s < warmup, warm_lr, cos_lr)
