"""The single-device train step: grads -> clip -> optimizer -> metrics.

Counterpart of ``pretraining_llm_tpu/training/train_step.py`` on one
device. The state is a plain dict {'params', 'opt', 'step'} (+ 'ema'), the
same tree as the JAX package's, so checkpoints of either package restore
in the other. PyTorch runs eagerly: ``loss.backward()`` takes the place of
``jax.value_and_grad`` and a Python loop over microbatches the place of the
``lax.scan``. Metrics stay tensors on the device (no host sync in a step).
Where JAX donates the state, the port updates it in place: the backward
adds into one gradient tree, the clip scales it, and the optimizer writes
the parameters and its state where they are (``training/optimizer.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from pretraining_llm_tpu_torch.config import Config
from pretraining_llm_tpu_torch.models import transformer
from pretraining_llm_tpu_torch.training import optimizer as opt
from pretraining_llm_tpu_torch.utils import debug
from pretraining_llm_tpu_torch.utils.device import DeviceLike, resolve_device

TrainState = Dict[str, Any]
Batch = Tuple[torch.Tensor, torch.Tensor]


def init_train_state(
    cfg: Config, generator: Union[torch.Generator, int, None] = None, *, device: DeviceLike = None,
) -> TrainState:
    """Fresh params (``transformer.init_params`` from ``generator``, by
    default ``cfg.train.seed``), the zero state of ``train.optimizer``, step
    0, and an fp32 EMA copy of the params when ``train.ema_decay`` > 0."""
    dev = resolve_device(device)
    seed = cfg.train.seed if generator is None else generator
    params = transformer.init_params(cfg.model, seed, device=dev)
    state: TrainState = {
        "params": params,
        "opt": opt.optimizer_init(params, cfg.train),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if cfg.train.ema_decay > 0:
        state["ema"] = opt.tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


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
                   grads: Optional[Any] = None) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of one microbatch. The backward adds into ``grads`` (a
    tree like ``params``; fresh zeros by default) in place. Under
    ``train.grad_dtype="bfloat16"`` each fp32 grad leaf is rounded to bf16
    once after the backward (a new tree)."""
    if grads is None:
        grads = opt.tree_map(torch.zeros_like, params)
    loss = transformer.loss_fn(_grad_leaves(params, grads), x, y, cfg.model)
    loss.backward()
    if cfg.train.grad_dtype == "bfloat16":
        grads = opt.tree_map(lambda g: g.to(torch.bfloat16) if g.dtype == torch.float32 else g, grads)
    return loss.detach(), grads


def compute_grads(state: TrainState, batch: Batch, cfg: Config) -> Tuple[torch.Tensor, Any]:
    """Mean loss and mean grads over ``train.microbatches`` slices of the
    batch. fp32 grads: every microbatch's backward adds into one tree, in
    microbatch order (the JAX package's zeros + g1 + g2 ..., bit for bit),
    then divides in place. bf16 grads: each microbatch's grads are rounded
    to bf16 and summed in a bf16 accumulator, as in the JAX package."""
    x, y = batch
    n_micro = cfg.train.microbatches
    if n_micro == 1:
        return loss_and_grads(state["params"], x, y, cfg)
    b = x.shape[0]
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
            loss, grads = loss_and_grads(state["params"], xm[i], ym[i], cfg)
            grad_sum = opt.tree_map(torch.add, grad_sum, grads)
        else:
            loss, grad_sum = loss_and_grads(state["params"], xm[i], ym[i], cfg, grad_sum)
        loss_sum = loss_sum + loss
    with torch.no_grad():
        for _, g in opt.tree_leaves(grad_sum):
            g.div_(n_micro)
    return loss_sum / n_micro, grad_sum


def train_step(state: TrainState, batch: Batch, cfg: Config) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step. Returns (new state, {'loss', 'grad_norm', 'lr'})."""
    tcfg = cfg.train
    loss, grads = compute_grads(state, batch, cfg)
    if debug.nan_checks_enabled():
        debug.check_finite(f"train step {int(state['step'])}",
                           [("loss", loss)] + [("grad " + "/".join(p), g) for p, g in opt.tree_leaves(grads)])
    with torch.no_grad():
        if tcfg.grad_clip > 0:
            grads, grad_norm = opt.clip_by_global_norm(grads, tcfg.grad_clip)
        else:
            grad_norm = opt.global_norm(grads)
        lr = opt.learning_rate(state["step"], tcfg)
        new_params, new_opt = opt.optimizer_update(grads, state["opt"], state["params"], lr, tcfg)
        new_state: TrainState = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        if "ema" in state:
            d = tcfg.ema_decay
            new_state["ema"] = opt.tree_map(
                lambda e, p: d * e + (1.0 - d) * p.float(), state["ema"], new_params
            )
    return new_state, {"loss": loss, "grad_norm": grad_norm, "lr": lr}


def build_train_step(cfg: Config) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, (x, y))``, x and y (B, T) int tensors on the state's
    device, B = ``train.batch_size``. The step updates ``state``'s tensors
    in place and returns them in a new dict."""
    return lambda state, batch: train_step(state, batch, cfg)


def build_eval_loop(cfg: Config) -> Callable[[TrainState, Batch], torch.Tensor]:
    """Mean eval loss (pure cross-entropy, ``include_aux=False``) over
    stacked batches (x, y), each (N, B, T)."""

    @torch.no_grad()
    def eval_many(state: TrainState, batches: Batch) -> torch.Tensor:
        xs, ys = batches
        total = torch.zeros((), dtype=torch.float32, device=xs.device)
        for x, y in zip(xs, ys):
            total = total + transformer.loss_fn(state["params"], x, y, cfg.model, include_aux=False)
        return total / xs.shape[0]

    return eval_many
