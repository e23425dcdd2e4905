"""The single-device train step: grads -> clip -> AdamW -> metrics.

Counterpart of ``pretraining_llm_tpu/training/train_step.py`` on one
device. The state is a plain dict {'params', 'opt', 'step'} (+ 'ema'), the
same tree as the JAX package's, so checkpoints of either package restore
in the other. PyTorch runs eagerly: ``loss.backward()`` takes the place of
``jax.value_and_grad`` and a Python loop over microbatches the place of the
``lax.scan``. Metrics stay tensors on the device (no host sync in a step).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple, Union

import torch

from pretraining_llm_tpu_torch.config import Config
from pretraining_llm_tpu_torch.models import transformer
from pretraining_llm_tpu_torch.training import optimizer as opt
from pretraining_llm_tpu_torch.utils.device import DeviceLike, resolve_device

TrainState = Dict[str, Any]
Batch = Tuple[torch.Tensor, torch.Tensor]


def init_train_state(
    cfg: Config, generator: Union[torch.Generator, int, None] = None, *, device: DeviceLike = None,
) -> TrainState:
    """Fresh params (``transformer.init_params`` from ``generator``, by
    default ``cfg.train.seed``), zero AdamW moments, step 0, and an fp32
    EMA copy of the params when ``train.ema_decay`` > 0."""
    opt.check_optimizer(cfg.train)
    dev = resolve_device(device)
    seed = cfg.train.seed if generator is None else generator
    params = transformer.init_params(cfg.model, seed, device=dev)
    state: TrainState = {
        "params": params,
        "opt": opt.adamw_init(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if cfg.train.ema_decay > 0:
        state["ema"] = opt.tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def loss_and_grads(params: Any, x: torch.Tensor, y: torch.Tensor, cfg: Config) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of one microbatch. Each fp32 grad leaf is rounded to
    bf16 once after the backward under ``train.grad_dtype="bfloat16"``."""
    leaves = opt.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = transformer.loss_fn(leaves, x, y, cfg.model)
    loss.backward()
    bf16 = cfg.train.grad_dtype == "bfloat16"

    def grad_of(p: torch.Tensor) -> torch.Tensor:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        return g.to(torch.bfloat16) if bf16 and g.dtype == torch.float32 else g

    return loss.detach(), opt.tree_map(grad_of, leaves)


def compute_grads(state: TrainState, batch: Batch, cfg: Config) -> Tuple[torch.Tensor, Any]:
    """Mean loss and mean grads over ``train.microbatches`` slices of the
    batch; the accumulator has the grad storage dtype (bf16 under
    ``grad_dtype="bfloat16"``, as in the JAX package)."""
    x, y = batch
    n_micro = cfg.train.microbatches
    if n_micro == 1:
        return loss_and_grads(state["params"], x, y, cfg)
    b = x.shape[0]
    xm = x.reshape(n_micro, b // n_micro, -1)
    ym = y.reshape(n_micro, b // n_micro, -1)
    gdt = torch.bfloat16 if cfg.train.grad_dtype == "bfloat16" else None
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    grad_sum = opt.tree_map(
        lambda p: torch.zeros_like(p, dtype=gdt if (gdt and p.dtype == torch.float32) else p.dtype),
        state["params"],
    )
    for i in range(n_micro):
        loss, grads = loss_and_grads(state["params"], xm[i], ym[i], cfg)
        loss_sum = loss_sum + loss
        grad_sum = opt.tree_map(torch.add, grad_sum, grads)
    return loss_sum / n_micro, opt.tree_map(lambda g: g / n_micro, grad_sum)


def train_step(state: TrainState, batch: Batch, cfg: Config) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step. Returns (new state, {'loss', 'grad_norm', 'lr'})."""
    tcfg = cfg.train
    loss, grads = compute_grads(state, batch, cfg)
    with torch.no_grad():
        if tcfg.grad_clip > 0:
            grads, grad_norm = opt.clip_by_global_norm(grads, tcfg.grad_clip)
        else:
            grad_norm = opt.global_norm(grads)
        lr = opt.learning_rate(state["step"], tcfg)
        new_params, new_opt = opt.adamw_update(grads, state["opt"], state["params"], lr, tcfg)
        new_state: TrainState = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        if "ema" in state:
            d = tcfg.ema_decay
            new_state["ema"] = opt.tree_map(
                lambda e, p: d * e + (1.0 - d) * p.float(), state["ema"], new_params
            )
    return new_state, {"loss": loss, "grad_norm": grad_norm, "lr": lr}


def build_train_step(cfg: Config) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, (x, y))``, x and y (B, T) int tensors on the state's
    device, B = ``train.batch_size``."""
    opt.check_optimizer(cfg.train)
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
