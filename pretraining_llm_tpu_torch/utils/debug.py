"""Numerics debugging: the counterpart of ``pretraining_llm_tpu/utils/debug.py``.

  - ``enable_nan_checks()`` turns on the check that the train step makes
    when ``train.debug_nans`` is set (``training/train_step.py``): the step
    raises ``FloatingPointError`` at the first non-finite loss or gradient,
    before the optimizer touches the parameters. JAX's ``jax_debug_nans``
    raises ``FloatingPointError`` too, but at the first primitive that
    produces a NaN, found by re-running the compiled step op by op; here the
    check reads the step's loss and gradients once (one host sync a step)
    and names the first non-finite one, not the op that made it.
  - ``checked_loss`` runs the loss with the JAX function's three checks: a
    negative token id, a token id at or past the vocabulary, a non-finite
    loss. It returns (error, loss) as the checkified JAX function does;
    ``error.get()`` is the failed check's message or None, ``error.throw()``
    raises it.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.models import transformer

_nan_checks = {"nans": False, "infs": False}


def enable_nan_checks(nans: bool = True, infs: bool = False) -> None:
    """Make every later train step raise ``FloatingPointError`` at a NaN
    (``nans``) or an infinity (``infs``) in its loss or gradients."""
    _nan_checks.update(nans=nans, infs=infs)


def nan_checks_enabled() -> bool:
    return _nan_checks["nans"] or _nan_checks["infs"]


def check_finite(what: str, tensors: Any) -> None:
    """Raise ``FloatingPointError`` naming the first of ``tensors`` ((name,
    tensor) pairs) holding a value the enabled checks refuse (one host sync
    for all of them)."""
    names, flags = [], []
    for name, t in tensors:
        bad = torch.isnan(t).any() if _nan_checks["nans"] else torch.zeros((), dtype=torch.bool, device=t.device)
        if _nan_checks["infs"]:
            bad = bad | torch.isinf(t).any()
        names.append(name)
        flags.append(bad)
    flags_t = torch.stack(flags)
    if bool(flags_t.any()):
        raise FloatingPointError(f"{what}: non-finite values in {names[int(flags_t.nonzero()[0, 0])]}")


class CheckError:
    """The outcome of ``checked_loss``'s checks (``checkify.Error``'s
    ``get``/``throw``)."""

    def __init__(self, message: Optional[str]) -> None:
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise RuntimeError(self.message)


def checked_loss(
    params: Any, tokens: torch.Tensor, targets: torch.Tensor, cfg: ModelConfig,
) -> Tuple[CheckError, torch.Tensor]:
    """(error, loss): the loss of ``transformer.loss_fn`` and the first
    failed check among a negative token id, a token id out of range for the
    vocabulary and a non-finite loss (the loss is NaN when an id fails:
    embedding rows out of range are not read)."""
    if bool((tokens < 0).any()):
        return CheckError("negative token id"), torch.tensor(float("nan"))
    if bool((tokens >= cfg.vocab_size).any()):
        return CheckError(f"token id out of range for vocab {cfg.vocab_size}"), torch.tensor(float("nan"))
    loss = transformer.loss_fn(params, tokens, targets, cfg)
    if not bool(torch.isfinite(loss)):
        return CheckError("non-finite loss"), loss
    return CheckError(None), loss
