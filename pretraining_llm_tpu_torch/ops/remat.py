"""Rematerialization policies: one name -> per-layer checkpoint wrapper.

Counterpart of ``pretraining_llm_tpu/ops/remat.py``: the same seven
``ModelConfig.remat`` names, each wrapping one layer's body (attention block
and MLP block) in ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``,
so the backward recomputes what the policy does not keep:

  - "none":          no checkpointing (autograd keeps everything it needs);
  - "full":          keep only the layer's input; the backward reruns the
                     whole layer, K1 included;
  - "dots_saveable": keep every matrix product's output (``aten.mm``,
                     ``addmm``, ``bmm``, ... through
                     ``create_selective_checkpoint_contexts``) and recompute
                     the rest. The flash forward is no ATen product, so K1
                     reruns, as the Pallas forward does under JAX's policy;
  - "save_attn":     keep the attention output ("attn_out"); K1 reruns for
                     its logsumexp, as in JAX;
  - "save_attn_res": keep the flash forward's residuals ("attn_o_res",
                     "attn_lse"): the attention backward starts from the
                     kept (o, lse) and K1 does not rerun; the QKV
                     projection does;
  - "save_qkv_attn": also keep the QKV projection ("qkv"): neither the
                     projection nor K1 reruns;
  - "save_big":      save_qkv_attn + the MLP hidden ("mlp_hidden").

How the named tags are kept. JAX tags a value and XLA drops the recompute
of everything only a kept value needs. Eager PyTorch reruns the layer's code
in the backward, so a kept value must be produced there without its
kernel, while autograd still records the op that makes it:
  - the model marks a tagged op with ``site(name)``; a selective checkpoint
    policy keeps that op's output (``MUST_SAVE``) and the recompute hands the
    kept output back instead of running it. "qkv" marks the QKV
    projection's products (the RoPE rotation and the bias add, elementwise,
    rerun), "mlp_hidden" the activation's last op;
  - the flash forward is one ctypes launch inside an ``autograd.Function``,
    invisible to a dispatch-level policy, so the layer's ``_Region`` keeps
    its (o, lse) in the first run and ``FlashAttention.forward`` takes them
    back in the recompute (``kept_attention``) instead of launching K1.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

# Tag names of the model's sites and the flash residuals, per policy (the
# JAX package's lists).
_SAVE_ATTN = ("attn_out",)
_SAVE_ATTN_RES = ("attn_o_res", "attn_lse")
_SAVE_QKV_ATTN = ("qkv",) + _SAVE_ATTN_RES
_SAVE_BIG = _SAVE_QKV_ATTN + ("mlp_hidden",)
_NAMED = {"save_attn": _SAVE_ATTN, "save_attn_res": _SAVE_ATTN_RES,
          "save_qkv_attn": _SAVE_QKV_ATTN, "save_big": _SAVE_BIG}

POLICIES = ("none", "full", "dots_saveable", "save_attn", "save_attn_res",
            "save_qkv_attn", "save_big")

_aten = torch.ops.aten
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default,
                   _aten.matmul.default, _aten.linear.default})

# Per thread (a CUDA backward, and so a recompute, runs on autograd's device
# thread): the tag of the ops being dispatched, set by ``site``, and the
# checkpointed layers being run, innermost last.
_local = threading.local()


def _regions() -> List["_Region"]:
    if not hasattr(_local, "regions"):
        _local.regions = []
    return _local.regions


@contextlib.contextmanager
def site(name: str) -> Iterator[None]:
    """Mark the ops run inside as the tagged value ``name`` (the JAX
    ``checkpoint_name`` sites): a named policy that lists it keeps their
    outputs for the backward."""
    outer = getattr(_local, "site", None)
    _local.site = name
    try:
        yield
    finally:
        _local.site = outer


def _dots_policy(ctx: Any, func: Any, *args: Any, **kwargs: Any) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if func in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _named_policy(names: Tuple[str, ...], ctx: Any, func: Any, *args: Any, **kwargs: Any) -> CheckpointPolicy:
    tag = getattr(_local, "site", None)
    if tag in names and (tag != "qkv" or func in _DOTS):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _Region:
    """One checkpointed layer call: the first run keeps the flash forward's
    residuals its policy names, the recompute takes them back."""

    def __init__(self, names: Tuple[str, ...]) -> None:
        self.names = names
        self.replay = False
        self.kept: List[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]] = []


def unrecorded() -> contextlib.AbstractContextManager:
    """Inside a named policy's layer: hide the ops run inside from its
    selective checkpoint. Its dispatch modes match each kept value to its
    op by the op's count in the layer, so ops that run in the first run but
    not in the recompute (K1's wrapper when the layer keeps (o, lse)) would
    hand later ops another op's value. Elsewhere a no-op."""
    return _disable_current_modes() if _regions() else contextlib.nullcontext()


def kept_attention() -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(o, lse) that the innermost checkpointed layer kept for this flash
    call in its first run, each None where its policy does not keep it (no
    layer, no named policy, or the first run)."""
    regions = _regions()
    if not regions or not regions[-1].replay or not regions[-1].kept:
        return None, None
    return regions[-1].kept.pop(0)


def keep_attention(o: torch.Tensor, lse: torch.Tensor) -> None:
    """Record a flash forward's (o, lse) in the first run of a checkpointed
    layer: o under "attn_out" or "attn_o_res", lse under "attn_lse"."""
    regions = _regions()
    if not regions or regions[-1].replay:
        return
    names = regions[-1].names
    keep_o = "attn_out" in names or "attn_o_res" in names
    regions[-1].kept.append((o.detach() if keep_o else None, lse.detach() if "attn_lse" in names else None))


def checkpoint_wrap(fn: Callable[..., torch.Tensor], remat: str) -> Callable[..., torch.Tensor]:
    """Wrap a per-layer body with the checkpoint policy named by ``remat``."""
    if remat == "none":
        return fn
    if remat not in POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}")
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "full":
        return functools.partial(checkpoint, fn, **kw)
    if remat == "dots_saveable":
        ctx = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return functools.partial(checkpoint, fn, context_fn=ctx, **kw)
    names = _NAMED[remat]
    ctx = functools.partial(create_selective_checkpoint_contexts, functools.partial(_named_policy, names))

    def wrapped(*args: Any) -> torch.Tensor:
        region = _Region(names)

        def run(*a: Any) -> torch.Tensor:
            _regions().append(region)
            try:
                return fn(*a)
            finally:
                _regions().pop()
                region.replay = True

        return checkpoint(run, *args, context_fn=ctx, **kw)

    return wrapped
