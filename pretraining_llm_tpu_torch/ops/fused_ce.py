"""Fused cross-entropy head: hidden @ W -> per-token loss, no logits.

Counterpart of ``pretraining_llm_tpu/ops/pallas_ce.py::fused_cross_entropy``.
``FusedCE`` is the custom VJP: its forward runs the forward kernel (loss and
lse, online over the vocabulary), its backward the dH and dW kernels, which
recompute each logits tile from (hidden, W). The residuals are (hidden, W,
labels, lse): O(S + D*V), no (S, V) logits. CUDA tensors go to the kernels
(``ops/cuda_ce.py``), CPU tensors to their plain versions; a failed build
or launch raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from pretraining_llm_tpu_torch.ops import cuda_ce


class FusedCE(torch.autograd.Function):
    """``apply(h (S, D), w (D, V), labels (S,) int32)`` -> per-token losses
    (S,) fp32. W is read through its (V, D) transpose, which is contiguous
    for the tied head (``embedding.T``); dW comes back (V, D) and is handed
    to autograd transposed. The cotangent g (S,) need not be uniform."""

    @staticmethod
    def forward(ctx, h, w, labels):
        loss, lse = cuda_ce.fused_ce_fwd(h, w.t().contiguous(), labels)
        ctx.save_for_backward(h, w, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        w_vd = w.t().contiguous()
        g = g.float().contiguous()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = cuda_ce.fused_ce_dh(h, w_vd, labels, lse, g)
        if ctx.needs_input_grad[1]:
            dw = cuda_ce.fused_ce_dw(h, w_vd, labels, lse, g).t()
        return dh, dw, None


def fused_cross_entropy(
    hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-token CE loss of a biasless LM head without materializing logits.

    hidden: (S, D); w: (D, V), both in the compute dtype; labels: (S,) int
    in [0, V). Returns (S,) fp32 losses (= lse - label logit). A ``bias``
    raises ``ValueError``: the kernels target the biasless (tied) head, and
    the model's head dispatcher sends a biased head to the chunked head.
    The JAX function's ``block_s``/``block_v`` are not taken: the plain
    versions walk the JAX default tiles, the kernels tile themselves."""
    if bias is not None:
        raise ValueError("fused CE kernel does not support an lm_head bias")
    return FusedCE.apply(hidden, w, labels.to(torch.int32).contiguous())
