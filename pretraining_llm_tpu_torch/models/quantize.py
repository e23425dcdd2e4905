"""Post-load int8 weight quantization for serving.

Counterpart of ``pretraining_llm_tpu/models/quantize.py``, the pass behind
``ServingEngine(quantize=...)``:

  - per-channel symmetric int8 over the matmul projections of every block
    (attention wqkv/wq/wkv/wo, MLP w1/w2), reducing over the contracted
    (input) axes of each product so every output channel keeps its own
    fp32 scale;
  - each quantized weight becomes an int8 leaf plus a sibling
    ``{name}_scale`` fp32 leaf in the same subtree, with the leading
    (n_layers,) dim, in the JAX package's names and layouts;
  - embeddings, lm_head, norms and biases keep their dtype; MoE models are
    refused.

Dequantization happens at the use site (``transformer._weight``):
``w_int8.float() * scale``, then one cast to the compute dtype.
Scheme: ``scale = max(|w|, eps) / 127`` over the reduce axes,
``q = clip(round(w / scale), -127, 127)``; ``torch.round`` rounds half to
even, as ``jnp.round`` does, so the codes are the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

# Contracted (input) axes per quantized projection, for stacked block
# leaves (leading n_layers axis at 0):
#   wqkv (L, d, 3, h, dh) -> scale (L, 1, 3, h, dh)
#   wq   (L, d, h, dh)    -> scale (L, 1, h, dh)
#   wkv  (L, d, 2, g, dh) -> scale (L, 1, 2, g, dh)
#   wo   (L, h, dh, d)    -> scale (L, 1, 1, d)
#   w1   (L, d, [2,] f)   -> scale (L, 1, [2,] f)
#   w2   (L, f, d)        -> scale (L, 1, d)
REDUCE_AXES: Dict[str, Tuple[int, ...]] = {
    "wqkv": (1,),
    "wq": (1,),
    "wkv": (1,),
    "wo": (1, 2),
    "w1": (1,),
    "w2": (1,),
}

_EPS = 1e-8


def quantize_weight(w: torch.Tensor, axes: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, fp32 scale) of ``w``, symmetric per channel over
    ``axes``. The scale keeps singleton reduce dims, so
    ``q.float() * scale`` broadcasts back to ``w``'s shape."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axes, keepdim=True)
    # eps floor: an all-zero channel quantizes to zeros with a tiny scale.
    scale = amax.clamp_min(_EPS) / 127.0
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_weight`` up to rounding: an fp32 multiply, then
    one cast to ``dtype`` (the numerics of ``transformer._weight``)."""
    return (q.float() * scale.float()).to(dtype)


def scale_shape(name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Shape of ``{name}_scale`` for a stacked weight of ``shape``."""
    axes = REDUCE_AXES[name]
    return tuple(1 if i in axes else n for i, n in enumerate(shape))


def quantize_params_for_serving(params: Any, cfg: Any) -> Any:
    """Per-channel int8 over the block projections. Call after
    ``bridge.cast_params_for_inference``. Returns a new tree; only
    ``params['blocks']['attn'|'mlp']`` changes. MoE models raise."""
    if getattr(cfg, "n_experts", 0):
        raise ValueError("int8 weight quantization does not cover MoE expert matmuls")
    params = dict(params)
    blocks = dict(params["blocks"])
    for sub_name in ("attn", "mlp"):
        sub = dict(blocks[sub_name])
        for name, axes in REDUCE_AXES.items():
            w = sub.get(name)
            if w is None or not w.is_floating_point():
                continue
            sub[name], sub[name + "_scale"] = quantize_weight(w, axes)
        blocks[sub_name] = sub
    params["blocks"] = blocks
    return params


def is_quantized(params: Any) -> bool:
    """True if ``quantize_params_for_serving`` has run on this tree."""
    try:
        attn = params["blocks"]["attn"]
    except (KeyError, TypeError):
        return False
    return any(k.endswith("_scale") for k in attn)


def param_bytes(params: Any) -> int:
    """Total bytes across all leaves."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
