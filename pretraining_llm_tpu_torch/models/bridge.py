"""Parameter trees between the JAX package and the port, and the serving cast.

``params_from_numpy`` takes the JAX package's parameter tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the port's tree
of tensors: the same names and layouts, checked leaf for leaf against
``transformer.param_shapes``. ``params_to_numpy`` goes back.
``cast_params_for_inference`` is the counterpart of
``pretraining_llm_tpu/generation/generate.py::cast_params_for_inference``.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.models.transformer import Params, param_shapes, torch_dtype
from pretraining_llm_tpu_torch.utils.device import DeviceLike, resolve_device


def _to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig, device: DeviceLike = None) -> Params:
    """JAX parameter tree (numpy leaves) -> the port's tree on ``device``.
    Raises ``ValueError`` naming the first leaf whose name or shape differs
    from what ``cfg`` needs."""
    dev = resolve_device(device)

    def convert(sub: Mapping[str, Any], shapes: Mapping[str, Any], path: Tuple[str, ...]) -> Params:
        if set(sub) != set(shapes):
            raise ValueError(
                f"parameter names at {'.'.join(path) or '<root>'} differ: got "
                f"{sorted(sub)}, expected {sorted(shapes)}"
            )
        out: Params = {}
        for name, want in shapes.items():
            where = path + (name,)
            if isinstance(want, dict):
                out[name] = convert(sub[name], want, where)
                continue
            got = tuple(np.shape(sub[name]))
            if got != tuple(want):
                raise ValueError(f"{'.'.join(where)}: shape {got}, expected {tuple(want)}")
            out[name] = _to_tensor(sub[name], dev)
        return out

    return convert(tree, param_shapes(cfg), ())


def params_to_numpy(params: Mapping[str, Any]) -> dict:
    """The port's tree -> numpy leaves (bf16 leaves come back as exact fp32)."""
    return {
        k: params_to_numpy(v) if isinstance(v, Mapping)
        else (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
        for k, v in params.items()
    }


def cast_params_for_inference(params: Params, cfg: ModelConfig) -> Params:
    """One-time cast of the matmul weights to ``compute_dtype``. The leaves
    the forward consumes in fp32 keep their dtype: norm scales and biases
    (names starting with ``ln`` or containing ``norm``) and the lm_head
    bias. Results are identical: the forward casts at every use site."""
    cdt = torch_dtype(cfg.compute_dtype)

    def cast(tree: Params, path: Tuple[str, ...]) -> Params:
        out: Params = {}
        for name, leaf in tree.items():
            where = path + (name,)
            if isinstance(leaf, dict):
                out[name] = cast(leaf, where)
            elif (
                not leaf.is_floating_point()
                or any(n.startswith("ln") or "norm" in n for n in where)
                or where[-2:] == ("lm_head", "bias")
            ):
                out[name] = leaf
            else:
                out[name] = leaf.to(cdt)
        return out

    return cast(params, ())
