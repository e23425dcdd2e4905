"""Import a Hugging Face GPT-2 checkpoint into the port's checkpoint format.

The port's counterpart of ``scripts/import_hf_checkpoint.py``. A local HF
GPT-2 directory (``config.json`` plus ``model.safetensors``, a sharded
``model.safetensors.index.json``, or ``pytorch_model.bin``) is read with
the standard library, numpy and torch only (no ``transformers``, no
``safetensors`` package), its weights are mapped onto the stacked
parameter tree by the JAX script's mapping, and the result is written with
``training/checkpoint.py``: the JAX package's format, so either package's
``load_model_for_inference``, ``generate_text``, ``evaluate``, ``serve``
and ``train`` (resume) load it.

Architecture facts relied on (and asserted): GPT-2 is pre-LN with learned
absolute positions, fused Conv1D qkv (weights stored (in, out), the port's
orientation, no transposes), gelu_new (the port's tanh "gelu"), LayerNorm
with the config's epsilon, and a tied lm_head with no bias.

Mapping (HF state_dict key -> params leaf):
  transformer.wte.weight (V, D)          -> tok_embed.embedding (tied head)
  transformer.wpe.weight (T, D)          -> pos_embed.embedding
  transformer.h.{i}.ln_1.{weight,bias}   -> blocks.ln1.{scale,bias}[i]
  transformer.h.{i}.attn.c_attn.weight (D, 3D) -> blocks.attn.wqkv[i] (D, 3, H, Dh)
  transformer.h.{i}.attn.c_attn.bias (3D,)     -> blocks.attn.bqkv[i] (3, H, Dh)
  transformer.h.{i}.attn.c_proj.weight (D, D)  -> blocks.attn.wo[i] (H, Dh, D)
  transformer.h.{i}.attn.c_proj.bias (D,)      -> blocks.attn.bo[i]
  transformer.h.{i}.mlp.c_fc.{weight,bias}     -> blocks.mlp.{w1,b1}[i]
  transformer.h.{i}.mlp.c_proj.{weight,bias}   -> blocks.mlp.{w2,b2}[i]
  transformer.ln_f.{weight,bias}         -> final_norm.{scale,bias}
  lm_head.weight                         -> dropped (tied to wte; checked)
  *.attn.bias / *.attn.masked_bias       -> dropped (causal-mask buffers)

Usage::

    python -m pretraining_llm_tpu_torch.import_hf_checkpoint /path/to/hf_gpt2_dir --out_dir imported \\
        --override model.attention_impl=flash model.paged_attention_impl=kernel
    python -m pretraining_llm_tpu_torch.generate_text --model_path imported --input_text "..."

``--override`` takes dotted config overrides for the written config (the
serving path's kernels above; the mapped weights are unchanged).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import Config, DataConfig, ModelConfig
from pretraining_llm_tpu_torch.utils import safetensors

_DROP_SUFFIXES = (".attn.bias", ".attn.masked_bias")


def _get(hf_cfg: Any, key: str, default: Any) -> Any:
    if isinstance(hf_cfg, Mapping):
        return hf_cfg.get(key, default)
    return getattr(hf_cfg, key, default)


def check_hf_config(hf_cfg: Any) -> float:
    """Reject GPT-2-family configs whose NUMERICS deviate from what the
    mapped weights will run under here (state-dict shapes alone cannot
    catch these). ``hf_cfg`` is ``config.json`` as a dict (or any object
    with the same attributes). Returns the layer-norm epsilon to carry
    over."""
    problems = []
    act = _get(hf_cfg, "activation_function", "gelu_new")
    if act != "gelu_new":
        problems.append(
            f"activation_function={act!r} (only gelu_new == this framework's tanh-approx gelu is supported)"
        )
    if _get(hf_cfg, "scale_attn_by_inverse_layer_idx", False):
        problems.append("scale_attn_by_inverse_layer_idx=True")
    if _get(hf_cfg, "reorder_and_upcast_attn", False):
        problems.append("reorder_and_upcast_attn=True")
    if problems:
        raise ValueError(
            "HF config numerics differ from this framework's forward; a "
            f"silent import would corrupt outputs: {problems}"
        )
    return float(_get(hf_cfg, "layer_norm_epsilon", 1e-5))


def import_hf_model(model: Any) -> Tuple[ModelConfig, Dict[str, Any]]:
    """(an object with ``config`` and ``state_dict()``, such as a
    ``GPT2LMHeadModel``) -> (ModelConfig, params), config-validated."""
    norm_eps = check_hf_config(model.config)
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    return import_hf_state_dict(sd, int(model.config.n_head), norm_eps=norm_eps)


def import_hf_state_dict(sd: Dict[str, np.ndarray], n_heads: int,
                         norm_eps: float = 1e-5) -> Tuple[ModelConfig, Dict[str, Any]]:
    """(HF GPT2LMHeadModel state_dict as numpy, n_head) -> (ModelConfig,
    params as fp32 numpy).

    Every key must be consumed: leftovers mean the checkpoint is not the
    GPT-2 architecture this importer maps, and silently dropping trained
    weights would corrupt the import."""
    sd = {
        k[len("transformer."):] if k.startswith("transformer.") else k: v
        for k, v in sd.items()
        if not k.endswith(_DROP_SUFFIXES)
    }
    # lm_head.weight is tied storage of wte: assert, then drop.
    if "lm_head.weight" in sd:
        if not np.array_equal(sd["lm_head.weight"], sd["wte.weight"]):
            raise ValueError(
                "lm_head.weight is not tied to wte.weight; untied GPT-2 "
                "variants are not supported by this importer"
            )
        del sd["lm_head.weight"]
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    unused = set(sd)

    def take(key: str) -> np.ndarray:
        unused.discard(key)
        return sd[key]

    vocab_size, d_model = take("wte.weight").shape
    context_length = take("wpe.weight").shape[0]
    n_layers = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"h\.(\d+)\.", k)))
    if d_model % n_heads:
        raise ValueError(f"n_heads={n_heads} does not divide d_model={d_model}")
    dh = d_model // n_heads
    d_ff = sd["h.0.mlp.c_fc.weight"].shape[1]

    cfg = ModelConfig(
        vocab_size=vocab_size,
        context_length=context_length,
        d_model=d_model,
        n_heads=n_heads,
        n_layers=n_layers,
        # +0.5 so int(mlp_ratio * d_model) reconstructs d_ff exactly: the
        # bare ratio truncates one low for some integer pairs
        # (int((220/49)*49) == 219).
        mlp_ratio=(d_ff + 0.5) / d_model,
        activation="gelu",  # == HF gelu_new (tanh approximation)
        norm="layernorm",
        pos_embed="learned",
        use_output_proj=True,
        tie_embeddings=True,
        lm_head_bias=False,
        qkv_bias=True,
        mlp_bias=True,
        norm_eps=norm_eps,
    )
    assert cfg.d_ff == d_ff, (cfg.d_ff, d_ff)

    def stack(fmt: str, transform=lambda a: a) -> np.ndarray:
        return np.stack([transform(take(fmt.format(i=i))) for i in range(n_layers)])

    params = {
        "tok_embed": {"embedding": sd["wte.weight"]},
        "pos_embed": {"embedding": sd["wpe.weight"]},
        "blocks": {
            "ln1": {"scale": stack("h.{i}.ln_1.weight"), "bias": stack("h.{i}.ln_1.bias")},
            "attn": {
                # Conv1D stores (in, out): (D, 3D) -> (D, 3, H, Dh) directly.
                "wqkv": stack("h.{i}.attn.c_attn.weight", lambda a: a.reshape(d_model, 3, n_heads, dh)),
                "bqkv": stack("h.{i}.attn.c_attn.bias", lambda a: a.reshape(3, n_heads, dh)),
                "wo": stack("h.{i}.attn.c_proj.weight", lambda a: a.reshape(n_heads, dh, d_model)),
                "bo": stack("h.{i}.attn.c_proj.bias"),
            },
            "ln2": {"scale": stack("h.{i}.ln_2.weight"), "bias": stack("h.{i}.ln_2.bias")},
            "mlp": {
                "w1": stack("h.{i}.mlp.c_fc.weight"),
                "b1": stack("h.{i}.mlp.c_fc.bias"),
                "w2": stack("h.{i}.mlp.c_proj.weight"),
                "b2": stack("h.{i}.mlp.c_proj.bias"),
            },
        },
        "final_norm": {"scale": take("ln_f.weight"), "bias": take("ln_f.bias")},
    }
    if unused:
        raise ValueError(
            "checkpoint has weights this importer does not map (not the "
            f"GPT-2 architecture): {sorted(unused)[:8]}"
        )
    return cfg, params


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A state-dict tensor as numpy (bf16 widened to fp32, exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def read_hf_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The weights of a local HF model directory as numpy arrays: from
    ``model.safetensors``, the shards a ``model.safetensors.index.json``
    names, or ``pytorch_model.bin`` (``torch.load(weights_only=True)``)."""
    single = os.path.join(path, "model.safetensors")
    index = os.path.join(path, "model.safetensors.index.json")
    binary = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(single):
        files: List[str] = [single]
    elif os.path.exists(index):
        with open(index) as f:
            files = [os.path.join(path, n) for n in sorted(set(json.load(f)["weight_map"].values()))]
    elif os.path.exists(binary):
        sd = torch.load(binary, map_location="cpu", weights_only=True)
        return {k: _numpy(v) for k, v in sd.items()}
    else:
        raise FileNotFoundError(
            f"{path} holds no model.safetensors, model.safetensors.index.json or pytorch_model.bin"
        )
    out: Dict[str, np.ndarray] = {}
    for name in files:
        out.update({k: _numpy(v) for k, v in safetensors.load_file(name).items()})
    return out


def load_hf_model_dir(path: str) -> Tuple[ModelConfig, Dict[str, Any]]:
    """(ModelConfig, params) from a local HF GPT-2 directory, with no
    ``transformers`` import: ``config.json`` as JSON, the weights through
    ``read_hf_state_dict``."""
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    norm_eps = check_hf_config(hf_cfg)
    return import_hf_state_dict(read_hf_state_dict(path), int(hf_cfg["n_head"]), norm_eps=norm_eps)


def write_checkpoint(out_dir: str, cfg: ModelConfig, params: Dict[str, Any], *, name: str,
                     tokenizer: str, source: str, overrides: Optional[Dict[str, Any]] = None) -> str:
    """Save ``params`` (numpy, written as fp32) as step 0 of a checkpoint
    directory whose config is ``cfg`` with ``overrides`` applied; returns
    the step directory."""
    from pretraining_llm_tpu_torch.training import checkpoint as ckpt

    full = Config(model=cfg, data=DataConfig(tokenizer_name=tokenizer), name=name)
    if overrides:
        full = full.with_overrides(overrides)

    def fp32(tree: Dict[str, Any]) -> Dict[str, Any]:
        return {k: fp32(v) if isinstance(v, dict) else np.asarray(v, np.float32) for k, v in tree.items()}

    return ckpt.save_checkpoint(
        out_dir, 0, {"params": fp32(params)},
        extra={"step": 0, "config": dataclasses.asdict(full), "preset": full.name, "source": source},
    )


def n_params(params: Dict[str, Any]) -> int:
    return sum(n_params(v) if isinstance(v, dict) else int(np.prod(np.shape(v))) for v in params.values())


def main(argv: Optional[List[str]] = None) -> str:
    from pretraining_llm_tpu_torch.train import parse_overrides

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("hf_path", help="local HF GPT-2 model directory")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--tokenizer", default="gpt2", help="tokenizer name recorded in the checkpoint's config")
    ap.add_argument("--override", nargs="*", default=[], help="dotted config overrides, e.g. model.attention_impl=flash")
    args = ap.parse_args(argv)

    cfg, params = load_hf_model_dir(args.hf_path)
    path = write_checkpoint(args.out_dir, cfg, params, name="imported-hf-gpt2", tokenizer=args.tokenizer,
                            source=os.path.abspath(args.hf_path), overrides=parse_overrides(args.override))
    print(f"imported {n_params(params) / 1e6:.1f}M params ({cfg.n_layers}L d{cfg.d_model} "
          f"h{cfg.n_heads} ctx{cfg.context_length} V{cfg.vocab_size}) -> {path}")
    return path


if __name__ == "__main__":
    main()
