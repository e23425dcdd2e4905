"""Export a checkpoint as a Hugging Face GPT-2 model directory.

The port's counterpart of ``scripts/export_hf_checkpoint.py``, the inverse
of ``import_hf_checkpoint``: a GPT-2-shaped model (learned positions,
LayerNorm, gelu, fused qkv with bias, output projection, tied head, full
causal attention) becomes a directory that
``GPT2LMHeadModel.from_pretrained`` loads: ``config.json`` (a
``GPT2Config``'s fields, as JSON) and ``model.safetensors`` with HF's key
names, written with numpy and torch only (no ``transformers``, no
``safetensors`` package). The tied ``lm_head.weight`` is left out, as
``save_pretrained`` leaves it out.

Usage::

    python -m pretraining_llm_tpu_torch.export_hf_checkpoint build/ck --out_dir hf_model
    # then anywhere:  GPT2LMHeadModel.from_pretrained("hf_model")
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.utils import safetensors

# The GPT2Config fields from_pretrained reads, at GPT2Config's defaults;
# export_params_to_hf fills in the model's.
_GPT2_CONFIG = {
    "architectures": ["GPT2LMHeadModel"],
    "model_type": "gpt2",
    "initializer_range": 0.02,
    "summary_type": "cls_index",
    "summary_use_proj": True,
    "summary_activation": None,
    "summary_first_dropout": 0.1,
    "summary_proj_to_labels": True,
    "scale_attn_weights": True,
    "use_cache": True,
    "scale_attn_by_inverse_layer_idx": False,
    "reorder_and_upcast_attn": False,
    "bos_token_id": 50256,
    "eos_token_id": 50256,
    "tie_word_embeddings": True,
    "torch_dtype": "float32",
}


def _np(a: Any) -> np.ndarray:
    """A leaf (tensor or array) as fp32 numpy (bf16 widens exactly)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().float().numpy()
    return np.asarray(a, np.float32)


def export_params_to_hf(params: Dict[str, Any], cfg: ModelConfig) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(params, ModelConfig) -> (HF ``config.json`` dict, HF state dict of
    fp32 numpy arrays without the tied ``lm_head.weight``). Raises
    ``ValueError`` naming every property that keeps the model from being
    the GPT-2 architecture HF runs."""
    required = {
        "pos_embed": cfg.pos_embed == "learned",
        "norm": cfg.norm == "layernorm",
        "activation": cfg.activation in ("gelu",),
        "use_output_proj": cfg.use_output_proj,
        "tie_embeddings": cfg.tie_embeddings,
        "qkv_bias": cfg.qkv_bias,
        "mlp_bias": cfg.mlp_bias,
        "mha (no GQA)": cfg.kv_heads == cfg.n_heads,
        "no MoE": cfg.n_experts == 0,
        # HF GPT-2 runs FULL causal attention: a windowed or doc-masked
        # model would load cleanly but compute different outputs.
        "no sliding_window": cfg.sliding_window == 0,
        "no doc_mask": cfg.doc_mask_token < 0,
    }
    bad = [k for k, ok in required.items() if not ok]
    if bad:
        raise ValueError(
            f"model is not the GPT-2 architecture HF expects; failing "
            f"properties: {bad}"
        )

    d, h, dh, nl = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_layers
    hf_cfg = dict(
        _GPT2_CONFIG,
        vocab_size=cfg.vocab_size,
        n_positions=cfg.context_length,
        n_embd=d,
        n_layer=nl,
        n_head=h,
        n_inner=int(cfg.mlp_ratio * d),
        activation_function="gelu_new",
        layer_norm_epsilon=cfg.norm_eps,
        # No dropout: this framework trains without it, and an exported
        # model should evaluate identically by default.
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )
    blocks = params["blocks"]
    sd = {
        "transformer.wte.weight": _np(params["tok_embed"]["embedding"]),
        "transformer.wpe.weight": _np(params["pos_embed"]["embedding"]),
        "transformer.ln_f.weight": _np(params["final_norm"]["scale"]),
        "transformer.ln_f.bias": _np(params["final_norm"]["bias"]),
    }
    for i in range(nl):
        pre = f"transformer.h.{i}."
        sd[pre + "ln_1.weight"] = _np(blocks["ln1"]["scale"][i])
        sd[pre + "ln_1.bias"] = _np(blocks["ln1"]["bias"][i])
        sd[pre + "attn.c_attn.weight"] = _np(blocks["attn"]["wqkv"][i]).reshape(d, 3 * h * dh)
        sd[pre + "attn.c_attn.bias"] = _np(blocks["attn"]["bqkv"][i]).reshape(3 * h * dh)
        sd[pre + "attn.c_proj.weight"] = _np(blocks["attn"]["wo"][i]).reshape(h * dh, d)
        sd[pre + "attn.c_proj.bias"] = _np(blocks["attn"]["bo"][i])
        sd[pre + "ln_2.weight"] = _np(blocks["ln2"]["scale"][i])
        sd[pre + "ln_2.bias"] = _np(blocks["ln2"]["bias"][i])
        sd[pre + "mlp.c_fc.weight"] = _np(blocks["mlp"]["w1"][i])
        sd[pre + "mlp.c_fc.bias"] = _np(blocks["mlp"]["b1"][i])
        sd[pre + "mlp.c_proj.weight"] = _np(blocks["mlp"]["w2"][i])
        sd[pre + "mlp.c_proj.bias"] = _np(blocks["mlp"]["b2"][i])
    return hf_cfg, sd


def save_hf_dir(out_dir: str, hf_cfg: Dict[str, Any], sd: Dict[str, np.ndarray]) -> str:
    """Write ``config.json`` and ``model.safetensors`` (metadata format
    "pt", which ``from_pretrained`` requires) into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2, sort_keys=True)
    safetensors.save_file(sd, os.path.join(out_dir, "model.safetensors"), metadata={"format": "pt"})
    return out_dir


def main(argv: Optional[List[str]] = None) -> str:
    from pretraining_llm_tpu_torch.generation.generate import load_model_for_inference

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", help="checkpoint directory (or a step-N directory)")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--ema", action="store_true", help="export the EMA shadow params instead of the raw params")
    args = ap.parse_args(argv)

    params, cfg = load_model_for_inference(args.checkpoint, use_ema=args.ema, device="cpu")
    hf_cfg, sd = export_params_to_hf(params, cfg.model)
    save_hf_dir(args.out_dir, hf_cfg, sd)
    n = sum(v.size for v in sd.values())
    print(f"exported {n / 1e6:.1f}M params -> {args.out_dir} (GPT2LMHeadModel.from_pretrained-loadable)")
    return args.out_dir


if __name__ == "__main__":
    main()
