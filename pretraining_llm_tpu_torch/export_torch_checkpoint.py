"""Export a checkpoint to the reference's PyTorch ``.pt`` layout.

The port's counterpart of ``scripts/export_torch_checkpoint.py``, the
inverse of ``import_torch_checkpoint``: a reference-shaped model
(use_output_proj=False, untied biased lm_head, ReLU, learned positions,
LayerNorm, biasless MHA QKV: the ``reference-3b`` preset or an imported
checkpoint) is written as ``torch.save({'model_state_dict': ...})`` with
the reference's module names (per-head K/Q/V Linears split back out of the
fused wqkv, and the causal-mask buffers its strict ``load_state_dict``
expects). Other models are refused.

Usage::

    python -m pretraining_llm_tpu_torch.export_torch_checkpoint <ckpt_dir_or_step_dir> --out ref.pt
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def export_params(cfg, params) -> Dict[str, np.ndarray]:
    """(ModelConfig, params pytree) -> reference-named state dict (numpy)."""
    if cfg.use_output_proj or cfg.tie_embeddings or not cfg.lm_head_bias:
        raise ValueError(
            "only reference-shaped models export (use_output_proj=False, "
            "untied embeddings, biased lm_head) — e.g. the reference-3b "
            f"preset or an imported checkpoint; got use_output_proj="
            f"{cfg.use_output_proj} tie_embeddings={cfg.tie_embeddings} "
            f"lm_head_bias={cfg.lm_head_bias}"
        )
    if cfg.activation != "relu" or cfg.pos_embed != "learned" or cfg.norm != "layernorm":
        raise ValueError(
            "reference-shaped layout is ReLU/learned-positions/LayerNorm; got "
            f"{cfg.activation}/{cfg.pos_embed}/{cfg.norm}"
        )
    if cfg.qkv_bias or not cfg.mlp_bias or cfg.kv_heads != cfg.n_heads or cfg.n_experts:
        raise ValueError(
            "reference-shaped attention/MLP is biasless fused-MHA QKV with "
            "biased dense MLP (no GQA, no MoE); got qkv_bias="
            f"{cfg.qkv_bias} mlp_bias={cfg.mlp_bias} kv_heads={cfg.kv_heads} "
            f"n_experts={cfg.n_experts}"
        )
    p = {k: np.asarray(v, np.float32) for k, v in _flatten(params).items()}
    unused = set(p)

    def take(key: str) -> np.ndarray:
        unused.discard(key)
        return p[key]

    sd: Dict[str, np.ndarray] = {
        "token_embed.weight": take("tok_embed.embedding"),
        "position_embed.weight": take("pos_embed.embedding"),
        "layer_norm.weight": take("final_norm.scale"),
        "layer_norm.bias": take("final_norm.bias"),
        "lm_head.weight": take("lm_head.kernel").T,
        "lm_head.bias": take("lm_head.bias"),
    }
    wqkv = take("blocks.attn.wqkv")  # (L, D, 3, H, Dh)
    ln1_s, ln1_b = take("blocks.ln1.scale"), take("blocks.ln1.bias")
    ln2_s, ln2_b = take("blocks.ln2.scale"), take("blocks.ln2.bias")
    w1, b1 = take("blocks.mlp.w1"), take("blocks.mlp.b1")
    w2, b2 = take("blocks.mlp.w2"), take("blocks.mlp.b2")
    t = cfg.context_length
    for i in range(cfg.n_layers):
        sd[f"attn_blocks.{i}.ln1.weight"] = ln1_s[i]
        sd[f"attn_blocks.{i}.ln1.bias"] = ln1_b[i]
        for h in range(cfg.n_heads):
            for c, name in enumerate(("query", "key", "value")):
                sd[f"attn_blocks.{i}.attn.heads.{h}.{name}.weight"] = (
                    wqkv[i, :, c, h, :].T
                )
            # Registered buffers the reference's strict load_state_dict
            # expects (its per-head causal masks, B10).
            sd[f"attn_blocks.{i}.attn.heads.{h}.tril"] = np.tril(
                np.ones((t, t), np.float32)
            )
        sd[f"attn_blocks.{i}.ln2.weight"] = ln2_s[i]
        sd[f"attn_blocks.{i}.ln2.bias"] = ln2_b[i]
        sd[f"attn_blocks.{i}.mlp.hidden.weight"] = w1[i].T
        sd[f"attn_blocks.{i}.mlp.hidden.bias"] = b1[i]
        sd[f"attn_blocks.{i}.mlp.proj.weight"] = w2[i].T
        sd[f"attn_blocks.{i}.mlp.proj.bias"] = b2[i]
    sd["pos_idxs"] = np.arange(t, dtype=np.int64)
    if unused:
        raise ValueError(
            "checkpoint has weights the reference layout cannot hold "
            f"(would be silently dropped): {sorted(unused)[:8]}"
        )
    return sd


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def save_reference_pt(sd: Dict[str, np.ndarray], path: str) -> None:
    """``torch.save({'model_state_dict': ...})`` of an ``export_params``
    state dict."""
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}}, path)


def main(argv: Optional[List[str]] = None) -> str:
    from pretraining_llm_tpu_torch.generation.generate import load_model_for_inference
    from pretraining_llm_tpu_torch.models.bridge import params_to_numpy

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", help="checkpoint dir (or step-N dir)")
    ap.add_argument("--out", required=True, help="output .pt path")
    ap.add_argument("--ema", action="store_true", help="export the EMA shadow params instead of the raw params")
    args = ap.parse_args(argv)

    params, cfg = load_model_for_inference(args.checkpoint, use_ema=args.ema, device="cpu")
    sd = export_params(cfg.model, params_to_numpy(params))
    save_reference_pt(sd, args.out)
    n = sum(v.size for v in sd.values())
    print(f"exported {n / 1e6:.1f}M params -> {args.out} ({len(sd)} tensors)")
    return args.out


if __name__ == "__main__":
    main()
