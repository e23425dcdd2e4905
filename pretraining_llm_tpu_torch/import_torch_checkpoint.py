"""Import a reference (PyTorch) checkpoint into the port's checkpoint format.

The port's counterpart of ``scripts/import_torch_checkpoint.py``. A user
switching from the reference brings ``torch.save({'model_state_dict': ...,
'optimizer_state_dict': ...})`` files of its architecture: per-head
biasless K/Q/V Linears, no attention output projection, a ReLU MLP with
biases, learned positions and an untied biased lm_head. This maps them onto
the stacked parameter tree (fused wqkv) under the matching ModelConfig and
writes a checkpoint in the JAX package's format (``training/checkpoint.py``)
that ``generate_text``, ``serve`` and ``train`` (resume) of either package
load.

Mapping (reference state_dict key -> params leaf):
  token_embed.weight    (V, D)  -> tok_embed.embedding
  position_embed.weight (T, D)  -> pos_embed.embedding
  attn_blocks.{i}.ln1.{weight,bias}            -> blocks.ln1.{scale,bias}[i]
  attn_blocks.{i}.attn.heads.{h}.{query,key,value}.weight (dh, D)
        -> blocks.attn.wqkv[i, :, {0,1,2}, h, :] (transposed to (D, dh))
  attn_blocks.{i}.ln2.{weight,bias}            -> blocks.ln2.{scale,bias}[i]
  attn_blocks.{i}.mlp.hidden.{weight,bias}     -> blocks.mlp.{w1,b1}[i] (w T)
  attn_blocks.{i}.mlp.proj.{weight,bias}       -> blocks.mlp.{w2,b2}[i] (w T)
  layer_norm.{weight,bias}                     -> final_norm.{scale,bias}
  lm_head.{weight,bias}        (V, D) / (V,)   -> lm_head.{kernel (D,V), bias}
  *.tril / pos_idxs buffers                    -> dropped (mask buffers)

Usage::

    python -m pretraining_llm_tpu_torch.import_torch_checkpoint ckpt.pt --out_dir imported_ckpt
    python -m pretraining_llm_tpu_torch.generate_text --model_path imported_ckpt --input_text "..."
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import ModelConfig


def _strip_prefixes(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop DDP ('module.') and torch.compile ('_orig_mod.') wrappers, in
    any nesting order (compile-of-DDP gives '_orig_mod.module.*')."""
    out = {}
    for k, v in sd.items():
        changed = True
        while changed:
            changed = False
            for pre in ("module.", "_orig_mod."):
                if k.startswith(pre):
                    k = k[len(pre):]
                    changed = True
        out[k] = v
    return out


def import_state_dict(sd: Dict[str, np.ndarray]):
    """(reference state_dict of numpy arrays) -> (ModelConfig, params).

    Every key must be consumed — leftover keys mean the checkpoint's
    architecture deviates from the reference spec and a silent import would
    drop trained weights; that is an error, not a warning.
    """
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    unused = set(sd)

    def take(key: str) -> np.ndarray:
        unused.discard(key)
        return sd[key]

    vocab_size, d_model = take("token_embed.weight").shape
    context_length = take("position_embed.weight").shape[0]
    n_layers = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.match(r"attn_blocks\.(\d+)\.", k))
    )
    n_heads = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.match(r"attn_blocks\.0\.attn\.heads\.(\d+)\.", k))
    )
    dh = sd["attn_blocks.0.attn.heads.0.key.weight"].shape[0]
    d_ff = sd["attn_blocks.0.mlp.hidden.weight"].shape[0]
    cfg = ModelConfig(
        vocab_size=vocab_size,
        context_length=context_length,
        d_model=d_model,
        n_heads=n_heads,
        d_head=dh,
        n_layers=n_layers,
        mlp_ratio=d_ff / d_model,
        activation="relu",
        norm="layernorm",
        pos_embed="learned",
        use_output_proj=False,
        tie_embeddings=False,
        lm_head_bias=True,
        qkv_bias=False,
        mlp_bias=True,
    )

    def stack(fmt: str, transform=lambda a: a):
        return np.stack([transform(take(fmt.format(i=i))) for i in range(n_layers)])

    # Fused QKV: slot order (q, k, v) matches _attention_block's unpacking.
    wqkv = np.zeros((n_layers, d_model, 3, n_heads, dh), np.float32)
    for i in range(n_layers):
        for h in range(n_heads):
            for c, name in enumerate(("query", "key", "value")):
                w = take(f"attn_blocks.{i}.attn.heads.{h}.{name}.weight")  # (dh, D)
                wqkv[i, :, c, h, :] = w.T

    params = {
        "tok_embed": {"embedding": sd["token_embed.weight"]},
        "pos_embed": {"embedding": sd["position_embed.weight"]},
        "blocks": {
            "ln1": {
                "scale": stack("attn_blocks.{i}.ln1.weight"),
                "bias": stack("attn_blocks.{i}.ln1.bias"),
            },
            "attn": {"wqkv": wqkv},
            "ln2": {
                "scale": stack("attn_blocks.{i}.ln2.weight"),
                "bias": stack("attn_blocks.{i}.ln2.bias"),
            },
            "mlp": {
                "w1": stack("attn_blocks.{i}.mlp.hidden.weight", lambda a: a.T),
                "b1": stack("attn_blocks.{i}.mlp.hidden.bias"),
                "w2": stack("attn_blocks.{i}.mlp.proj.weight", lambda a: a.T),
                "b2": stack("attn_blocks.{i}.mlp.proj.bias"),
            },
        },
        "final_norm": {
            "scale": take("layer_norm.weight"),
            "bias": take("layer_norm.bias"),
        },
        "lm_head": {
            "kernel": take("lm_head.weight").T,
            "bias": take("lm_head.bias"),
        },
    }
    if unused:
        raise ValueError(
            "checkpoint has weights this importer does not map (architecture "
            f"deviates from the reference spec): {sorted(unused)[:8]}"
        )
    return cfg, params


def read_reference_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pt`` file's weights as numpy: ``model_state_dict`` (or
    a bare state dict), wrapper prefixes stripped, mask buffers dropped."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("model_state_dict", raw)  # reference schema or a bare state_dict
    sd = _strip_prefixes({k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")})
    return {k: v for k, v in sd.items() if not k.endswith((".tril", "pos_idxs"))}


def main(argv: Optional[List[str]] = None) -> str:
    from pretraining_llm_tpu_torch.import_hf_checkpoint import n_params, write_checkpoint
    from pretraining_llm_tpu_torch.train import parse_overrides

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", help="reference .pt file (torch.save format)")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--tokenizer", default="gpt2",
                    help="tokenizer name recorded for generate_text (the reference uses gpt2/r50k)")
    ap.add_argument("--override", nargs="*", default=[], help="dotted config overrides, e.g. model.attention_impl=flash")
    args = ap.parse_args(argv)

    cfg, params = import_state_dict(read_reference_state_dict(args.checkpoint))
    path = write_checkpoint(args.out_dir, cfg, params, name="imported-reference", tokenizer=args.tokenizer,
                            source=os.path.abspath(args.checkpoint), overrides=parse_overrides(args.override))
    print(f"imported {n_params(params) / 1e6:.1f}M params ({cfg.n_layers}L d{cfg.d_model} "
          f"h{cfg.n_heads} ctx{cfg.context_length} V{cfg.vocab_size}) -> {path}")
    return path


if __name__ == "__main__":
    main()
