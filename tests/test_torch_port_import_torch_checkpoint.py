"""The port's reference-checkpoint converters (``import_torch_checkpoint``,
``export_torch_checkpoint``) against the JAX package's scripts.

Mirrors ``tests/test_import_torch_checkpoint.py``: a synthetic checkpoint in
the reference's state-dict layout (per-head K/Q/V Linears, no W_O, ReLU
MLP, untied biased lm_head, wrapper prefixes, mask buffers). The bar: the
port's import equals the JAX script's key for key and bit for bit, its
logits match an independent numpy forward of the reference semantics,
export is the exact inverse of import and equals the JAX export key for
key, the CLIs round-trip through ``.pt`` files, and the rejections carry
over.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu_torch import export_torch_checkpoint as exp
from pretraining_llm_tpu_torch import import_torch_checkpoint as imp
from pretraining_llm_tpu_torch.config import get_preset
from pretraining_llm_tpu_torch.models import bridge, transformer
from scripts import export_torch_checkpoint as jexp
from scripts import import_torch_checkpoint as jimp

ROOT = Path(__file__).resolve().parent.parent
V, T, D, H, L = 89, 16, 24, 3, 2
DH = D // H


def _make_reference_state_dict(seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.2

    sd["token_embed.weight"] = t(V, D)
    sd["position_embed.weight"] = t(T, D)
    for i in range(L):
        sd[f"attn_blocks.{i}.ln1.weight"] = 1 + 0.1 * t(D)
        sd[f"attn_blocks.{i}.ln1.bias"] = 0.1 * t(D)
        for h in range(H):
            for name in ("query", "key", "value"):
                sd[f"attn_blocks.{i}.attn.heads.{h}.{name}.weight"] = t(DH, D)
            sd[f"attn_blocks.{i}.attn.heads.{h}.tril"] = torch.tril(torch.ones(T, T))
        sd[f"attn_blocks.{i}.ln2.weight"] = 1 + 0.1 * t(D)
        sd[f"attn_blocks.{i}.ln2.bias"] = 0.1 * t(D)
        sd[f"attn_blocks.{i}.mlp.hidden.weight"] = t(4 * D, D)
        sd[f"attn_blocks.{i}.mlp.hidden.bias"] = 0.1 * t(4 * D)
        sd[f"attn_blocks.{i}.mlp.proj.weight"] = t(D, 4 * D)
        sd[f"attn_blocks.{i}.mlp.proj.bias"] = 0.1 * t(D)
    sd["layer_norm.weight"] = 1 + 0.1 * t(D)
    sd["layer_norm.bias"] = 0.1 * t(D)
    sd["lm_head.weight"] = t(V, D)
    sd["lm_head.bias"] = 0.1 * t(V)
    sd["pos_idxs"] = torch.arange(T)
    return sd


def _weights(sd):
    return {k: v.numpy() for k, v in sd.items() if v.dtype.is_floating_point and not k.endswith(".tril")}


def _reference_forward_numpy(sd, tokens):
    """Independent numpy forward of the reference semantics."""

    def ln(x, w, b):
        mu = x.mean(-1, keepdims=True)
        var = x.var(-1, keepdims=True)
        return (x - mu) / np.sqrt(var + 1e-5) * w + b

    p = {k: v.numpy().astype(np.float64) for k, v in sd.items() if v.dtype.is_floating_point}
    x = p["token_embed.weight"][tokens] + p["position_embed.weight"][: tokens.shape[1]]
    mask = np.tril(np.ones((tokens.shape[1], tokens.shape[1]), bool))
    for i in range(L):
        hld = ln(x, p[f"attn_blocks.{i}.ln1.weight"], p[f"attn_blocks.{i}.ln1.bias"])
        heads = []
        for h in range(H):
            q, k, v = (hld @ p[f"attn_blocks.{i}.attn.heads.{h}.{n}.weight"].T for n in ("query", "key", "value"))
            s = np.where(mask, q @ k.transpose(0, 2, 1) / np.sqrt(DH), -np.inf)
            e = np.exp(s - s.max(-1, keepdims=True))
            heads.append(e / e.sum(-1, keepdims=True) @ v)
        x = x + np.concatenate(heads, -1)
        hld = ln(x, p[f"attn_blocks.{i}.ln2.weight"], p[f"attn_blocks.{i}.ln2.bias"])
        hid = np.maximum(hld @ p[f"attn_blocks.{i}.mlp.hidden.weight"].T + p[f"attn_blocks.{i}.mlp.hidden.bias"], 0.0)
        x = x + hid @ p[f"attn_blocks.{i}.mlp.proj.weight"].T + p[f"attn_blocks.{i}.mlp.proj.bias"]
    x = ln(x, p["layer_norm.weight"], p["layer_norm.bias"])
    return x @ p["lm_head.weight"].T + p["lm_head.bias"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


def test_import_matches_jax_and_reference_semantics(tmp_path):
    sd = _make_reference_state_dict()
    pt = tmp_path / "reference.pt"
    torch.save({"model_state_dict": {f"module._orig_mod.{k}": v for k, v in sd.items()}}, pt)
    clean = imp.read_reference_state_dict(str(pt))
    cfg, params = imp.import_state_dict(clean)
    jcfg_, jparams = jimp.import_state_dict(clean)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg_)
    got, want = _flat(params), _flat(jparams)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (cfg.vocab_size, cfg.n_layers, cfg.n_heads) == (V, L, H)
    assert not cfg.use_output_proj and not cfg.tie_embeddings and cfg.lm_head_bias
    tokens = np.arange(2 * T).reshape(2, T) % V
    fcfg = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad():
        logits, _ = transformer.forward(bridge.params_from_numpy(params, fcfg, device="cpu"),
                                        torch.from_numpy(tokens), fcfg)
    np.testing.assert_allclose(logits.numpy(), _reference_forward_numpy(sd, tokens), rtol=1e-4, atol=1e-4)


def test_import_cli_roundtrip_generates(tmp_path):
    """torch.save -> the import CLI (a subprocess) -> the port's
    ``generate_text`` on the CPU."""
    from pretraining_llm_tpu_torch.generation.generate import generate_text

    sd = _make_reference_state_dict(seed=1)
    pt = tmp_path / "ref.pt"
    torch.save({"model_state_dict": sd}, pt)
    out_dir = tmp_path / "imported"
    r = subprocess.run([sys.executable, "-m", "pretraining_llm_tpu_torch.import_torch_checkpoint", str(pt),
                        "--out_dir", str(out_dir), "--tokenizer", "byte"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "imported" in r.stdout
    # Byte ids below V = 89 (JAX's gather would clamp "a" = 97; the port's raises).
    text = generate_text(str(out_dir), "AB", max_new_tokens=4, seed=0, device="cpu")
    assert text.startswith("AB") and len(text) > 2


def test_import_rejects_unmapped_weights():
    sd = _weights(_make_reference_state_dict())
    sd["attn_blocks.0.attn.proj.weight"] = np.zeros((D, D), np.float32)
    with pytest.raises(ValueError, match="does not map") as got:
        imp.import_state_dict(sd)
    with pytest.raises(ValueError) as want:
        jimp.import_state_dict(sd)
    assert str(got.value) == str(want.value)


def test_strip_prefixes_handles_compile_of_ddp():
    sd = {"_orig_mod.module.token_embed.weight": 1, "module.x": 2, "y": 3, "module._orig_mod.module.z": 4}
    assert imp._strip_prefixes(sd) == jimp._strip_prefixes(sd)
    assert set(imp._strip_prefixes(sd)) == {"token_embed.weight", "x", "y", "z"}


def test_export_import_roundtrip_identity(tmp_path):
    """export_params is the exact inverse of import_state_dict, equal to the
    JAX export key for key; the export CLI's ``.pt`` imports back to the
    same tree."""
    sd = _weights(_make_reference_state_dict(seed=2))
    cfg, params = imp.import_state_dict(sd)
    back = exp.export_params(cfg, params)
    jback = jexp.export_params(*jimp.import_state_dict(sd))
    assert sorted(back) == sorted(jback)
    for k in back:
        np.testing.assert_array_equal(back[k], jback[k], err_msg=k)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    assert set(back) - set(sd) == {"pos_idxs"} | {
        f"attn_blocks.{i}.attn.heads.{h}.tril" for i in range(L) for h in range(H)}
    from pretraining_llm_tpu_torch.import_hf_checkpoint import write_checkpoint

    ck = write_checkpoint(str(tmp_path / "ck"), cfg, params, name="imported-reference", tokenizer="byte", source="t")
    exp.main([ck, "--out", str(tmp_path / "ref.pt")])
    cfg2, params2 = imp.import_state_dict(imp.read_reference_state_dict(str(tmp_path / "ref.pt")))
    assert cfg2 == cfg
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(params2)[k], v, err_msg=k)


def test_export_rejects_non_reference_shapes():
    cfg = get_preset("tiny").model  # GPT-2 shape: W_O and a tied head
    params = bridge.params_to_numpy(transformer.init_params(cfg, 0, device="cpu"))
    with pytest.raises(ValueError, match="reference-shaped") as got:
        exp.export_params(cfg, params)
    from pretraining_llm_tpu.config import get_preset as jax_preset

    with pytest.raises(ValueError) as want:
        jexp.export_params(jax_preset("tiny").model, params)
    assert str(got.value) == str(want.value)
    ref = dataclasses.replace(cfg, use_output_proj=False, tie_embeddings=False, lm_head_bias=True, activation="gelu")
    with pytest.raises(ValueError, match="ReLU"):
        exp.export_params(ref, params)
