"""The port's Hugging Face GPT-2 converters (``import_hf_checkpoint``,
``export_hf_checkpoint``, ``utils/safetensors.py``) against the JAX
package's scripts and ``transformers``.

Mirrors ``tests/test_hf_interop.py``. HF models come from a local
``GPT2Config`` (no download). The bar: the port's import equals the JAX
script's ``import_hf_state_dict`` leaf for leaf, bit for bit, from the
model, from a ``save_pretrained`` directory (``model.safetensors``) and
from a ``pytorch_model.bin`` one; imported fp32 logits are within 1e-4 of
``GPT2LMHeadModel``'s and greedy tokens equal the JAX ``generate``'s and
HF's; ``GPT2LMHeadModel.from_pretrained`` loads the port's export with
every weight bit for bit; the rejections and the odd ``d_ff`` case carry
over; and the port's safetensors reader and writer round-trip against the
``safetensors`` package.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.generation.generate import generate as jax_generate
from pretraining_llm_tpu_torch import export_hf_checkpoint as exp
from pretraining_llm_tpu_torch import import_hf_checkpoint as imp
from pretraining_llm_tpu_torch.models import bridge, transformer
from pretraining_llm_tpu_torch.utils import safetensors as port_st
from scripts import import_hf_checkpoint as jimp

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

MASKS = (".attn.bias", ".attn.masked_bias")


@pytest.fixture(scope="module")
def hf_model():
    cfg = transformers.GPT2Config(vocab_size=97, n_positions=32, n_embd=48, n_layer=2, n_head=4,
                                  resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


def _assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in g:
        assert g[k].dtype == w[k].dtype == np.float32, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_import_config_and_shapes_equal_jax(hf_model):
    cfg, params = imp.import_hf_model(hf_model)
    jcfg_, jparams = jimp.import_hf_model(hf_model)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg_)
    _assert_same_tree(params, jparams)
    assert (cfg.vocab_size, cfg.context_length, cfg.n_layers, cfg.n_heads) == (97, 32, 2, 4)
    assert cfg.tie_embeddings and cfg.qkv_bias and cfg.use_output_proj
    assert params["blocks"]["attn"]["wqkv"].shape == (2, 48, 3, 4, 12)
    assert "lm_head" not in params


def test_import_reads_safetensors_and_bin_dirs(hf_model, tmp_path):
    """``save_pretrained`` directories (safetensors, and the
    ``pytorch_model.bin`` route), read with no ``transformers`` call, give
    the JAX import of the model bit for bit; so does the import CLI's
    checkpoint, read back by the port's loader."""
    from pretraining_llm_tpu_torch.generation.generate import load_model_for_inference

    want_cfg, want = jimp.import_hf_model(hf_model)
    hf_model.save_pretrained(tmp_path / "st")
    hf_model.save_pretrained(tmp_path / "bin", safe_serialization=False)
    for name in ("st", "bin"):
        cfg, params = imp.load_hf_model_dir(str(tmp_path / name))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
        _assert_same_tree(params, want)
    imp.main([str(tmp_path / "st"), "--out_dir", str(tmp_path / "ck"), "--tokenizer", "byte",
              "--override", "model.attention_impl=flash"])
    loaded, full = load_model_for_inference(str(tmp_path / "ck"), device="cpu")
    assert full.model.attention_impl == "flash" and full.data.tokenizer_name == "byte"
    _assert_same_tree(bridge.params_to_numpy(loaded), want)
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        imp.read_hf_state_dict(str(tmp_path))


def test_imported_logits_match_hf(hf_model):
    cfg, params = imp.import_hf_model(hf_model)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    toks = np.random.default_rng(1).integers(0, 97, (2, 20))
    with torch.no_grad():
        want = hf_model(torch.from_numpy(toks)).logits.numpy()
        got, _ = transformer.forward(bridge.params_from_numpy(params, cfg, device="cpu"), torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_export_round_trip_exact_through_from_pretrained(hf_model, tmp_path):
    """import -> export -> ``GPT2LMHeadModel.from_pretrained`` reproduces
    every HF weight bit for bit, and the loaded model's logits are the
    original's."""
    cfg, params = imp.import_hf_model(hf_model)
    hf_cfg, sd = exp.export_params_to_hf(params, cfg)
    exp.save_hf_dir(str(tmp_path / "out"), hf_cfg, sd)
    back = transformers.GPT2LMHeadModel.from_pretrained(str(tmp_path / "out")).eval()
    orig, out = hf_model.state_dict(), back.state_dict()
    for k, v in orig.items():
        if not k.endswith(MASKS):
            np.testing.assert_array_equal(v.numpy(), out[k].numpy(), err_msg=k)
    assert back.config.n_inner == 4 * 48 and back.config.activation_function == "gelu_new"
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 97, (1, 12)))
    with torch.no_grad():
        assert torch.equal(back(toks).logits, hf_model(toks).logits)
    # The export CLI on a port checkpoint gives the same directory.
    ck = imp.write_checkpoint(str(tmp_path / "ck"), cfg, params, name="x", tokenizer="byte", source="test")
    exp.main([ck, "--out_dir", str(tmp_path / "cli")])
    assert (tmp_path / "cli" / "model.safetensors").read_bytes() == (tmp_path / "out" / "model.safetensors").read_bytes()
    assert json.loads((tmp_path / "cli" / "config.json").read_text()) == hf_cfg


def test_import_rejects_unmapped_keys(hf_model):
    sd = {k: v.detach().numpy() for k, v in hf_model.state_dict().items()}
    sd["transformer.h.0.adapter.weight"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="does not map") as got:
        imp.import_hf_state_dict(sd, 4)
    with pytest.raises(ValueError) as want:
        jimp.import_hf_state_dict(sd, 4)
    assert str(got.value) == str(want.value)
    sd.pop("transformer.h.0.adapter.weight")
    sd["lm_head.weight"] = sd["lm_head.weight"] + 1.0
    with pytest.raises(ValueError, match="not tied"):
        imp.import_hf_state_dict(sd, 4)


def test_import_rejects_divergent_numerics(hf_model):
    for key, value in (("activation_function", "gelu"), ("scale_attn_by_inverse_layer_idx", True),
                       ("reorder_and_upcast_attn", True)):
        m = copy.deepcopy(hf_model)
        setattr(m.config, key, value)
        with pytest.raises(ValueError, match="numerics") as got:
            imp.import_hf_model(m)
        with pytest.raises(ValueError) as want:
            jimp.import_hf_model(m)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="numerics"):
            imp.check_hf_config(m.config.to_dict())  # config.json's form


def test_import_mlp_ratio_reconstructs_awkward_d_ff():
    cfg = transformers.GPT2Config(vocab_size=31, n_positions=8, n_embd=49, n_layer=1, n_head=7, n_inner=220,
                                  resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(1)
    m = transformers.GPT2LMHeadModel(cfg).eval()
    icfg, params = imp.import_hf_model(m)
    assert icfg.d_ff == 220 and params["blocks"]["mlp"]["w1"].shape == (1, 49, 220)
    _assert_same_tree(params, jimp.import_hf_model(m)[1])


@pytest.mark.parametrize("change", [dict(sliding_window=8), dict(activation="swiglu"), dict(n_kv_heads=2),
                                    dict(doc_mask_token=3)])
def test_export_rejects_non_gpt2_architecture(hf_model, change):
    from scripts.export_hf_checkpoint import export_params_to_hf as jexport

    cfg, params = imp.import_hf_model(hf_model)
    with pytest.raises(ValueError, match="failing properties") as got:
        exp.export_params_to_hf(params, dataclasses.replace(cfg, **change))
    jcfg_, jparams = jimp.import_hf_model(hf_model)
    with pytest.raises(ValueError) as want:
        jexport(jparams, dataclasses.replace(jcfg_, **change))
    assert str(got.value) == str(want.value)


def test_imported_checkpoint_generates(tmp_path, hf_model):
    """The import CLI's checkpoint through the port's loader and greedy
    ``generate``: the JAX ``generate``'s tokens on the same import, and
    HF's own greedy decode."""
    from pretraining_llm_tpu_torch.generation.generate import generate, load_model_for_inference

    hf_model.save_pretrained(tmp_path / "hf")
    imp.main([str(tmp_path / "hf"), "--out_dir", str(tmp_path / "ck")])
    loaded, full = load_model_for_inference(str(tmp_path / "ck"), device="cpu")
    assert full.name == "imported-hf-gpt2"
    mcfg = dataclasses.replace(full.model, compute_dtype="float32")
    prompt = [[1, 2, 3, 4]]
    toks = generate(loaded, mcfg, torch.tensor(prompt), 6, torch.Generator().manual_seed(0), temperature=0.0)
    jcfg_, jparams = jimp.import_hf_model(hf_model)
    jtoks = jax_generate(jax.tree.map(jnp.asarray, jparams), dataclasses.replace(jcfg_, compute_dtype="float32"),
                         jnp.asarray(prompt, jnp.int32), 6, jax.random.key(0), temperature=0.0)
    with torch.no_grad():
        hf_out = hf_model.generate(torch.tensor(prompt), max_new_tokens=6, do_sample=False, pad_token_id=0)
    assert toks.tolist()[0] == np.asarray(jtoks)[0].tolist() == hf_out[0, 4:].tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int64, torch.int8,
                                   torch.bool])
def test_safetensors_round_trip_against_the_package(tmp_path, dtype):
    g = torch.Generator().manual_seed(3)
    raw = {"w": torch.randn(5, 7, generator=g), "b": torch.randn(3, generator=g) * 100, "e": torch.zeros(0, 2)}
    tensors = {k: (v > 0 if dtype == torch.bool else v.to(dtype)) for k, v in raw.items()}
    port_st.save_file(tensors, str(tmp_path / "port.safetensors"), metadata={"format": "pt"})
    safetensors_torch.save_file(tensors, str(tmp_path / "pkg.safetensors"), metadata={"format": "pt"})
    assert (tmp_path / "port.safetensors").read_bytes() == (tmp_path / "pkg.safetensors").read_bytes()
    for got in (safetensors_torch.load_file(str(tmp_path / "port.safetensors")),
                port_st.load_file(str(tmp_path / "pkg.safetensors"))):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert port_st.read_header(str(tmp_path / "pkg.safetensors"))["__metadata__"] == {"format": "pt"}
    blob = bytearray((tmp_path / "port.safetensors").read_bytes())
    (tmp_path / "short.safetensors").write_bytes(bytes(blob[:-1]))
    with pytest.raises(ValueError):
        port_st.load_file(str(tmp_path / "short.safetensors"))
