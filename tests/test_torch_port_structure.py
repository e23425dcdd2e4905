"""Structural rules of the PyTorch port.

- No module of ``pretraining_llm_tpu_torch``, and not ``chip_smoke.py``,
  imports JAX or anything of the JAX package.
- Entry points run on the GPU unless the caller passes ``device="cpu"``:
  with no GPU they raise instead of falling back to the CPU.
- Options the port does not implement yet raise ``NotImplementedError``.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from pretraining_llm_tpu_torch.config import ModelConfig, get_preset, list_presets
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch.models import bridge, transformer

ROOT = Path(__file__).resolve().parent.parent
TINY = dataclasses.replace(get_preset("tiny").model, compute_dtype="float32")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pretraining_llm_tpu")


def _port_sources():
    return sorted((ROOT / "pretraining_llm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            bad += [a.value for a in node.args[:1]
                    if isinstance(a, ast.Constant) and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"


def test_port_has_kernel_sources_for_both_kernels():
    names = sorted(p.name for p in (ROOT / "pretraining_llm_tpu_torch" / "csrc").glob("*.cu"))
    assert names == ["flash_fwd.cu", "paged_decode.cu"]


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(TINY, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.make_paged_kv_pool(TINY, 4, 8)
    tree = bridge.params_to_numpy(transformer.init_params(TINY, 0, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_numpy(tree, TINY)
    params = transformer.init_params(TINY, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, TINY, n_blocks=4, block_size=8)


def test_engine_refuses_params_on_another_device():
    params = transformer.init_params(TINY, 0, device="cpu")
    params = dict(params, tok_embed={"embedding": params["tok_embed"]["embedding"].to("meta")})
    with pytest.raises(ValueError, match="params lie on meta"):
        ServingEngine(params, TINY, n_blocks=4, block_size=8, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(quantize="int8"), dict(prefix_cache=True), dict(prefill_chunk_tokens=16),
    dict(spec_k=2), dict(mesh=object()), dict(pipeline_depth=2), dict(admit_batch=4),
    dict(fused_sampling=False), dict(kv_checksum=True),
])
def test_unported_engine_options_raise(kw):
    params = transformer.init_params(TINY, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=next(iter(kw))):
        ServingEngine(params, TINY, n_blocks=4, block_size=8, device="cpu", **kw)


@pytest.mark.parametrize("kw,name", [
    (dict(n_experts=4), "n_experts"),
    (dict(attention_impl="ring"), "ring"),
    (dict(attention_impl="ulysses"), "ulysses"),
    (dict(kv_cache_dtype="int8"), "kv_cache_dtype"),
    (dict(doc_mask_token=3), "doc_mask_token"),
])
def test_unported_model_options_raise(kw, name):
    cfg = dataclasses.replace(TINY, **kw)
    with pytest.raises(NotImplementedError, match=name):
        transformer.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=name):
        transformer.forward({}, torch.zeros(1, 2, dtype=torch.long), cfg)


def test_unported_forward_paths_raise():
    params = transformer.init_params(TINY, 0, device="cpu")
    cache = transformer.make_kv_cache(TINY, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="cache_index"):
        transformer.forward(params, torch.zeros(1, 4, dtype=torch.long), TINY,
                            kv_cache=cache, cache_index=4)
    pools = transformer.make_paged_kv_pool(TINY, 4, 8, device="cpu")
    info = transformer.PagedInfo(torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
                                 q_lens=torch.ones(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="q_lens"):
        transformer.forward(params, torch.zeros(1, 3, dtype=torch.long), TINY, kv_cache=pools, paged=info)


def test_presets_and_config_validation():
    assert {"gpt2-124m", "tiny", "llama3-1b-gqa"} <= set(list_presets())
    gpt2 = get_preset("gpt2-124m").model
    assert (gpt2.vocab_size, gpt2.d_model, gpt2.n_heads, gpt2.head_dim, gpt2.n_layers) == (50304, 768, 12, 64, 12)
    assert gpt2.attention_impl == "flash" and gpt2.tie_embeddings and gpt2.qkv_bias
    llama = get_preset("llama3-1b-gqa").model
    assert (llama.kv_heads, llama.d_ff, llama.norm) == (4, 5504, "rmsnorm")
    with pytest.raises(KeyError):
        get_preset("nope")
    with pytest.raises(ValueError, match="paged_attention_impl"):
        ModelConfig(paged_attention_impl="fast")
    with pytest.raises(ValueError, match="n_kv_heads"):
        ModelConfig(n_heads=12, n_kv_heads=5)
    assert np.isclose(gpt2.num_params(), 124_475_904)
