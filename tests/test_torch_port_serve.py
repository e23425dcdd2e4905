"""The port's ``serving`` config section and offline serve CLI against the
JAX package's.

``ServingConfig`` field for field (defaults and ``__post_init__`` errors),
``serving.*`` overrides, ``Config.from_dict`` on a JAX config dict with and
without the section; ``python -m pretraining_llm_tpu_torch.serve`` on a
tiny JAX-written checkpoint in CPU mode, whose greedy JSONL ``output``
fields equal those of ``scripts/serve.py``'s ``main()`` on the same
checkpoint and tokenizer (byte), under the pipelined and the synchronous
scheduler and with a draft checkpoint; scheduler flags left at 0 fall back
to the checkpoint's ``serving`` section; the online and fleet flags raise.
A tiny byte-tokenizer model (2 layers, d 32, V 260) with seeded numpy
weights (std 0.3).
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.training import checkpoint as jckpt
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch import serve as tserve
from pretraining_llm_tpu_torch.generation import serving as tserving

ROOT = Path(__file__).resolve().parent.parent
MODEL = dict(vocab_size=260, context_length=64, d_model=32, n_heads=4, n_layers=2, compute_dtype="float32")
PROMPTS = ["hello world", "a", "the quick brown fox", "zz top", "serving engines", "xyz"]


def _load_jax_serve():
    spec = importlib.util.spec_from_file_location("jax_serve_script", ROOT / "scripts" / "serve.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_serving_section_field_for_field():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.ServingConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.ServingConfig)}
    assert tf == jf
    assert tcfg.Config().serving == tcfg.ServingConfig()
    assert tcfg.get_preset("gpt2-124m").serving.pipeline_depth == 2


@pytest.mark.parametrize("key,value", [
    ("quantize", "int4"), ("pipeline_depth", 0), ("admit_batch", -1),
    ("prefix_cache_min_blocks", 0), ("prefill_chunk_tokens", -2),
])
def test_serving_section_validation_matches_jax(key, value):
    with pytest.raises(ValueError) as want:
        jcfg.ServingConfig(**{key: value})
    with pytest.raises(ValueError) as got:
        tcfg.ServingConfig(**{key: value})
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        tcfg.get_preset("tiny").with_overrides({f"serving.{key}": value})


def test_serving_overrides_and_from_dict():
    over = {"serving.pipeline_depth": 3, "serving.kv_checksum": True, "serving.quantize": "int8-kv",
            "serving.prefix_cache": True}
    cfg = tcfg.get_preset("tiny").with_overrides(over)
    assert (cfg.serving.pipeline_depth, cfg.serving.kv_checksum, cfg.serving.quantize) == (3, True, "int8-kv")
    with pytest.raises(KeyError, match="serving.nope"):
        cfg.with_overrides({"serving.nope": 1})
    with pytest.raises(NotImplementedError, match="frontend"):
        cfg.with_overrides({"frontend.port": 1})
    raw = dataclasses.asdict(jcfg.get_preset("tiny").with_overrides(over))
    got = tcfg.Config.from_dict(raw)
    assert dataclasses.asdict(got.serving) == raw["serving"]
    assert got.model == tcfg.ModelConfig(**raw["model"])
    del raw["serving"]  # a checkpoint written before the section existed
    assert tcfg.Config.from_dict(raw).serving == tcfg.ServingConfig()


def _save(path: Path, model: dict, seed: int, serving=None) -> str:
    config = jcfg.Config(model=jcfg.ModelConfig(**model), data=jcfg.DataConfig(tokenizer_name="byte"),
                         serving=serving or jcfg.ServingConfig())
    layout = jax.eval_shape(lambda k: jtf.init_params(config.model, k), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(p, spec):
        base = 1.0 if p[-1].key == "scale" else 0.0
        return jnp.asarray((base + rng.normal(0, 0.3, spec.shape)).astype(np.float32))

    params = jax.tree_util.tree_map_with_path(leaf, layout)
    # Shrink the (tied) embeddings of the non-ASCII ids, so that greedy
    # tokens are ASCII and each decodes to its own character (the byte
    # decoder maps stray high bytes to U+FFFD).
    emb = params["tok_embed"]["embedding"]
    params["tok_embed"]["embedding"] = emb.at[128:].multiply(0.01)
    jckpt.save_checkpoint(str(path), 1, {"params": params},
                          extra={"step": 1, "config": dataclasses.asdict(config)})
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    prompts = root / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n\n")
    return {
        "target": _save(root / "target", MODEL, 3),
        "draft": _save(root / "draft", dict(MODEL, n_layers=1, d_model=16, n_heads=2), 4),
        "cached": _save(root / "cached", MODEL, 3, jcfg.ServingConfig(prefix_cache=True, pipeline_depth=3)),
        "prompts": str(prompts), "root": root,
    }


def _common(ckpts, model_path, out):
    return ["--model_path", model_path, "--input_file", ckpts["prompts"], "--max_new_tokens", "8",
            "--temperature", "0", "--max_batch", "2", "--n_blocks", "32", "--block_size", "8",
            "--output", str(out)]


def _jax_records(ckpts, extra, monkeypatch):
    out = ckpts["root"] / "jax.jsonl"
    monkeypatch.setattr("sys.argv", ["serve.py"] + _common(ckpts, ckpts["target"], out) + extra)
    _load_jax_serve().main()
    return [json.loads(line) for line in out.read_text().splitlines()]


@pytest.mark.parametrize("extra", [[], ["--no-pipeline"], ["--pipeline_depth", "3", "--admit_batch", "2"]],
                         ids=["pipelined", "sync", "depth3-admit2"])
def test_serve_cli_matches_jax_serve(ckpts, monkeypatch, extra, tmp_path):
    want = _jax_records(ckpts, extra, monkeypatch)
    out = tmp_path / "port.jsonl"
    got = tserve.main(_common(ckpts, ckpts["target"], out) + extra + ["--device", "cpu"])
    assert [json.loads(line) for line in out.read_text().splitlines()] == got
    assert [r["output"] for r in got] == [r["output"] for r in want]
    for g, w in zip(got, want):
        assert (g["index"], g["prompt"], g["n_tokens"]) == (w["index"], w["prompt"], w["n_tokens"])
        assert set(g) == set(w) == {"index", "prompt", "output", "n_tokens", "queue_wait_s", "ttft_s", "e2e_s"}
    assert [r["prompt"] for r in got] == PROMPTS
    assert all(len(r["output"]) == r["n_tokens"] == 8 and "\ufffd" not in r["output"] for r in got)


def test_serve_cli_speculative_equals_plain(ckpts, tmp_path):
    common = _common(ckpts, ckpts["target"], tmp_path / "a.jsonl") + ["--device", "cpu"]
    plain = tserve.main(common)
    spec = tserve.main(common + ["--draft_model_path", ckpts["draft"], "--spec_k", "3"])
    assert [r["output"] for r in spec] == [r["output"] for r in plain]


def test_serve_cli_falls_back_to_the_serving_section(ckpts, tmp_path, monkeypatch):
    seen = {}
    real = tserving.ServingEngine

    class Recording(real):
        def __init__(self, *args, **kw):
            seen.update(kw)
            super().__init__(*args, **kw)

    monkeypatch.setattr(tserving, "ServingEngine", Recording)
    got = tserve.main(_common(ckpts, ckpts["cached"], tmp_path / "c.jsonl") + ["--device", "cpu"])
    assert (seen["pipeline_depth"], seen["prefix_cache"], seen["kv_checksum"]) == (3, True, False)
    assert all("cached_tokens" in r for r in got)
    tserve.main(_common(ckpts, ckpts["cached"], tmp_path / "d.jsonl")
                + ["--device", "cpu", "--pipeline_depth", "1", "--kv_checksum", "--quantize", "int8"])
    assert (seen["pipeline_depth"], seen["kv_checksum"], seen["quantize"]) == (1, True, "int8")


@pytest.mark.parametrize("flags", [["--http"], ["--replicas", "2"], ["--trace", "t.json"], ["--no-slo"]])
def test_serve_cli_refuses_the_online_flags(ckpts, flags):
    with pytest.raises(NotImplementedError, match="item 6.*item 3"):
        tserve.main(["--model_path", ckpts["target"], "--input_file", ckpts["prompts"]] + flags)
