"""``python -m pretraining_llm_tpu_torch.train --compile-only`` against the
JAX package's ``scripts/train.py --compile-only``.

The port prints one JSON line with the JAX script's keys. Its
``arguments`` (the state and one global batch) and ``aliased`` (the state)
equal, byte for byte, what XLA's ``memory_analysis()`` reports for the JAX
train step of the same tiny config (0 bytes allowed: the JAX state's step
counter is an int32 scalar, as the port's is, and the JAX step takes no RNG
key), for each optimizer, with an EMA copy, with bf16 parameters and with
microbatches. Its ``outputs`` are the state plus the step's three fp32
metrics, where the JAX step returns more metric scalars (under 1 KiB more).
On the CPU the measured fields are ``null``; without a GPU the default
device raises, as every entry point does.
"""

import json

import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.config import get_preset as jax_preset
from pretraining_llm_tpu.training import train_step as jts
from pretraining_llm_tpu_torch import train as train_cli
from pretraining_llm_tpu_torch.config import get_preset

KEYS = ["arguments", "outputs", "aliased (donated state, counted once)", "temps", "total_peak_estimate"]


@pytest.mark.parametrize("overrides", [
    {}, {"train.optimizer": "adafactor"}, {"train.optimizer": "muon"}, {"train.ema_decay": 0.999},
    {"model.param_dtype": "bfloat16"}, {"train.microbatches": 2},
], ids=["adamw", "adafactor", "muon", "ema", "bf16-params", "microbatches"])
def test_shape_bytes_equal_xla_memory_analysis(overrides):
    mem = jts.lower_train_step(jax_preset("tiny").with_overrides(overrides), None).compile().memory_analysis()
    sizes = train_cli.shape_bytes(get_preset("tiny").with_overrides(overrides))
    assert sizes["state"] + sizes["batch"] == mem.argument_size_in_bytes
    assert sizes["state"] == mem.alias_size_in_bytes
    assert 0 <= mem.output_size_in_bytes - (sizes["state"] + sizes["metrics"]) < 1024


def test_compile_only_prints_the_jax_keys_on_the_cpu(capsys):
    report = train_cli.main(["--preset", "tiny", "--compile-only", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == report
    assert list(report) == ["compile_s", "devices", "per_device_GiB"]
    assert list(report["per_device_GiB"]) == KEYS
    assert report["devices"] == 1 and report["compile_s"] >= 0
    per = report["per_device_GiB"]
    assert per["temps"] is None and per["total_peak_estimate"] is None  # no peak counter on the CPU
    sizes = train_cli.shape_bytes(get_preset("tiny"))
    assert per["arguments"] == round((sizes["state"] + sizes["batch"]) / 2**30, 3)


def test_compile_only_sizes_a_full_preset_without_allocating(monkeypatch, capsys):
    """reference-3b's state is sized from shapes on the meta device: no
    parameter is drawn or allocated on the CPU. The preset's mesh shards
    it over 4 fsdp ranks; one process states a one-device mesh."""
    calls = []
    real = torch.randn
    monkeypatch.setattr(torch, "randn", lambda *a, **k: calls.append(a) or real(*a, **k))
    report = train_cli.main(["--preset", "reference-3b", "--compile-only", "--device", "cpu",
                             "--override", "mesh.fsdp=1"])
    assert calls == []
    cfg = get_preset("reference-3b")
    n = cfg.model.num_params()
    # fp32 params and AdamW's two moments, the step and AdamW's count.
    assert train_cli.shape_bytes(cfg)["state"] == 12 * n + 8
    assert report["per_device_GiB"]["aliased (donated state, counted once)"] == round((12 * n + 8) / 2**30, 3)


def test_compile_only_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--preset", "tiny", "--compile-only"])
