"""Every mode of the port's bench entry (``pretraining_llm_tpu_torch.bench``)
on the CPU at the tiny preset (2 layers, d 32), held against the JAX
package's ``bench.py``.

Each mode's ``run_bench`` gives one record whose metric is the series the
JAX package names for the same command line (its ``error_result``), with a
finite positive value (the train mode's MFU is null on the CPU, which has
no peak: its tokens/s stands in), ``loss_finite`` where the mode has it,
and ``device`` "cpu". The serving modes run at 32 requests/s to keep the
CPU run short. ``decode_bench_workload`` sizes its workload as JAX's. With
no GPU, the default command prints one environment-error line and exits 1.
"""

import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench as jbench
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.config import get_preset as jax_preset
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu_torch import bench as tbench
from pretraining_llm_tpu_torch.config import get_preset
from pretraining_llm_tpu_torch.models import transformer as ttf

jgen = importlib.import_module("pretraining_llm_tpu.generation.generate")
tgen = importlib.import_module("pretraining_llm_tpu_torch.generation.generate")
ROOT = Path(__file__).resolve().parent.parent
BASE = ["--device", "cpu", "--preset", "tiny", "--quick"]
FAST = ["--rate-rps", "32"]
MODES = {
    "train": [],
    "decode": ["--mode", "decode"],
    "trainer": ["--mode", "trainer"],
    "serving": ["--mode", "serving"],
    "serving_chunked_prefix": ["--mode", "serving", "--prefill-chunk-tokens", "16", "--prefix-cache"],
    "serving_gather": ["--mode", "serving", "--paged-attn", "gather"],
    "serving-slo": ["--mode", "serving-slo", *FAST],
    "serving-fleet": ["--mode", "serving-fleet", "--fleet-scenario", "kill", *FAST],
    "kernel": ["--mode", "kernel"],
}


def _jax_metric(argv):
    """The series the JAX package names for ``argv``. Its error_result has no
    serving-fleet branch (such failures fall through to the train series),
    so that mode is held to the port's, which names the scenario's; nor
    the serving suffixes of the chunk and prefix-cache flags, which its
    success path appends. The port files its plain gather route apart
    (``_gather``): the JAX package's default serving route is the port's
    kernel route."""
    args = jbench.parse_args([a for a in argv if a not in ("--device", "cpu")])
    if args.mode == "serving-fleet":
        return tbench.error_result(tbench.parse_args(argv), "", 0)["metric"]
    if args.prefill_chunk_tokens:
        return "serving_tokens_per_sec_tiny_pfx_chunked_unstacked"
    return jbench.error_result(args, "", 0)["metric"] + ("_gather" if args.paged_attn == "gather" else "")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_runs_on_the_cpu(mode):
    argv = BASE + MODES[mode]
    rec = tbench.run_bench(tbench.parse_args(argv))
    assert rec["metric"] == _jax_metric(argv)
    assert rec["device"] == "cpu" and "error" not in rec
    value = rec["tokens_per_sec_chip"] if mode == "train" else rec["value"]
    assert isinstance(value, float) and math.isfinite(value) and value > 0, value
    if mode in ("train", "trainer"):
        assert rec["loss_finite"] is True
        assert rec["vs_baseline"] is None and rec.get("mfu") is None  # no peak on the CPU
    if mode == "train":
        assert rec["value"] is None and rec["remat"] == "save_attn"
    if mode.startswith("serving"):
        assert rec["paged_attention_impl"] == ("gather" if mode == "serving_gather" else "kernel")
    if mode == "serving-fleet":
        # Every request ends in a terminal outcome (at 32/s some are shed busy).
        assert sum(rec["counts"].values()) == rec["n_requests"] and rec["lost_requests"] == 0
        assert rec["router"]["redrives"] >= 1 and rec["router"]["relaunches"] >= 1
    if mode == "kernel":
        assert rec["cpu_interpret"] is True
        assert set(rec["variants"]) == {"gather", "ragged", "ragged_split", "ragged_amla"}
        assert set(rec["ragged_route"].values()) == {"plain"}
    if mode == "serving_chunked_prefix":
        assert rec["engine_stats"]["prefill_chunks"] > 0


@pytest.mark.parametrize("preset", ["tiny", "gpt2-124m", "gpt2-8k-sp"])
def test_decode_bench_workload_sizes_as_jax(preset, monkeypatch):
    """The same config (ring falls back to naive), prompt_len and
    new_tokens; gpt2's weights are stubbed out (their values are seeded
    draws of each framework's own generator, not compared)."""
    if preset != "tiny":
        monkeypatch.setattr(jtf, "init_params", lambda cfg, key: {})
        monkeypatch.setattr(ttf, "init_params", lambda cfg, seed, device=None: {})
    for quick in (True, False):
        jcfg, _, jprompt, jnew = jgen.decode_bench_workload(jax_preset(preset).model, 4, quick=quick)
        tcfg, params, prompt, new = tgen.decode_bench_workload(get_preset(preset).model, 4, quick=quick,
                                                               device="cpu")
        assert (new, tuple(prompt.shape)) == (jnew, tuple(jprompt.shape))
        assert tcfg.__dict__ == jcfg.__dict__
        assert prompt.dtype == torch.int64 and 0 <= int(prompt.min()) and int(prompt.max()) < tcfg.vocab_size
    if preset == "tiny":
        wq = params["blocks"]["attn"]["wqkv"]
        assert wq.dtype == torch.bfloat16  # cast for inference
        again = tgen.decode_bench_workload(get_preset(preset).model, 4, device="cpu")
        assert torch.equal(again[1]["blocks"]["attn"]["wqkv"], wq) and torch.equal(again[2], prompt)


def test_default_command_without_a_gpu_is_an_environment_error():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default command would run on it")
    proc = subprocess.run([sys.executable, "-m", "pretraining_llm_tpu_torch.bench", "--quick"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    lines = proc.stdout.splitlines()
    assert proc.returncode == 1 and len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    assert rec["environment_error"] is True and rec["metric"] == "mfu_gpt2-124m_train"
    assert "no CUDA device" in rec["error"] and "Traceback" not in proc.stdout
    assert "last_banked" not in rec  # no earlier capture is cited
