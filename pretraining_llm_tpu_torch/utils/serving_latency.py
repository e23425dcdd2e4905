"""Admission wall time and time to first token of ``chip_smoke.py``'s path 1.

Run from the repository root on a machine with a GPU::

    python -m pretraining_llm_tpu_torch.utils.serving_latency [--runs N]

The workload is path 1's: gpt2-124m at full width (bf16,
``paged_attention_impl="kernel"``, random weights from seed 0), 16 requests
of 17-900 prompt tokens and 64 new tokens each, submitted together to a
``ServingEngine`` (8 rows, 256 blocks of 64 slots, 8 decode steps per
schedule). One warm-up run (kernel loads, library handles), then ``--runs``
measured runs on fresh engines. One JSON line: the card's name and power
limit as ``nvidia-smi`` gives them and, per run, the engine's admission
wall time (``stats["prefill_s"]``, host clock around each admission
prefill, ending when its sampled tokens reach the host), the median and
largest time to first token over the requests (submit to first token) and
the run's wall time.

It uses only the engine's public entry points, so the same file can be
copied into another checkout of the repository and run there: two trees
are compared by alternating such runs on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

SEED = 0  # weights and prompts, as in chip_smoke.py's path 1


def serve_once(params, cfg) -> dict:
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine

    eng = ServingEngine(params, cfg, max_batch=8, n_blocks=256, block_size=64, steps_per_sched=8, device="cuda")
    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(17, 901, size=16).tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(rng.integers(0, cfg.vocab_size, size=n).tolist(), 64) for n in lens]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = [eng.timing_summary(r)["ttft_s"] for r in rids]
    return {"admission_s": eng.stats["prefill_s"], "ttft_median_s": statistics.median(ttft),
            "ttft_max_s": max(ttft), "wall_s": wall}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=2, help="measured runs after the warm-up")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serving_latency needs a CUDA device")
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.models import bridge, transformer

    cfg = dataclasses.replace(get_preset("gpt2-124m").model, paged_attention_impl="kernel")
    params = bridge.cast_params_for_inference(transformer.init_params(cfg, SEED, device="cuda"), cfg)
    serve_once(params, cfg)
    runs = [serve_once(params, cfg) for _ in range(args.runs)]
    device = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[:1]
    print(json.dumps({"device": device, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
