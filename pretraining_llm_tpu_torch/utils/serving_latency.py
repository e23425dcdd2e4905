"""End-to-end serving numbers of ``chip_smoke.py``'s paths 1, 2 and 3.

Run from the repository root on a machine with a GPU::

    python -m pretraining_llm_tpu_torch.utils.serving_latency [--path 1|2|3] [--runs N]

Every path serves gpt2-124m at full width (bf16,
``paged_attention_impl="kernel"``, random weights from seed 0) through a
``ServingEngine`` of 8 rows, 256 blocks of 64 slots and 8 decode steps per
schedule, 64 new tokens per request, with ``chip_smoke.py``'s engine
settings:

  path 1  16 requests of 17-900 prompt tokens submitted together,
          monolithic admission prefill (flash kernel), paged decode;
  path 2  16 requests sharing two 384-token system prompts, submitted
          together, 256-token prefill chunks and the prefix cache, one-pass
          ragged kernel (``ragged_kv_splits=1``);
  path 3  the same requests arriving two per scheduler step under
          ``quantize="int8-kv"`` with the prefix cache and the auto KV-split
          count: every attention through the ragged kernel on int8 pools.

One warm-up run (kernel loads, library handles), then ``--runs`` measured
runs on fresh engines. One JSON line: the path, the card's name and power
limit as ``nvidia-smi`` gives them and, per run, the wall time, prefill
tokens/s (``stats["prefill_tokens"] / stats["prefill_s"]``), decode tokens/s
(generated tokens after each request's first, over ``stats["decode_s"]``),
the admission wall time (``stats["prefill_s"]``) and the median and largest
time to first token over the requests (submit to first token).

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

SEED = 0  # weights and prompts, as in chip_smoke.py
MAX_NEW = 64
ENGINE = dict(max_batch=8, n_blocks=256, block_size=64, steps_per_sched=8, device="cuda")
PATHS = {  # path: (model config fields, engine settings, arrivals per scheduler step; 0 = all at once)
    1: ({}, {}, 0),
    2: ({"ragged_kv_splits": 1}, {"prefill_chunk_tokens": 256, "prefix_cache": True}, 0),
    3: ({"ragged_kv_splits": 0}, {"quantize": "int8-kv", "prefix_cache": True}, 2),
}


def prompts_for(path: int, vocab_size: int) -> list:
    """Path 1: 16 prompts of 17-900 random tokens. Paths 2 and 3
    (``chip_smoke.py::shared_prefix_requests``): two 384-token system
    prompts, 8 requests each, alternating, each followed by its own 17-400
    tokens."""
    if path == 1:
        rng = np.random.default_rng(SEED + 3)
        return [rng.integers(0, vocab_size, size=n).tolist() for n in rng.integers(17, 901, size=16).tolist()]
    rng = np.random.default_rng(SEED + 7)
    prefixes = [rng.integers(0, vocab_size, size=384).tolist() for _ in range(2)]
    own = rng.integers(17, 401, size=16).tolist()
    return [prefixes[i % 2] + rng.integers(0, vocab_size, size=n).tolist() for i, n in enumerate(own)]


def serve_once(path: int, params, cfg) -> dict:
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine

    _, engine_kw, arrivals = PATHS[path]
    eng = ServingEngine(params, cfg, **ENGINE, **engine_kw)
    prompts = prompts_for(path, cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if arrivals:
        rids, pending = [], list(prompts)
        while pending or eng.has_work():
            for _ in range(arrivals):
                if pending:
                    rids.append(eng.submit(pending.pop(0), MAX_NEW))
            eng.step()
    else:
        rids = [eng.submit(p, MAX_NEW) for p in prompts]
        eng.run(pipeline=False)  # chip_smoke's paths 1 and 2 run the synchronous scheduler
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats
    ttft = [eng.timing_summary(r)["ttft_s"] for r in rids]
    return {"wall_s": wall, "prefill_tokens_per_s": st["prefill_tokens"] / st["prefill_s"],
            "decode_tokens_per_s": (st["tokens"] - st["admissions"]) / st["decode_s"],
            "admission_s": st["prefill_s"], "ttft_median_s": statistics.median(ttft), "ttft_max_s": max(ttft)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", type=int, choices=sorted(PATHS), default=1, help="chip_smoke.py's serving path")
    parser.add_argument("--runs", type=int, default=2, help="measured runs after the warm-up")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serving_latency needs a CUDA device")
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.models import bridge, transformer

    cfg_kw, _, _ = PATHS[args.path]
    cfg = dataclasses.replace(get_preset("gpt2-124m").model, paged_attention_impl="kernel", **cfg_kw)
    params = bridge.cast_params_for_inference(transformer.init_params(cfg, SEED, device="cuda"), cfg)
    serve_once(args.path, params, cfg)
    runs = [serve_once(args.path, params, cfg) for _ in range(args.runs)]
    device = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[:1]
    print(json.dumps({"path": args.path, "device": device, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
