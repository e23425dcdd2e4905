"""Where the serving path's time goes on the card: a ``torch.profiler``
breakdown of one admission prefill and one decode window.

Run from the repository root on a machine with a GPU::

    python -m pretraining_llm_tpu_torch.utils.profiling

It serves gpt2-124m (bf16, ``paged_attention_impl="kernel"``, random
weights from seed 0) with the engine settings ``chip_smoke.py`` uses, and
prints one JSON line per phase: the host wall time (which ends when the
sampled tokens reach the host), the summed device kernel time, their ratio
(the device's busy share), and the kernels that took the most device time.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict

import numpy as np
import torch

TOP_KERNELS = 12  # kernels listed per phase, by device time
SEED = 0  # weights and prompts, as in chip_smoke.py


def _profile(fn: Callable[[], None]) -> Dict[str, object]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies, fills): a CPU op's own
    # device time would count its kernels a second time.
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "wall_ms": wall * 1e3,
        "device_kernel_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e6 / wall,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [
            {"name": e.key[:80], "ms": e.self_device_time_total / 1e3, "count": e.count}
            for e in kernels[:TOP_KERNELS]
        ],
    }


def profile_serving() -> Dict[str, Dict[str, object]]:
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import bridge, transformer

    cfg = dataclasses.replace(get_preset("gpt2-124m").model, paged_attention_impl="kernel")
    params = bridge.cast_params_for_inference(transformer.init_params(cfg, SEED, device="cuda"), cfg)
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in rng.integers(17, 901, size=8)]

    def engine() -> ServingEngine:
        return ServingEngine(params, cfg, max_batch=8, n_blocks=256, block_size=64, steps_per_sched=8)

    warm = engine()  # first-call costs (kernel loads, library handles)
    for p in prompts:
        warm.submit(p, 16)
    warm.run()

    prefill = engine()
    for p in prompts:
        prefill.submit(p, 1)  # finishes at admission: the step is the prefill alone
    out = {"prefill": _profile(prefill.step)}
    out["prefill"]["tokens"] = sum(len(p) for p in prompts)

    decode = engine()
    for p in prompts:
        decode.submit(p, 64)
    decode.step()  # admission + first window, not profiled
    out["decode_window"] = _profile(decode.step)
    out["decode_window"]["steps"] = decode.steps_per_sched
    out["decode_window"]["rows"] = len(prompts)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    for phase, rec in profile_serving().items():
        print(json.dumps({"phase": phase, "device": torch.cuda.get_device_name(0), **rec}), flush=True)


if __name__ == "__main__":
    main()
