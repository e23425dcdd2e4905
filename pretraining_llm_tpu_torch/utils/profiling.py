"""Where the time goes on the card: a ``torch.profiler`` breakdown of one
admission prefill and one decode window of the serving path, of path 2's
chunked prefill and path 3's int8 decode window, of one training step, and
of one ``generate`` call at G1's shape.

Run from the repository root on a machine with a GPU::

    python -m pretraining_llm_tpu_torch.utils.profiling

Serving: gpt2-124m (bf16, ``paged_attention_impl="kernel"``, random
weights from seed 0) with the engine settings ``chip_smoke.py`` uses: path
1's admission prefill and decode window (8 prompts of 17-900 tokens); path
2's chunk phase (the first four scheduler steps after 8 of its shared-prefix
requests arrive: 256-token chunks and prefix-cache suffixes through the
one-pass ragged kernel); path 3's decode window (the same 8 requests under
``quantize="int8-kv"`` with the prefix cache, admitted in one step, then one
window of 8 decode steps through the ragged kernel on int8 pools at the
auto split count).
Training: one ``build_train_step`` step of the gpt2-124m preset (batch 12,
T 1024, bf16 compute, fp32 params and AdamW, the flash kernels) after two
warm-up steps, on random tokens; then the same with the fused CE head and
document masking (``ce_impl="fused"``, ``doc_mask_token=10``, separators
at chip_smoke T3's density of one per 67 tokens, the median spacing of
``data/parity``).
Sampling: G1's ``generate`` call (``chip_smoke.py``): gpt2-124m cast to
bf16, 8 ragged prompts of G1's lengths (random tokens), 128 greedy tokens
over the dense cache: the prefill alone (``forward`` at cache index 0 over
the 896-token bucket, as ``generate`` runs it), then the whole call.
One JSON line per phase: the host wall
time (which ends when the loss or the sampled tokens reach the host), the
summed device kernel time, their ratio (the device's busy share), and the
kernels that took the most device time.
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


def profile_ragged_paths() -> Dict[str, Dict[str, object]]:
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import bridge, transformer
    from pretraining_llm_tpu_torch.utils.serving_latency import prompts_for

    out = {}
    for phase, cfg_kw, engine_kw in (
        ("path2_chunks", {"ragged_kv_splits": 1}, {"prefill_chunk_tokens": 256, "prefix_cache": True}),
        ("path3_decode_window", {"ragged_kv_splits": 0}, {"quantize": "int8-kv", "prefix_cache": True}),
    ):
        cfg = dataclasses.replace(get_preset("gpt2-124m").model, paged_attention_impl="kernel", **cfg_kw)
        params = bridge.cast_params_for_inference(transformer.init_params(cfg, SEED, device="cuda"), cfg)
        prompts = prompts_for(2, cfg.vocab_size)[:8]

        def engine() -> ServingEngine:
            eng = ServingEngine(params, cfg, max_batch=8, n_blocks=256, block_size=64, steps_per_sched=8,
                                **engine_kw)
            for p in prompts:
                eng.submit(p, 64)
            return eng

        engine().run()  # first-call costs (kernel loads, library handles)
        eng = engine()
        if phase == "path2_chunks":
            out[phase] = _profile(lambda: [eng.step() for _ in range(4)])
            out[phase]["steps"] = 4
            out[phase]["chunk_tokens"] = eng.stats["prefill_chunk_tokens"]
        else:
            eng.step()  # admission (suffix prefills) and the first window, not profiled
            out[phase] = _profile(eng.step)
            out[phase]["steps"] = eng.steps_per_sched
        out[phase]["rows"] = len(prompts)
        del eng, params
        torch.cuda.empty_cache()
    return out


DOC_SEP = 10  # the separator of the doc-masked phase (byte "\n")
DOC_SPACING = 67  # tokens per document in that phase


def profile_train() -> Dict[str, Dict[str, object]]:
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.training import train_step as ts

    out = {}
    for phase, overrides in (
        ("train_step", {}),
        ("train_step_fused_ce_doc_mask", {"model.ce_impl": "fused", "model.doc_mask_token": DOC_SEP}),
    ):
        cfg = get_preset("gpt2-124m").with_overrides(overrides)
        state = {"state": ts.init_train_state(cfg, SEED, device="cuda")}
        step = ts.build_train_step(cfg)
        rng = np.random.default_rng(SEED + 12)
        toks = rng.integers(0, cfg.model.vocab_size, (cfg.train.batch_size, cfg.model.context_length + 1))
        if cfg.model.doc_mask_token >= 0:
            toks[rng.random(toks.shape) < 1.0 / DOC_SPACING] = DOC_SEP
        toks = torch.from_numpy(toks).cuda()
        batch = (toks[:, :-1], toks[:, 1:])

        def one() -> None:
            state["state"], metrics = step(state["state"], batch)
            float(metrics["loss"])  # the step ends when its loss reaches the host

        for _ in range(2):
            one()
        out[phase] = _profile(one)
        out[phase]["tokens"] = cfg.train.batch_size * cfg.model.context_length
        del state, step
        torch.cuda.empty_cache()
    return out


G1_NEW_TOKENS = 128  # chip_smoke.py's G1


def profile_generate() -> Dict[str, Dict[str, object]]:
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.generate import _bucket_len, generate
    from pretraining_llm_tpu_torch.models import bridge, transformer

    cfg = get_preset("gpt2-124m").model
    params = bridge.cast_params_for_inference(transformer.init_params(cfg, SEED, device="cuda"), cfg)
    rng = np.random.default_rng(SEED + 21)
    lens = rng.choice(np.arange(17, 601), size=8, replace=False).tolist()  # G1's prompt lengths
    batch = np.zeros((len(lens), max(lens)), np.int64)
    for i, n in enumerate(lens):
        batch[i, :n] = rng.integers(0, 256, n)
    bucket = _bucket_len(max(lens), cfg.context_length, G1_NEW_TOKENS)
    padded = torch.zeros((len(lens), bucket), dtype=torch.long, device="cuda")
    padded[:, :batch.shape[1]] = torch.from_numpy(batch)

    def prefill() -> None:
        cache = transformer.make_kv_cache(cfg, len(lens), bucket + G1_NEW_TOKENS, device="cuda")
        with torch.no_grad():
            logits, _ = transformer.forward(params, padded, cfg, kv_cache=cache, cache_index=0)
        logits[:, -1].argmax(-1).cpu()

    def call() -> None:
        generate(params, cfg, batch, G1_NEW_TOKENS, 0, temperature=0.0, prompt_lengths=lens).cpu()

    out = {}
    for phase, fn, tokens in (("generate_prefill", prefill, sum(lens)),
                              ("generate_call", call, len(lens) * G1_NEW_TOKENS)):
        fn()  # warm-up
        out[phase] = _profile(fn)
        out[phase]["tokens"] = tokens
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    for profile_phases in (profile_serving, profile_ragged_paths, profile_train, profile_generate):
        for phase, rec in profile_phases().items():
            print(json.dumps({"phase": phase, "device": torch.cuda.get_device_name(0), **rec}), flush=True)


if __name__ == "__main__":
    main()
