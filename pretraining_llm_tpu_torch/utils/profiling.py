"""The trainer's step-window profiler (``StepProfiler``), and where the time
goes on the card: a ``torch.profiler`` breakdown of one
admission prefill and one decode window of the serving path, of path 2's
chunked prefill and path 3's int8 decode window, of one training step, and
of one ``generate`` call at G1's shape.

Run from the repository root on a machine with a GPU::

    python -m pretraining_llm_tpu_torch.utils.profiling [serving ragged train generate reference-3b remat moe]

Serving: gpt2-124m (bf16, ``paged_attention_impl="kernel"``, random
weights from seed 0) with the engine settings ``chip_smoke.py`` uses: path
1's admission prefill and decode window (8 prompts of 17-900 tokens, the
synchronous scheduler's ``step``), and four windows of the pipelined
scheduler at depth 2 in steady state (``pipeline_tick``; with the host's
blocked time per window, from the engine's ``host_blocked_s``); path
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
``data/parity``); one step of the reference-3b preset at full size
(batch 32 x 512 in 2 microbatches, ``dots_saveable``); one step of
llama3-1b-gqa (22 layers, batch 2) under remat none, full and
dots_saveable; and one step of moe-8x350m at full size (chip_smoke M1's
batch, 32 x 1024 in 4 microbatches, ``dots_saveable``: routing, index
gathers and the experts' batched products).
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
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

class StepProfiler:
    """Capture a [start, start + n_steps) window of training steps with
    ``torch.profiler`` (host ops and, on a card, its kernels) and write it
    as a Chrome trace, ``<logdir>/trace-<start>-<stop>.json``: the
    counterpart of the JAX package's ``StepProfiler``, which writes a
    ``jax.profiler`` trace there. No ``logdir``: does nothing."""

    def __init__(self, logdir: str, start_step: int, n_steps: int) -> None:
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = start_step + n_steps
        self._prof = None

    def step(self, step: int) -> None:
        """Call before running step ``step``."""
        if not self.logdir:
            return
        if step == self.start_step and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        elif step >= self.stop_step and self._prof is not None:
            self._finish()

    def _finish(self) -> None:
        import os

        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.logdir, f"trace-{self.start_step}-{self.stop_step}.json"))

    def close(self) -> None:
        """Stop and write an open capture. Idempotent, and safe on any exit
        path: a failure here never masks the error that is propagating."""
        if self._prof is None:
            return
        try:
            self._finish()
        except Exception:
            pass


TOP_KERNELS = 12  # kernels listed per phase, by device time
SEED = 0  # weights and prompts, as in chip_smoke.py


def profile_call(fn: Callable[[], None]) -> Dict[str, object]:
    """Run ``fn`` under ``torch.profiler`` on the card: host wall time (to a
    synchronize after ``fn``), summed device kernel time, their ratio (the
    device's busy share), launches and the top kernels."""
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
    out = {"prefill": profile_call(prefill.step)}
    out["prefill"]["tokens"] = sum(len(p) for p in prompts)

    decode = engine()
    for p in prompts:
        decode.submit(p, 64)
    decode.step()  # admission + first window, not profiled
    out["decode_window"] = profile_call(decode.step)
    out["decode_window"]["steps"] = decode.steps_per_sched
    out["decode_window"]["rows"] = len(prompts)

    # The pipelined scheduler at depth 2 (the engine's default): admission
    # and the first two windows unprofiled, then four ticks (four windows
    # dispatched, four reaped) in steady state.
    piped = engine()
    for p in prompts:
        piped.submit(p, 64)
    for _ in range(3):
        piped.pipeline_tick()
    before = dict(piped.stats)
    ticks = 4
    phase = profile_call(lambda: [piped.pipeline_tick() for _ in range(ticks)])
    reaped = piped.stats["windows_reaped"] - before["windows_reaped"]
    phase.update(
        ticks=ticks, rows=len(prompts), steps=piped.steps_per_sched, pipeline_depth=piped.pipeline_depth,
        windows_dispatched=piped.stats["windows"] - before["windows"], windows_reaped=reaped,
        host_blocked_ms_per_window=(piped.stats["host_blocked_s"] - before["host_blocked_s"]) * 1e3 / max(1, reaped),
        wall_ms_per_window=phase["wall_ms"] / ticks, device_kernel_ms_per_window=phase["device_kernel_ms"] / ticks,
    )
    out["decode_window_depth2"] = phase
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
            out[phase] = profile_call(lambda: [eng.step() for _ in range(4)])
            out[phase]["steps"] = 4
            out[phase]["chunk_tokens"] = eng.stats["prefill_chunk_tokens"]
        else:
            eng.step()  # admission (suffix prefills) and the first window, not profiled
            out[phase] = profile_call(eng.step)
            out[phase]["steps"] = eng.steps_per_sched
        out[phase]["rows"] = len(prompts)
        del eng, params
        torch.cuda.empty_cache()
    return out


DOC_SEP = 10  # the separator of the doc-masked phase (byte "\n")
DOC_SPACING = 67  # tokens per document in that phase


def _profile_train_step(preset: str, overrides: Dict[str, object]) -> Dict[str, object]:
    """One ``build_train_step`` step of ``preset`` after two warm-up steps,
    on random tokens (document separators at T3's density when the model
    masks documents)."""
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.training import train_step as ts

    cfg = get_preset(preset).with_overrides(overrides)
    torch.cuda.reset_peak_memory_stats()
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
    out = profile_call(one)
    out["tokens"] = cfg.train.batch_size * cfg.model.context_length
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state, step
    torch.cuda.empty_cache()
    return out


def profile_train() -> Dict[str, Dict[str, object]]:
    return {
        "train_step": _profile_train_step("gpt2-124m", {}),
        "train_step_fused_ce_doc_mask": _profile_train_step(
            "gpt2-124m", {"model.ce_impl": "fused", "model.doc_mask_token": DOC_SEP}),
    }


def profile_reference_3b() -> Dict[str, Dict[str, object]]:
    """The source's reference-3b at full size: batch 32 x 512 in 2
    microbatches (chip_smoke T4's fit), its dots_saveable remat, bf16
    compute, fp32 params and AdamW."""
    return {"train_step_reference_3b": _profile_train_step("reference-3b", {"train.microbatches": 2})}


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
        out[phase] = profile_call(fn)
        out[phase]["tokens"] = tokens
    return out


def profile_remat() -> Dict[str, Dict[str, object]]:
    """chip_smoke R's model (llama3-1b-gqa, 22 layers, batch 2 x 2048) one
    step under remat none, full and dots_saveable: how the selective
    policy's dispatch-level recompute shows in the busy share."""
    return {f"train_step_llama3_1b_gqa_{policy}": _profile_train_step(
        "llama3-1b-gqa", {"train.batch_size": 2, "model.remat": policy})
        for policy in ("none", "full", "dots_saveable")}


def profile_moe() -> Dict[str, Dict[str, object]]:
    """moe-8x350m at full size at chip_smoke M1's fit: batch 32 x 1024 in 4
    microbatches, its dots_saveable remat, bf16 compute, fp32 params and
    AdamW."""
    return {"train_step_moe_8x350m": _profile_train_step("moe-8x350m", {"train.microbatches": 4})}


PHASES = {"serving": profile_serving, "ragged": profile_ragged_paths, "train": profile_train,
          "generate": profile_generate, "reference-3b": profile_reference_3b, "remat": profile_remat,
          "moe": profile_moe}


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="torch.profiler breakdowns on the card")
    parser.add_argument("phases", nargs="*", default=list(PHASES), choices=list(PHASES),
                        help="which phases to profile (default: all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    for name in args.phases:
        for phase, rec in PHASES[name]().items():
            print(json.dumps({"phase": phase, "device": torch.cuda.get_device_name(0), **rec}), flush=True)


if __name__ == "__main__":
    main()
