#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pretraining_llm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pretraining_llm_tpu_torch/csrc``
(one ``nvcc`` per source, all started together), holds each against its
plain PyTorch version at the serving and training paths' shapes (the
flash kernels with and without document segments, the flash backward also
through ``FlashAttention`` gradients, the fused CE kernels also through
``FusedCE`` gradients against a dense head, the fp32 CE route at D 1024
and 2048), holds each kernel on operands one element off an aligned
address against the aligned call bit for bit, holds 2-layer models on the
card against the same models on the CPU (a mixture-of-experts model at
moe-8x350m's widths: loss, gradients, logits, routing decisions and
greedy ``generate``; the monolithic admission with
paged decode; the chunked suffix lane with an exact and an int8-kv pool;
three AdamW steps of a gpt2-width and a GQA model, each with the chunked
head and again with the fused CE head and document masking; ``generate``
on a ragged batch with an exact and an int8 dense cache, and a chunked
prefill at a nonzero cache index), checks that documents stay isolated on
the card, then drives three serving paths, four training runs and the
sample/evaluate/preprocess path, counting each kernel's launches on each:

  path 1  16 requests, ``ServingEngine.submit/run`` on full-width
          gpt2-124m, monolithic admission prefill (flash kernel) and paged
          decode (paged kernel);
  path 2  16 requests sharing two 384-token system prompts, chunked
          prefill (256-token chunks) and the prefix cache: chunks and
          prefix-cache suffixes through the ragged kernel, decode through
          the paged kernel;
  path 3  the same requests arriving two per scheduler step under
          ``quantize="int8-kv"`` with the prefix cache: every attention
          (suffix prefill and decode) through the ragged kernel on int8
          pools, with the auto KV-split count;
          (paths 1 and 2 run the synchronous scheduler,
          ``run(pipeline=False)``, path 3 ``step()``)
  path 4  path 1's requests through the pipelined scheduler, ``run()`` at
          the engine's defaults (depth 2), at depth 1, at depth 3 and at
          depth 2 with ``admit_batch=4``, beside a synchronous run: every
          decode dispatch under ``torch.cuda.set_sync_debug_mode("error")``,
          each run's streams against path 1's up to each row's first near
          tie, windows, flushes, host-blocked seconds per window, tokens/s
          and the profiled busy share; then 4 requests on the unfused lane
          (``fused_sampling=False``), token for token the fused streams;
  checksum
          path 2's workload with ``kv_checksum=True`` (path 2's streams),
          then one byte of a published page flipped: the request that hits
          it drops the page, prefills privately and gives the stream of the
          same request on a fresh engine;
  path 5  after T1: speculative serving (``spec_k=4``, depth 2) of 8 corpus
          lines on gpt2-124m with T1's step-30 weights and a draft of its
          first 2 blocks, against target-only serving up to near ties, K2's
          verify at T = 5 on the split route once per layer per round; then
          llama3-1b-gqa at its 22 layers (random weights, 8 requests of
          64-400 tokens, 32 new tokens), whose verify (20 query rows per KV
          head) takes K2's loop route;
  serve   ``python -m pretraining_llm_tpu_torch.serve`` as a subprocess on
          the same checkpoint and prompts, without and with the draft: the
          JSONL outputs are path 5's streams decoded;
  T1      ``Trainer.train`` on gpt2-124m at full width and depth (batch
          12, T 1024, bf16 compute) for 30 steps on ``data/parity``
          bytes: flash forward and the one-pass backward kernel; held
          against a naive-attention run, then a checkpoint round trip that
          must restore every state leaf and the data RNG, and the next
          step's loss, bit for bit;
  G1      right after T1, on its step-30 checkpoint: the source's sample,
          evaluate and preprocess entry points. ``load_model_for_inference``
          + ``cast_params_for_inference``, then ``generate`` and
          ``generate_text_batch`` of 8 corpus prompts (17-600 bytes, byte
          tokenizer), 128 greedy tokens, one with a stop token a row emits:
          K1 once per layer per call (tensor cores), decode over the dense
          cache in torch ops; every token held against one uncached
          forward; ``evaluate`` bit for bit against the ``Trainer``'s (numpy
          sampler), and the default ``Trainer``'s against the eval loop on
          the native batcher's batches; a
          vocab-512 BPE trained on the corpus and ``preprocess`` into
          ``build/`` with the native encoder;
  T2      ``Trainer.train`` on llama3-1b-gqa cut to 4 layers (T 2048, Dh
          128, 4 KV heads) for 10 steps on synthetic data: flash forward
          and the dQ + dK/dV kernels; held against a naive-attention run;
  parity  the repo's golden run (``data/parity``: init weights, corpus
          and the JAX package's recorded 1500-step curve and eval loss)
          trained on the card at fp32 through the flash kernels;
  T3      ``Trainer.train`` on gpt2-124m at full width and depth (batch
          12, T 1024, bf16 compute) with ``ce_impl="fused"`` and
          ``doc_mask_token=10`` for 20 steps on ``data/parity`` bytes: the
          fused CE kernels (forward, dH, dW) once each per step, flash
          forward and one-pass backward with document segments; its
          losses and every parameter's gradient held against its
          all-torch-ops twin (chunked head, naive attention) on T3's own
          states;
  T4      ``Trainer.train`` on each single-card preset T1-T3 do not run,
          at full width and depth with its own remat policy (bf16
          compute, fp32 params, AdamW, synthetic data, no checkpoints), 4
          steps at the preset's global batch: gpt2-350m-dp (none, 32 x
          1024), gpt2-1p3b-fsdp (dots_saveable, 64 x 1024 in microbatches),
          llama-1b (dots_saveable, 32 x 2048, Dh 128 MHA: dQ + dK/dV) and
          the source's reference-3b (dots_saveable, 32 x 512, ReLU, no
          output projection, biased head). Each runs as the microbatches
          it is first given, or twice as many after an out-of-memory error
          or a peak at 80 GB or more, and prints them with step ms,
          tokens/s, MFU, peak memory, losses and launches; the launches
          must be the exact counts of the one-pass or split backward on
          the tensor cores, K1 twice a layer where the policy recomputes it;
  M1      ``Trainer.train`` on moe-8x350m at full width and depth (24
          layers, d 1024, 8 experts, top-2, 1.77B params, 0.56B active),
          4 steps at 32 x 1024 in the microbatches that fit: step ms,
          tokens/s, MFU on the active FLOPs, peak memory, the router's aux
          term per step, dropped (token, choice) pairs per layer at step
          1, exact K1 and one-pass launches; then ``generate`` (8 prompts
          of 256 tokens, 64 greedy tokens) and ``evaluate`` (4 batches)
          from its weights, and 8 cached greedy steps (nothing dropped)
          against one uncached forward of the same tokens;
  R       the remat sweep: llama3-1b-gqa at its 22 layers, batch 2 x
          2048, under each of the seven policies from one init: step-1 loss
          and every gradient leaf against remat none's (the bf16 bar; bit
          equality reported), then 3 steps: step ms, peak memory, K1
          launches per step (22, or 44 under full, dots_saveable and
          save_attn); full's peak below none's;
  O       gpt2-124m at full size, 10 steps under AdamW, Adafactor and
          Muon: finite, falling losses; then the trainer's options on a
          2-layer gpt2-width model: ``checkpoint_async`` (the step-3
          checkpoint and a resume from it bit for bit as the synchronous
          run), ``profile_dir`` (a trace of steps 1-2 naming K1),
          ``debug_nans`` (a NaN weight raises ``FloatingPointError``) and a
          3:1 mixture of ``data/parity``'s files with ``data.prefetch=2``
          (the batches the steps got equal the unprefetched iterator's);
  D1      the drills: gpt2-124m at full width and depth (T1's model and
          data, through the native batcher), 32 steps with a log line every
          4 and a checkpoint every 8, anomaly detection, a 10 s watchdog
          and telemetry on: a clean run of the train CLI; the same command
          under the port's supervisor with SIGTERM after step 12 and a hang
          after step 20 (children exit 43, 45, 0; the final state the clean
          run's bit for bit); a NaN after step 10 rolled back to step 8; a
          torn step-16 checkpoint a resume falls back past, whose next two
          log windows run under ``torch.cuda.set_sync_debug_mode("error")``
          between log boundaries; the event streams' goodput, the
          Prometheus textfile's lint and the Chrome trace. The CLI children
          run ``python3 chip_smoke.py --d1-child COUNTS <train arguments>``,
          which records each child's kernel launches.

The flash forward (K1) and the three backward kernels (one pass, dQ,
dK/dV) have two routes: bf16 runs the tensor-core kernels
(``csrc/flash_fwd_tc.cu``, ``csrc/flash_bwd_tc.cu``: wgmma fed by TMA),
fp32 the CUDA-core ones. Each path's launch counts name the route it took
(``<kernel>_tc``, ``<kernel>_fp32``), and the script asserts them: path 1,
T1, T2 and T3 run the tensor-core K1, T1 and T3 the tensor-core one pass,
T2 the tensor-core dQ and dK/dV, the parity run (fp32) the CUDA-core
kernels only. Every bf16 backward kernel must give the same bits on a
repeat launch (the tensor-core one pass sums dQ in a fixed order).

The ragged kernel has two routes too, chosen by ``ragged_route``: bf16
queries run ``csrc/ragged_paged_tc.cu`` (wgmma fed by a TMA ring of
pages), fp32 queries ``csrc/ragged_paged.cu``. ``check_ragged`` logs each
case's route and asserts it, and every bf16 case must give the same bits
on a repeat launch; paths 2 and 3 must run the tensor-core kernel only
(``ragged_wgmma`` / ``ragged_fp32`` in their launch counts). The ragged
entries of the kernels line give the CUDA-core kernel's time on the same
inputs after "was", and a ``ragged_split_sweep`` line per timed shape
holds one pass against 2 and 4 partitions in alternated launches.

The paged decode kernel (K2) has two routes, chosen by ``paged_route``:
Dh 64 or 128 with 64-slot pages and at most 16 query rows per KV head run
the split page stream (``paged_split``: each row's table cut into
partitions, one block each, merged in partition order by the last block
inside the launch), other shapes the one-block-per-row loop
(``paged_loop``). ``check_paged`` logs and asserts each case's route, and
every split case must give the same bits on a repeat launch; paths 1, 2
and 4 must decode through the split route only; path 5's llama3-1b-gqa
verify (T 5) through the loop route, which two ``check_paged`` cases hold
at its shape (H 16, G 4, T 5, Dh 128). The fused CE forward (B9)
takes ``csrc/fused_ce_tc.cu`` (wgmma fed by a TMA ring, the vocabulary cut
into partitions merged by the last block of each token tile) for bf16
and ``csrc/fused_ce.cu`` for fp32 (``ce_route``; ``fused_ce_fwd_wgmma`` /
``fused_ce_fwd_fp32``): ``check_ce`` asserts the route and a bit-identical
repeat bf16 forward for every case, and T3 asserts all 20 forward launches
on the tensor cores. dH and dW (B10, B11) take ``csrc/fused_ce_bwd_tc.cu``
for bf16 (wgmma fed by a TMA ring, the output in D-chunks, the walked axis
in partitions merged in order by the last block; ``ce_bwd_plan``) and
``csrc/fused_ce.cu`` for fp32 (``ce_bwd_route``; ``fused_ce_dh_wgmma`` /
``_fp32``, the same for dw): ``check_ce`` asserts their routes and
bit-identical repeat bf16 launches for every case, holds a bf16
``FusedCE`` at llama3-1b-gqa's head (D 2048, V 32000) against the plain
versions, and T3 asserts all 20 dH and dW launches on the tensor cores.
The K2 and B9-B11 entries of the kernels line give the earlier kernel's
time on the same inputs after "was"; B10 and B11 also give their plan, a
sweep of chunk widths and partition counts, and ptxas's registers.

It times every kernel beside its plain version, a PyTorch library call and
its bound, and prints:

    <the card's name and power limit, as nvidia-smi reports them>
    ...one line per phase...
    {"kernels": [...]}
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Any failed check raises, and the script exits non-zero without the last
line. With no CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Tolerances of the kernel checks (inputs N(0, 1)). An fp32 output, and the
# fp32 logsumexp in either dtype, differs from the plain version only in
# summation order: max-abs <= 1e-4. A bf16 output is rounded to bf16 (and P
# to bf16 before PV) in both, so a rounding flip is one ulp of the value:
# within each output row (one query of one head, over Dh) the max-abs error
# must be <= 2^-6 times that row's largest |reference|, i.e. 2 to 4 bf16
# ulps of it. A fixed bf16 limit would leave no headroom on rows of large
# outputs and be loose on long rows, whose outputs are small.
FP32_TOL = 1e-4
AMLA_FP32_TOL = 2e-4  # AMLA's integer-quantized base-2 running max (the JAX bar)
BF16_ROW_RTOL = 2.0**-6
MODEL_TOL = 1e-3  # fp32 logits, 2-layer model, card vs CPU
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SEED = 0
DEVICE = "cuda"  # the card; the phases take their tensors from here
ROOT = Path(__file__).resolve().parent
PARITY_DIR = ROOT / "data" / "parity"
SCRATCH = ROOT / "build" / "chip_smoke"  # git-ignored; the train paths' checkpoints, removed at the end

# Training bars. Card vs CPU at fp32 (TF32 off): losses within 1e-4
# relative, first-step gradients within 1e-3 of each leaf's largest |g|
# (summation order, and the fp32 one-pass kernel's atomic dQ sum). Flash-kernel
# runs vs naive-attention runs on the card at bf16 compute: every compared
# step's loss within 0.05. The parity run vs the JAX package's recorded
# curve: 0.02 at every logged step, 0.01 on the final eval loss.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
NAIVE_LOSS_TOL = 0.05
ISOLATION_TOL = 1e-6  # other documents' fp32 logits when one document changes
PARITY_LOSS_TOL = 0.02
PARITY_EVAL_TOL = 0.01


def log(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, sort_keys=True), flush=True)


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen).to(device=DEVICE, dtype=dtype)


def time_ms(fn, *, n=25, warmup=5, flush=None, device_only=False) -> float:
    """Median of ``n`` launches, each between two CUDA events, after a
    warm-up; ``flush`` (outside the events) evicts the L2 cache first. The
    events also hold whatever host time the wrapper spends before its launch
    reaches the card; ``device_only`` first queues a ~1 ms spin on the card,
    so that the launch is queued before the start event fires and only
    device time is counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if flush is not None:
            flush()
        if device_only:
            torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def tol_use(out: torch.Tensor, ref: torch.Tensor, fp32_tol: float = FP32_TOL) -> float:
    """The largest error over its limit (the check passes at <= 1): fp32
    against ``fp32_tol``, bf16 per row of the last axis against
    BF16_ROW_RTOL times the row's largest |ref|."""
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        return err.max().item() / fp32_tol
    limit = BF16_ROW_RTOL * ref.float().abs().amax(dim=-1, keepdim=True)
    return (err / limit.clamp_min(1e-30)).max().item()


DOC_SEP = 10  # byte "\n": the document separator of the doc-masked runs (model.doc_mask_token)


def parity_segments(b: int, t: int, seed: int) -> torch.Tensor:
    """(B, T) int32 document ids of B windows of ``data/parity/train.bin``
    split at DOC_SEP, as the model derives them (separators strictly
    before each token: a separator ends its document)."""
    data = np.memmap(PARITY_DIR / "train.bin", dtype=np.uint16, mode="r")
    starts = np.random.default_rng(seed).integers(0, len(data) - t, size=b)
    sep = (np.stack([data[i:i + t] for i in starts]) == DOC_SEP).astype(np.int32)
    return torch.from_numpy(np.cumsum(sep, axis=1) - sep).to(device=DEVICE, dtype=torch.int32).contiguous()


def segment_summary(seg) -> object:
    """Documents per row and the shortest and longest, for the log."""
    if seg is None:
        return None
    docs = [torch.unique_consecutive(row, return_counts=True)[1] for row in seg.cpu()]
    return {"docs_per_row": [len(c) for c in docs], "min_len": min(int(c.min()) for c in docs),
            "max_len": max(int(c.max()) for c in docs)}


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(out, flush=True)
    return out


PTXAS: dict = {}  # source -> {mangled entry: [ptxas lines]}, from phase_build


def phase_build() -> None:
    from pretraining_llm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    log("build", seconds=round(time.perf_counter() - t0, 3),
        per_source={name: secs for name, (secs, _) in built.items()})
    for name, (_, text) in built.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif any(w in line for w in ("registers", "spill", "warning", "Performance", "C75")):
                print(f"ptxas[{name}] {entry}: {line.strip()}", flush=True)
                PTXAS.setdefault(name, {}).setdefault(entry, []).append(line.strip())


def check_flash() -> float:
    from pretraining_llm_tpu_torch.ops import cuda_flash

    gen = torch.Generator().manual_seed(SEED)
    cases = [  # (B, H, G, T, Dh, window, dtype, document segments)
        (2, 12, 12, 512, 64, 0, torch.bfloat16, False), (2, 12, 12, 1024, 64, 0, torch.bfloat16, False),
        (2, 12, 12, 512, 64, 0, torch.float32, False), (2, 12, 12, 1024, 64, 0, torch.float32, False),
        (2, 16, 4, 512, 64, 0, torch.bfloat16, False),  # GQA
        (2, 12, 12, 1024, 64, 256, torch.bfloat16, False),  # sliding window
        (1, 4, 2, 200, 64, 0, torch.float32, False),  # T not a multiple of the 64-row tile
        (1, 16, 4, 300, 128, 0, torch.bfloat16, False), (1, 16, 4, 300, 128, 0, torch.float32, False),  # Dh 128
        (4, 8, 8, 256, 32, 0, torch.float32, False), (4, 8, 8, 256, 32, 0, torch.bfloat16, False),  # Dh 32
        (2, 12, 12, 1024, 64, 0, torch.bfloat16, True), (2, 12, 12, 1024, 64, 0, torch.float32, True),
        (2, 16, 4, 512, 64, 200, torch.bfloat16, True),  # segments, GQA, window
        (1, 4, 2, 200, 64, 0, torch.float32, True), (1, 16, 4, 300, 128, 0, torch.bfloat16, True),
        # The tensor-core kernel's tile edges (64-row tiles, 64-key tiles): T of
        # 832 (serving's), 200 and 1000, Dh 32/64/128, n_rep 4, windows of 200
        # and 256 with and without segments.
        (1, 12, 12, 832, 64, 0, torch.bfloat16, False), (1, 4, 2, 200, 64, 0, torch.bfloat16, False),
        (1, 16, 4, 1000, 128, 0, torch.bfloat16, False), (2, 8, 8, 200, 32, 0, torch.bfloat16, False),
        (2, 8, 2, 1000, 64, 200, torch.bfloat16, False), (2, 8, 2, 1000, 64, 200, torch.bfloat16, True),
        (1, 16, 4, 832, 128, 256, torch.bfloat16, False), (1, 16, 4, 832, 128, 256, torch.bfloat16, True),
        (2, 8, 2, 1000, 32, 256, torch.bfloat16, True), (1, 16, 4, 200, 128, 200, torch.bfloat16, True),
        # M1's shapes (moe-8x350m, MHA): a training microbatch, and its
        # generate's prefill of 8 prompts of 256 tokens.
        (8, 16, 16, 1024, 64, 0, torch.bfloat16, False), (8, 16, 16, 256, 64, 0, torch.bfloat16, False),
    ]
    worst = 0.0
    fwd = cuda_flash.flash_attention_fwd
    for b, h, g, t, d, window, dtype, seg_on in cases:
        q = randn((b * h, t, d), dtype, gen)
        k = randn((b * g, t, d), dtype, gen)
        v = randn((b * g, t, d), dtype, gen)
        seg = parity_segments(b, t, SEED + b * t) if seg_on else None
        before = (fwd.launches_tc, fwd.launches_fp32)
        o, lse = cuda_flash.flash_attention_fwd(q, k, v, h, g, window=window, segments=seg)
        ran = (fwd.launches_tc - before[0], fwd.launches_fp32 - before[1])
        if ran != ((1, 0) if dtype == torch.bfloat16 else (0, 1)):
            raise AssertionError(f"flash forward at {dtype} ran (tensor-core, fp32) = {ran}")
        o_ref, lse_ref = cuda_flash.flash_attention_fwd_reference(q, k, v, h, g, window=window, segments=seg)
        torch.cuda.synchronize()
        err = max(max_err(o, o_ref), max_err(lse, lse_ref))
        use = max(tol_use(o, o_ref), tol_use(lse, lse_ref))
        log("check_flash", B=b, H=h, G=g, T=t, Dh=d, window=window, dtype=str(dtype),
            route=cuda_flash.kernel_route(dtype, d), segments=segment_summary(seg), max_abs_err=err, tol_use=use)
        if not (use <= 1.0):
            raise AssertionError(f"flash kernel disagrees with its plain version: {use} x its limit")
        worst = max(worst, err)
    return worst


def row_tol_use(out: torch.Tensor, ref: torch.Tensor, rtol: float) -> float:
    """The largest error over its limit (passes at <= 1), per row of the
    last axis: ``rtol`` times the row's largest |ref|, floored at 2^-8 of
    the whole output's largest |ref| (rows that cancel to ~0, such as the
    first query's dQ, are held at that floor)."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    row = ref.abs().amax(dim=-1, keepdim=True).clamp_min(2.0**-8 * ref.abs().max().item())
    return (err / (rtol * row).clamp_min(1e-30)).max().item()


# Backward limits: fp32 1e-4 of each output row's largest |reference|
# (summation order, and the fp32 one-pass kernel's atomic dQ sum); bf16
# 2^-6 of it (both round dS and P to bf16 at the same points; a sum in
# another order flips a rounding: 1 to 4 ulps of the row's largest value).
BWD_FP32_RTOL = 1e-4
GRAD_TOL = 1e-4  # FlashAttention vs autograd through naive attention, fp32 max-abs
BWD_CASES = [  # (B, H, G, T, Dh, window, dtype, block_q, block_kv, document segments)
    (2, 12, 12, 1024, 64, 0, torch.bfloat16, 0, 0, False),     # gpt2-124m: one pass
    (1, 12, 12, 1024, 64, 0, torch.float32, 0, 0, False),
    (1, 8, 4, 512, 64, 0, torch.bfloat16, 0, 0, False),        # GQA n_rep 2, one pass
    (1, 8, 4, 512, 64, 0, torch.float32, 128, 128, False),     # GQA n_rep 2, split
    (1, 16, 4, 2048, 128, 0, torch.bfloat16, 0, 0, False),     # llama3-1b-gqa: n_rep 4, split
    (1, 16, 4, 2048, 128, 0, torch.float32, 0, 0, False),
    (1, 12, 12, 1024, 64, 256, torch.bfloat16, 0, 0, False),   # window, one pass
    (1, 8, 2, 1024, 64, 200, torch.float32, 256, 256, False),  # window, n_rep 4, split
    (2, 8, 8, 256, 32, 0, torch.float32, 0, 0, False),         # Dh 32 (the parity model)
    (2, 8, 8, 256, 32, 0, torch.bfloat16, 64, 64, False),      # Dh 32, split
    (1, 8, 8, 300, 128, 0, torch.bfloat16, 0, 0, False),       # T not a multiple of 64, one pass
    (1, 4, 2, 200, 64, 0, torch.float32, 100, 100, False),     # ... split
    (2, 12, 12, 1024, 64, 0, torch.bfloat16, 0, 0, True),      # segments, one pass
    (1, 12, 12, 1024, 64, 0, torch.float32, 0, 0, True),
    (1, 8, 4, 512, 64, 0, torch.float32, 128, 128, True),      # segments, GQA, split
    (1, 8, 2, 1024, 64, 200, torch.bfloat16, 256, 256, True),  # segments, window, split
    (1, 8, 8, 300, 128, 0, torch.float32, 0, 0, True),         # segments, ragged T, one pass
    # The tensor-core dK/dV kernel's tile edges (split: blocks below T).
    (1, 12, 12, 832, 64, 0, torch.bfloat16, 64, 64, False),    # serving's T
    (1, 4, 2, 200, 64, 0, torch.bfloat16, 100, 100, False),    # T 200
    (1, 16, 4, 1000, 128, 0, torch.bfloat16, 200, 200, False),  # T 1000, Dh 128, n_rep 4
    (1, 8, 2, 1000, 32, 200, torch.bfloat16, 200, 200, False),  # Dh 32, window 200, n_rep 4
    (1, 8, 2, 1000, 64, 200, torch.bfloat16, 200, 200, True),   # window 200 + segments
    (1, 16, 4, 832, 128, 256, torch.bfloat16, 64, 64, False),   # window 256
    (1, 16, 4, 832, 128, 256, torch.bfloat16, 64, 64, True),    # window 256 + segments
    (2, 8, 8, 200, 32, 0, torch.bfloat16, 100, 100, True),      # Dh 32, T 200, segments
    # The tensor-core one pass's edges (one block: T within 1024): T not a
    # multiple of 64, Dh 128 with n_rep 2 and 4, Dh 32 with a window of 200
    # and n_rep 4, serving's T with segments, a window of 256 with segments.
    (1, 8, 4, 300, 128, 0, torch.bfloat16, 0, 0, True),         # T 300, Dh 128, n_rep 2, segments
    (1, 16, 4, 1000, 128, 0, torch.bfloat16, 0, 0, False),      # T 1000, Dh 128, n_rep 4
    (1, 8, 2, 1000, 32, 200, torch.bfloat16, 0, 0, False),      # Dh 32, window 200, n_rep 4
    (1, 12, 12, 832, 64, 0, torch.bfloat16, 0, 0, True),        # T 832, segments
    (1, 16, 4, 832, 128, 256, torch.bfloat16, 0, 0, True),      # window 256 + segments, n_rep 4
    # The T4 presets' MHA shapes at Dh 128 (n_rep 1).
    (1, 16, 16, 1024, 128, 0, torch.bfloat16, 0, 0, False),     # gpt2-1p3b-fsdp: one pass
    (1, 16, 16, 512, 128, 0, torch.bfloat16, 0, 0, False),      # reference-3b: one pass
    (1, 16, 16, 2048, 128, 0, torch.bfloat16, 0, 0, False),     # llama-1b: split
    (8, 16, 16, 1024, 64, 0, torch.bfloat16, 0, 0, False),      # M1's microbatch (moe-8x350m): one pass
]


def check_flash_bwd() -> None:
    """The three backward kernels against ``flash_attention_bwd_reference``
    on the card (dq, dk, dv), with K1 giving the residuals; every bf16 case
    must run the tensor-core kernels and every fp32 case the CUDA-core ones,
    and every case must give the same bits on a repeat launch (the fp32 one
    pass too: its dQ partials are summed in key-tile order). Then
    ``FlashAttention`` gradients in fp32 against autograd through the
    port's ``naive_attention``. The kernels line reports each kernel's
    error at its training path's shape (``time_train_kernels``)."""
    from pretraining_llm_tpu_torch.ops import cuda_flash
    from pretraining_llm_tpu_torch.ops.attention import naive_attention
    from pretraining_llm_tpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator().manual_seed(SEED + 9)
    counters = (cuda_flash.flash_bwd_fused, cuda_flash.flash_bwd_dq, cuda_flash.flash_bwd_dkv)
    for b, h, g, t, d, window, dtype, bq, bk, seg_on in BWD_CASES:
        q, do = randn((b * h, t, d), dtype, gen), randn((b * h, t, d), dtype, gen)
        k, v = randn((b * g, t, d), dtype, gen), randn((b * g, t, d), dtype, gen)
        seg = parity_segments(b, t, SEED + 9 + b * t) if seg_on else None
        o, lse = cuda_flash.flash_attention_fwd(q, k, v, h, g, window=window, segments=seg)
        before = [(f.launches, f.launches_tc, f.launches_fp32) for f in counters]
        got = cuda_flash.flash_attention_bwd(q, k, v, o, lse, do, h, g, window=window, block_q=bq,
                                             block_kv=bk, segments=seg)
        ran = [tuple(x - y for x, y in zip((f.launches, f.launches_tc, f.launches_fp32), n))
               for f, n in zip(counters, before)]
        ref = cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g, window=window, segments=seg)
        torch.cuda.synchronize()
        rtol = BWD_FP32_RTOL if dtype == torch.float32 else BF16_ROW_RTOL
        uses = {n: row_tol_use(x, y, rtol) for n, x, y in zip(("dq", "dk", "dv"), got, ref)}
        errs = {n: max_err(x, y) for n, x, y in zip(("dq", "dk", "dv"), got, ref)}
        one_pass = cuda_flash.backward_is_one_pass(t, bq, bk)
        # No unordered sums on either route: a second launch gives the same bits.
        delta = (do.float() * o.float()).sum(-1)
        if one_pass:
            again = cuda_flash.flash_bwd_fused(q, k, v, do, lse, delta, h, g, window=window, segments=seg)
        else:
            again = (cuda_flash.flash_bwd_dq(q, k, v, do, lse, delta, h, g, window=window, segments=seg),
                     *cuda_flash.flash_bwd_dkv(q, k, v, do, lse, delta, h, g, window=window, segments=seg))
        same = all(torch.equal(x, y) for x, y in zip(again, got))
        log("check_flash_bwd", B=b, H=h, G=g, T=t, Dh=d, window=window, dtype=str(dtype),
            block_q=bq, block_kv=bk, segments=segment_summary(seg),
            kernels="one pass" if one_pass else "dq + dkv", route=cuda_flash.kernel_route(dtype, d),
            max_abs_err=errs, tol_use=uses, rtol=rtol, repeat_bit_identical=same)
        launched = [r[0] for r in ran]
        if launched != ([1, 0, 0] if one_pass else [0, 1, 1]):
            raise AssertionError(f"backward launched {launched} (fused, dq, dkv) for one_pass={one_pass}")
        want_route = [(n, n, 0) if dtype == torch.bfloat16 else (n, 0, n) for n in launched]
        if ran != want_route:
            raise AssertionError(f"backward at {dtype} ran (all, tensor-core, fp32) = {ran} per kernel")
        if not all(u <= 1.0 for u in uses.values()):
            raise AssertionError(f"flash backward disagrees with its plain version: {uses}")
        if not same:
            raise AssertionError(f"{dtype} backward differs between two launches on the same inputs (T {t}, Dh {d})")

    # Gradients of the autograd Function (fp32) against autograd through the
    # plain masked attention, one pass and split: max-abs within GRAD_TOL
    # (gradients of N(0, 1) inputs are O(1) to O(10); the two differ in
    # summation order and in D = rowsum(dO*O) against the softmax VJP's
    # rowsum(P*dP)).
    for b, t, h, g, d, window, blocks, seg_on in ((2, 256, 8, 4, 64, 0, 0, False), (1, 512, 8, 2, 32, 100, 128, False),
                                                  (2, 256, 8, 4, 64, 0, 0, True), (2, 512, 8, 2, 32, 0, 128, True)):
        q, k, v = (randn((b, t, n, d), torch.float32, gen).requires_grad_(True) for n in (h, g, g))
        do = randn((b, t, h, d), torch.float32, gen)
        seg = parity_segments(b, t, SEED + 12 + b * t) if seg_on else None
        flash_attention(q, k, v, window=window, block_q=blocks, block_kv=blocks, segments=seg).backward(do)
        got = [x.grad.clone() for x in (q, k, v)]
        for x in (q, k, v):
            x.grad = None
        naive_attention(q, k, v, causal=True, window=window, segments=seg).backward(do)
        errs = {n: max_err(x, y.grad) for n, x, y in zip(("dq", "dk", "dv"), got, (q, k, v))}
        uses = {n: e / GRAD_TOL for n, e in errs.items()}
        log("check_flash_grad", B=b, T=t, H=h, G=g, Dh=d, window=window, blocks=blocks,
            segments=segment_summary(seg), max_abs_err=errs, tol=GRAD_TOL, tol_use=uses)
        if not all(u <= 1.0 for u in uses.values()):
            raise AssertionError(f"FlashAttention gradients disagree with autograd through naive: {uses}")


# Fused CE checks. Loss and lse: within CE_LOSS_TOL of max(1, |reference|)
# (fp32 stats from the same operands; summation order only). dH and dW:
# bf16 per output row (of the (S, D) and (V, D) outputs) at BF16_ROW_RTOL
# with row_tol_use's floor (both round p~ to bf16 at the same point, then
# the output; a sum in another order flips a rounding), fp32 max-abs
# FP32_TOL. FusedCE against autograd through a dense head: fp32, each
# gradient within CE_GRAD_RTOL of its largest |value|.
T1_HEAD = (12 * 1024, 768, 50304)  # (S, D, V) of T1's and T3's CE head: batch 12 x 1024 tokens, gpt2-124m
CE_LOSS_TOL = 1e-4
CE_GRAD_RTOL = 1e-4
CE_CASES = [  # (S, D, V, dtype[, labels in the last 256-column tile]): token and vocabulary tails, V = 50257
    (300, 768, 200, torch.float32), (300, 768, 200, torch.bfloat16),
    (300, 256, 384, torch.float32), (300, 256, 384, torch.bfloat16),
    (1000, 768, 50257, torch.float32), (1000, 768, 50257, torch.bfloat16),
    # The bf16 forward's edges (fused_ce_tc.cu: 128-token tiles, 256-column
    # vocabulary tiles, D streamed in 64-column slices): D 64 with V under
    # one tile, D 1024, labels in the tail tile.
    (300, 64, 200, torch.bfloat16), (1000, 1024, 50257, torch.bfloat16),
    (257, 768, 50257, torch.bfloat16, True), (129, 128, 1000, torch.bfloat16, True),
    # The bf16 dH and dW edges (fused_ce_bwd_tc.cu: 128-row output tiles and
    # walked tiles, D-chunks of 128-256 columns, partitions): D 2048 (8
    # chunks, llama3-1b-gqa's head), D 320 (a last chunk of 64 columns) with
    # token and vocabulary tails, V under one walked tile, dW in 7
    # partitions (S 2500); D 1024 above runs dH in 4 partitions, V 50257
    # and labels in the tail tile at D 768.
    (300, 2048, 32000, torch.bfloat16), (136, 320, 300, torch.bfloat16, True),
    (200, 192, 100, torch.bfloat16, True), (2500, 256, 1000, torch.bfloat16),
    # The fp32 kernels stream D: D 320 takes 64-column output chunks (the
    # wide ones are FP32_WIDE).
    (136, 320, 300, torch.float32, True),
]
# The fp32 route past the widths it once kept whole in shared memory:
# moe-8x350m's D 1024 and D 2048 at GPT-2's V 50304, with a ragged last
# token tile (1000 = 31 x 32 + 8) and labels in the last vocabulary tile;
# compared (the CE_CASES bars, a repeat launch) and timed by time_fp32_ce.
FP32_WIDE = ((1000, 1024, 50304), (1000, 2048, 50304))  # (S, D, V)
LLAMA_HEAD = (2048, 2048, 32000)  # (S, D, V): one llama3-1b-gqa sequence at its untied head


def ce_inputs(s, d, v, dtype, gen, tail_labels=False):
    """h ~ N(0, 1) (S, D), W (V, D) ~ N(0, 0.05^2), labels uniform in [0, V)
    (or in the last 256-column tile), and a non-uniform per-token cotangent
    (0.5 to 2)."""
    h = randn((s, d), dtype, gen)
    w_vd = (torch.randn((v, d), generator=gen) * 0.05).to(device=DEVICE, dtype=dtype)
    lo = (v - 1) // 256 * 256 if tail_labels else 0
    labels = torch.randint(lo, v, (s,), generator=gen, dtype=torch.int32).to(DEVICE)
    return h, w_vd, labels, torch.linspace(0.5, 2.0, s, device=DEVICE)


def ce_compare(what, h, w_vd, labels, g, **extra):
    """The three kernels against their plain versions on the same inputs
    (the backward both from the plain forward's lse), their routes
    (``ce_route``, ``ce_bwd_route``: bf16 on the tensor cores, fp32 on
    fused_ce.cu) and a repeat launch of each with the same bits.
    Returns {kernel: (max_abs_err, tol_use)} and fails above 1.0 of a
    limit."""
    from pretraining_llm_tpu_torch.ops import _build
    from pretraining_llm_tpu_torch.ops import ce_reference as ref
    from pretraining_llm_tpu_torch.ops import cuda_ce

    kernels = (cuda_ce.fused_ce_fwd, cuda_ce.fused_ce_dh, cuda_ce.fused_ce_dw)
    route, bwd_route = cuda_ce.ce_route(h.dtype), cuda_ce.ce_bwd_route(h.dtype)
    by_route = [dict(f.launches_by_route) for f in kernels]
    before = [f.launches for f in kernels]
    loss, lse = cuda_ce.fused_ce_fwd(h, w_vd, labels)
    r_loss, r_lse = ref.fused_ce_fwd_reference(h, w_vd.t(), labels)
    dh = cuda_ce.fused_ce_dh(h, w_vd, labels, r_lse, g)
    dw = cuda_ce.fused_ce_dw(h, w_vd, labels, r_lse, g)
    r_dh = ref.fused_ce_dh_reference(h, w_vd.t(), labels, r_lse, g)
    r_dw = ref.fused_ce_dw_reference(h, w_vd.t(), labels, r_lse, g).t()
    torch.cuda.synchronize()
    ran = [f.launches - n for f, n in zip(kernels, before)]
    ran_route = [f.launches_by_route[r] - b[r] for f, b, r in zip(kernels, by_route, (route, bwd_route, bwd_route))]
    (s, d), v = h.shape, w_vd.shape[0]
    plans = ({kind: cuda_ce.ce_bwd_plan(kind, s, v, d, _build.sm_count(h.device.index)) for kind in ("dh", "dw")}
             if bwd_route == "wgmma" else None)

    def stat_use(x, y):
        return ((x - y).abs() / (CE_LOSS_TOL * y.abs().clamp_min(1.0))).max().item()

    def grad_use(x, y):
        return row_tol_use(x, y, BF16_ROW_RTOL) if x.dtype == torch.bfloat16 else max_err(x, y) / FP32_TOL

    out = {
        "fused_ce_fwd": (max(max_err(loss, r_loss), max_err(lse, r_lse)),
                         max(stat_use(loss, r_loss), stat_use(lse, r_lse))),
        "fused_ce_dh": (max_err(dh, r_dh), grad_use(dh, r_dh)),
        "fused_ce_dw": (max_err(dw, r_dw), grad_use(dw, r_dw)),
    }
    finite = all(bool(torch.isfinite(x.float()).all()) for x in (loss, lse, dh, dw))
    loss2, lse2 = cuda_ce.fused_ce_fwd(h, w_vd, labels)
    repeat_same = {"fused_ce_fwd": bool(torch.equal(loss, loss2) and torch.equal(lse, lse2)),
                   "fused_ce_dh": bool(torch.equal(dh, cuda_ce.fused_ce_dh(h, w_vd, labels, r_lse, g))),
                   "fused_ce_dw": bool(torch.equal(dw, cuda_ce.fused_ce_dw(h, w_vd, labels, r_lse, g)))}
    log(what, S=s, D=d, V=v, dtype=str(h.dtype), fwd_route=route, bwd_route=bwd_route, bwd_plans=plans, **extra,
        max_abs_err={k: e for k, (e, _) in out.items()}, tol_use={k: u for k, (_, u) in out.items()},
        finite=finite, launches=ran, launches_on_route=ran_route, repeat_same_bits=repeat_same)
    if ran != [1, 1, 1] or ran_route != [1, 1, 1] or not finite or not all(u <= 1.0 for _, u in out.values()):
        raise AssertionError(f"fused CE kernels disagree with their plain versions ({what}, {ran_route}): {out}")
    want = "wgmma" if h.dtype == torch.bfloat16 else "fp32"
    if (route, bwd_route) != (want, want):
        raise AssertionError(f"{what}: the {h.dtype} kernels took routes {route}, {bwd_route}")
    if not all(repeat_same.values()):
        raise AssertionError(f"{what}: a repeat launch gave other bits: {repeat_same}")
    return out


def check_ce() -> dict:
    """The fused CE kernels (B9 forward, B10 dH, B11 dW) against their plain
    versions at CE_CASES with a non-uniform cotangent, and the fp32 route
    timed at FP32_WIDE (``time_fp32_ce``); then a bf16
    ``FusedCE`` forward and backward at llama3-1b-gqa's head (LLAMA_HEAD,
    the untied (D, V) layout) against the plain versions at the bf16 bars;
    then ``FusedCE`` gradients (fp32, the tied layout: W is the embedding's
    transpose) against autograd through a plain dense head (logits, then
    ``cross_entropy``). The T1-shape comparison is in ``time_ce_kernels``.
    Returns {kernel: [the fp32 route's entry at each FP32_WIDE shape]}."""
    from pretraining_llm_tpu_torch.ops import ce_reference as ref
    from pretraining_llm_tpu_torch.ops import cuda_ce
    from pretraining_llm_tpu_torch.ops.fused_ce import FusedCE

    gen = torch.Generator().manual_seed(SEED + 13)
    for s, d, v, dtype, *tail in CE_CASES:
        ce_compare("check_ce", *ce_inputs(s, d, v, dtype, gen, *tail), tail_labels=bool(tail))
    wide = time_fp32_ce(gen)

    s, d, v = LLAMA_HEAD
    h, w_vd, labels, g = ce_inputs(s, d, v, torch.bfloat16, gen)
    w = w_vd.t().contiguous()  # the untied head's (D, V) weight
    counted = (cuda_ce.fused_ce_fwd, cuda_ce.fused_ce_dh, cuda_ce.fused_ce_dw)
    before = [f.launches_by_route["wgmma"] for f in counted]
    hh, ww = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    losses = FusedCE.apply(hh, ww, labels)
    (losses * g).sum().backward()
    torch.cuda.synchronize()
    ran = [f.launches_by_route["wgmma"] - n for f, n in zip(counted, before)]
    r_loss, r_lse = ref.fused_ce_fwd_reference(h, w, labels)
    r_dh = ref.fused_ce_dh_reference(h, w, labels, r_lse, g)
    r_dw = ref.fused_ce_dw_reference(h, w, labels, r_lse, g)
    uses = {"loss": ((losses.detach() - r_loss).abs() / (CE_LOSS_TOL * r_loss.abs().clamp_min(1.0))).max().item(),
            "dh": row_tol_use(hh.grad, r_dh, BF16_ROW_RTOL),
            "dw": row_tol_use(ww.grad.t(), r_dw.t(), BF16_ROW_RTOL)}
    finite = all(bool(torch.isfinite(x.float()).all()) for x in (losses, hh.grad, ww.grad))
    log("check_ce_llama_head", S=s, D=d, V=v, dtype="torch.bfloat16", tol_use=uses, finite=finite,
        wgmma_launches=ran, grad_dtypes=[str(hh.grad.dtype), str(ww.grad.dtype)])
    if ran != [1, 1, 1] or not finite or not all(u <= 1.0 for u in uses.values()):
        raise AssertionError(f"FusedCE at llama3-1b-gqa's head disagrees with the plain versions: {uses}, {ran}")
    del h, w_vd, w, hh, ww, losses, r_dh, r_dw

    s, d, v = 512, 768, 50257
    h, emb, labels, g = ce_inputs(s, d, v, torch.float32, gen)
    grads = []
    for fused in (True, False):
        hh, ee = h.clone().requires_grad_(True), emb.clone().requires_grad_(True)
        if fused:
            losses = FusedCE.apply(hh, ee.T, labels)
        else:
            losses = torch.nn.functional.cross_entropy(hh @ ee.T, labels.long(), reduction="none")
        (losses * g).sum().backward()
        grads.append((losses.detach(), hh.grad, ee.grad))
    (fl, fh, fe), (dl, dh, de) = grads
    uses = {"loss": ((fl - dl).abs() / (CE_LOSS_TOL * dl.abs().clamp_min(1.0))).max().item(),
            "dh": max_err(fh, dh) / (CE_GRAD_RTOL * dh.abs().max().item()),
            "dembedding": max_err(fe, de) / (CE_GRAD_RTOL * de.abs().max().item())}
    log("check_ce_grad", S=s, D=d, V=v, dtype="torch.float32", tol_use=uses, grad_rtol=CE_GRAD_RTOL)
    if not all(u <= 1.0 for u in uses.values()):
        raise AssertionError(f"FusedCE disagrees with autograd through a dense head: {uses}")
    return wide


def time_fp32_ce(gen) -> dict:
    """The fp32 route (``csrc/fused_ce.cu``'s ``ce32_kernel``, D streamed)
    at FP32_WIDE: each kernel held against its plain version (the CE_CASES
    bars), then timed (3 launches after 1, L2 flushed) beside its plain
    version, a library composite (the fp32 (S, V) logits as one cuBLAS GEMM
    with TF32 off, then torch ops) and its bound at the fp32 peak
    (PEAK_FP32_FLOPS: 2*S*D*V per product, one forward, two dH or dW).
    Returns {kernel: [entry per shape]}."""
    from pretraining_llm_tpu_torch.ops import ce_reference as ref
    from pretraining_llm_tpu_torch.ops import cuda_ce

    l2_buf = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    flush = l2_buf.zero_
    out = {"fused_ce_fwd": [], "fused_ce_dh": [], "fused_ce_dw": []}
    for s, d, v in FP32_WIDE:
        h, w_vd, labels, g = ce_inputs(s, d, v, torch.float32, gen, tail_labels=True)
        errs = ce_compare("check_ce_fp32_wide", h, w_vd, labels, g, tail_labels=True)
        _, lse = cuda_ce.fused_ce_fwd(h, w_vd, labels)

        def lib_p():
            p = torch.exp_((h @ w_vd.t()).sub_(lse[:, None]))
            p[torch.arange(s, device=DEVICE), labels.long()] -= 1.0
            return p.mul_(g[:, None])

        def lib_fwd():
            z = h @ w_vd.t()
            lse_ = torch.logsumexp(z, dim=1)
            return lse_ - z.gather(1, labels.long()[:, None])[:, 0], lse_

        operand_bytes = 4 * (s * d + v * d + s)
        for name, fn, plain, lib, products, nbytes in (
            ("fused_ce_fwd", lambda: cuda_ce.fused_ce_fwd(h, w_vd, labels),
             lambda: ref.fused_ce_fwd_reference(h, w_vd.t(), labels), lib_fwd, 1, operand_bytes + 8 * s),
            ("fused_ce_dh", lambda: cuda_ce.fused_ce_dh(h, w_vd, labels, lse, g),
             lambda: ref.fused_ce_dh_reference(h, w_vd.t(), labels, lse, g), lambda: lib_p() @ w_vd, 2,
             operand_bytes + 8 * s + 4 * s * d),
            ("fused_ce_dw", lambda: cuda_ce.fused_ce_dw(h, w_vd, labels, lse, g),
             lambda: ref.fused_ce_dw_reference(h, w_vd.t(), labels, lse, g), lambda: lib_p().t() @ h, 2,
             operand_bytes + 8 * s + 4 * v * d),
        ):
            flops = 2.0 * s * d * v * products
            entry = dict(S=s, D=d, V=v, dtype="float32", route=cuda_ce.ce_route(torch.float32),
                         ms=time_ms(fn, n=3, warmup=1, flush=flush),
                         device_ms=time_ms(fn, n=3, warmup=1, flush=flush, device_only=True),
                         plain_ms=time_ms(plain, n=2, warmup=1, flush=flush),
                         library_ms=time_ms(lib, n=3, warmup=1, flush=flush), flops=flops, bytes=nbytes,
                         **_bound(flops, nbytes, PEAK_FP32_FLOPS), max_abs_err=errs[name][0],
                         tol_use=errs[name][1])
            log("time_fp32_ce", kernel=name, **entry)
            out[name].append(entry)
        del h, w_vd, labels, g, lse
        _free_card()
    return out


def paged_state(rng, b, n_blocks, nb, bs, t, lo=0, hi=None, seqs=None):
    """Fragmented tables with dead tails (zeros); row 0 has seq 0, or each
    row b has ``seqs[b]``."""
    perm = rng.permutation(np.arange(1, n_blocks)).tolist()
    tables = np.zeros((b, nb), np.int32)
    seq = np.zeros((b,), np.int32)
    for i in range(b):
        if seqs is not None:
            s = seqs[i]
        elif i == 0:
            s = 0
        else:
            s = int(rng.integers(lo, (hi if hi is not None else nb * bs - t) + 1))
        n_pages = (s + t - 1) // bs + 1
        tables[i, :n_pages] = [perm.pop() for _ in range(n_pages)]
        seq[i] = s
    return torch.from_numpy(tables).cuda(), torch.from_numpy(seq).cuda()


PAGED_CASES = [  # (case, B, T, G, Dh, window, dtype, seq_lens or None for drawn ones[, H; default 12])
    ("grid", 8, 1, 12, 64, 0, torch.bfloat16, None), ("grid", 8, 1, 12, 64, 0, torch.float32, None),
    ("grid", 8, 4, 12, 64, 0, torch.bfloat16, None), ("grid", 8, 4, 12, 64, 0, torch.float32, None),
    ("grid", 8, 1, 4, 64, 0, torch.bfloat16, None), ("grid", 8, 4, 4, 64, 200, torch.bfloat16, None),
    ("grid", 8, 1, 12, 64, 200, torch.float32, None), ("grid", 8, 4, 4, 128, 0, torch.bfloat16, None),
    # The split route's edges: seq 0 and seq at a page's last and first slot,
    # a full table, windows ending on a page edge, more partitions than
    # live pages (one row: 16 partitions of one entry), GQA at Dh 128.
    ("page_edges", 8, 1, 12, 64, 0, torch.bfloat16, [0, 63, 64, 127, 128, 1, 62, 65]),
    ("page_edges", 8, 1, 12, 64, 0, torch.float32, [0, 63, 64, 127, 128, 1, 62, 65]),
    ("page_edges_t4", 8, 4, 12, 64, 0, torch.bfloat16, [0, 60, 61, 63, 64, 124, 125, 128]),
    ("full_table", 8, 1, 12, 64, 0, torch.bfloat16, [1023] * 4 + [1022, 960, 959, 1000]),
    ("full_table_t4", 8, 4, 4, 128, 0, torch.bfloat16, [1020] * 4 + [1019, 957, 956, 1000]),
    ("window_page_edge", 8, 1, 12, 64, 128, torch.bfloat16, [255, 191, 319, 128, 127, 64, 1000, 511]),
    ("window_page_edge_t4", 8, 4, 4, 64, 64, torch.float32, [252, 188, 316, 125, 124, 61, 1000, 508]),
    ("more_partitions_than_pages", 1, 1, 12, 64, 0, torch.bfloat16, [70]),
    ("more_partitions_than_pages", 2, 1, 4, 128, 0, torch.bfloat16, [5, 700]),
    ("gqa_dh128", 8, 1, 4, 128, 0, torch.bfloat16, None), ("gqa_dh128", 8, 1, 4, 128, 0, torch.float32, None),
    # Shapes outside the split route's rule: the loop kernel.
    ("loop_dh32", 8, 1, 12, 32, 0, torch.bfloat16, None), ("loop_rows_24", 8, 8, 4, 64, 0, torch.bfloat16, None),
    # llama3-1b-gqa's speculative verify (H 16 over G 4, T 5 = k + 1, Dh 128:
    # 20 rows per KV head, the loop route), drawn lengths and page edges.
    ("loop_gqa_t5", 8, 5, 4, 128, 0, torch.bfloat16, None, 16),
    ("loop_gqa_t5_page_edges", 8, 5, 4, 128, 0, torch.bfloat16, [0, 59, 60, 63, 64, 123, 124, 1019], 16),
]


def check_paged() -> dict:
    """K2 against its plain version at PAGED_CASES (H 12 unless the case
    names its own, 64-slot pages, 16-entry tables): each case logs the
    route ``paged_route`` gives it and asserts that the launch took it;
    every split-route case launches twice and must give the same bits (its
    partials merge in partition order). Returns the worst error over the
    cases and over the loop route's speculative-verify cases."""
    from pretraining_llm_tpu_torch.ops import _build, cuda_paged

    f = cuda_paged.paged_decode_attention
    gen = torch.Generator().manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    bs, nb, n_blocks = 64, 16, 160
    worst, worst_gqa_t5 = 0.0, 0.0
    for case, b, t, g, d, window, dtype, seqs, *case_h in PAGED_CASES:
        h = case_h[0] if case_h else 12
        q = randn((b, t, h, d) if t > 1 else (b, h, d), dtype, gen)
        kp = randn((n_blocks, bs, g, d), dtype, gen)
        vp = randn((n_blocks, bs, g, d), dtype, gen)
        tables, seq = paged_state(rng, b, n_blocks, nb, bs, t, seqs=seqs)
        route = cuda_paged.paged_route(dtype, d, bs, (h // g) * t)
        before = dict(f.launches_by_route)
        out = f(q, kp, vp, tables, seq, window=window)
        repeat_same = None
        if route == "split":
            repeat_same = bool(torch.equal(out, f(q, kp, vp, tables, seq, window=window)))
        ran = {r: f.launches_by_route[r] - before[r] for r in before}
        ref = cuda_paged.paged_decode_attention_reference(q, kp, vp, tables, seq, window=window)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        use = tol_use(out, ref)
        parts = (cuda_paged._kv_partitions(b, g, nb, _build.sm_count(torch.cuda.current_device()))
                 if route == "split" else None)
        log("check_paged", case=case, route=route, partitions=parts, B=b, H=h, G=g, T=t, Dh=d, window=window,
            dtype=str(dtype), max_abs_err=err, tol_use=use, repeat_same_bits=repeat_same, seq_lens=seq.tolist())
        if ran[route] != (2 if route == "split" else 1) or sum(ran.values()) != ran[route]:
            raise AssertionError(f"paged case {case} ran {ran}, not the {route} kernel")
        if not (use <= 1.0):
            raise AssertionError(f"paged kernel disagrees with its plain version: {use} x its limit")
        if repeat_same is False:
            raise AssertionError(f"paged case {case}: a repeat launch gave other bits")
        worst = max(worst, err)
        if case.startswith("loop_gqa_t5"):
            worst_gqa_t5 = max(worst_gqa_t5, err)
    return {"paged_decode": worst, "paged_loop_gqa_t5": worst_gqa_t5}


def ragged_state(rng, q_lens, seqs, n_blocks, nb, bs):
    """Fragmented tables holding each row's pages up to seq + q_len - 1,
    with dead (zero) tails."""
    perm = rng.permutation(np.arange(1, n_blocks)).tolist()
    tables = np.zeros((len(seqs), nb), np.int32)
    for i, (s, n) in enumerate(zip(seqs, q_lens)):
        n_pages = (s + max(n, 1) - 1) // bs + 1
        tables[i, :n_pages] = [perm.pop() for _ in range(n_pages)]
    as_dev = lambda x: torch.tensor(x, dtype=torch.int32, device=DEVICE)  # noqa: E731
    return torch.from_numpy(tables).to(DEVICE), as_dev(seqs), as_dev(q_lens)


def int8_pools(shape, scale_dtype, gen):
    """int8 K/V pools and scale pages, quantized from N(0, 1) values as the
    model quantizes them."""
    from pretraining_llm_tpu_torch.models.transformer import _kv_quantize

    out = []
    for _ in range(2):
        codes, scale = _kv_quantize(randn(shape, torch.float32, gen))
        out += [codes, scale.to(scale_dtype)]
    return out  # k, k_scale, v, v_scale


RAGGED_FORMS = ("ragged", "ragged_split", "ragged_int8", "ragged_int8_amla")


def _ragged_form(split: bool, int8: bool, amla: bool) -> str:
    if split:
        return "ragged_split"
    if int8:
        return "ragged_int8_amla" if amla else "ragged_int8"
    return "ragged"


def _ragged_case(worst, *, b, t, h, g, d, bs, nb, n_blocks, q_lens, seqs, pool, window, splits, amla, gen, rng,
                 case="grid", edit=None):
    """One ragged kernel case against ``ragged_gather_attention`` on the
    card: the route it must take by ``ragged_route`` (bf16 q: the
    tensor-core kernel; fp32 q: the CUDA-core kernel), the launch that
    route counted, the bar, and for bf16 a repeat launch with the same bits.
    ``edit(q, kp, vp, tables)`` may shape the inputs in place."""
    from pretraining_llm_tpu_torch.ops import cuda_ragged

    f = cuda_ragged.ragged_paged_attention
    pool, _, q_name = pool.partition(":")  # "int8-f32:bf16": fp32 scale pages under bf16 queries
    qdt = torch.float32 if pool in ("fp32", "int8-f32") and q_name != "bf16" else torch.bfloat16
    q = randn((b, t, h, d), qdt, gen)
    shape = (n_blocks, bs, g, d)
    kw = {}
    if pool.startswith("int8"):
        kp, ks, vp, vs = int8_pools(shape, torch.float32 if pool == "int8-f32" else torch.bfloat16, gen)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = randn(shape, qdt, gen), randn(shape, qdt, gen)
    tables, seq, ql = ragged_state(rng, q_lens, seqs, n_blocks, nb, bs)
    if edit is not None:
        edit(q, kp, vp, tables)
    route = cuda_ragged.ragged_route(qdt, kp.dtype, d, bs, h // g)
    want_route = "wgmma" if qdt == torch.bfloat16 else "fp32"
    before = dict(f.launches_by_route)
    out = f(q, kp, vp, tables, seq, ql, window=window, kv_splits=splits, amla=amla, **kw)
    repeat_same = None
    if qdt == torch.bfloat16:
        again = f(q, kp, vp, tables, seq, ql, window=window, kv_splits=splits, amla=amla, **kw)
        repeat_same = bool(torch.equal(out, again))
    ran = {r: f.launches_by_route[r] - before[r] for r in before}
    ref = cuda_ragged.ragged_gather_attention(q, kp, vp, tables, seq, ql, window=window, **kw)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    use = tol_use(out, ref, AMLA_FP32_TOL if amla else FP32_TOL)
    n_splits = min(splits or cuda_ragged._auto_kv_splits(nb, b), nb)
    log("check_ragged", case=case, route=route, amla=amla, kv_splits=splits, splits_run=n_splits, pool=pool,
        q_dtype=str(qdt), B=b, H=h, G=g, T=t, Dh=d, bs=bs, window=window, q_lens=q_lens, seq_lens=seqs,
        max_abs_err=err, tol_use=use, repeat_same_bits=repeat_same)
    if route != want_route or ran[want_route] != (2 if repeat_same is not None else 1):
        raise AssertionError(f"ragged case {case} ran {ran} by route {route}, not the {want_route} kernel")
    if not (use <= 1.0):
        raise AssertionError(f"ragged kernel disagrees with its plain version: {use} x its limit")
    if repeat_same is False:
        raise AssertionError(f"ragged case {case}: a repeat launch gave other bits")
    form = _ragged_form(n_splits > 1, pool.startswith("int8"), amla)
    worst[form] = max(worst[form], err)


def check_ragged() -> dict:
    """The ragged kernels against ``ragged_gather_attention`` on the card:
    classic and AMLA x kv_splits {1, 2, 3 (uneven tail), auto} x pools
    {bf16, fp32, int8 + fp32 scales (fp32 q), int8 + bf16 scales (bf16 q)},
    with window 0/200, G = H and GQA, Dh 64 and 128 varying across the
    cases. Rows mix q_len 0, 1, a few and T = 256 at offsets from 0 to the
    table's capacity. Then bf16 edge cases of the tensor-core kernel: GQA
    n_rep 4 at Dh 128, a decode batch, live pages ending inside a query
    tile, a window skipping whole pages, empty split partitions, an AMLA
    score jump of more than 126 between pages, int8 with fp32 and with bf16
    scales, and block sizes 32, 96 and 128. Every bf16 case must run the
    tensor-core kernel and give the same bits on a repeat launch, every
    fp32 case the CUDA-core kernel. Returns the worst max-abs error per
    kernel form."""
    gen = torch.Generator().manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    b, t, h, bs, nb, n_blocks = 6, 256, 12, 64, 16, 120
    q_lens = [0, 1, 5, t, 1, 100]
    seqs = [100, 0, 500, nb * bs - t, nb * bs - 1, 37]
    worst = dict.fromkeys(RAGGED_FORMS, 0.0)
    i = 0
    for amla in (False, True):
        for splits in (1, 2, 3, None):
            for pool in ("bf16", "fp32", "int8-f32", "int8-bf16"):
                j, k = divmod(i, 4)  # (form x splits) index, pool index
                window = 200 if (j + k) % 2 else 0
                g = 4 if (j // 2 + k) % 2 else 12
                d = 128 if (j + k) % 3 == 0 else 64
                i += 1
                _ragged_case(worst, b=b, t=t, h=h, g=g, d=d, bs=bs, nb=nb, n_blocks=n_blocks, q_lens=q_lens,
                             seqs=seqs, pool=pool, window=window, splits=splits, amla=amla, gen=gen, rng=rng)

    def score_jump(q, kp, vp, tables):
        # Query rows of 4s against K pages of 4s on the odd pages of row 0:
        # their scores sit 184 (log2 units) above the even pages' ~N(0, 6).
        q.fill_(4.0)
        for j in range(1, nb, 2):
            kp[int(tables[0, j])] = 4.0

    edge = [  # (case, T, H, G, Dh, bs, nb, q_lens, seqs, pool, window, splits, amla, edit)
        ("gqa_nrep4_dh128", 256, 16, 4, 128, 64, 16, [256, 200, 0], [0, 300, 64], "bf16", 0, 1, False, None),
        ("gqa_nrep4_dh128_split", 256, 16, 4, 128, 64, 16, [256, 200, 0], [0, 300, 64], "bf16", 0, 2, True,
         None),
        ("decode_batch", 1, 12, 12, 64, 64, 16, [1] * 8, [401, 847, 0, 63, 64, 500, 1000, 777], "bf16", 0, 1,
         False, None),
        ("decode_batch_int8", 1, 12, 12, 64, 64, 16, [1] * 8, [401, 847, 0, 63, 64, 500, 1000, 777],
         "int8-bf16", 0, None, False, None),
        ("pages_end_inside_tile", 256, 12, 12, 64, 64, 16, [70, 130, 200], [10, 197, 5], "bf16", 0, 1, False,
         None),
        ("window_skips_pages", 64, 12, 4, 64, 64, 16, [64, 33], [700, 900], "bf16", 200, 1, False, None),
        ("empty_partitions", 16, 12, 12, 64, 64, 16, [1, 16, 0], [0, 10, 300], "bf16", 0, 4, False, None),
        ("amla_score_jump", 64, 12, 12, 64, 64, 16, [64, 1], [600, 900], "bf16", 0, 1, True, score_jump),
        ("amla_score_jump_split", 64, 12, 12, 64, 64, 16, [64, 1], [600, 900], "bf16", 0, 2, True, score_jump),
        ("int8_f32_scales", 256, 12, 12, 64, 64, 16, [256, 1, 40], [0, 700, 300], "int8-f32:bf16", 0, 1, False,
         None),
        ("int8_bf16_scales", 256, 12, 12, 64, 64, 16, [256, 1, 40], [0, 700, 300], "int8-bf16", 0, 1, True,
         None),
        ("bs32_dh128", 64, 12, 4, 128, 32, 32, [64, 1], [100, 900], "bf16", 0, 1, True, None),
        ("bs96_dh128_int8", 64, 12, 12, 128, 96, 10, [64, 3], [100, 800], "int8-bf16", 200, 2, False, None),
        ("bs128_dh64", 200, 12, 12, 64, 128, 8, [200, 1], [37, 700], "bf16", 0, 1, False, None),
    ]
    for case, t, h, g, d, bs, nb, q_lens, seqs, pool, window, splits, amla, edit in edge:
        _ragged_case(worst, b=len(q_lens), t=t, h=h, g=g, d=d, bs=bs, nb=nb, n_blocks=n_blocks, q_lens=q_lens,
                     seqs=seqs, pool=pool, window=window, splits=splits, amla=amla, gen=gen, rng=rng, case=case,
                     edit=edit)
    return worst


def offset_view(x: torch.Tensor) -> torch.Tensor:
    """x's values in a contiguous view that starts one element into a fresh
    buffer: 2 bytes (bf16) or 1 (int8) past an aligned address."""
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = base[1:].view(x.shape)
    view.copy_(x)
    if view.data_ptr() % 16 == 0:
        raise AssertionError("offset_view: the view is 16-byte aligned")
    return view


def check_misaligned() -> None:
    """K1, the backward kernels (one pass, dQ, dK/dV), K2 (split route), K3
    (tensor cores) and B9-B11, bf16, once on aligned operands and once with
    every operand the kernel reads 16 bytes at a time as ``offset_view``:
    the wrappers copy a misaligned operand into a fresh buffer
    (``_build.aligned``) and launch the same kernel, so each output must
    equal the aligned call's bit for bit, on the same route, one launch
    each."""
    from pretraining_llm_tpu_torch.ops import cuda_ce, cuda_flash, cuda_paged, cuda_ragged

    gen = torch.Generator().manual_seed(SEED + 31)
    rng = np.random.default_rng(SEED + 31)
    bf = torch.bfloat16
    results = {}

    def same(name, fn, aligned_args, shifted_args, counted):
        before = counted()
        want = fn(*aligned_args)
        mid = counted()
        got = fn(*shifted_args)
        after = counted()
        torch.cuda.synchronize()
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        equal = all(torch.equal(a, b) for a, b in zip(want, got))
        results[name] = {"bit_identical": equal, "launches": [mid - before, after - mid]}
        if not equal or mid - before != after - mid or mid == before:
            raise AssertionError(f"{name}: misaligned operands gave {results[name]}")

    b, h, g, t, d = 2, 8, 4, 512, 64
    q, k, v, do = (randn((b * n, t, d), bf, gen) for n in (h, g, g, h))
    o, lse = cuda_flash.flash_attention_fwd(q, k, v, h, g)
    fwd = cuda_flash.flash_attention_fwd
    same("flash_fwd (K1)", lambda *a: fwd(*a, h, g), (q, k, v), tuple(map(offset_view, (q, k, v))),
         lambda: fwd.launches_tc)
    for name, blocks, counted in (("flash_bwd_fused (B4)", 0, cuda_flash.flash_bwd_fused),
                                  ("flash_bwd_dq + dkv (B2, B3)", 128, cuda_flash.flash_bwd_dq)):
        same(name, lambda q_, k_, v_, do_: cuda_flash.flash_attention_bwd(q_, k_, v_, o, lse, do_, h, g, block_q=blocks,
                                                                         block_kv=blocks),
             (q, k, v, do), tuple(map(offset_view, (q, k, v, do))), lambda c=counted: c.launches_tc)

    bs, nb, n_blocks = 64, 16, 160
    qd = randn((8, 12, 64), bf, gen)
    kp, vp = randn((n_blocks, bs, 12, 64), bf, gen), randn((n_blocks, bs, 12, 64), bf, gen)
    tables, seq = paged_state(rng, 8, n_blocks, nb, bs, 1)
    k2 = cuda_paged.paged_decode_attention
    same("paged_decode (K2, split)", lambda q_, kp_, vp_: k2(q_, kp_, vp_, tables, seq), (qd, kp, vp),
         (offset_view(qd), offset_view(kp), offset_view(vp)), lambda: k2.launches_by_route["split"])

    qr = randn((3, 64, 12, 64), bf, gen)
    rt, rs, rq = ragged_state(rng, [64, 1, 30], [100, 900, 0], n_blocks, nb, bs)
    k3 = cuda_ragged.ragged_paged_attention
    same("ragged_paged (K3, tensor cores)", lambda q_, kp_, vp_: k3(q_, kp_, vp_, rt, rs, rq, kv_splits=1),
         (qr, kp, vp), (offset_view(qr), offset_view(kp), offset_view(vp)),
         lambda: k3.launches_by_route["wgmma"])

    hh, w_vd, labels, gg = ce_inputs(300, 768, 1000, bf, gen)
    _, ce_lse = cuda_ce.fused_ce_fwd(hh, w_vd, labels)
    for name, fn in (("fused_ce_fwd (B9)", lambda h_, w_: cuda_ce.fused_ce_fwd(h_, w_, labels)),
                     ("fused_ce_dh (B10)", lambda h_, w_: cuda_ce.fused_ce_dh(h_, w_, labels, ce_lse, gg)),
                     ("fused_ce_dw (B11)", lambda h_, w_: cuda_ce.fused_ce_dw(h_, w_, labels, ce_lse, gg))):
        counted = getattr(cuda_ce, name.split(" ")[0])
        same(name, fn, (hh, w_vd), (offset_view(hh), offset_view(w_vd)), lambda c=counted: c.launches_by_route["wgmma"])
    log("check_misaligned", offset="one element (2 bytes, bf16)", **{"results": results})


def check_model_card_vs_cpu() -> None:
    """gpt2-124m widths at 2 layers, fp32: batched prefill and 4 paged
    decode steps on the card (the kernels) and on the CPU (the plain
    versions), from the same weights."""
    import dataclasses

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation import paged
    from pretraining_llm_tpu_torch.models import transformer

    cfg = dataclasses.replace(
        get_preset("gpt2-124m").model, n_layers=2, compute_dtype="float32",
        paged_attention_impl="kernel",
    )
    rng = np.random.default_rng(SEED + 2)
    lens = [17, 100, 64, 250]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]
    bs, nb, steps = 64, 6, 4
    tables = np.zeros((len(lens), nb), np.int32)
    ids = iter(rng.permutation(np.arange(1, 40)).tolist())
    for i, n in enumerate(lens):
        tables[i, : paged.required_blocks(n + steps, bs)] = [
            next(ids) for _ in range(paged.required_blocks(n + steps, bs))
        ]

    def run(device):
        params = transformer.init_params(cfg, SEED, device=device)
        pools = transformer.make_paged_kv_pool(cfg, 40, bs, device=device)
        rows = [tables[i, : paged.required_blocks(n, bs)].tolist() for i, n in enumerate(lens)]
        last, pools = paged.prefill_logits_into_pool_batched(params, cfg, pools, prompts, rows)
        all_logits, toks = [last], [last.argmax(-1)]
        tab = torch.from_numpy(tables).to(device)
        seq = torch.tensor(lens, dtype=torch.int32, device=device)
        for _ in range(steps):
            logits, pools = transformer.forward(
                params, toks[-1][:, None], cfg, kv_cache=pools,
                paged=transformer.PagedInfo(tab, seq),
            )
            all_logits.append(logits[:, 0])
            toks.append(logits[:, 0].argmax(-1))
            seq = seq + 1
        return [x.cpu() for x in all_logits], [x.cpu() for x in toks]

    from pretraining_llm_tpu_torch.ops import cuda_flash, cuda_paged

    before = (cuda_flash.flash_attention_fwd.launches, cuda_paged.paged_decode_attention.launches)
    card_logits, card_toks = run("cuda")
    cpu_logits, cpu_toks = run("cpu")
    launched = (cuda_flash.flash_attention_fwd.launches - before[0],
                cuda_paged.paged_decode_attention.launches - before[1])
    err = max(max_err(a, b) for a, b in zip(card_logits, cpu_logits))
    same = all(torch.equal(a, b) for a, b in zip(card_toks, cpu_toks))
    finite = all(bool(torch.isfinite(x).all()) for x in card_logits)
    log("check_model", layers=cfg.n_layers, prompt_lens=lens, decode_steps=steps,
        max_abs_logit_err=err, tol=MODEL_TOL, greedy_tokens_equal=same, finite=finite,
        kernel_launches={"flash_fwd": launched[0], "paged_decode": launched[1]})
    if not (err <= MODEL_TOL and same and finite and min(launched) > 0):
        raise AssertionError("2-layer model on the card disagrees with the CPU run")


def check_model_chunked_card_vs_cpu() -> None:
    """gpt2-124m widths at 2 layers, fp32, through the suffix lane: prompts
    stream in 64-token chunks (``prefill_suffix_logits_into_pool_batched``
    with the token axis pinned, as the engine's chunks run), then 4 paged
    decode steps, on the card and on the CPU from the same weights. Once
    with an exact pool (one-pass ragged kernel for the chunks, paged kernel
    for decode), once with an int8-kv pool (int8 weights, bf16 scale pages)
    and AMLA with 2 KV splits (every attention through the split kernel)."""
    import dataclasses

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation import paged
    from pretraining_llm_tpu_torch.models import quantize, transformer
    from pretraining_llm_tpu_torch.ops import cuda_paged, cuda_ragged

    base = dataclasses.replace(
        get_preset("gpt2-124m").model, n_layers=2, compute_dtype="float32",
        paged_attention_impl="kernel",
    )
    rng = np.random.default_rng(SEED + 6)
    lens = [17, 100, 64, 250]
    prompts = [rng.integers(0, base.vocab_size, size=n).tolist() for n in lens]
    bs, nb, steps, chunk = 64, 6, 4, 64
    tables = np.zeros((len(lens), nb), np.int32)
    ids = iter(rng.permutation(np.arange(1, 40)).tolist())
    for i, n in enumerate(lens):
        n_pages = paged.required_blocks(n + steps, bs)
        tables[i, :n_pages] = [next(ids) for _ in range(n_pages)]

    def run(cfg, int8, device):
        params = transformer.init_params(cfg, SEED, device=device)
        if int8:
            params = quantize.quantize_params_for_serving(params, cfg)
        pools = transformer.make_paged_kv_pool(
            cfg, 40, bs, device=device, scale_dtype=torch.bfloat16 if int8 else None)
        last = [None] * len(lens)
        pos = [0] * len(lens)
        while any(p < n for p, n in zip(pos, lens)):
            rows = [i for i, n in enumerate(lens) if pos[i] < n]
            chunks = [prompts[i][pos[i]:pos[i] + chunk] for i in rows]
            logits, pools = paged.prefill_suffix_logits_into_pool_batched(
                params, cfg, pools, chunks, tables[rows], [pos[i] for i in rows], t_bucket=chunk)
            for j, i in enumerate(rows):
                pos[i] += len(chunks[j])
                if pos[i] == lens[i]:
                    last[i] = logits[j]
        first = torch.stack(last)
        all_logits, toks = [first], [first.argmax(-1)]
        tab = torch.from_numpy(tables).to(device)
        seq = torch.tensor(lens, dtype=torch.int32, device=device)
        for _ in range(steps):
            logits, pools = transformer.forward(
                params, toks[-1][:, None], cfg, kv_cache=pools,
                paged=transformer.PagedInfo(tab, seq),
            )
            all_logits.append(logits[:, 0])
            toks.append(logits[:, 0].argmax(-1))
            seq = seq + 1
        return [x.cpu() for x in all_logits], [x.cpu() for x in toks]

    ragged = cuda_ragged.ragged_paged_attention
    for name, int8, kw in (
        ("exact", False, dict(ragged_kv_splits=1)),
        ("int8-kv+amla", True, dict(kv_cache_dtype="int8", ragged_kv_splits=2, ragged_amla=True)),
    ):
        cfg = dataclasses.replace(base, **kw)
        before = (ragged.launches, ragged.split_launches, cuda_paged.paged_decode_attention.launches)
        card_logits, card_toks = run(cfg, int8, DEVICE)
        launched = {
            "ragged": ragged.launches - before[0],
            "ragged_split": ragged.split_launches - before[1],
            "paged_decode": cuda_paged.paged_decode_attention.launches - before[2],
        }
        cpu_logits, cpu_toks = run(cfg, int8, "cpu")
        err = max(max_err(a, b) for a, b in zip(card_logits, cpu_logits))
        same = all(torch.equal(a, b) for a, b in zip(card_toks, cpu_toks))
        finite = all(bool(torch.isfinite(x).all()) for x in card_logits)
        want = ("ragged", "paged_decode") if not int8 else ("ragged_split",)
        log("check_model_chunked", pool=name, layers=cfg.n_layers, prompt_lens=lens, chunk=chunk,
            decode_steps=steps, max_abs_logit_err=err, tol=MODEL_TOL, greedy_tokens_equal=same,
            finite=finite, kernel_launches=launched)
        if not (err <= MODEL_TOL and same and finite and all(launched[k] > 0 for k in want)):
            raise AssertionError(f"2-layer chunked model ({name}) on the card disagrees with the CPU run")
    if ragged.launches <= 0 or ragged.split_launches <= 0:
        raise AssertionError("the chunked card-vs-CPU check did not launch both ragged forms")


NEAR_TIE = 1e-3  # a CPU step whose top two logits lie this close may flip its greedy token


def check_generate_card_vs_cpu() -> None:
    """gpt2-124m widths at 2 layers, fp32 (TF32 off): ``generate`` on a
    ragged 4-row batch, 16 greedy tokens each, and a chunked prefill at a
    nonzero cache index, on the card and on the CPU from the same weights.
    Two models: learned positions with MHA and an exact cache; RoPE with
    GQA (4 KV heads) and an int8 dense cache. Each row's tokens must be the
    CPU's up to the first step where the CPU's top two logits lie within
    NEAR_TIE (that row is not compared from there on); every compared
    step's logits, and the chunk's, within MODEL_TOL. The prefill at index
    0 runs K1 (fp32 route); the chunk at index 256 runs blockwise attention
    in torch ops."""
    import dataclasses

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.generate import generate
    from pretraining_llm_tpu_torch.models import transformer
    from pretraining_llm_tpu_torch.ops import cuda_flash

    base = dataclasses.replace(get_preset("gpt2-124m").model, n_layers=2, compute_dtype="float32")
    rng = np.random.default_rng(SEED + 20)
    lens = [17, 100, 64, 250]
    batch = np.zeros((len(lens), max(lens)), np.int64)
    for i, n in enumerate(lens):
        batch[i, :n] = rng.integers(0, base.vocab_size, n)
    chunk_toks = torch.from_numpy(rng.integers(0, base.vocab_size, (2, 384)))
    steps = 16
    for name, kw in (("learned-mha-exact", {}),
                     ("rope-gqa-int8", dict(pos_embed="rope", n_kv_heads=4, kv_cache_dtype="int8"))):
        cfg = dataclasses.replace(base, **kw)
        runs = {}
        for device in (DEVICE, "cpu"):
            before = cuda_flash.flash_attention_fwd.launches_fp32
            params = transformer.init_params(cfg, SEED, device=device)
            toks, logits = generate(params, cfg, batch, steps, 0, temperature=0.0, prompt_lengths=lens,
                                    return_logits=True)
            cache = transformer.make_kv_cache(cfg, 2, 384, device=device)
            x = chunk_toks.to(device)
            _, cache = transformer.forward(params, x[:, :256], cfg, kv_cache=cache, cache_index=0)
            chunk, _ = transformer.forward(params, x[:, 256:], cfg, kv_cache=cache, cache_index=256)
            runs[device] = (toks.cpu(), logits.cpu(), chunk.cpu(), cuda_flash.flash_attention_fwd.launches_fp32 - before)
            del params, cache
        (ct, cl, cc, k1), (pt, pl, pc, _) = runs[DEVICE], runs["cpu"]
        top2 = pl.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]  # (rows, steps)
        compared, same, err = [], True, 0.0
        for i in range(len(lens)):
            ties = (gap[i] < NEAR_TIE).nonzero()
            upto = int(ties[0]) if len(ties) else steps
            compared.append(upto)
            same = same and torch.equal(ct[i, :upto], pt[i, :upto])
            if upto:
                err = max(err, max_err(cl[i, :upto], pl[i, :upto]))
        chunk_err = max_err(cc, pc)
        finite = bool(torch.isfinite(cl).all() and torch.isfinite(cc).all())
        log("check_generate", model=name, layers=cfg.n_layers, prompt_lens=lens, new_tokens=steps,
            steps_compared_per_row=compared, near_tie=NEAR_TIE, greedy_tokens_equal=same,
            max_abs_logit_err=err, chunk="256 at index 0, 128 at index 256", chunk_max_abs_logit_err=chunk_err,
            tol=MODEL_TOL, finite=finite, k1_fp32_launches=k1)
        if not (same and err <= MODEL_TOL and chunk_err <= MODEL_TOL and finite and k1 == 2 * cfg.n_layers):
            raise AssertionError(f"generate ({name}) on the card disagrees with the CPU run")
        if sum(compared) < len(lens) * steps // 2:
            raise AssertionError(f"generate ({name}): near ties left too few steps to compare: {compared}")


def main_path_requests(vocab_size: int):
    """Path 1's 16 requests: prompts of 17-900 random tokens."""
    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(17, 901, size=16).tolist()
    return [rng.integers(0, vocab_size, size=n).tolist() for n in lens]


def run_main_path():
    """Full-width gpt2-124m, bf16, paged_attention_impl="kernel", served
    through ServingEngine.submit/run(pipeline=False) (the synchronous
    scheduler). Returns each kernel's launch count on that run, the (rows,
    padded length) of each admission prefill and the 16 token streams."""
    import dataclasses

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import bridge, transformer

    cfg = dataclasses.replace(get_preset("gpt2-124m").model, paged_attention_impl="kernel")
    params = bridge.cast_params_for_inference(transformer.init_params(cfg, SEED, device=DEVICE), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(params, cfg, max_batch=8, n_blocks=256, block_size=64, steps_per_sched=8,
                        device=DEVICE)
    prompts = main_path_requests(cfg.vocab_size)
    lens = [len(p) for p in prompts]
    max_new = 64
    rids = [eng.submit(p, max_new) for p in prompts]

    reset_kernel_counts()
    t0 = time.perf_counter()
    out = eng.run(pipeline=False)  # the synchronous scheduler, as PERF.md's path 1 numbers
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()

    ok = sorted(out) == sorted(rids) and all(
        len(out[r]) == max_new and all(0 <= tok < cfg.vocab_size for tok in out[r]) for r in rids
    )
    st = eng.stats
    decode_tokens = st["tokens"] - st["admissions"]
    log("main_path", model="gpt2-124m", layers=cfg.n_layers, dtype=cfg.compute_dtype,
        requests=len(rids), prompt_lens=lens, max_new_tokens=max_new, wall_s=wall,
        prefill_tokens=st["prefill_tokens"], prefill_s=st["prefill_s"],
        prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
        decode_tokens=decode_tokens, decode_s=st["decode_s"],
        decode_tokens_per_s=decode_tokens / st["decode_s"], decode_steps=st["steps"],
        admissions=st["admissions"], preemptions=st["preemptions"],
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        prefill_shapes=eng.prefill_shapes, launches=launches, outputs_ok=ok)
    if not ok:
        raise AssertionError("main path: a request did not finish with max_new in-vocab tokens")
    if launches["flash_fwd"] <= 0 or launches["paged_decode"] <= 0:
        raise AssertionError(f"main path did not run through both kernels: {launches}")
    if launches["flash_fwd_tc"] != launches["flash_fwd"]:
        raise AssertionError(f"main path (bf16) ran the flash forward off the tensor-core route: {launches}")
    _assert_paged_split("main path", launches)
    return launches, eng.prefill_shapes, [out[r] for r in rids]


def _assert_paged_split(name: str, launches: dict) -> None:
    """Every paged decode launch of a serving path took the split route."""
    if launches["paged_loop"] != 0 or launches["paged_split"] != launches["paged_decode"]:
        raise AssertionError(f"{name}: a paged decode launch did not take the split route: {launches}")


def shared_prefix_requests(vocab_size: int):
    """16 requests: two 384-token system prompts (8 requests each,
    alternating) followed by each request's own 17-400 tokens."""
    rng = np.random.default_rng(SEED + 7)
    prefixes = [rng.integers(0, vocab_size, size=384).tolist() for _ in range(2)]
    own = rng.integers(17, 401, size=16).tolist()
    return [prefixes[i % 2] + rng.integers(0, vocab_size, size=n).tolist() for i, n in enumerate(own)]


def kernel_counts() -> dict:
    from pretraining_llm_tpu_torch.ops import cuda_ce, cuda_flash, cuda_paged, cuda_ragged

    return {
        "fused_ce_fwd": cuda_ce.fused_ce_fwd.launches,
        **{f"fused_ce_fwd_{route}": n for route, n in cuda_ce.fused_ce_fwd.launches_by_route.items()},
        "fused_ce_dh": cuda_ce.fused_ce_dh.launches,
        "fused_ce_dw": cuda_ce.fused_ce_dw.launches,
        **{f"{name}_{route}": n for name in ("fused_ce_dh", "fused_ce_dw")
           for route, n in getattr(cuda_ce, name).launches_by_route.items()},
        "flash_fwd": cuda_flash.flash_attention_fwd.launches,
        "flash_fwd_tc": cuda_flash.flash_attention_fwd.launches_tc,
        "flash_fwd_fp32": cuda_flash.flash_attention_fwd.launches_fp32,
        **{f"flash_bwd_{name}{route}": getattr(getattr(cuda_flash, f"flash_bwd_{name}"), f"launches{route}")
           for name in ("fused", "dq", "dkv") for route in ("", "_tc", "_fp32")},
        "paged_decode": cuda_paged.paged_decode_attention.launches,
        **{f"paged_{route}": n for route, n in cuda_paged.paged_decode_attention.launches_by_route.items()},
        **{f"paged_{route}_t{t}": n for (route, t), n in cuda_paged.paged_decode_attention.launches_by_queries.items()},
        "ragged": cuda_ragged.ragged_paged_attention.launches,
        "ragged_split": cuda_ragged.ragged_paged_attention.split_launches,
        **{f"ragged_{route}": n for route, n in cuda_ragged.ragged_paged_attention.launches_by_route.items()},
    }


def reset_kernel_counts() -> None:
    from pretraining_llm_tpu_torch.ops import cuda_ce, cuda_flash, cuda_paged, cuda_ragged

    for counted in (cuda_flash.flash_attention_fwd, cuda_flash.flash_bwd_fused, cuda_flash.flash_bwd_dq,
                    cuda_flash.flash_bwd_dkv, cuda_paged.paged_decode_attention,
                    cuda_ragged.ragged_paged_attention, cuda_ce.fused_ce_fwd, cuda_ce.fused_ce_dh,
                    cuda_ce.fused_ce_dw):
        counted.launches = 0
    for routed in (cuda_flash.flash_attention_fwd, cuda_flash.flash_bwd_fused, cuda_flash.flash_bwd_dq,
                   cuda_flash.flash_bwd_dkv):
        routed.launches_tc = routed.launches_fp32 = 0
    cuda_ragged.ragged_paged_attention.split_launches = 0
    cuda_ragged.ragged_paged_attention.launches_by_route = dict.fromkeys(cuda_ragged.ROUTES, 0)
    cuda_paged.paged_decode_attention.launches_by_route = dict.fromkeys(cuda_paged.ROUTES, 0)
    cuda_paged.paged_decode_attention.launches_by_queries = {}
    for routed in (cuda_ce.fused_ce_fwd, cuda_ce.fused_ce_dh, cuda_ce.fused_ce_dw):
        routed.launches_by_route = dict.fromkeys(cuda_ce.ROUTES, 0)


def serving_path(name: str, *, arrivals_per_step: int = 0, **engine_kw):
    """Full-width gpt2-124m, bf16, random weights from the seed, serving the
    16 shared-prefix requests (64 new tokens each) through
    ``ServingEngine``: all submitted up front and ``run(pipeline=False)``
    (the synchronous scheduler), or ``arrivals_per_step`` submitted before
    each ``step()``. Returns (each kernel's launches on the run, the
    engine)."""
    import dataclasses

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import bridge, transformer

    cfg_kw = {k: engine_kw.pop(k) for k in ("ragged_kv_splits", "ragged_amla") if k in engine_kw}
    cfg = dataclasses.replace(get_preset("gpt2-124m").model, paged_attention_impl="kernel", **cfg_kw)
    params = bridge.cast_params_for_inference(transformer.init_params(cfg, SEED, device=DEVICE), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(params, cfg, max_batch=8, n_blocks=256, block_size=64, steps_per_sched=8,
                        device=DEVICE, **engine_kw)
    prompts = shared_prefix_requests(cfg.vocab_size)
    max_new = 64
    rids = []
    reset_kernel_counts()
    t0 = time.perf_counter()
    if arrivals_per_step:
        pending = list(prompts)
        while pending or eng.has_work():
            for _ in range(arrivals_per_step):
                if pending:
                    rids.append(eng.submit(pending.pop(0), max_new))
            eng.step()
        out = eng.finished
    else:
        rids = [eng.submit(p, max_new) for p in prompts]
        out = eng.run(pipeline=False)  # the synchronous scheduler, as PERF.md's path 2 numbers
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    ok = sorted(out) == sorted(rids) and all(
        len(out[r]) == max_new and all(0 <= tok < cfg.vocab_size for tok in out[r]) for r in rids
    )
    st = eng.stats
    decode_tokens = st["tokens"] - st["admissions"]
    pool = eng.pool_info()
    bf16_pool = cfg.n_layers * eng.n_blocks * eng.block_size * cfg.kv_heads * cfg.head_dim * 2 * 2
    log(name, model="gpt2-124m", layers=cfg.n_layers, dtype=cfg.compute_dtype,
        engine=dict(engine_kw, ragged_kv_splits=cfg.ragged_kv_splits, ragged_amla=cfg.ragged_amla,
                    arrivals_per_step=arrivals_per_step or "all at once"),
        requests=len(prompts), prompt_lens=[len(p) for p in prompts], max_new_tokens=max_new,
        wall_s=wall, prefill_tokens=st["prefill_tokens"], prefill_s=st["prefill_s"],
        prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
        decode_tokens=decode_tokens, decode_s=st["decode_s"],
        decode_tokens_per_s=decode_tokens / st["decode_s"], decode_steps=st["steps"],
        admissions=st["admissions"], preemptions=st["preemptions"],
        prefill_chunks=st["prefill_chunks"],
        prefix_cache_hits=st.get("prefix_cache_hits", 0),
        prefix_cache_hit_tokens=st.get("prefix_cache_hit_tokens", 0),
        pool_bytes=pool["pool_bytes"], bf16_pool_bytes_same_blocks=bf16_pool,
        pool_capacity_ratio=bf16_pool / pool["pool_bytes"],
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        suffix_shapes=[(len(o), t) for o, _, t in eng.suffix_shapes],
        launches=launches, outputs_ok=ok)
    if not ok:
        raise AssertionError(f"{name}: a request did not finish with {max_new} in-vocab tokens")
    return launches, eng


def run_path2():
    """Chunked prefill (256-token chunks) and the prefix cache, exact bf16
    pools, one-pass ragged kernel."""
    launches, eng = serving_path(
        "path2", prefill_chunk_tokens=256, prefix_cache=True, ragged_kv_splits=1)
    if eng.stats["prefix_cache_hit_tokens"] <= 0:
        raise AssertionError("path2: no prompt token came from the prefix cache")
    if launches["ragged"] <= 0 or launches["paged_decode"] <= 0:
        raise AssertionError(f"path2 did not run through the ragged and paged kernels: {launches}")
    _assert_ragged_tensor_cores("path2", launches)
    _assert_paged_split("path2", launches)
    return launches, eng


def _assert_ragged_tensor_cores(name: str, launches: dict) -> None:
    """Every ragged launch of a bf16 serving path took the tensor-core
    kernel."""
    if launches["ragged_fp32"] != 0 or launches["ragged_wgmma"] != launches["ragged"] + launches["ragged_split"]:
        raise AssertionError(f"{name}: a ragged launch did not run the tensor-core kernel: {launches}")


def run_path3():
    """int8-kv serving with the prefix cache, no chunking, auto KV splits,
    two arrivals per scheduler step: every attention through the ragged
    kernel, never the paged kernel."""
    launches, eng = serving_path(
        "path3", arrivals_per_step=2, quantize="int8-kv", prefix_cache=True, ragged_kv_splits=0)
    if launches["ragged"] <= 0 or launches["ragged_split"] <= 0:
        raise AssertionError(f"path3 did not run both ragged forms: {launches}")
    if launches["paged_decode"] != 0:
        raise AssertionError(f"path3 launched the paged kernel on int8 pools: {launches}")
    _assert_ragged_tensor_cores("path3", launches)
    return launches, eng


# ---------------------------------------------------------------------------
# The pipelined scheduler, speculative serving, KV checksums, the serve CLI
# ---------------------------------------------------------------------------

SERVE_DIR = SCRATCH / "serve"  # T1's weights and the 2-block draft, saved for serving
SERVE_ENGINE = dict(max_batch=8, n_blocks=256, block_size=64, steps_per_sched=8)  # the serve CLI's defaults
SPEC_K = 4
P5_NEW_TOKENS = 64
LLAMA_SPEC_NEW_TOKENS = 32


def guard_dispatch(eng) -> None:
    """Every decode dispatch of ``eng`` (a window or a spec round) runs
    under ``torch.cuda.set_sync_debug_mode("error")``: a call inside it that
    waits for the stream raises."""
    for name in ("_dispatch_window", "_dispatch_spec_round"):
        orig = getattr(eng, name)

        def guarded(*args, _orig=orig):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _orig(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        setattr(eng, name, guarded)


def compare_streams(name: str, params, cfg, prompts, want, got) -> dict:
    """Each row of ``got`` against ``want`` (two greedy runs of the same
    requests on the card) up to the first token where they part. There the
    two tokens must be a near tie of one uncached bf16 forward over the
    prompt and the common prefix: their logits within BF16_ROW_RTOL of that
    position's largest |logit| (G1's bar; bf16 logits move by more than
    NEAR_TIE when an admission's padded shape picks another GEMM
    algorithm). Returns the exact rows, the compared tokens and each tie."""
    from pretraining_llm_tpu_torch.models import transformer

    exact, compared, ties = 0, 0, []
    for i, (p, w, g) in enumerate(zip(prompts, want, got)):
        if len(w) != len(g):
            raise AssertionError(f"{name}: row {i} has {len(g)} tokens, the reference {len(w)}")
        j = next((j for j, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if j is None:
            exact += 1
            compared += len(w)
            continue
        compared += j
        with torch.no_grad():
            logits, _ = transformer.forward(params, torch.tensor([list(p) + w[:j]], device=DEVICE), cfg)
        row = logits[0, -1].float()
        gap, bar = (row[w[j]] - row[g[j]]).abs().item(), BF16_ROW_RTOL * row.abs().max().item()
        ties.append({"row": i, "step": j, "gap": gap, "bar": bar})
        if not gap <= bar:
            raise AssertionError(f"{name}: row {i} parts at step {j}, where the logits are {gap} apart (> {bar})")
    return {"rows": len(want), "exact_rows": exact, "compared_tokens": compared,
            "tokens": sum(map(len, want)), "near_ties": ties}


def _first_blocks(tree: dict, n: int) -> dict:
    """A parameter tree with only its first ``n`` blocks (block leaves are
    stacked on axis 0); embeddings, final norm and head unchanged."""
    def cut(sub):
        return {k: cut(v) if isinstance(v, dict) else v[:n] for k, v in sub.items()}

    return {**tree, "blocks": cut(tree["blocks"])}


def corpus_lines(n: int = 8):
    """``n`` lines of ``data/parity/corpus.txt`` of 17-600 ASCII bytes,
    drawn from the seed: prompts a prompt file holds one a line."""
    lines = [ln for ln in (PARITY_DIR / "corpus.txt").read_text().split("\n")
             if 17 <= len(ln) <= 600 and ln.isascii() and ln.strip() == ln]
    rng = np.random.default_rng(SEED + 31)
    return [lines[i] for i in rng.choice(len(lines), size=n, replace=False)]


P4_RUNS = (("sync", {}, False), ("default", {}, True), ("depth1", dict(pipeline_depth=1), True),
           ("depth3", dict(pipeline_depth=3), True), ("depth2_admit4", dict(admit_batch=4), True))
P4_ORDER = ("sync", "default", "depth1", "depth3", "depth2_admit4", "default", "sync")  # timed runs, in turns
P4_PROFILED_WINDOWS = 2


def run_path4(path1_streams) -> dict:
    """Path 4: path 1's 16 requests (full-width gpt2-124m, bf16, 64 greedy
    tokens) through the pipelined scheduler: ``run()`` at the defaults
    (depth 2), at depth 1, at depth 3, and at depth 2 with
    ``admit_batch=4``, beside the synchronous scheduler. After a warm-up
    run, the timed runs go in turns (P4_ORDER: the synchronous and default
    runs twice, first and last), every decode dispatch under the sync
    guard, each run's streams against path 1's (``compare_streams``). The
    busy share of each configuration comes from P4_PROFILED_WINDOWS decode
    windows in steady state under the profiler (a whole run's trace takes
    minutes to read). Then 4 of the requests with ``fused_sampling=False``:
    the fused streams exactly. Returns the first default run's launches."""
    import dataclasses

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import bridge, transformer
    from pretraining_llm_tpu_torch.utils.profiling import profile_call

    cfg = dataclasses.replace(get_preset("gpt2-124m").model, paged_attention_impl="kernel")
    params = bridge.cast_params_for_inference(transformer.init_params(cfg, SEED, device=DEVICE), cfg)
    prompts = main_path_requests(cfg.vocab_size)
    max_new = 64

    def engine(kw, pipeline, reqs):
        eng = ServingEngine(params, cfg, device=DEVICE, **SERVE_ENGINE, **kw)
        rids = [eng.submit(p, max_new) for p in reqs]
        if pipeline and kw.get("fused_sampling", True):
            guard_dispatch(eng)
        torch.cuda.synchronize()
        return eng, rids

    def serve(kw, pipeline, reqs):
        eng, rids = engine(kw, pipeline, reqs)
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = eng.run(pipeline=pipeline)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return eng, [out[r] for r in rids], wall, kernel_counts()

    def profiled_windows(kw, pipeline) -> dict:
        eng, _ = engine(kw, pipeline, prompts)
        tick = eng.pipeline_tick if pipeline else eng.step
        for _ in range(3 if pipeline else 1):  # admission, and the queue filled
            tick()
        before = dict(eng.stats)
        prof = profile_call(lambda: [tick() for _ in range(P4_PROFILED_WINDOWS)])
        reaped = eng.stats["windows_reaped"] - before["windows_reaped"]
        return dict(windows=P4_PROFILED_WINDOWS, wall_ms_per_window=prof["wall_ms"] / P4_PROFILED_WINDOWS,
                    device_kernel_ms_per_window=prof["device_kernel_ms"] / P4_PROFILED_WINDOWS,
                    busy_share=prof["device_busy_share"], kernel_launches=prof["kernel_launches"],
                    host_blocked_ms_per_window=(eng.stats["host_blocked_s"] - before["host_blocked_s"]) * 1e3
                    / max(1, reaped))

    serve({}, True, prompts[:8])  # warm-up: the pipelined path's first pinned buffers and events
    configs = {name: (kw, pipeline) for name, kw, pipeline in P4_RUNS}
    walls = {name: [] for name in configs}
    first_streams = {}
    default_launches = None
    for turn, name in enumerate(P4_ORDER):
        kw, pipeline = configs[name]
        eng, streams, wall, launches = serve(kw, pipeline, prompts)
        walls[name].append(wall)
        if len(walls[name]) > 1:  # a repeat: the same streams, timed again
            if streams != first_streams[name]:
                raise AssertionError(f"path4 {name}: a repeat run gave other streams")
            continue
        first_streams[name] = streams
        st = eng.stats
        decode_tokens = st["tokens"] - st["admissions"]
        cmp = compare_streams(f"path4 {name}", params, cfg, prompts, path1_streams, streams)
        log("path4", run=name, turn=turn, engine=kw, scheduler="pipelined" if pipeline else "synchronous",
            pipeline_depth=eng.pipeline_depth if pipeline else None, requests=len(prompts), max_new_tokens=max_new,
            wall_s=wall, tokens=st["tokens"], tokens_per_s=st["tokens"] / wall, decode_tokens=decode_tokens,
            decode_tokens_per_s=decode_tokens / wall, windows=st["windows"], windows_reaped=st["windows_reaped"],
            flushes=st["flushes"], host_blocked_s=st["host_blocked_s"],
            host_blocked_s_per_window=st["host_blocked_s"] / max(1, st["windows_reaped"]),
            steps=st["steps"], admissions=st["admissions"], admit_batches=st.get("admit_batches", 0),
            admit_deferrals=st.get("admit_deferrals", 0), preemptions=st["preemptions"], prefill_s=st["prefill_s"],
            profiled=profiled_windows(kw, pipeline), launches={k: n for k, n in launches.items() if n},
            streams_vs_path1=cmp,
            sync_guard="every dispatch under set_sync_debug_mode('error')" if pipeline else None)
        if pipeline and not (st["windows_reaped"] == st["windows"] > 0):
            raise AssertionError(f"path4 {name}: {st['windows']} windows dispatched, {st['windows_reaped']} reaped")
        if launches["flash_fwd_tc"] != launches["flash_fwd"] or launches["flash_fwd"] <= 0:
            raise AssertionError(f"path4 {name}: the admissions did not run K1 on the tensor cores: {launches}")
        _assert_paged_split(f"path4 {name}", launches)
        if name == "default":
            default_launches = launches
    log("path4_walls", order=list(P4_ORDER), walls_s=walls,
        tokens_per_s={name: [len(prompts) * max_new / w for w in ws] for name, ws in walls.items()})

    four = prompts[:4]
    fused_eng, fused, fused_wall, _ = serve({}, True, four)
    eng, unfused, wall, _ = serve(dict(fused_sampling=False), True, four)
    st = eng.stats
    log("path4_unfused", requests=len(four), streams_equal_fused=unfused == fused, steps=st["steps"],
        logits_bytes_host=st["logits_bytes_host"],
        logits_bytes_per_step=st["logits_bytes_host"] / max(1, st["steps"]),
        fused_logits_bytes_host=fused_eng.stats["logits_bytes_host"], wall_s=wall, fused_wall_s=fused_wall)
    if unfused != fused or st["logits_bytes_host"] != st["steps"] * SERVE_ENGINE["max_batch"] * cfg.vocab_size * 4:
        raise AssertionError("path4: the unfused lane gave other tokens or moved other bytes than the fused one")
    del eng, fused_eng, params
    _free_card()
    return default_launches


def save_serving_checkpoints() -> dict:
    """T1's step-30 weights re-saved through the port's checkpoint writer
    with ``paged_attention_impl="kernel"`` and the byte tokenizer, and the
    2-block draft cut from them (its first 2 blocks with the embeddings,
    final norm and head): the checkpoints path 5 and the serve CLI load."""
    import dataclasses

    from pretraining_llm_tpu_torch.generation.generate import load_model_for_inference
    from pretraining_llm_tpu_torch.training import checkpoint as ckpt

    params, cfg = load_model_for_inference(str(t1_config().train.checkpoint_dir), device="cpu")
    model = dataclasses.replace(cfg.model, paged_attention_impl="kernel")
    data = dataclasses.replace(cfg.data, tokenizer_name="byte")
    paths = {}
    for name, tree, m in (("target", params, model),
                          ("draft", _first_blocks(params, 2), dataclasses.replace(model, n_layers=2))):
        conf = dataclasses.replace(cfg, model=m, data=data)
        paths[name] = str(SERVE_DIR / name)
        ckpt.save_checkpoint(paths[name], T1_STEPS, {"params": tree},
                             extra={"step": T1_STEPS, "config": dataclasses.asdict(conf)})
    return paths


def _spec_launch_check(name: str, launches: dict, rounds: int, t_layers: int, d_layers: int, verify: str) -> dict:
    """K2 launches of a speculative run: the verify's at T = k + 1 on route
    ``verify`` (one a target layer a round), the draft's at T = 1 on the
    split route ((k + 1) a draft layer a round); nothing else."""
    k2 = {key: n for key, n in launches.items() if key.startswith("paged_") and "_t" in key and n}
    want = {f"paged_{verify}_t{SPEC_K + 1}": rounds * t_layers, "paged_split_t1": rounds * (SPEC_K + 1) * d_layers}
    if k2 != want:
        raise AssertionError(f"{name}: K2 launches {k2}, expected {want}")
    return k2


def run_path5(paths: dict) -> tuple:
    """Path 5, speculative serving on full-width gpt2-124m with T1's
    step-30 weights and the 2-block draft (``spec_k=4``, depth 2, greedy),
    8 corpus lines (byte tokens), 64 new tokens: the streams against
    target-only serving's (``compare_streams``), every dispatch under the
    sync guard, K2 at T = 5 on the split route once per target layer per
    round. Returns (launches, prompts, target-only streams, spec streams)."""
    from pretraining_llm_tpu_torch.generation.generate import cast_params_for_inference, load_model_for_inference
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine

    params, cfg = load_model_for_inference(paths["target"], device=DEVICE)
    params = cast_params_for_inference(params, cfg.model)
    d_params, d_cfg = load_model_for_inference(paths["draft"], device=DEVICE)
    d_params = cast_params_for_inference(d_params, d_cfg.model)
    prompts = [list(line.encode()) for line in corpus_lines()]
    runs = {}
    for name, kw in (("target_only", {}), ("spec", dict(draft_params=d_params, draft_cfg=d_cfg.model, spec_k=SPEC_K))):
        eng = ServingEngine(params, cfg.model, device=DEVICE, **SERVE_ENGINE, **kw)
        rids = [eng.submit(p, P5_NEW_TOKENS) for p in prompts]
        guard_dispatch(eng)
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        runs[name] = (eng, [out[r] for r in rids], time.perf_counter() - t0, kernel_counts())
    (eng_t, want, wall_t, _), (eng, got, wall, launches) = runs["target_only"], runs["spec"]
    st = eng.stats
    cmp = compare_streams("path5", params, cfg.model, prompts, want, got)
    k2 = _spec_launch_check("path5", launches, st["spec_rounds"], cfg.model.n_layers, 2, "split")
    log("path5", model="gpt2-124m", weights="T1 step 30", draft="first 2 blocks + embeddings, final norm, head",
        spec_k=SPEC_K, pipeline_depth=eng.pipeline_depth, requests=len(prompts), prompt_lens=list(map(len, prompts)),
        max_new_tokens=P5_NEW_TOKENS, wall_s=wall, target_only_wall_s=wall_t, tokens_per_s=st["tokens"] / wall,
        target_only_tokens_per_s=eng_t.stats["tokens"] / wall_t, spec_rounds=st["spec_rounds"],
        target_only_windows=eng_t.stats["windows"], spec_proposed=st["spec_proposed"],
        spec_accepted=st["spec_accepted"], acceptance=st["spec_accepted"] / st["spec_proposed"],
        windows=st["windows"], flushes=st["flushes"], host_blocked_s=st["host_blocked_s"], k2_launches=k2,
        launches={k: n for k, n in launches.items() if n}, streams_vs_target_only=cmp)
    del eng, eng_t, params, d_params
    _free_card()
    return launches, prompts, want, got


def run_path5_llama() -> dict:
    """Path 5 on full-depth llama3-1b-gqa (22 layers, random weights from
    the seed, bf16): 8 requests of 64-400 random tokens, 32 greedy tokens,
    target-only and with the 2-block draft (``spec_k=4``, depth 2): the
    streams compared, and every verify launch of K2 (16 query heads over 4
    KV heads x T 5 = 20 rows per KV head) on the loop route."""
    import dataclasses

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import bridge, transformer

    cfg = dataclasses.replace(get_preset("llama3-1b-gqa").model, paged_attention_impl="kernel")
    params = bridge.cast_params_for_inference(transformer.init_params(cfg, SEED, device=DEVICE), cfg)
    d_cfg = dataclasses.replace(cfg, n_layers=2)
    d_params = _first_blocks(params, 2)
    rng = np.random.default_rng(SEED + 32)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in rng.integers(64, 401, size=8)]
    runs = {}
    for name, kw in (("target_only", {}), ("spec", dict(draft_params=d_params, draft_cfg=d_cfg, spec_k=SPEC_K))):
        eng = ServingEngine(params, cfg, device=DEVICE, **SERVE_ENGINE, **kw)
        rids = [eng.submit(p, LLAMA_SPEC_NEW_TOKENS) for p in prompts]
        guard_dispatch(eng)
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        runs[name] = (eng, [out[r] for r in rids], time.perf_counter() - t0, kernel_counts())
    (eng_t, want, wall_t, _), (eng, got, wall, launches) = runs["target_only"], runs["spec"]
    st = eng.stats
    cmp = compare_streams("path5 llama", params, cfg, prompts, want, got)
    k2 = _spec_launch_check("path5 llama", launches, st["spec_rounds"], cfg.n_layers, 2, "loop")
    log("path5_llama", model="llama3-1b-gqa", layers=cfg.n_layers, draft_layers=2, spec_k=SPEC_K,
        requests=len(prompts), prompt_lens=list(map(len, prompts)), max_new_tokens=LLAMA_SPEC_NEW_TOKENS,
        wall_s=wall, target_only_wall_s=wall_t, spec_rounds=st["spec_rounds"], spec_proposed=st["spec_proposed"],
        spec_accepted=st["spec_accepted"], acceptance=st["spec_accepted"] / st["spec_proposed"],
        verify_rows_per_kv_head=(cfg.n_heads // cfg.kv_heads) * (SPEC_K + 1), k2_launches=k2,
        launches={k: n for k, n in launches.items() if n}, streams_vs_target_only=cmp)
    del eng, eng_t, params, d_params
    _free_card()
    return launches


def run_checksum(path2_streams) -> dict:
    """Path 2's workload with ``kv_checksum=True``: the same streams as
    path 2 (digests only read the pages). Then one byte of a published page
    that path 2's first prompt hits is flipped, and that prompt is
    submitted again: the page fails verification and is dropped, the
    request prefills privately (no cached tokens, its whole prompt
    prefilled), and its stream equals that of the same request served alone
    on a fresh engine. Returns the first run's launches."""
    import dataclasses

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import bridge, transformer
    from pretraining_llm_tpu_torch.resilience import integrity

    launches, eng = serving_path("checksum", prefill_chunk_tokens=256, prefix_cache=True, ragged_kv_splits=1,
                                 kv_checksum=True)
    clean = [eng.finished[r] for r in range(len(path2_streams))]
    victim = shared_prefix_requests(eng.cfg.vocab_size)[0]
    cache = eng.prefix_cache
    cached_len, ids = cache.acquire(victim)
    cache.release_shared(ids)
    if not ids or cache.checksum_of(ids[0]) is None:
        raise AssertionError("checksum: path 2's first prompt hits no checksummed page")
    block = ids[0]
    page = eng.pools["layers"][0]["k_pool"][block].view(torch.uint8).view(-1)
    page[0] ^= 1
    before = dict(eng.stats)
    rid = eng.submit(victim, 64)
    got = eng.run(pipeline=False)[rid]
    cfg = dataclasses.replace(get_preset("gpt2-124m").model, paged_attention_impl="kernel", ragged_kv_splits=1)
    params = bridge.cast_params_for_inference(transformer.init_params(cfg, SEED, device=DEVICE), cfg)
    fresh = ServingEngine(params, cfg, device=DEVICE, **SERVE_ENGINE, prefill_chunk_tokens=256, prefix_cache=True)
    fresh_rid = fresh.submit(victim, 64)
    want = fresh.run(pipeline=False)[fresh_rid]
    st = eng.stats
    checks = {
        "streams_equal_path2": clean == path2_streams,
        "kv_mismatches": st.get("kv_mismatches", 0),
        # Dropped: no page left in the cache differs from its digest.
        "page_dropped": all(integrity.kv_block_digest(eng.pools, b) == cache.checksum_of(b)
                            for b in cache.cached_block_ids()),
        "cached_tokens_of_the_rerun": eng.timing_summary(rid).get("cached_tokens"),
        "prefilled_privately": st["prefill_tokens"] - before["prefill_tokens"] == len(victim),
        "stream_equals_fresh_engine": got == want,
        "hit_before_the_flip": cached_len,
    }
    log("checksum", workload="path 2 with kv_checksum=True", flipped={"block": block, "leaf": "layer 0 k_pool",
        "byte": 0}, launches={k: n for k, n in launches.items() if n}, **checks)
    if not (checks["streams_equal_path2"] and checks["kv_mismatches"] == 1 and checks["page_dropped"]
            and checks["cached_tokens_of_the_rerun"] == 0 and checks["prefilled_privately"]
            and checks["stream_equals_fresh_engine"]):
        raise AssertionError(f"checksum: {checks}")
    del eng, fresh, params
    _free_card()
    return launches


def run_serve_cli(paths: dict, p5) -> None:
    """``python -m pretraining_llm_tpu_torch.serve`` as two subprocesses on
    the saved T1 checkpoint, run together: path 5's 8 corpus lines,
    ``--tokenizer byte --temperature 0``, 64 new tokens, the CLI's engine
    defaults (which are path 5's); one of them with ``--draft_model_path``
    the 2-block draft.
    Each JSONL file's outputs must be path 5's streams decoded (target-only
    and spec), whose agreement path 5 holds up to near ties."""
    from pretraining_llm_tpu_torch.data.bpe import ByteTokenizer

    _, prompts, want, got = p5
    lines = [bytes(p).decode() for p in prompts]
    prompt_file = SERVE_DIR / "prompts.txt"
    prompt_file.write_text("\n".join(lines) + "\n")
    enc = ByteTokenizer()
    expected = {"plain": [enc.decode(t) for t in want], "spec": [enc.decode(t) for t in got]}
    # Both processes at once (their start-up dominates), each waited for.
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, extra in (("plain", []), ("spec", ["--draft_model_path", paths["draft"], "--spec_k", str(SPEC_K)])):
            cmd = [sys.executable, "-m", "pretraining_llm_tpu_torch.serve", "--model_path", paths["target"],
                   "--input_file", str(prompt_file), "--tokenizer", "byte", "--temperature", "0",
                   "--max_new_tokens", str(P5_NEW_TOKENS), "--output", str(SERVE_DIR / f"{name}.jsonl")] + extra
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        stderr = {name: proc.communicate(timeout=600)[1] for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    results = {}
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise AssertionError(f"serve CLI ({name}) exited {proc.returncode}: {stderr[name][-2000:]}")
        records = [json.loads(line) for line in (SERVE_DIR / f"{name}.jsonl").read_text().splitlines()]
        results[name] = dict(records=len(records),
                             outputs_equal_path5=[r["output"] for r in records] == expected[name],
                             prompts_in_order=[r["prompt"] for r in records] == lines,
                             n_tokens=[r["n_tokens"] for r in records],
                             summary=[ln for ln in stderr[name].splitlines() if ln.startswith("[serve]")][-1:])
    plain_out, spec_out = expected["plain"], expected["spec"]
    log("serve_cli", module="pretraining_llm_tpu_torch.serve", checkpoint=paths["target"], draft=paths["draft"],
        both_processes_wall_s=wall, exact_rows_plain_vs_spec=sum(a == b for a, b in zip(plain_out, spec_out)),
        **results)
    for name, res in results.items():
        if not (res["outputs_equal_path5"] and res["prompts_in_order"] and res["records"] == len(lines)):
            raise AssertionError(f"serve CLI ({name}): {res}")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def check_train_card_vs_cpu() -> None:
    """Three AdamW steps of 2-layer models at fp32 on the card (the
    kernels) and on the CPU (their plain versions), from the same init and
    batches: gpt2-124m widths at T 256 (one-pass backward), and a small GQA
    llama flavour (n_rep 4, Dh 32, RoPE, SwiGLU, untied head) with 128-row
    flash blocks (dQ + dK/dV kernels). Each model runs twice: with the
    chunked CE head, then with ``ce_impl="fused"`` (the fused CE kernels)
    and ``doc_mask_token`` (segments in every flash kernel) on batches with
    ~3% separators. Then the gpt2 model without its QKV bias under Adafactor
    and the GQA model under Muon (Newton-Schulz in fp32: TF32 is off for the
    whole run): after 3 steps every parameter and optimizer-state leaf
    within TRAIN_GRAD_RTOL of its largest |value| on the CPU. (The key
    bias's gradient is zero in exact arithmetic, so its computed value is
    rounding noise that a normalizing update blows up to +-lr on either
    device: the state check leaves that bias out, as the CPU tests do.)"""
    import dataclasses

    from pretraining_llm_tpu_torch.config import Config, ModelConfig, TrainConfig, get_preset
    from pretraining_llm_tpu_torch.training import optimizer as opt
    from pretraining_llm_tpu_torch.training import train_step as ts

    gpt2 = dataclasses.replace(get_preset("gpt2-124m").model, n_layers=2, context_length=256,
                               compute_dtype="float32")
    llama = ModelConfig(
        vocab_size=4096, context_length=256, d_model=256, n_heads=8, n_kv_heads=2, n_layers=2,
        activation="swiglu", norm="rmsnorm", pos_embed="rope", tie_embeddings=False,
        qkv_bias=False, mlp_bias=False, compute_dtype="float32", attention_impl="flash",
        flash_block_q=128, flash_block_kv=128,
    )
    train = TrainConfig(batch_size=2, train_steps=3, lr=6e-4)
    rng = np.random.default_rng(SEED + 10)
    fused = ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")
    runs = []
    for name, model, want, optimizer in (("gpt2", gpt2, ("flash_fwd", "flash_bwd_fused"), "adafactor"),
                                         ("llama_gqa", llama, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), "muon")):
        runs.append((name, model, want, "adamw"))
        runs.append((name + "+fused_ce+doc_mask",
                     dataclasses.replace(model, ce_impl="fused", doc_mask_token=DOC_SEP), want + fused, "adamw"))
        runs.append((f"{name}+{optimizer}", dataclasses.replace(model, qkv_bias=False), want, optimizer))
    for name, model, want, optimizer in runs:
        cfg = Config(model=model, train=dataclasses.replace(train, optimizer=optimizer))
        batches = [rng.integers(0, model.vocab_size, (train.batch_size, model.context_length + 1))
                   for _ in range(3)]
        if model.doc_mask_token >= 0:
            for toks in batches:
                toks[rng.random(toks.shape) < 0.03] = DOC_SEP

        def run(device):
            state = ts.init_train_state(cfg, SEED, device=device)
            step = ts.build_train_step(cfg)
            grads, losses = None, []
            for i, toks in enumerate(batches):
                t = torch.from_numpy(toks).to(device)
                batch = (t[:, :-1], t[:, 1:])
                if i == 0:
                    _, grads = ts.compute_grads(state, batch, cfg)
                    grads = opt.tree_map(lambda g: g.cpu(), grads)
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
            return losses, grads, opt.tree_map(lambda x: x.cpu(), {"params": state["params"], "opt": state["opt"]})

        reset_kernel_counts()
        card_losses, card_grads, card_state = run(DEVICE)
        launched = kernel_counts()
        cpu_losses, cpu_grads, cpu_state = run("cpu")
        loss_use = max(abs(a - b) / (TRAIN_LOSS_RTOL * abs(b)) for a, b in zip(card_losses, cpu_losses))
        grad_use = {
            "/".join(path): max_err(a, b) / (TRAIN_GRAD_RTOL * max(b.abs().max().item(), 1e-30))
            for (path, a), (_, b) in zip(opt.tree_leaves(card_grads), opt.tree_leaves(cpu_grads))
        }
        worst_leaf = max(grad_use, key=grad_use.get)
        state_use = {
            "/".join(path): max_err(a, b) / (TRAIN_GRAD_RTOL * max(b.float().abs().max().item(), 1e-30))
            for (path, a), (_, b) in zip(opt.tree_leaves(card_state), opt.tree_leaves(cpu_state))
            if a.is_floating_point()
        }
        if optimizer == "adamw":  # the AdamW runs keep their loss and gradient checks
            state_use = {"-": 0.0}
        worst_state = max(state_use, key=state_use.get)
        log("check_train", model=name, optimizer=optimizer, state_tol_use=state_use[worst_state],
            worst_state_leaf=worst_state, layers=model.n_layers, d=model.d_model, H=model.n_heads,
            G=model.kv_heads, T=model.context_length, batch=train.batch_size, card_losses=card_losses,
            cpu_losses=cpu_losses, loss_rtol=TRAIN_LOSS_RTOL, loss_tol_use=loss_use,
            grad_rtol=TRAIN_GRAD_RTOL, grad_tol_use=grad_use[worst_leaf], worst_leaf=worst_leaf,
            ce_impl=model.ce_impl, doc_mask_token=model.doc_mask_token,
            kernel_launches={k: launched[k] for k in want})
        if not (loss_use <= 1.0 and grad_use[worst_leaf] <= 1.0 and state_use[worst_state] <= 1.0):
            raise AssertionError(f"training {name} on the card disagrees with the CPU run")
        if not all(launched[k] > 0 for k in want):
            raise AssertionError(f"training {name} on the card did not launch {want}: {launched}")
        if model.ce_impl != "fused" and any(launched[k] for k in fused):
            raise AssertionError(f"training {name} launched the fused CE kernels: {launched}")


MOE_NEAR_TIE = 1e-6  # router probabilities this close may order differently on the card and the CPU


def check_moe_card_vs_cpu() -> None:
    """moe-8x350m's widths (d 1024, 16 heads, d_ff 4096, 8 experts, top-2,
    V 50304) at 2 layers, fp32 (TF32 off), on the card and on the CPU from
    the same init: the loss with the router term and every gradient leaf
    on a batch of 2 x 1024 tokens (2 routing groups: ``moe_group_size``
    1024 here, so the CPU side stays short), the logits
    and the routing decisions of the uncached forward, and ``generate``
    (4 equal-length prompts of 64 tokens, 16 greedy tokens: a grouped
    prefill with capacity, decode steps without). Bars: logits MODEL_TOL,
    loss TRAIN_LOSS_RTOL, gradients TRAIN_GRAD_RTOL of each leaf's largest
    |g|; the experts of every (token, choice) equal except at rows whose
    top k + 1 router probabilities hold two within MOE_NEAR_TIE on the CPU
    (counted and printed), and, in a group without such a row, every
    capacity position and drop equal; greedy tokens equal up to each row's
    first near tie (NEAR_TIE), as ``check_generate_card_vs_cpu``."""
    import dataclasses

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.generate import generate
    from pretraining_llm_tpu_torch.models import transformer
    from pretraining_llm_tpu_torch.training import optimizer as opt

    cfg = dataclasses.replace(get_preset("moe-8x350m").model, n_layers=2, compute_dtype="float32",
                              moe_group_size=1024)
    rng = np.random.default_rng(SEED + 43)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, cfg.context_length + 1)))
    prompts = rng.integers(0, cfg.vocab_size, (4, 64))
    steps = 16
    runs = {}
    for device in (DEVICE, "cpu"):
        reset_kernel_counts()
        params = transformer.init_params(cfg, SEED, device=device)
        x, y = toks[:, :-1].to(device), toks[:, 1:].to(device)
        leaves = opt.tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
        loss = transformer.loss_fn(leaves, x, y, cfg)
        loss.backward()
        grads = opt.tree_map(lambda p: p.grad.cpu(), leaves)
        del leaves
        routes = []

        def record(router_logits, r):
            top = torch.sort(torch.softmax(router_logits, dim=-1), dim=-1, descending=True).values
            routes.append((r.idx.cpu(), r.pos.cpu(), r.keep.cpu(), top[..., : cfg.experts_per_token + 1].cpu()))

        with torch.no_grad(), recording_route(record):
            logits, _, aux = transformer.forward(params, x, cfg, return_aux=True)
        gen_toks, gen_logits = generate(params, cfg, prompts, steps, 0, temperature=0.0, return_logits=True)
        runs[device] = dict(loss=float(loss.detach()), aux=float(aux), grads=grads, logits=logits.cpu(), routes=routes,
                            toks=gen_toks.cpu(), gen_logits=gen_logits.cpu(), launches=kernel_counts())
        del params, logits, gen_logits
        _free_card()
    card, cpu = runs[DEVICE], runs["cpu"]
    loss_use = abs(card["loss"] - cpu["loss"]) / (TRAIN_LOSS_RTOL * abs(cpu["loss"]))
    logit_err = max_err(card["logits"], cpu["logits"])
    grad_use = {"/".join(path): max_err(a, b) / (TRAIN_GRAD_RTOL * max(b.abs().max().item(), 1e-30))
                for (path, a), (_, b) in zip(opt.tree_leaves(card["grads"]), opt.tree_leaves(cpu["grads"]))}
    worst_leaf = max(grad_use, key=grad_use.get)
    ties, idx_equal, slots_equal, groups_compared = 0, True, True, 0
    for (ci, cp, ck, _), (pi, pp, pk, top) in zip(card["routes"], cpu["routes"]):
        near = ((top[..., :-1] - top[..., 1:]) < MOE_NEAR_TIE).any(-1)  # (G, S)
        ties += int(near.sum())
        idx_equal = idx_equal and bool((ci == pi).all(-1)[~near].all())
        for grp in range(near.shape[0]):
            if not bool(near[grp].any()):
                groups_compared += 1
                slots_equal = slots_equal and torch.equal(cp[grp], pp[grp]) and torch.equal(ck[grp], pk[grp])
    gap = cpu["gen_logits"].topk(2, dim=-1).values
    gap = gap[..., 0] - gap[..., 1]
    compared, same_toks, gen_err = [], True, 0.0
    for i in range(prompts.shape[0]):
        near_steps = (gap[i] < NEAR_TIE).nonzero()
        upto = int(near_steps[0]) if len(near_steps) else steps
        compared.append(upto)
        same_toks = same_toks and torch.equal(card["toks"][i, :upto], cpu["toks"][i, :upto])
        if upto:
            gen_err = max(gen_err, max_err(card["gen_logits"][i, :upto], cpu["gen_logits"][i, :upto]))
    launched = card["launches"]
    log("check_moe", layers=cfg.n_layers, d=cfg.d_model, d_ff=cfg.d_ff, experts=cfg.n_experts,
        top_k=cfg.experts_per_token, V=cfg.vocab_size, T=cfg.context_length, batch=toks.shape[0],
        group_size=cfg.moe_group_size, remat=cfg.remat,
        card_loss=card["loss"], cpu_loss=cpu["loss"], loss_tol_use=loss_use, card_aux=card["aux"],
        cpu_aux=cpu["aux"], max_abs_logit_err=logit_err, logit_tol=MODEL_TOL, grad_rtol=TRAIN_GRAD_RTOL,
        grad_tol_use=grad_use[worst_leaf], worst_leaf=worst_leaf, near_tie=MOE_NEAR_TIE, near_tie_rows=ties,
        experts_equal_off_ties=idx_equal, groups_compared=groups_compared, slots_and_drops_equal=slots_equal,
        generate_steps_compared_per_row=compared, greedy_tokens_equal=same_toks, generate_max_abs_logit_err=gen_err,
        launches={k: v for k, v in launched.items() if v})
    if not (loss_use <= 1.0 and logit_err <= MODEL_TOL and grad_use[worst_leaf] <= 1.0 and gen_err <= MODEL_TOL):
        raise AssertionError("MoE on the card disagrees with the CPU run")
    if not (idx_equal and slots_equal and groups_compared and same_toks):
        raise AssertionError(f"MoE routing or greedy tokens differ on the card: experts {idx_equal}, slots "
                             f"{slots_equal} over {groups_compared} groups, tokens {same_toks}")
    if not (launched["flash_fwd_fp32"] and launched["flash_bwd_fused_fp32"]):
        raise AssertionError(f"MoE on the card did not run the fp32 flash kernels: {launched}")


def check_doc_isolation() -> None:
    """Cross-document isolation on the card: gpt2-124m widths at 2 layers,
    fp32, flash attention, doc_mask_token = DOC_SEP, T 512. Row 0 holds four
    documents (separators at 100, 250 and 400); the tokens of its second
    document are replaced. Every other document's per-token logits stay
    within ISOLATION_TOL; without the mask the later documents move."""
    import dataclasses

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.models import transformer

    cfg = dataclasses.replace(get_preset("gpt2-124m").model, n_layers=2, context_length=512,
                              compute_dtype="float32", doc_mask_token=DOC_SEP)
    params = transformer.init_params(cfg, SEED, device=DEVICE)
    rng = np.random.default_rng(SEED + 14)
    a = rng.integers(DOC_SEP + 1, cfg.vocab_size, (2, cfg.context_length))
    a[0, [100, 250, 400]] = DOC_SEP
    a[1, [37, 300]] = DOC_SEP
    b = a.copy()
    b[0, 101:250] = rng.integers(DOC_SEP + 1, cfg.vocab_size, 149)
    keep = np.ones(a.shape, bool)
    keep[0, 101:251] = False  # the changed document, its separator included
    keep_t = torch.from_numpy(keep).to(DEVICE)
    reset_kernel_counts()
    with torch.no_grad():
        la, _ = transformer.forward(params, torch.from_numpy(a).to(DEVICE), cfg)
        lb, _ = transformer.forward(params, torch.from_numpy(b).to(DEVICE), cfg)
        off = dataclasses.replace(cfg, doc_mask_token=-1)
        oa, _ = transformer.forward(params, torch.from_numpy(a).to(DEVICE), off)
        ob, _ = transformer.forward(params, torch.from_numpy(b).to(DEVICE), off)
    launched = kernel_counts()["flash_fwd"]
    err = (la - lb).abs()[keep_t].max().item()
    changed = (la - lb).abs()[~keep_t].max().item()
    leak = (oa - ob).abs()[0, 251:].max().item()
    log("check_doc_isolation", layers=cfg.n_layers, T=cfg.context_length, dtype=cfg.compute_dtype,
        other_docs_max_abs_diff=err, tol=ISOLATION_TOL, changed_doc_max_abs_diff=changed,
        unmasked_later_docs_max_abs_diff=leak, flash_fwd_launches=launched)
    if not (err <= ISOLATION_TOL and changed > 1e-3 and leak > 1e-3 and launched == 4 * cfg.n_layers):
        raise AssertionError("documents are not isolated on the card")


def train_config(preset: str, overrides: dict):
    """``preset`` with no eval, checkpoint or final save unless
    ``overrides`` ask, a log line (and so a loss) every step, checkpoints
    under SCRATCH."""
    from pretraining_llm_tpu_torch.config import get_preset

    base = {"train.eval_interval": 0, "train.checkpoint_interval": 0, "train.save_final": False,
            "train.log_interval": 1, "train.checkpoint_dir": str(SCRATCH / preset)}
    return get_preset(preset).with_overrides({**base, **overrides})


def train_run(cfg, steps: int, **trainer_kw):
    """``Trainer(cfg, ...).train(steps)`` on the card with every kernel
    count set to 0 just before and read just after. Returns (trainer, the
    per-step log records, launches, wall seconds, peak bytes)."""
    from pretraining_llm_tpu_torch.training.metrics import MetricsLogger
    from pretraining_llm_tpu_torch.training.trainer import Trainer

    class Records(MetricsLogger):
        def __init__(self):
            super().__init__("", stream=sys.stderr)
            self.records = []

        def log(self, record):
            self.records.append(dict(record))
            super().log(record)

    logger = Records()
    trainer = Trainer(cfg, logger=logger, device=DEVICE, **trainer_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    trainer.train(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    steps_logged = [r for r in logger.records if "loss" in r]
    return trainer, steps_logged, launches, wall, torch.cuda.max_memory_allocated()


def _rates(records) -> dict:
    """Medians over the steps after the first two (the first window holds
    the first step's start-up; the second settles the allocator)."""
    timed = [r for r in records if r["step"] > 2 and "step_ms" in r]
    out = {k: statistics.median(r[k] for r in timed) for k in ("step_ms", "tokens_per_sec") if timed}
    if timed and "mfu" in timed[0]:
        out["mfu"] = statistics.median(r["mfu"] for r in timed)
    return out


def _free_card() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


T1_STEPS = 30


def t1_config():
    """T1's run: gpt2-124m on ``data/parity`` bytes, a checkpoint at its
    last step (which G1 then loads)."""
    return train_config("gpt2-124m", {
        "train.train_steps": T1_STEPS, "train.checkpoint_interval": T1_STEPS,
        "data.train_path": str(PARITY_DIR / "train.bin"), "data.val_path": str(PARITY_DIR / "val.bin"),
    })


def run_train_path1() -> dict:
    """T1, this slice's main path: ``Trainer.train`` on gpt2-124m at full
    width and depth (batch 12, T 1024, bf16 compute, fp32 params, flash
    attention, init from seed 0) for 30 steps on ``data/parity`` bytes,
    checkpointing at step 30. Then: 10 steps of the same run with
    ``attention_impl="naive"`` (every compared loss within NAIVE_LOSS_TOL),
    and the checkpoint round trip: a fresh ``Trainer`` that resumed the
    step-30 checkpoint holds every leaf of the state (params, AdamW mu, nu
    and count, step) and the data RNG bit for bit as the run left them, and
    its step 31 gives the uninterrupted run's loss and params bit for bit
    (every kernel of the bf16 path sums in a fixed order)."""
    from pretraining_llm_tpu_torch.training.metrics import MetricsLogger
    from pretraining_llm_tpu_torch.training.optimizer import tree_leaves
    from pretraining_llm_tpu_torch.training.trainer import Trainer

    shutil.rmtree(SCRATCH, ignore_errors=True)
    steps = T1_STEPS
    cfg = t1_config()
    trainer, recs, launches, wall, peak = train_run(cfg, steps, resume=False)
    losses = [r["loss"] for r in recs]
    rates = _rates(recs)

    # Checkpoint round trip: the step-30 state, step 31 uninterrupted, then
    # the same from a fresh Trainer resumed from the step-30 checkpoint.
    saved = [(path, x.detach().clone()) for path, x in tree_leaves(trainer.state)]
    saved_rng = trainer.train_iterator.state()
    uninterrupted = trainer.train(steps + 1)["loss"]
    after = {path: x.detach().clone() for path, x in tree_leaves(trainer.state["params"])}
    del trainer
    _free_card()
    resumed_trainer = Trainer(cfg, device=DEVICE, resume=True, logger=MetricsLogger("", stream=sys.stderr))
    resumed_from = resumed_trainer.start_step
    leaves = dict(tree_leaves(resumed_trainer.state))
    state_differs = [".".join(path) for path, x in saved
                     if path not in leaves or leaves[path].dtype != x.dtype or not torch.equal(leaves[path], x)]
    state_differs += [".".join(path) for path in leaves.keys() - {path for path, _ in saved}]
    rng_equal = resumed_trainer.train_iterator.state() == saved_rng
    del saved, leaves
    resumed = resumed_trainer.train(steps + 1)["loss"]
    param_diff = max(max_err(x, after[path]) for path, x in tree_leaves(resumed_trainer.state["params"]))
    del resumed_trainer, after
    _free_card()

    naive_cfg = cfg.with_overrides({"model.attention_impl": "naive", "train.checkpoint_interval": 0})
    n_steps = 10
    naive, naive_recs, naive_launches, _, naive_peak = train_run(naive_cfg, n_steps, resume=False)
    del naive
    _free_card()
    naive_losses = [r["loss"] for r in naive_recs]
    diffs = [abs(a - b) for a, b in zip(losses, naive_losses)]
    model = cfg.model
    log("train_path1", model="gpt2-124m", layers=model.n_layers, d=model.d_model, T=model.context_length,
        batch=cfg.train.batch_size, dtype=model.compute_dtype, data=str(PARITY_DIR / "train.bin"),
        steps=steps, lr=cfg.train.lr, wall_s=wall, **rates, max_memory_allocated_bytes=peak,
        losses=losses, launches=launches, naive_losses=naive_losses, naive_max_abs_diff=max(diffs),
        naive_tol=NAIVE_LOSS_TOL, naive_launches=naive_launches, naive_max_memory_allocated_bytes=naive_peak,
        checkpoint={"resumed_from": resumed_from, "state_leaves_differing": state_differs,
                    "data_rng_equal": rng_equal, "step": steps + 1, "loss_uninterrupted": uninterrupted,
                    "loss_resumed": resumed, "bit_identical": uninterrupted == resumed,
                    "params_max_abs_diff_after_step": param_diff})
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"T1: expected {steps} finite losses, got {losses}")
    if statistics.mean(losses[-5:]) > losses[0] - 1.0:
        raise AssertionError(f"T1: the last 5 losses do not average 1.0 below step 1's: {losses}")
    if launches["flash_fwd"] <= 0 or launches["flash_bwd_fused"] <= 0:
        raise AssertionError(f"T1 did not run the flash forward and one-pass backward kernels: {launches}")
    if launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
        raise AssertionError(f"T1 launched the split backward kernels: {launches}")
    if launches["flash_fwd_tc"] != launches["flash_fwd"] or launches["flash_bwd_fused_tc"] != launches["flash_bwd_fused"]:
        raise AssertionError(f"T1 (bf16) ran the flash forward or one pass off the tensor-core route: {launches}")
    if len(naive_losses) != n_steps or max(diffs) > NAIVE_LOSS_TOL:
        raise AssertionError(f"T1: flash run and naive run disagree: {losses[:n_steps]} vs {naive_losses}")
    if resumed_from != steps or state_differs or not rng_equal:
        raise AssertionError(f"T1: resume from step {resumed_from} restored a different state: leaves "
                             f"{state_differs}, data RNG equal {rng_equal}")
    if uninterrupted != resumed or param_diff != 0.0:
        raise AssertionError(f"T1: resumed step {steps + 1} gave loss {resumed} (uninterrupted {uninterrupted}), "
                             f"params {param_diff} apart")
    return launches


G1_NEW_TOKENS = 128


def run_g1() -> dict:
    """G1: the source's sample, evaluate and preprocess entry points on T1's
    step-30 checkpoint (gpt2-124m, full width and depth). Loads it through
    ``load_model_for_inference`` + ``cast_params_for_inference`` (bf16
    matmul weights), generates 128 greedy tokens for 8 prompts cut from
    ``data/parity/corpus.txt`` (17-600 bytes, byte tokenizer) with
    ``generate``, then again with ``generate_text_batch`` and a stop token
    that one row emits. Checks: each generate call launches K1 once per
    layer, all on the tensor cores, and no K2 or K3; every generated token
    is the argmax of one uncached forward over prompt + continuation, or
    within BF16_ROW_RTOL of that position's largest |logit|; the strings
    are the prompts plus the decoded tokens, cut at the stop token; the
    port's ``evaluate`` on the checkpoint equals the T1 ``Trainer``'s
    ``evaluate()`` on the numpy sampler bit for bit, and the ``Trainer``'s
    ``evaluate()`` at its defaults equals the same eval loop on the native
    batcher's eval batches bit for bit; a BPE trained on the corpus's first 200 KB
    (vocab 512) preprocesses the corpus into ``build/`` with the native
    encoder, whose ids equal the Python sweep's on a 64 KB sample, and the
    val document decodes back from its tokens. Returns G1's launches."""
    from pretraining_llm_tpu_torch.data import native_bpe
    from pretraining_llm_tpu_torch.data.bpe import BPETokenizer, ByteTokenizer
    from pretraining_llm_tpu_torch.data.preprocess import preprocess
    from pretraining_llm_tpu_torch.data.native_batcher import NativeBatchIterator
    from pretraining_llm_tpu_torch.data.tokenizer import get_tokenizer
    from pretraining_llm_tpu_torch.evaluate import eval_loss, evaluate
    from pretraining_llm_tpu_torch.generation.generate import (
        cast_params_for_inference, generate, generate_text_batch, load_model_for_inference,
    )
    from pretraining_llm_tpu_torch.models import transformer
    from pretraining_llm_tpu_torch.training.metrics import MetricsLogger
    from pretraining_llm_tpu_torch.training.train_step import build_eval_loop
    from pretraining_llm_tpu_torch.training.trainer import EVAL_SEED_OFFSET, Trainer

    t1 = t1_config()
    ckpt_dir = t1.train.checkpoint_dir
    t_start = time.perf_counter()
    params, cfg = load_model_for_inference(ckpt_dir, device=DEVICE)
    params = cast_params_for_inference(params, cfg.model)
    model = cfg.model
    load_s = time.perf_counter() - t_start

    text = (PARITY_DIR / "corpus.txt").read_text()
    rng = np.random.default_rng(SEED + 21)
    prompts = []
    for n in rng.choice(np.arange(17, 601), size=8, replace=False).tolist():
        while True:  # a window whose bytes are its characters
            start = int(rng.integers(0, len(text) - n))
            if len(text[start:start + n].encode()) == n:
                break
        prompts.append(text[start:start + n])
    enc = ByteTokenizer()
    encoded = [enc.encode_ordinary(p) for p in prompts]
    lens = [len(e) for e in encoded]
    batch = np.zeros((len(prompts), max(lens)), np.int64)
    for i, e in enumerate(encoded):
        batch[i, :len(e)] = e

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    reset_kernel_counts()
    t0 = time.perf_counter()
    ids = generate(params, model, batch, G1_NEW_TOKENS, 0, temperature=0.0, prompt_lengths=lens, stats=stats)
    wall = time.perf_counter() - t0  # generate synchronizes before it returns (stats)
    gen_launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    ids = ids.cpu().numpy()

    # Teacher forcing: one uncached forward over prompt + continuation.
    seqs = [e + row.tolist() for e, row in zip(encoded, ids)]
    full = np.zeros((len(seqs), max(map(len, seqs))), np.int64)
    for i, sq in enumerate(seqs):
        full[i, :len(sq)] = sq
    with torch.no_grad():
        logits, _ = transformer.forward(params, torch.from_numpy(full).to(DEVICE), model)
        worst_use, argmax_hits = 0.0, 0
        for i, n in enumerate(lens):
            rows = logits[i, n - 1:n - 1 + G1_NEW_TOKENS]  # row j predicts ids[i, j]
            want = torch.from_numpy(ids[i]).to(DEVICE).long()
            top, picked = rows.max(-1).values, rows.gather(1, want[:, None])[:, 0]
            argmax_hits += int((rows.argmax(-1) == want).sum())
            limit = BF16_ROW_RTOL * rows.abs().amax(-1)
            worst_use = max(worst_use, ((top - picked) / limit).max().item())
    del logits, params
    _free_card()

    # The stop token: the first token, at step 8 or later, that a row emits
    # for the first time (else at step 1 or later).
    stop, stop_row = None, None
    for lo in (8, 1, 0):
        for i, row in enumerate(ids.tolist()):
            firsts = [j for j in range(lo, len(row)) if row[j] not in row[:j]]
            if firsts:
                stop, stop_row = row[firsts[0]], i
                break
        if stop is not None:
            break
    reset_kernel_counts()
    texts = generate_text_batch(str(ckpt_dir), prompts, G1_NEW_TOKENS, temperature=0.0, tokenizer="byte",
                                stop_token=stop, device=DEVICE)
    text_launches = kernel_counts()
    expected = [p + enc.decode(row[:row.index(stop)] if stop in row else row)
                for p, row in zip(prompts, ids.tolist())]
    texts_ok = texts == expected
    _free_card()

    # Evaluate: the port's entry point against the T1 Trainer's evaluate().
    params32, cfg32 = load_model_for_inference(ckpt_dir, device=DEVICE)
    val = str(PARITY_DIR / "val.bin")
    port_loss = eval_loss(params32, cfg32, val, iters=t1.train.eval_iters)
    # The same eval loop on the native gatherer's eval batches, which the
    # Trainer's evaluate() draws at its defaults.
    native_it = NativeBatchIterator(val, t1.train.batch_size, t1.model.context_length,
                                    seed=t1.data.sample_seed + EVAL_SEED_OFFSET)
    xs, ys = zip(*(next(native_it) for _ in range(t1.train.eval_iters)))
    native_it.close()
    native_loss = float(build_eval_loop(cfg32)({"params": params32}, (
        torch.from_numpy(np.stack(xs)).to(DEVICE), torch.from_numpy(np.stack(ys)).to(DEVICE))))
    del params32
    record = evaluate(str(ckpt_dir), val, iters=t1.train.eval_iters, device=DEVICE)
    # The evaluate entry point samples with the numpy sampler (as
    # scripts/evaluate.py does): one Trainer is given the same sampler, and
    # one stays at its defaults (the native batcher).
    trainer = Trainer(t1.with_overrides({"data.use_native_batcher": False}), device=DEVICE, resume=True,
                      logger=MetricsLogger("", stream=sys.stderr))
    trainer_loss = trainer.evaluate()
    resumed_from = trainer.start_step
    del trainer
    trainer = Trainer(t1, device=DEVICE, resume=True, logger=MetricsLogger("", stream=sys.stderr))
    native_trainer_loss = trainer.evaluate()
    del trainer
    _free_card()

    # Preprocess with a BPE trained here, into build/.
    g1_dir = SCRATCH / "g1"
    g1_dir.mkdir(parents=True, exist_ok=True)
    lib, why = native_bpe.load_library()
    if lib is None:
        raise AssertionError(f"G1: the native BPE encoder did not build: {why}")
    corpus = (PARITY_DIR / "corpus.txt").read_bytes()
    t_bpe = time.perf_counter()
    bpe = BPETokenizer.train([corpus[:200_000].decode("utf-8", errors="ignore")], 512)
    bpe_train_s = time.perf_counter() - t_bpe
    bpe_path = str(g1_dir / "bpe.json")
    bpe.save(bpe_path)
    t_pre = time.perf_counter()
    train_bin, val_bin = preprocess(input_files=[str(PARITY_DIR / "corpus.txt")], out_dir=str(g1_dir / "data"),
                                    tokenizer_name=bpe_path)
    preprocess_s = time.perf_counter() - t_pre
    tok = get_tokenizer(bpe_path)
    cut = max(1, int(len(text) * (1 - 0.01)))  # preprocess's val tail of a one-document corpus
    val_ids = np.fromfile(val_bin, dtype=np.uint16)
    round_trip = tok.decode(val_ids.tolist()) == text[cut:] and int(val_ids[-1]) == tok.eot_token
    sample = corpus[1_000_000:1_000_000 + 65_536]
    native_ids = native_bpe.NativeBpeEncoder(bpe.merges).encode_bytes(sample)
    native_equal = native_ids == bpe._encode_python(list(sample))

    k1 = {k: gen_launches[k] + text_launches[k] for k in ("flash_fwd", "flash_fwd_tc", "flash_fwd_fp32")}
    per_call_ok = all(
        c["flash_fwd"] == c["flash_fwd_tc"] == model.n_layers and c["flash_fwd_fp32"] == 0
        and c["paged_decode"] == 0 and c["ragged"] == 0
        for c in (gen_launches, text_launches)
    )
    log("G1", model="gpt2-124m", layers=model.n_layers, dtype=model.compute_dtype,
        checkpoint=str(ckpt_dir), load_s=load_s, prompts=len(prompts), prompt_lens=lens,
        new_tokens=G1_NEW_TOKENS, prefill_tokens=stats["prefill_tokens"], prefill_s=stats["prefill_s"],
        prefill_tokens_per_s=stats["prefill_tokens"] / stats["prefill_s"],
        decode_tokens=stats["decode_tokens"], decode_s=stats["decode_s"],
        decode_tokens_per_s=stats["decode_tokens"] / stats["decode_s"], wall_s=wall,
        max_memory_allocated_bytes=peak, k1_launches_by_route=k1,
        launches_generate={k: n for k, n in gen_launches.items() if n},
        launches_generate_text_batch={k: n for k, n in text_launches.items() if n},
        teacher_forcing={"argmax_hits": argmax_hits, "tokens": len(prompts) * G1_NEW_TOKENS,
                         "worst_bf16_bar_use": worst_use, "bar": BF16_ROW_RTOL},
        stop_token={"id": stop, "row": stop_row, "texts_equal": texts_ok},
        evaluate={"port": port_loss, "trainer": trainer_loss, "bit_identical": port_loss == trainer_loss,
                  "record_val_loss": record["val_loss"], "resumed_from": resumed_from,
                  "iters": t1.train.eval_iters, "native": native_loss, "native_trainer": native_trainer_loss},
        bpe={"encoder": tok.encoder, "library": why, "vocab": bpe.n_vocab, "train_s": bpe_train_s,
             "preprocess_s": preprocess_s, "val_round_trip": round_trip, "native_equals_python_64kb": native_equal,
             "train_tokens": int(os.path.getsize(train_bin) // 2), "val_tokens": int(val_ids.size)})
    if not per_call_ok:
        raise AssertionError(f"G1: a generate call did not launch K1 once per layer on the tensor cores alone: "
                             f"{gen_launches} {text_launches}")
    if not worst_use <= 1.0:
        raise AssertionError(f"G1: a generated token is off the uncached forward's argmax by {worst_use}x the bar")
    if not texts_ok:
        raise AssertionError(f"G1: generate_text_batch gave other strings than generate's tokens: {texts}")
    if not (port_loss == trainer_loss and record["val_loss"] == round(trainer_loss, 6)
            and resumed_from == T1_STEPS and math.isfinite(port_loss)):
        raise AssertionError(f"G1: evaluate {port_loss} != the Trainer's {trainer_loss} (resumed {resumed_from})")
    if not (native_loss == native_trainer_loss and math.isfinite(native_loss)):
        raise AssertionError(f"G1: the default Trainer's evaluate() {native_trainer_loss} != the eval loop on "
                             f"the native batches {native_loss}")
    if not (round_trip and native_equal and tok.encoder == "native"):
        raise AssertionError(f"G1: BPE round trip {round_trip}, native == python {native_equal}, "
                             f"encoder {tok.encoder}")
    return {k: gen_launches[k] + text_launches[k] for k in gen_launches}


def run_train_path2() -> dict:
    """T2: ``Trainer.train`` on llama3-1b-gqa at full width cut to 4 of its
    22 layers (T 2048, 16 heads, 4 KV heads, Dh 128) for 10 steps at batch
    2 on synthetic data: the flash forward and the dQ + dK/dV kernels.
    Then 5 steps with ``attention_impl="naive"`` (losses within
    NAIVE_LOSS_TOL)."""
    steps, n_steps = 10, 5
    cfg = train_config("llama3-1b-gqa", {
        "model.n_layers": 4, "train.batch_size": 2, "train.train_steps": steps,
    })
    trainer, recs, launches, wall, peak = train_run(cfg, steps, synthetic_data=True, resume=False)
    del trainer
    _free_card()
    naive_cfg = cfg.with_overrides({"model.attention_impl": "naive"})
    naive, naive_recs, _, _, _ = train_run(naive_cfg, n_steps, synthetic_data=True, resume=False)
    del naive
    _free_card()
    losses = [r["loss"] for r in recs]
    naive_losses = [r["loss"] for r in naive_recs]
    diffs = [abs(a - b) for a, b in zip(losses, naive_losses)]
    model = cfg.model
    log("train_path2", model="llama3-1b-gqa", layers=model.n_layers, layers_full=22, d=model.d_model,
        H=model.n_heads, G=model.kv_heads, T=model.context_length, batch=cfg.train.batch_size,
        dtype=model.compute_dtype, data="synthetic", steps=steps, wall_s=wall, **_rates(recs),
        max_memory_allocated_bytes=peak, losses=losses, launches=launches, naive_losses=naive_losses,
        naive_max_abs_diff=max(diffs), naive_tol=NAIVE_LOSS_TOL)
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"T2: expected {steps} finite losses, got {losses}")
    if launches["flash_bwd_dq"] <= 0 or launches["flash_bwd_dkv"] <= 0 or launches["flash_fwd"] <= 0:
        raise AssertionError(f"T2 did not run the flash forward and dQ + dK/dV kernels: {launches}")
    if launches["flash_bwd_fused"]:
        raise AssertionError(f"T2 launched the one-pass backward kernel: {launches}")
    if any(launches[f"{k}_tc"] != launches[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        raise AssertionError(f"T2 (bf16) ran the flash forward, dQ or dK/dV off the tensor-core route: {launches}")
    if len(naive_losses) != n_steps or max(diffs) > NAIVE_LOSS_TOL:
        raise AssertionError(f"T2: flash run and naive run disagree: {losses[:n_steps]} vs {naive_losses}")
    return launches


def run_train_path3() -> dict:
    """T3, this slice's main path: ``Trainer.train`` on gpt2-124m at full
    width and depth (12 layers, d 768, T 1024, V 50304, bf16 compute, fp32
    params, init from seed 0) with ``ce_impl="fused"`` and
    ``doc_mask_token=DOC_SEP``, batch 12, 20 AdamW steps on ``data/parity``
    bytes (T1's lr 6e-4 and 3 warmup steps), no eval: the fused CE kernels
    B9-B11 once each per step, K1 and the one-pass backward with segments
    in every layer.

    Then its all-torch-ops twin (``ce_impl="chunked"``,
    ``attention_impl="naive"``), held on T3's own states: the same run
    again for 10 steps (``utils/trajectory.py::same_state``), where before
    each step the path's and the twin's loss and gradients of the step's
    params and batch are taken: each loss within NAIVE_LOSS_TOL, and every
    parameter's gradient within ``trajectory.T3_GRAD_RTOL`` of the twin's
    (relative to the twin's norm), so B10, B11 and the segmented backward are held at
    every state, not only at init. A leaf over that bar passes only where
    the twin is at least T3_TWIN_OFF from the fp32 gradient and the path
    no farther from it than the twin. Two independent runs are not compared:
    on this data a grad-norm spike at step 8 comes and goes with a one-ulp
    move of the init and carries a run 0.09-0.12 in loss from its unmoved
    self by step 10, past NAIVE_LOSS_TOL, whatever the head and attention
    (``python -m pretraining_llm_tpu_torch.utils.trajectory``; PERF.md)."""
    from pretraining_llm_tpu_torch.utils import trajectory

    cfg = trajectory.t3_config().with_overrides({
        "model.ce_impl": "fused", "train.log_interval": 1, "train.checkpoint_dir": str(SCRATCH / "gpt2-124m")})
    steps, n_steps = cfg.train.train_steps, trajectory.STEPS
    trainer, recs, launches, wall, peak = train_run(cfg, steps, resume=False)
    del trainer
    _free_card()
    losses = [r["loss"] for r in recs]
    held = trajectory.same_state(cfg, n_steps, DEVICE, ["fused_flash"])
    _free_card()
    model = cfg.model
    want = {"fused_ce_fwd": steps, "fused_ce_fwd_wgmma": steps, "fused_ce_fwd_fp32": 0,
            "fused_ce_dh": steps, "fused_ce_dh_wgmma": steps, "fused_ce_dh_fp32": 0,
            "fused_ce_dw": steps, "fused_ce_dw_wgmma": steps, "fused_ce_dw_fp32": 0,
            "flash_fwd": model.n_layers * steps, "flash_fwd_tc": model.n_layers * steps, "flash_fwd_fp32": 0,
            "flash_bwd_fused": model.n_layers * steps, "flash_bwd_fused_tc": model.n_layers * steps,
            "flash_bwd_fused_fp32": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    loss_diffs = [r["fused_flash"]["loss_diff"] for r in held]
    grad_diffs = [r["fused_flash"]["max_rel_grad_diff"] for r in held]
    verdicts = {(r["step"], k): trajectory.held_by(u, trajectory.T3_GRAD_RTOL, trajectory.T3_TWIN_OFF)
                for r in held for k, u in r["fused_flash"]["leaves"].items()}
    off_twin = {f"{s}:{k}": dict(held[s - 1]["fused_flash"]["leaves"][k], held_by=v)
                for (s, k), v in verdicts.items() if v != "twin"}
    log("train_path3", model="gpt2-124m", layers=model.n_layers, d=model.d_model, T=model.context_length,
        V=model.vocab_size, batch=cfg.train.batch_size, dtype=model.compute_dtype, ce_impl=model.ce_impl,
        doc_mask_token=model.doc_mask_token, data=cfg.data.train_path, steps=steps, lr=cfg.train.lr,
        warmup_steps=cfg.train.warmup_frac * steps, wall_s=wall, **_rates(recs), max_memory_allocated_bytes=peak,
        losses=losses, launches=launches, expected_launches=want, twin="ce_impl=chunked, attention_impl=naive",
        same_state_twin_losses=[r["twin_loss"] for r in held], same_state_loss_diffs=loss_diffs,
        same_state_max_rel_grad_diffs=grad_diffs, same_state_worst_leaves=[r["fused_flash"]["leaf"] for r in held],
        same_state_off_twin=off_twin, loss_tol=NAIVE_LOSS_TOL, grad_rtol=trajectory.T3_GRAD_RTOL,
        twin_off=trajectory.T3_TWIN_OFF)
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"T3: expected {steps} finite losses, got {losses}")
    if statistics.mean(losses[-5:]) > losses[0] - 1.0:
        raise AssertionError(f"T3: the last 5 losses do not average 1.0 below step 1's: {losses}")
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"T3 launched {launches}, expected {want}")
    within = all(abs(x) <= NAIVE_LOSS_TOL for x in loss_diffs) and None not in verdicts.values()
    if len(held) != n_steps or not within:  # a NaN fails the comparisons
        raise AssertionError(f"T3 and its twin disagree on the same states: {loss_diffs}, {off_twin}")
    return launches


# The parity run's TrainConfig: scripts/parity_experiment.py:60-66 and
# :136-146, copied.
PARITY_TRAIN = dict(batch_size=16, lr=3e-4, lr_schedule="warmup_constant", warmup_frac=0.05,
                    grad_clip=1.0, weight_decay=0.1, adam_b1=0.9, adam_b2=0.95, adam_eps=1e-8,
                    checkpoint_interval=0, eval_interval=0, train_steps=1500)
PARITY_DATA_SEED, PARITY_EVAL_SEED, PARITY_EVAL_ITERS = 1234, 4321, 50


def run_parity() -> dict:
    """The golden run on the card: the ``__model_kw__`` model of
    ``data/parity/init.npz`` (4 layers, d 256, 8 heads, T 256, V 256, fp32)
    with ``attention_impl="flash"``, from those weights, 1500 AdamW steps on
    ``train.bin`` (batch 16, seed 1234), then 50 eval batches of
    ``val.bin`` (seed 4321); TF32 is off. Held against the JAX package's
    recorded curve and eval loss (``results.json["jax"]``)."""
    from pretraining_llm_tpu_torch.config import Config, ModelConfig, TrainConfig
    from pretraining_llm_tpu_torch.data import loader
    from pretraining_llm_tpu_torch.models import bridge
    from pretraining_llm_tpu_torch.training import optimizer as opt
    from pretraining_llm_tpu_torch.training import train_step as ts

    raw = dict(np.load(PARITY_DIR / "init.npz"))
    model_kw = json.loads(bytes(raw.pop("__model_kw__")).decode())
    tree: dict = {}
    for key, arr in raw.items():
        *parents, leaf = key.split("__")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    recorded = json.loads((PARITY_DIR / "results.json").read_text())["jax"]
    want = {p["step"]: p["loss"] for p in recorded["curve"]}
    cfg = Config(model=ModelConfig(**dict(model_kw, attention_impl="flash")),
                 train=TrainConfig(**PARITY_TRAIN), name="parity")
    params = bridge.params_from_numpy(tree, cfg.model, device=DEVICE)
    state = {"params": params, "opt": opt.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=DEVICE)}
    step = ts.build_train_step(cfg)
    batches = loader.get_batch_iterator(str(PARITY_DIR / "train.bin"), cfg.train.batch_size,
                                        cfg.model.context_length, seed=PARITY_DATA_SEED)
    dev = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731

    reset_kernel_counts()
    t0 = time.perf_counter()
    got = {}
    for s in range(1, cfg.train.train_steps + 1):
        x, y = next(batches)
        state, metrics = step(state, (dev(x), dev(y)))
        if s in want:
            got[s] = float(metrics["loss"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    ev = loader.get_batch_iterator(str(PARITY_DIR / "val.bin"), cfg.train.batch_size,
                                   cfg.model.context_length, seed=PARITY_EVAL_SEED)
    xs, ys = zip(*(next(ev) for _ in range(PARITY_EVAL_ITERS)))
    eval_loss = float(ts.build_eval_loop(cfg)(state, (dev(np.stack(xs)), dev(np.stack(ys)))))
    launches = kernel_counts()
    worst = max(abs(got[s] - want[s]) for s in want)
    log("parity", model=model_kw, steps=cfg.train.train_steps, train_s=train_s,
        step_ms=train_s / cfg.train.train_steps * 1e3,
        curve=[{"step": s, "loss": got[s], "jax": want[s], "diff": got[s] - want[s]} for s in sorted(want)],
        max_abs_diff=worst, tol=PARITY_LOSS_TOL, eval_loss=eval_loss, jax_eval_loss=recorded["eval_loss"],
        eval_diff=eval_loss - recorded["eval_loss"], eval_tol=PARITY_EVAL_TOL, launches=launches)
    if worst > PARITY_LOSS_TOL or abs(eval_loss - recorded["eval_loss"]) > PARITY_EVAL_TOL:
        raise AssertionError("parity run on the card left the recorded JAX curve")
    if launches["flash_fwd"] <= 0 or launches["flash_bwd_fused"] <= 0:
        raise AssertionError(f"parity run did not go through the flash kernels: {launches}")
    flash = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
    if any(launches[f"{k}_fp32"] != launches[k] or launches[f"{k}_tc"] for k in flash):
        raise AssertionError(f"parity run (fp32) left the CUDA-core flash kernels: {launches}")
    return launches


# Phases added with the presets, remat and trainer-option slice.
T4_PRESETS = (  # (preset, the microbatches tried first: the JAX preset's, or 2 where one pass cannot fit)
    ("gpt2-350m-dp", 1), ("gpt2-1p3b-fsdp", 2), ("llama-1b", 2), ("reference-3b", 2))
T4_STEPS = 4
CARD_BYTES = 80e9  # the card's 80 GB
RECOMPUTES_K1 = ("full", "dots_saveable", "save_attn")  # remat policies under which K1 reruns in the backward
R_STEPS = 3


def _no_checkpoint_dir() -> str:
    """A checkpoint dir that cannot be created (a file stands in its
    place): a failing step's emergency save fails at once instead of
    writing the full-size state to disk."""
    SCRATCH.mkdir(parents=True, exist_ok=True)
    blocker = SCRATCH / "no-checkpoints"
    blocker.touch()
    return str(blocker / "ck")


def _route_check(name: str, launches: dict, one_pass: bool, layers: int, k1_per_layer: int, passes: int) -> None:
    """Every flash launch on the tensor cores, the backward's algorithm as
    the JAX block rule picks it, and the exact counts: K1 ``k1_per_layer``
    times a layer per forward-backward pass, each backward kernel once."""
    want = {"flash_fwd": layers * k1_per_layer * passes,
            "flash_bwd_fused": layers * passes if one_pass else 0,
            "flash_bwd_dq": 0 if one_pass else layers * passes,
            "flash_bwd_dkv": 0 if one_pass else layers * passes}
    got = {k: launches[k] for k in want}
    if got != want or any(launches[f"{k}_tc"] != n for k, n in want.items()):
        raise AssertionError(f"{name}: flash launches {launches}, expected {want} all on the tensor cores")


def run_t4() -> dict:
    """T4: ``Trainer.train`` on each single-card preset that T1-T3 do not
    run, at full width and depth with the preset's own remat policy, bf16
    compute, fp32 params and AdamW, for T4_STEPS steps at the preset's
    global batch on synthetic data, no checkpoints. The global batch runs
    as the preset's microbatches, or twice as many after an out-of-memory
    error or a peak at CARD_BYTES or above. Returns {"T4 <preset>":
    launches}."""
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.ops import cuda_flash

    out = {}
    for preset, micro in T4_PRESETS:
        model = get_preset(preset).model
        batch = get_preset(preset).train.batch_size
        t0 = time.perf_counter()
        tried = []
        while True:
            cfg = train_config(preset, {"train.train_steps": T4_STEPS, "train.microbatches": micro,
                                        "train.checkpoint_dir": _no_checkpoint_dir()})
            try:
                trainer, recs, launches, wall, peak = train_run(cfg, T4_STEPS, synthetic_data=True, resume=False)
                del trainer
            except torch.cuda.OutOfMemoryError as e:
                tried.append({"microbatches": micro, "error": str(e).splitlines()[0][:160]})
                peak = None
            _free_card()
            if peak is not None and peak < CARD_BYTES:
                break
            if peak is not None:
                tried.append({"microbatches": micro, "max_memory_allocated_bytes": peak})
            micro *= 2
            if batch % micro:
                raise AssertionError(f"T4 {preset}: no microbatch count fits: {tried}")
        losses = [r["loss"] for r in recs]
        one_pass = cuda_flash.backward_is_one_pass(model.context_length, model.flash_block_q, model.flash_block_kv)
        log("train_t4", preset=preset, params=model.num_params(), layers=model.n_layers, d=model.d_model,
            H=model.n_heads, G=model.kv_heads, Dh=model.head_dim, T=model.context_length, V=model.vocab_size,
            remat=model.remat, batch=batch, microbatches=micro, tried=tried, dtype=model.compute_dtype,
            data="synthetic", steps=T4_STEPS, wall_s=wall, **_rates(recs), max_memory_allocated_bytes=peak,
            card_bytes=CARD_BYTES, losses=losses, launches={k: v for k, v in launches.items() if v},
            backward="one pass" if one_pass else "dq + dkv", phase_s=time.perf_counter() - t0)
        if len(losses) != T4_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"T4 {preset}: expected {T4_STEPS} finite losses, got {losses}")
        _route_check(f"T4 {preset}", launches, one_pass, model.n_layers,
                     2 if model.remat in RECOMPUTES_K1 else 1, T4_STEPS * micro)
        out[f"T4 {preset}"] = launches
    return out


M1_STEPS = 4
M1_MICRO = 4  # microbatches tried first: 8 x 1024 tokens each, 4 routing groups of 2048
M1_PROMPTS = (8, 256)  # generate from the step-4 weights: rows x prompt tokens (equal lengths: MoE)
M1_NEW_TOKENS = 64
M1_EVAL_ITERS = 4
M1_CHECK_STEPS = 8  # cached greedy steps held against one uncached forward


@contextlib.contextmanager
def recording_route(record):
    """Replaces ``moe.route`` while the block runs with a stand-in that
    passes each forward call's (router logits, routing) to ``record``, not
    the recompute in the backward (a remat policy reruns the layer
    there)."""
    from pretraining_llm_tpu_torch.models import moe

    real = moe.route

    def recording(logits, cfg, capacity):
        r = real(logits, cfg, capacity)
        if torch._C._current_graph_task_id() == -1:  # not inside the backward
            record(logits, r)
        return r

    moe.route = recording
    try:
        yield
    finally:
        moe.route = real


def m1_decode_check(params, model, prompts) -> dict:
    """The cached MoE decode (``decode=True`` routing, the cache index, the
    fp32 router) against one uncached forward. ``generate`` of
    M1_CHECK_STEPS greedy tokens from ``prompts`` with the capacity factor
    raised to n_experts / top_k, so that no (token, choice) drops in the
    prefill either (decode routes with every choice kept), then one
    uncached forward of prompt + continuation under that config, both
    recording each token's experts. Each row's step logits within
    BF16_ROW_RTOL of that position's largest |logit|, up to the row's
    first routing difference, which must be a near tie: the uncached run's
    k-th and (k+1)-th router probabilities within BF16_ROW_RTOL of the k-th
    (hidden states a few bf16 roundings apart).
    Returns the fields to log; raises on a failure."""
    import dataclasses

    from pretraining_llm_tpu_torch.generation.generate import generate
    from pretraining_llm_tpu_torch.models import moe, transformer

    rows, plen = prompts.shape
    layers = model.n_layers
    k = model.experts_per_token
    no_drop = dataclasses.replace(model, expert_capacity_factor=model.n_experts / k)
    if moe.expert_capacity(no_drop, prompts.numel()) != prompts.numel():
        raise AssertionError("M1: the raised capacity factor still drops choices")
    routes = []  # per routed call: each token's k experts (sorted) and top k + 1 router probabilities

    def record(router_logits, r):
        top = torch.sort(torch.softmax(router_logits, dim=-1), dim=-1, descending=True).values
        routes.append((r.idx.sort(dim=-1).values.cpu(), top[..., : k + 1].cpu()))

    with recording_route(record):
        check_toks, step_logits = generate(params, no_drop, prompts, M1_CHECK_STEPS, 0,
                                           temperature=0.0, return_logits=True)
        full = torch.cat([prompts, check_toks[:, :-1]], dim=1)
        with torch.no_grad():
            logits, _ = transformer.forward(params, full, no_drop)
    if len(routes) != (M1_CHECK_STEPS + 1) * layers:
        raise AssertionError(f"M1: {len(routes)} routed calls in the decode check")
    # (layer, row, position) experts of the cached run (the prefill, then
    # one decode step a call) and of the uncached forward.
    got = torch.stack([torch.cat([routes[s * layers + i][0].reshape(rows, -1, k) for s in range(M1_CHECK_STEPS)],
                                 dim=1) for i in range(layers)])
    want = torch.stack([routes[M1_CHECK_STEPS * layers + i][0].reshape(rows, -1, k) for i in range(layers)])
    want_top = torch.stack([routes[M1_CHECK_STEPS * layers + i][1].reshape(rows, -1, k + 1) for i in range(layers)])
    differs = (got != want).any(-1)  # (layer, row, position)
    # A row is compared up to its first routing difference: the flip
    # changes that position's output and, through attention, every later
    # one. That first flip must be a near tie of the uncached run's k-th
    # and (k+1)-th router probabilities.
    compared, flip_gaps = [], []
    for i in range(rows):
        pos = differs[:, i].any(0).nonzero()
        if not len(pos):
            compared.append(M1_CHECK_STEPS)
            continue
        p = int(pos[0])
        layer = int(differs[:, i, p].nonzero()[0])
        kth, nxt = want_top[layer, i, p, k - 1].item(), want_top[layer, i, p, k].item()
        flip_gaps.append({"row": i, "position": p, "layer": layer, "relative_gap": (kth - nxt) / kth})
        compared.append(max(0, min(M1_CHECK_STEPS, p - (plen - 1))))
    ref = logits[:, plen - 1:].float()  # position P - 1 + j predicts step j
    cached = step_logits.float()
    row_use = (cached - ref).abs().amax(-1) / (BF16_ROW_RTOL * ref.abs().amax(-1))  # (row, step)
    decode_use = max((row_use[i, :n].max().item() for i, n in enumerate(compared) if n), default=0.0)
    argmax_equal = (cached.argmax(-1) == ref.argmax(-1)).float().mean().item()
    fields = dict(steps=M1_CHECK_STEPS, capacity_factor=no_drop.expert_capacity_factor,
                  steps_compared_per_row=compared, routing_flips=flip_gaps,
                  bar=BF16_ROW_RTOL, bar_use=decode_use, bar_use_per_step_all_rows=row_use.amax(0).tolist(),
                  argmax_equal_share=argmax_equal)
    if not decode_use <= 1.0:
        raise AssertionError(f"M1: cached MoE decode off the uncached forward: {fields}")
    if not all(f["relative_gap"] <= BF16_ROW_RTOL for f in flip_gaps):
        raise AssertionError(f"M1: the cached decode routes a token away from the uncached run: {fields}")
    return fields


def run_m1() -> dict:
    """M1: ``Trainer.train`` on moe-8x350m at full width and depth (24
    layers, d 1024, 16 heads, d_ff 4096, 8 experts, top-2, capacity factor
    1.25, routing groups of 2048 tokens, V 50304, T 1024, tied head,
    ``dots_saveable``, bf16 compute, fp32 params, AdamW), M1_STEPS steps at
    the preset's global batch of 32 x 1024 synthetic tokens in M1_MICRO
    microbatches, or twice as many after an out-of-memory error or a peak at
    CARD_BYTES or above. Logs step ms, tokens/s, MFU on the active FLOPs
    (``flops_per_token``), peak memory, the losses, the router's aux term
    per step (summed over layers, the microbatches' mean; the loss less
    ``router_aux_coef`` times it is the step's cross-entropy) and the dropped
    (token, choice) pairs per layer at step 1, and asserts the K1 and
    one-pass launches (K1 twice a layer: ``dots_saveable`` recomputes it).
    Then ``generate`` from the step-4 weights (cast for inference): M1_PROMPTS
    equal-length random prompts, M1_NEW_TOKENS greedy tokens, prefill and
    decode tokens/s, K1 once a layer; then the trainer's ``evaluate`` on
    M1_EVAL_ITERS batches (pure cross-entropy); last, ``m1_decode_check``
    from the same prompts. Returns {"M1": launches, "M1 generate":
    launches}."""
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.generate import generate
    from pretraining_llm_tpu_torch.models import bridge, moe

    preset = "moe-8x350m"
    model = get_preset(preset).model
    batch = get_preset(preset).train.batch_size
    micro, tried, records = M1_MICRO, [], []
    t0 = time.perf_counter()
    with recording_route(lambda _, r: records.append((r.aux.detach().mean(), (~r.keep).sum()))):
        while True:
            records.clear()
            cfg = train_config(preset, {"train.train_steps": M1_STEPS, "train.microbatches": micro,
                                        "train.checkpoint_dir": _no_checkpoint_dir()})
            try:
                trainer, recs, launches, wall, peak = train_run(cfg, M1_STEPS, synthetic_data=True, resume=False)
            except torch.cuda.OutOfMemoryError as e:
                tried.append({"microbatches": micro, "error": str(e).splitlines()[0][:160]})
                trainer, peak = None, None
                _free_card()
            if peak is not None and peak < CARD_BYTES:
                break
            if peak is not None:
                tried.append({"microbatches": micro, "max_memory_allocated_bytes": peak})
                del trainer
                _free_card()
            micro *= 2
            if batch % micro:
                raise AssertionError(f"M1: no microbatch count fits: {tried}")
    layers = model.n_layers
    per_step = micro * layers
    if len(records) != M1_STEPS * per_step:
        raise AssertionError(f"M1: {len(records)} routed forward calls, expected {M1_STEPS * per_step}")
    aux = torch.stack([a for a, _ in records]).float().reshape(M1_STEPS, micro, layers).cpu()
    dropped = torch.stack([n for _, n in records]).reshape(M1_STEPS, micro, layers).cpu()
    aux_per_step = aux.sum(-1).mean(-1).tolist()
    dropped_step1 = dropped[0].sum(0).tolist()
    losses = [r["loss"] for r in recs]
    tokens_micro = batch // micro * model.context_length
    groups = tokens_micro // model.moe_group_size if tokens_micro > model.moe_group_size else 1
    log("train_m1", preset=preset, params=model.num_params(), active_params=model.num_active_params(),
        flops_per_token=model.flops_per_token(), layers=layers, d=model.d_model, H=model.n_heads,
        d_ff=model.d_ff, experts=model.n_experts, top_k=model.experts_per_token,
        capacity_factor=model.expert_capacity_factor, groups_per_microbatch=groups,
        capacity_per_group=moe.expert_capacity(model, tokens_micro // groups), T=model.context_length,
        V=model.vocab_size, remat=model.remat, batch=batch, microbatches=micro, tried=tried,
        dtype=model.compute_dtype, data="synthetic", steps=M1_STEPS, wall_s=wall, **_rates(recs),
        max_memory_allocated_bytes=peak, card_bytes=CARD_BYTES, losses=losses, aux_per_step=aux_per_step,
        router_aux_coef=model.router_aux_coef,
        cross_entropy_per_step=[x - model.router_aux_coef * a for x, a in zip(losses, aux_per_step)],
        dropped_choices_per_layer_step1=dropped_step1,
        choices_per_layer=batch * model.context_length * model.experts_per_token,
        launches={k: v for k, v in launches.items() if v})
    if len(losses) != M1_STEPS or not all(math.isfinite(x) for x in losses + aux_per_step):
        raise AssertionError(f"M1: expected {M1_STEPS} finite losses and aux terms: {losses}, {aux_per_step}")
    _route_check("M1", launches, True, layers, 2, M1_STEPS * micro)

    params = bridge.cast_params_for_inference(trainer.state["params"], model)
    prompts = torch.from_numpy(np.random.default_rng(SEED + 41).integers(0, model.vocab_size, M1_PROMPTS))
    stats = {}
    reset_kernel_counts()
    toks = generate(params, model, prompts.to(DEVICE), M1_NEW_TOKENS, 0, temperature=0.0, stats=stats)
    torch.cuda.synchronize()
    gen_launches = kernel_counts()
    eval_loss = trainer.evaluate(M1_EVAL_ITERS)

    decode = m1_decode_check(params, model, prompts.to(DEVICE))
    del params
    log("generate_m1", rows=M1_PROMPTS[0], prompt_tokens=M1_PROMPTS[1], new_tokens=M1_NEW_TOKENS,
        prefill_tokens_per_s=stats["prefill_tokens"] / stats["prefill_s"],
        decode_tokens_per_s=stats["decode_tokens"] / stats["decode_s"], **stats,
        launches={k: v for k, v in gen_launches.items() if v}, eval_iters=M1_EVAL_ITERS, eval_loss=eval_loss,
        decode_check=decode, phase_s=time.perf_counter() - t0)
    if tuple(toks.shape) != (M1_PROMPTS[0], M1_NEW_TOKENS) or not (0 <= int(toks.min()) and
                                                                   int(toks.max()) < model.vocab_size):
        raise AssertionError(f"M1 generate: tokens of shape {tuple(toks.shape)} in [{toks.min()}, {toks.max()}]")
    if gen_launches["flash_fwd_tc"] != layers or gen_launches["flash_fwd"] != layers:
        raise AssertionError(f"M1 generate: K1 launches {gen_launches['flash_fwd']}, expected {layers}")
    if not math.isfinite(eval_loss):
        raise AssertionError(f"M1 evaluate: loss {eval_loss}")
    del trainer
    _free_card()
    return {"M1": launches, "M1 generate": gen_launches}


def run_remat_sweep() -> dict:
    """R: llama3-1b-gqa at its full 22 layers, batch 2 x 2048, bf16, under
    each remat policy from the same init: the step-1 loss and gradients
    (``compute_grads``) against remat "none"'s, within BF16_ROW_RTOL of
    each leaf's largest |g| (and whether every bit is equal), then R_STEPS
    AdamW steps: step ms (median of the steps after the first), peak
    memory over those steps, K1 launches per step (n_layers without a K1
    rerun, twice that under RECOMPUTES_K1). ``full``'s peak must be below
    ``none``'s. Returns {"R <policy>": launches}."""
    from pretraining_llm_tpu_torch.ops import remat
    from pretraining_llm_tpu_torch.training import optimizer as opt
    from pretraining_llm_tpu_torch.training import train_step as ts

    t_phase = time.perf_counter()
    cfg0 = train_config("llama3-1b-gqa", {"train.batch_size": 2, "train.train_steps": 100})
    model = cfg0.model
    init = ts.init_train_state(cfg0, SEED, device=DEVICE)
    rng = np.random.default_rng(SEED + 30)
    toks = torch.from_numpy(rng.integers(0, model.vocab_size, (R_STEPS, 2, model.context_length + 1))).to(DEVICE)
    batches = [(t[:, :-1], t[:, 1:]) for t in toks]
    ref = None
    peaks, out = {}, {}
    for policy in remat.POLICIES:
        cfg = cfg0.with_overrides({"model.remat": policy})
        state = opt.tree_map(torch.clone, init)
        loss1, grads = ts.compute_grads(state, batches[0], cfg)
        loss1 = float(loss1)
        if ref is None:
            ref = (loss1, grads)
            grad_use, bits_equal = 0.0, True
        else:
            pairs = list(zip(opt.tree_leaves(grads), opt.tree_leaves(ref[1])))
            grad_use = max(max_err(a, b) / (BF16_ROW_RTOL * max(b.abs().max().item(), 1e-30))
                           for (_, a), (_, b) in pairs)
            bits_equal = loss1 == ref[0] and all(torch.equal(a, b) for (_, a), (_, b) in pairs)
            del grads, pairs
        loss_use = abs(loss1 - ref[0]) / (BF16_ROW_RTOL * abs(ref[0]))
        step = ts.build_train_step(cfg)
        _free_card()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        times, losses = [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        peaks[policy] = torch.cuda.max_memory_allocated()
        launches = kernel_counts()
        k1_per_step = launches["flash_fwd"] / R_STEPS
        del state
        log("remat_sweep", model="llama3-1b-gqa", layers=model.n_layers, batch=2, T=model.context_length,
            remat=policy, step_ms=statistics.median(times[1:]), step_ms_all=times, losses=losses,
            max_memory_allocated_bytes=peaks[policy], state_bytes=base,
            activation_peak_bytes=peaks[policy] - base, k1_launches_per_step=k1_per_step,
            step1_loss=loss1, step1_loss_tol_use=loss_use, grad_tol_use=grad_use, grad_rtol=BF16_ROW_RTOL,
            bit_identical_to_none=bits_equal,
            launches={k: v for k, v in launches.items() if v})
        want_k1 = model.n_layers * (2 if policy in RECOMPUTES_K1 else 1)
        if k1_per_step != want_k1:
            raise AssertionError(f"R {policy}: {k1_per_step} K1 launches per step, expected {want_k1}")
        if loss_use > 1.0 or grad_use > 1.0:
            raise AssertionError(f"R {policy}: step-1 loss or gradients differ from remat none's "
                                 f"(loss {loss_use}, grads {grad_use} of the bar)")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"R {policy}: non-finite losses {losses}")
        _route_check(f"R {policy}", launches, False, model.n_layers, 2 if policy in RECOMPUTES_K1 else 1, R_STEPS)
        out[f"R {policy}"] = launches
    del init, ref
    _free_card()
    log("remat_sweep_summary", peaks=peaks, full_below_none=peaks["full"] < peaks["none"],
        phase_s=time.perf_counter() - t_phase)
    if not peaks["full"] < peaks["none"]:
        raise AssertionError(f"R: remat full's peak {peaks['full']} is not below none's {peaks['none']}")
    return out


OPT_STEPS = 10


def run_optimizers() -> dict:
    """gpt2-124m at full width and depth, ``Trainer.train`` for OPT_STEPS
    steps under each optimizer (batch 12, synthetic data, lr 6e-4 after a
    one-step warmup): finite losses, the last below the first."""
    t0 = time.perf_counter()
    out = {}
    for name in ("adamw", "adafactor", "muon"):
        cfg = train_config("gpt2-124m", {"train.optimizer": name, "train.train_steps": OPT_STEPS})
        trainer, recs, launches, wall, peak = train_run(cfg, OPT_STEPS, synthetic_data=True, resume=False)
        del trainer
        _free_card()
        losses = [r["loss"] for r in recs]
        log("train_optimizer", model="gpt2-124m", optimizer=name, steps=OPT_STEPS, wall_s=wall, **_rates(recs),
            max_memory_allocated_bytes=peak, losses=losses, launches={k: v for k, v in launches.items() if v})
        if not (len(losses) == OPT_STEPS and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"{name}: losses are not finite and falling: {losses}")
        out[f"optimizer {name}"] = launches
    log("train_optimizers_phase", phase_s=time.perf_counter() - t0)
    return out


def run_trainer_options() -> None:
    """The trainer's options on the card, gpt2-124m widths at 2 layers,
    batch 4, bf16: ``checkpoint_async`` (the step-3 checkpoint equals the
    synchronous run's leaf for leaf, bit for bit, and a run resumed from it
    ends on the synchronous run's params bit for bit); ``profile_dir`` (the
    trace of steps 1-2 exists and names K1's kernel); ``debug_nans`` (a NaN
    in one weight raises ``FloatingPointError``; the phase fails if it does
    not); a 3:1 mixture of ``data/parity``'s two files with
    ``data.prefetch=2`` (the batches each step received equal the
    unprefetched iterator's)."""
    from pretraining_llm_tpu_torch.data import loader
    from pretraining_llm_tpu_torch.training import checkpoint as ckpt
    from pretraining_llm_tpu_torch.training.metrics import MetricsLogger
    from pretraining_llm_tpu_torch.training.optimizer import tree_leaves
    from pretraining_llm_tpu_torch.training.trainer import Trainer
    from pretraining_llm_tpu_torch.utils import debug

    t0 = time.perf_counter()
    small = {"model.n_layers": 2, "train.batch_size": 4, "train.train_steps": 6, "train.checkpoint_interval": 3}

    def leaves(tree):
        return {".".join(p): x for p, x in tree_leaves(tree)}

    sync = train_config("gpt2-124m", {**small, "train.checkpoint_dir": str(SCRATCH / "opt_sync")})
    asyn = sync.with_overrides({"train.checkpoint_async": True, "train.checkpoint_dir": str(SCRATCH / "opt_async")})
    t_sync, recs_sync, _, _, _ = train_run(sync, 6, synthetic_data=True, resume=False)
    t_async, recs_async, _, _, _ = train_run(asyn, 6, synthetic_data=True, resume=False)
    template = t_sync.state
    saved = [leaves(ckpt.load_checkpoint(str(SCRATCH / d / "step-3"), template)[0]) for d in ("opt_sync", "opt_async")]
    ckpt_differs = [n for n in saved[0] if not torch.equal(saved[0][n], saved[1][n])]
    shutil.rmtree(SCRATCH / "opt_async" / "step-6")
    resumed = Trainer(asyn, device=DEVICE, resume=True, synthetic_data=True,
                      logger=MetricsLogger("", stream=sys.stderr))
    resumed_from = resumed.start_step
    resumed.train(6)
    want, got = leaves(t_sync.state["params"]), leaves(resumed.state["params"])
    resume_differs = [n for n in want if not torch.equal(want[n], got[n])]
    losses_equal = [r["loss"] for r in recs_sync] == [r["loss"] for r in recs_async]
    del t_sync, t_async, resumed, template, saved, want, got
    _free_card()

    prof_dir = SCRATCH / "profile"
    prof = sync.with_overrides({"train.profile_dir": str(prof_dir), "train.profile_start": 1,
                                "train.profile_steps": 2, "train.checkpoint_interval": 0})
    t_prof, recs_prof, _, _, _ = train_run(prof, 4, synthetic_data=True, resume=False)
    del t_prof
    traces = sorted(p.name for p in prof_dir.iterdir()) if prof_dir.is_dir() else []
    names = set()
    if traces:
        names = {str(e.get("name")) for e in json.loads((prof_dir / traces[0]).read_text())["traceEvents"]}
    k1_traced = sorted(n for n in names if "flash_fwd_tc_kernel" in n)
    profiled_losses_equal = [r["loss"] for r in recs_prof] == [r["loss"] for r in recs_sync[:4]]

    nan_cfg = sync.with_overrides({"train.debug_nans": True, "train.checkpoint_interval": 0,
                                   "train.checkpoint_dir": _no_checkpoint_dir()})
    raised = None
    try:
        trainer = Trainer(nan_cfg, device=DEVICE, resume=False, synthetic_data=True,
                          logger=MetricsLogger("", stream=sys.stderr))
        trainer.state["params"]["blocks"]["mlp"]["w1"][0, 0, 0] = float("nan")
        trainer.train(2)
    except FloatingPointError as e:
        raised = str(e)
    finally:
        debug.enable_nan_checks(False)
    trainer = None
    _free_card()

    spec = f"{PARITY_DIR / 'train.bin'}:3,{PARITY_DIR / 'val.bin'}:1"
    mix = sync.with_overrides({"data.train_path": spec, "data.prefetch": 2, "train.checkpoint_interval": 0})
    seen = []
    trainer = Trainer(mix, device=DEVICE, resume=False, logger=MetricsLogger("", stream=sys.stderr))
    step_fn = trainer.step_fn

    def recording_step(state, batch):
        seen.append(tuple(t.cpu().numpy() for t in batch))
        return step_fn(state, batch)

    trainer.step_fn = recording_step
    trainer.train(3)
    del trainer
    _free_card()
    plain = loader.get_batch_iterator(spec, mix.train.batch_size, mix.model.context_length,
                                      seed=mix.data.sample_seed)
    mixture_equal = len(seen) == 3 and all(
        all(np.array_equal(a, b) for a, b in zip(got, next(plain))) for got in seen)
    log("train_options", checkpoint_async={"leaves_differing_at_step_3": ckpt_differs, "resumed_from": resumed_from,
                                           "params_differing_after_resume": resume_differs,
                                           "losses_equal_sync": losses_equal},
        profile={"traces": traces, "k1_kernels_named": k1_traced, "losses_equal_unprofiled": profiled_losses_equal},
        debug_nans={"raised": raised}, mixture_prefetch={"spec_weights": "3:1", "prefetch": 2,
                                                         "batches_equal_unprefetched": mixture_equal},
        phase_s=time.perf_counter() - t0)
    if ckpt_differs or resume_differs or resumed_from != 3 or not losses_equal:
        raise AssertionError("checkpoint_async: the async checkpoint or its resume differs from the sync run")
    if traces != ["trace-1-3.json"] or not k1_traced or not profiled_losses_equal:
        raise AssertionError(f"profile_dir: trace {traces}, K1 named {k1_traced}, losses equal {profiled_losses_equal}")
    if raised is None:
        raise AssertionError("debug_nans: a NaN weight did not raise FloatingPointError")
    if not mixture_equal:
        raise AssertionError("mixture + prefetch: the trainer's batches differ from the unprefetched iterator's")


D1_PRESET = "gpt2-124m"
D1_STEPS = 32
D1_DIR = SCRATCH / "d1"
D1_WATCHDOG_S = 10
D1_ROLLBACK_STEPS = 16  # the rollback run (c): past the restored step and one more checkpoint
D1_CHILD = "--d1-child"  # chip_smoke.py's child mode: the train CLI with its kernel counts recorded


def d1_argv(tag: str, *overrides: str) -> list:
    """The train CLI's arguments of D1's run ``tag``: T1's model and data
    (gpt2-124m, batch 12, T 1024, bf16, ``data/parity`` through the native
    batcher), 32 steps, a log line every 4, a checkpoint every 8, anomaly
    detection, a 10 s watchdog, telemetry under the run's ``obs`` dir with
    a device memory sample every 2 log boundaries."""
    run = D1_DIR / tag
    return ["--preset", D1_PRESET, "--device", DEVICE, "--obs-dir", str(run / "obs"), "--override",
            f"train.train_steps={D1_STEPS}", "train.log_interval=4", "train.checkpoint_interval=8",
            "train.eval_interval=0", f"train.checkpoint_dir={run / 'ck'}",
            f"data.train_path={PARITY_DIR / 'train.bin'}", f"data.val_path={PARITY_DIR / 'val.bin'}",
            "resilience.anomaly_detection=True", f"resilience.watchdog_timeout_s={D1_WATCHDOG_S}",
            "obs.device_memory_interval=2", *overrides]


def d1_config(tag: str, *overrides: str):
    """``d1_argv``'s configuration, for the runs D1 drives in this process."""
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.train import parse_overrides

    argv = d1_argv(tag, *overrides)
    over = parse_overrides(argv[argv.index("--override") + 1:])
    obs = D1_DIR / tag / "obs"
    obs.mkdir(parents=True, exist_ok=True)
    over.update({"obs.events_path": str(obs / "events.jsonl"), "obs.spans_path": str(obs / "spans.trace.json"),
                 "obs.prometheus_path": str(obs / "metrics.prom")})
    return get_preset(D1_PRESET).with_overrides(over)


def d1_child(argv: list) -> int:
    """``python chip_smoke.py --d1-child COUNTS <train CLI arguments>``: the
    port's train CLI (``pretraining_llm_tpu_torch.train.main``), with every
    record its trainer logs followed by a line of this process's kernel
    launch counts in COUNTS, so D1 reads each child's routes even when the
    watchdog ends it with ``os._exit``. A separator line opens each child's
    part of COUNTS."""
    from pretraining_llm_tpu_torch import train
    from pretraining_llm_tpu_torch.training.metrics import MetricsLogger

    counts_path, args = argv[0], argv[1:]
    with open(counts_path, "a") as f:
        f.write("\n===\n")
    log_record = MetricsLogger.log

    def counted(self, record):
        log_record(self, record)
        with open(counts_path, "a") as f:
            f.write(json.dumps({"step": record.get("step"), "event": record.get("event"),
                                "counts": kernel_counts()}) + "\n")

    MetricsLogger.log = counted
    train.main(args)
    return 0


def _d1_events(tag: str) -> list:
    path = D1_DIR / tag / "obs" / "events.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def _d1_final_state(tag: str):
    from pretraining_llm_tpu_torch.training import checkpoint as ckpt

    path = D1_DIR / tag / "ck" / f"step-{D1_STEPS}"
    meta = json.loads((path / "metadata.json").read_text())
    template = {m["name"]: np.empty(m["shape"]) for m in meta["manifest"]}
    state, extra = ckpt.load_checkpoint(str(path), template)
    return state, extra


def _d1_child_launches(counts_path: Path) -> list:
    """Per child process: (steps it ran, its kernel counts at its last
    record)."""
    out = []
    for lines in counts_path.read_text().split("\n===\n")[1:]:
        recs = [json.loads(line) for line in lines.splitlines() if line.strip()]
        steps = [r["step"] for r in recs if isinstance(r.get("step"), int)]
        start = next((r["step"] for r in recs if r.get("event") == "resumed"), 0)
        out.append((max(steps) - start, recs[-1]["counts"]))
    return out


def run_d1() -> dict:
    """D1, the drills: gpt2-124m at full width and depth trained on the card
    under the resilience loop with the observability hub on (T1's model
    and data through the native batcher; ``d1_argv``).

      (a) clean: 32 steps, the train CLI in a subprocess; its step-32
          state is the reference;
      (b) drilled: the same command under the port's supervisor with
          ``resilience.faults="sigterm@12,hang@20"`` (a fault fires after
          that many completed steps): the children exit 43 (SIGTERM after
          step 12, checkpoint at the next log boundary, 16), 45 (the
          watchdog's emergency checkpoint at 20) and 0, and the step-32
          state equals (a)'s bit for bit (every leaf and the sampler's
          counter);
      (c) rollback, in this process, 16 steps: ``nan@10`` is detected at
          the step-12 log boundary, step 8 is restored, the poison window
          skipped, and the run completes with finite losses; then ``ckpt_truncate@17``
          tears the step-16 checkpoint of an 18-step run, and a resume falls
          back to step 8;
      (e) that resume trains two log windows (steps 9-16, no checkpoint)
          with the hub, the detector and the watchdog on, every stretch
          between log boundaries under
          ``torch.cuda.set_sync_debug_mode("error")``: no device sync there;
      (d) the event streams of (a), (b) and (c) folded by the port's
          ``GoodputAccountant``: (b) and (c) below (a); (a)'s Prometheus
          textfile lint-clean and its Chrome trace loadable.

    Every step of every run launches K1 and the one-pass backward on the
    tensor-core route, 12 each (the children's counts through
    ``d1_child``). Returns D1's launches, summed."""
    from pretraining_llm_tpu_torch.observability.export import lint_exposition
    from pretraining_llm_tpu_torch.observability.goodput import GoodputAccountant
    from pretraining_llm_tpu_torch.resilience import EXIT_PREEMPTED, EXIT_WEDGED
    from pretraining_llm_tpu_torch.training import checkpoint as ckpt
    from pretraining_llm_tpu_torch.training.optimizer import tree_leaves
    from pretraining_llm_tpu_torch.training.trainer import Trainer
    from pretraining_llm_tpu_torch.training.metrics import MetricsLogger

    t_phase = time.perf_counter()
    shutil.rmtree(D1_DIR, ignore_errors=True)
    D1_DIR.mkdir(parents=True)
    layers = d1_config("clean").model.n_layers
    total = kernel_counts()
    total = dict.fromkeys(total, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    def route_ok(steps, counts):
        return (counts["flash_fwd_tc"] == counts["flash_fwd"] == layers * steps
                and counts["flash_bwd_fused_tc"] == counts["flash_bwd_fused"] == layers * steps
                and counts["flash_fwd_fp32"] == counts["flash_bwd_fused_fp32"] == 0)

    def child_cmd(tag, *overrides):
        counts = D1_DIR / f"{tag}.counts.jsonl"
        return [sys.executable, str(ROOT / "chip_smoke.py"), D1_CHILD, str(counts), *d1_argv(tag, *overrides)]

    # (a) clean run, one child.
    t0 = time.perf_counter()
    proc = subprocess.run(child_cmd("clean"), cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall_a = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"D1 (a): the clean run exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    children_a = _d1_child_launches(D1_DIR / "clean.counts.jsonl")

    # (b) the drilled run under the supervisor.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pretraining_llm_tpu_torch.supervisor", "--backoff-base", "1",
         "--events", str(D1_DIR / "drilled" / "obs" / "events.jsonl"), "--",
         *child_cmd("drilled", "resilience.faults=sigterm@12,hang@20")],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall_b = time.perf_counter() - t0
    sup = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"supervisor"')]
    codes = [r["rc"] for r in sup if r["event"] == "exit"]
    child_walls = [r["elapsed_s"] for r in sup if r["event"] == "exit"]
    children_b = _d1_child_launches(D1_DIR / "drilled.counts.jsonl")
    events_b = _d1_events("drilled")
    emergency = [e.get("step") for e in events_b if e.get("event") == "ckpt_save" and e.get("emergency")]
    # Relaunch overhead: from a child's last event to the next child's first
    # (its restore): exit, backoff, start-up and restore. A child's bus
    # numbers its events from 0.
    own = [e for e in events_b if not e.get("supervisor")]
    relaunch_s = [own[i]["t_wall"] - own[i - 1]["t_wall"] for i in range(1, len(own)) if own[i]["seq"] == 0]

    state_a, extra_a = _d1_final_state("clean")
    state_b, extra_b = _d1_final_state("drilled")
    differ = [n for n in state_a if not torch.equal(state_a[n], state_b[n])]
    rng_equal = extra_a.get("data_rng") == extra_b.get("data_rng")
    del state_a, state_b

    # (c) rollback and the torn checkpoint, in this process.
    logger = MetricsLogger("", stream=sys.stderr)
    reset_kernel_counts()
    t0 = time.perf_counter()
    nan_trainer = Trainer(d1_config("rollback", "resilience.faults=nan@10",
                                    f"train.train_steps={D1_ROLLBACK_STEPS}"),
                          device=DEVICE, resume=False, logger=logger)
    records = []
    log_record = logger.log
    logger.log = lambda r: (records.append(dict(r)), log_record(r))[1]
    nan_trainer.train()
    wall_c = time.perf_counter() - t0
    rollbacks = [r for r in records if r.get("event") == "rollback"]
    c_losses = [(r["step"], r["loss"]) for r in records if "loss" in r]
    c_reason = nan_trainer.exit_reason
    del nan_trainer
    _free_card()
    c_counts = kernel_counts()
    c_steps = D1_ROLLBACK_STEPS + sum(r["from_step"] - r["to_step"] for r in rollbacks)  # replays run again
    add(c_counts)

    reset_kernel_counts()
    torn = d1_config("torn", "resilience.faults=ckpt_truncate@17", "train.train_steps=18", "train.save_final=False")
    trainer = Trainer(torn, device=DEVICE, resume=False, logger=MetricsLogger("", stream=sys.stderr))
    trainer.train()
    del trainer
    torn_steps = sorted(ckpt._list_steps(str(D1_DIR / "torn" / "ck")))
    torn_counts = kernel_counts()
    add(torn_counts)

    # (e) the resume: falls back to step 8, then two log windows with every
    # stretch between log boundaries under the sync check.
    reset_kernel_counts()
    skipped = []
    resume_logger = MetricsLogger("", stream=sys.stderr)
    resume_log = resume_logger.log
    resume_logger.log = lambda r: (skipped.append(r) if r.get("event") == "checkpoint_skipped" else None,
                                   resume_log(r))[1]
    resumed = Trainer(torn.with_overrides({"train.train_steps": 16, "resilience.faults": "",
                                           "train.checkpoint_interval": 0, "train.save_final": False}),
                      device=DEVICE, resume=True, logger=resume_logger)
    fell_back_to = resumed.start_step
    step_fn, host_step = resumed.step_fn, [fell_back_to]

    def guarded(state, batch):
        torch.cuda.set_sync_debug_mode("error")  # on from the first step after a boundary
        try:
            out = step_fn(state, batch)
        except BaseException:
            torch.cuda.set_sync_debug_mode("default")  # the failure path's save may sync
            raise
        host_step[0] += 1
        if host_step[0] % resumed.config.train.log_interval == 0:
            torch.cuda.set_sync_debug_mode("default")  # the boundary's metric fetch syncs
        return out

    resumed.step_fn = guarded
    try:
        e_last = resumed.train()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    e_reason = resumed.exit_reason
    del resumed
    _free_card()
    e_counts = kernel_counts()
    add(e_counts)

    # (d) goodput of each event stream, the textfile and the trace.
    goodput = {tag: GoodputAccountant.fold(_d1_events(tag)) for tag in ("clean", "drilled", "rollback")}
    samplers = sorted({e.get("sampler") for tag in ("clean", "drilled", "rollback", "torn")
                       for e in _d1_events(tag) if e["event"] == "run_start"}, key=str)
    memory = [e["max_bytes_in_use"] for e in _d1_events("clean") if e["event"] == "device_memory"]
    prom = (D1_DIR / "clean" / "obs" / "metrics.prom").read_text()
    lint = lint_exposition(prom)
    trace = json.loads((D1_DIR / "clean" / "obs" / "spans.trace.json").read_text())
    span_names = sorted({e["name"] for e in trace["traceEvents"]})
    for _, counts in children_a + children_b:
        add(counts)
    routes = {"clean": [route_ok(s, c) for s, c in children_a], "drilled": [route_ok(s, c) for s, c in children_b],
              "rollback": route_ok(c_steps, c_counts), "torn": route_ok(18, torn_counts),
              "resumed": route_ok(16 - fell_back_to, e_counts)}
    log("D1", model="gpt2-124m", layers=layers, batch=12, T=1024, dtype="bfloat16", sampler="native",
        data=str(PARITY_DIR / "train.bin"), steps=D1_STEPS, log_interval=4, checkpoint_interval=8,
        watchdog_timeout_s=D1_WATCHDOG_S,
        clean={"wall_s": wall_a, "children": [s for s, _ in children_a]},
        drilled={"wall_s": wall_b, "exit_codes": codes, "child_wall_s": child_walls,
                 "child_steps": [s for s, _ in children_b], "emergency_checkpoint_steps": emergency,
                 "relaunch_overhead_s": relaunch_s, "final_leaves_differing": differ,
                 "data_rng_equal": rng_equal, "data_rng": extra_b.get("data_rng")},
        rollback={"wall_s": wall_c, "exit_reason": c_reason, "rollbacks": rollbacks, "losses": c_losses,
                  "steps_run": c_steps},
        torn={"steps_on_disk": torn_steps, "skipped": [r.get("path") for r in skipped],
              "resumed_from": fell_back_to, "exit_reason": e_reason, "loss": e_last.get("loss")},
        goodput={tag: {"goodput": g["goodput"], "total_s": g["total_s"], "runs": g["runs"],
                       "rollbacks": g["rollbacks"], "categories": g["categories"]} for tag, g in goodput.items()},
        prometheus_lint=lint, trace_spans=span_names, samplers=samplers, device_memory_bytes=memory,
        routes=routes, launches=total,
        phase_s=time.perf_counter() - t_phase)
    if codes != [EXIT_PREEMPTED, EXIT_WEDGED, 0] or proc.returncode != 0:
        raise AssertionError(f"D1 (b): child exit codes {codes}, supervisor {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    if emergency != [20]:
        raise AssertionError(f"D1 (b): emergency checkpoints at {emergency}, expected step 20")
    if differ or not rng_equal:
        raise AssertionError(f"D1 (b): the drilled run's final state differs from the clean run's: {differ[:8]}, "
                             f"data rng equal {rng_equal}")
    if (c_reason != "completed" or [(r["from_step"], r["to_step"]) for r in rollbacks] != [(12, 8)]
            or not all(math.isfinite(x) for s, x in c_losses if s > 12) or c_losses[-1][0] != D1_ROLLBACK_STEPS):
        raise AssertionError(f"D1 (c): rollback {rollbacks}, exit {c_reason}, losses {c_losses}")
    if torn_steps != [8, 16] or fell_back_to != 8 or not skipped or e_reason != "completed" \
            or not math.isfinite(e_last.get("loss", math.nan)):
        raise AssertionError(f"D1 (c): torn checkpoint {torn_steps}, resumed from {fell_back_to}, skipped {skipped}, "
                             f"{e_reason} {e_last}")
    g = {tag: v["goodput"] for tag, v in goodput.items()}
    if not (0 < g["drilled"] < g["clean"] and 0 < g["rollback"] < g["clean"]) or goodput["rollback"]["rollbacks"] != 1:
        raise AssertionError(f"D1 (d): goodput {g}")
    if samplers != ["native"]:
        raise AssertionError(f"D1: the runs sampled with {samplers}, not the native batcher")
    if len(memory) != D1_STEPS // 8 or not all(b > 1e9 for b in memory):  # 8 log boundaries, a sample every 2
        raise AssertionError(f"D1: device memory samples {memory}")
    if lint or "ckpt_save" not in span_names or "checkpoint/write_leaves" not in span_names:
        raise AssertionError(f"D1 (d): Prometheus lint {lint}, trace spans {span_names}")
    if not all(all(v) if isinstance(v, list) else v for v in routes.values()) or len(children_a) != 1 \
            or len(children_b) != 3:
        raise AssertionError(f"D1: K1 or the one pass off the tensor-core route, or a step missing: {routes}")
    shutil.rmtree(D1_DIR, ignore_errors=True)
    return total

def time_kernels(launches, prefill_shapes, errs, launches_g1, serving_paths):
    from pretraining_llm_tpu_torch.ops import cuda_flash, cuda_paged

    sdpa = torch.nn.functional.scaled_dot_product_attention
    l2_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        l2_buf.zero_()

    gen = torch.Generator().manual_seed(SEED + 4)
    kernels = []

    # K1 at the main path's longest admission prefill (its rows, padded to
    # the longest prompt's whole pages), 12 heads, Dh 64, bf16, causal.
    b, t = max(prefill_shapes, key=lambda rt: (rt[1], rt[0]))
    h, d, dt = 12, 64, torch.bfloat16
    q, k, v = (randn((b * h, t, d), dt, gen) for _ in range(3))
    k_ms = time_ms(lambda: cuda_flash.flash_attention_fwd(q, k, v, h, h), flush=flush)
    k_dev = time_ms(lambda: cuda_flash.flash_attention_fwd(q, k, v, h, h), flush=flush, device_only=True)
    p_ms = time_ms(lambda: cuda_flash.flash_attention_fwd_reference(q, k, v, h, h), flush=flush)
    q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
    l_ms = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), flush=flush)
    flops = 2.0 * b * h * t * t * d  # QK^T and PV over the causal half
    nbytes = 4 * b * h * t * d * 2 + b * h * t * 4  # q, k, v, o in bf16 + lse fp32
    kernels.append(dict(
        name="flash_fwd", route="cuda", mma="wgmma", source="pretraining_llm_tpu_torch/csrc/flash_fwd_tc.cu",
        replaces="pretraining_llm_tpu/ops/pallas_flash.py:104",
        shape=f"B*H={b * h} T={t} Dh={d} bf16 causal",
        launches=launches["flash_fwd_tc"] + launches_g1["flash_fwd_tc"],
        launches_by_path={"path1": launches["flash_fwd_tc"], "G1": launches_g1["flash_fwd_tc"],
                          **{name: n["flash_fwd_tc"] for name, n in serving_paths.items()}},
        flops=flops, bytes=nbytes, **_bound(flops, nbytes), max_abs_err=errs["flash_fwd"],
        ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=l_ms,
    ))

    # K2 at a decode step of the main path: 8 rows, 12 heads, Dh 64, one
    # query, 64-slot pages, 16-entry tables, lengths drawn like the main
    # path's (prompt 17..900 plus up to 64 generated), bf16.
    b, h, g, d, bs, nb, n_blocks = 8, 12, 12, 64, 64, 16, 256
    rng = np.random.default_rng(SEED + 4)
    tables, seq = paged_state(rng, b + 1, n_blocks, nb, bs, 1, lo=17, hi=963)
    tables, seq = tables[1:].contiguous(), seq[1:].contiguous()  # drop the seq-0 row
    q = randn((b, h, d), dt, gen)
    kp, vp = randn((n_blocks, bs, g, d), dt, gen), randn((n_blocks, bs, g, d), dt, gen)
    call = lambda: cuda_paged.paged_decode_attention(q, kp, vp, tables, seq)  # noqa: E731
    if cuda_paged.paged_route(dt, d, bs, h // g) != "split":
        raise AssertionError("paged_decode: the timed shape does not take the split route")
    k_ms = time_ms(call, flush=flush)
    k_dev = time_ms(call, flush=flush, device_only=True)
    with _forced(cuda_paged, "paged_route", "loop"):
        was_ms = time_ms(call, flush=flush)
        was_dev = time_ms(call, flush=flush, device_only=True)
    p_ms = time_ms(lambda: cuda_paged.paged_decode_attention_reference(q, kp, vp, tables, seq),
                   flush=flush)
    kv_len = nb * bs
    kg = kp[tables.long()].reshape(b, kv_len, g, d).permute(0, 2, 1, 3)
    vg = vp[tables.long()].reshape(b, kv_len, g, d).permute(0, 2, 1, 3)
    mask = (torch.arange(kv_len, device="cuda")[None, :] <= seq[:, None].long())[:, None, None, :]
    l_ms = time_ms(lambda: sdpa(q[:, :, None], kg, vg, attn_mask=mask), flush=flush)
    live_pages = ((seq.long() // bs) + 1).sum().item()  # pages j with j*bs <= seq
    live_slots = (seq.long() + 1).sum().item()
    flops = 4.0 * h * live_slots * d  # QK and PV over each row's visible slots
    nbytes = live_pages * bs * g * d * 2 * 2 + 2 * b * h * d * 2 + b * nb * 4 + b * 4
    parts = cuda_paged._kv_partitions(b, g, nb, torch.cuda.get_device_properties(0).multi_processor_count)
    kernels.append(dict(
        name="paged_decode", route="cuda", mma="none (fp32 CUDA cores, cp.async page rings)",
        source="pretraining_llm_tpu_torch/csrc/paged_decode.cu (paged_split_kernel)",
        replaces="pretraining_llm_tpu/ops/pallas_paged.py:48",
        shape=f"B={b} H={h} G={g} T=1 Dh={d} bs={bs} nb={nb} bf16 seq_lens={seq.tolist()}",
        partitions=parts, launches=launches["paged_split"],
        launches_by_route={r: launches[f"paged_{r}"] for r in cuda_paged.ROUTES},
        launches_by_path={"path1": {"paged_split_t1": launches["paged_split"]},
                          **{name: {k: v for k, v in n.items() if k.startswith("paged_") and "_t" in k and v}
                             for name, n in serving_paths.items()}},
        flops=flops, bytes=nbytes, **_bound(flops, nbytes),
        max_abs_err=errs["paged_decode"], ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=l_ms,
        was_ms=was_ms, was_device_ms=was_dev,
        was_source="pretraining_llm_tpu_torch/csrc/paged_decode.cu (paged_decode_kernel, route loop, same inputs, "
                   "this run)",
        library_note="SDPA over the pre-gathered KV with a boolean mask (gather not timed)",
    ))

    def with_partitions(n):  # the split kernel with n partitions of ceil(nb / n) table entries
        per = -(-nb // n)
        with _forced(cuda_paged, "_kv_partitions", (-(-nb // per), per)):
            return call()

    split_sweep("paged_split_sweep", f"path 1 decode step: {kernels[-1]['shape']}", "partitions",
                (1, 2, 4, 8, 16), with_partitions, flush)

    # The loop route at path 5's llama3-1b-gqa verify: 8 rows, H 16 over G
    # 4, T 5 queries (20 rows per KV head), Dh 128, lengths drawn like its
    # prompts (64-400 plus up to 32 generated), bf16.
    b, h, g, t, d = 8, 16, 4, 5, 128
    tables, seq = paged_state(rng, b + 1, n_blocks, nb, bs, t, lo=64, hi=432)
    tables, seq = tables[1:].contiguous(), seq[1:].contiguous()
    q = randn((b, t, h, d), dt, gen)
    kp, vp = randn((n_blocks, bs, g, d), dt, gen), randn((n_blocks, bs, g, d), dt, gen)
    if cuda_paged.paged_route(dt, d, bs, (h // g) * t) != "loop":
        raise AssertionError("paged_decode: the verify shape does not take the loop route")
    call = lambda: cuda_paged.paged_decode_attention(q, kp, vp, tables, seq)  # noqa: E731
    loop_ms = time_ms(call, flush=flush)
    loop_dev = time_ms(call, flush=flush, device_only=True)
    loop_plain = time_ms(lambda: cuda_paged.paged_decode_attention_reference(q, kp, vp, tables, seq), flush=flush)
    kv_len = nb * bs
    rep_kv = h // g
    kg = kp[tables.long()].reshape(b, kv_len, g, d).permute(0, 2, 1, 3).repeat_interleave(rep_kv, dim=1)
    vg = vp[tables.long()].reshape(b, kv_len, g, d).permute(0, 2, 1, 3).repeat_interleave(rep_kv, dim=1)
    pos = seq.long()[:, None] + torch.arange(t, device="cuda")[None, :]
    mask = (torch.arange(kv_len, device="cuda")[None, None, :] <= pos[:, :, None])[:, None]
    loop_lib = time_ms(lambda: sdpa(q.permute(0, 2, 1, 3), kg, vg, attn_mask=mask), flush=flush)
    seq_h = seq.tolist()
    live_pages = sum((s + t - 1) // bs + 1 for s in seq_h)
    flops = 4.0 * h * sum(s + i + 1 for s in seq_h for i in range(t)) * d
    nbytes = live_pages * bs * g * d * 2 * 2 + 2 * q.numel() * 2 + tables.numel() * 4 + b * 4
    kernels[-1]["loop_route"] = dict(
        source="pretraining_llm_tpu_torch/csrc/paged_decode.cu (paged_decode_kernel)",
        shape=f"B={b} H={h} G={g} T={t} Dh={d} bs={bs} nb={nb} bf16 seq_lens={seq_h}",
        launches_by_path={name: n.get("paged_loop_t5", 0) for name, n in serving_paths.items()},
        max_abs_err=errs["paged_loop_gqa_t5"], ms=loop_ms, device_ms=loop_dev, plain_ms=loop_plain,
        library_ms=loop_lib, flops=flops, bytes=nbytes, **_bound(flops, nbytes),
        library_note="SDPA over the pre-gathered KV, KV heads repeated, boolean mask (gather not timed)",
    )
    for kern in kernels:
        kern["kernel_ms"] = kern["ms"]
        kern["max_err"] = kern["max_abs_err"]
    return kernels


class _forced:
    """Within the block, ``module.name`` (a route rule or a partition plan)
    returns ``value`` whatever its arguments: a kernel's earlier route (the
    "was" times of the kernels line) or another partition count, timed on
    the same inputs in the same run."""

    def __init__(self, module, name: str, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self._fn = getattr(self.module, self.name)
        setattr(self.module, self.name, lambda *args, **kw: self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._fn)


def split_sweep(phase: str, shape: str, key: str, counts, call, flush) -> None:
    """``call(n)`` at each partition count n of ``counts``, 12 rounds of
    alternated launches (the counts up, then down), L2 flushed before each:
    logs the median and range of each count, host work included and device
    only."""
    order = tuple(counts) + tuple(reversed(counts))
    times = {n: {"ms": [], "device_ms": []} for n in counts}
    for n in order:
        call(n)
    torch.cuda.synchronize()
    for _ in range(12):
        for n in order:
            for what in ("ms", "device_ms"):
                flush()
                if what == "device_ms":
                    torch.cuda._sleep(2_000_000)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                call(n)
                end.record()
                end.synchronize()
                times[n][what].append(start.elapsed_time(end))
    log(phase, shape=shape, launches_per_count=24, **{
        f"{key}_{n}": {what: {"median": statistics.median(v), "min": min(v), "max": max(v)}
                       for what, v in times[n].items()} for n in counts})


def time_ragged(paths, eng2, errs, serving_paths):
    """The ragged kernels' four entries: exact bf16 at path 2's largest
    chunk launch (one pass, and at the auto split count), and int8 pools
    with bf16 scales at a path 3 decode step (8 rows, q_len 1), classic and
    AMLA, all bf16 queries: the tensor-core kernel, with the CUDA-core
    kernel's time at the same inputs after "was". ``launches`` counts the
    entry's form (one-pass or split) on the serving paths; AMLA is a form of
    the one-pass kernel that no serving path switches on (``ragged_amla`` is
    off by default, as in the JAX package), so its entry reports the
    one-pass launches of path 3. Then the split-count sweep: one pass
    against 2 and 4 partitions at the chunk and the decode step, in
    alternated launches."""
    from pretraining_llm_tpu_torch.ops import cuda_ragged

    sdpa = torch.nn.functional.scaled_dot_product_attention
    l2_buf = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def flush():
        l2_buf.zero_()

    gen = torch.Generator().manual_seed(SEED + 8)
    rng = np.random.default_rng(SEED + 8)
    h, g, d, bs, nb, n_blocks = 12, 12, 64, 64, eng2.max_blocks, 256
    dt = torch.bfloat16
    f = cuda_ragged.ragged_paged_attention
    kernels = []
    p1, p2, p3 = paths

    def library_ms(q, kp, vp, tables, seq, ql, t, ks=None, vs=None):
        """SDPA over the pre-gathered (and dequantized) K/V with a boolean
        mask; the gather and the dequant are not timed."""
        b = q.shape[0]
        kv_len = nb * bs
        rows = tables.long()

        def gathered(pool, scale):
            x = pool[rows].reshape(b, kv_len, g, d)
            if scale is not None:
                x = x.float() * (scale[rows].reshape(b, kv_len, g, 1).float() * (1.0 / 127.0))
            return x.to(dt).permute(0, 2, 1, 3)

        kg, vg = gathered(kp, ks), gathered(vp, vs)
        lin = torch.arange(kv_len, device=DEVICE)
        pos = seq.long()[:, None] + torch.arange(t, device=DEVICE)[None, :]
        mask = (lin[None, None, :] <= pos[:, :, None]) & (
            torch.arange(t, device=DEVICE)[None, :, None] < ql.long()[:, None, None])
        qh = q.permute(0, 2, 1, 3)
        return time_ms(lambda: sdpa(qh, kg, vg, attn_mask=mask[:, None]), flush=flush)

    def entry(name, shape, q, kp, vp, tables, seq, ql, t, launches, splits, by_path, amla=False, ks=None,
              vs=None, **extra):
        kw = dict(k_scale=ks, v_scale=vs) if ks is not None else {}
        call = lambda: f(q, kp, vp, tables, seq, ql, kv_splits=splits, amla=amla, **kw)  # noqa: E731
        if cuda_ragged.ragged_route(q.dtype, kp.dtype, d, bs, h // g) != "wgmma":
            raise AssertionError(f"{name}: the timed shape does not take the tensor-core kernel")
        k_ms = time_ms(call, flush=flush)
        k_dev = time_ms(call, flush=flush, device_only=True)
        with _forced(cuda_ragged, "ragged_route", "fp32"):
            was_ms = time_ms(call, flush=flush)
            was_dev = time_ms(call, flush=flush, device_only=True)
        p_ms = time_ms(lambda: cuda_ragged.ragged_gather_attention(q, kp, vp, tables, seq, ql, **kw),
                       flush=flush)
        l_ms = library_ms(q, kp, vp, tables, seq, ql, t, ks, vs)
        seq_h, ql_h = seq.tolist(), ql.tolist()
        live_pages = sum((s + n - 1) // bs + 1 for s, n in zip(seq_h, ql_h) if n > 0)
        pairs = sum(s + i + 1 for s, n in zip(seq_h, ql_h) for i in range(n))
        elem = kp.element_size()
        scale_bytes = ks.element_size() if ks is not None else 0
        flops = 4.0 * h * pairs * d
        nbytes = (live_pages * bs * g * (d * elem + scale_bytes) * 2 + 2 * q.numel() * q.element_size()
                  + tables.numel() * 4 + 2 * seq.numel() * 4)
        kernels.append(dict(
            name=name, route="cuda", mma="wgmma", source="pretraining_llm_tpu_torch/csrc/ragged_paged_tc.cu",
            replaces=("pretraining_llm_tpu/ops/pallas_ragged.py:287" if name == "ragged_split"
                      else "pretraining_llm_tpu/ops/pallas_ragged.py:228"),
            shape=shape, kv_splits=splits, launches=launches, launches_by_path=by_path, flops=flops,
            bytes=nbytes, **_bound(flops, nbytes), max_abs_err=errs[name], ms=k_ms, device_ms=k_dev,
            plain_ms=p_ms, library_ms=l_ms, was_ms=was_ms, was_device_ms=was_dev,
            was_source="pretraining_llm_tpu_torch/csrc/ragged_paged.cu (CUDA cores, same inputs, this run)",
            library_note="SDPA over the pre-gathered (dequantized) KV with a boolean mask "
                         "(gather and dequant not timed)", **extra,
        ))

    # Path 2's largest chunk launch: its rows' offsets and chunk lengths, T
    # pinned to the chunk size, fresh pages per row.
    offsets, lens, t = max(eng2.suffix_shapes, key=lambda s: (sum(s[1]), len(s[1])))
    b = len(lens)
    tables, seq, ql = ragged_state(rng, lens, offsets, n_blocks, nb, bs)
    q = randn((b, t, h, d), dt, gen)
    kp, vp = randn((n_blocks, bs, g, d), dt, gen), randn((n_blocks, bs, g, d), dt, gen)
    shape = f"B={b} T={t} H={h} G={g} Dh={d} bs={bs} nb={nb} bf16 seq_lens={offsets} q_lens={lens}"
    entry("ragged", shape, q, kp, vp, tables, seq, ql, t, p2["ragged"], 1,
          {"path2": p2["ragged"], "path3": p3["ragged"],
           **{name: n["ragged"] for name, n in serving_paths.items()}})
    auto = cuda_ragged._auto_kv_splits(nb, b)
    entry("ragged_split", shape, q, kp, vp, tables, seq, ql, t, p2["ragged_split"] + p3["ragged_split"],
          auto, {"path2": p2["ragged_split"], "path3": p3["ragged_split"]})
    split_sweep("ragged_split_sweep", f"path 2 chunk: {shape}", "splits", (1, 2, 4),
                lambda n: f(q, kp, vp, tables, seq, ql, kv_splits=n), flush)

    # A path 3 decode step: 8 rows, q_len 1, lengths drawn like path 3's
    # (prompts 401-784 plus up to 63 generated), int8 pools, bf16 scales.
    b, t = 8, 1
    seqs = rng.integers(401, 848, size=b).tolist()
    tables, seq, ql = ragged_state(rng, [1] * b, seqs, n_blocks, nb, bs)
    q = randn((b, t, h, d), dt, gen)
    kp, ks, vp, vs = int8_pools((n_blocks, bs, g, d), torch.bfloat16, gen)
    shape = f"B={b} T=1 H={h} G={g} Dh={d} bs={bs} nb={nb} int8 pools, bf16 scales, bf16 q seq_lens={seqs}"
    by_path = {"path2": p2["ragged"], "path3": p3["ragged"]}
    entry("ragged_int8", shape, q, kp, vp, tables, seq, ql, t, p3["ragged"], 1, by_path, ks=ks, vs=vs)
    entry("ragged_int8_amla", shape, q, kp, vp, tables, seq, ql, t, p3["ragged"], 1, by_path, amla=True,
          ks=ks, vs=vs, launches_note="one-pass launches on path 3, which runs the classic form")
    split_sweep("ragged_split_sweep", f"path 3 decode: {shape}", "splits", (1, 2, 4),
                lambda n: f(q, kp, vp, tables, seq, ql, kv_splits=n, k_scale=ks, v_scale=vs), flush)
    for kern in kernels:
        kern["kernel_ms"] = kern["ms"]
        kern["max_err"] = kern["max_abs_err"]
    return kernels


def time_train_kernels(paths):
    """``paths``: {"T1" | "T2" | "parity": that run's launches}. The
    training entries: K1 and the one-pass backward at T1's shape
    (B*H = 144, T 1024, Dh 64, bf16, causal), the dQ and dK/dV kernels at
    T2's (B 2, H 16, G 4, T 2048, Dh 128, bf16), the T4 presets' backward
    at their Dh-128 shapes, and K1 and the one pass at M1's microbatch (B 8,
    H 16, T 1024, Dh 64) with K1 at its generate's prefill (T 256). Each
    wrapper's outputs are first held against its plain version on the same
    inputs (K1's o and lse by ``tol_use``, the backward's dq, dk, dv per row
    at BF16_ROW_RTOL), failing above 1.0; the entry reports that error.
    Each wrapper is timed as the path calls it (the one-pass wrapper's fp32
    buffer and zeroed turn counters included); D = rowsum(dO*O) is computed
    outside. The plain
    backward computes dq, dk and dv together, and so does the library
    yardstick, ``scaled_dot_product_attention(is_causal=True)``'s backward
    alone (``torch.autograd.grad`` on a retained graph), with GQA through
    K/V repeated to H heads before the timed call (the group sum of dK/dV
    is not timed). Bound FLOPs: 2*Dh per visible (query, key) pair per
    product, 2 products forward, 5 one pass, 3 dQ, 4 dK/dV, 7 for the
    informational split pair at T1's shape. Each entry also gives
    ``device_ms``, the kernel's time without the wrapper's host work
    (``time_ms(device_only=True)``). Every backward kernel is also launched
    twice on the same inputs and must give the same bits."""
    from pretraining_llm_tpu_torch.ops import cuda_flash

    sdpa = torch.nn.functional.scaled_dot_product_attention
    l2_buf = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def flush():
        l2_buf.zero_()

    def seg_mask(seg, t):
        """(B, 1, T, T) boolean: causal and same document."""
        causal = torch.ones((t, t), dtype=torch.bool, device=DEVICE).tril()
        return (causal[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]

    def sdpa_bwd_ms(q, k, v, do, b, h, g, t, d, seg=None):
        qs = q.view(b, h, t, d).detach().requires_grad_(True)
        ks, vs = (x.view(b, g, t, d).repeat_interleave(h // g, dim=1).detach().requires_grad_(True)
                  for x in (k, v))
        if seg is None:
            out = sdpa(qs, ks, vs, is_causal=True)
        else:
            out = sdpa(qs, ks, vs, attn_mask=seg_mask(seg, t))
        dout = do.view(b, h, t, d)
        return time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dout, retain_graph=True), flush=flush)

    gen = torch.Generator().manual_seed(SEED + 11)
    dt = torch.bfloat16
    kernels = []

    def inputs(b, h, g, t, d):
        q, do = randn((b * h, t, d), dt, gen), randn((b * h, t, d), dt, gen)
        k, v = randn((b * g, t, d), dt, gen), randn((b * g, t, d), dt, gen)
        o, lse = cuda_flash.flash_attention_fwd(q, k, v, h, g)
        delta = (do.float() * o.float()).sum(-1)
        return q, k, v, do, o, lse, delta

    def compare(name, shape, outs, got, ref, use):
        """Max-abs error and tol_use of ``got`` against ``ref``, worst over
        the outputs named ``outs``."""
        errs = {n: max_err(x, y) for n, x, y in zip(outs, got, ref)}
        uses = {n: use(x, y) for n, x, y in zip(outs, got, ref)}
        log("check_train_kernel", name=name, shape=shape, max_abs_err=errs, tol_use=uses)
        if not all(u <= 1.0 for u in uses.values()):
            raise AssertionError(f"{name} disagrees with its plain version at {shape}: {uses}")
        return max(errs.values()), max(uses.values())

    def bwd_use(x, y):
        return row_tol_use(x, y, BF16_ROW_RTOL)

    def entry(name, *, source, line, main, shape, products, pairs, d, nbytes, fn, plain_ms, library_ms, err,
              key=None, **notes):
        """Bound FLOPs count the causal pairs: no kernel skips a tile by
        segment, as ``_run_ok`` does not. ``key``: the kernel's name in the
        launch counts (the tensor-core route's count for K1 and dK/dV)."""
        key = key or name
        flops = products * 2.0 * d * pairs
        ms = time_ms(fn, flush=flush)
        kernels.append(dict(
            name=name, route="cuda", mma="wgmma" if source.endswith("_tc.cu") else "none (fp32 CUDA cores)",
            source=f"pretraining_llm_tpu_torch/csrc/{source}",
            replaces=f"pretraining_llm_tpu/ops/pallas_flash.py:{line}", shape=shape,
            launches=paths[main][key], launches_by_path={p: n[key] for p, n in paths.items()},
            flops=flops, bytes=nbytes, **_bound(flops, nbytes), max_abs_err=err[0], tol_use=err[1], ms=ms,
            device_ms=time_ms(fn, flush=flush, device_only=True), plain_ms=plain_ms, library_ms=library_ms,
            kernel_ms=ms, max_err=err[0], **notes,
        ))

    def repeat_check(name, shape, fn, first):
        """A second launch of ``fn`` on the same inputs must give the bits
        of ``first``: no kernel of the bf16 route sums in an unordered way."""
        again = fn()
        same = all(torch.equal(x, y) for x, y in zip(again, first))
        log("check_repeat", name=name, shape=shape, bit_identical=same)
        if not same:
            raise AssertionError(f"{name} differs between two launches on the same inputs at {shape}")

    # T1's shape: K1 and the one-pass kernel.
    b, h, g, t, d = 12, 12, 12, 1024, 64
    q, k, v, do, o, lse, delta = inputs(b, h, g, t, d)
    common = dict(main="T1", shape=f"B*H={b * h} T={t} Dh={d} bf16 causal", pairs=b * h * t * (t + 1) // 2, d=d)
    act, rows = q.numel() * 2, lse.numel() * 4  # one (B*H, T, Dh) bf16 tensor; one (B*H, T) fp32 row vector
    q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
    ref = cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g)
    fwd_err = compare("flash_fwd_train", common["shape"], ("o", "lse"),
                      cuda_flash.flash_attention_fwd(q, k, v, h, g),
                      cuda_flash.flash_attention_fwd_reference(q, k, v, h, g), tol_use)
    fused = lambda: cuda_flash.flash_bwd_fused(q, k, v, do, lse, delta, h, g)  # noqa: E731
    out = fused()
    bwd_err = compare("flash_bwd_fused", common["shape"], ("dq", "dk", "dv"), out, ref, bwd_use)
    repeat_check("flash_bwd_fused", common["shape"], fused, out)
    split = lambda: (cuda_flash.flash_bwd_dq(q, k, v, do, lse, delta, h, g),  # noqa: E731
                     *cuda_flash.flash_bwd_dkv(q, k, v, do, lse, delta, h, g))
    out = split()
    split_err = compare("flash_bwd_split_t1", common["shape"], ("dq", "dk", "dv"), out, ref, bwd_use)
    repeat_check("flash_bwd_split_t1", common["shape"], split, out)
    del ref, out
    bwd_plain = time_ms(lambda: cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g), flush=flush)
    bwd_lib = sdpa_bwd_ms(q, k, v, do, b, h, g, t, d)
    entry("flash_fwd_train", key="flash_fwd_tc", source="flash_fwd_tc.cu", line=104, products=2,
          nbytes=4 * act + rows, err=fwd_err, fn=lambda: cuda_flash.flash_attention_fwd(q, k, v, h, g),
          plain_ms=time_ms(lambda: cuda_flash.flash_attention_fwd_reference(q, k, v, h, g), flush=flush),
          library_ms=time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), flush=flush),
          library_note="SDPA forward, is_causal=True", **common)
    entry("flash_bwd_fused", key="flash_bwd_fused_tc", source="flash_bwd_tc.cu", line=348, products=5,
          nbytes=7 * act + 2 * rows, err=bwd_err, fn=fused, plain_ms=bwd_plain, library_ms=bwd_lib,
          library_note="SDPA backward alone (dq, dk, dv), is_causal=True", **common)
    # Informational: the split pair (dQ, then dK/dV) on the one pass's work,
    # to weigh the one pass's ordered dQ sum against a second walk. T1 runs
    # the one pass (the JAX block rule), so its launches there are 0.
    entry("flash_bwd_split_t1", key="flash_bwd_dq_tc", source="flash_bwd_tc.cu", line=236, products=7,
          nbytes=8 * act + 4 * rows, err=split_err, fn=split, plain_ms=bwd_plain, library_ms=bwd_lib,
          library_note="SDPA backward alone (dq, dk, dv), is_causal=True",
          launches_note="dQ (pallas_flash.py:236) then dK/dV (:291) at T1's shape; not on any path at this shape",
          **common)

    # The same at T1's shape with T3's document segments (data/parity
    # windows split at DOC_SEP): K1 and the one-pass kernel as T3 runs them.
    seg = parity_segments(b, t, SEED + 15)
    o, lse = cuda_flash.flash_attention_fwd(q, k, v, h, g, segments=seg)
    delta = (do.float() * o.float()).sum(-1)
    common.update(main="T3", shape=common["shape"] + " segments " + json.dumps(segment_summary(seg)))
    fwd_err = compare("flash_fwd_seg", common["shape"], ("o", "lse"),
                      cuda_flash.flash_attention_fwd(q, k, v, h, g, segments=seg),
                      cuda_flash.flash_attention_fwd_reference(q, k, v, h, g, segments=seg), tol_use)
    fused = lambda: cuda_flash.flash_bwd_fused(q, k, v, do, lse, delta, h, g, segments=seg)  # noqa: E731
    out = fused()
    bwd_err = compare("flash_bwd_fused_seg", common["shape"], ("dq", "dk", "dv"), out,
                      cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g, segments=seg), bwd_use)
    repeat_check("flash_bwd_fused_seg", common["shape"], fused, out)
    del out
    mask = seg_mask(seg, t)
    entry("flash_fwd_seg", key="flash_fwd_tc", source="flash_fwd_tc.cu", line=104, products=2,
          nbytes=4 * act + rows + seg.numel() * 4, err=fwd_err,
          fn=lambda: cuda_flash.flash_attention_fwd(q, k, v, h, g, segments=seg),
          plain_ms=time_ms(lambda: cuda_flash.flash_attention_fwd_reference(q, k, v, h, g, segments=seg),
                           flush=flush),
          library_ms=time_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask), flush=flush),
          library_note="SDPA forward with a (B, 1, T, T) boolean causal-and-same-document mask", **common)
    entry("flash_bwd_fused_seg", key="flash_bwd_fused_tc", source="flash_bwd_tc.cu", line=348, products=5,
          nbytes=7 * act + 2 * rows + seg.numel() * 4, err=bwd_err, fn=fused,
          plain_ms=time_ms(lambda: cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g,
                                                                            segments=seg), flush=flush),
          library_ms=sdpa_bwd_ms(q, k, v, do, b, h, g, t, d, seg),
          library_note="SDPA backward alone (dq, dk, dv) with the boolean causal-and-same-document mask",
          **common)
    del q, k, v, do, o, lse, delta, q4, k4, v4, seg, mask, fused, split

    # T2's shape: the dQ and dK/dV kernels. q, dO (B*H) and k, v (B*G) in.
    b, h, g, t, d = 2, 16, 4, 2048, 128
    q, k, v, do, o, lse, delta = inputs(b, h, g, t, d)
    common = dict(main="T2", shape=f"B={b} H={h} G={g} T={t} Dh={d} bf16 causal", pairs=b * h * t * (t + 1) // 2,
                  d=d, plain_note="the plain backward computes dq, dk and dv together",
                  library_note="SDPA backward alone (dq, dk, dv), is_causal=True, K/V repeated to 16 heads "
                               "before the call (not timed; the group sum of dK/dV not timed)")
    bwd_in = 2 * q.numel() * 2 + 2 * k.numel() * 2 + 2 * lse.numel() * 4
    ref = cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g)
    dq_fn = lambda: (cuda_flash.flash_bwd_dq(q, k, v, do, lse, delta, h, g),)  # noqa: E731
    dkv_fn = lambda: cuda_flash.flash_bwd_dkv(q, k, v, do, lse, delta, h, g)  # noqa: E731
    dq_out, dkv_out = dq_fn(), dkv_fn()
    dq_err = compare("flash_bwd_dq", common["shape"], ("dq",), dq_out, ref[:1], bwd_use)
    dkv_err = compare("flash_bwd_dkv", common["shape"], ("dk", "dv"), dkv_out, ref[1:], bwd_use)
    repeat_check("flash_bwd_dq", common["shape"], dq_fn, dq_out)
    repeat_check("flash_bwd_dkv", common["shape"], dkv_fn, dkv_out)
    del ref, dq_out, dkv_out
    common["plain_ms"] = time_ms(lambda: cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g),
                                 flush=flush)
    common["library_ms"] = sdpa_bwd_ms(q, k, v, do, b, h, g, t, d)
    entry("flash_bwd_dq", key="flash_bwd_dq_tc", source="flash_bwd_tc.cu", line=236, products=3,
          nbytes=bwd_in + q.numel() * 2, err=dq_err, fn=dq_fn, **common)
    entry("flash_bwd_dkv", key="flash_bwd_dkv_tc", source="flash_bwd_tc.cu", line=291, products=4,
          nbytes=bwd_in + 2 * k.numel() * 2, err=dkv_err, fn=dkv_fn, **common)

    # The same kernels at T2's shape with document segments.
    seg = parity_segments(b, t, SEED + 16)
    o, lse = cuda_flash.flash_attention_fwd(q, k, v, h, g, segments=seg)
    delta = (do.float() * o.float()).sum(-1)
    common.update(shape=common["shape"] + " segments " + json.dumps(segment_summary(seg)),
                  launches_note="the same kernel as the entry without segments, with its segment mask; "
                                "T2 runs it without segments",
                  library_note="SDPA backward alone (dq, dk, dv) with a (B, 1, T, T) boolean causal-and-same-"
                               "document mask, K/V repeated to 16 heads before the call (not timed)")
    ref = cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g, segments=seg)
    dq_err = compare("flash_bwd_dq_seg", common["shape"], ("dq",),
                     (cuda_flash.flash_bwd_dq(q, k, v, do, lse, delta, h, g, segments=seg),), ref[:1], bwd_use)
    dkv_err = compare("flash_bwd_dkv_seg", common["shape"], ("dk", "dv"),
                      cuda_flash.flash_bwd_dkv(q, k, v, do, lse, delta, h, g, segments=seg), ref[1:], bwd_use)
    del ref
    common["plain_ms"] = time_ms(lambda: cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g,
                                                                                  segments=seg), flush=flush)
    common["library_ms"] = sdpa_bwd_ms(q, k, v, do, b, h, g, t, d, seg)
    entry("flash_bwd_dq_seg", key="flash_bwd_dq_tc", source="flash_bwd_tc.cu", line=236, products=3,
          nbytes=bwd_in + q.numel() * 2 + seg.numel() * 4, err=dq_err,
          fn=lambda: cuda_flash.flash_bwd_dq(q, k, v, do, lse, delta, h, g, segments=seg), **common)
    entry("flash_bwd_dkv_seg", key="flash_bwd_dkv_tc", source="flash_bwd_tc.cu", line=291, products=4,
          nbytes=bwd_in + 2 * k.numel() * 2 + seg.numel() * 4, err=dkv_err,
          fn=lambda: cuda_flash.flash_bwd_dkv(q, k, v, do, lse, delta, h, g, segments=seg), **common)
    del q, k, v, do, o, lse, delta, seg

    # The T4 presets' MHA shapes at Dh 128 (BWD_CASES' three last cases):
    # the one pass at gpt2-1p3b-fsdp's T 1024 and reference-3b's T 512, the
    # dQ and dK/dV kernels at llama-1b's T 2048.
    for b, h, g, t, d, main, names in ((1, 16, 16, 1024, 128, "T4 gpt2-1p3b-fsdp", ("flash_bwd_fused_1p3b",)),
                                       (1, 16, 16, 512, 128, "T4 reference-3b", ("flash_bwd_fused_3b",)),
                                       (1, 16, 16, 2048, 128, "T4 llama-1b",
                                        ("flash_bwd_dq_llama1b", "flash_bwd_dkv_llama1b"))):
        q, k, v, do, o, lse, delta = inputs(b, h, g, t, d)
        common = dict(main=main, shape=f"B={b} H={h} G={g} T={t} Dh={d} bf16 causal", pairs=b * h * t * (t + 1) // 2,
                      d=d, library_note="SDPA backward alone (dq, dk, dv), is_causal=True")
        act, rows = q.numel() * 2, lse.numel() * 4
        ref = cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g)
        common["plain_ms"] = time_ms(lambda: cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g),
                                     flush=flush)
        common["library_ms"] = sdpa_bwd_ms(q, k, v, do, b, h, g, t, d)
        if len(names) == 1:
            fused = lambda: cuda_flash.flash_bwd_fused(q, k, v, do, lse, delta, h, g)  # noqa: E731
            out = fused()
            err = compare(names[0], common["shape"], ("dq", "dk", "dv"), out, ref, bwd_use)
            repeat_check(names[0], common["shape"], fused, out)
            entry(names[0], key="flash_bwd_fused_tc", source="flash_bwd_tc.cu", line=348, products=5,
                  nbytes=7 * act + 2 * rows, err=err, fn=fused, **common)
        else:
            dq_fn = lambda: (cuda_flash.flash_bwd_dq(q, k, v, do, lse, delta, h, g),)  # noqa: E731
            dkv_fn = lambda: cuda_flash.flash_bwd_dkv(q, k, v, do, lse, delta, h, g)  # noqa: E731
            dq_out, dkv_out = dq_fn(), dkv_fn()
            dq_err = compare(names[0], common["shape"], ("dq",), dq_out, ref[:1], bwd_use)
            dkv_err = compare(names[1], common["shape"], ("dk", "dv"), dkv_out, ref[1:], bwd_use)
            repeat_check(names[0], common["shape"], dq_fn, dq_out)
            repeat_check(names[1], common["shape"], dkv_fn, dkv_out)
            bwd_in = 4 * act + 2 * rows
            entry(names[0], key="flash_bwd_dq_tc", source="flash_bwd_tc.cu", line=236, products=3,
                  nbytes=bwd_in + act, err=dq_err, fn=dq_fn, **common)
            entry(names[1], key="flash_bwd_dkv_tc", source="flash_bwd_tc.cu", line=291, products=4,
                  nbytes=bwd_in + 2 * act, err=dkv_err, fn=dkv_fn, **common)
        del q, k, v, do, o, lse, delta, ref

    # M1's shapes (moe-8x350m, MHA, Dh 64): K1 and the one pass at a
    # training microbatch of 8 x 1024, K1 at its generate's prefill of 8
    # prompts of 256 tokens.
    for b, t, main, names in ((8, 1024, "M1", ("flash_fwd_m1", "flash_bwd_fused_m1")),
                              (8, 256, "M1 generate", ("flash_fwd_m1_prefill",))):
        h = g = 16
        d = 64
        q, k, v, do, o, lse, delta = inputs(b, h, g, t, d)
        common = dict(main=main, shape=f"B={b} H={h} G={g} T={t} Dh={d} bf16 causal", pairs=b * h * t * (t + 1) // 2,
                      d=d)
        act, rows = q.numel() * 2, lse.numel() * 4
        q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
        fwd = lambda: cuda_flash.flash_attention_fwd(q, k, v, h, g)  # noqa: E731
        fwd_err = compare(names[0], common["shape"], ("o", "lse"), fwd(),
                          cuda_flash.flash_attention_fwd_reference(q, k, v, h, g), tol_use)
        entry(names[0], key="flash_fwd_tc", source="flash_fwd_tc.cu", line=104, products=2,
              nbytes=4 * act + rows, err=fwd_err, fn=fwd,
              plain_ms=time_ms(lambda: cuda_flash.flash_attention_fwd_reference(q, k, v, h, g), flush=flush),
              library_ms=time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), flush=flush),
              library_note="SDPA forward, is_causal=True", **common)
        if len(names) == 2:
            fused = lambda: cuda_flash.flash_bwd_fused(q, k, v, do, lse, delta, h, g)  # noqa: E731
            out = fused()
            err = compare(names[1], common["shape"], ("dq", "dk", "dv"), out,
                          cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g), bwd_use)
            repeat_check(names[1], common["shape"], fused, out)
            del out
            entry(names[1], key="flash_bwd_fused_tc", source="flash_bwd_tc.cu", line=348, products=5,
                  nbytes=7 * act + 2 * rows, err=err, fn=fused,
                  plain_ms=time_ms(lambda: cuda_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, h, g),
                                   flush=flush),
                  library_ms=sdpa_bwd_ms(q, k, v, do, b, h, g, t, d),
                  library_note="SDPA backward alone (dq, dk, dv), is_causal=True", **common)
        del q, k, v, do, o, lse, delta, q4, k4, v4
    return kernels


def time_ce_kernels(paths, fp32_wide):
    """The fused CE kernels at T1's (and T3's) head shape: S = 12 x 1024
    tokens, D 768, V 50304, bf16, W ~ N(0, 0.02^2) (the model's init), the
    mean's uniform cotangent 1/S. Each is first held against its plain
    version on the same inputs (``ce_compare``), then timed: the kernel, the
    plain version (fewer runs: it walks 393 vocabulary tiles) and the
    library yardstick, a composite of cuBLAS and torch ops doing the same
    work (B9: the (S, V) logits as one bf16 GEMM with fp32 output, then
    logsumexp and a gather; B10 and B11: the same GEMM, p~ elementwise and
    cast to bf16, then the one product). Bound FLOPs: 2*S*D*V per product
    (B9 one, B10 and B11 two: the recompute and their own); bytes: h, W,
    labels (and lse, g) read once, the outputs written once. B10 and B11
    also give the design's floor (the logits once per D-chunk, then the
    second product, at the bf16 peak), their plan, a sweep of plans
    (``ce_bwd_sweep``: chunk widths and partition counts, alternated
    launches) and ptxas's registers for the planned instantiation. Each
    redesigned kernel gives fused_ce.cu's ``mma.sync`` kernel on the same
    inputs after "was"."""
    from pretraining_llm_tpu_torch.ops import _build
    from pretraining_llm_tpu_torch.ops import ce_reference as ref
    from pretraining_llm_tpu_torch.ops import cuda_ce

    l2_buf = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def flush():
        l2_buf.zero_()

    (s, d, v), dt = T1_HEAD, torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 17)
    h = randn((s, d), dt, gen)
    w_vd = (torch.randn((v, d), generator=gen) * 0.02).to(device=DEVICE, dtype=dt)
    labels = torch.randint(0, v, (s,), generator=gen, dtype=torch.int32).to(DEVICE)
    g = torch.full((s,), 1.0 / s, device=DEVICE)
    errs = ce_compare("check_ce_t1_shape", h, w_vd, labels, g)
    _, lse = cuda_ce.fused_ce_fwd(h, w_vd, labels)

    def logits32():
        return torch.mm(h, w_vd.t(), out_dtype=torch.float32)  # bf16 operands, fp32 output (cuBLAS)

    rows = torch.arange(s, device=DEVICE)

    def lib_fwd():
        z = logits32()
        lse_ = torch.logsumexp(z, dim=1)
        return lse_ - z.gather(1, labels.long()[:, None])[:, 0], lse_

    def lib_p():
        p = torch.exp_(logits32().sub_(lse[:, None]))
        p[rows, labels.long()] -= 1.0
        return p.mul_(g[:, None]).to(dt)

    mm_name = "torch.mm(out_dtype=float32)"
    operand_bytes = s * d * 2 + v * d * 2 + s * 4
    flops = 2.0 * s * d * v
    shape = f"S={s} D={d} V={v} bf16"
    kernels = []
    sms = _build.sm_count(h.device.index)
    for name, line, fn, plain, lib, products, nbytes, note in (
        ("fused_ce_fwd", 80, lambda: cuda_ce.fused_ce_fwd(h, w_vd, labels),
         lambda: ref.fused_ce_fwd_reference(h, w_vd.t(), labels), lib_fwd, 1, operand_bytes + 2 * s * 4,
         f"composite: {mm_name} (S, V) logits, logsumexp, gather"),
        ("fused_ce_dh", 122, lambda: cuda_ce.fused_ce_dh(h, w_vd, labels, lse, g),
         lambda: ref.fused_ce_dh_reference(h, w_vd.t(), labels, lse, g), lambda: torch.mm(lib_p(), w_vd), 2,
         operand_bytes + 2 * s * 4 + s * d * 2, f"composite: {mm_name} logits, p~ elementwise to bf16, p~ @ W"),
        ("fused_ce_dw", 148, lambda: cuda_ce.fused_ce_dw(h, w_vd, labels, lse, g),
         lambda: ref.fused_ce_dw_reference(h, w_vd.t(), labels, lse, g), lambda: torch.mm(lib_p().t(), h), 2,
         operand_bytes + 2 * s * 4 + v * d * 2, f"composite: {mm_name} logits, p~ elementwise to bf16, p~^T @ h"),
    ):
        f = flops * products
        fwd = name == "fused_ce_fwd"
        route_rule = "ce_route" if fwd else "ce_bwd_route"
        if getattr(cuda_ce, route_rule)(dt) != "wgmma":
            raise AssertionError(f"{name}: the timed shape does not take the tensor-core route")
        # The redesign's "was": fused_ce.cu's mma.sync kernel on the same inputs, this run.
        with _forced(cuda_ce, route_rule, "fp32"):
            extra = dict(was_ms=time_ms(fn, n=10, warmup=2, flush=flush),
                         was_device_ms=time_ms(fn, n=10, warmup=2, flush=flush, device_only=True),
                         was_source=f"pretraining_llm_tpu_torch/csrc/fused_ce.cu (ce_kernel<bf16, D, "
                                    f"{'FWD' if fwd else name[-2:].upper()}>, mma.sync, same inputs, this run)")
        extra["launches_by_route"] = {r: paths["T3"][f"{name}_{r}"] for r in cuda_ce.ROUTES}
        if fwd:
            extra["partitions"] = cuda_ce.ce_partitions(s, v, sms)
        else:
            kind = name[-2:]
            dc, chunks, parts, per = cuda_ce.ce_bwd_plan(kind, s, v, d, sms)
            floor_flops = flops * (chunks + 1)
            extra.update(
                plan={"dc": dc, "chunks": chunks, "partitions": parts, "walked_tiles_per_partition": per,
                      "blocks": -(-(s if kind == "dh" else v) // cuda_ce.BWD_BM) * chunks * parts},
                floor_flops=floor_flops, floor_ms=floor_flops / PEAK_BF16_FLOPS * 1e3,
                floor_note=f"the logits recomputed once per D-chunk ({chunks}) plus the second product, "
                           "at the bf16 peak",
                ptxas={entry: lines for entry, lines in PTXAS.get("fused_ce_bwd_tc", {}).items()
                       if f"ce_bwd_tc_kernelILi{_BWD_MODE[kind]}ELi{dc}E" in entry})
            ce_bwd_sweep(name, shape, kind, s, v, d, fn, flush)
        kernels.append(dict(
            name=name, route="cuda", mma="wgmma",
            source="pretraining_llm_tpu_torch/csrc/" + ("fused_ce_tc.cu" if fwd else "fused_ce_bwd_tc.cu"),
            replaces=f"pretraining_llm_tpu/ops/pallas_ce.py:{line}", shape=shape,
            launches=paths["T3"][f"{name}_wgmma"],
            launches_by_path={p: n[name] for p, n in paths.items()},
            flops=f, bytes=nbytes, **_bound(f, nbytes), max_abs_err=errs[name][0], tol_use=errs[name][1],
            ms=time_ms(fn, n=10, warmup=2, flush=flush),
            device_ms=time_ms(fn, n=10, warmup=2, flush=flush, device_only=True),
            plain_ms=time_ms(plain, n=3, warmup=1, flush=flush),
            library_ms=time_ms(lib, n=10, warmup=2, flush=flush), library_note=note,
            plain_note="walks the JAX tiles: 393 vocabulary tiles of 128 (pallas_ce._tiles)",
            fp32_route=fp32_wide[name], **extra,
        ))
        kernels[-1]["kernel_ms"], kernels[-1]["max_err"] = kernels[-1]["ms"], kernels[-1]["max_abs_err"]
        _free_card()
    return kernels


_BWD_MODE = {"dh": 0, "dw": 1}  # csrc/fused_ce_bwd_tc.cu's Mode, in its mangled kernel names
# Plans (DC, partitions) of the dH and dW sweeps at T3's head: the plan's
# own pick is among them.
BWD_SWEEP = {"dh": ((256, 1), (256, 3), (256, 4), (256, 5), (256, 8), (192, 1), (192, 3), (128, 2)),
             "dw": ((256, 1), (256, 2), (192, 1), (128, 1))}


def ce_bwd_sweep(name, shape, kind, s, v, d, fn, flush) -> None:
    """``fn`` (B10 or B11) under each plan of BWD_SWEEP[kind], alternated
    (``split_sweep``)."""
    from pretraining_llm_tpu_torch.ops import cuda_ce

    n_wt = -(-(v if kind == "dh" else s) // cuda_ce.BWD_BN)
    plans = {}
    for dc, p in BWD_SWEEP[kind]:
        per = -(-n_wt // p)
        plans[f"dc{dc}_p{-(-n_wt // per)}"] = (dc, -(-d // dc), -(-n_wt // per), per)

    def call(label):
        with _forced(cuda_ce, "ce_bwd_plan", plans[label]):
            return fn()

    split_sweep(f"{name}_sweep", shape, "plan", tuple(plans), call, flush)


def _bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import pretraining_llm_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2
    # Full-precision fp32 references (no TF32 in matmuls or convolutions).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)

    phase_card()
    phase_build()
    errs = {"flash_fwd": check_flash(), **check_paged(), **check_ragged()}
    check_flash_bwd()
    fp32_wide = check_ce()
    check_misaligned()
    check_model_card_vs_cpu()
    check_model_chunked_card_vs_cpu()
    check_generate_card_vs_cpu()
    check_train_card_vs_cpu()
    check_moe_card_vs_cpu()
    check_doc_isolation()
    launches1, prefill_shapes, streams1 = run_main_path()
    launches2, eng2 = run_path2()
    launches3, _ = run_path3()
    serving_paths = {"path4": run_path4(streams1),
                     "checksum": run_checksum([eng2.finished[r] for r in range(len(eng2.finished))])}
    launches_t1 = run_train_path1()
    launches_g1 = run_g1()  # on T1's checkpoint, before SCRATCH goes
    serve_ckpts = save_serving_checkpoints()  # T1's weights, before SCRATCH goes
    p5 = run_path5(serve_ckpts)
    serving_paths.update(path5=p5[0], path5_llama=run_path5_llama())
    run_serve_cli(serve_ckpts, p5)
    train_paths = {"T1": launches_t1, "T2": run_train_path2(), "parity": run_parity(),
                   "T3": run_train_path3()}
    train_paths.update(run_t4())
    train_paths.update(run_m1())
    train_paths.update(run_remat_sweep())
    train_paths.update(run_optimizers())
    run_trainer_options()
    train_paths["D1"] = run_d1()
    shutil.rmtree(SCRATCH, ignore_errors=True)
    kernels = time_kernels(launches1, prefill_shapes, errs, launches_g1, serving_paths)
    kernels += time_ragged((launches1, launches2, launches3), eng2, errs, serving_paths)
    del eng2
    kernels += time_train_kernels(train_paths)
    kernels += time_ce_kernels(train_paths, fp32_wide)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [D1_CHILD]:
        sys.exit(d1_child(sys.argv[2:]))
    sys.exit(main())
