"""Benchmark entry of the PyTorch port: ``python -m pretraining_llm_tpu_torch.bench``.

The JAX package's ``bench.py`` (its flags, defaults, modes, metric names
and record keys), run on the port: prints ONE JSON line,

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Modes (``--mode``): ``train`` (the train step's MFU and tokens/s, timed as
the slope between two run lengths so fixed overheads cancel), ``decode``
(``generate`` on ``generation.generate.decode_bench_workload``),
``trainer`` (the whole ``Trainer`` loop on synthetic data; compare
``--prefetch 0`` with ``2``), ``serving`` (``ServingEngine`` over a
mixed-length request set), ``serving-slo`` (Poisson arrivals through the
frontend ``EngineLoop``: TTFT/TPOT/e2e percentiles and goodput under the
SLO), ``serving-fleet`` (the same load through the ``Router`` while a
``--fleet-scenario`` disturbance runs) and ``kernel`` (the ragged paged
attention kernel K3 against its plain version over JAX's four lanes).
Each mode rejects the flags of the others with the JAX package's
``ValueError``, and every mode rejects ``--unroll``, ``--cache-layout`` and
``--decode-unroll``, knobs of the JAX program that change nothing here.
The serving modes run the hand-written paged kernels unless
``--paged-attn gather`` asks for the plain version (a ``_gather`` series);
their records state ``paged_attention_impl``. ``vs_baseline`` is MFU / 0.50 for train and trainer and
null elsewhere (no reference number exists).

Every record names its device: ``torch.cuda.get_device_name()``, or
``"cpu"``. MFU is tokens/s x ``ModelConfig.flops_per_token`` over
``training.metrics.device_peak_flops`` (989e12 for the H100); on the CPU,
which has no peak, it is null (and so is the train mode's ``value``).
``--device cuda`` (the default) never falls back to the CPU: with no GPU
the run ends in an ``environment_error`` record and exit 1. ``--device
cpu`` runs the kernels' plain PyTorch versions (``cpu_interpret: true`` on
the kernel record).

The default entry point is a wrapper: a one-matmul canary in a fresh
process classifies the environment first (one retry, then
``environment_error: true``), then each attempt runs in a fresh process
(``--_inner``) under ``--attempt-timeout``, with backoff on transient
failures (an out-of-memory error is deterministic) until
``--timeout-budget`` is spent. A default gpt2-124m train run races the JAX
package's rungs (remat policy, CE head, batch), contenders apart from
fallbacks, reports the best with every rung's numbers under ``rungs`` and
re-runs the winner ``--race-repeats`` times for a median. The rung order
and gpt2-124m's default batch of 16 are the JAX package's choices; they
were not measured on the card. On failure it prints a structured error
line (the inner run's, when it left one), never a traceback.

The race's ``value`` is its best sample, as in the JAX package; a
comparison across runs reads ``value_median``. The kernel mode times
JAX's 4-row shapes, where launch and host overhead dominate: its
``value`` is not a measure of K3 at serving shapes.

Usage::

  python -m pretraining_llm_tpu_torch.bench                  # gpt2-124m train race
  python -m pretraining_llm_tpu_torch.bench --quick --mode decode
  python -m pretraining_llm_tpu_torch.bench --device cpu --preset tiny --quick --mode serving
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the checkout: the inner runs start here
MODULE = "pretraining_llm_tpu_torch.bench"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Benchmark of the PyTorch port: one JSON line.")
    parser.add_argument("--preset", default="gpt2-124m")
    parser.add_argument(
        "--batch", type=int, default=0,
        help="global batch (0 = the bench's default: 16 for gpt2-124m, the JAX package's choice, "
        "else the preset's training batch)",
    )
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument(
        "--mode", default="train", choices=["train", "decode", "trainer",
                                            "serving", "serving-slo",
                                            "serving-fleet", "kernel"],
        help="train: MFU + tokens/sec of the train step; decode: KV-cached generate tokens/sec; "
        "trainer: the whole Trainer loop with its input pipeline (compare --prefetch 0 vs 2); "
        "serving: continuous-batching paged engine throughput; serving-slo: latency and goodput "
        "under Poisson load through the frontend EngineLoop; serving-fleet: the same load through "
        "the Router while a --fleet-scenario disturbance runs; kernel: the ragged paged-attention "
        "kernel over JAX's lanes and variants (on the CPU the plain versions run: cpu_interpret)",
    )
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="'cpu' runs the kernels' plain PyTorch versions; 'cuda' never falls back to the CPU",
    )
    parser.add_argument(
        "--steps-per-sched", type=int, default=0,
        help="serving mode: decode steps per scheduling window (0 = default 8)",
    )
    parser.add_argument(
        "--prefetch", type=int, default=-1,
        help="trainer mode: data.prefetch depth override (-1 = preset value)",
    )
    parser.add_argument(
        "--ragged", action="store_true",
        help="decode mode: per-row prompt lengths (one lockstep ragged batch)",
    )
    parser.add_argument(
        "--optimizer", default="", choices=["", "adamw", "adafactor", "muon"],
        help="train mode: optimizer override",
    )
    parser.add_argument(
        "--grad-dtype", default="", choices=["", "float32", "bfloat16"],
        help="train mode: gradient storage dtype override",
    )
    parser.add_argument(
        "--kv-dtype", default="", choices=["", "compute", "int8"],
        help="decode mode: KV-cache element type override",
    )
    parser.add_argument("--attention", default="", choices=["", "naive", "flash"])
    parser.add_argument("--ce", default="", choices=["", "chunked", "fused", "dense"])
    parser.add_argument(
        "--remat", default="", choices=["", "none", "full", "dots_saveable", "save_attn", "save_attn_res",
                                        "save_qkv_attn", "save_big"]
    )
    parser.add_argument(
        "--unroll", type=int, default=0,
        help="the JAX program's scan_unroll: parsed so its command lines parse, rejected in every "
        "mode (no effect on the port)",
    )
    parser.add_argument(
        "--context", type=int, default=0,
        help="train mode: context_length override (RoPE presets only: learned position tables "
        "are sized by the preset's context)",
    )
    parser.add_argument(
        "--cache-layout", default="", choices=["", "stacked", "unstacked"],
        help="the JAX program's KV-cache container layout: parsed so its command lines parse, "
        "rejected in every mode (no effect on the port)",
    )
    parser.add_argument(
        "--decode-unroll", action="store_true",
        help="the JAX program's decode_unroll_layers: parsed so its command lines parse, "
        "rejected in every mode (no effect on the port)",
    )
    parser.add_argument(
        "--block-q", type=int, default=0,
        help="flash q-block override (0 = auto); with --block-kv it picks the flash backward's "
        "algorithm as in the JAX package",
    )
    parser.add_argument(
        "--block-kv", type=int, default=0,
        help="flash kv-block override (0 = auto)",
    )
    parser.add_argument(
        "--timeout-budget", type=float, default=1800.0,
        help="total seconds across all attempts before giving up with a JSON error",
    )
    parser.add_argument(
        "--attempt-timeout", type=float, default=700.0,
        help="hard wall-clock cap for a single attempt (the kernels' first build included)",
    )
    parser.add_argument(
        "--race-repeats", type=int, default=3,
        help="same-config samples of the race winner to collect (budget permitting) for a "
        "median; 1 = no repeat runs",
    )
    parser.add_argument(
        "--no-pipeline", action="store_true",
        help="serving mode: the synchronous scheduler instead of the pipelined one",
    )
    parser.add_argument(
        "--pipeline-depth", type=int, default=0,
        help="serving mode: in-flight decode-window depth (0 = engine default 2)",
    )
    parser.add_argument(
        "--admit-batch", type=int, default=0,
        help="serving mode: admit waiting prefills in batches of this many (0/1 = eagerly)",
    )
    parser.add_argument(
        "--paged-attn", default="", choices=["", "gather", "kernel"],
        help="serving modes: paged attention (default kernel = K2 and K3; gather = the plain "
        "pool[tables], filed under a _gather series)",
    )
    parser.add_argument(
        "--quantize", default="", choices=["", "none", "int8", "int8-kv"],
        help="serving/serving-slo mode: int8 weights ('int8'), plus int8 KV pages with per-token "
        "scales ('int8-kv'); records gain a 'quantization' block",
    )
    parser.add_argument(
        "--spec-draft", default="", choices=["", "self"],
        help="serving mode: speculative decoding with the target as its own draft (the "
        "acceptance upper bound)",
    )
    parser.add_argument(
        "--spec-k", type=int, default=4,
        help="serving mode: draft proposals per speculative round",
    )
    parser.add_argument(
        "--rate-rps", type=float, default=4.0,
        help="serving-slo mode: open-loop Poisson arrival rate",
    )
    parser.add_argument(
        "--slo-ttft-s", type=float, default=1.0,
        help="serving-slo mode: TTFT bound for goodput (0 = none)",
    )
    parser.add_argument(
        "--slo-e2e-s", type=float, default=10.0,
        help="serving-slo mode: end-to-end bound for goodput (0 = none)",
    )
    parser.add_argument(
        "--n-requests", type=int, default=0,
        help="serving-slo mode: workload size (0 = 3x max_batch)",
    )
    parser.add_argument(
        "--prefix-cache", action="store_true",
        help="serving/serving-slo mode: cross-request prefix cache",
    )
    parser.add_argument(
        "--prefix-pool-size", type=int, default=0,
        help="serving-slo mode: hot-prefix scenario, the pool of shared prefixes (0 = off)",
    )
    parser.add_argument(
        "--prefix-len", type=int, default=0,
        help="serving-slo mode: shared-prefix length in tokens (0 = 2x block_size with a pool)",
    )
    parser.add_argument(
        "--prefix-zipf", type=float, default=1.0,
        help="serving-slo mode: zipf skew over prefix-pool rank (0 = uniform)",
    )
    parser.add_argument(
        "--prefill-chunk-tokens", type=int, default=0,
        help="serving/serving-slo mode: chunked prefill of at most this many tokens a chunk "
        "(0 = off); serving-slo also runs a monolithic baseline and records the TTFT-p99 delta",
    )
    parser.add_argument(
        "--replicas", type=int, default=2,
        help="serving-fleet mode: engine replicas behind the router",
    )
    parser.add_argument(
        "--fleet-scenario", default="kill",
        choices=[
            "kill", "rolling", "hotprefix", "upgrade", "proc-kill",
            "partition", "disagg", "decode-sat",
        ],
        help="serving-fleet mode: kill = replica_crash on replica 0 a third into the burst; "
        "rolling = drain/restore each replica in turn; hotprefix = zipf-skewed shared prefixes "
        "(prefix-affinity placement); upgrade = probe-vetted rolling weight upgrade; proc-kill = "
        "worker processes (RemoteReplica), SIGKILL worker 0 mid-burst; partition = worker "
        "processes, blackhole worker 0 mid-decode, lease expiry redrives, heal and count the "
        "fenced frames; disagg = replica 0 serves prefill legs only, the rest decode migrated KV "
        "pages; decode-sat = disagg at 4x --rate-rps with a live SLO engine on the fleet bus",
    )
    parser.add_argument("--_inner", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--_canary", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument(
        "--canary-timeout", type=float, default=150.0,
        help="seconds the one-matmul environment canary may take",
    )
    parser.add_argument(
        "--skip-canary", action="store_true",
        help="skip the environment canary (e.g. on a known-good device)",
    )
    return parser.parse_args(argv)


_T0 = time.monotonic()


def _stamp(msg: str) -> None:
    """Phase stamp to stderr: a killed attempt names its phase."""
    print(f"[bench-inner {time.monotonic() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def _device(args: argparse.Namespace):
    from pretraining_llm_tpu_torch.utils.device import resolve_device

    return resolve_device(args.device)


def _device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mfu(tok_per_sec: float, model, dev):
    """MFU against the device's bf16 peak; None where none is known (CPU)."""
    from pretraining_llm_tpu_torch.training.metrics import device_peak_flops

    peak = device_peak_flops(dev)
    return None if peak is None else tok_per_sec * model.flops_per_token() / peak


def _round(x, nd: int):
    return None if x is None else round(x, nd)


def canary_main(device: str = "cuda") -> int:
    """One bf16 matmul on ``device`` in this process: success proves the
    device is up and runs work. No GPU for ``cuda`` prints an error line
    and returns 1."""
    _stamp("canary: importing torch")
    import torch

    from pretraining_llm_tpu_torch.utils.device import resolve_device

    try:
        dev = resolve_device(device)
    except RuntimeError as exc:
        print(json.dumps({"ok": False, "error": str(exc)}))
        return 1
    x = torch.ones((512, 512), dtype=torch.bfloat16, device=dev)
    val = float((x @ x)[0, 0])
    _stamp(f"canary: matmul done ({val})")
    print(json.dumps({"ok": True, "platform": "gpu" if dev.type == "cuda" else "cpu",
                      "device": _device_name(dev),
                      "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1}))
    return 0


# Knobs of the JAX program that change nothing in the port (its config
# keeps their fields and ignores them): parsed, so the JAX package's
# command lines still parse, and rejected in every mode.
_INERT_KNOBS = ("unroll", "cache_layout", "decode_unroll")


def _reject_knobs(args: argparse.Namespace, noop: dict, path: str) -> None:
    """Knobs are rejected, not ignored: a record made under them would read
    as the default run's. A mode's foreign knobs first (the JAX package's
    text), then the knobs the port has no use for."""
    bad = [k for k, v in noop.items() if v]
    if bad:
        raise ValueError(f"{', '.join(bad)} have no effect on {path}")
    bad = ["--" + k.replace("_", "-") for k in _INERT_KNOBS if getattr(args, k)]
    if bad:
        raise ValueError(f"{', '.join(bad)} have no effect on the port")


def run_decode_bench(args: argparse.Namespace) -> dict:
    """KV-cached generation throughput: tokens/sec of ``generate`` (K1
    prefill, then single-token decode steps against the dense cache)."""
    import numpy as np

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.generate import decode_bench_workload, generate

    cfg = get_preset(args.preset).model
    noop = {  # train-only knobs
        "--attention": args.attention, "--remat": args.remat, "--ce": args.ce,
        "--optimizer": args.optimizer, "--unroll": args.unroll,
        "--block-q": args.block_q, "--block-kv": args.block_kv,
        "--steps-per-sched": args.steps_per_sched,
        "--context": args.context, "--paged-attn": args.paged_attn,
        "--spec-draft": args.spec_draft, "--no-pipeline": args.no_pipeline,
        "--pipeline-depth": args.pipeline_depth,
        "--admit-batch": args.admit_batch,
        "--grad-dtype": args.grad_dtype,
        "--prefix-cache": args.prefix_cache,
        "--prefix-pool-size": args.prefix_pool_size,
        "--prefix-len": args.prefix_len,
        "--prefill-chunk-tokens": args.prefill_chunk_tokens,
        "--quantize": args.quantize,
    }
    _reject_knobs(args, noop, "the cached decode path")
    if args.kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_dtype)
    batch = args.batch or 8
    if args.quick:
        batch = min(batch, 4)
    dev = _device(args)
    cfg, params, prompt, new_tokens = decode_bench_workload(cfg, batch, quick=args.quick, device=dev)
    prompt_len = int(prompt.shape[1])
    # --ragged: per-row prompt lengths over [prompt_len/4, prompt_len].
    lengths = None
    if args.ragged:
        rng = np.random.default_rng(0)
        lengths = rng.integers(max(prompt_len // 4, 1), prompt_len + 1, size=batch).astype(np.int32)

    def run(seed):
        out = generate(params, cfg, prompt, new_tokens, seed, temperature=1.0, prompt_lengths=lengths)
        return out.cpu()  # waits for the device

    run(0)  # the kernels' build + warm-up
    t0 = time.perf_counter()
    n_runs = 2 if args.quick else 4
    for s in range(1, n_runs + 1):
        run(s)
    dt = (time.perf_counter() - t0) / n_runs
    tps = batch * new_tokens / dt
    rec = {
        "metric": f"decode_tokens_per_sec_{args.preset}",
        "value": round(tps, 1),
        "unit": "tokens_per_sec",
        "vs_baseline": None,  # the reference publishes no decode numbers
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "ms_per_token_step": round(dt / new_tokens * 1e3, 3),
        "attention": ("K1 prefill, then the cached torch decode" if cfg.attention_impl == "flash"
                      else "naive prefill, then the cached torch decode"),
        "kv_cache_dtype": cfg.kv_cache_dtype,
        "device": _device_name(dev),
    }
    if lengths is not None:
        rec["metric"] += "_ragged"
        rec["prompt_lengths"] = [int(x) for x in lengths]
    if cfg.kv_cache_dtype == "int8":
        rec["metric"] += "_kvint8"
    # The JAX model's default cache layout names the series.
    rec["metric"] += "_unstacked"
    rec["decode_cache_layout"] = "unstacked"
    return rec


def _time_ms(fn, reps: int, dev) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up call: between
    CUDA events on the card, on the host clock on the CPU."""
    import torch

    fn()
    _sync(dev)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def run_kernel_bench(args: argparse.Namespace) -> dict:
    """Ragged paged-attention microbench: the plain gather version and the
    kernel (``ops/cuda_ragged.py``) as one pass, KV-split and AMLA, over
    the JAX package's (B, T, pages, window, int8) lanes at its shapes (h 4,
    g 2, Dh 32, 8-slot pages, fp32), with its inputs drawn from the same
    numpy generator. The headline value is the one-pass kernel's ms on the
    first lane. On the CPU every variant runs the plain version
    (``cpu_interpret: true``; not device numbers)."""
    import numpy as np
    import torch

    noop = {
        "--batch": args.batch, "--attention": args.attention,
        "--remat": args.remat, "--ce": args.ce,
        "--optimizer": args.optimizer, "--unroll": args.unroll,
        "--block-q": args.block_q, "--block-kv": args.block_kv,
        "--steps-per-sched": args.steps_per_sched,
        "--context": args.context, "--paged-attn": args.paged_attn,
        "--spec-draft": args.spec_draft, "--no-pipeline": args.no_pipeline,
        "--pipeline-depth": args.pipeline_depth,
        "--admit-batch": args.admit_batch,
        "--grad-dtype": args.grad_dtype, "--ragged": args.ragged,
        "--kv-dtype": args.kv_dtype,
        "--cache-layout": args.cache_layout,
        "--decode-unroll": args.decode_unroll,
        "--prefix-cache": args.prefix_cache,
        "--prefix-pool-size": args.prefix_pool_size,
        "--prefix-len": args.prefix_len,
        "--prefill-chunk-tokens": args.prefill_chunk_tokens,
        "--quantize": args.quantize,
    }
    _reject_knobs(args, noop, "the kernel microbench")

    from pretraining_llm_tpu_torch.ops.cuda_ragged import (
        ragged_gather_attention,
        ragged_paged_attention,
        ragged_route,
    )

    dev = _device(args)
    h, g, d, bs = 4, 2, 32, 8
    # (name, B, T, pages, window, int8): decode-like and chunk-like q_lens
    # in each lane; pages sets the per-row scan the KV split partitions.
    lanes = [
        ("mixed", 4, 8, 8, 0, False),
        ("long_row", 2, 4, 16, 0, False),
        ("windowed", 4, 8, 8, 24, False),
        ("int8", 4, 8, 8, 0, True),
    ]
    if args.quick:
        lanes = lanes[:1]
    reps = 2 if args.quick else 4

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev).contiguous()

    def quantize(pool):
        amax = pool.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(amax == 0, torch.ones_like(amax), amax)
        return torch.clamp(torch.round(pool / scale * 127.0), -127, 127).to(torch.int8), scale

    rng = np.random.default_rng(0)
    lane_recs = []
    for name, b, t, pages, window, int8 in lanes:
        n_blocks = pages * 3
        q = put(rng.normal(size=(b, t, h, d)), torch.float32)
        kp = put(rng.normal(size=(n_blocks, bs, g, d)), torch.float32)
        vp = put(rng.normal(size=(n_blocks, bs, g, d)), torch.float32)
        tbl = put(rng.integers(1, n_blocks, size=(b, pages)), torch.int32)
        cap = pages * bs
        seq = put(rng.integers(cap // 2, cap - t, size=(b,)), torch.int32)
        # Ragged q_lens: half the rows decode-like (1), half chunk-like.
        ql = put([1 if i % 2 == 0 else t for i in range(b)], torch.int32)
        scales = {}
        if int8:
            kp, ks = quantize(kp)
            vp, vs = quantize(vp)
            scales = {"k_scale": ks, "v_scale": vs}
        common = dict(window=window, **scales)
        splits = max(2, min(4, pages // 2))
        variants = {
            "gather": lambda: ragged_gather_attention(q, kp, vp, tbl, seq, ql, **common),
            "ragged": lambda: ragged_paged_attention(q, kp, vp, tbl, seq, ql, kv_splits=1, **common),
            "ragged_split": lambda: ragged_paged_attention(q, kp, vp, tbl, seq, ql, kv_splits=splits, **common),
            "ragged_amla": lambda: ragged_paged_attention(q, kp, vp, tbl, seq, ql, kv_splits=1, amla=True,
                                                          **common),
        }
        kernel_route = ragged_route(q.dtype, kp.dtype, d, bs, h // g) if dev.type == "cuda" else "plain"
        times = {k: round(_time_ms(fn, reps, dev), 3) for k, fn in variants.items()}
        lane_recs.append({
            "lane": name, "B": b, "T": t, "pages": pages,
            "window": window, "int8": int8, "kv_splits": splits,
            "ms": times,
            "ragged_route": {k: "plain" if k == "gather" else kernel_route for k in variants},
        })
        _stamp(f"kernel lane {name}: {times}")
    ref = lane_recs[0]
    return {
        "metric": "kernel_ragged_microbench_ms",
        "value": ref["ms"]["ragged"],
        "unit": "ms",
        "vs_baseline": None,
        # CPU numbers are the plain versions' host times, not the kernel's.
        "cpu_interpret": dev.type == "cpu",
        "device": _device_name(dev),
        "variants": dict(ref["ms"]),
        "ragged_route": dict(ref["ragged_route"]),
        "lanes": lane_recs,
        "shape": {"heads": h, "kv_heads": g, "head_dim": d,
                  "block_size": bs},
    }


_QUANT_SUFFIX = {"int8": "_q8", "int8-kv": "_q8kv"}


def _quantization_block(eng, raw_params) -> dict:
    """Model bytes and KV bytes per token for serving records; ``raw_params``
    is the tree before quantization, so the unquantized footprint rides the
    same record."""
    from pretraining_llm_tpu_torch.models import quantize as quantize_mod

    info = eng.pool_info()
    bsz = info["block_size"]
    return {
        "quantize": info["quantize"],
        "kv_dtype": info["kv_dtype"],
        "kv_scale_dtype": info["kv_scale_dtype"],
        "model_bytes": quantize_mod.param_bytes(eng.params),
        "model_bytes_unquantized": quantize_mod.param_bytes(raw_params),
        "kv_pool_bytes": info["pool_bytes"],
        "kv_bytes_per_block": info["bytes_per_block"],
        "kv_bytes_per_token": round(info["bytes_per_block"] / bsz, 1),
    }


SERVING_MODES = ("serving", "serving-slo", "serving-fleet")


def _paged_route(args: argparse.Namespace) -> str:
    """The serving modes' paged attention: the hand-written kernels (K2 for
    decode rows, K3 for chunks, adopted prefixes and int8 pools; on the CPU
    their wrappers run the plain versions) unless ``--paged-attn gather``
    asks for the plain PyTorch gather. The preset's own default, ``gather``,
    is the JAX package's and is not taken."""
    return args.paged_attn or "kernel"


def _route_suffix(args: argparse.Namespace) -> str:
    """The plain gather is another program: its records file apart."""
    return "_gather" if _paged_route(args) == "gather" else ""


def _serving_model(args: argparse.Namespace, cfg):
    """The model overrides the serving modes share."""
    if args.kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_dtype)
    return dataclasses.replace(cfg, paged_attention_impl=_paged_route(args))


def run_serving_bench(args: argparse.Namespace) -> dict:
    """Continuous-batching throughput: mixed-length requests through the
    paged ``ServingEngine`` (admission, prefill, multi-step decode windows,
    reaping)."""
    import numpy as np

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.generate import decode_bench_workload
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine

    noop = {
        "--attention": args.attention, "--remat": args.remat, "--ce": args.ce,
        "--optimizer": args.optimizer, "--unroll": args.unroll,
        "--block-q": args.block_q, "--block-kv": args.block_kv,
        "--ragged": args.ragged, "--decode-unroll": args.decode_unroll,
        "--context": args.context, "--grad-dtype": args.grad_dtype,
        # Hot-prefix traffic lives in the SLO loadgen; this mode's fixed
        # request set would ignore it.
        "--prefix-pool-size": args.prefix_pool_size,
        "--prefix-len": args.prefix_len,
    }
    _reject_knobs(args, noop, "the serving path")

    cfg = _serving_model(args, get_preset(args.preset).model)
    max_batch = args.batch or 8
    if args.quick:
        max_batch = min(max_batch, 4)
    dev = _device(args)
    # The decode bench's model and params; its prompt_len bounds the
    # request lengths (its dense prompt is unused).
    cfg, params, canon_prompt, new_tokens = decode_bench_workload(cfg, max_batch, quick=args.quick, device=dev)
    prompt_len = int(canon_prompt.shape[1])
    block_size = min(64, cfg.context_length)
    n_requests = 3 * max_batch
    rng = np.random.default_rng(0)
    lengths = rng.integers(max(1, prompt_len // 4), prompt_len + 1, size=n_requests)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lengths]
    pages_per_req = -(-(prompt_len + new_tokens) // block_size)
    n_blocks = max_batch * pages_per_req + max_batch + 1

    sps = args.steps_per_sched or 8
    depth = args.pipeline_depth or 2

    spec = {}
    if args.spec_draft == "self":
        spec = dict(draft_params=params, draft_cfg=cfg, spec_k=args.spec_k)

    def serve():
        eng = ServingEngine(
            params, cfg, max_batch=max_batch, n_blocks=n_blocks,
            block_size=block_size,
            # Speculation is greedy here (the self-draft's acceptance upper
            # bound); plain serving keeps the temperature-1.0 series.
            temperature=0.0 if spec else 1.0,
            steps_per_sched=sps, pipeline_depth=depth,
            admit_batch=args.admit_batch,
            prefix_cache=args.prefix_cache,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            quantize=args.quantize or "none", device=dev, **spec,
        )
        rids = [eng.submit(p, new_tokens) for p in prompts]
        out = eng.run(pipeline=not args.no_pipeline)
        return sum(len(out[r]) for r in rids), eng.stats, eng

    serve()  # the kernels' build + warm-up
    t0 = time.perf_counter()
    n_tok, stats, eng = serve()
    dt = time.perf_counter() - t0
    # The share of the wall the host spent blocked on a window's readback.
    reaped = stats.get("windows_reaped", 0)
    blocked_s = stats.get("host_blocked_s", 0.0)
    rec = {
        "metric": f"serving_tokens_per_sec_{args.preset}",
        "value": round(n_tok / dt, 1),
        "unit": "generated_tokens_per_sec",
        "vs_baseline": None,  # the reference has no serving stack
        "max_batch": max_batch,
        "n_requests": n_requests,
        "new_tokens_per_request": new_tokens,
        "steps_per_sched": sps,
        "pipeline": not args.no_pipeline,
        "pipeline_depth": depth if not args.no_pipeline else 0,
        "admit_batch": args.admit_batch,
        "host_blocked_frac": round(blocked_s / dt, 4) if dt > 0 else None,
        "host_blocked_ms_per_window": (
            round(1e3 * blocked_s / reaped, 3) if reaped else None
        ),
        "paged_attention_impl": cfg.paged_attention_impl,
        "block_size": block_size,
        "n_blocks": n_blocks,
        "kv_cache_dtype": cfg.kv_cache_dtype,
        "engine_stats": stats,
        "quantization": _quantization_block(eng, params),
        "wall_s": round(dt, 2),
        "device": _device_name(dev),
    }
    if args.quantize in _QUANT_SUFFIX:
        rec["metric"] += _QUANT_SUFFIX[args.quantize]
    if spec:
        rec["metric"] += "_spec"
        rec["spec_k"] = args.spec_k
    if args.prefix_cache:
        rec["metric"] += "_pfx"
        rec["prefix_cache"] = True
    if args.prefill_chunk_tokens:
        rec["metric"] += "_chunked"
        rec["prefill_chunk_tokens"] = args.prefill_chunk_tokens
    if cfg.kv_cache_dtype == "int8":
        rec["metric"] += "_kvint8"
    rec["metric"] += "_unstacked" + _route_suffix(args)
    rec["decode_cache_layout"] = "unstacked"
    return rec


def run_serving_slo_bench(args: argparse.Namespace) -> dict:
    """Online latency under load: seeded Poisson arrivals through the
    frontend ``EngineLoop`` (the loop the HTTP gateway drives): p50/p99
    TTFT, TPOT and e2e, and goodput under the SLO."""
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.frontend.admission import AdmissionController
    from pretraining_llm_tpu_torch.frontend.engine_loop import EngineLoop
    from pretraining_llm_tpu_torch.frontend.loadgen import LoadSpec, run_engine_loop
    from pretraining_llm_tpu_torch.generation.generate import decode_bench_workload
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine

    noop = {
        "--attention": args.attention, "--remat": args.remat, "--ce": args.ce,
        "--optimizer": args.optimizer, "--unroll": args.unroll,
        "--block-q": args.block_q, "--block-kv": args.block_kv,
        "--ragged": args.ragged, "--decode-unroll": args.decode_unroll,
        "--grad-dtype": args.grad_dtype,
        "--spec-draft": args.spec_draft, "--no-pipeline": args.no_pipeline,
    }
    _reject_knobs(args, noop, "the serving-slo path")

    cfg = get_preset(args.preset).model
    if args.context:
        # Long prompts: the context (and the prompt-length ceiling) grows;
        # the random position table is drawn at the new length.
        cfg = dataclasses.replace(cfg, context_length=args.context)
    cfg = _serving_model(args, cfg)
    max_batch = args.batch or 8
    if args.quick:
        max_batch = min(max_batch, 4)
    dev = _device(args)
    cfg, params, canon_prompt, new_tokens = decode_bench_workload(cfg, max_batch, quick=args.quick, device=dev)
    prompt_len = int(canon_prompt.shape[1])
    block_size = min(64, cfg.context_length)
    n_requests = args.n_requests or 3 * max_batch
    # Hot-prefix scenario: each request starts with a shared prefix drawn
    # zipf-skewed from a fixed pool.
    pfx_pool = args.prefix_pool_size
    pfx_len = 0
    if pfx_pool:
        # Prefixes pay off only over whole blocks: smaller pages so that a
        # prefix, a private prompt and the generation span several.
        block_size = min(block_size, max(8, cfg.context_length // 8))
        pfx_len = args.prefix_len or 2 * block_size
        room = cfg.context_length - new_tokens - pfx_len
        if room < 1:
            raise ValueError(
                f"--prefix-len {pfx_len} leaves no room for prompts "
                f"(context {cfg.context_length}, new_tokens {new_tokens})"
            )
        prompt_len = min(prompt_len, room)
    if args.prefill_chunk_tokens:
        # The chunked-vs-monolithic comparison wants long prompts among the
        # short ones: the mix's ceiling goes to the full context.
        prompt_len = max(prompt_len, cfg.context_length - new_tokens - pfx_len)
    pages_per_req = -(-(pfx_len + prompt_len + new_tokens) // block_size)
    n_blocks = max_batch * pages_per_req + max_batch + 1

    sps = args.steps_per_sched or 8
    depth = args.pipeline_depth or 2

    spec = LoadSpec(
        n_requests=n_requests, mode="open", rate_rps=args.rate_rps,
        vocab_size=cfg.vocab_size,
        prompt_len_min=max(1, prompt_len // 4), prompt_len_max=prompt_len,
        max_new_min=new_tokens, max_new_max=new_tokens,
        slo_ttft_s=args.slo_ttft_s, slo_e2e_s=args.slo_e2e_s, seed=0,
        prefix_pool_size=pfx_pool, prefix_len=pfx_len,
        prefix_zipf=args.prefix_zipf,
    )

    def run_once(chunk_tokens: int):
        eng = ServingEngine(
            params, cfg, max_batch=max_batch, n_blocks=n_blocks,
            block_size=block_size, temperature=0.0,
            steps_per_sched=sps, pipeline_depth=depth,
            admit_batch=args.admit_batch,
            prefix_cache=args.prefix_cache,
            prefill_chunk_tokens=chunk_tokens,
            quantize=args.quantize or "none", device=dev,
        )
        admission = AdmissionController(max_queue_depth=4 * max_batch)
        loop = EngineLoop(eng, admission=admission)
        with loop:
            # Warm-up outside the measured window.
            loop.submit([1] * prompt_len, new_tokens).result()
            report = run_engine_loop(loop, spec)
        return eng, admission, loop, report

    baseline = None
    if args.prefill_chunk_tokens:
        # The monolithic-prefill baseline over the same seeded arrivals.
        _, _, _, base_report = run_once(0)
        baseline = base_report.summary()
    eng, admission, loop, report = run_once(args.prefill_chunk_tokens)
    s = report.summary()
    rec = {
        "metric": f"serving_slo_goodput_{args.preset}",
        "value": round(s["goodput_rps"], 3),
        "unit": "slo_ok_requests_per_sec",
        "vs_baseline": None,  # the reference has no serving stack
        "slo_attainment": round(s["slo_attainment"], 4),
        "counts": s["counts"],
        "n_requests": n_requests,
        "rate_rps": args.rate_rps,
        "slo_ttft_s": args.slo_ttft_s,
        "slo_e2e_s": args.slo_e2e_s,
        "ttft_p50_s": round(s["ttft"]["p50"], 4),
        "ttft_p99_s": round(s["ttft"]["p99"], 4),
        "tpot_p50_s": round(s["tpot"]["p50"], 5),
        "e2e_p50_s": round(s["e2e"]["p50"], 4),
        "e2e_p99_s": round(s["e2e"]["p99"], 4),
        "throughput_tok_s": round(s["throughput_tok_s"], 1),
        "max_batch": max_batch,
        "new_tokens_per_request": new_tokens,
        "steps_per_sched": sps,
        "pipeline_depth": depth,
        "block_size": block_size,
        "n_blocks": n_blocks,
        "wall_s": round(report.wall_s, 2),
        "quantization": _quantization_block(eng, params),
        "device": _device_name(dev),
    }
    if args.quantize in _QUANT_SUFFIX:
        rec["metric"] += _QUANT_SUFFIX[args.quantize]
    if args.context:
        rec["metric"] += f"_ctx{args.context}"
    if pfx_pool:
        rec["metric"] += "_hotprefix"
        rec["prefix_pool_size"] = pfx_pool
        rec["prefix_len"] = pfx_len
        rec["prefix_zipf"] = args.prefix_zipf
    if args.prefix_cache:
        rec["metric"] += "_pfx"
        hit_tok = eng.stats.get("prefix_cache_hit_tokens", 0)
        prefill_tok = eng.stats.get("prefill_tokens", 0)
        rec["prefix_cache"] = {
            "hits": eng.stats.get("prefix_cache_hits", 0),
            "misses": eng.stats.get("prefix_cache_misses", 0),
            "hit_tokens": hit_tok,
            "prefill_tokens": prefill_tok,
            "evicted_blocks": eng.stats.get("prefix_cache_evicted_blocks", 0),
            # The share of prompt tokens served from the cache.
            "prefill_reduction": (
                round(hit_tok / (hit_tok + prefill_tok), 4)
                if hit_tok + prefill_tok else 0.0
            ),
            "cached_tokens_total": s["cached_tokens_total"],
        }
    if args.prefill_chunk_tokens:
        rec["metric"] += "_chunked"
        rec["prefill_chunk_tokens"] = args.prefill_chunk_tokens
        base_ttft = baseline["ttft"]["p99"]
        base_tpot = baseline["tpot"]["p50"]
        rec["chunked_prefill"] = {
            "prefill_chunks": eng.stats.get("prefill_chunks", 0),
            "prefill_chunk_tokens": eng.stats.get("prefill_chunk_tokens", 0),
            "chunk_windows_interleaved": eng.stats.get("chunk_windows_interleaved", 0),
            "chunk_windows_dedicated": eng.stats.get("chunk_windows_dedicated", 0),
            "chunk_deferrals": eng.stats.get("chunk_deferrals", 0),
            "ttft_p99_monolithic_s": round(base_ttft, 4),
            "ttft_p99_chunked_s": round(s["ttft"]["p99"], 4),
            "ttft_p99_reduction": (
                round(1.0 - s["ttft"]["p99"] / base_ttft, 4)
                if base_ttft > 0 else None
            ),
            "tpot_p50_monolithic_s": round(base_tpot, 5),
            "tpot_p50_chunked_s": round(s["tpot"]["p50"], 5),
            "tpot_p50_regression": (
                round(s["tpot"]["p50"] / base_tpot - 1.0, 4)
                if base_tpot > 0 else None
            ),
        }
    # Recompute on resume, and what the frontend shed on deadlines.
    rec["preemption"] = {
        "preemptions": eng.stats.get("preemptions", 0),
        "preempted_tokens_recomputed": eng.stats.get("preempted_tokens_recomputed", 0),
        "deadline_shed": {
            "admission": admission.stats.get("rejected_infeasible", 0),
            "inflight": loop.counters.get("expired", 0),
        },
    }
    rec["metric"] += _route_suffix(args)
    rec["paged_attention_impl"] = cfg.paged_attention_impl
    return rec


def run_serving_fleet_bench(args: argparse.Namespace) -> dict:
    """Online latency under load through the N-replica ``Router`` while a
    scenario disturbance runs (``--fleet-scenario``): goodput, redrives,
    ejects, per-replica spread, and each scenario's own counters and
    invariants (lost and duplicated requests, leases, fences, KV
    migrations, tier isolation)."""
    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.frontend.admission import AdmissionController
    from pretraining_llm_tpu_torch.frontend.loadgen import (
        FleetAction, LoadSpec, rolling_restart_plan, run_engine_loop,
        run_fleet_plan,
    )
    from pretraining_llm_tpu_torch.frontend.replica import Replica
    from pretraining_llm_tpu_torch.frontend.router import Router
    from pretraining_llm_tpu_torch.generation.generate import decode_bench_workload
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.resilience.faults import ServingFaultInjector

    noop = {
        "--attention": args.attention, "--remat": args.remat, "--ce": args.ce,
        "--optimizer": args.optimizer, "--unroll": args.unroll,
        "--block-q": args.block_q, "--block-kv": args.block_kv,
        "--ragged": args.ragged, "--decode-unroll": args.decode_unroll,
        "--context": args.context, "--grad-dtype": args.grad_dtype,
        "--spec-draft": args.spec_draft, "--no-pipeline": args.no_pipeline,
        # Per-replica engine knobs the fleet launcher does not take.
        "--prefill-chunk-tokens": args.prefill_chunk_tokens,
        "--quantize": args.quantize,
    }
    _reject_knobs(args, noop, "the serving-fleet path")
    if args.replicas < 2:
        raise ValueError("serving-fleet mode needs --replicas >= 2")

    cfg = _serving_model(args, get_preset(args.preset).model)
    max_batch = args.batch or 4  # per replica
    if args.quick:
        max_batch = min(max_batch, 4)
    dev = _device(args)
    cfg, params, canon_prompt, new_tokens = decode_bench_workload(cfg, max_batch, quick=args.quick, device=dev)
    prompt_len = int(canon_prompt.shape[1])
    block_size = min(64, cfg.context_length)
    n_requests = args.n_requests or 4 * max_batch * args.replicas
    pfx_pool = args.prefix_pool_size
    pfx_len = 0
    if args.fleet_scenario in ("hotprefix", "disagg", "decode-sat"):
        pfx_pool = pfx_pool or 2 * args.replicas
        block_size = min(block_size, max(8, cfg.context_length // 8))
        pfx_len = args.prefix_len or 2 * block_size
        room = cfg.context_length - new_tokens - pfx_len
        if room < 1:
            raise ValueError(
                f"--prefix-len {pfx_len} leaves no room for prompts "
                f"(context {cfg.context_length}, new_tokens {new_tokens})"
            )
        prompt_len = min(prompt_len, room)
    pages_per_req = -(-(pfx_len + prompt_len + new_tokens) // block_size)
    n_blocks = max_batch * pages_per_req + max_batch + 1
    sps = args.steps_per_sched or 8
    depth = args.pipeline_depth or 2

    # disagg needs the prefix cache (the pages it migrates) and checks the
    # migrated pages' checksums; decode-sat is disagg plus a live SLO
    # engine at 4x the offered load.
    decode_sat = args.fleet_scenario == "decode-sat"
    disagg = args.fleet_scenario == "disagg" or decode_sat

    def make_engine():
        return ServingEngine(
            params, cfg, max_batch=max_batch, n_blocks=n_blocks,
            block_size=block_size, temperature=0.0,
            steps_per_sched=sps, pipeline_depth=depth,
            admit_batch=args.admit_batch,
            prefix_cache=args.prefix_cache or disagg,
            kv_checksum=disagg, device=dev,
        )

    # decode-sat: the SLO engine's window outlasts the burst, so the tier
    # comparison covers every request.
    bus = slo = None
    if decode_sat:
        from pretraining_llm_tpu_torch.observability.events import EventBus
        from pretraining_llm_tpu_torch.observability.slo import SLOEngine, default_slo_classes

        bus = EventBus()
        slo = SLOEngine(
            classes=default_slo_classes(ttft_s=args.slo_ttft_s, e2e_s=args.slo_e2e_s),
            bus=bus, window_s=600.0,
        )

    faults = None
    kill_at = max(2, n_requests // (3 * args.replicas))
    if args.fleet_scenario == "kill":
        # Replica 0 crashes as it accepts its kill_at'th request.
        faults = ServingFaultInjector(f"replica_crash@req{kill_at}:r0")

    if args.fleet_scenario in ("proc-kill", "partition"):
        # Worker processes, each drawing the same weights from (preset,
        # init_seed 0) on the same device; worker_kill is a real SIGKILL,
        # partition blackholes worker 0's socket (found by the lease).
        from pretraining_llm_tpu_torch.frontend.remote_replica import RemoteReplica

        fault_kind = "partition" if args.fleet_scenario == "partition" else "worker_kill"
        faults = ServingFaultInjector(f"{fault_kind}@req{kill_at}:r0")
        worker_spec = {
            "preset": args.preset,
            "init_seed": 0,
            "device": args.device,
            "model_overrides": {
                "attention_impl": cfg.attention_impl,
                "sequence_parallel": cfg.sequence_parallel,
                "kv_cache_dtype": cfg.kv_cache_dtype,
                "paged_attention_impl": cfg.paged_attention_impl,
                "decode_cache_layout": cfg.decode_cache_layout,
            },
            "engine": {
                "max_batch": max_batch, "n_blocks": n_blocks,
                "block_size": block_size, "temperature": 0.0,
                "steps_per_sched": sps, "pipeline_depth": depth,
                "admit_batch": args.admit_batch,
                "prefix_cache": args.prefix_cache,
            },
            "admission": {"max_queue_depth": 4 * max_batch},
        }
        # A short lease puts the partition's detection inside the burst.
        rep_kw = {"lease_s": 1.0} if args.fleet_scenario == "partition" else {}
        replicas = [
            RemoteReplica(i, worker_spec, fault_injector=faults, **rep_kw)
            for i in range(args.replicas)
        ]
    else:
        replicas = [
            Replica(
                i, make_engine, fault_injector=faults, bus=bus,
                # disagg: replica 0 is the prefill tier, the rest decode.
                role=(("prefill" if i == 0 else "decode") if disagg else "both"),
                admission_factory=lambda reg: AdmissionController(
                    max_queue_depth=4 * max_batch, registry=reg
                ),
            )
            for i in range(args.replicas)
        ]
    router = Router(
        replicas,
        admission=AdmissionController(max_queue_depth=4 * max_batch * args.replicas),
        bus=bus, slo=slo,
        # partition: the backoff outlasts the heal, so the healed gate's
        # backlog reaches the fence filter; elsewhere relaunch fast.
        eject_backoff_s=3.0 if args.fleet_scenario == "partition" else 0.2,
        # upgrade: probes vet the new weights (interval beyond the burst).
        probe_interval_s=60.0 if args.fleet_scenario == "upgrade" else 0.0,
    )
    spec = LoadSpec(
        n_requests=n_requests, mode="open",
        # decode-sat: the offered load outruns the decode tier.
        rate_rps=args.rate_rps * (4.0 if decode_sat else 1.0),
        vocab_size=cfg.vocab_size,
        prompt_len_min=max(1, prompt_len // 4), prompt_len_max=prompt_len,
        max_new_min=new_tokens, max_new_max=new_tokens,
        slo_ttft_s=args.slo_ttft_s, slo_e2e_s=args.slo_e2e_s, seed=0,
        prefix_pool_size=pfx_pool, prefix_len=pfx_len,
        prefix_zipf=args.prefix_zipf,
    )
    router.start()
    try:
        # Warm each replica outside the measured window.
        warm = [rep.submit([1] * prompt_len, new_tokens) for rep in replicas]
        for w in warm:
            w.result()
        plan_th = None
        if args.fleet_scenario == "rolling":
            est_wall = n_requests / args.rate_rps
            plan_th = run_fleet_plan(
                router,
                rolling_restart_plan(
                    args.replicas,
                    start_s=0.25 * est_wall,
                    step_s=max(0.5, 0.5 * est_wall / args.replicas),
                ),
            )
        elif args.fleet_scenario == "upgrade":
            # A vetted upgrade of every replica, staggered over the burst.
            est_wall = n_requests / args.rate_rps
            plan_th = run_fleet_plan(
                router,
                [
                    FleetAction(
                        at_s=0.25 * est_wall + i * max(0.5, 0.4 * est_wall / args.replicas),
                        kind="upgrade", replica=i,
                    )
                    for i in range(args.replicas)
                ],
            )
        elif args.fleet_scenario == "partition":
            # Heal replica 0 after the lease expired and the router redrove
            # and ejected it: its flushed frames carry the old generation.
            kill_est = kill_at * args.replicas / args.rate_rps
            plan_th = run_fleet_plan(router, [FleetAction(at_s=kill_est + 2.5, kind="heal", replica=0)])
        report = run_engine_loop(router, spec)
        if plan_th is not None:
            plan_th.join(timeout=60.0)
        per_replica = {rep.index: rep.submits for rep in replicas}
        counters = dict(router.counters)
        lease_expiries = sum(
            int(rep._c_lease.value) for rep in replicas if getattr(rep, "_c_lease", None) is not None
        )
        fenced_frames = sum(
            int(rep._c_fenced.value) for rep in replicas if getattr(rep, "_c_fenced", None) is not None
        )
        # The live surfaces, read while the fleet is up.
        slo_snap = slo.snapshot() if slo is not None else None
        fleet_health = router.fleet_health() if decode_sat else None
    finally:
        router.stop()
    s = report.summary()
    # Every scheduled request must end with some terminal outcome.
    lost = spec.n_requests - len(report.outcomes)
    rec = {
        "metric": f"serving_fleet_{args.fleet_scenario}_{args.preset}",
        "value": round(s["goodput_rps"], 3),
        "unit": "slo_ok_requests_per_sec",
        "vs_baseline": None,  # the reference has no serving stack
        "scenario": args.fleet_scenario,
        "replicas": args.replicas,
        "slo_attainment": round(s["slo_attainment"], 4),
        "counts": s["counts"],
        "n_requests": n_requests,
        "rate_rps": args.rate_rps,
        "redrives_total": s["redrives_total"],
        "router": {
            "redrives": counters.get("redrives", 0),
            "ejects": counters.get("ejects", 0),
            "brownout_shed": counters.get("brownout_shed", 0),
            "errors": counters.get("errors", 0),
            "relaunches": counters.get("relaunches", 0),
            "upgrades": counters.get("upgrades", 0),
            "upgrades_refused": counters.get("upgrades_refused", 0),
        },
        "replica_mode": "process" if args.fleet_scenario in ("proc-kill", "partition") else "inproc",
        "per_replica_submits": per_replica,
        "lost_requests": lost,
        "ttft_p50_s": round(s["ttft"]["p50"], 4),
        "ttft_p99_s": round(s["ttft"]["p99"], 4),
        "e2e_p50_s": round(s["e2e"]["p50"], 4),
        "e2e_p99_s": round(s["e2e"]["p99"], 4),
        "throughput_tok_s": round(s["throughput_tok_s"], 1),
        "max_batch_per_replica": max_batch,
        "new_tokens_per_request": new_tokens,
        "steps_per_sched": sps,
        "pipeline_depth": depth,
        "block_size": block_size,
        "n_blocks": n_blocks,
        "wall_s": round(report.wall_s, 2),
        "device": _device_name(dev),
    }
    if args.fleet_scenario in ("hotprefix", "disagg", "decode-sat"):
        rec["prefix_pool_size"] = pfx_pool
        rec["prefix_len"] = pfx_len
        rec["prefix_zipf"] = args.prefix_zipf
    if disagg:
        # Every client request ends on a decode replica: the percentiles
        # above are the decode tier's.
        rec["prefill_replicas"] = 1
        rec["kv_migrations"] = counters.get("kv_migrations", 0)
        rec["kv_pages_migrated"] = counters.get("kv_pages_migrated", 0)
        rec["kv_migration_rejects"] = counters.get("kv_migration_rejects", 0)
    if args.fleet_scenario == "partition":
        # Nothing lost, nothing duplicated: no done request overran its
        # token budget (the fence dropped the stale attempt's frames).
        rec["lease_expiries"] = lease_expiries
        rec["fenced_frames"] = fenced_frames
        rec["duplicate_overruns"] = sum(
            1 for o in report.outcomes
            if o.status == "done" and o.n_tokens > new_tokens
        )
    if decode_sat and slo_snap is not None:
        # The prefill replica's terminals are the migration legs: its e2e
        # is the prefill tier's service time. Isolation holds when that
        # stays inside the TTFT objective while the decode tier queues.
        lat = slo_snap["latency"]["replicas"]
        prefill_lat = lat.get("0", {})
        decode_qw_p99 = max(
            (r.get("queue_wait_s", {}).get("p99", 0.0) for i, r in lat.items() if i != "0"),
            default=0.0,
        )
        prefill_e2e_p99 = prefill_lat.get("e2e_s", {}).get("p99")
        rec["rate_rps_offered"] = spec.rate_rps
        rec["slo_fleet_ttft"] = slo_snap["latency"]["fleet"]["ttft_s"]
        rec["prefill_tier_e2e"] = prefill_lat.get("e2e_s", {})
        rec["prefill_tier_queue"] = prefill_lat.get("queue_wait_s", {})
        rec["decode_tier_queue_p99_s"] = round(decode_qw_p99, 4)
        rec["slo_alerts_fired"] = slo_snap["alerts"]["fired_total"]
        rec["slo_alerts_active"] = len(slo_snap["alerts"]["active"])
        rec["prefill_isolated"] = bool(
            prefill_e2e_p99 is not None and prefill_e2e_p99 <= args.slo_ttft_s
        )
        if fleet_health is not None:
            rec["fleet_gauges"] = fleet_health["fleet"].get("gauges", {})
    rec["metric"] += _route_suffix(args)
    rec["paged_attention_impl"] = cfg.paged_attention_impl
    return rec


def run_trainer_bench(args: argparse.Namespace) -> dict:
    """Tokens/sec of the whole ``Trainer`` loop on synthetic data: step
    dispatch, host sampling and the host-to-device copy, what the train CLI
    sustains. --prefetch 0 against 2 is the input pipeline's overlap."""
    noop = {"--ragged": args.ragged, "--kv-dtype": args.kv_dtype,
            "--decode-unroll": args.decode_unroll,
            "--steps-per-sched": args.steps_per_sched,
            "--cache-layout": args.cache_layout,
            "--context": args.context, "--paged-attn": args.paged_attn,
            "--spec-draft": args.spec_draft, "--no-pipeline": args.no_pipeline,
            "--pipeline-depth": args.pipeline_depth,
            "--admit-batch": args.admit_batch,
            "--prefix-cache": args.prefix_cache,
            "--prefix-pool-size": args.prefix_pool_size,
            "--prefix-len": args.prefix_len,
            "--prefill-chunk-tokens": args.prefill_chunk_tokens,
            "--quantize": args.quantize}
    _reject_knobs(args, noop, "the trainer path")

    import shutil
    import tempfile

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.training.trainer import Trainer

    cfg = get_preset(args.preset)
    model = cfg.model
    if model.attention_impl == "ring":
        model = dataclasses.replace(model, attention_impl="flash", sequence_parallel=False)
    if args.remat:
        model = dataclasses.replace(model, remat=args.remat)
    elif model.remat == "none":
        model = dataclasses.replace(model, remat="save_attn")
    if args.ce:
        model = dataclasses.replace(model, ce_impl=args.ce)
    if args.block_q or args.block_kv:
        model = dataclasses.replace(model, flash_block_q=args.block_q, flash_block_kv=args.block_kv)
    batch = args.batch or (16 if args.preset == "gpt2-124m" else cfg.train.batch_size)
    steps = 8 if args.quick else max(args.steps, 10)
    if args.quick:
        batch = min(batch, 4)
    data = cfg.data
    if args.prefetch >= 0:
        data = dataclasses.replace(data, prefetch=args.prefetch)
    dev = _device(args)
    ckpt_dir = tempfile.mkdtemp(prefix="bench_trainer_")
    cfg = cfg.replace(
        model=model,
        data=data,
        train=dataclasses.replace(
            cfg.train,
            optimizer=args.optimizer or cfg.train.optimizer,
            grad_dtype=args.grad_dtype or cfg.train.grad_dtype,
            batch_size=batch,
            train_steps=steps,
            checkpoint_interval=0,
            # No end-of-run checkpoint: its write would land inside the
            # timed region.
            save_final=False,
            checkpoint_dir=ckpt_dir,
            eval_interval=0,
            log_interval=max(steps // 2, 1),
            metrics_path="",
        ),
    )
    _stamp(f"trainer bench: prefetch={cfg.data.prefetch}, batch={batch}, steps={steps}")

    class _Quiet:
        def log(self, rec):
            pass

    try:
        t = Trainer(cfg, synthetic_data=True, resume=False, logger=_Quiet(), device=dev)
        _stamp("trainer built; warm steps")
        warm = max(2, steps // 4)
        t.train(steps=warm)  # the kernels' build + warm-up
        _stamp("warm done; timing the loop")
        t0 = time.perf_counter()
        # train(steps=N) runs until the state's step is N: `steps` more.
        last = t.train(steps=warm + steps)
        _sync(dev)
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    tok_per_sec = batch * model.context_length * steps / dt
    mfu = _mfu(tok_per_sec, model, dev)
    return {
        "metric": f"trainer_tokens_per_sec_{cfg.name}",
        "value": round(tok_per_sec, 1),
        "unit": "tokens_per_sec_chip",
        "vs_baseline": _round(None if mfu is None else mfu / 0.50, 4),  # the MFU record's ratio
        "mfu": _round(mfu, 4),
        "prefetch": cfg.data.prefetch,
        "batch": batch,
        "steps": steps,
        "loss_finite": bool(math.isfinite(last["loss"])) if last and "loss" in last else True,
        "device": _device_name(dev),
        "n_devices": 1,
    }


def run_bench(args: argparse.Namespace) -> dict:
    """One in-process bench attempt of ``args.mode``. May raise; the
    wrapper owns retries and timeouts."""
    if args.mode == "decode":
        return run_decode_bench(args)
    if args.mode == "trainer":
        return run_trainer_bench(args)
    if args.mode == "serving":
        return run_serving_bench(args)
    if args.mode == "serving-slo":
        return run_serving_slo_bench(args)
    if args.mode == "serving-fleet":
        return run_serving_fleet_bench(args)
    if args.mode == "kernel":
        return run_kernel_bench(args)

    # Decode-only knobs are rejected on the train path.
    noop = {"--ragged": args.ragged, "--kv-dtype": args.kv_dtype,
            "--decode-unroll": args.decode_unroll,
            "--steps-per-sched": args.steps_per_sched,
            "--cache-layout": args.cache_layout,
            "--paged-attn": args.paged_attn,
            "--spec-draft": args.spec_draft, "--no-pipeline": args.no_pipeline,
            "--pipeline-depth": args.pipeline_depth,
            "--admit-batch": args.admit_batch,
            "--prefix-cache": args.prefix_cache,
            "--prefix-pool-size": args.prefix_pool_size,
            "--prefix-len": args.prefix_len,
            "--prefill-chunk-tokens": args.prefill_chunk_tokens,
            "--quantize": args.quantize}
    _reject_knobs(args, noop, "the train path")

    _stamp("importing torch")
    import numpy as np
    import torch

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.data import loader
    from pretraining_llm_tpu_torch.training import train_step as ts

    cfg = get_preset(args.preset)
    model = cfg.model
    if args.context:
        if model.pos_embed != "rope":
            raise ValueError(
                "--context requires a RoPE preset (learned position tables "
                "are sized by the original context_length)"
            )
        if args.context == model.context_length:
            args.context = 0  # the preset's own: same series, no _ctx suffix
        else:
            model = dataclasses.replace(model, context_length=args.context)
    if args.attention:
        model = dataclasses.replace(model, attention_impl=args.attention)
    elif model.attention_impl == "ring":
        model = dataclasses.replace(model, attention_impl="flash", sequence_parallel=False)
    if args.block_q or args.block_kv:
        model = dataclasses.replace(model, flash_block_q=args.block_q, flash_block_kv=args.block_kv)
    if args.ce:
        model = dataclasses.replace(model, ce_impl=args.ce)
    if args.remat:
        model = dataclasses.replace(model, remat=args.remat)
    elif model.remat == "none":
        # The JAX package's default for the bench (not measured on the card).
        model = dataclasses.replace(model, remat="save_attn")
    if args.optimizer:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, optimizer=args.optimizer))
    if args.grad_dtype:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, grad_dtype=args.grad_dtype))
    batch = args.batch or cfg.train.batch_size
    if args.batch == 0 and args.preset == "gpt2-124m":
        batch = 16  # the JAX package's default for gpt2-124m (not measured on the card)
    if args.quick:
        args.steps, args.warmup, batch = 5, 2, min(batch, 4)
    cfg = cfg.replace(model=model, train=dataclasses.replace(cfg.train, batch_size=batch))

    dev = _device(args)
    _stamp(f"device up: {_device_name(dev)}")
    state = ts.init_train_state(cfg, 0, device=dev)
    step = ts.build_train_step(cfg)
    _stamp(f"state built (remat={model.remat}, attn={model.attention_impl}, "
           f"ce={model.ce_impl}, batch={batch})")

    x, y = next(loader.synthetic_iterator(model.vocab_size, model.context_length, batch, seed=0))
    batch_dev = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (x, y))

    def run(n: int) -> float:
        """n steps on the one batch; the loss's read waits for the device."""
        nonlocal state
        for _ in range(n):
            state, metrics = step(state, batch_dev)
        return float(metrics["loss"])

    # Two run lengths: the slope between them cancels fixed overheads.
    n2 = max(args.steps, 2)
    n1 = max(n2 // 4, 1)
    _stamp(f"warm-up start (run lengths {n1}, {n2})")
    run(n1)  # the kernels' build
    run(n2)
    for _ in range(max(args.warmup - 1, 0)):
        run(n1)
    _stamp("warm-up done; timing")

    t0 = time.perf_counter()
    run(n1)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_v = run(n2)
    t2 = time.perf_counter() - t0

    dt_per_step = (t2 - t1) / (n2 - n1)
    if dt_per_step <= 0:  # noisy short run: the long run alone
        dt_per_step = t2 / n2
    tok_per_sec = batch * model.context_length / dt_per_step
    mfu = _mfu(tok_per_sec, model, dev)
    return {
        "metric": f"mfu_{cfg.name}_train"
        + (f"_ctx{model.context_length}" if args.context else ""),
        "value": _round(mfu, 4),
        "unit": "fraction_of_peak_bf16",
        "vs_baseline": _round(None if mfu is None else mfu / 0.50, 4),
        "tokens_per_sec_chip": round(tok_per_sec, 1),
        "step_ms": round(dt_per_step * 1e3, 2),
        "batch": batch,
        "context_length": model.context_length,
        "params_m": round(model.num_params() / 1e6, 1),
        "attention": model.attention_impl,
        "remat": model.remat,
        "ce_impl": model.ce_impl,
        "grad_dtype": cfg.train.grad_dtype,
        "device": _device_name(dev),
        "n_devices": 1,
        "loss_finite": math.isfinite(loss_v),
    }


def error_result(args: argparse.Namespace, msg: str, attempts: int) -> dict:
    # The metric names the success path's series of the same invocation
    # (decode's layout suffix, the trainer_ prefix, _ctxN), so a failure
    # files under the series it would have measured.
    if args.mode == "decode":
        metric, unit = f"decode_tokens_per_sec_{args.preset}", "tokens_per_sec"
        if args.ragged:
            metric += "_ragged"
        if args.kv_dtype == "int8":
            metric += "_kvint8"
        if args.decode_unroll:
            metric += "_unroll"
        # The model's default layout is 'unstacked': only an explicit
        # --cache-layout stacked lands in the unsuffixed series.
        if args.cache_layout != "stacked":
            metric += "_unstacked"
    elif args.mode == "trainer":
        metric, unit = f"trainer_tokens_per_sec_{args.preset}", "tokens_per_sec_chip"
    elif args.mode == "serving":
        metric = f"serving_tokens_per_sec_{args.preset}"
        if args.kv_dtype == "int8":
            metric += "_kvint8"
        if args.cache_layout != "stacked":  # effective default: unstacked
            metric += "_unstacked"
        metric += _route_suffix(args)
        unit = "generated_tokens_per_sec"
    elif args.mode == "serving-slo":
        metric = f"serving_slo_goodput_{args.preset}" + _route_suffix(args)
        unit = "slo_ok_requests_per_sec"
    elif args.mode == "serving-fleet":
        # The JAX package's error_result has no branch for this mode (its
        # failures fall through to the train series); the port names the
        # success path's series.
        metric = f"serving_fleet_{args.fleet_scenario}_{args.preset}" + _route_suffix(args)
        unit = "slo_ok_requests_per_sec"
    elif args.mode == "kernel":
        metric, unit = "kernel_ragged_microbench_ms", "ms"
    else:
        metric, unit = f"mfu_{args.preset}_train", "fraction_of_peak_bf16"
        if args.context:
            metric += f"_ctx{args.context}"
    rec = {
        "metric": metric,
        "value": 0.0,
        "unit": unit,
        # The success path's null contract: no reference baseline.
        "vs_baseline": None if args.mode in (*SERVING_MODES, "decode", "kernel") else 0.0,
        "error": msg[:800],
        "attempts": attempts,
    }
    if args.mode in SERVING_MODES:
        rec["paged_attention_impl"] = _paged_route(args)
    return rec


def _run_canary(timeout: float, device: str = "cuda"):
    """Probe the environment in a fresh process. Returns (ok, detail)."""
    cmd = [sys.executable, "-m", MODULE, "--_canary", "--device", device]
    try:
        proc = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=sys.stderr, timeout=timeout, text=True, cwd=ROOT,
        )
    except subprocess.TimeoutExpired:
        return False, f"canary hung past {timeout:.0f}s (device unreachable)"
    lines = [ln for ln in (proc.stdout or "").splitlines() if ln.strip()]
    if proc.returncode == 0 and lines:
        try:
            return True, json.loads(lines[-1])
        except json.JSONDecodeError:
            pass
    tail = lines[-1][:200] if lines else "(no output)"
    return False, f"canary failed rc={proc.returncode}: {tail}"


def _attempt(args: argparse.Namespace, remat: str, timeout: float, attention: str = "",
             batch_override: int = 0, ce_override: str = ""):
    """One inner run in a fresh process. Returns (json_dict|None, err_str).

    ``batch_override``: a race rung's own batch (0 = args.batch);
    ``ce_override``: its CE head ("" = args.ce; the race drops such rungs
    under an explicit --ce)."""
    cmd = [
        sys.executable, "-m", MODULE, "--_inner",
        "--device", args.device,
        "--preset", args.preset,
        "--batch", str(batch_override or args.batch),
        "--steps", str(args.steps),
        "--warmup", str(args.warmup),
    ]
    if args.quick:
        cmd.append("--quick")
    if args.mode != "train":
        cmd += ["--mode", args.mode]
    if args.prefetch >= 0:
        cmd += ["--prefetch", str(args.prefetch)]
    if args.ragged:
        cmd.append("--ragged")
    if args.kv_dtype:
        cmd += ["--kv-dtype", args.kv_dtype]
    if args.decode_unroll:
        cmd.append("--decode-unroll")
    if args.steps_per_sched:
        cmd += ["--steps-per-sched", str(args.steps_per_sched)]
    if args.no_pipeline:
        cmd.append("--no-pipeline")
    if args.pipeline_depth:
        cmd += ["--pipeline-depth", str(args.pipeline_depth)]
    if args.admit_batch:
        cmd += ["--admit-batch", str(args.admit_batch)]
    if args.paged_attn:
        cmd += ["--paged-attn", args.paged_attn]
    if args.spec_draft:
        cmd += ["--spec-draft", args.spec_draft, "--spec-k", str(args.spec_k)]
    if args.prefix_cache:
        cmd.append("--prefix-cache")
    if args.prefill_chunk_tokens:
        cmd += ["--prefill-chunk-tokens", str(args.prefill_chunk_tokens)]
    if args.quantize:
        cmd += ["--quantize", args.quantize]
    if args.mode in ("serving-slo", "serving-fleet"):
        cmd += [
            "--rate-rps", str(args.rate_rps),
            "--slo-ttft-s", str(args.slo_ttft_s),
            "--slo-e2e-s", str(args.slo_e2e_s),
            "--n-requests", str(args.n_requests),
        ]
        if args.prefix_pool_size:
            cmd += ["--prefix-pool-size", str(args.prefix_pool_size)]
        if args.prefix_len:
            cmd += ["--prefix-len", str(args.prefix_len)]
        cmd += ["--prefix-zipf", str(args.prefix_zipf)]
    if args.mode == "serving-fleet":
        cmd += ["--replicas", str(args.replicas), "--fleet-scenario", args.fleet_scenario]
    if args.cache_layout:
        cmd += ["--cache-layout", args.cache_layout]
    if args.context:
        cmd += ["--context", str(args.context)]
    if args.attention or attention:
        cmd += ["--attention", args.attention or attention]
    if args.ce or ce_override:
        cmd += ["--ce", ce_override or args.ce]
    if remat:
        cmd += ["--remat", remat]
    if args.optimizer:
        cmd += ["--optimizer", args.optimizer]
    if args.grad_dtype:
        cmd += ["--grad-dtype", args.grad_dtype]
    if args.unroll:
        cmd += ["--unroll", str(args.unroll)]
    if args.block_q:
        cmd += ["--block-q", str(args.block_q)]
    if args.block_kv:
        cmd += ["--block-kv", str(args.block_kv)]
    try:
        proc = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=sys.stderr, timeout=timeout, text=True, cwd=ROOT,
        )
    except subprocess.TimeoutExpired:
        return None, f"hung past {timeout:.0f}s (killed)"
    out_lines = [ln for ln in (proc.stdout or "").splitlines() if ln.strip()]
    if not out_lines:
        return None, f"rc={proc.returncode}: (no output)"
    try:
        rec = json.loads(out_lines[-1])
    except json.JSONDecodeError:
        return None, f"rc={proc.returncode}: non-JSON output: {out_lines[-1][:200]}"
    if proc.returncode == 0:
        return rec, ""
    # The inner run's structured error: handed back whole for relaying.
    return rec, f"rc={proc.returncode}: {out_lines[-1][:300]}"


def _score(rec: dict) -> float:
    """A race rung's score: its MFU, or its tokens/s where MFU is null (the
    CPU has no peak)."""
    value = rec.get("value")
    return float(value) if isinstance(value, (int, float)) else float(rec.get("tokens_per_sec_chip") or 0.0)


def wrapper_main(args: argparse.Namespace) -> int:
    """Candidate-racing retry loop: a fresh process per attempt under a hard
    timeout, a structured JSON error on final failure. A default gpt2-124m
    train run races the rung list below and reports the best success."""
    deadline = time.monotonic() + args.timeout_budget

    # The environment canary first, with one retry: a dead device must not
    # burn the budget or read as a regression of the program.
    canary_info = None
    if not args.skip_canary:
        for i in range(2):
            t_c = time.monotonic()
            ok, detail = _run_canary(args.canary_timeout, device=args.device)
            if ok:
                canary_info = detail
                canary_info["canary_s"] = round(time.monotonic() - t_c, 1)
                print(f"[bench] canary ok: {json.dumps(detail)}", file=sys.stderr)
                break
            print(f"[bench] {detail} (try {i + 1}/2)", file=sys.stderr)
        else:
            rec = error_result(args, f"environment: backend unreachable ({detail})", 0)
            rec["environment_error"] = True
            print(json.dumps(rec))
            return 1

    # The race runs on the preset its rungs were chosen for; every other
    # preset keeps its own remat.
    race = (
        not args.remat
        and not args.attention
        and args.mode == "train"
        and not args.quick
        and args.preset == "gpt2-124m"
    )
    if race:
        # (remat, attention, batch_override, ce_override, contender): the
        # JAX package's rung list and order (not measured on the card).
        # Contenders are always raced; fallbacks run only while no result
        # is banked.
        candidates = [
            ("save_attn_res", "", 0, "dense", True),
            ("save_attn", "", 0, "dense", True),
            ("save_attn", "", 0, "", True),
            ("none", "", 8, "dense", True),
            ("none", "", 8, "", True),
            ("save_big", "", 0, "", False), ("full", "", 0, "", False),
            ("full", "naive", 0, "", False),
        ]
        if args.batch:
            # An explicit --batch drops the rungs of another batch.
            candidates = [c for c in candidates if not c[2] or c[2] == args.batch]
        if args.ce:
            # An explicit --ce applies to every rung: drop the CE rungs.
            candidates = [c for c in candidates if not c[3]]
    else:
        candidates = [(args.remat, "", 0, "", True)]
    last_contender = max(i for i, c in enumerate(candidates) if c[4])
    attempts = 0
    last_err = "no attempts made (timeout budget too small?)"
    best = None
    best_cand = None
    rungs = []
    last_error_rec = None
    wedged = False
    # A busy or unreachable device is worth a retry after a backoff.
    transient_markers = ("busy or unavailable", "Socket", "socket", "connect")
    rung_keys = ("remat", "ce_impl", "batch", "value", "tokens_per_sec_chip", "step_ms")
    for ci, (remat, attention, batch_over, ce_over, _contender) in enumerate(candidates):
        # Reserve budget up front: a first candidate may spend its fair
        # share, never the fallbacks'; a contender's share is floored at
        # one full attempt where the budget allows.
        remaining = deadline - time.monotonic()
        share = remaining / (len(candidates) - ci)
        if _contender:
            share = max(share, min(args.attempt_timeout + 60, remaining / 2))
        cand_deadline = time.monotonic() + share
        backoff = 10.0
        cand_hangs = 0
        while True:
            remaining = cand_deadline - time.monotonic()
            if remaining <= 5:
                break
            attempts += 1
            rec, err = _attempt(args, remat, min(args.attempt_timeout, remaining), attention,
                                batch_over, ce_over)
            if rec is not None and not err:
                print(
                    "[bench] rung "
                    f"remat={rec.get('remat')} ce={rec.get('ce_impl')} "
                    f"batch={rec.get('batch')} -> "
                    f"mfu={rec.get('value')} tok/s={rec.get('tokens_per_sec_chip')} "
                    f"step_ms={rec.get('step_ms')}",
                    file=sys.stderr,
                )
                rungs.append({k: rec.get(k) for k in rung_keys})
                if best is None or _score(rec) > _score(best):
                    best = rec
                    best_cand = (remat, attention, batch_over, ce_over)
                break
            last_err = (
                f"attempt {attempts} (remat={remat or 'default'}"
                + (f", attention={attention}" if attention else "")
                + (f", batch={batch_over}" if batch_over else "")
                + (f", ce={ce_over}" if ce_over else "")
                + f"): {err}"
            )
            if rec is not None:
                last_error_rec = rec
            print(f"[bench] {last_err}", file=sys.stderr)
            if "hung" in err:
                cand_hangs += 1
                # A killed hang may leave the device unusable: classify it
                # with a cheap canary before spending more budget.
                ok, detail = _run_canary(min(args.canary_timeout, max(deadline - time.monotonic(), 30)),
                                         device=args.device)
                if not ok:
                    if best is not None:
                        # A result is banked: report it now, marked so that
                        # chained --skip-canary callers know.
                        print(f"[bench] post-hang canary: {detail} — device wedged; "
                              "reporting the banked result", file=sys.stderr)
                        best["backend_wedged"] = True
                        wedged = True
                        break
                    print(f"[bench] post-hang canary: {detail} — device wedged; "
                          "polling for recovery instead of burning attempts", file=sys.stderr)
                    while time.monotonic() + 60 < deadline:
                        time.sleep(45)
                        ok, detail = _run_canary(
                            min(args.canary_timeout, max(deadline - time.monotonic(), 30)), device=args.device)
                        if ok:
                            print("[bench] device recovered; resuming", file=sys.stderr)
                            break
                    if not ok:
                        wedged = True
                        last_err += " (backend wedged after the kill; never recovered in budget)"
                        break
                    if cand_hangs >= 2:
                        break  # hung twice: this program is the problem
                    continue  # recovered: one retry of this candidate
                # The device answers: one retry, a second hang abandons it.
                if cand_hangs >= 2:
                    break
                continue
            # Out of memory is deterministic: one bounded attempt per rung.
            oom = any(m in err for m in ("out of memory", "OutOfMemoryError"))
            transient = not oom and any(m in err for m in transient_markers)
            if not transient:
                break
            if time.monotonic() + backoff >= cand_deadline:
                break
            time.sleep(backoff)
            backoff = min(backoff * 2, 120.0)
        if wedged:
            break
        if best is not None and ci >= last_contender:
            break  # every contender has run: the fallbacks are slower
    if race and best is not None and not wedged:
        # A same-session median: re-run the winner's config until
        # --race-repeats samples exist or the budget is gone. `value` stays
        # the best sample; `value_median` is the median.
        race_values = [_score(best)]
        r_remat, r_attention, r_batch, r_ce = best_cand
        while len(race_values) < args.race_repeats:
            remaining = deadline - time.monotonic()
            if remaining <= 5:
                print(f"[bench] race repeats: budget exhausted at n={len(race_values)}", file=sys.stderr)
                break
            attempts += 1
            rec, err = _attempt(args, r_remat, min(args.attempt_timeout, remaining), r_attention, r_batch, r_ce)
            if rec is not None and not err:
                race_values.append(_score(rec))
                rungs.append({k: rec.get(k) for k in rung_keys})
                if _score(rec) > _score(best):
                    best = rec
                continue
            print(f"[bench] race repeat failed: {err}", file=sys.stderr)
            if "hung" in err:
                ok, detail = _run_canary(min(args.canary_timeout, max(deadline - time.monotonic(), 30)),
                                         device=args.device)
                if not ok:
                    print(f"[bench] post-hang canary: {detail} — device wedged; "
                          "reporting the collected samples", file=sys.stderr)
                    best["backend_wedged"] = True
            break  # a failed repeat ends the sampling
        best["race"] = {
            "best": max(race_values),
            "median": round(statistics.median(race_values), 5),
            "n": len(race_values),
            "spread": round(max(race_values) - min(race_values), 5),
            "values": race_values,
        }
        best["value_median"] = best["race"]["median"]
    if best is not None:
        if canary_info is not None:
            best.setdefault("canary_s", canary_info.get("canary_s"))
        if len(rungs) > 1:
            best["rungs"] = rungs
        print(json.dumps(best))
        return 0
    if last_error_rec is not None and not wedged:
        # The inner run's structured error line, relayed whole.
        print(json.dumps(last_error_rec))
        return 1
    rec = error_result(args, last_err, attempts)
    if wedged:
        rec["environment_error"] = True
    print(json.dumps(rec))
    return 1


def inner_main(args: argparse.Namespace) -> int:
    """One attempt in this process: its record, or its error record, as one
    line. No GPU for ``--device cuda`` is an environment error."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        rec = error_result(args, "environment: no CUDA device is available", 0)
        rec["environment_error"] = True
        print(json.dumps(rec))
        return 1
    try:
        print(json.dumps(run_bench(args)))
        return 0
    except Exception as exc:  # noqa: BLE001 — the wrapper parses this line
        print(json.dumps(error_result(args, f"{type(exc).__name__}: {exc}", 1)))
        return 1


def main(argv=None) -> int:
    args = parse_args(argv)
    if args._canary:
        return canary_main(args.device)
    if args._inner:
        return inner_main(args)
    try:
        return wrapper_main(args)
    except Exception as exc:  # noqa: BLE001 — one JSON line, never a traceback
        print(json.dumps(error_result(args, f"wrapper: {type(exc).__name__}: {exc}", 0)))
        return 1


if __name__ == "__main__":
    sys.exit(main())
