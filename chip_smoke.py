#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pretraining_llm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pretraining_llm_tpu_torch/csrc``,
holds each against its plain PyTorch version at the serving path's shapes,
holds a 2-layer GPT-2-width model on the card against the same model on the
CPU, serves 16 requests through full-width gpt2-124m with
``ServingEngine.submit/run`` (counting both kernels' launches on that run),
times every kernel beside its plain version, a PyTorch library call and its
bound, and prints:

    <the card's name and power limit, as nvidia-smi reports them>
    ...one line per phase...
    {"kernels": [...]}
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Any failed check raises, and the script exits non-zero without the last
line. With no CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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
BF16_ROW_RTOL = 2.0**-6
MODEL_TOL = 1e-3  # fp32 logits, 2-layer model, card vs CPU
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SEED = 0


def log(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, sort_keys=True), flush=True)


def randn(shape, dtype, gen, device="cuda"):
    return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)


def time_ms(fn, *, n=25, warmup=5, flush=None) -> float:
    """Median of ``n`` launches, each between two CUDA events, after a
    warm-up; ``flush`` (outside the events) evicts the L2 cache first."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def tol_use(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest error over its limit (the check passes at <= 1): fp32
    against FP32_TOL, bf16 per row of the last axis against BF16_ROW_RTOL
    times the row's largest |ref|."""
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        return err.max().item() / FP32_TOL
    limit = BF16_ROW_RTOL * ref.float().abs().amax(dim=-1, keepdim=True)
    return (err / limit.clamp_min(1e-30)).max().item()


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


def phase_build() -> None:
    from pretraining_llm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    log("build", seconds=round(time.perf_counter() - t0, 3),
        per_source={name: secs for name, (secs, _) in built.items()})
    for name, (_, text) in built.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)


def check_flash() -> float:
    from pretraining_llm_tpu_torch.ops import cuda_flash

    gen = torch.Generator().manual_seed(SEED)
    cases = [  # (B, H, G, T, Dh, window, dtype)
        (2, 12, 12, 512, 64, 0, torch.bfloat16), (2, 12, 12, 1024, 64, 0, torch.bfloat16),
        (2, 12, 12, 512, 64, 0, torch.float32), (2, 12, 12, 1024, 64, 0, torch.float32),
        (2, 16, 4, 512, 64, 0, torch.bfloat16),  # GQA
        (2, 12, 12, 1024, 64, 256, torch.bfloat16),  # sliding window
        (1, 4, 2, 200, 64, 0, torch.float32),  # T not a multiple of the 64-row tile
        (1, 16, 4, 300, 128, 0, torch.bfloat16), (1, 16, 4, 300, 128, 0, torch.float32),  # Dh 128
    ]
    worst = 0.0
    for b, h, g, t, d, window, dtype in cases:
        q = randn((b * h, t, d), dtype, gen)
        k = randn((b * g, t, d), dtype, gen)
        v = randn((b * g, t, d), dtype, gen)
        o, lse = cuda_flash.flash_attention_fwd(q, k, v, h, g, window=window)
        o_ref, lse_ref = cuda_flash.flash_attention_fwd_reference(q, k, v, h, g, window=window)
        torch.cuda.synchronize()
        err = max(max_err(o, o_ref), max_err(lse, lse_ref))
        use = max(tol_use(o, o_ref), tol_use(lse, lse_ref))
        log("check_flash", B=b, H=h, G=g, T=t, Dh=d, window=window, dtype=str(dtype),
            max_abs_err=err, tol_use=use)
        if not (use <= 1.0):
            raise AssertionError(f"flash kernel disagrees with its plain version: {use} x its limit")
        worst = max(worst, err)
    return worst


def paged_state(rng, b, n_blocks, nb, bs, t, lo=0, hi=None):
    """Fragmented tables with dead tails (zeros); row 0 has seq 0."""
    perm = rng.permutation(np.arange(1, n_blocks)).tolist()
    tables = np.zeros((b, nb), np.int32)
    seq = np.zeros((b,), np.int32)
    for i in range(b):
        if i == 0:
            n_pages, s = 1, 0
        else:
            s = int(rng.integers(lo, (hi if hi is not None else nb * bs - t) + 1))
            n_pages = (s + t - 1) // bs + 1
        tables[i, :n_pages] = [perm.pop() for _ in range(n_pages)]
        seq[i] = s
    return torch.from_numpy(tables).cuda(), torch.from_numpy(seq).cuda()


def check_paged() -> float:
    from pretraining_llm_tpu_torch.ops import cuda_paged

    gen = torch.Generator().manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    b, h, bs, nb, n_blocks = 8, 12, 64, 16, 160
    cases = [  # (T, G, Dh, window, dtype)
        (1, 12, 64, 0, torch.bfloat16), (1, 12, 64, 0, torch.float32),
        (4, 12, 64, 0, torch.bfloat16), (4, 12, 64, 0, torch.float32),
        (1, 4, 64, 0, torch.bfloat16), (4, 4, 64, 200, torch.bfloat16),
        (1, 12, 64, 200, torch.float32), (4, 4, 128, 0, torch.bfloat16),
    ]
    worst = 0.0
    for t, g, d, window, dtype in cases:
        q = randn((b, t, h, d) if t > 1 else (b, h, d), dtype, gen)
        kp = randn((n_blocks, bs, g, d), dtype, gen)
        vp = randn((n_blocks, bs, g, d), dtype, gen)
        tables, seq = paged_state(rng, b, n_blocks, nb, bs, t)
        out = cuda_paged.paged_decode_attention(q, kp, vp, tables, seq, window=window)
        ref = cuda_paged.paged_decode_attention_reference(q, kp, vp, tables, seq, window=window)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        use = tol_use(out, ref)
        log("check_paged", B=b, H=h, G=g, T=t, Dh=d, window=window, dtype=str(dtype),
            max_abs_err=err, tol_use=use, seq_lens=seq.tolist())
        if not (use <= 1.0):
            raise AssertionError(f"paged kernel disagrees with its plain version: {use} x its limit")
        worst = max(worst, err)
    return worst


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


def run_main_path():
    """Full-width gpt2-124m, bf16, paged_attention_impl="kernel", served
    through ServingEngine.submit/run. Returns each kernel's launch count
    on that run and the (rows, padded length) of each admission prefill."""
    import dataclasses

    from pretraining_llm_tpu_torch.config import get_preset
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import bridge, transformer
    from pretraining_llm_tpu_torch.ops import cuda_flash, cuda_paged

    cfg = dataclasses.replace(get_preset("gpt2-124m").model, paged_attention_impl="kernel")
    params = bridge.cast_params_for_inference(transformer.init_params(cfg, SEED, device="cuda"), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(params, cfg, max_batch=8, n_blocks=256, block_size=64, steps_per_sched=8)
    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(17, 901, size=16).tolist()
    max_new = 64
    rids = [eng.submit(rng.integers(0, cfg.vocab_size, size=n).tolist(), max_new) for n in lens]

    cuda_flash.flash_attention_fwd.launches = 0
    cuda_paged.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "flash_fwd": cuda_flash.flash_attention_fwd.launches,
        "paged_decode": cuda_paged.paged_decode_attention.launches,
    }

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
    if min(launches.values()) <= 0:
        raise AssertionError(f"main path did not run through both kernels: {launches}")
    return launches, eng.prefill_shapes


def time_kernels(launches, prefill_shapes, errs):
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
    p_ms = time_ms(lambda: cuda_flash.flash_attention_fwd_reference(q, k, v, h, h), flush=flush)
    q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
    l_ms = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), flush=flush)
    flops = 2.0 * b * h * t * t * d  # QK^T and PV over the causal half
    nbytes = 4 * b * h * t * d * 2 + b * h * t * 4  # q, k, v, o in bf16 + lse fp32
    kernels.append(dict(
        name="flash_fwd", route="cuda", source="pretraining_llm_tpu_torch/csrc/flash_fwd.cu",
        replaces="pretraining_llm_tpu/ops/pallas_flash.py:104",
        shape=f"B*H={b * h} T={t} Dh={d} bf16 causal", launches=launches["flash_fwd"],
        flops=flops, bytes=nbytes, **_bound(flops, nbytes), max_abs_err=errs["flash_fwd"],
        ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
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
    k_ms = time_ms(lambda: cuda_paged.paged_decode_attention(q, kp, vp, tables, seq), flush=flush)
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
    kernels.append(dict(
        name="paged_decode", route="cuda", source="pretraining_llm_tpu_torch/csrc/paged_decode.cu",
        replaces="pretraining_llm_tpu/ops/pallas_paged.py:48",
        shape=f"B={b} H={h} G={g} T=1 Dh={d} bs={bs} nb={nb} bf16 seq_lens={seq.tolist()}",
        launches=launches["paged_decode"], flops=flops, bytes=nbytes, **_bound(flops, nbytes),
        max_abs_err=errs["paged_decode"], ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
        library_note="SDPA over the pre-gathered KV with a boolean mask (gather not timed)",
    ))
    for kern in kernels:
        kern["kernel_ms"] = kern["ms"]
        kern["max_err"] = kern["max_abs_err"]
    return kernels


def _bound(flops: float, nbytes: float) -> dict:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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
    errs = {"flash_fwd": check_flash(), "paged_decode": check_paged()}
    check_model_card_vs_cpu()
    launches, prefill_shapes = run_main_path()
    kernels = time_kernels(launches, prefill_shapes, errs)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
