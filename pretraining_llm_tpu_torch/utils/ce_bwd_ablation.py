"""Which part of the tensor-core dH / dW kernel holds it above its floor.

Times ``csrc/fused_ce_bwd_tc.cu`` at T3's head (S 12288, D 768, V 50304,
bf16, the plan ``ce_bwd_plan`` picks) beside copies of it with one part
taken out: the second product, the logits product, both products, the loads
of the resident operand's slices, or the exp of the epilogue. Each copy
keeps the barriers and the loads of the others, so it runs to its end; its
output is not a gradient. Run from the repository root on a machine with a
GPU::

    python -m pretraining_llm_tpu_torch.utils.ce_bwd_ablation

Prints the card's name and power limit, then one JSON line per (variant,
kernel): the median and range of its device time over 8 alternated rounds
(L2 flushed, a spin queued first so that only device time counts). The
copies are built with ``nvcc`` under ``build/ce_bwd_ablation`` (git-ignored).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

import torch

from pretraining_llm_tpu_torch.ops import _build, cuda_ce

SHAPE = (12 * 1024, 768, 50304)  # (S, D, V): T3's head
ROUNDS = 8
_SECOND = "wgmma_rs<DC>(acc, pa[kk], mnmajor_desc<64, BN>(chunk_tile, kk), 1);"
_LOGITS = "wgmma_ss_n128(lg, kmajor_desc<64>(r_tile, k4), kmajor_desc<64, BN>(x_tile, k4), 1);"
_R_LOAD = "      tma_load_2d(st, &rmap, &full[s], kc, row0);\n"
_R_BYTES = "mbar_arrive_expect_tx(&full[s], Sm::STAGE);"
_EXP = "exp2_ftz(fmaf("
# name -> the source's edits (each text must occur in the source)
VARIANTS = {
    "kernel": [],
    "no_second_product": [(_SECOND, ";")],
    "no_logits_product": [(_LOGITS, ";")],
    "no_products": [(_SECOND, ";"), (_LOGITS, ";")],
    "no_resident_loads": [(_R_LOAD, ""), (_R_BYTES, "mbar_arrive_expect_tx(&full[s], Sm::X_SLICE);")],
    "no_exp": [(_EXP, "(fmaf(")],
}


def _build_variants() -> dict:
    src = (_build.CSRC / "fused_ce_bwd_tc.cu").read_text()
    out = _build.BUILD_DIR.parent / "ce_bwd_ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in fused_ce_bwd_tc.cu")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out / f"lib{name}.so"),
               str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).pllm_ce_bwd_tc
        fn.argtypes = list(cuda_ce._TC_BWD_ARGTYPES)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ce_bwd_ablation: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    fns = _build_variants()
    s, d, v = SHAPE
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((s, d), generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn((v, d), generator=gen) * 0.02).to("cuda", torch.bfloat16)
    labels = torch.randint(0, v, (s,), generator=gen, dtype=torch.int32).cuda()
    g = torch.full((s,), 1.0 / s, device="cuda")
    _, lse = cuda_ce.fused_ce_fwd(h, w, labels)
    stream = torch.cuda.current_stream().cuda_stream
    sms = _build.sm_count(0)

    def launcher(fn, kind):
        dc, chunks, parts, per = cuda_ce.ce_bwd_plan(kind, s, v, d, sms)
        rows = s if kind == "dh" else v
        n_tiles = -(-rows // cuda_ce.BWD_BM) * chunks
        out = torch.empty((rows, d), dtype=torch.bfloat16, device="cuda")
        part = torch.empty(parts * n_tiles * cuda_ce.BWD_BM * dc if parts > 1 else 0, dtype=torch.float32,
                           device="cuda")
        counters = _build.counters(h.device, stream, n_tiles)

        def call():
            _build.check(fn(cuda_ce._BWD_MODES[kind], h.data_ptr(), w.data_ptr(), labels.data_ptr(),
                            lse.data_ptr(), g.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(),
                            s, v, d, dc, parts, per, stream), f"ce_bwd_ablation {kind}")
        return call, (dc, parts)

    cases = {(name, kind): launcher(fn, kind) for name, fn in fns.items() for kind in ("dh", "dw")}
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for call, _ in cases.values():
        call()
    torch.cuda.synchronize()
    times = {key: [] for key in cases}
    order = list(cases)
    for r in range(ROUNDS):
        for key in (order if r % 2 == 0 else order[::-1]):
            l2.zero_()
            torch.cuda._sleep(2_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            cases[key][0]()
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end))
    for (name, kind), t in times.items():
        dc, parts = cases[(name, kind)][1]
        print(json.dumps({"variant": name, "kernel": f"fused_ce_{kind}", "shape": f"S={s} D={d} V={v} bf16",
                          "dc": dc, "partitions": parts, "device_ms_median": statistics.median(t),
                          "device_ms_min": min(t), "device_ms_max": max(t)}), flush=True)


if __name__ == "__main__":
    main()
