"""Offline serving entry point of the PyTorch port.

The offline mode of the JAX package's ``scripts/serve.py``: a prompt file
(one prompt a line) flows through ``generation.serving.ServingEngine``'s
continuous batching, and each prompt gets one JSONL record with ``index``,
``prompt``, ``output``, ``n_tokens`` and its lifecycle latencies
(``queue_wait_s``, ``ttft_s``, ``e2e_s``, and ``cached_tokens`` with the
prefix cache on), in prompt order, to ``--output`` or stdout. A summary
with the engine's stats goes to stderr. Scheduler flags left at 0 fall back
to the checkpoint's ``serving`` section, as in JAX. Runs on the GPU;
``--device cpu`` runs the kernels' plain PyTorch versions on the CPU.

Examples::

    python -m pretraining_llm_tpu_torch.serve --model_path build/ck \\
        --input_file prompts.txt --max_new_tokens 64 --temperature 0 --output out.jsonl
    python -m pretraining_llm_tpu_torch.serve --model_path build/ck \\
        --draft_model_path build/draft --spec_k 4 --input_file prompts.txt --temperature 0

``--http`` (the online gateway) and the fleet, observability and SLO flags
of ``scripts/serve.py`` are accepted by the parser and raise
``NotImplementedError``: they wait for the fleet hookup (ROADMAP Queue A
item 6) and the observability port (item 3).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional

# The JAX CLI's online, fleet, observability and SLO flags: (flag, kind).
_UNPORTED_FLAGS = (
    ("--host", str), ("--port", int), ("--max_queue_depth", int), ("--max_outstanding_tokens", int),
    ("--default_deadline_s", float), ("--events", str), ("--trace", str), ("--trace_sample", float),
    ("--healthz_stale_after_s", float), ("--replicas", int), ("--replica_mode", str),
    ("--replica_roles", str), ("--attach", str), ("--attach_token", str), ("--lease_s", float),
    ("--journal_path", str), ("--serving_faults", str), ("--wedged_after_s", float),
    ("--probe_interval_s", float), ("--probe_count", int), ("--probe_max_new", int),
    ("--weight_fingerprint_interval_s", float), ("--slo_ttft_s", float), ("--slo_e2e_s", float),
    ("--slo_target", float), ("--slo_window_s", float),
)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model_path", required=True, help="checkpoint dir (or a step-N dir)")
    parser.add_argument("--input_file", default="", help="one prompt per line")
    parser.add_argument("--max_new_tokens", type=int, default=100)
    parser.add_argument("--max_batch", type=int, default=8, help="concurrent decode rows")
    parser.add_argument("--n_blocks", type=int, default=256, help="KV pool size in blocks (block 0 is reserved)")
    parser.add_argument("--block_size", type=int, default=64, help="tokens per pool block (multiple of 8)")
    parser.add_argument("--steps_per_sched", type=int, default=8, help="decode steps per window")
    parser.add_argument("--temperature", type=float, default=1.0, help="0 = greedy")
    parser.add_argument("--top_k", type=int, default=None)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--min_p", type=float, default=None)
    parser.add_argument("--stop_token", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ema", action="store_true", help="serve from the EMA shadow params")
    parser.add_argument("--draft_model_path", default="",
                        help="draft checkpoint for speculative serving (temperature-only sampling)")
    parser.add_argument("--spec_k", type=int, default=4, help="draft proposals per speculative round")
    parser.add_argument("--no-pipeline", action="store_true",
                        help="the synchronous scheduler instead of the pipelined one")
    parser.add_argument("--pipeline_depth", type=int, default=0,
                        help="in-flight window queue depth (0 = the config's)")
    parser.add_argument("--admit_batch", type=int, default=0,
                        help="admit waiting requests this many at a time while rows run (0 = the config's)")
    parser.add_argument("--prefix_cache", action="store_true", help="cross-request prefix cache")
    parser.add_argument("--prefix_cache_min_blocks", type=int, default=0,
                        help="shortest cached prefix worth mapping, in blocks (0 = the config's)")
    parser.add_argument("--prefill_chunk_tokens", type=int, default=0,
                        help="chunked prefill budget in tokens (0 = the config's)")
    parser.add_argument("--quantize", default="", choices=["", "none", "int8", "int8-kv"],
                        help="int8 block projections, or also int8 KV pools (default: the config's)")
    parser.add_argument("--kv_checksum", action="store_true",
                        help="verify prefix-cache pages against digests recorded at publish")
    parser.add_argument("--tokenizer", default=None, help="override the checkpoint's tokenizer name")
    parser.add_argument("--output", default="", help="results JSONL path (default: stdout)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="'cpu' runs the kernels' plain PyTorch versions")
    parser.add_argument("--http", action="store_true", help="the online gateway (not ported)")
    parser.add_argument("--recover", action="store_true", help="(--http) not ported")
    parser.add_argument("--no-slo", action="store_true", help="(--http) not ported")
    for flag, kind in _UNPORTED_FLAGS:
        parser.add_argument(flag, type=kind, default=None, help="(--http) not ported")
    return parser


def _refuse_unported(args: argparse.Namespace) -> None:
    named = [flag for flag, _ in _UNPORTED_FLAGS if getattr(args, flag[2:]) is not None]
    named += [flag for flag, on in (("--http", args.http), ("--recover", args.recover),
                                    ("--no-slo", args.no_slo)) if on]
    if named:
        raise NotImplementedError(
            f"{', '.join(named)}: the online gateway, fleet and SLO flags are not ported to "
            "PyTorch yet (ROADMAP Queue A item 6, the fleet hookup, and item 3, observability)"
        )


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    parser = _parser()
    args = parser.parse_args(argv)
    _refuse_unported(args)
    if not args.input_file:
        parser.error("--input_file is required")

    from pretraining_llm_tpu_torch.data.tokenizer import get_tokenizer
    from pretraining_llm_tpu_torch.generation.generate import (
        cast_params_for_inference, load_model_for_inference,
    )
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import quantize as quantize_mod

    with open(args.input_file) as f:
        texts = [ln.rstrip("\r\n") for ln in f if ln.strip()]
    if not texts:
        raise SystemExit(f"no prompts in {args.input_file}")

    params, cfg = load_model_for_inference(args.model_path, use_ema=args.ema, device=args.device)
    params = cast_params_for_inference(params, cfg.model)
    enc = get_tokenizer(args.tokenizer or cfg.data.tokenizer_name)
    spec: Dict[str, Any] = {}
    if args.draft_model_path:
        d_params, d_cfg = load_model_for_inference(args.draft_model_path, device=args.device)
        spec = dict(draft_params=cast_params_for_inference(d_params, d_cfg.model),
                    draft_cfg=d_cfg.model, spec_k=args.spec_k)
    serving = cfg.serving
    quantize = args.quantize or serving.quantize
    if quantize != "none":
        params = quantize_mod.quantize_params_for_serving(params, cfg.model)
    eng = ServingEngine(
        params, cfg.model,
        max_batch=args.max_batch, n_blocks=args.n_blocks, block_size=args.block_size,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
        stop_token=args.stop_token, seed=args.seed, steps_per_sched=args.steps_per_sched,
        pipeline_depth=args.pipeline_depth or serving.pipeline_depth,
        admit_batch=args.admit_batch or serving.admit_batch,
        prefix_cache=args.prefix_cache or serving.prefix_cache,
        prefix_cache_min_blocks=args.prefix_cache_min_blocks or serving.prefix_cache_min_blocks,
        prefill_chunk_tokens=args.prefill_chunk_tokens or serving.prefill_chunk_tokens,
        kv_checksum=args.kv_checksum or serving.kv_checksum,
        quantize=quantize, device=args.device, **spec,
    )

    rids: Dict[int, int] = {}
    for i, text in enumerate(texts):
        try:
            rids[eng.submit(enc.encode_ordinary(text), args.max_new_tokens)] = i
        except ValueError as e:
            # One oversized prompt must not abort the other requests.
            print(f"[serve] rejected prompt {i}: {e}", file=sys.stderr)
    if not rids:
        raise SystemExit("every prompt was rejected")

    t0 = time.perf_counter()
    out = eng.run(pipeline=not args.no_pipeline)
    dt = time.perf_counter() - t0

    records = []
    for rid in sorted(rids, key=rids.get):
        toks = out[rid]
        record = {"index": rids[rid], "prompt": texts[rids[rid]], "output": enc.decode(toks),
                  "n_tokens": len(toks)}
        record.update(eng.timing_summary(rid))
        records.append(record)
    sink = open(args.output, "w") if args.output else sys.stdout
    try:
        for record in records:
            sink.write(json.dumps(record) + "\n")
    finally:
        if sink is not sys.stdout:
            sink.close()
    n_tok = sum(len(out[r]) for r in rids)
    print(f"[serve] {len(texts)} requests, {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s) — "
          f"stats {eng.stats}", file=sys.stderr)
    return records


if __name__ == "__main__":
    main()
