"""Serving entry point of the PyTorch port: the JAX package's
``scripts/serve.py``.

Offline, a prompt file (one prompt a line) flows through
``generation.serving.ServingEngine``'s continuous batching, and each prompt gets one JSONL record with ``index``,
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

With ``--http`` the same engine goes online behind ``frontend.EngineLoop``,
``AdmissionController`` and ``ServingGateway`` (POST /v1/generate, full or
SSE; GET /healthz, /readyz, /metrics, /slo, /metricsz, /debug/requests,
/debug/engine) until SIGINT or SIGTERM; SIGTERM first drains the requests
in flight. ``--events`` writes the request lifecycle (and capacity) events
as JSONL, ``--trace`` the request traces as Chrome trace JSON at shutdown,
and the SLO engine runs unless ``--no-slo``::

    python -m pretraining_llm_tpu_torch.serve --model_path build/ck --http --port 8000 \\
        --tokenizer byte --temperature 0 --events build/events.jsonl --trace build/trace.json
    curl -s localhost:8000/v1/generate -d '{"prompt": "hi", "max_new_tokens": 16}'

``--replicas N`` puts ``frontend.Router`` in front of N replicas in this
process, each with its own engine, loop, admission and labelled registry,
behind the same gateway: prefix-affinity routing, ejection and relaunch,
drain and redrive. ``--replica_roles prefill,decode`` disaggregates
prefill (the KV pages migrate to the decode replica), ``--journal_path``
keeps the router's write-ahead journal and ``--recover`` replays it,
``--serving_faults`` runs a drill (also with one replica),
``--wedged_after_s`` ejects a replica whose turn hangs, and
``--probe_interval_s`` re-runs golden probes per replica and quarantines
one that diverges::

    python -m pretraining_llm_tpu_torch.serve --model_path build/ck --http --port 8000 \\
        --tokenizer byte --temperature 0 --replicas 2 --journal_path build/journal.jsonl \\
        --probe_interval_s 0.5 --serving_faults corrupt_weights@req8:r1 --events build/events.jsonl
    python -m pretraining_llm_tpu_torch.obs_report --fleet --integrity --strict build/events.jsonl

``--replica_mode process`` runs each replica in a worker process of its
own (``python -m pretraining_llm_tpu_torch.frontend.worker``, which loads
``--model_path`` itself on ``--device``) behind a socket: the same router,
with a kill -9, a dropped connection or a wedged worker as real faults
(``worker_kill``, ``conn_drop``, ``worker_stall``, ``partition``,
``wire_delay``) and rolling weight upgrades. ``--attach host:port,...``
attaches to workers started beforehand with ``--listen`` and ``--token``
instead of spawning them, ``--attach_token`` presents the token and
``--lease_s`` is the heartbeat lease after which a silent worker parks and
its requests are redriven::

    python -m pretraining_llm_tpu_torch.frontend.worker --listen 127.0.0.1:7001 --token s3cret \\
        --spec-json '{"model_path": "build/ck", "engine": {"prefix_cache": true}}'
    python -m pretraining_llm_tpu_torch.serve --model_path build/ck --http --port 8000 --tokenizer byte \\
        --temperature 0 --replica_mode process --replicas 2 --attach 127.0.0.1:7001,127.0.0.1:7002 \\
        --attach_token s3cret --lease_s 2 --journal_path build/journal.jsonl

With ``--attach`` and ``--weight_fingerprint_interval_s`` > 0 the router
refuses a worker whose weight fingerprint is not this checkpoint's (the
workers must pin fingerprints too: ``"loop": {"weight_fingerprint_interval_s": ...}``
in their spec).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time
from typing import Any, Dict, List, Optional

# The JAX CLI's online flags: (flag, kind, help). None leaves the config's
# ``frontend`` value.
_HTTP_FLAGS = (
    ("--host", str, "gateway bind host"),
    ("--port", int, "gateway bind port, 0 = ephemeral"),
    ("--max_queue_depth", int, "backpressure: max in-system requests before 429"),
    ("--max_outstanding_tokens", int, "backpressure: outstanding prompt+max_new budget, 0 = unlimited"),
    ("--default_deadline_s", float, "deadline of requests that send none, 0 = none"),
    ("--trace_sample", float, "per-request tracing head-sample fraction in [0, 1]; 0 = off"),
    ("--healthz_stale_after_s", float, "/healthz is 503 after this many seconds without a scheduler turn"),
    ("--weight_fingerprint_interval_s", float, "weight fingerprint refresh period on the loop thread; 0 = off"),
)
# Its fleet flags: (flag, kind, help). None leaves the config's value.
_FLEET_FLAGS = (
    ("--replicas", int, "replicas in this process behind the fleet router; 1 = one engine loop"),
    ("--replica_roles", str, "(replicas > 1) comma-separated prefill|decode|both, one per replica or one for all "
     "(default: both)"),
    ("--journal_path", str, "write-ahead fleet journal JSONL"),
    ("--serving_faults", str, "serving fault plan, e.g. 'replica_crash@req3:r0,slow_window@req5'"),
    ("--wedged_after_s", float, "eject a replica with active requests and no scheduler turn for this long; 0 = off"),
    ("--probe_interval_s", float, "(replicas > 1) golden-probe period; 0 = off"),
    ("--probe_count", int, "distinct golden probes to pin"),
    ("--probe_max_new", int, "tokens each probe decodes"),
    ("--attach", str, "(replica_mode process) attach to workers started with --listen instead of spawning them: "
     "host:port,... one address per replica (default: config frontend.worker_attach)"),
    ("--attach_token", str, "shared secret of the attach handshake, the workers' --token"),
    ("--lease_s", float, "heartbeat lease: a worker that hears nothing from the router for this long parks and the "
     "router redrives its requests; 0 = off"),
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
    parser.add_argument("--http", action="store_true",
                        help="serve the HTTP/SSE gateway instead of draining a prompt file")
    for flag, kind, text in _HTTP_FLAGS:
        parser.add_argument(flag, type=kind, default=None, help=f"(--http) {text} (default: config)")
    parser.add_argument("--events", default="", help="(--http) request-lifecycle events JSONL path")
    parser.add_argument("--trace", default=None,
                        help="(--http) Chrome-trace JSON written at shutdown; implies --trace_sample 1.0 "
                        "unless set (default: config)")
    parser.add_argument("--no-slo", action="store_true", help="(--http) no live SLO engine (GET /slo is 404)")
    parser.add_argument("--slo_ttft_s", type=float, default=2.0, help="(--http) the interactive class's TTFT bound")
    parser.add_argument("--slo_e2e_s", type=float, default=30.0, help="(--http) the interactive class's e2e bound")
    parser.add_argument("--slo_target", type=float, default=0.99, help="(--http) the objectives' success target")
    parser.add_argument("--slo_window_s", type=float, default=60.0,
                        help="(--http) rolling window of the live latency sketches")
    parser.add_argument("--recover", action="store_true",
                        help="(--http) replay --journal_path before taking traffic: journaled in-flight "
                        "requests are redriven from their last committed frontier")
    for flag, kind, text in _FLEET_FLAGS:
        parser.add_argument(flag, type=kind, default=None,
                            help=f"(--http) {text}" + ("" if "(default:" in text else " (default: config)"))
    parser.add_argument("--replica_mode", default=None, choices=["inproc", "process"],
                        help="(--http) 'inproc' = replicas in this process; 'process' = one worker process per "
                        "replica behind a socket (default: config)")
    return parser


def _serve_http(args: argparse.Namespace, cfg: Any, make_engine: Any, enc: Any, quantize: str,
                fingerprint: Any) -> None:
    """The gateway until SIGINT or SIGTERM (the JAX CLI's branches): one
    ``EngineLoop`` with ``--replicas 1`` in this process, else the fleet
    ``Router`` over that many ``Replica``s, each building its own engine
    with ``make_engine``, or with ``--replica_mode process`` over that many
    ``RemoteReplica``s (worker processes, or attached workers).
    ``fingerprint()`` is the served weights' fingerprint, which attached
    workers must match. SIGTERM drains first: no new requests, the ones in
    flight finish (30 s at most), then the loops stop, the bus closes and
    the trace is written."""
    from pretraining_llm_tpu_torch.frontend.admission import AdmissionController
    from pretraining_llm_tpu_torch.frontend.engine_loop import EngineLoop
    from pretraining_llm_tpu_torch.frontend.gateway import ServingGateway
    from pretraining_llm_tpu_torch.frontend.replica import Replica
    from pretraining_llm_tpu_torch.frontend.router import Router
    from pretraining_llm_tpu_torch.observability.capacity import DecisionLog
    from pretraining_llm_tpu_torch.observability.events import EventBus
    from pretraining_llm_tpu_torch.observability.metrics import MetricsRegistry
    from pretraining_llm_tpu_torch.observability.slo import SLOEngine, default_slo_classes
    from pretraining_llm_tpu_torch.observability.spans import get_recorder
    from pretraining_llm_tpu_torch.observability.tracing import Tracer
    from pretraining_llm_tpu_torch.resilience.faults import ServingFaultInjector

    fc = cfg.frontend

    def pick(cli_val, cfg_val):
        return cfg_val if cli_val is None else cli_val

    n_replicas = pick(args.replicas, fc.replicas)
    replica_mode = pick(args.replica_mode, fc.replica_mode)
    fault_spec = pick(args.serving_faults, fc.serving_faults)
    attach = pick(args.attach, fc.worker_attach)
    attach_token = pick(args.attach_token, fc.attach_token)
    lease_s = pick(args.lease_s, fc.lease_s)
    journal_path = pick(args.journal_path, fc.journal_path)
    roles = [r.strip() for r in args.replica_roles.split(",") if r.strip()] if args.replica_roles else []
    if roles:
        if len(roles) == 1:
            roles = roles * n_replicas
        if len(roles) != n_replicas:
            raise SystemExit(f"--replica_roles lists {len(roles)} roles for {n_replicas} replicas")
        bad = [r for r in roles if r not in ("prefill", "decode", "both")]
        if bad:
            raise SystemExit(f"--replica_roles: unknown role(s) {bad}; expected prefill|decode|both")
    attach_addrs = [a.strip() for a in attach.split(",")] if attach else []
    if attach_addrs:
        if replica_mode != "process":
            raise SystemExit("--attach needs --replica_mode process")
        if len(attach_addrs) != n_replicas:
            raise SystemExit(f"--attach lists {len(attach_addrs)} addresses for {n_replicas} replicas")
    if args.recover and not journal_path:
        raise SystemExit("--recover needs --journal_path")

    # The SLO engine subscribes to the bus, so it makes one (in memory
    # without --events).
    bus = EventBus(jsonl_path=args.events) if args.events or not args.no_slo else None
    slo = None
    if not args.no_slo:
        slo = SLOEngine(
            classes=default_slo_classes(ttft_s=args.slo_ttft_s, e2e_s=args.slo_e2e_s, target=args.slo_target),
            bus=bus, decisions=DecisionLog(bus=bus), window_s=args.slo_window_s,
        )
    trace_path = pick(args.trace, fc.trace_path)
    trace_sample = pick(args.trace_sample, fc.trace_sample)
    if args.trace is not None and args.trace_sample is None:
        trace_sample = 1.0  # asking for an export implies sampling
    tracer = Tracer(get_recorder(), sample=trace_sample, seed=args.seed) if trace_sample > 0 else None
    registry = MetricsRegistry(prefix="pllm_serving_", const_labels={"quant_dtype": quantize})

    def make_admission(reg, scope=""):
        return AdmissionController(
            max_queue_depth=pick(args.max_queue_depth, fc.max_queue_depth),
            max_outstanding_tokens=pick(args.max_outstanding_tokens, fc.max_outstanding_tokens),
            retry_after_s=fc.retry_after_s, shed_infeasible=fc.shed_infeasible, registry=reg, scope=scope,
        )

    loop_kwargs = dict(
        idle_wait_s=fc.idle_wait_s, capacity_ring=fc.capacity_ring,
        weight_fingerprint_interval_s=pick(args.weight_fingerprint_interval_s, fc.weight_fingerprint_interval_s),
    )
    def make_router(replicas: List[Any]) -> Any:
        return Router(
            replicas, admission=make_admission(registry, scope="fleet"), bus=bus, registry=registry,
            tracer=tracer, slo=slo, affinity_tokens=fc.affinity_tokens, spill_margin=fc.spill_margin,
            wedged_after_s=pick(args.wedged_after_s, fc.wedged_after_s), eject_backoff_s=fc.eject_backoff_s,
            eject_backoff_max_s=fc.eject_backoff_max_s, backoff_seed=args.seed,
            redrive_max=fc.redrive_max_attempts, brownout_min_healthy_frac=fc.brownout_min_healthy_frac,
            brownout_min_priority=fc.brownout_min_priority, brownout_max_deadline_s=fc.brownout_max_deadline_s,
            probe_interval_s=pick(args.probe_interval_s, fc.probe_interval_s),
            probe_count=pick(args.probe_count, fc.probe_count),
            probe_max_new=pick(args.probe_max_new, fc.probe_max_new), journal_path=journal_path,
            journal_rotate_bytes=int(fc.journal_rotate_mb * 1024 * 1024), recover=args.recover,
        ).start()

    if replica_mode == "process":
        # One worker process per replica. The workers load the checkpoint
        # themselves (the same load, cast and quantize as above, on the
        # same device); the fault plan splits into engine kinds (in the
        # worker spec, fired inside its scheduler) and process kinds
        # (worker_kill, conn_drop, ... fired by this process, the only
        # party that can kill a worker or cut its connection).
        from pretraining_llm_tpu_torch.frontend.remote_replica import RemoteReplica
        from pretraining_llm_tpu_torch.resilience.faults import split_serving_plan

        if args.draft_model_path:
            raise SystemExit("--replica_mode process does not support speculative serving (--draft_model_path): "
                             "draft params cannot ride a JSON worker spec")
        engine_plan, process_plan = split_serving_plan(fault_spec) if fault_spec else ("", "")
        serving = cfg.serving
        worker_spec = dict(
            model_path=args.model_path, ema=bool(args.ema), quantize=quantize, device=args.device,
            engine=dict(
                max_batch=args.max_batch, n_blocks=args.n_blocks, block_size=args.block_size,
                temperature=args.temperature, top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
                stop_token=args.stop_token, seed=args.seed, steps_per_sched=args.steps_per_sched,
                pipeline_depth=args.pipeline_depth or serving.pipeline_depth,
                admit_batch=args.admit_batch or serving.admit_batch,
                prefix_cache=args.prefix_cache or serving.prefix_cache,
                prefix_cache_min_blocks=args.prefix_cache_min_blocks or serving.prefix_cache_min_blocks,
                prefill_chunk_tokens=args.prefill_chunk_tokens or serving.prefill_chunk_tokens,
                kv_checksum=args.kv_checksum or serving.kv_checksum,
            ),
            admission=dict(
                max_queue_depth=pick(args.max_queue_depth, fc.max_queue_depth),
                max_outstanding_tokens=pick(args.max_outstanding_tokens, fc.max_outstanding_tokens),
                retry_after_s=fc.retry_after_s, shed_infeasible=fc.shed_infeasible,
            ),
            loop=loop_kwargs, serving_faults=engine_plan,
        )
        # An attached worker must serve this checkpoint: with fingerprints
        # on, its hello's fingerprint is held against this process's own,
        # taken on the same device from the same cast (and quantized) tree.
        expect = fingerprint() if attach_addrs and loop_kwargs["weight_fingerprint_interval_s"] > 0 else None

        def rep_spec(i: int) -> Dict[str, Any]:
            spec = dict(worker_spec)
            if roles:
                spec["role"] = roles[i]
            if attach_addrs:
                spec["attach"] = attach_addrs[i]
                if attach_token:
                    spec["token"] = attach_token
                if expect is not None:
                    spec["expect_fingerprint"] = expect
            return spec

        # Every RemoteReplica shares the tracer's recorder (or the process
        # default): the workers' spans land in the router's buffer, so one
        # export at shutdown holds the merged trace.
        proc_faults = ServingFaultInjector(process_plan, bus=bus) if process_plan else None
        loop = make_router([
            RemoteReplica(
                i, rep_spec(i), bus=bus, registry_labels={"quant_dtype": quantize}, fault_injector=proc_faults,
                backoff_seed=args.seed, lease_s=lease_s, recorder=tracer.recorder if tracer is not None else None,
            )
            for i in range(n_replicas)
        ])
    elif n_replicas > 1:
        faults = ServingFaultInjector(fault_spec, bus=bus) if fault_spec else None
        loop = make_router([
            Replica(
                i, make_engine, bus=bus, tracer=tracer, registry_labels={"quant_dtype": quantize},
                admission_factory=make_admission, fault_injector=faults, loop_kwargs=loop_kwargs,
                role=roles[i] if roles else "both",
            )
            for i in range(n_replicas)
        ])
    else:
        faults = ServingFaultInjector(fault_spec, bus=bus) if fault_spec else None
        eng = make_engine()
        if faults is not None:
            eng.pipeline_tick = faults.wrap_tick(0, eng.pipeline_tick)
            faults.attach_engine(0, eng)
        loop = EngineLoop(
            eng, admission=make_admission(registry), bus=bus, tracer=tracer, registry=registry, **loop_kwargs,
        ).start()
    gateway = ServingGateway(
        loop, host=pick(args.host, fc.host), port=pick(args.port, fc.port), encode=enc.encode_ordinary,
        decode=enc.decode, default_deadline_s=pick(args.default_deadline_s, fc.default_deadline_s),
        healthz_stale_after_s=pick(args.healthz_stale_after_s, fc.healthz_stale_after_s),
        retry_jitter_frac=fc.retry_jitter_frac, retry_jitter_seed=fc.retry_jitter_seed, slo=slo,
    )
    host, port = gateway._server.server_address[:2]
    fleet = f" ({n_replicas} replicas)" if n_replicas > 1 else ""
    print(f"[serve] gateway{fleet} listening on http://{host}:{port} — POST /v1/generate, GET /healthz, "
          "GET /readyz, GET /metrics, GET /slo, GET /metricsz, GET /debug/requests, GET /debug/engine",
          file=sys.stderr, flush=True)
    # SIGTERM (the orchestrator's stop) takes the ^C path, after a drain.
    graceful = {"drain": False}

    def _sigterm(signum, frame):
        graceful["drain"] = True
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        gateway.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if graceful["drain"]:
            loop.begin_drain()
            deadline = time.monotonic() + 30.0
            while loop.active_requests > 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            print(f"[serve] SIGTERM drain complete ({loop.active_requests} still in flight)",
                  file=sys.stderr, flush=True)
        gateway.stop()
        if loop.stop() is False:
            print("[serve] WARNING: engine loop abandoned wedged at shutdown; outstanding requests got "
                  "error terminals", file=sys.stderr, flush=True)
        if bus is not None:
            bus.close()
        if tracer is not None and trace_path:
            path = tracer.recorder.export(trace_path)
            dropped = tracer.recorder.dropped
            extra = f" ({dropped} spans DROPPED)" if dropped else ""
            print(f"[serve] trace written to {path}{extra}", file=sys.stderr, flush=True)
        print(f"[serve] shut down — {loop.counters}", file=sys.stderr, flush=True)
    failure = getattr(loop, "failure", None)
    if failure is not None:
        raise RuntimeError(f"the engine loop failed: {failure!r}") from failure


def main(argv: Optional[List[str]] = None) -> Optional[List[Dict[str, Any]]]:
    parser = _parser()
    args = parser.parse_args(argv)
    if not args.http and not args.input_file:
        parser.error("--input_file is required unless --http is set")

    from pretraining_llm_tpu_torch.data.tokenizer import get_tokenizer
    from pretraining_llm_tpu_torch.generation.generate import (
        cast_params_for_inference, load_model_for_inference,
    )
    from pretraining_llm_tpu_torch.generation.serving import ServingEngine
    from pretraining_llm_tpu_torch.models import quantize as quantize_mod

    texts: List[str] = []
    if args.input_file:
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
    if args.device != "cpu":
        # Every replica's loop thread would otherwise build the kernel
        # libraries at its first launch, each its own nvcc.
        from pretraining_llm_tpu_torch.ops import _build

        _build.build()

    def make_engine() -> ServingEngine:
        # A factory, not an engine: a fleet builds one engine per replica,
        # and a crashed replica relaunches with a fresh one. The engines
        # share ``params`` (quantized once above).
        return ServingEngine(
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

    if args.http:
        from pretraining_llm_tpu_torch.resilience.integrity import weight_fingerprint

        _serve_http(args, cfg, make_engine, enc, quantize, lambda: weight_fingerprint(params))
        return None

    eng = make_engine()
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
