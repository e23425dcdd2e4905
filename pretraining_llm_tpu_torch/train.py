"""Training entry point of the PyTorch port.

The flag names of the JAX package's ``scripts/train.py`` for what is
ported: a preset (every preset of the JAX package: gpt2-124m,
gpt2-350m-dp, gpt2-1p3b-fsdp, llama-1b, gpt2-8k-sp, gpt2-8k-gqa,
llama3-1b-gqa, moe-8x350m, reference-3b, tiny), dotted overrides of any model, data or train field, file, mixture
or synthetic data, ``--no-resume``, ``--steps`` and ``--obs-dir`` (the
run's events, spans and Prometheus textfile under one directory, for
``python -m pretraining_llm_tpu_torch.obs_report``) and ``--compile-only``.
Runs on the GPU; ``--device cpu`` runs the plain PyTorch versions of the
kernels on the CPU.

Under ``torchrun`` every process is one rank of the preset's mesh (the
``mesh`` section; ``parallel/``): NCCL over one card per rank, or gloo
with ``--device cpu``. A preset whose mesh fixes an axis above 1 needs that
many ranks; one rank runs it with a one-device mesh (``--override
mesh.fsdp=1`` for an fsdp preset, ``mesh.seq=1`` for the 8k presets,
``mesh.expert=1`` for moe-8x350m). Rank 0 prints and logs.

``--compile-only`` sizes a preset before a run: it builds the kernel
libraries, then prints one JSON line with the JAX script's keys.
``arguments`` (the state: parameters, the preset's optimizer state, the
step, the EMA copy if any; and one global batch of int32 tokens),
``outputs`` (the updated state and the step's three fp32 metrics) and
``aliased`` (the state, updated in place as JAX donates it) come from
shapes alone. ``temps`` is measured on the card: the peak allocated during
one full train step of the preset (every microbatch, synthetic tokens)
less the state and the batch; on the CPU, which keeps no peak, it and the
total are ``null``. When the step runs out of memory the line carries
``"oom": true`` and the command exits 1. On a mesh the sizes are one
rank's (its blocks of the sharded leaves, its rows of the batch) and
``devices`` is the number of ranks.

The exit code is the resilience contract the supervisor reads
(``resilience/__init__.py``): 0 when the run completed, 43 after a SIGTERM
stop (checkpointed), 44 when the rollback budget is spent or an anomaly
finds no checkpoint; the step watchdog exits 45 by itself. Run it under
``python -m pretraining_llm_tpu_torch.supervisor -- python -m
pretraining_llm_tpu_torch.train ...`` to be relaunched on 43 and 45.

Examples::

    python -m pretraining_llm_tpu_torch.train --preset tiny --data synthetic \\
        --override train.train_steps=100
    python -m pretraining_llm_tpu_torch.train --preset reference-3b --data synthetic \\
        --override model.remat=full mesh.fsdp=1
    torchrun --nproc_per_node 4 -m pretraining_llm_tpu_torch.train --preset gpt2-8k-sp \\
        --data synthetic --override train.train_steps=3
    torchrun --nproc_per_node 2 -m pretraining_llm_tpu_torch.train --device cpu --preset tiny \\
        --data synthetic --override mesh.fsdp=2 train.train_steps=20
    python -m pretraining_llm_tpu_torch.train --preset gpt2-124m --override \\
        train.optimizer=muon train.checkpoint_async=True train.profile_dir=build/prof \\
        data.train_path=data/parity/train.bin:3,data/parity/val.bin:1
    python -m pretraining_llm_tpu_torch.train --preset gpt2-124m \\
        --override data.train_path=data/train.bin data.val_path=data/val.bin
    python -m pretraining_llm_tpu_torch.train --preset gpt2-124m --no-resume \\
        --override model.ce_impl=fused model.doc_mask_token=10 \\
        data.train_path=data/parity/train.bin data.val_path=data/parity/val.bin
    python -m pretraining_llm_tpu_torch.supervisor --backoff-base 1 -- \\
        python -m pretraining_llm_tpu_torch.train --preset gpt2-124m --obs-dir build/obs \\
        --override data.train_path=data/parity/train.bin resilience.anomaly_detection=True \\
        resilience.watchdog_timeout_s=60
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from pretraining_llm_tpu_torch.config import get_preset, list_presets
from pretraining_llm_tpu_torch.resilience import EXIT_ANOMALY, EXIT_PREEMPTED
from pretraining_llm_tpu_torch.training.trainer import Trainer


def parse_overrides(pairs: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"override must be key=value, got {pair!r}")
        key, raw = pair.split("=", 1)
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw  # plain string
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--preset", default="gpt2-124m", help=f"one of {list(list_presets())}")
    parser.add_argument("--override", nargs="*", default=[], metavar="SECTION.KEY=VALUE",
                        help="dotted config overrides, e.g. train.lr=1e-4")
    parser.add_argument("--data", default="files", choices=["files", "synthetic"],
                        help="'synthetic' trains on a generated Markov stream (no files needed)")
    parser.add_argument("--obs-dir", default="", metavar="DIR",
                        help="run telemetry under DIR: events.jsonl, spans.trace.json, metrics.prom "
                             "(python -m pretraining_llm_tpu_torch.obs_report reads them); explicit obs.* "
                             "overrides win")
    parser.add_argument("--no-resume", action="store_true", help="ignore existing checkpoints")
    parser.add_argument("--steps", type=int, default=None, help="override total steps")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="'cpu' runs the kernels' plain PyTorch versions")
    parser.add_argument("--compile-only", action="store_true",
                        help="build the kernels, print the per-device memory estimate (one JSON line) and exit")
    args = parser.parse_args(argv)
    from pretraining_llm_tpu_torch.parallel.mesh import initialize_distributed, rank

    initialize_distributed(args.device)
    host0 = rank() == 0

    overrides = parse_overrides(args.override)
    if args.obs_dir:
        os.makedirs(args.obs_dir, exist_ok=True)
        for key, fname in (("obs.events_path", "events.jsonl"), ("obs.spans_path", "spans.trace.json"),
                           ("obs.prometheus_path", "metrics.prom")):
            overrides.setdefault(key, os.path.join(args.obs_dir, fname))
    config = get_preset(args.preset).with_overrides(overrides)
    if host0:
        print(f"preset={config.name} device={args.device} params={config.model.num_params() / 1e6:.1f}M",
              flush=True)
    if args.compile_only:
        report = compile_only(config, args.device)
        if report.get("oom"):
            sys.exit(1)
        return report
    trainer = Trainer(config, synthetic_data=args.data == "synthetic", resume=not args.no_resume,
                      device=args.device)
    final = trainer.train(steps=args.steps)
    if host0:
        print("final:", final, f"exit_reason={trainer.exit_reason}", flush=True)
    rc = {"preempted": EXIT_PREEMPTED, "anomaly_budget": EXIT_ANOMALY,
          "anomaly_no_checkpoint": EXIT_ANOMALY}.get(trainer.exit_reason, 0)
    if rc:
        sys.exit(rc)
    return final


def _nbytes(tree: Any) -> int:
    from pretraining_llm_tpu_torch.training.optimizer import tree_leaves

    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))


def shape_bytes(config: Any, mesh: Any = None) -> Dict[str, int]:
    """{"state", "batch", "metrics"} bytes of one train step of ``config``,
    from shapes: the state is ``init_train_state``'s tree (parameters,
    optimizer state, step, EMA copy) built on the meta device, which
    allocates nothing; the batch is x and y of int32 tokens; the metrics are
    the step's three fp32 scalars. On a ``mesh``, one rank's: its blocks of
    the sharded leaves and its rows of the batch."""
    from pretraining_llm_tpu_torch.models import transformer
    from pretraining_llm_tpu_torch.training import optimizer as opt

    dtype = transformer.torch_dtype(config.model.param_dtype)

    def fill(tree: Any) -> Any:
        return {k: fill(s) if isinstance(s, dict) else torch.empty(s, dtype=dtype, device="meta")
                for k, s in tree.items()}

    params = fill(transformer.param_shapes(config.model))
    state = {"params": params, "opt": opt.optimizer_init(params, config.train),
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    if config.train.ema_decay > 0:
        state["ema"] = opt.tree_map(lambda p: torch.empty_like(p, dtype=torch.float32), params)
    b, t = config.train.batch_size, config.model.context_length
    if mesh is not None:
        from pretraining_llm_tpu_torch.parallel.mesh import axis_size
        from pretraining_llm_tpu_torch.training import train_step as ts

        state = ts.shard_train_state(state, mesh, config)
        b //= axis_size(mesh, "data") * axis_size(mesh, "fsdp")
    return {"state": _nbytes(state), "batch": 2 * b * t * 4, "metrics": 3 * 4}


def compile_only(config: Any, device: str = "cuda") -> Dict[str, Any]:
    """The ``--compile-only`` report of ``config`` (see the module
    docstring), printed as one JSON line and returned. On the card one full
    train step runs on a fresh random state and synthetic tokens; an
    out-of-memory error there is the answer (``"oom": true``)."""
    from pretraining_llm_tpu_torch.parallel import mesh as pmesh
    from pretraining_llm_tpu_torch.training import train_step as ts
    from pretraining_llm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and pmesh.world_size() > 1:
        dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    if dev.type == "cuda":
        from pretraining_llm_tpu_torch.ops import _build

        _build.build()
    mesh = pmesh.build_mesh(config.mesh, dev.type) if pmesh.needs_mesh(config.mesh) else None
    sizes = shape_bytes(config, mesh)
    b = sizes["batch"] // (2 * 4 * config.model.context_length)
    t = config.model.context_length
    state_b, batch_b, metrics_b = sizes["state"], sizes["batch"], sizes["metrics"]
    compile_s = time.perf_counter() - t0
    temps: Optional[int] = None
    oom = False
    if dev.type == "cuda":
        try:
            state = ts.init_train_state(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                                        mesh=mesh)
            gen = torch.Generator(device=dev).manual_seed(1)
            x = torch.randint(0, config.model.vocab_size, (b, t), generator=gen, device=dev, dtype=torch.int32)
            y = torch.randint(0, config.model.vocab_size, (b, t), generator=gen, device=dev, dtype=torch.int32)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            state, metrics = ts.build_train_step(config, mesh)(state, (x, y))
            float(metrics["loss"])  # the step ran to its end
            temps = torch.cuda.max_memory_allocated(dev) - state_b - batch_b
        except torch.cuda.OutOfMemoryError:
            oom = True
    gib = 2**30

    def g(n: Optional[int]) -> Optional[float]:
        return None if n is None else round(n / gib, 3)

    report: Dict[str, Any] = {
        "compile_s": round(compile_s, 1),
        "devices": pmesh.world_size(),
        "per_device_GiB": {
            "arguments": g(state_b + batch_b),
            "outputs": g(state_b + metrics_b),
            "aliased (donated state, counted once)": g(state_b),
            "temps": g(temps),
            "total_peak_estimate": g(None if temps is None else state_b + batch_b + metrics_b + temps),
        },
    }
    if oom:
        report["oom"] = True
    if pmesh.rank() == 0:
        print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
