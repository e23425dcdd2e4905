"""Training entry point of the PyTorch port.

The flag names of the JAX package's ``scripts/train.py`` for what is
ported: a preset (every single-device preset of the JAX package: gpt2-124m,
gpt2-350m-dp, gpt2-1p3b-fsdp, llama-1b, llama3-1b-gqa, reference-3b,
tiny), dotted overrides of any model, data or train field, file, mixture
or synthetic data, ``--no-resume``, ``--steps`` and ``--obs-dir`` (the
run's events, spans and Prometheus textfile under one directory, for
``scripts/obs_report.py``). ``--compile-only`` is not ported. Runs on the
GPU; ``--device cpu`` runs the plain PyTorch versions of the kernels on the
CPU.

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
        --override model.remat=full
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
import os
import sys
from typing import Any, Dict, List, Optional

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
                             "(scripts/obs_report.py reads them); explicit obs.* overrides win")
    parser.add_argument("--no-resume", action="store_true", help="ignore existing checkpoints")
    parser.add_argument("--steps", type=int, default=None, help="override total steps")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="'cpu' runs the kernels' plain PyTorch versions")
    args = parser.parse_args(argv)

    overrides = parse_overrides(args.override)
    if args.obs_dir:
        os.makedirs(args.obs_dir, exist_ok=True)
        for key, fname in (("obs.events_path", "events.jsonl"), ("obs.spans_path", "spans.trace.json"),
                           ("obs.prometheus_path", "metrics.prom")):
            overrides.setdefault(key, os.path.join(args.obs_dir, fname))
    config = get_preset(args.preset).with_overrides(overrides)
    print(f"preset={config.name} device={args.device} params={config.model.num_params() / 1e6:.1f}M",
          flush=True)
    trainer = Trainer(config, synthetic_data=args.data == "synthetic", resume=not args.no_resume,
                      device=args.device)
    final = trainer.train(steps=args.steps)
    print("final:", final, f"exit_reason={trainer.exit_reason}", flush=True)
    rc = {"preempted": EXIT_PREEMPTED, "anomaly_budget": EXIT_ANOMALY,
          "anomaly_no_checkpoint": EXIT_ANOMALY}.get(trainer.exit_reason, 0)
    if rc:
        sys.exit(rc)
    return final


if __name__ == "__main__":
    main()
