"""Deterministic fault drills for training (the training kinds of the JAX
package's ``resilience/faults.py``).

Plan grammar (``ResilienceConfig.faults``): comma-separated ``kind@step``
entries, e.g. ``"nan@20,sigterm@50"``. A fault fires right before that step
runs, after ``step`` completed steps:

  nan            multiply every parameter by NaN: the next loss is NaN and
                 the detector must roll back at the next log boundary;
  sigterm        send this process SIGTERM: the trainer checkpoints and
                 stops at the next log boundary (EXIT_PREEMPTED);
  hang           block the host loop: the step watchdog must fire, save an
                 emergency checkpoint and exit EXIT_WEDGED;
  ckpt_truncate  truncate one ``.npy`` leaf of the newest checkpoint: the
                 next restore must fall back to the previous good step.

Each entry fires at most once per process, and a resumed run never fires
an entry at or below its start step, so a supervisor's relaunch after an
injected hang resumes from the emergency checkpoint and runs on.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, List, Optional, Tuple

import torch

FAULT_KINDS = ("nan", "sigterm", "hang", "ckpt_truncate")

# How long an injected hang blocks: forever next to any watchdog timeout,
# bounded so a run without a watchdog still ends.
_HANG_SECONDS = 3600.0


def parse_faults(spec: str) -> List[Tuple[str, int]]:
    """Parse a fault plan; raises ValueError naming the offending entry."""
    out: List[Tuple[str, int]] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, sep, at = entry.partition("@")
        if not sep or not at:
            raise ValueError(f"malformed fault entry {entry!r} in {spec!r}: expected kind@step")
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {spec!r}; one of {FAULT_KINDS}")
        try:
            step = int(at)
        except ValueError:
            raise ValueError(f"fault step must be an integer in {entry!r} (plan {spec!r})") from None
        if step < 1:
            raise ValueError(
                f"fault step must be >= 1 in {entry!r} (step 0 is never "
                "reachable: faults fire only past the run's start step)"
            )
        out.append((kind, step))
    if not out:
        raise ValueError(f"empty fault plan {spec!r}")
    return out


class FaultInjector:
    """Fires the parsed plan against a live ``Trainer``, once per entry.
    Entries at or below ``start_step`` (the step the run resumed from) fired
    in the lineage that wrote the checkpoint and are spent."""

    def __init__(self, spec: str, *, start_step: int = 0, logger: Any = None, bus: Any = None) -> None:
        self.plan = parse_faults(spec)
        self.start_step = start_step
        self.logger = logger
        self.bus = bus
        self._fired: set = set()

    def maybe_fire(self, step: int, trainer: Any) -> None:
        for i, (kind, at) in enumerate(self.plan):
            if at != step or at <= self.start_step or i in self._fired:
                continue
            self._fired.add(i)
            if self.logger is not None:
                self.logger.log({"event": "fault_injected", "kind": kind, "step": step})
            if self.bus is not None:
                # Before the action: sigterm and hang never hand control back.
                self.bus.emit("fault_injected", step=step, fault=kind)
            getattr(self, f"_fire_{kind}")(trainer)

    def _fire_nan(self, trainer: Any) -> None:
        # In place, as the optimizer updates the parameters.
        from pretraining_llm_tpu_torch.training.optimizer import tree_leaves

        with torch.no_grad():
            for _, p in tree_leaves(trainer.state["params"]):
                if p.is_floating_point():
                    p.mul_(float("nan"))

    def _fire_sigterm(self, trainer: Any) -> None:  # noqa: ARG002 - one shape for every kind
        os.kill(os.getpid(), signal.SIGTERM)

    def _fire_hang(self, trainer: Any) -> None:  # noqa: ARG002
        time.sleep(_HANG_SECONDS)

    def _fire_ckpt_truncate(self, trainer: Any) -> None:
        from pretraining_llm_tpu_torch.training import checkpoint as ckpt

        trainer.join_pending_save()  # the newest checkpoint is on disk first
        latest = ckpt.latest_checkpoint(trainer.config.train.checkpoint_dir)
        if latest is not None:
            truncate_leaf(latest)


def truncate_leaf(ckpt_path: str, leaf: Optional[str] = None) -> Optional[str]:
    """Truncate one ``.npy`` leaf of a checkpoint dir to half its size (a torn
    write). Returns the damaged file's name, or None if there is no leaf."""
    names = sorted(n for n in os.listdir(ckpt_path) if n.endswith(".npy"))
    if leaf is not None:
        names = [n for n in names if n.startswith(leaf)]
    if not names:
        return None
    target = os.path.join(ckpt_path, names[0])
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.truncate(max(1, size // 2))
    return names[0]
