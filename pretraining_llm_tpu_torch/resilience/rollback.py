"""Automatic checkpoint rollback: anomaly -> last good state -> fresh data
(the JAX package's ``resilience/rollback.py``).

  restore   the newest loadable checkpoint (``checkpoint.restore_latest``
            collects partial ``tmp-<step>`` dirs and falls back past torn
            ones). If the anomaly recurs before a newer checkpoint lands,
            the one just restored is suspect too, and the retry digs
            strictly earlier.
  skip      the data frontier moves past the poison window: the (anomaly
            step - restored step) batches the restored run would replay,
            plus ``skip_batches``.
  re-arm    the caller clears the detector's history, and anomalies are
            suppressed for ``cooldown_steps``.
  budget    at most ``rollback_budget`` rollbacks per ``train()`` call; the
            next anomaly ends the run with EXIT_ANOMALY.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from pretraining_llm_tpu_torch.config import ResilienceConfig
from pretraining_llm_tpu_torch.resilience.anomaly import Anomaly


class RollbackManager:
    """Decides and executes rollbacks against a live ``Trainer``.

    ``handle`` returns "rolled_back" (state restored, data skipped: the
    caller continues from ``last_restored``), "suppressed" (inside the
    cooldown), "exhausted" (budget spent: stop) or "no_checkpoint" (nothing
    loadable: stop)."""

    def __init__(self, cfg: ResilienceConfig, logger: Any = None, bus: Any = None) -> None:
        self.cfg = cfg
        self.logger = logger
        self.bus = bus  # an executed rollback is a run event (goodput's "restore")
        self.used = 0
        self._cooldown_until = -1
        self._last_restored: Optional[int] = None

    def _log(self, record: dict) -> None:
        if self.logger is not None:
            self.logger.log(record)

    def handle(self, trainer: Any, anomaly: Anomaly) -> str:
        step = anomaly.step
        t0 = time.perf_counter()
        if step < self._cooldown_until:
            self._log({"event": "anomaly_suppressed", "kind": anomaly.kind, "step": step,
                       "cooldown_until": self._cooldown_until})
            return "suppressed"
        if self.used >= self.cfg.rollback_budget:
            self._log({"event": "rollback_budget_exhausted", "step": step, "used": self.used,
                       "budget": self.cfg.rollback_budget})
            return "exhausted"

        # An async save in flight may be writing the poisoned state: let it
        # land (and report its error) before choosing what to restore; the
        # prefetch thread holds batches of the poison window: drop it.
        try:
            trainer.join_pending_save()
        except RuntimeError:
            self._log({"event": "async_checkpoint_failed", "step": step})
        trainer._drop_feed()

        from pretraining_llm_tpu_torch.training import checkpoint as ckpt

        directory = trainer.config.train.checkpoint_dir
        newest = max(ckpt._list_steps(directory), default=None)
        before = newest + 1 if newest is not None else None
        if newest is not None and newest == self._last_restored:
            before = newest  # the poison predates the checkpoint restored last
        restored = ckpt.restore_latest(
            directory, trainer._state_template(), before_step=before, loader=trainer._checkpoint_loader,
            on_skip=lambda path, e: self._log({"event": "checkpoint_skipped", "path": path,
                                               "error": repr(e)[:200]}),
        )
        if restored is None:
            self._log({"event": "rollback_no_checkpoint", "step": step})
            return "no_checkpoint"

        state, extra, restored_step = restored
        trainer._adopt_restored(state, extra)
        skip = max(0, step - restored_step) + self.cfg.skip_batches
        trainer._skip_batches(skip)
        self.used += 1
        self._last_restored = restored_step
        self._cooldown_until = restored_step + self.cfg.cooldown_steps
        self._log({"event": "rollback", "kind": anomaly.kind, "from_step": step, "to_step": restored_step,
                   "skipped_batches": skip, "budget_left": self.cfg.rollback_budget - self.used})
        if self.bus is not None:
            # One event covers the whole recovery, restore included: the
            # trainer's resume path owns "ckpt_restore".
            self.bus.emit("rollback", step=step, from_step=step, to_step=restored_step, skipped_batches=skip,
                          anomaly=anomaly.kind, dur_s=time.perf_counter() - t0)
        return "rolled_back"

    @property
    def last_restored(self) -> Optional[int]:
        return self._last_restored
