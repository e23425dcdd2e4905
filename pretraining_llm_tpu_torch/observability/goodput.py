"""Goodput accounting: fold the run-event stream into a wall-clock budget
(the JAX package's ``observability/goodput.py``).

Peak-window MFU says how fast the step loop runs *while it runs*; goodput
says how much of the run's wall-clock was that loop making NEW progress.
The decomposition:

  productive  step time spent on steps the run had not reached before —
              measured per ``step_window`` event, split by a step
              high-water mark;
  replay      step time re-running steps at or below the high-water mark
              (the poison window after a rollback, or the resume gap after
              a relaunch — compute burned to stand still);
  eval        evaluate() calls;
  checkpoint  checkpoint saves;
  restore     checkpoint restores + the whole rollback procedure (restore,
              RNG skip-ahead, feed teardown);
  idle        gaps between a run's last event and the next ``run_start``
              (supervisor backoff, scheduler queue time, relaunch exec);
  other       everything unaccounted: compile/init time before the first
              window, host overhead between events. Computed as the
              remainder, so the categories sum to total wall-clock exactly.

The high-water-mark rule is what makes rollbacks visible: a rolled-back run
re-earns steps it already had, so those windows are replay, not progress —
``goodput = productive / total`` drops accordingly.

Events may come from several processes/relaunches (trainer + supervisor
JSONLs); ``fold`` orders them by wall time, the one clock they share.
Durations ride inside events (``dur_s``, measured on each producer's
monotonic clock), so cross-host NTP skew only smears category BOUNDARIES,
never the measured durations themselves.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

CATEGORIES = (
    "productive", "replay", "eval", "checkpoint", "restore", "idle", "other",
)

# Event kind -> whole-duration category (events whose dur_s lands in one
# bucket unsplit; step_window is handled specially by the high-water mark).
_DUR_CATEGORY = {
    "eval": "eval",
    "ckpt_save": "checkpoint",
    "ckpt_restore": "restore",
    "rollback": "restore",
}


class GoodputAccountant:
    """Streaming fold over run events; also usable offline via ``fold``."""

    def __init__(self) -> None:
        self._totals: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self._hwm: Optional[int] = None  # highest step ever completed
        self._first_wall: Optional[float] = None
        self._last_wall: Optional[float] = None
        self._in_run = False
        self.runs = 0
        self.rollbacks = 0
        self.recompiles = 0
        self.exit_reason: Optional[str] = None

    # -- streaming interface (EventBus subscriber) ---------------------

    def observe(self, event: Dict[str, Any]) -> None:
        t = event.get("t_wall")
        if not isinstance(t, (int, float)):
            return  # not a stamped event record
        kind = event.get("event")
        if self._first_wall is None:
            self._first_wall = t
        if kind == "run_start":
            self.runs += 1
            # The gap back to the previous run's last sign of life is idle
            # time (supervisor backoff, queueing, process startup).
            if self._last_wall is not None and not self._in_run:
                self._totals["idle"] += max(0.0, t - self._last_wall)
            self._in_run = True
            step = event.get("step")
            if isinstance(step, int):
                self._hwm = step if self._hwm is None else max(self._hwm, step)
        elif kind == "run_end":
            self._in_run = False
            reason = event.get("exit_reason")
            if isinstance(reason, str):
                self.exit_reason = reason
        elif kind == "step_window":
            self._observe_window(event)
        elif kind == "rollback":
            self.rollbacks += 1
            self._add_dur(kind, event)
        elif kind == "recompile":
            self.recompiles += 1
        elif kind in _DUR_CATEGORY:
            self._add_dur(kind, event)
        self._last_wall = max(self._last_wall or t, t)

    def _add_dur(self, kind: str, event: Dict[str, Any]) -> None:
        dur = event.get("dur_s")
        if isinstance(dur, (int, float)) and dur > 0:
            self._totals[_DUR_CATEGORY[kind]] += float(dur)

    def _observe_window(self, event: Dict[str, Any]) -> None:
        dur = event.get("dur_s")
        steps = event.get("steps")
        end_step = event.get("step")
        if not (isinstance(dur, (int, float)) and dur > 0):
            return
        if not (isinstance(steps, (int, float)) and steps > 0):
            self._totals["other"] += float(dur)
            return
        if isinstance(end_step, int) and self._hwm is not None:
            # Steps past the high-water mark are new ground; the rest of
            # the window re-ran already-earned steps (post-rollback replay
            # or post-relaunch catch-up).
            new = min(float(steps), float(max(0, end_step - self._hwm)))
        else:
            new = float(steps)
        frac = new / float(steps)
        self._totals["productive"] += float(dur) * frac
        self._totals["replay"] += float(dur) * (1.0 - frac)
        if isinstance(end_step, int):
            self._hwm = end_step if self._hwm is None else max(self._hwm, end_step)

    # -- views ---------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Decomposition + goodput fraction over the observed stream.

        ``other`` is the remainder, so the categories sum to ``total_s``
        exactly (unless explicit durations over-count total wall time —
        then ``accounting_error_s`` carries the overshoot instead of a
        negative bucket).
        """
        totals = dict(self._totals)
        total = 0.0
        if self._first_wall is not None and self._last_wall is not None:
            total = max(0.0, self._last_wall - self._first_wall)
        explicit = sum(v for k, v in totals.items() if k != "other") + totals["other"]
        remainder = total - explicit
        error = 0.0
        if remainder >= 0:
            totals["other"] += remainder
        else:
            error = -remainder
        return {
            "total_s": total,
            "goodput": (totals["productive"] / total) if total > 0 else 0.0,
            "categories": totals,
            "accounting_error_s": error,
            "runs": self.runs,
            "rollbacks": self.rollbacks,
            "recompiles": self.recompiles,
            "max_step": self._hwm,
            "exit_reason": self.exit_reason,
        }

    @classmethod
    def fold(cls, events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
        """Offline: order a (possibly multi-file) stream by wall time and
        fold it. Stable sort keeps same-tick events in file order."""
        acc = cls()
        stamped: List[Dict[str, Any]] = [
            e for e in events if isinstance(e.get("t_wall"), (int, float))
        ]
        for event in sorted(stamped, key=lambda e: e["t_wall"]):
            acc.observe(event)
        return acc.summary()
