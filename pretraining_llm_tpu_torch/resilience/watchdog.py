"""Host-side hung-step watchdog (the JAX package's
``resilience/watchdog.py``).

A wedged device blocks the host thread inside a sync forever: no
exception, no signal, nothing for the trainer's failure path to catch. A
watchdog thread notices that steps stopped completing and, in order:

  1. dumps every thread's stack to stderr (``faulthandler``);
  2. runs ``on_timeout`` (the trainer's bounded emergency checkpoint) under
     a try/except;
  3. ``os._exit(EXIT_WEDGED)``: a SystemExit raised in a daemon thread is
     swallowed, and exit handlers may block on the wedged device.

The first ``heartbeat()`` arms it, so start-up and the first step's kernel
builds never count; ``pause()``/``resume()`` bracket known-long off-path
work (eval, saves, rollback restores): the timeout budgets a step.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Any, Callable, Optional

from pretraining_llm_tpu_torch.resilience import EXIT_WEDGED


class StepWatchdog:
    def __init__(
        self,
        timeout_s: float,
        *,
        on_timeout: Optional[Callable[[], None]] = None,
        logger: Any = None,
        bus: Any = None,
        exit_code: int = EXIT_WEDGED,
        exit_fn: Callable[[int], None] = os._exit,
    ) -> None:
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.logger = logger
        self.bus = bus  # the wedge event is emitted before os._exit, or it never lands
        self.exit_code = exit_code
        self._exit = exit_fn  # tests observe instead of dying
        self._last_beat: Optional[float] = None  # None: not armed
        self._was_armed_at_pause = False
        self._stopped = threading.Event()
        self._fired = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StepWatchdog":
        self._thread = threading.Thread(target=self._run, name="step-watchdog", daemon=True)
        self._thread.start()
        return self

    def heartbeat(self) -> None:
        """A step completed. The first call arms the watchdog."""
        self._last_beat = time.monotonic()

    def pause(self) -> None:
        """Disarm while off-path host work runs on the main thread; ``resume``
        re-arms with a fresh beat only if the watchdog was armed here."""
        self._was_armed_at_pause = self._last_beat is not None
        self._last_beat = None

    def resume(self) -> None:
        if self._was_armed_at_pause:
            self._was_armed_at_pause = False
            self.heartbeat()

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    @property
    def fired(self) -> bool:
        return self._fired

    def _run(self) -> None:
        poll = min(self.timeout_s / 4.0, 1.0)
        while not self._stopped.wait(poll):
            last = self._last_beat
            if last is None:
                continue  # not armed
            stalled = time.monotonic() - last
            if stalled > self.timeout_s:
                self._fire(stalled)
                return

    def _fire(self, stalled: float) -> None:
        self._fired = True
        for call in (
            lambda: self.bus.emit("wedge", stalled_s=round(stalled, 2), timeout_s=self.timeout_s),
            lambda: self.logger.log({"event": "watchdog_timeout", "stalled_s": round(stalled, 2),
                                     "timeout_s": self.timeout_s}),
        ):
            try:
                call()
            except Exception:  # a missing sink or a full disk must not stop the exit
                pass
        try:
            sys.stderr.write(f"\n=== step watchdog: no completed step in {stalled:.1f}s "
                             f"(timeout {self.timeout_s:.1f}s); all thread stacks: ===\n")
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            sys.stderr.flush()
        except Exception:
            pass
        if self.on_timeout is not None:
            try:
                self.on_timeout()
            except Exception as e:
                try:
                    self.logger.log({"event": "emergency_save_failed", "error": repr(e)[:200]})
                except Exception:
                    pass
        self._exit(self.exit_code)
