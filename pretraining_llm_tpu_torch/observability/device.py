"""Device and build telemetry: memory samples and recompile events (the
port's ``observability/device.py``).

  - ``DeviceTelemetry.sample`` reads ``torch.cuda.memory_stats`` per visible
    card (current and peak allocated bytes, and the card's total): a query
    of the caching allocator on the host, no device sync. A CPU run has no
    such counters and emits no sample, as the JAX package emits none on a
    backend without ``memory_stats``.
  - ``CompileWatcher`` counts the port's own builds. Eager PyTorch compiles
    no programs; what the port compiles at first use are its CUDA kernels
    (``ops/_build.py``: one ``nvcc`` per source) and its host C++ libraries
    (``data/_native.py``). Each finished build is reported to
    ``note_build``; builds before ``mark_warm`` are the expected first-use
    builds, and every one after becomes a ``recompile`` event unless a
    ``suppress()`` scope is open. A run whose libraries were already built
    reports zero builds: the watcher reports only what it observed.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Dict, Iterator, List, Optional

import torch

# The watchers started and not stopped; ``note_build`` reports to each.
_ACTIVE: "weakref.WeakSet[CompileWatcher]" = weakref.WeakSet()


def note_build(kind: str, name: str, dur_s: float) -> None:
    """Called by the build modules after a library was built: ``kind`` is
    "nvcc" or "cxx", ``name`` the source."""
    for watcher in list(_ACTIVE):
        watcher.note_compile(dur_s, what=f"{kind}:{name}")


class DeviceTelemetry:
    """Per-card memory sampling onto the event bus."""

    def __init__(self, bus: Any = None) -> None:
        self.bus = bus

    def sample(self, step: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        """One ``memory_stats`` read per card; emits a ``device_memory``
        event when any card reports. Returns ``{"cuda:<i>": stats}`` (empty
        without a card)."""
        per_device: Dict[str, Dict[str, float]] = {}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                if not stats:
                    continue
                per_device[f"cuda:{i}"] = {
                    "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
                    "bytes_reserved": float(stats.get("reserved_bytes.all.current", 0)),
                    "bytes_limit": float(torch.cuda.get_device_properties(i).total_memory),
                }
        if per_device and self.bus is not None:
            worst = max(d["bytes_in_use"] for d in per_device.values())
            self.bus.emit("device_memory", step=step, max_bytes_in_use=worst, devices=per_device)
        return per_device


class CompileWatcher:
    """Counts the port's builds and their seconds; builds after warm-up
    become ``recompile`` events."""

    def __init__(self, bus: Any = None) -> None:
        self.bus = bus
        self._lock = threading.Lock()
        self._warm = False
        self.compiles = 0
        self.compile_s = 0.0
        self.recompiles = 0
        self.recompile_s = 0.0
        self.built: List[str] = []
        self._current_step: Optional[int] = None
        self._suppressed = 0

    def start(self) -> "CompileWatcher":
        _ACTIVE.add(self)
        return self

    def stop(self) -> None:
        _ACTIVE.discard(self)

    def mark_warm(self, step: Optional[int] = None) -> None:
        """The first step is done: a later build is a recompile."""
        self._warm = True
        self._current_step = step

    def at_step(self, step: int) -> None:
        """Label later recompile events with the loop's position."""
        self._current_step = step

    @contextlib.contextmanager
    def suppress(self) -> Iterator[None]:
        """Builds inside the block are expected (counted, no event): an eval
        or a restore that first uses a kernel after warm-up."""
        with self._lock:
            self._suppressed += 1
        try:
            yield
        finally:
            with self._lock:
                self._suppressed -= 1

    def note_compile(self, dur_s: float, what: str = "") -> None:
        """Record one build (public so tests can feed it directly)."""
        with self._lock:
            self.compiles += 1
            self.compile_s += dur_s
            if what:
                self.built.append(what)
            if not self._warm or self._suppressed:
                return
            self.recompiles += 1
            self.recompile_s += dur_s
            step = self._current_step
        if self.bus is not None:
            self.bus.emit("recompile", step=step, dur_s=dur_s, what=what)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {"compiles": self.compiles, "compile_s": round(self.compile_s, 4),
                    "recompiles": self.recompiles, "recompile_s": round(self.recompile_s, 4),
                    "built": list(self.built)}
