"""ObservabilityHub: the one handle the trainer wires in (the JAX package's
``observability/hub.py``).

Composes the event bus, span recorder, goodput accountant, device telemetry
and build watcher behind a small surface shaped around the trainer's
boundaries:

    hub.start_run(start_step, total)        train() entered
    hub.mark_warm(step)                     first step done (first-use builds are over)
    hub.on_log_boundary(step, window, m)    once per log interval
    hub.timed_event(kind, step=...)         context manager: span + event
                                            with dur_s around off-path work
    hub.end_run(exit_reason)                train() exiting

File sinks (events JSONL, Chrome trace, Prometheus textfile) are config-
gated and written by host 0 only; the in-memory pieces (bus subscribers,
goodput, build counters) always run — they are a few dict updates per LOG BOUNDARY,
nothing per step, and never touch a device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

from pretraining_llm_tpu_torch.observability import spans as spans_mod
from pretraining_llm_tpu_torch.observability.device import CompileWatcher, DeviceTelemetry
from pretraining_llm_tpu_torch.observability.events import EventBus
from pretraining_llm_tpu_torch.observability.export import write_textfile
from pretraining_llm_tpu_torch.observability.goodput import GoodputAccountant
from pretraining_llm_tpu_torch.observability.metrics import MetricsRegistry
from pretraining_llm_tpu_torch.observability.spans import SpanRecorder


class ObservabilityHub:
    def __init__(self, cfg: Any, *, is_host0: bool = True) -> None:
        self.cfg = cfg
        self.is_host0 = is_host0
        self.bus = EventBus(cfg.events_path if is_host0 else "")
        self.spans = SpanRecorder()
        # Adopt the module default slot so layers without a hub reference
        # (the checkpoint module's spans) land in the same export.
        spans_mod.set_recorder(self.spans)
        self.goodput = GoodputAccountant()
        self.bus.subscribe(self.goodput.observe)
        self.device = DeviceTelemetry(self.bus)
        self.compile_watcher: Optional[CompileWatcher] = (
            CompileWatcher(self.bus) if cfg.compile_telemetry else None
        )
        self._boundaries = 0
        # Typed registry behind the textfile export: the flat per-boundary
        # metrics still ride along as gauges, but the step-window latency
        # becomes a real histogram and the span-recorder drop count a real
        # counter — same module the serving gateway's /metrics uses.
        self.registry = MetricsRegistry(prefix="pllm_")
        self._h_window = self.registry.histogram(
            "step_window_seconds", "wall seconds per log window")
        self._c_dropped = self.registry.counter(
            "spans_dropped_total", "span-recorder events lost to saturation")
        self._dropped_seen = 0

    # -- run lifecycle -------------------------------------------------

    def start_run(self, start_step: int, total: int, **fields: Any) -> None:
        """``fields`` ride on the ``run_start`` event (the trainer names its
        data sampler there)."""
        if self.compile_watcher is not None:
            self.compile_watcher.start()
        self.bus.emit("run_start", step=start_step, total=total, **fields)

    def mark_warm(self, step: int) -> None:
        """First step completed: the kernels its path uses are built; any
        later build is a recompile worth an event."""
        if self.compile_watcher is not None:
            self.compile_watcher.mark_warm(step)

    def end_run(self, exit_reason: str, **fields: Any) -> Dict[str, Any]:
        """Emit ``run_end`` with the goodput + compile summary, flush the
        file sinks, detach the compile listener. Returns the summary."""
        summary = self.goodput.summary()
        record: Dict[str, Any] = {
            "exit_reason": exit_reason,
            "goodput": summary["goodput"],
            "goodput_categories_s": {
                k: round(v, 4) for k, v in summary["categories"].items()
            },
            "total_s": round(summary["total_s"], 4),
            "rollbacks": summary["rollbacks"],
            **fields,
        }
        if self.compile_watcher is not None:
            record["compile"] = self.compile_watcher.summary()
            self.compile_watcher.stop()
        record["spans"] = {
            name: {"count": agg["count"], "total_s": round(agg["total_s"], 4)}
            for name, agg in sorted(self.spans.summary().items())
        }
        self.bus.emit("run_end", **record)
        if self.is_host0 and self.cfg.spans_path:
            try:
                self.spans.export(self.cfg.spans_path)
            except OSError:
                pass  # a full disk must not mask the run's own exit path
        self._sync_dropped()
        self._write_prometheus({"goodput": summary["goodput"]})
        self.bus.close()
        return record

    # -- per-boundary work ---------------------------------------------

    def on_log_boundary(
        self,
        step: int,
        window: Dict[str, float],
        metrics: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, float]:
        """Once per log interval: emit the window event, run the interval
        samplers, export Prometheus. Returns extra metrics (goodput) for
        the caller to merge into its log record."""
        self._boundaries += 1
        if self.compile_watcher is not None:
            self.compile_watcher.at_step(step)
        if window.get("window_s"):
            self.bus.emit(
                "step_window",
                step=step,
                steps=int(window.get("window_steps", 0)),
                dur_s=window["window_s"],
            )
            self._h_window.observe(window["window_s"])
        self._sync_dropped()
        interval = self.cfg.device_memory_interval
        if interval > 0 and self._boundaries % interval == 0:
            self.device.sample(step)
        extra = {"goodput": self.goodput.summary()["goodput"]}
        if metrics is not None:
            merged = dict(metrics)
            merged.update(extra)
            merged["step"] = step
            self._write_prometheus(merged)
        return extra

    @contextlib.contextmanager
    def suppressed_compiles(self) -> Iterator[None]:
        """Builds inside the block are expected first uses (a drill's or a
        rollback's first kernel), not step-loop recompiles."""
        cm = (
            self.compile_watcher.suppress()
            if self.compile_watcher is not None
            else contextlib.nullcontext()
        )
        with cm:
            yield

    @contextlib.contextmanager
    def timed_event(self, kind: str, *, step: Optional[int] = None, **fields: Any) -> Iterator[Dict[str, Any]]:
        """Span + end-of-activity event with measured ``dur_s`` around a
        block of off-path host work. The yielded dict lets the body attach
        result fields (e.g. val_loss) to the event."""
        out: Dict[str, Any] = dict(fields)
        t0 = time.perf_counter()
        suppress = (
            self.compile_watcher.suppress()
            if self.compile_watcher is not None
            else contextlib.nullcontext()
        )
        try:
            # Off-path work building its first kernel (an eval's) is
            # expected: suppress() keeps it out of the recompile class.
            with suppress, self.spans.span(kind):
                yield out
        finally:
            self.bus.emit(kind, step=step, dur_s=time.perf_counter() - t0, **out)

    # ------------------------------------------------------------------

    def _sync_dropped(self) -> None:
        """Fold the recorder's drop count into the counter (a counter can
        only be advanced, so track the delta since last sync)."""
        dropped = self.spans.dropped
        if dropped > self._dropped_seen:
            self._c_dropped.inc(dropped - self._dropped_seen)
            self._dropped_seen = dropped

    def _write_prometheus(self, metrics: Dict[str, Any]) -> None:
        if not (self.is_host0 and self.cfg.prometheus_path):
            return
        try:
            write_textfile(
                self.cfg.prometheus_path, metrics, registry=self.registry
            )
        except OSError:
            pass  # metrics export must never take down the run
