"""Rolling-window anomaly detection over log-boundary training metrics
(the JAX package's ``resilience/anomaly.py``).

The trainer already fetches loss and grad_norm to the host at every log
boundary; observing those floats adds no device work. Three rules:

  nan        loss or grad_norm is NaN/Inf; armed from the first sample.
  loss_spike loss > loss_spike_factor * rolling median of the loss.
  grad_spike grad_norm > grad_spike_factor * rolling median of grad_norm.

The spike rules arm after ``anomaly_min_history`` samples, and an anomalous
sample never joins the window it is judged against.
"""

from __future__ import annotations

import math
import statistics
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Optional

from pretraining_llm_tpu_torch.config import ResilienceConfig


@dataclass(frozen=True)
class Anomaly:
    kind: str  # "nan" | "loss_spike" | "grad_spike"
    step: int
    value: float
    threshold: float

    def as_event(self) -> Dict[str, Any]:
        return {"event": "anomaly_detected", "kind": self.kind, "step": self.step,
                "value": self.value, "threshold": self.threshold}


class AnomalyDetector:
    def __init__(self, cfg: ResilienceConfig) -> None:
        self.cfg = cfg
        self._loss: "deque[float]" = deque(maxlen=cfg.anomaly_window)
        self._grad: "deque[float]" = deque(maxlen=cfg.anomaly_window)

    def reset(self) -> None:
        """Drop the history (after a rollback the poisoned window's samples
        must not seed the restored timeline's baseline)."""
        self._loss.clear()
        self._grad.clear()

    def observe(self, step: int, metrics: Dict[str, float]) -> Optional[Anomaly]:
        """Feed one log boundary's metrics; returns the anomaly, if any."""
        loss = metrics.get("loss")
        grad = metrics.get("grad_norm")
        for value in (loss, grad):
            if value is not None and not math.isfinite(value):
                return Anomaly("nan", step, float(value), float("nan"))
        anomaly = None
        if loss is not None and len(self._loss) >= self.cfg.anomaly_min_history:
            baseline = statistics.median(self._loss)
            threshold = self.cfg.loss_spike_factor * baseline
            if baseline > 0 and loss > threshold:
                anomaly = Anomaly("loss_spike", step, loss, threshold)
        if anomaly is None and grad is not None and len(self._grad) >= self.cfg.anomaly_min_history:
            baseline = statistics.median(self._grad)
            threshold = self.cfg.grad_spike_factor * baseline
            if baseline > 0 and grad > threshold:
                anomaly = Anomaly("grad_spike", step, grad, threshold)
        if anomaly is None:  # only clean samples extend the baseline
            if loss is not None:
                self._loss.append(loss)
            if grad is not None:
                self._grad.append(grad)
        return anomaly
