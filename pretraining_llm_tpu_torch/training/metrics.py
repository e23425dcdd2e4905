"""Structured training metrics: JSONL + stdout, throughput and MFU.

Counterpart of ``pretraining_llm_tpu/training/metrics.py``. ``Throughput``
turns the wall time between two log boundaries (each ends in a device sync:
the loss is fetched) into step ms, tokens/s and MFU, from the model's
analytic FLOPs per token against the card's dense bf16 peak. The peak is
looked up by ``torch.cuda.get_device_name``; a card the table does not know
reports no ``mfu`` rather than a guessed one, and so does a CPU run.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Any, Dict, Optional, TextIO

import torch

from pretraining_llm_tpu_torch.config import ModelConfig

# Dense bf16 tensor-core peaks (NVIDIA data sheets, SXM parts), by a
# substring of the device name; the first match wins.
PEAK_BF16_FLOPS = (
    ("H100 SXM", 989e12),
    ("H100 80GB HBM3", 989e12),  # the SXM part's name in get_device_name
)


def device_peak_flops(device: torch.device) -> Optional[float]:
    """Dense bf16 peak of ``device``, or None (CPU, or a card not listed)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in PEAK_BF16_FLOPS:
        if key in name:
            return peak
    return None


def json_line(record: Dict[str, Any]) -> str:
    """One strict-JSON line: a non-finite float becomes null plus a
    ``<key>_nonfinite`` string ('nan' | 'inf' | '-inf')."""
    out: Dict[str, Any] = {}
    for key, val in record.items():
        if isinstance(val, float) and not math.isfinite(val):
            out[key] = None
            out[key + "_nonfinite"] = repr(val)
        else:
            out[key] = val
    return json.dumps(out, allow_nan=False)


class MetricsLogger:
    """JSONL + stdout sink. ``close`` is idempotent and the JSONL file
    reopens (append) on the next ``log``."""

    def __init__(self, jsonl_path: str = "", stream: Optional[TextIO] = None) -> None:
        self.stream = stream or sys.stdout
        self._path = jsonl_path
        self._file = open(jsonl_path, "a") if jsonl_path else None

    def log(self, record: Dict[str, Any]) -> None:
        record = {k: (float(v) if hasattr(v, "item") else v) for k, v in record.items()}
        if self._file is None and self._path:
            self._file = open(self._path, "a")
        if self._file is not None:
            self._file.write(json_line(record) + "\n")
            self._file.flush()
        parts = [f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in record.items()]
        print(" | ".join(parts), file=self.stream, flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class Throughput:
    """Throughput/MFU over log windows: ``tick`` per step, ``window`` right
    after a device sync, ``reset_clock`` after off-path work (eval, save)."""

    def __init__(self, model_cfg: ModelConfig, device: torch.device) -> None:
        self.flops_per_token = model_cfg.flops_per_token()
        self.peak = device_peak_flops(device)
        self._last_time: Optional[float] = None
        self._tokens = 0
        self._steps = 0

    def tick(self, tokens: int) -> None:
        self._tokens += tokens
        self._steps += 1

    def reset_clock(self) -> None:
        self._last_time = time.perf_counter()
        self._tokens = 0
        self._steps = 0

    def window(self) -> Dict[str, float]:
        now = time.perf_counter()
        if self._last_time is None or self._steps == 0:
            self.reset_clock()
            return {}
        dt = now - self._last_time
        tokens, steps = self._tokens, self._steps
        self.reset_clock()
        if dt <= 0:
            return {}
        tok_per_sec = tokens / dt
        out = {
            "step_ms": dt / steps * 1e3,
            "tokens_per_sec": tok_per_sec,
            "window_s": dt,
            "window_steps": float(steps),
        }
        if self.peak is not None:
            out["mfu"] = tok_per_sec * self.flops_per_token / self.peak
        return out
