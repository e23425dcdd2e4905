"""Prometheus textfile exporter — no server, no client library (the JAX
package's ``observability/export.py``).

Writes the node-exporter "textfile collector" format: a flat file of
``# TYPE`` headers and ``name{labels} value`` samples that node_exporter
(or any file-scraping agent) picks up. One atomic replace per write, so a
scraper never reads a torn file. This is the lowest-dependency way to get
live run metrics (loss, MFU, goodput, device memory) onto a dashboard from
a training host: no port to open, no endpoint to keep alive while the host
is busy driving the card.
"""

from __future__ import annotations

import math
import os
import re
import time
from typing import Any, Dict, Mapping, Optional

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(key: str, prefix: str) -> str:
    name = prefix + _NAME_FIX.sub("_", key)
    if not _NAME_OK.match(name):
        name = "_" + name
    return name


def _format_value(val: float) -> str:
    if math.isnan(val):
        return "NaN"
    if math.isinf(val):
        return "+Inf" if val > 0 else "-Inf"
    return repr(float(val))


def _format_labels(labels: Optional[Mapping[str, Any]]) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in sorted(labels.items()):
        sval = str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
        parts.append(f'{_NAME_FIX.sub("_", k)}="{sval}"')
    return "{" + ",".join(parts) + "}"


def prometheus_lines(
    metrics: Mapping[str, Any],
    *,
    prefix: str = "pllm_",
    labels: Optional[Mapping[str, Any]] = None,
    timestamp: Optional[float] = None,
    types: Optional[Mapping[str, str]] = None,
) -> str:
    """Render numeric metrics as Prometheus text exposition.

    Non-numeric values are skipped (the textfile format has no strings);
    bools export as 0/1. Keys are sanitized into valid metric names.

    ``types`` maps input keys to ``"counter"`` or ``"gauge"`` (default
    gauge — the historical behavior). A key typed counter whose name does
    not already end ``_total`` is renamed ``<name>_total`` so the output
    satisfies the Prometheus counter-naming contract; full typed series
    (histograms, labeled children) live in metrics.MetricsRegistry — this
    stays the flat-dict renderer.
    """
    label_str = _format_labels(labels)
    ts = ""
    if timestamp is not None:
        ts = f" {int(timestamp * 1000)}"
    lines = []
    for key in sorted(metrics):
        val = metrics[key]
        if isinstance(val, bool):
            val = float(val)
        if not isinstance(val, (int, float)):
            continue
        kind = (types or {}).get(key, "gauge")
        if kind not in ("counter", "gauge"):
            raise ValueError(f"unsupported series type {kind!r} for {key!r}")
        name = _metric_name(key, prefix)
        if kind == "counter" and not name.endswith("_total"):
            name += "_total"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name}{label_str} {_format_value(float(val))}{ts}")
    return "\n".join(lines) + ("\n" if lines else "")


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?"
    r" (?P<value>[^ ]+)(?: [0-9]+)?$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_sample(line: str):
    m = _SAMPLE_RE.match(line)
    if m is None:
        return None
    labels = dict(_LABEL_RE.findall(m.group("labels") or ""))
    raw = m.group("value")
    try:
        value = float(raw)
    except ValueError:
        return None
    return m.group("name"), labels, value


def _series_base(name: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def lint_exposition(text: str) -> "list[str]":
    """In-tree Prometheus exposition lint; returns a list of problems
    (empty = clean). CI runs this over the live ``/metrics`` body so the
    format is a checked contract, not a convention. Checks:

      - every sample line parses (name, optional labels, float value);
      - at most one ``# TYPE`` per metric name, emitted before its samples;
      - counters end ``_total`` and gauges don't claim to;
      - histogram children are complete and coherent per label set:
        ``_bucket`` series cumulative and non-decreasing in ``le`` order,
        a ``+Inf`` bucket present and equal to ``_count``, ``_sum``/
        ``_count`` present;
      - no sample under a name that was never typed when any name was.
    """
    problems: list[str] = []
    types: Dict[str, str] = {}
    seen_samples: Dict[str, bool] = {}
    hist: Dict[str, Dict[str, Dict[str, Any]]] = {}

    def _label_key(labels: Mapping[str, str]) -> str:
        return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) != 4 or parts[3] not in (
                "counter", "gauge", "histogram", "summary", "untyped"
            ):
                problems.append(f"line {lineno}: malformed TYPE line {line!r}")
                continue
            name, kind = parts[2], parts[3]
            if name in types:
                problems.append(f"line {lineno}: duplicate TYPE for {name}")
            if seen_samples.get(name):
                problems.append(
                    f"line {lineno}: TYPE for {name} after its samples"
                )
            types[name] = kind
            if kind == "counter" and not name.endswith("_total"):
                problems.append(
                    f"line {lineno}: counter {name} does not end '_total'"
                )
            if kind == "gauge" and name.endswith("_total"):
                problems.append(
                    f"line {lineno}: gauge {name} ends '_total' (counter name)"
                )
            continue
        if line.startswith("#"):
            continue  # HELP / comments
        parsed = _parse_sample(line)
        if parsed is None:
            problems.append(f"line {lineno}: unparseable sample {line!r}")
            continue
        name, labels, value = parsed
        base = _series_base(name)
        typed = types.get(name) or types.get(base)
        if types and typed is None:
            problems.append(f"line {lineno}: sample {name} has no TYPE")
        seen_samples[name] = True
        seen_samples[base] = True
        if types.get(base) == "histogram":
            slot = hist.setdefault(base, {}).setdefault(
                _label_key({k: v for k, v in labels.items() if k != "le"}),
                {"buckets": [], "sum": None, "count": None},
            )
            if name.endswith("_bucket"):
                if "le" not in labels:
                    problems.append(
                        f"line {lineno}: {name} bucket without le label"
                    )
                else:
                    slot["buckets"].append((labels["le"], value))
            elif name.endswith("_sum"):
                slot["sum"] = value
            elif name.endswith("_count"):
                slot["count"] = value
            else:
                problems.append(
                    f"line {lineno}: stray sample {name} under histogram {base}"
                )
    for base, children in hist.items():
        for label_key, slot in children.items():
            where = f"{base}{{{label_key}}}" if label_key else base
            buckets = slot["buckets"]
            if not buckets:
                problems.append(f"{where}: histogram with no _bucket series")
                continue
            if slot["sum"] is None:
                problems.append(f"{where}: histogram missing _sum")
            if slot["count"] is None:
                problems.append(f"{where}: histogram missing _count")
            les = [le for le, _ in buckets]
            if les[-1] != "+Inf":
                problems.append(f"{where}: last bucket le={les[-1]!r}, not +Inf")
            try:
                bounds = [float("inf") if le == "+Inf" else float(le) for le in les]
            except ValueError:
                problems.append(f"{where}: unparseable le value in {les}")
                continue
            if bounds != sorted(bounds):
                problems.append(f"{where}: bucket le values not ascending")
            counts = [c for _, c in buckets]
            if any(b > a for a, b in zip(counts[1:], counts)):
                problems.append(f"{where}: bucket counts not cumulative")
            if slot["count"] is not None and counts and counts[-1] != slot["count"]:
                problems.append(
                    f"{where}: +Inf bucket {counts[-1]} != _count {slot['count']}"
                )
    return problems


def write_textfile(
    path: str,
    metrics: Mapping[str, Any],
    *,
    prefix: str = "pllm_",
    labels: Optional[Mapping[str, Any]] = None,
    stamp: bool = True,
    registry: Optional[Any] = None,
) -> str:
    """Atomically write the textfile; returns the path.

    ``stamp`` adds a ``<prefix>last_write_seconds`` gauge so dashboards can
    alert on a run that stopped updating (the watchdog's out-of-band twin).
    ``registry`` (observability.metrics.MetricsRegistry) renders its typed
    series first, with ``metrics`` merged in as plain gauges — the path by
    which training metrics and the typed registry share one exposition.
    """
    if registry is not None:
        body = registry.render(extra_gauges=metrics)
        prefix = registry.prefix or prefix
    else:
        body = prometheus_lines(metrics, prefix=prefix, labels=labels)
    if stamp:
        body += prometheus_lines(
            {"last_write_seconds": time.time()}, prefix=prefix, labels=labels
        )
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(body)
    os.replace(tmp, path)
    return path
