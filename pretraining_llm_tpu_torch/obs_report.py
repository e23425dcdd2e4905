"""Offline run analyzer: metrics/events JSONL in, run report out (the JAX
package's ``scripts/obs_report.py``, every report and flag).

The online half (pretraining_llm_tpu_torch/observability/) streams events
and metrics to JSONL during the run; this module is the post-hoc fold over
those files, usable on a laptop against files copied off a training host,
and run in CI over the smoke run so the JSONL schema stays a checked
contract.

    python -m pretraining_llm_tpu_torch.obs_report run/obs/events.jsonl run/metrics.jsonl
    python -m pretraining_llm_tpu_torch.obs_report --json --strict ...   # CI: machine
                                                 # output, nonzero on bad lines

Pass any mix of files: records carrying ``event`` + ``t_wall`` are treated as
run events (folded into the goodput decomposition and the event timeline);
records carrying ``step_ms`` feed the step-time histogram. ``--strict`` makes
unparseable lines fatal — a corrupt metrics stream (e.g. bare NaN tokens)
must fail CI, not be skipped.

``--trace trace.json --slo`` adds the SERVING view: the Chrome-trace export
(``python -m pretraining_llm_tpu_torch.serve --trace``, or any
SpanRecorder export) is reconstructed into
per-request span trees keyed by ``trace_id``, each request's end-to-end
latency is decomposed into queue / admission / prefill / decode /
host-blocked / other segments that sum exactly to the root span, and every
SLO miss (``--slo_ttft_s`` / ``--slo_e2e_s``) is attributed to its dominant
segment — "why we missed", not just "that we missed". Under ``--strict``,
an incomplete span tree (missing root, terminal, or orphaned children) is
fatal, which is the CI tracing gate.

``--capacity`` adds the ENGINE view over the same events JSONL: the
``cap_window`` occupancy samples (one per reaped decode window) become a
slot-second waterfall — productive / admission-starved / pool-starved /
preempted-rework / spec-wasted, summing to wall time — the run's binding
constraint is named (slots vs. pool blocks vs. admission budget vs.
arrival rate), and every scheduler ``decision`` record (preempt, evict,
shed) is joined to its trace so "why was trace X preempted" is
answerable offline. ``--strict`` makes a >1% sum error or an unjoinable
decision fatal, which is the CI capacity gate.

``--fleet`` adds the ROUTER view: the ``fleet_req_submit`` /
``fleet_req_terminal`` streams are joined by ``frid`` to assert request
conservation (every accepted request reaches exactly one terminal — the
zero-lost invariant a replica-crash drill is checking), the
replica-tagged ``req_*`` streams become per-replica waterfalls,
``redrive`` events are folded into failover cost (requests redriven,
committed tokens carried over, e2e penalty vs. undisturbed), and
``replica_state`` transitions into per-incident recovery times. Injected
network partitions (``partition_injected``) are joined to whichever
mechanism detected them — ``lease_expired`` (heartbeats stopped) or
``fenced_frames_dropped`` (stale-generation frames arrived after heal) —
plus the redrives they caused; ``journal_replay`` events summarize a
router restart recovering from its fleet journal. Under ``--strict`` a
lost request, dangling redrive, or UNDETECTED partition is fatal, which
is the CI fleet gate.

``--fleet-trace`` adds the CROSS-HOST view over the same ``--trace``
export: each request becomes a lineage tree — the router's root span,
one ``req.attempt`` child per placement attempt (tagged replica + fence
generation + redrive index), and per-attempt worker subtrees shipped
over the span-export frame and clock-aligned into the router timeline by
the per-connection min-RTT offset estimator. The per-request waterfall
decomposes e2e ACROSS attempts (placement / attempts / redrive gaps /
finish, summing to the root), and inter-attempt gaps are joined to the
``redrive``/``lease_expired`` events that explain them. ``--strict``
fails unalignable spans, orphaned attempts or subtrees, and worker spans
outside their attempt's window beyond the recorded clock error bound,
which is the CI cross-host tracing gate.

``--live URL`` adds the ONLINE view: polls a running gateway's
``GET /slo`` (``pretraining_llm_tpu_torch.serve --http``) for the rolling-window latency
sketches, per-class error budgets, burn rates, active alerts, and the
router's fleet-health snapshot. Given events JSONL paths too, the live
sketch percentiles are reconciled against exact percentiles computed
offline from the same run's terminal events — each live quantile must
land inside the exact-rank band ``[q-eps, q+eps]`` (the sketch's
accuracy contract). ``--strict`` makes a mismatch fatal, which is the
CI live-SLO gate.

It imports only the stdlib and the port's observability package, whose
modules need no device at import, so it runs where the training stack does
not. Its JSON output equals the JAX script's on the same files.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, Dict, List, Optional, Tuple

from pretraining_llm_tpu_torch.observability.goodput import CATEGORIES, GoodputAccountant
from pretraining_llm_tpu_torch.observability.metrics import (
    DEFAULT_LATENCY_BUCKETS,
    Histogram,
)
from pretraining_llm_tpu_torch.observability.tracing import (
    _ATTEMPT,
    _ROOT,
    _is_remote,
    check_trace_tree,
    group_request_spans,
)

# Events worth a line each in the timeline; step_window/device_memory are
# high-rate telemetry and only counted.
_NOTABLE = (
    "run_start", "run_end", "eval", "ckpt_save", "ckpt_restore", "rollback",
    "recompile", "wedge", "preempt", "relaunch", "failure", "fault_injected",
)


def _reject_constant(const: str) -> float:
    raise ValueError(f"non-finite JSON constant {const!r} (invalid strict JSON)")


def read_jsonl(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Parse one JSONL file; returns (records, bad_line_count)."""
    records: List[Dict[str, Any]] = []
    bad = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                # parse_constant: Python's json ACCEPTS bare NaN/Infinity by
                # default, but they are invalid JSON — exactly the corruption
                # --strict exists to catch (a logger writing a NaN loss raw).
                rec = json.loads(line, parse_constant=_reject_constant)
            except ValueError:
                bad += 1
                print(f"{path}:{lineno}: unparseable JSON line", file=sys.stderr)
                continue
            if not isinstance(rec, dict):
                bad += 1
                print(f"{path}:{lineno}: not a JSON object", file=sys.stderr)
                continue
            records.append(rec)
    return records, bad


def split_records(
    records: List[Dict[str, Any]],
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """(events, metrics): stamped run events vs per-step metric records."""
    events = [r for r in records if "event" in r and "t_wall" in r]
    metrics = [r for r in records if "step_ms" in r]
    return events, metrics


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def step_time_stats(metrics: List[Dict[str, Any]], bins: int = 10) -> Dict[str, Any]:
    vals = sorted(
        float(r["step_ms"]) for r in metrics
        if isinstance(r.get("step_ms"), (int, float))
    )
    if not vals:
        return {"count": 0}
    lo, hi = vals[0], vals[-1]
    width = (hi - lo) / bins if hi > lo else 1.0
    counts = [0] * bins
    for v in vals:
        counts[min(bins - 1, int((v - lo) / width))] += 1
    return {
        "count": len(vals),
        "mean_ms": sum(vals) / len(vals),
        "p50_ms": _percentile(vals, 0.50),
        "p90_ms": _percentile(vals, 0.90),
        "max_ms": hi,
        "histogram": [
            {"lo_ms": lo + i * width, "hi_ms": lo + (i + 1) * width, "count": c}
            for i, c in enumerate(counts)
        ],
    }


def timeline(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Chronological notable events, timestamped relative to the first."""
    stamped = sorted(events, key=lambda e: e["t_wall"])
    if not stamped:
        return []
    t0 = stamped[0]["t_wall"]
    out = []
    for e in stamped:
        if e["event"] not in _NOTABLE:
            continue
        entry = {"t_rel_s": round(e["t_wall"] - t0, 3), "event": e["event"]}
        for key in (
            "step", "dur_s", "to_step", "why", "rc", "exit_reason",
            "anomaly", "fault",
        ):
            if key in e:
                entry[key] = e[key]
        out.append(entry)
    return out


# -- serving trace analysis (--trace / --slo) ------------------------------

# Span names the request tracer emits (tracing.RequestTrace) beside the root
# and terminal; the segment decomposition below keys on them.
_SEGMENT_SPANS = ("req.queue", "req.admission", "req.prefill",
                  "req.prefill_chunk", "req.window")


def load_trace(path: str) -> Dict[str, Any]:
    """Load a Chrome trace-event JSON export (SpanRecorder.to_chrome_trace
    shape: {"traceEvents": [...], "otherData": {...}})."""
    with open(path) as f:
        obj = json.load(f)
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError(f"{path}: not a Chrome trace export (no traceEvents)")
    return obj


def _union_s(intervals: List[Tuple[float, float]]) -> float:
    """Total length (seconds) of the union of [t0, t1] intervals in µs —
    decode windows OVERLAP under deep pipelining, so summing their
    durations would double-count device time the request shared."""
    total = 0.0
    end = float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total / 1e6


def request_waterfall(trace_id: str, spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One request's latency decomposition. Segments sum to the root e2e
    exactly: decode is the UNION of the (possibly overlapping) window
    intervals, host_blocked is carved out of it from the per-window
    ``host_blocked_s`` meta, and ``other`` is the residual no child span
    claims (scheduler turnaround, token reap-to-notify, SSE write).

    Cross-host traces decompose the same way: the ROUTER's root anchors
    e2e, and a worker's clock-aligned queue/prefill/window spans fill the
    segments exactly as in-process ones would (they are clipped to the
    root, so any clock-mapping slop at the edges cannot break the
    sums-to-e2e contract)."""
    root = next(
        ev for ev in spans if ev["name"] == _ROOT and not _is_remote(ev)
    )
    r0, r1 = root["ts"], root["ts"] + root["dur"]

    def clipped(name: str) -> List[Tuple[float, float]]:
        return [
            (max(ev["ts"], r0), min(ev["ts"] + ev["dur"], r1))
            for ev in spans
            if ev["name"] == name and ev["ts"] + ev["dur"] > r0 and ev["ts"] < r1
        ]

    e2e_s = root["dur"] / 1e6
    queue_s = _union_s(clipped("req.queue"))
    admission_s = _union_s(clipped("req.admission"))
    prefill_s = _union_s(clipped("req.prefill"))
    # Chunked prefill emits one span per chunk instead of one monolithic
    # req.prefill; union them into their own segment so the waterfall
    # shows how much of TTFT the chunk lane itself consumed.
    chunked_prefill_s = _union_s(clipped("req.prefill_chunk"))
    windows = [ev for ev in spans if ev["name"] == "req.window"]
    decode_union_s = _union_s(clipped("req.window"))
    host_blocked_s = min(
        decode_union_s,
        sum(float(ev["args"].get("host_blocked_s", 0.0)) for ev in windows),
    )
    claimed = (queue_s + admission_s + prefill_s + chunked_prefill_s
               + decode_union_s)
    segments = {
        "queue_s": queue_s,
        "admission_s": admission_s,
        "prefill_s": prefill_s,
        "chunked_prefill_s": chunked_prefill_s,
        "decode_s": decode_union_s - host_blocked_s,
        "host_blocked_s": host_blocked_s,
        "other_s": max(0.0, e2e_s - claimed),
    }
    first = [ev for ev in spans if ev["name"] == "req.first_token"]
    out = {
        "trace_id": trace_id,
        "status": root["args"].get("status"),
        "e2e_s": e2e_s,
        "ttft_s": (min(ev["ts"] for ev in first) - r0) / 1e6 if first else None,
        "n_windows": len(windows),
        "segments": segments,
        # >0 means child spans overlapped beyond the model (a tracer bug);
        # the acceptance bound is |error| <= 1% of e2e.
        "sum_error_s": sum(segments.values()) - e2e_s,
    }
    return out


def _tail(vals: List[float]) -> Dict[str, float]:
    """Bucket-estimated tail percentiles via the SAME histogram class the
    live /metrics endpoint uses — the offline report and the dashboard
    quantiles disagree only by bucket width, never by method."""
    h = Histogram("tail", {}, buckets=DEFAULT_LATENCY_BUCKETS)
    for v in vals:
        h.observe(v)
    if not vals:
        return {}
    return {q: h.percentile(p) for q, p in
            (("p50", 0.50), ("p90", 0.90), ("p99", 0.99))}


def build_slo_report(
    trace: Dict[str, Any],
    *,
    slo_ttft_s: float = 0.0,
    slo_e2e_s: float = 0.0,
) -> Dict[str, Any]:
    """Fold a trace export into the per-request SLO attribution view."""
    groups = group_request_spans(trace)
    problems: List[str] = []
    waterfalls: List[Dict[str, Any]] = []
    for trace_id, spans in sorted(groups.items()):
        ps = check_trace_tree(trace_id, spans)
        problems.extend(ps)
        if any(ev["name"] == _ROOT and not _is_remote(ev) for ev in spans):
            waterfalls.append(request_waterfall(trace_id, spans))
    waterfalls.sort(key=lambda w: w["e2e_s"], reverse=True)

    def _missed(w: Dict[str, Any]) -> Optional[str]:
        if w["status"] != "done":
            return f"status={w['status']}"
        if slo_ttft_s > 0 and (w["ttft_s"] is None or w["ttft_s"] > slo_ttft_s):
            return f"ttft {w['ttft_s']:.3f}s > {slo_ttft_s}s" if w["ttft_s"] \
                is not None else "no first token"
        if slo_e2e_s > 0 and w["e2e_s"] > slo_e2e_s:
            return f"e2e {w['e2e_s']:.3f}s > {slo_e2e_s}s"
        return None

    misses = []
    for w in waterfalls:
        why = _missed(w)
        if why is None:
            continue
        dominant = max(w["segments"], key=lambda k: w["segments"][k])
        misses.append({**w, "why": why, "dominant_segment": dominant})
    done = [w for w in waterfalls if w["status"] == "done"]
    dropped = int((trace.get("otherData") or {}).get("dropped_spans", 0))
    return {
        "n_traces": len(groups),
        "n_done": len(done),
        "statuses": {
            s: sum(1 for w in waterfalls if w["status"] == s)
            for s in sorted({w["status"] for w in waterfalls} - {None})
        },
        "slo": {"ttft_s": slo_ttft_s, "e2e_s": slo_e2e_s},
        "misses": misses,
        "waterfalls": waterfalls,
        "tails": {
            "e2e_s": _tail([w["e2e_s"] for w in done]),
            "ttft_s": _tail([w["ttft_s"] for w in done if w["ttft_s"] is not None]),
        },
        "max_sum_error_s": max(
            (abs(w["sum_error_s"]) for w in waterfalls), default=0.0
        ),
        "dropped_spans": dropped,
        "problems": problems,
    }


_SEG_ORDER = ("queue_s", "admission_s", "prefill_s", "chunked_prefill_s",
              "decode_s", "host_blocked_s", "other_s")


def print_slo_report(report: Dict[str, Any]) -> None:
    print("== serving slo ==")
    print(
        f"traces={report['n_traces']} done={report['n_done']} "
        f"statuses={report['statuses']}"
    )
    for metric, tails in report["tails"].items():
        if tails:
            print(
                f"  {metric:<8} " + " ".join(
                    f"{q}={v:.4f}s" for q, v in tails.items()
                )
            )
    if report["dropped_spans"]:
        print(
            f"!! trace is INCOMPLETE: {report['dropped_spans']} spans "
            f"dropped at record time — waterfalls below may be partial",
        )
    print("== waterfalls (slowest first) ==")
    hdr = "  trace_id      status     e2e_s " + " ".join(
        f"{s[:-2]:>9}" for s in _SEG_ORDER
    )
    print(hdr)
    for w in report["waterfalls"][:20]:
        segs = " ".join(f"{w['segments'][s]:9.4f}" for s in _SEG_ORDER)
        print(
            f"  {w['trace_id'][:12]:<12} {w['status'] or '?':<9} "
            f"{w['e2e_s']:6.3f} {segs}"
        )
    if len(report["waterfalls"]) > 20:
        print(f"  ... {len(report['waterfalls']) - 20} more")
    if report["misses"]:
        print("== slo misses: why ==")
        for m in report["misses"]:
            seg = m["dominant_segment"]
            print(
                f"  {m['trace_id'][:12]:<12} {m['why']:<28} dominant="
                f"{seg[:-2]} ({m['segments'][seg]:.3f}s of {m['e2e_s']:.3f}s)"
            )
    elif report["slo"]["ttft_s"] or report["slo"]["e2e_s"]:
        print("== slo misses: none ==")
    for p in report["problems"]:
        print(f"!! {p}")


# -- cross-host trace analysis (--fleet-trace) ------------------------------

# Slack added to each span's recorded clock error bound when checking
# containment: covers send/receive latency between the router stamping the
# attempt edges and the worker stamping its own spans.
_ALIGN_SLACK_S = 0.002


def build_fleet_trace_report(
    trace: Dict[str, Any],
    events: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Fold a merged cross-host trace into the fleet-trace view.

    Each request is a LINEAGE TREE: the router's root span anchors e2e,
    every placement attempt is a ``req.attempt`` child tagged (replica,
    fence, redrive), and a worker that served an attempt contributes a
    clock-aligned subtree ingested over the span-export frame. The
    decomposition here is ACROSS attempts and sums to the root e2e by
    construction: placement (root start to first attempt), the union of
    attempt intervals, inter-attempt gaps (the redrive/partition-detection
    dead time — joined to ``redrive``/``lease_expired`` events when an
    events JSONL rides along), and finish (last attempt to terminal).

    Problems (all strict): a span the ingester could not clock-align
    (``unaligned`` meta — no offset estimate existed yet), a worker
    subtree root orphaned from its attempt, a worker span lying outside
    its attempt's window by more than its recorded clock error bound
    (+ a small send-latency slack), a worker-span group with no router
    root at all, and an attempt-union/e2e sum error > 1%. Remote CHILD
    spans whose subtree root never arrived are honest loss, not a lie —
    a partitioned worker's root dies with the fenced connection while
    earlier export batches already shipped some children — so they are
    counted (``n_stray_spans``), excluded from alignment, never strict.
    """
    groups = group_request_spans(trace)
    events = events or []
    redrive_ev = [e for e in events if e.get("event") == "redrive"]
    lease_ev = [e for e in events if e.get("event") == "lease_expired"]
    problems: List[str] = []
    requests: List[Dict[str, Any]] = []
    n_worker_spans = 0
    n_unaligned = 0
    n_stray_spans = 0
    max_clock_err_s = 0.0
    for trace_id, spans in sorted(groups.items()):
        short = trace_id[:12]
        local = [ev for ev in spans if not _is_remote(ev)]
        remote = [ev for ev in spans if _is_remote(ev)]
        n_worker_spans += len(remote)
        for ev in remote:
            err = ev["args"].get("clock_err_s")
            if err is not None:
                max_clock_err_s = max(max_clock_err_s, float(err))
            if ev["args"].get("unaligned"):
                n_unaligned += 1
                problems.append(
                    f"trace {short}: unalignable worker span "
                    f"{ev['name']!r} (replica {ev['args'].get('worker')}: "
                    f"no clock offset estimate at ingest)"
                )
        roots = [ev for ev in local if ev["name"] == _ROOT]
        if len(roots) != 1:
            problems.append(
                f"trace {short}: {len(roots)} router root spans (want 1) "
                f"— worker spans cannot join a lineage tree"
            )
            continue
        root = roots[0]
        r0, r1 = float(root["ts"]), float(root["ts"]) + float(root["dur"])
        e2e_s = float(root["dur"]) / 1e6
        attempts = sorted(
            (ev for ev in local if ev["name"] == _ATTEMPT),
            key=lambda ev: float(ev["ts"]),
        )
        attempt_by_sid = {ev["args"].get("span_id"): ev for ev in attempts}

        # Worker subtree -> owning attempt (remote roots parent to the
        # attempt's span_id; other remote spans parent to a remote root).
        subtree_attempt: Dict[Any, Dict[str, Any]] = {}
        for ev in remote:
            if ev["name"] != _ROOT:
                continue
            att = attempt_by_sid.get(ev["args"].get("parent_span_id"))
            if att is None:
                problems.append(
                    f"trace {short}: worker subtree (replica "
                    f"{ev['args'].get('worker')}) orphaned — its parent "
                    f"attempt span is missing from the tree"
                )
            else:
                subtree_attempt[ev["args"].get("span_id")] = att

        def _owning_attempt(ev: Dict[str, Any]) -> Optional[Dict[str, Any]]:
            if ev["name"] == _ROOT:
                return subtree_attempt.get(ev["args"].get("span_id"))
            return subtree_attempt.get(ev["args"].get("parent_span_id"))

        # Clock-alignment acceptance: every aligned worker span must lie
        # inside its attempt's window, within the error bound recorded at
        # ingest (the live min-RTT estimate) plus the send-latency slack.
        for ev in remote:
            if ev["args"].get("unaligned"):
                continue
            att = _owning_attempt(ev)
            if att is None:
                if ev["name"] != _ROOT:
                    # Stray child: its subtree root never arrived (lost
                    # behind a fenced partition after earlier batches
                    # shipped the child) — counted, not strict.
                    n_stray_spans += 1
                continue
            tol_us = (
                float(ev["args"].get("clock_err_s", 0.0)) + _ALIGN_SLACK_S
            ) * 1e6
            a0, a1 = float(att["ts"]), float(att["ts"]) + float(att["dur"])
            if (float(ev["ts"]) < a0 - tol_us
                    or float(ev["ts"]) + float(ev["dur"]) > a1 + tol_us):
                problems.append(
                    f"trace {short}: worker span {ev['name']!r} lies "
                    f"outside its attempt window by more than the clock "
                    f"error bound ({ev['args'].get('clock_err_s', 0.0)}s)"
                )

        # Cross-attempt decomposition: merge the (clipped) attempt
        # intervals, then placement/attempts/gaps/finish sum to e2e.
        ivs = sorted(
            (max(float(ev["ts"]), r0),
             min(float(ev["ts"]) + float(ev["dur"]), r1))
            for ev in attempts
            if float(ev["ts"]) < r1 and float(ev["ts"]) + float(ev["dur"]) > r0
        )
        merged: List[List[float]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        attempts_s = sum(e - s for s, e in merged) / 1e6
        placement_s = (merged[0][0] - r0) / 1e6 if merged else e2e_s
        finish_s = (r1 - merged[-1][1]) / 1e6 if merged else 0.0
        gaps: List[Dict[str, Any]] = []
        for (_, g0), (g1, _) in zip(merged, merged[1:]):
            causes = []
            for ev in redrive_ev:
                if (ev.get("trace_id") == trace_id
                        and g0 / 1e6 - 0.5 <= float(ev.get("t_wall", 0.0))
                        <= g1 / 1e6 + 0.5):
                    causes.append(f"redrive:{ev.get('reason', '?')}")
            for ev in lease_ev:
                if g0 / 1e6 - 0.5 <= float(ev.get("t_wall", 0.0)) \
                        <= g1 / 1e6 + 0.5:
                    causes.append(
                        f"partition_detect:lease_expired"
                        f"(replica {ev.get('replica')})"
                    )
            gaps.append({
                "t_rel_s": (g0 - r0) / 1e6,
                "dur_s": (g1 - g0) / 1e6,
                "causes": causes,
            })
        gap_s = sum(g["dur_s"] for g in gaps)
        sum_error_s = (placement_s + attempts_s + gap_s + finish_s) - e2e_s
        if e2e_s > 0 and abs(sum_error_s) > 0.01 * e2e_s:
            problems.append(
                f"trace {short}: cross-host segments sum to "
                f"{placement_s + attempts_s + gap_s + finish_s:.4f}s but "
                f"e2e is {e2e_s:.4f}s (error > 1%)"
            )

        att_rows = []
        for ev in attempts:
            sid = ev["args"].get("span_id")
            sub = [
                rv for rv in remote
                if _owning_attempt(rv) is attempt_by_sid.get(sid)
            ]
            att_rows.append({
                "outcome": ev["args"].get("outcome"),
                "replica": ev["args"].get("replica"),
                "fence": ev["args"].get("fence"),
                "redrive": ev["args"].get("redrive"),
                "t_rel_s": (float(ev["ts"]) - r0) / 1e6,
                "dur_s": float(ev["dur"]) / 1e6,
                "worker_spans": len(sub),
                "worker_decode_s": _union_s([
                    (float(rv["ts"]), float(rv["ts"]) + float(rv["dur"]))
                    for rv in sub if rv["name"] == "req.window"
                ]),
                "clock_err_s": max(
                    (float(rv["args"].get("clock_err_s", 0.0))
                     for rv in sub), default=None,
                ) if sub else None,
            })
        requests.append({
            "trace_id": trace_id,
            "status": root["args"].get("status"),
            "redrives": root["args"].get("redrives"),
            "e2e_s": e2e_s,
            "segments": {
                "placement_s": placement_s,
                "attempts_s": attempts_s,
                "redrive_gap_s": gap_s,
                "finish_s": finish_s,
            },
            "sum_error_s": sum_error_s,
            "attempts": att_rows,
            "gaps": gaps,
        })
    requests.sort(key=lambda r: r["e2e_s"], reverse=True)
    return {
        "n_requests": len(requests),
        "n_attempts": sum(len(r["attempts"]) for r in requests),
        "n_worker_spans": n_worker_spans,
        "n_unaligned": n_unaligned,
        "n_stray_spans": n_stray_spans,
        "max_clock_err_s": max_clock_err_s,
        "redriven_requests": sum(
            1 for r in requests if len(r["attempts"]) > 1
        ),
        "requests": requests,
        "problems": problems,
    }


def print_fleet_trace_report(report: Dict[str, Any]) -> None:
    print("== fleet trace ==")
    print(
        f"requests={report['n_requests']} attempts={report['n_attempts']} "
        f"worker_spans={report['n_worker_spans']} "
        f"unaligned={report['n_unaligned']} "
        f"stray={report['n_stray_spans']} "
        f"max_clock_err={report['max_clock_err_s'] * 1e3:.3f}ms "
        f"redriven={report['redriven_requests']}"
    )
    for r in report["requests"][:20]:
        seg = r["segments"]
        print(
            f"  {r['trace_id'][:12]:<12} {r['status'] or '?':<9} "
            f"e2e={r['e2e_s']:.3f}s placement={seg['placement_s']:.4f}s "
            f"attempts={seg['attempts_s']:.4f}s "
            f"gaps={seg['redrive_gap_s']:.4f}s "
            f"finish={seg['finish_s']:.4f}s "
            f"(err={r['sum_error_s']:+.4f}s)"
        )
        for a in r["attempts"]:
            err = (
                f" clock_err={a['clock_err_s'] * 1e3:.3f}ms"
                if a["clock_err_s"] is not None else ""
            )
            print(
                f"    attempt r{a['replica']} g{a['fence']} "
                f"#{a['redrive']}: {a['outcome'] or '?':<11} "
                f"+{a['t_rel_s']:.4f}s {a['dur_s']:.4f}s "
                f"worker_spans={a['worker_spans']} "
                f"decode={a['worker_decode_s']:.4f}s{err}"
            )
        for g in r["gaps"]:
            why = " ".join(g["causes"]) or "?"
            print(
                f"    gap +{g['t_rel_s']:.4f}s {g['dur_s']:.4f}s <- {why}"
            )
    if len(report["requests"]) > 20:
        print(f"  ... {len(report['requests']) - 20} more")
    for p in report["problems"]:
        print(f"!! {p}")


_TERMINAL_EVENTS = ("req_done", "req_cancelled", "req_expired", "req_error")


def prefix_cache_summary(
    events: List[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """Fold terminal request events into the prefix-cache view: hit rate
    over requests that reached the engine and total prompt tokens served
    from cache instead of prefill. ``cached_tokens`` only appears in
    terminal events when the engine ran with the cache on (it accumulates
    across preemption re-admissions), so absence means no section."""
    term = [
        e for e in events
        if e.get("event") in _TERMINAL_EVENTS and "cached_tokens" in e
    ]
    if not term:
        return None
    hit = sum(1 for e in term if int(e["cached_tokens"]) > 0)
    return {
        "requests": len(term),
        "hit_requests": hit,
        "hit_rate": hit / len(term),
        "prefill_tokens_saved": sum(int(e["cached_tokens"]) for e in term),
    }


# -- capacity attribution (--capacity) --------------------------------------

_CAP_SEGMENTS = ("productive", "admission_starved", "pool_starved",
                 "preempted_rework", "spec_wasted")


def build_capacity_report(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold ``cap_window`` + ``decision`` events into the capacity view:
    decode-slot-seconds decomposed into segments that sum to wall time,
    the run's binding constraint, and decision records joined to traces.

    The engine dispatches windows sequentially and reaps them FIFO, so
    ``cap_window`` records (stamped at reap with perf_counter dispatch/
    reap times) arrive in dispatch order; under deep pipelining
    consecutive windows OVERLAP, so each window is charged only its NEW
    coverage (``d_eff``, the same interval-union idea as ``_union_s``)
    and the residual gaps are host time between device windows. Within a
    window's coverage: the active-row share splits into productive
    (committed tokens) vs. spec-wasted (dispatched slot-tokens never
    committed — rejected speculative drafts or overrun past stop/
    max_new); the idle-row share is pool-starved when requests were
    waiting (rows existed to fill, blocks did not) and admission-starved
    when the queue was empty. Gaps split by the rework fraction of the
    prefill they contain (recompute-on-resume re-prefill is pure
    preemption cost); the remainder follows the same waiting test. Every
    charge is a disjoint share of [first dispatch, last reap], so the
    segments sum to wall time by construction — the strict gate checks
    the arithmetic anyway."""
    wins = sorted(
        (e for e in events if e.get("event") == "cap_window"),
        key=lambda e: (float(e["t_dispatch_s"]), float(e["t_reap_s"])),
    )
    decisions = [e for e in events if e.get("event") == "decision"]
    decision_counts: Dict[str, int] = {}
    for d in decisions:
        k = d.get("decision", "?")
        decision_counts[k] = decision_counts.get(k, 0) + 1

    # Join decisions to the request stream: every trace_id a decision
    # carries must name a request the req_* events know about.
    known = {
        e["trace_id"] for e in events
        if str(e.get("event", "")).startswith("req_") and e.get("trace_id")
    }
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    problems: List[str] = []
    for d in decisions:
        tid = d.get("trace_id")
        if not tid:
            continue
        by_trace.setdefault(tid, []).append(
            {k: v for k, v in d.items()
             if k not in ("event", "seq", "t_wall", "t_mono")}
        )
        if tid not in known:
            problems.append(
                f"decision {d.get('decision')} carries trace_id "
                f"{tid[:12]} with no matching req_* event"
            )

    report: Dict[str, Any] = {
        "n_windows": len(wins),
        "decisions": decision_counts,
        "decisions_by_trace": by_trace,
        "problems": problems,
    }
    if not wins:
        problems.append("no cap_window events (capacity sampling off?)")
        return report

    rows_cap = int(wins[0]["rows_capacity"])
    t0 = min(float(w["t_dispatch_s"]) for w in wins)
    t1 = max(float(w["t_reap_s"]) for w in wins)
    wall = t1 - t0
    segments = dict.fromkeys(_CAP_SEGMENTS, 0.0)
    slot_bound_s = 0.0
    admission_saturated = decision_counts.get("reject_busy", 0) > 0
    cover_end = t0
    prev_waiting = 0
    prev_prefill = prev_rework = None
    for w in wins:
        t_d, t_r = float(w["t_dispatch_s"]), float(w["t_reap_s"])
        cum_prefill = int(w.get("cum_prefill_tokens", 0))
        cum_rework = int(w.get("cum_rework_prefill_tokens", 0))
        gap = max(0.0, t_d - cover_end)
        if gap > 0.0:
            dp = cum_prefill - (prev_prefill or 0)
            dr = cum_rework - (prev_rework or 0)
            rework_frac = min(1.0, dr / dp) if dp > 0 else 0.0
            segments["preempted_rework"] += gap * rework_frac
            rest = gap * (1.0 - rework_frac)
            if prev_waiting > 0 or dp > 0:
                # Host between windows with real work queued (or fresh
                # prefill landing): scheduling/prefill of useful tokens.
                segments["productive"] += rest
            else:
                segments["admission_starved"] += rest
        d_eff = max(0.0, t_r - max(t_d, cover_end))
        cover_end = max(cover_end, t_r)
        rows = int(w["rows"])
        slot_tokens = rows * int(w["steps"])
        committed = min(int(w["tokens_committed"]), slot_tokens)
        frac = committed / slot_tokens if slot_tokens else 0.0
        active_s = d_eff * rows / rows_cap if rows_cap else 0.0
        segments["productive"] += active_s * frac
        segments["spec_wasted"] += active_s * (1.0 - frac)
        idle_s = max(0.0, d_eff - active_s)
        waiting = int(w["waiting"])
        if waiting > 0:
            segments["pool_starved"] += idle_s
            if rows >= rows_cap:
                slot_bound_s += d_eff
        else:
            segments["admission_starved"] += idle_s
        limit = w.get("admission_depth_limit")
        if limit and int(w.get("admission_depth", 0)) >= int(limit):
            admission_saturated = True
        prev_waiting = waiting
        prev_prefill, prev_rework = cum_prefill, cum_rework

    total = sum(segments.values())
    pool_bound_s = segments["pool_starved"] + segments["preempted_rework"]
    scores = {
        "slots": slot_bound_s,
        "pool_blocks": pool_bound_s,
        "admission_budget":
            segments["admission_starved"] if admission_saturated else 0.0,
        "arrival_rate":
            0.0 if admission_saturated else segments["admission_starved"],
    }
    report.update({
        "rows_capacity": rows_cap,
        "pool_total": int(wins[0].get("pool_total", 0)),
        "wall_s": wall,
        "segments": segments,
        "sum_error_s": total - wall,
        "binding_constraint": max(scores, key=lambda k: scores[k]),
        "constraint_scores": scores,
    })
    if wall > 0 and abs(total - wall) > 0.01 * wall:
        problems.append(
            f"capacity segments sum to {total:.4f}s but wall is "
            f"{wall:.4f}s (error {abs(total - wall) / wall:.2%} > 1%)"
        )
    return report


def print_capacity_report(report: Dict[str, Any]) -> None:
    print("== capacity ==")
    if "segments" not in report:
        print("no cap_window events")
    else:
        wall = report["wall_s"]
        print(
            f"wall={wall:.3f}s windows={report['n_windows']} "
            f"rows_capacity={report['rows_capacity']} "
            f"pool_blocks={report['pool_total']}"
        )
        for seg in _CAP_SEGMENTS:
            sec = report["segments"][seg]
            pct = 100.0 * sec / wall if wall > 0 else 0.0
            bar = "#" * int(round(pct / 2))
            print(f"  {seg:<17} {sec:9.3f}s {pct:5.1f}% {bar}")
        print(
            f"sum_error={report['sum_error_s']:+.4f}s  binding constraint: "
            f"{report['binding_constraint']} (" + " ".join(
                f"{k}={v:.3f}s"
                for k, v in report["constraint_scores"].items()
            ) + ")"
        )
    if report["decisions"]:
        print("== scheduler decisions ==")
        for kind, n in sorted(report["decisions"].items()):
            print(f"  {kind:<18} {n}")
    if report["decisions_by_trace"]:
        print("== decisions by trace (why was my request shed?) ==")
        items = sorted(report["decisions_by_trace"].items())
        for tid, recs in items[:20]:
            kinds = " ".join(
                r.get("decision", "?") + (
                    f"(-{r['blocks_reclaimed']}blk)"
                    if "blocks_reclaimed" in r else ""
                )
                for r in recs
            )
            print(f"  {tid[:12]:<12} {kinds}")
        if len(items) > 20:
            print(f"  ... {len(items) - 20} more")
    for p in report["problems"]:
        print(f"!! {p}")


# -- fleet attribution (--fleet) --------------------------------------------


def build_fleet_report(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the fleet event streams into the router view:

      conservation  every ``fleet_req_submit`` frid must reach exactly one
                    ``fleet_req_terminal`` — the zero-lost-requests
                    invariant a crash/drain drill is asserting (strict);
      per-replica   request waterfalls from the replica-tagged ``req_*``
                    streams: what each replica accepted, finished, failed
                    (its loop died mid-decode) — failure here is NORMAL
                    fleet operation as long as conservation holds;
      redrive cost  how many requests failed over, the committed-token
                    frontier they carried (tokens NOT regenerated), and
                    the e2e penalty vs. undisturbed requests;
      recovery      per-replica lifecycle from ``replica_state`` events:
                    active -> ejected/draining -> active, with the
                    out-of-service interval measured from the bus clock.
    """
    submits = [e for e in events if e.get("event") == "fleet_req_submit"]
    terms = [e for e in events if e.get("event") == "fleet_req_terminal"]
    redrives = [e for e in events if e.get("event") == "redrive"]
    states = [e for e in events if e.get("event") == "replica_state"]
    brownouts = [e for e in events if e.get("event") == "brownout"]

    problems: List[str] = []
    sub_frids: Dict[Any, Dict[str, Any]] = {}
    for e in submits:
        frid = e.get("frid")
        if frid in sub_frids:
            problems.append(f"duplicate fleet_req_submit for frid {frid}")
        sub_frids[frid] = e
    term_frids: Dict[Any, Dict[str, Any]] = {}
    for e in terms:
        frid = e.get("frid")
        if frid in term_frids:
            problems.append(f"duplicate fleet_req_terminal for frid {frid}")
        term_frids[frid] = e
    lost = sorted(set(sub_frids) - set(term_frids))
    for frid in lost:
        problems.append(
            f"LOST request: frid {frid} submitted but never reached a "
            f"terminal (conservation violated)"
        )
    for frid in sorted(set(term_frids) - set(sub_frids)):
        problems.append(
            f"orphan fleet_req_terminal for frid {frid} (no submit)"
        )
    for e in redrives:
        if e.get("frid") not in sub_frids:
            problems.append(
                f"redrive references unknown frid {e.get('frid')}"
            )

    status_counts: Dict[str, int] = {}
    for e in terms:
        s = str(e.get("status", "?"))
        status_counts[s] = status_counts.get(s, 0) + 1

    # Per-replica waterfalls from the replica-tagged EngineLoop streams.
    per_replica: Dict[int, Dict[str, int]] = {}

    def _rep_slot(r: Any) -> Dict[str, int]:
        return per_replica.setdefault(
            int(r),
            {"submits": 0, "done": 0, "errors": 0, "expired": 0,
             "cancelled": 0, "tokens": 0, "redrives_in": 0,
             "redrives_out": 0},
        )

    for e in events:
        r = e.get("replica")
        if r is None:
            continue
        kind = e.get("event")
        if kind == "req_submit":
            _rep_slot(r)["submits"] += 1
        elif kind == "req_done":
            slot = _rep_slot(r)
            slot["done"] += 1
            slot["tokens"] += int(e.get("n_tokens", 0))
        elif kind == "req_error":
            _rep_slot(r)["errors"] += 1
        elif kind == "req_expired":
            _rep_slot(r)["expired"] += 1
        elif kind == "req_cancelled":
            _rep_slot(r)["cancelled"] += 1
    for e in redrives:
        if e.get("from_replica") is not None:
            _rep_slot(e["from_replica"])["redrives_out"] += 1
        if e.get("to_replica") is not None:
            _rep_slot(e["to_replica"])["redrives_in"] += 1

    # Redrive cost: the committed frontier carried over is decode work the
    # failover did NOT repeat; the e2e delta vs undisturbed is what it cost.
    redriven_e2e = sorted(
        float(e["e2e_s"]) for e in terms
        if int(e.get("redrives", 0)) > 0 and e.get("e2e_s") is not None
    )
    clean_e2e = sorted(
        float(e["e2e_s"]) for e in terms
        if int(e.get("redrives", 0)) == 0 and e.get("e2e_s") is not None
    )
    redrive_cost = {
        "redriven_requests": sum(
            1 for e in terms if int(e.get("redrives", 0)) > 0
        ),
        "redrive_events": len(redrives),
        "tokens_carried_over": sum(
            int(e.get("n_committed", 0)) for e in redrives
        ),
        "reasons": {},
        "e2e_p50_redriven_s": _percentile(redriven_e2e, 0.50),
        "e2e_p50_clean_s": _percentile(clean_e2e, 0.50),
    }
    for e in redrives:
        rs = str(e.get("reason", "?"))
        redrive_cost["reasons"][rs] = redrive_cost["reasons"].get(rs, 0) + 1

    # Recovery: replica_state transitions, out-of-service span per incident.
    lifecycle: Dict[int, List[Dict[str, Any]]] = {}
    for e in sorted(states, key=lambda e: float(e.get("t_mono", 0.0))):
        lifecycle.setdefault(int(e.get("replica", -1)), []).append({
            "t_mono": float(e.get("t_mono", 0.0)),
            "state": e.get("state"),
            "reason": e.get("reason"),
            "generation": e.get("generation"),
        })
    incidents: List[Dict[str, Any]] = []
    for rep, trail in lifecycle.items():
        down_at: Optional[Dict[str, Any]] = None
        for rec in trail:
            if rec["state"] in ("ejected", "draining") and down_at is None:
                down_at = rec
            elif rec["state"] == "active" and down_at is not None:
                incidents.append({
                    "replica": rep,
                    "kind": down_at["state"],
                    "reason": down_at["reason"],
                    "recovery_s": rec["t_mono"] - down_at["t_mono"],
                })
                down_at = None
        if down_at is not None:
            incidents.append({
                "replica": rep,
                "kind": down_at["state"],
                "reason": down_at["reason"],
                "recovery_s": None,  # still down at end of log
            })

    # Out-of-process workers: join each unclean worker death to the
    # redrives it caused and the replica_state recovery that followed —
    # the incident story ACROSS a real process boundary. Clean exits
    # (drain/shutdown/upgrade teardown) are routine and not incidents.
    w_spawns = [e for e in events if e.get("event") == "worker_spawn"]
    w_exits = [e for e in events if e.get("event") == "worker_exit"]
    w_conn_lost = [e for e in events if e.get("event") == "worker_conn_lost"]
    rpc_retry_ev = [e for e in events if e.get("event") == "rpc_retry"]
    process_deaths: List[Dict[str, Any]] = []
    for e in w_exits:
        if e.get("clean"):
            continue
        rep = int(e.get("replica", -1))
        t0 = float(e.get("t_mono", 0.0))
        recovery = next(
            (
                s for s in sorted(
                    states, key=lambda s: float(s.get("t_mono", 0.0))
                )
                if int(s.get("replica", -2)) == rep
                and s.get("state") == "active"
                and float(s.get("t_mono", 0.0)) > t0
            ),
            None,
        )
        t_end = (
            float(recovery.get("t_mono", 0.0))
            if recovery is not None else float("inf")
        )
        # conn-loss detection can precede the reaped exit by a beat; give
        # the join a small backwards grace window.
        caused = [
            r for r in redrives
            if r.get("from_replica") == rep
            and t0 - 1.0 <= float(r.get("t_mono", 0.0)) <= t_end
        ]
        process_deaths.append({
            "replica": rep,
            "pid": e.get("pid"),
            "returncode": e.get("returncode"),
            "redrives_caused": len(caused),
            "tokens_carried_over": sum(
                int(r.get("n_committed", 0)) for r in caused
            ),
            "recovered_in_s": (
                float(recovery.get("t_mono", 0.0)) - t0
                if recovery is not None else None
            ),
            "respawned": any(
                int(s.get("replica", -2)) == rep
                and float(s.get("t_mono", 0.0)) > t0
                for s in w_spawns
            ),
        })
    workers = None
    if w_spawns or w_exits or w_conn_lost or rpc_retry_ev:
        workers = {
            "spawns": len(w_spawns),
            "exits_clean": sum(1 for e in w_exits if e.get("clean")),
            "exits_unclean": sum(1 for e in w_exits if not e.get("clean")),
            "conn_lost": len(w_conn_lost),
            "rpc_retries": len(rpc_retry_ev),
            "process_deaths": process_deaths,
        }

    # Rolling upgrades: every refusal must be followed by a rollback that
    # restored the old weights — a refused upgrade that left the replica
    # on the new (probe-failing) checkpoint is the one unacceptable end
    # state, so it is strict.
    up_starts = [e for e in events if e.get("event") == "upgrade_start"]
    up_vetted = [e for e in events if e.get("event") == "upgrade_vetted"]
    up_refused = [e for e in events if e.get("event") == "upgrade_refused"]
    up_rolled = [e for e in events if e.get("event") == "upgrade_rolled_back"]
    for e in up_refused:
        rep = e.get("replica")
        t0 = float(e.get("t_mono", 0.0))
        rb = next(
            (
                r for r in up_rolled
                if r.get("replica") == rep
                and float(r.get("t_mono", 0.0)) >= t0
            ),
            None,
        )
        if rb is None:
            problems.append(
                f"upgrade_refused on replica {rep} has no matching "
                f"upgrade_rolled_back (replica left in limbo)"
            )
    upgrades = None
    if up_starts or up_refused or up_rolled:
        upgrades = {
            "started": len(up_starts),
            "vetted": len(up_vetted),
            "refused": len(up_refused),
            "rolled_back": len(up_rolled),
            "restored": sum(1 for e in up_rolled if e.get("restored")),
        }

    # Partitions: join each injected blackhole to the mechanism that
    # detected it — lease expiry (the router stopped hearing heartbeats)
    # or a fence drop (stale-generation frames arrived after heal) —
    # and to the redrives it caused. An injected partition that NOTHING
    # detected means a worker can stream stale tokens unnoticed, which
    # is the one unacceptable end state, so it is strict.
    p_inject = [e for e in events if e.get("event") == "partition_injected"]
    p_heal = [e for e in events if e.get("event") == "partition_healed"]
    leases = [e for e in events if e.get("event") == "lease_expired"]
    fenced = [e for e in events if e.get("event") == "fenced_frames_dropped"]
    f_bumps = [e for e in events if e.get("event") == "fence_bump"]
    j_replays = [e for e in events if e.get("event") == "journal_replay"]
    partitions = None
    if p_inject or p_heal or leases or fenced:
        part_incidents: List[Dict[str, Any]] = []
        for e in p_inject:
            rep = int(e.get("replica", -1))
            t0 = float(e.get("t_mono", 0.0))
            # Detection events carry their own bus timestamps; give the
            # join a small backwards grace window for clock skew between
            # the injector thread and the health/reader threads.
            lease_hit = next(
                (
                    le for le in sorted(
                        leases, key=lambda x: float(x.get("t_mono", 0.0))
                    )
                    if int(le.get("replica", -2)) == rep
                    and float(le.get("t_mono", 0.0)) >= t0 - 1.0
                ),
                None,
            )
            fence_hit = next(
                (
                    fe for fe in sorted(
                        fenced, key=lambda x: float(x.get("t_mono", 0.0))
                    )
                    if int(fe.get("replica", -2)) == rep
                    and float(fe.get("t_mono", 0.0)) >= t0 - 1.0
                ),
                None,
            )
            hits = [
                ("lease_expiry", lease_hit),
                ("fence_drop", fence_hit),
            ]
            hits = [
                (k, h) for k, h in hits if h is not None
            ]
            hits.sort(key=lambda kh: float(kh[1].get("t_mono", 0.0)))
            detected_by = hits[0][0] if hits else None
            detect_s = (
                max(0.0, float(hits[0][1].get("t_mono", 0.0)) - t0)
                if hits else None
            )
            heal = next(
                (
                    h for h in sorted(
                        p_heal, key=lambda x: float(x.get("t_mono", 0.0))
                    )
                    if int(h.get("replica", -2)) == rep
                    and float(h.get("t_mono", 0.0)) >= t0
                ),
                None,
            )
            t_end = (
                float(heal.get("t_mono", 0.0))
                if heal is not None else float("inf")
            )
            caused = [
                r for r in redrives
                if r.get("from_replica") == rep
                and t0 - 1.0 <= float(r.get("t_mono", 0.0)) <= t_end + 1.0
            ]
            if detected_by is None:
                problems.append(
                    f"UNDETECTED partition on replica {rep}: neither a "
                    f"lease expiry nor a fenced-frame drop followed the "
                    f"injection (stale tokens could stream unnoticed)"
                )
            part_incidents.append({
                "replica": rep,
                "detected_by": detected_by,
                "detect_s": detect_s,
                "healed": heal is not None,
                "redrives_caused": len(caused),
                "tokens_carried_over": sum(
                    int(r.get("n_committed", 0)) for r in caused
                ),
            })
        partitions = {
            "injected": len(p_inject),
            "healed": len(p_heal),
            "lease_expiries": len(leases),
            "fence_drop_notices": len(fenced),
            "fence_bumps": len(f_bumps),
            "incidents": part_incidents,
        }

    journal = None
    if j_replays:
        journal = {
            "replays": len(j_replays),
            "tokens_resumed_from": sum(
                int(e.get("n_committed", 0)) for e in j_replays
            ),
        }

    # Disaggregated prefill/decode: join each kv_migrate to the request
    # whose prefill it saved (saved_tokens = pages * block_size the
    # decode tier did NOT recompute), and every reject to its typed
    # refusal reason — a reasonless drop is unauditable, so it is
    # strict, as is a migration for a request the router never saw.
    migrates = [e for e in events if e.get("event") == "kv_migrate"]
    mig_rejects = [
        e for e in events if e.get("event") == "kv_migration_reject"
    ]
    kv_migration = None
    if migrates or mig_rejects:
        mig_rows: List[Dict[str, Any]] = []
        for e in migrates:
            frid = e.get("frid")
            if frid not in sub_frids:
                problems.append(
                    f"kv_migrate references unknown frid {frid}"
                )
            term = term_frids.get(frid)
            mig_rows.append({
                "frid": frid,
                "from_replica": e.get("from_replica"),
                "to_replica": e.get("to_replica"),
                "pages": int(e.get("pages", 0)),
                "bytes": int(e.get("bytes", 0)),
                "rejected": int(e.get("rejected", 0)),
                "saved_tokens": int(e.get("saved_tokens", 0)),
                "request_status": (
                    str(term.get("status")) if term is not None else None
                ),
            })
        reject_reasons: Dict[str, int] = {}
        for e in mig_rejects:
            reason = e.get("reason")
            if not reason:
                problems.append(
                    f"kv_migration_reject for frid {e.get('frid')} "
                    f"carries no reason (unauditable page drop)"
                )
            reason = str(reason or "?")
            reject_reasons[reason] = reject_reasons.get(reason, 0) + 1
        kv_migration = {
            "migrations": len(migrates),
            "pages_migrated": sum(r["pages"] for r in mig_rows),
            "bytes_migrated": sum(r["bytes"] for r in mig_rows),
            "saved_prefill_tokens": sum(
                r["saved_tokens"] for r in mig_rows
            ),
            "pages_rejected": sum(r["rejected"] for r in mig_rows),
            "reject_reasons": reject_reasons,
            "migrations_detail": mig_rows,
        }

    return {
        "n_submitted": len(submits),
        "n_terminal": len(terms),
        "lost_requests": len(lost),
        "statuses": status_counts,
        "per_replica": {str(k): v for k, v in sorted(per_replica.items())},
        "redrive_cost": redrive_cost,
        "incidents": incidents,
        "brownout_transitions": len(brownouts),
        "workers": workers,
        "upgrades": upgrades,
        "partitions": partitions,
        "journal": journal,
        "kv_migration": kv_migration,
        "problems": problems,
    }


def print_fleet_report(report: Dict[str, Any]) -> None:
    print("== fleet ==")
    print(
        f"submitted={report['n_submitted']} terminal={report['n_terminal']} "
        f"lost={report['lost_requests']} statuses={report['statuses']}"
    )
    if report["per_replica"]:
        print("== per-replica waterfall ==")
        hdr = ("replica", "submits", "done", "errors", "expired",
               "tokens", "rd_out", "rd_in")
        print("  " + " ".join(f"{h:>8}" for h in hdr))
        for rep, row in report["per_replica"].items():
            print("  " + " ".join(f"{v:>8}" for v in (
                rep, row["submits"], row["done"], row["errors"],
                row["expired"], row["tokens"], row["redrives_out"],
                row["redrives_in"],
            )))
    rc = report["redrive_cost"]
    if rc["redrive_events"]:
        print("== redrive cost ==")
        print(
            f"requests_redriven={rc['redriven_requests']} "
            f"events={rc['redrive_events']} "
            f"tokens_carried_over={rc['tokens_carried_over']}"
        )
        print(
            f"e2e_p50 redriven={rc['e2e_p50_redriven_s']:.4f}s "
            f"vs clean={rc['e2e_p50_clean_s']:.4f}s"
        )
        for reason, n in sorted(rc["reasons"].items()):
            print(f"  {reason:<40} {n}")
    if report["incidents"]:
        print("== replica incidents ==")
        for inc in report["incidents"]:
            rec = (
                f"{inc['recovery_s']:.3f}s"
                if inc["recovery_s"] is not None else "STILL DOWN"
            )
            print(
                f"  replica {inc['replica']}: {inc['kind']} "
                f"({inc['reason']}) -> recovered in {rec}"
            )
    if report["brownout_transitions"]:
        print(f"brownout transitions: {report['brownout_transitions']}")
    w = report.get("workers")
    if w:
        print("== workers ==")
        print(
            f"spawns={w['spawns']} exits_clean={w['exits_clean']} "
            f"exits_unclean={w['exits_unclean']} conn_lost={w['conn_lost']} "
            f"rpc_retries={w['rpc_retries']}"
        )
        for d in w["process_deaths"]:
            rec = (
                f"{d['recovered_in_s']:.3f}s"
                if d["recovered_in_s"] is not None else "STILL DOWN"
            )
            print(
                f"  worker death: replica {d['replica']} pid {d['pid']} "
                f"(rc={d['returncode']}) -> {d['redrives_caused']} redrives "
                f"({d['tokens_carried_over']} tokens carried), "
                f"respawned={d['respawned']}, recovered in {rec}"
            )
    u = report.get("upgrades")
    if u:
        print("== upgrades ==")
        print(
            f"started={u['started']} vetted={u['vetted']} "
            f"refused={u['refused']} rolled_back={u['rolled_back']} "
            f"restored={u['restored']}"
        )
    pt = report.get("partitions")
    if pt:
        print("== partitions ==")
        print(
            f"injected={pt['injected']} healed={pt['healed']} "
            f"lease_expiries={pt['lease_expiries']} "
            f"fence_drop_notices={pt['fence_drop_notices']} "
            f"fence_bumps={pt['fence_bumps']}"
        )
        for inc in pt["incidents"]:
            det = (
                f"{inc['detected_by']} in {inc['detect_s']:.3f}s"
                if inc["detected_by"] is not None else "UNDETECTED"
            )
            print(
                f"  partition: replica {inc['replica']} -> detected by "
                f"{det}, {inc['redrives_caused']} redrives "
                f"({inc['tokens_carried_over']} tokens carried), "
                f"healed={inc['healed']}"
            )
    j = report.get("journal")
    if j:
        print("== journal recovery ==")
        print(
            f"replays={j['replays']} "
            f"tokens_resumed_from={j['tokens_resumed_from']}"
        )
    kv = report.get("kv_migration")
    if kv:
        print("== kv migration ==")
        print(
            f"migrations={kv['migrations']} "
            f"pages={kv['pages_migrated']} "
            f"bytes={kv['bytes_migrated']} "
            f"saved_prefill_tokens={kv['saved_prefill_tokens']} "
            f"pages_rejected={kv['pages_rejected']}"
        )
        for m in kv["migrations_detail"]:
            print(
                f"  frid {m['frid']}: replica {m['from_replica']} -> "
                f"{m['to_replica']}, {m['pages']} pages "
                f"({m['bytes']} bytes), saved {m['saved_tokens']} "
                f"prefill tokens, request {m['request_status']}"
            )
        for reason, n in sorted(kv["reject_reasons"].items()):
            print(f"  rejected: {reason:<32} {n}")
    for p in report["problems"]:
        print(f"!! {p}")


# -- integrity attribution (--integrity) ------------------------------------


_CORRUPTION_KINDS = ("corrupt_kv_page", "corrupt_weights", "wrong_token")


def build_integrity_report(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the integrity sentinel's event streams into the audit view:

      detection    every corruption that actually FIRED (``fault_fired``)
                   must be answered by a detector on that replica —
                   a ``integrity_quarantine`` (probe/fingerprint verdict),
                   an ``integrity_invalid_token`` (reap guard), or an
                   ``integrity_kv_mismatch`` (verify-on-acquire) — and the
                   fire-to-detection latency is the headline number;
      exposure     tokens delivered (``req_done``) by the corrupted replica
                   between fire and detection: an UPPER bound on wrong
                   tokens served (requests not touching the corrupted
                   state are counted too — the bound is what the operator
                   can prove, not what the model emitted);
      join         each ``quarantine`` decision should carry the failing
                   probe's trace_id when tracing is on, so the verdict
                   joins to a span tree (strict);
      hygiene      a strict probe failure (completed, wrong tokens) must
                   be followed by a quarantine; a quarantine must be
                   preceded by a detector signal.
    """
    probes = [e for e in events if e.get("event") == "integrity_probe"]
    quars = [e for e in events if e.get("event") == "integrity_quarantine"]
    kv_mm = [e for e in events if e.get("event") == "integrity_kv_mismatch"]
    w_mm = [
        e for e in events if e.get("event") == "integrity_weight_mismatch"
    ]
    invalid = [
        e for e in events if e.get("event") == "integrity_invalid_token"
    ]
    fired = [
        e for e in events
        if e.get("event") == "fault_fired"
        and e.get("fault") in _CORRUPTION_KINDS
    ]
    armed = [
        e for e in events
        if e.get("event") == "fault_injected"
        and e.get("fault") in _CORRUPTION_KINDS
    ]
    quar_decisions = [
        e for e in events
        if e.get("event") == "decision" and e.get("decision") == "quarantine"
    ]
    drop_decisions = [
        e for e in events
        if e.get("event") == "decision"
        and e.get("decision") == "drop_corrupt_block"
    ]

    problems: List[str] = []

    def _t(e: Dict[str, Any]) -> float:
        return float(e.get("t_mono", 0.0))

    # Detection: first detector record on the fired replica at or after
    # the fire instant. Ejection for an IntegrityError surfaces as
    # integrity_invalid_token (reap guard), so all three streams count.
    detectors = sorted(quars + invalid + kv_mm + w_mm, key=_t)
    detections: List[Dict[str, Any]] = []
    for f in sorted(fired, key=_t):
        rep = f.get("replica")
        hit = next(
            (
                d for d in detectors
                if _t(d) >= _t(f)
                and (d.get("replica") is None or d.get("replica") == rep)
            ),
            None,
        )
        rec: Dict[str, Any] = {
            "fault": f.get("fault"),
            "replica": rep,
            "detected": hit is not None,
            "detector": hit.get("event") if hit is not None else None,
            "detection_latency_s": (
                _t(hit) - _t(f) if hit is not None else None
            ),
        }
        # Exposure bound: completed requests the corrupted replica kept
        # answering between fire and detection (end of log if undetected).
        t_end = _t(hit) if hit is not None else float("inf")
        rec["wrong_tokens_served_bound"] = sum(
            int(e.get("n_tokens", 0)) for e in events
            if e.get("event") == "req_done"
            and e.get("replica") == rep
            and _t(f) <= _t(e) <= t_end
        )
        detections.append(rec)
        if hit is None:
            problems.append(
                f"UNDETECTED corruption: {f.get('fault')} fired on replica "
                f"{rep} and no detector answered (quarantine/invalid_token/"
                f"kv_mismatch/weight_mismatch)"
            )

    # Hygiene: a COMPLETED probe with wrong tokens is the sentinel's own
    # verdict — a quarantine must follow (probes that error/expire/time
    # out are the health loop's business and don't count here).
    strict_failures = [
        e for e in probes
        if not e.get("ok") and str(e.get("status")) == "done"
    ]
    for e in strict_failures:
        rep = e.get("replica")
        if not any(
            q.get("replica") == rep and _t(q) >= _t(e) for q in quars
        ):
            problems.append(
                f"probe divergence on replica {rep} (t_mono={_t(e):.3f}) "
                f"was never answered by a quarantine"
            )
    for q in quars:
        rep = q.get("replica")
        preceded = any(
            e.get("replica") == rep and _t(e) <= _t(q)
            for e in strict_failures + w_mm + invalid
        )
        if not preceded:
            problems.append(
                f"quarantine of replica {rep} (t_mono={_t(q):.3f}) has no "
                f"preceding detector signal"
            )
    # Join: when any probe carried a trace, the quarantine decision must
    # too — that's what lets the verdict join the span tree.
    traced_probes = any(e.get("trace_id") for e in probes)
    for d in quar_decisions:
        if traced_probes and not d.get("trace_id"):
            problems.append(
                "quarantine decision lacks a trace_id while probes are "
                "traced (decision-to-trace join broken)"
            )

    per_replica: Dict[str, Dict[str, int]] = {}

    def _slot(r: Any) -> Dict[str, int]:
        return per_replica.setdefault(
            str(r), {"probes": 0, "probe_failures": 0, "quarantines": 0},
        )

    for e in probes:
        slot = _slot(e.get("replica"))
        slot["probes"] += 1
        if not e.get("ok"):
            slot["probe_failures"] += 1
    for e in quars:
        _slot(e.get("replica"))["quarantines"] += 1

    latencies = sorted(
        d["detection_latency_s"] for d in detections
        if d["detection_latency_s"] is not None
    )
    return {
        "probes_run": len(probes),
        "probes_failed": sum(1 for e in probes if not e.get("ok")),
        "quarantines": len(quars),
        "kv_mismatches": len(kv_mm),
        "weight_mismatches": len(w_mm),
        "invalid_tokens": len(invalid),
        "corruptions_armed": len(armed),
        "corruptions_fired": len(fired),
        "corrupt_blocks_dropped": len(drop_decisions),
        "detections": detections,
        "detection_latency_p50_s": _percentile(latencies, 0.50),
        "detection_latency_max_s": latencies[-1] if latencies else None,
        "per_replica": dict(sorted(per_replica.items())),
        "problems": problems,
    }


def print_integrity_report(report: Dict[str, Any]) -> None:
    print("== integrity ==")
    print(
        f"probes={report['probes_run']} "
        f"failed={report['probes_failed']} "
        f"quarantines={report['quarantines']} "
        f"kv_mismatches={report['kv_mismatches']} "
        f"invalid_tokens={report['invalid_tokens']}"
    )
    if report["corruptions_armed"] or report["corruptions_fired"]:
        print(
            f"corruptions: armed={report['corruptions_armed']} "
            f"fired={report['corruptions_fired']} "
            f"blocks_dropped={report['corrupt_blocks_dropped']}"
        )
    for d in report["detections"]:
        if d["detected"]:
            print(
                f"  {d['fault']} on replica {d['replica']}: detected by "
                f"{d['detector']} in {d['detection_latency_s']:.3f}s, "
                f"wrong-tokens-served bound {d['wrong_tokens_served_bound']}"
            )
        else:
            print(
                f"  {d['fault']} on replica {d['replica']}: NOT DETECTED"
            )
    if report["per_replica"]:
        print("== per-replica probes ==")
        hdr = ("replica", "probes", "failed", "quarant")
        print("  " + " ".join(f"{h:>8}" for h in hdr))
        for rep, row in report["per_replica"].items():
            print("  " + " ".join(f"{v:>8}" for v in (
                rep, row["probes"], row["probe_failures"],
                row["quarantines"],
            )))
    for p in report["problems"]:
        print(f"!! {p}")


def build_report(records: List[Dict[str, Any]], bins: int) -> Dict[str, Any]:
    events, metrics = split_records(records)
    counts: Dict[str, int] = {}
    for e in events:
        counts[e["event"]] = counts.get(e["event"], 0) + 1
    report: Dict[str, Any] = {
        "n_records": len(records),
        "n_events": len(events),
        "n_metric_records": len(metrics),
        "event_counts": dict(sorted(counts.items())),
        "step_time": step_time_stats(metrics, bins),
        "timeline": timeline(events),
    }
    if events:
        report["goodput"] = GoodputAccountant.fold(events)
        pc = prefix_cache_summary(events)
        if pc is not None:
            report["prefix_cache"] = pc
    return report


def print_report(report: Dict[str, Any]) -> None:
    good = report.get("goodput")
    if good:
        total = good["total_s"]
        print("== goodput ==")
        print(f"total wall-clock  {total:.3f}s over {good['runs']} run(s)")
        print(f"goodput           {good['goodput']:.3f}")
        for cat in CATEGORIES:
            sec = good["categories"][cat]
            pct = 100.0 * sec / total if total > 0 else 0.0
            bar = "#" * int(round(pct / 2))
            print(f"  {cat:<11} {sec:9.3f}s {pct:5.1f}% {bar}")
        print(f"rollbacks={good['rollbacks']} recompiles={good['recompiles']} "
              f"max_step={good['max_step']} exit={good['exit_reason']}")
    st = report["step_time"]
    print("== step time ==")
    if st["count"] == 0:
        print("no step_ms records")
    else:
        print(f"windows={st['count']} mean={st['mean_ms']:.2f}ms "
              f"p50={st['p50_ms']:.2f}ms p90={st['p90_ms']:.2f}ms "
              f"max={st['max_ms']:.2f}ms")
        peak = max(b["count"] for b in st["histogram"]) or 1
        for b in st["histogram"]:
            bar = "#" * int(round(30 * b["count"] / peak))
            print(f"  [{b['lo_ms']:9.2f}, {b['hi_ms']:9.2f}) {b['count']:5d} {bar}")
    print("== events ==")
    if not report["event_counts"]:
        print("no events")
    for kind, n in report["event_counts"].items():
        print(f"  {kind:<15} {n}")
    pc = report.get("prefix_cache")
    if pc:
        print("== prefix cache ==")
        print(
            f"requests={pc['requests']} hit_requests={pc['hit_requests']} "
            f"hit_rate={pc['hit_rate']:.3f} "
            f"prefill_tokens_saved={pc['prefill_tokens_saved']}"
        )
    if report["timeline"]:
        print("== timeline ==")
        for entry in report["timeline"]:
            extra = " ".join(
                f"{k}={v}" for k, v in entry.items()
                if k not in ("t_rel_s", "event")
            )
            print(f"  +{entry['t_rel_s']:9.3f}s {entry['event']:<13} {extra}")


# ---------------------------------------------------------------------------
# live view: poll a running gateway's GET /slo, reconcile with offline events
# ---------------------------------------------------------------------------

LIVE_METRICS = ("ttft_s", "tpot_s", "e2e_s", "queue_wait_s")
_LIVE_TERMINALS = ("req_done", "req_expired", "req_error", "req_cancelled")
_LIVE_QUANTILES = (("p50", 0.50), ("p90", 0.90), ("p99", 0.99))


def fetch_live(url: str, timeout_s: float = 5.0) -> Dict[str, Any]:
    """GET <url>/slo from a running serving gateway (stdlib only)."""
    import urllib.request

    target = url.rstrip("/")
    if not target.endswith("/slo"):
        target += "/slo"
    with urllib.request.urlopen(target, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def build_live_report(
    snap: Dict[str, Any],
    events: List[Dict[str, Any]],
    rank_eps: float = 0.05,
) -> Dict[str, Any]:
    """Fold a GET /slo snapshot; reconcile sketches vs offline events.

    The live figures come from fixed-size mergeable sketches over a
    ROLLING window; the offline figures are exact percentiles over the
    full events JSONL. When the run fits inside the live window (the CI
    smoke case) the two must agree within the sketch's rank-error bound:
    each live quantile must land between the exact values at ranks
    q-rank_eps and q+rank_eps. A live window that saw far fewer events
    than the file (a long run, window already rotated) is reported as
    ``window_truncated`` and skipped rather than failed — the contract
    is accuracy, not that a 60s window summarizes an hour.
    """
    fleet = snap.get("latency", {}).get("fleet", {})
    problems: List[str] = []
    reconcile: Dict[str, Any] = {}
    offline: Dict[str, List[float]] = {m: [] for m in LIVE_METRICS}
    for ev in events:
        if ev.get("event") not in _LIVE_TERMINALS:
            continue
        for m in LIVE_METRICS:
            v = ev.get(m)
            if isinstance(v, (int, float)) and math.isfinite(v):
                offline[m].append(float(v))
    for m in LIVE_METRICS:
        live = fleet.get(m, {})
        live_n = int(live.get("count", 0))
        vals = sorted(offline[m])
        row: Dict[str, Any] = {
            "live_count": live_n,
            "offline_count": len(vals),
            "checked": False,
        }
        if len(vals) >= 20 and live_n > 0:
            if live_n < len(vals) // 2:
                row["window_truncated"] = True
            else:
                row["checked"] = True
                for key, q in _LIVE_QUANTILES:
                    got = live.get(key)
                    if not isinstance(got, (int, float)):
                        continue
                    lo = _percentile(vals, max(0.0, q - rank_eps))
                    hi = _percentile(vals, min(1.0, q + rank_eps))
                    slack = 1e-9 + 0.01 * max(abs(lo), abs(hi))
                    ok = (lo - slack) <= got <= (hi + slack)
                    row[key] = {
                        "live": got, "exact_lo": lo, "exact_hi": hi,
                        "ok": ok,
                    }
                    if not ok:
                        problems.append(
                            f"live {m} {key}={got:.6g} outside exact "
                            f"rank band [{lo:.6g}, {hi:.6g}] "
                            f"(rank_eps={rank_eps})"
                        )
        reconcile[m] = row
    alerts = snap.get("alerts", {})
    return {
        "events_seen": snap.get("events_seen", 0),
        "window_s": snap.get("window_s"),
        "fleet": fleet,
        "classes": snap.get("classes", {}),
        "alerts_active": alerts.get("active", []),
        "alerts_fired_total": alerts.get("fired_total", 0),
        "fleet_health": snap.get("fleet_health", {}).get("fleet", {}),
        "reconcile": reconcile,
        "problems": problems,
    }


def print_live_report(rep: Dict[str, Any]) -> None:
    print("== live SLO ==")
    print(
        f"events_seen={rep['events_seen']} "
        f"window_s={rep['window_s']} "
        f"alerts_active={len(rep['alerts_active'])} "
        f"alerts_fired_total={rep['alerts_fired_total']}"
    )
    for m in LIVE_METRICS:
        s = rep["fleet"].get(m, {})
        if not s.get("count"):
            print(f"  {m:<13} (no samples in window)")
            continue
        print(
            f"  {m:<13} n={s['count']:<6} p50={s.get('p50', 0.0):.4f}s "
            f"p90={s.get('p90', 0.0):.4f}s p99={s.get('p99', 0.0):.4f}s"
        )
    for name, cls in rep["classes"].items():
        burn = ", ".join(
            f"{r}={b['short']:.2f}/{b['long']:.2f}"
            f"{' FIRING' if b.get('firing') else ''}"
            for r, b in cls.get("burn", {}).items()
        )
        print(
            f"  class {name}: target={cls['target']} "
            f"events={cls['events']} bad={cls['bad']} "
            f"budget_spent={cls['budget_spent_frac']:.1%} [{burn}]"
        )
    for alert in rep["alerts_active"]:
        print(
            f"  ALERT {alert.get('alert_id')} {alert.get('slo_class')}/"
            f"{alert.get('rule')} severity={alert.get('severity')} "
            f"burn={alert.get('burn_short'):.1f}/{alert.get('burn_long'):.1f}"
        )
    fh = rep.get("fleet_health") or {}
    if fh:
        print(
            f"  fleet: replicas={fh.get('replicas_active')}/"
            f"{fh.get('replicas_total')} max_fence={fh.get('max_fence')} "
            f"gauges={fh.get('gauges', {})}"
        )
    checked = [m for m, r in rep["reconcile"].items() if r["checked"]]
    if checked:
        print("== live vs offline ==")
        for m in checked:
            row = rep["reconcile"][m]
            for key, _ in _LIVE_QUANTILES:
                c = row.get(key)
                if c is None:
                    continue
                mark = "ok" if c["ok"] else "MISMATCH"
                print(
                    f"  {m} {key}: live={c['live']:.4f} in "
                    f"[{c['exact_lo']:.4f}, {c['exact_hi']:.4f}] {mark}"
                )
    for p in rep["problems"]:
        print(f"  !! {p}")


def _finite_or_null(obj: Any) -> Any:
    """``obj`` with every non-finite float (the NaN of a percentile over no
    values: a fleet run without a redrive, an integrity report without a
    detection) as ``None``, so the ``--json`` output stays strict JSON.
    The JAX script raises ``ValueError`` there instead."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite_or_null(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite_or_null(v) for v in obj]
    return obj


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("paths", nargs="*", help="metrics/events JSONL files")
    parser.add_argument(
        "--strict", action="store_true",
        help="exit nonzero if any line fails to parse (CI schema gate) or, "
        "with --slo, if any request's span tree is incomplete",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    parser.add_argument("--bins", type=int, default=10, help="step-time histogram bins")
    parser.add_argument(
        "--trace", default="",
        help="Chrome-trace JSON export (serve --trace) to "
        "reconstruct per-request span trees from",
    )
    parser.add_argument(
        "--slo", action="store_true",
        help="per-request SLO attribution from --trace: waterfalls, "
        "segment decomposition, miss table",
    )
    parser.add_argument(
        "--slo_ttft_s", type=float, default=0.0,
        help="TTFT SLO bound in seconds (0 = no bound)",
    )
    parser.add_argument(
        "--slo_e2e_s", type=float, default=0.0,
        help="end-to-end SLO bound in seconds (0 = no bound)",
    )
    parser.add_argument(
        "--fleet-trace", dest="fleet_trace", action="store_true",
        help="cross-host lineage view from --trace (+ optional events "
        "JSONL): per-request waterfall across placement attempts (sums "
        "to e2e), worker subtrees clock-aligned into the router "
        "timeline, redrive/partition-detection gaps; --strict makes an "
        "unalignable span, an orphaned attempt/subtree, an "
        "out-of-bound worker span, or a >1%% sum error fatal",
    )
    parser.add_argument(
        "--capacity", action="store_true",
        help="capacity attribution from cap_window/decision events: "
        "slot-second waterfall (sums to wall time), binding constraint, "
        "decision-to-trace join; --strict makes a >1% sum error, an "
        "unjoinable decision, or a run with no occupancy samples fatal",
    )
    parser.add_argument(
        "--fleet", action="store_true",
        help="fleet attribution from fleet_req_*/redrive/replica_state "
        "events: request conservation (every submit reaches a terminal), "
        "per-replica waterfalls, redrive cost, replica recovery time, "
        "partition detection joins (lease expiry vs fence drop), journal "
        "replays; --strict makes a lost request, a dangling redrive, or "
        "an undetected partition fatal",
    )
    parser.add_argument(
        "--integrity", action="store_true",
        help="integrity attribution from integrity_*/fault_fired events: "
        "corruption-to-detection latency, probe/quarantine waterfall, "
        "wrong-tokens-served exposure bound, decision-to-trace join; "
        "--strict makes an undetected corruption, an unanswered probe "
        "divergence, or a broken trace join fatal",
    )
    parser.add_argument(
        "--live", default="",
        help="poll a RUNNING gateway's live SLO engine (base URL, e.g. "
        "http://localhost:8000): rolling-window percentile sketches, "
        "error budgets, burn rates, active alerts, fleet health. With "
        "events JSONL paths, reconciles the live sketch percentiles "
        "against exact offline percentiles within the sketch's rank "
        "error bound; --strict makes a mismatch fatal",
    )
    parser.add_argument(
        "--live_timeout_s", type=float, default=5.0,
        help="HTTP timeout for --live",
    )
    parser.add_argument(
        "--live_rank_eps", type=float, default=0.05,
        help="rank tolerance for the --live vs offline reconciliation",
    )
    args = parser.parse_args()
    if args.slo and not args.trace:
        parser.error("--slo needs --trace")
    if args.fleet_trace and not args.trace:
        parser.error("--fleet-trace needs --trace")
    if args.capacity and not args.paths:
        parser.error("--capacity needs events JSONL paths")
    if args.fleet and not args.paths:
        parser.error("--fleet needs events JSONL paths")
    if args.integrity and not args.paths:
        parser.error("--integrity needs events JSONL paths")
    if not args.paths and not args.trace and not args.live:
        parser.error(
            "nothing to analyze: pass JSONL paths, --trace, and/or --live"
        )

    records: List[Dict[str, Any]] = []
    bad = 0
    for path in args.paths:
        recs, nbad = read_jsonl(path)
        records.extend(recs)
        bad += nbad
    report = build_report(records, args.bins)
    report["bad_lines"] = bad
    slo_report: Optional[Dict[str, Any]] = None
    if args.trace:
        trace = load_trace(args.trace)
        slo_report = build_slo_report(
            trace, slo_ttft_s=args.slo_ttft_s, slo_e2e_s=args.slo_e2e_s
        )
        report["serving"] = slo_report
    fleet_trace_report: Optional[Dict[str, Any]] = None
    if args.fleet_trace:
        events, _ = split_records(records)
        fleet_trace_report = build_fleet_trace_report(trace, events)
        report["fleet_trace"] = fleet_trace_report
    cap_report: Optional[Dict[str, Any]] = None
    if args.capacity:
        events, _ = split_records(records)
        cap_report = build_capacity_report(events)
        report["capacity"] = cap_report
    fleet_report: Optional[Dict[str, Any]] = None
    if args.fleet:
        events, _ = split_records(records)
        fleet_report = build_fleet_report(events)
        report["fleet"] = fleet_report
    integrity_report: Optional[Dict[str, Any]] = None
    if args.integrity:
        events, _ = split_records(records)
        integrity_report = build_integrity_report(events)
        report["integrity"] = integrity_report
    live_report: Optional[Dict[str, Any]] = None
    if args.live:
        snap = fetch_live(args.live, timeout_s=args.live_timeout_s)
        events, _ = split_records(records)
        live_report = build_live_report(
            snap, events, rank_eps=args.live_rank_eps
        )
        report["live"] = live_report
    if args.json:
        print(json.dumps(_finite_or_null(report), indent=2, allow_nan=False))
    else:
        if args.paths:
            print_report(report)
        if slo_report is not None and (args.slo or slo_report["problems"]):
            print_slo_report(slo_report)
        if fleet_trace_report is not None:
            print_fleet_trace_report(fleet_trace_report)
        if cap_report is not None:
            print_capacity_report(cap_report)
        if fleet_report is not None:
            print_fleet_report(fleet_report)
        if integrity_report is not None:
            print_integrity_report(integrity_report)
        if live_report is not None:
            print_live_report(live_report)
        if bad:
            print(f"!! {bad} unparseable line(s)", file=sys.stderr)
        if slo_report is not None and slo_report["dropped_spans"]:
            print(
                f"!! {slo_report['dropped_spans']} dropped span(s): the "
                f"recorder saturated; raise max_events or sample fewer "
                f"requests",
                file=sys.stderr,
            )
    if args.strict and bad:
        return 1
    if args.strict and slo_report is not None and slo_report["problems"]:
        for p in slo_report["problems"]:
            print(f"STRICT: {p}", file=sys.stderr)
        return 1
    if (args.strict and fleet_trace_report is not None
            and fleet_trace_report["problems"]):
        for p in fleet_trace_report["problems"]:
            print(f"STRICT: {p}", file=sys.stderr)
        return 1
    if args.strict and cap_report is not None and cap_report["problems"]:
        for p in cap_report["problems"]:
            print(f"STRICT: {p}", file=sys.stderr)
        return 1
    if args.strict and fleet_report is not None and fleet_report["problems"]:
        for p in fleet_report["problems"]:
            print(f"STRICT: {p}", file=sys.stderr)
        return 1
    if args.strict and integrity_report is not None and integrity_report["problems"]:
        for p in integrity_report["problems"]:
            print(f"STRICT: {p}", file=sys.stderr)
        return 1
    if args.strict and live_report is not None and live_report["problems"]:
        for p in live_report["problems"]:
            print(f"STRICT: {p}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
