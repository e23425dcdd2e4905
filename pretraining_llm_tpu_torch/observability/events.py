"""Structured run events: the spine of the observability subsystem (the JAX
package's ``observability/events.py``).

An event is a flat JSON-serializable dict stamped with both clocks:

  ``t_wall``  epoch seconds — comparable ACROSS processes and relaunches
              (the goodput accountant orders multi-run streams by it);
  ``t_mono``  monotonic seconds — immune to NTP steps WITHIN a process
              (durations are always measured on this clock by the caller
              and shipped as an explicit ``dur_s`` field);
  ``seq``     per-bus emission counter — a total order for events landing
              inside the same wall-clock tick.

Duration-carrying events (``eval``, ``ckpt_save``, ``ckpt_restore``,
``rollback``, ``step_window``) are emitted at the END of the activity they
measure; the goodput fold relies on that convention.

The bus is deliberately tiny: ``emit`` appends one line to an optional JSONL
sink and calls the in-process subscribers (the live goodput accountant; a
test capture). Emission happens only at log boundaries and around off-path
work (eval/checkpoint/rollback), never per step — there is nothing here that
could touch a device. A lock makes ``emit`` safe from the watchdog thread.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# The vocabulary of run events. Producers outside this package (supervisor,
# tests) keep to this list so the offline analyzer can label everything.
EVENT_KINDS = (
    "run_start",      # train() entered: step=start step, total=target step
    "run_end",        # train() exiting: exit_reason + goodput/compile summary
    "step_window",    # a log window of pure step time: step, steps, dur_s
    "eval",           # one evaluate() call: step, dur_s, val_loss
    "ckpt_save",      # one checkpoint save: step, dur_s, async
    "ckpt_restore",   # one restore (resume or rollback): step, dur_s
    "rollback",       # anomaly rollback executed: from_step, to_step, dur_s
    "recompile",      # post-warmup backend compile: dur_s
    "wedge",          # watchdog fired: stalled_s
    "preempt",        # SIGTERM stop requested: step
    "relaunch",       # supervisor relaunched the child: attempt, backoff_s
    "failure",        # step loop raised: step, error
    "device_memory",  # HBM sample: per-device bytes_in_use/peak
    "fault_injected", # drill fault fired: kind, step
    # Serving-frontend request lifecycle (frontend/engine_loop.py). The
    # terminal kinds carry queue_wait_s/ttft_s/e2e_s + n_tokens, and every
    # req_* record carries trace_id when the request is traced, so the
    # event stream doubles as the per-request serving audit log and joins
    # against the Chrome-trace span tree in obs_report --slo.
    "req_submit",     # accepted past validation+admission: n_prompt, max_new
    "req_rejected",   # refused at admission: reason=busy|infeasible|invalid
    "req_done",       # generated to completion (HTTP 200)
    "req_cancelled",  # client cancelled / disconnected (HTTP 499)
    "req_expired",    # deadline passed mid-flight (HTTP 504)
    "req_error",      # engine failure or shutdown (HTTP 500)
    # Capacity observability (observability/capacity.py). One cap_window
    # record per reaped decode window (occupancy, pool split, admission
    # depth; t_dispatch_s/t_reap_s are perf_counter so offline interval
    # math stays on one clock); one decision record per scheduler action
    # that costs a request something (decision= one of DECISION_KINDS,
    # trace_id joins it to the req_* stream).
    "cap_window",     # per-window occupancy sample: rows, tokens, pool, queue
    "decision",       # scheduler decision: reject/shed/preempt/evict/reclaim
    # Serving fleet (frontend/router.py). Replica-scoped events carry a
    # ``replica`` index (replica-local req_* events carry it too, via the
    # router's tagging bus proxy); fleet_req_* events carry ``frid`` — the
    # router-level request id that stays stable across redrives, which is
    # what lets obs_report --fleet prove no accepted request was lost.
    "replica_state",      # lifecycle transition: replica, state, reason
    "redrive",            # in-flight failover: frid, from/to replica, committed tokens
    "brownout",           # fleet brownout entered/left: active, healthy, total
    "fleet_req_submit",   # router accepted a request: frid, replica, n_prompt
    "fleet_req_terminal", # router delivered a terminal: frid, status, redrives
    # Output-integrity sentinel (resilience/integrity.py + router). Probe
    # events carry the replica they exercised and whether the greedy
    # output matched the pinned reference; mismatch events are the
    # checksum detectors firing; quarantine is the sentinel's verdict
    # (the matching ``quarantine`` decision carries the probe trace_id).
    # Out-of-process workers (frontend/worker.py + remote_replica.py).
    # worker_* events carry the replica index and, where known, the
    # worker pid — obs_report --fleet joins a worker death (worker_exit
    # with clean=false / worker_conn_lost) to the redrives and the
    # replica_state recovery that followed it.
    "worker_spawn",       # worker process launched: replica, pid, port, reason
    "worker_exit",        # worker stopped: replica, pid, clean, returncode
    "worker_conn_lost",   # parent<->worker socket died: replica, reason
    "rpc_retry",          # idempotent worker RPC retried: replica, op, attempt
    # Rolling weight upgrades (Router.upgrade_replica). The vetting
    # verdict events are what proves traffic never reached an unvetted
    # checkpoint: upgrade_vetted precedes the replica_state active
    # transition, and a refusal carries the probe-divergence reason.
    "upgrade_start",        # replica drained for upgrade: replica, generation
    "upgrade_vetted",       # new weights passed golden probes: replica, detail
    "upgrade_refused",      # probes failed; upgrade rejected: replica, reason
    "upgrade_rolled_back",  # old weights restored (or ejected): replica, restored
    # Disaggregated prefill/decode (frontend/kv_transfer.py + router).
    # kv_migrate records each prefill-tier page push (frid, from/to
    # replica, pages, bytes, saved_tokens); a nonzero reject count also
    # emits kv_migration_reject with the decode worker's refusal reason
    # (checksum_mismatch/capacity/stale fence) — the proof that corrupt
    # pages were dropped rather than served.
    "kv_migrate",           # KV pages migrated prefill->decode: frid, pages, bytes
    "kv_migration_reject",  # decode worker refused migrated pages: replica, reason
    "fault_fired",               # armed corruption actually mutated engine state
    "integrity_probe",           # probe completed: replica, ok, probe, n_tokens
    "integrity_quarantine",      # replica pulled from service: replica, reason
    "integrity_kv_mismatch",     # cached KV page failed verify-on-acquire: block
    "integrity_weight_mismatch", # live weight fingerprint drifted: replica
    "integrity_invalid_token",   # out-of-vocab token id reached reap: rid, token
    # Live SLO engine (observability/slo.py). One record per alert
    # transition: state="firing" carries alert_id + burn rates over the
    # rule's short/long windows (and trigger_trace_id when the tipping
    # request was traced — the join to the req_* stream); the matching
    # state="resolved" record reuses the SAME alert_id, so the pair
    # brackets the incident in the replayable timeline. Every firing
    # also lands an ``slo_alert`` decision with the same alert_id.
    "slo_alert",      # burn-rate alert transition: alert_id, state, rule
)


def sanitize_record(record: Dict[str, Any]) -> Dict[str, Any]:
    """Make a record strictly-JSON serializable: non-finite floats become
    ``null`` plus a ``<key>_nonfinite`` string ('nan' | 'inf' | '-inf').

    Bare ``NaN``/``Infinity`` tokens (json.dumps' default) are invalid JSON
    and corrupt a JSONL stream exactly when it matters most — the anomaly
    detector logging a NaN loss. Downstream parsers get a valid line AND
    keep the information.
    """
    out: Dict[str, Any] = {}
    for key, val in record.items():
        if isinstance(val, float) and not math.isfinite(val):
            out[key] = None
            out[key + "_nonfinite"] = repr(val)  # 'nan' | 'inf' | '-inf'
        else:
            out[key] = val
    return out


def json_line(record: Dict[str, Any]) -> str:
    """One strict-JSON line (no trailing newline) for a JSONL sink."""
    return json.dumps(sanitize_record(record), allow_nan=False)


class EventBus:
    """Append-only run-event stream: JSONL sink + in-process subscribers.

    ``jsonl_path=""`` keeps the bus in-memory only (subscribers still fire).
    Like MetricsLogger, the file handle reopens on demand after ``close`` so
    the trainer can release the fd on every exit path while repeated
    ``train()`` calls on one Trainer keep appending.
    """

    def __init__(
        self,
        jsonl_path: str = "",
        *,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
    ) -> None:
        self._path = jsonl_path
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._clock = clock
        self._wall = wall
        self._subs: List[Callable[[Dict[str, Any]], None]] = []
        self._seq = 0
        self._lock = threading.Lock()

    def __enter__(self) -> "EventBus":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.close()

    def subscribe(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        self._subs.append(fn)

    def emit(self, kind: str, *, step: Optional[int] = None, **fields: Any) -> Dict[str, Any]:
        """Record one event; returns the full stamped record.

        Unknown kinds are allowed (forward compatibility for out-of-package
        producers) — EVENT_KINDS is the documented vocabulary, not a gate.
        """
        with self._lock:
            record: Dict[str, Any] = {
                "event": kind,
                "seq": self._seq,
                "t_wall": self._wall(),
                "t_mono": self._clock(),
            }
            self._seq += 1
            if step is not None:
                record["step"] = int(step)
            record.update(fields)
            if self._file is None and self._path:
                self._file = open(self._path, "a")
            if self._file is not None:
                self._file.write(json_line(record) + "\n")
                self._file.flush()
        # Subscribers run outside the lock: a subscriber that emits (e.g. a
        # telemetry sampler reacting to a window) must not deadlock.
        for fn in self._subs:
            fn(record)
        return record

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
