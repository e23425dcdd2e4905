"""Bounded exponential-backoff relauncher for training runs: the port's
stdlib copy of ``scripts/supervisor.py``, with the same return-code policy,
backoff, budgets, SIGTERM forwarding and ``relaunch`` events.

The trainer turns faults into distinct return codes and checkpoints
(``resilience/``); this process turns those codes into restart policy. It
imports nothing that needs torch, so it starts at once even when the
training stack is wedged.

Usage::

    python -m pretraining_llm_tpu_torch.supervisor [options] -- \
        python -m pretraining_llm_tpu_torch.train ...

Everything after ``--`` is the child command, relaunched as is (training
resumes from the latest checkpoint by itself).

Return-code policy (``resilience/__init__.py``):
  0    clean completion              -> exit 0.
  43   EXIT_PREEMPTED (SIGTERM stop) -> relaunch at once, no backoff;
       capped by --max-preemptions only as a runaway guard.
  44   EXIT_ANOMALY (rollback budget spent / no checkpoint) -> exit 44:
       an anomaly that survived the rollbacks is systemic.
  45   EXIT_WEDGED (watchdog: hung step) -> relaunch with backoff; counts
       toward --max-restarts.
  else crash                         -> relaunch with backoff; counts
       toward --max-restarts.

A child that ran longer than --healthy-secs before CRASHING resets the
failure count. EXIT_WEDGED never resets it: a wedged child's lifetime
includes the whole watchdog timeout spent hung. The supervisor exits with
the child's last return code when a budget is spent.

SIGTERM to the supervisor is forwarded to the child; once the child exits,
the supervisor surfaces its return code without relaunching.
"""

from __future__ import annotations

import argparse
import json
import signal
import subprocess
import sys
import time

from pretraining_llm_tpu_torch.resilience import EXIT_ANOMALY, EXIT_PREEMPTED, EXIT_WEDGED


def _log(record: dict) -> None:
    record = {"supervisor": True, "t": round(time.time(), 1), **record}
    print(json.dumps(record), flush=True)


class _EventWriter:
    """Append supervisor events to the JSONL stream the trainer's EventBus
    writes (--events pointed at the run's events file), in the same record
    shape (event/seq/t_wall/t_mono), so ``obs_report`` folds relaunches into
    one timeline. Kept apart from observability/events.py so the supervisor
    stays stdlib-only. Every write is best effort: a full disk must not kill
    the relauncher."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._seq = 0

    def emit(self, kind: str, **fields) -> None:
        if not self.path:
            return
        self._seq += 1
        record = {
            "event": kind,
            "seq": self._seq,
            "t_wall": time.time(),
            "t_mono": time.monotonic(),
            "supervisor": True,
            **fields,
        }
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(record, allow_nan=False) + "\n")
        except (OSError, ValueError):
            pass


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument(
        "--max-restarts", type=int, default=10,
        help="failure-restart budget (wedges + crashes); exceeded -> give up",
    )
    parser.add_argument(
        "--max-preemptions", type=int, default=1000,
        help="runaway guard on immediate preemption relaunches",
    )
    parser.add_argument(
        "--backoff-base", type=float, default=5.0,
        help="first failure backoff in seconds (doubles per consecutive failure)",
    )
    parser.add_argument(
        "--backoff-max", type=float, default=300.0,
        help="backoff ceiling in seconds",
    )
    parser.add_argument(
        "--events", default="", metavar="PATH",
        help="append relaunch/exit events (trainer EventBus JSONL schema) "
        "here; point it at the run's obs events file for one merged timeline",
    )
    parser.add_argument(
        "--healthy-secs", type=float, default=300.0,
        help="a child surviving this long before a CRASH resets the failure "
        "count (wedges never reset it: their lifetime includes the whole "
        "watchdog timeout spent hung)",
    )
    if "--" not in argv:
        parser.error("missing '-- <command ...>' (the child command to supervise)")
    split = argv.index("--")
    args = parser.parse_args(argv[:split])
    cmd = argv[split + 1:]
    if not cmd:
        parser.error("empty child command after '--'")
    return args, cmd


def supervise(args, cmd) -> int:
    failures = 0
    preemptions = 0
    launches = 0
    events = _EventWriter(getattr(args, "events", ""))
    # SIGTERM handling: a TERM delivered to the supervisor ALONE (not the
    # whole process group) must not kill it outright — that would orphan
    # the training child and lose the EXIT_PREEMPTED relaunch contract.
    # The handler forwards the signal to the child; the loop then waits
    # for the child's exit and surfaces its return code without
    # relaunching.
    state = {"child": None, "term": False}

    def _on_term(signum, frame):  # noqa: ARG001 — signal API shape
        state["term"] = True
        child = state["child"]
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signal.SIGTERM)
            except OSError:
                pass  # child exited between poll and send

    try:
        prev_term = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # non-main thread (tests): run without forwarding
        prev_term = None
    try:
        while True:
            launches += 1
            _log({"event": "launch", "attempt": launches, "cmd": cmd})
            started = time.monotonic()
            try:
                child = subprocess.Popen(cmd)
                state["child"] = child
                if state["term"]:  # TERM raced the launch: forward now
                    child.send_signal(signal.SIGTERM)
                rc = child.wait()
            except KeyboardInterrupt:
                _log({"event": "interrupted"})
                child = state["child"]
                if child is not None and child.poll() is None:
                    child.terminate()
                    try:
                        child.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        child.kill()
                return 130
            finally:
                state["child"] = None
            elapsed = time.monotonic() - started
            _log({"event": "exit", "rc": rc, "elapsed_s": round(elapsed, 1)})

            if state["term"]:
                _log({"event": "terminated", "rc": rc})
                return rc
            if rc == 0:
                return 0
            if rc == EXIT_ANOMALY:
                _log({"event": "fatal", "why": "anomaly budget exhausted; needs a human"})
                events.emit("failure", rc=rc, why="anomaly_budget")
                return rc
            if rc == EXIT_PREEMPTED:
                preemptions += 1
                if preemptions > args.max_preemptions:
                    _log({"event": "fatal", "why": "preemption budget exhausted"})
                    events.emit("failure", rc=rc, why="preemption_budget")
                    return rc
                _log({"event": "relaunch", "why": "preempted", "backoff_s": 0})
                events.emit("relaunch", rc=rc, why="preempted", attempt=launches)
                continue

            # Wedge or crash: exponential backoff, bounded budget. The
            # health reset applies to crashes only — a wedged child's
            # elapsed time includes watchdog_timeout_s of dead hang, so
            # its lifetime measures nothing; letting wedges reset the
            # counter would relaunch a permanently wedged run forever
            # whenever the watchdog timeout exceeds --healthy-secs.
            if rc != EXIT_WEDGED and elapsed >= args.healthy_secs and failures:
                _log({"event": "failure_count_reset", "elapsed_s": round(elapsed, 1)})
                failures = 0
            failures += 1
            if failures > args.max_restarts:
                _log({"event": "fatal", "why": "restart budget exhausted", "failures": failures - 1})
                events.emit("failure", rc=rc, why="restart_budget")
                return rc
            backoff = min(args.backoff_base * 2 ** (failures - 1), args.backoff_max)
            why = "wedged" if rc == EXIT_WEDGED else f"crash rc={rc}"
            _log({"event": "relaunch", "why": why, "failures": failures, "backoff_s": backoff})
            events.emit(
                "relaunch", rc=rc, why=why, attempt=launches, backoff_s=backoff
            )
            time.sleep(backoff)
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)


def main() -> None:
    args, cmd = parse_args(sys.argv[1:])
    sys.exit(supervise(args, cmd))


if __name__ == "__main__":
    main()
