"""Write-ahead fleet journal: the router's crash-recoverable control
plane (the JAX package's ``frontend/journal.py``, which is stdlib only).

Append-only JSONL, one record per line, written at every
redrive-relevant transition so a restarted router can rebuild exactly
the state it needs to finish what the dead one started:

==========  ===========================================================
rec         written when / carries
==========  ===========================================================
member      router start — replica index, mode (spawn/attach/inproc),
            attach address if any
fence       router start and every eject — the replica's fence
            generation; recovery bumps past the MAX seen, so every
            frame the old router's workers still have in flight is
            stale by construction ("fence the old generation
            everywhere")
submit      request admitted — frid, prompt, max_new, priority,
            deadline_s, trace_id (write-ahead: BEFORE placement; the
            trace_id lets a recovered router CONTINUE the original
            distributed trace instead of minting an orphan root)
frontier    redrive — the committed token frontier carried to the
            survivor (token VALUES, not a count: recovery re-submits
            ``prompt + tokens`` and greedy decode makes the
            continuation bit-identical)
terminal    request finished (any status) — recovery skips it
next_frid   compaction bookkeeping — preserves the frid high-water
            mark across a rotation that dropped every terminal'd
            submit (frids must never be reused across a restart)
==========  ===========================================================

Compaction: the journal grows without bound under sustained load
(terminal'd submits are never dropped), so ``rotate_bytes > 0`` arms
size-threshold rotation — once the file exceeds the threshold after an
append, the journal is rewritten as exactly its ``recovery_plan`` fold
(max fences + live submits at their frontiers + the frid high-water
mark) via write-to-temp then atomic ``os.replace``. A crash at ANY
point mid-rotate leaves either the old complete file or the new
complete file, never a torn hybrid; a stray ``.rotate`` temp from a
crash is ignored by ``load`` and overwritten by the next rotation.

Recovery folds the records front to back (`recovery_plan`): live
requests are submits without terminals, each at its last journaled
frontier. Tokens streamed between the last frontier record and the
crash are simply re-decoded — greedy determinism makes the full output
identical, and exactly-once holds per router lifetime (terminal
records are what dedups across the restart).

Durability is flush-per-record (the OS page cache): the failure model
is a crashed ROUTER PROCESS on a healthy host — the same machine
restarts it. Torn final lines (crash mid-write) are tolerated on load.

No engine, socket or device dependency: unit-testable on the CPU.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional


class FleetJournal:
    """Append-only JSONL writer with crash-tolerant load/replay."""

    def __init__(self, path: str, rotate_bytes: int = 0) -> None:
        if rotate_bytes < 0:
            raise ValueError(
                f"rotate_bytes must be >= 0 (0 = no rotation), got "
                f"{rotate_bytes}"
            )
        self.path = str(path)
        self.rotate_bytes = int(rotate_bytes)
        self.rotations = 0
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._f: Optional[Any] = open(self.path, "a", encoding="utf-8")

    def append(self, rec: Dict[str, Any]) -> None:
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        with self._lock:
            f = self._f
            if f is None:
                return  # closed under a racing pump terminal; drop
            f.write(line)
            f.flush()
            if self.rotate_bytes > 0 and f.tell() >= self.rotate_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Rewrite the journal as its recovery fold (caller holds the
        lock). The fold is written to a sibling temp file and swapped in
        with ``os.replace`` — atomic on POSIX — so a crash mid-rotate
        leaves a loadable journal at every instant. If the rewrite
        fails, the original (oversize but complete) file keeps serving;
        rotation is an optimization, never a durability trade."""
        plan = self.recovery_plan(self.load(self.path))
        tmp = self.path + ".rotate"
        try:
            with open(tmp, "w", encoding="utf-8") as out:
                for idx in sorted(plan["fences"]):
                    out.write(json.dumps(
                        {"rec": "fence", "replica": idx,
                         "fence": plan["fences"][idx]},
                        separators=(",", ":")) + "\n")
                # next_frid first among request records: even if every
                # live submit terminates before the next rotation, the
                # frid high-water mark survives.
                out.write(json.dumps(
                    {"rec": "next_frid", "frid": plan["next_frid"]},
                    separators=(",", ":")) + "\n")
                for frid in sorted(plan["live"]):
                    ent = plan["live"][frid]
                    out.write(json.dumps(
                        {"rec": "submit", "frid": frid,
                         "prompt": ent["prompt"],
                         "max_new": ent["max_new"],
                         "priority": ent["priority"],
                         "deadline_s": ent["deadline_s"],
                         "trace_id": ent.get("trace_id")},
                        separators=(",", ":")) + "\n")
                    if ent["tokens"] or ent["redrives"]:
                        out.write(json.dumps(
                            {"rec": "frontier", "frid": frid,
                             "tokens": ent["tokens"],
                             "redrives": ent["redrives"]},
                            separators=(",", ":")) + "\n")
                out.flush()
                os.fsync(out.fileno())
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        old = self._f
        os.replace(tmp, self.path)
        self._f = open(self.path, "a", encoding="utf-8")
        self.rotations += 1
        if old is not None:
            try:
                old.close()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            f, self._f = self._f, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    @staticmethod
    def load(path: str) -> List[Dict[str, Any]]:
        """Read every parseable record; a torn final line (crash
        mid-append) is skipped, mirroring how a real WAL discards its
        incomplete tail."""
        records: List[Dict[str, Any]] = []
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict):
                        records.append(rec)
        except FileNotFoundError:
            pass
        return records

    @staticmethod
    def recovery_plan(records: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Fold the journal into what a restarting router needs:

        - ``fences``: per-replica MAX fence generation seen (the new
          router bumps past these before any worker re-attaches).
        - ``live``: frid -> {prompt, max_new, priority, deadline_s,
          trace_id, tokens, redrives} for every submit without a
          terminal, at its last journaled frontier.
        - ``next_frid``: one past the highest frid ever journaled (or
          the journaled ``next_frid`` high-water mark after a rotation
          dropped the terminal'd submits), so recovered and fresh
          requests never collide.
        """
        fences: Dict[int, int] = {}
        live: Dict[int, Dict[str, Any]] = {}
        next_frid = 0
        for rec in records:
            kind = rec.get("rec")
            if kind == "fence":
                idx = int(rec.get("replica", -1))
                fences[idx] = max(
                    fences.get(idx, 0), int(rec.get("fence", 0))
                )
            elif kind == "next_frid":
                next_frid = max(next_frid, int(rec.get("frid", 0)))
            elif kind == "submit":
                frid = int(rec["frid"])
                next_frid = max(next_frid, frid + 1)
                live[frid] = {
                    "prompt": [int(t) for t in rec.get("prompt", [])],
                    "max_new": int(rec.get("max_new", 1)),
                    "priority": int(rec.get("priority", 0)),
                    "deadline_s": rec.get("deadline_s"),
                    "trace_id": rec.get("trace_id"),
                    "tokens": [],
                    "redrives": 0,
                }
            elif kind == "frontier":
                ent = live.get(int(rec.get("frid", -1)))
                if ent is not None:
                    ent["tokens"] = [int(t) for t in rec.get("tokens", [])]
                    ent["redrives"] = int(rec.get("redrives", 0))
            elif kind == "terminal":
                live.pop(int(rec.get("frid", -1)), None)
        return {"fences": fences, "live": live, "next_frid": next_frid}
