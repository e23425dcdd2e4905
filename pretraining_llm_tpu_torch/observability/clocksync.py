"""Cristian-style clock alignment between router and worker processes (the
JAX package's ``observability/clocksync.py``).

Every process has its own ``time.perf_counter`` epoch (an arbitrary
boot-relative zero), so a worker's span timestamps are meaningless in
the router's timeline until an offset is estimated. The estimator here
is the classic minimum-RTT filter over request/reply clock samples:

- the router stamps its own clock before sending an RPC (``t_send``)
  and after the reply lands (``t_recv``);
- the worker stamps ITS clock while building the reply (``t_remote``);
- assuming the remote stamp was taken near the midpoint of the round
  trip, ``offset = (t_send + t_recv) / 2 - t_remote`` maps remote time
  into local time, with the unavoidable error bounded by half the
  round-trip time (the stamp could have been taken anywhere between
  the request arriving and the reply leaving).

Samples taken during a congested round trip carry a large bound, so the
estimate is the MIN-RTT sample over a sliding window of recent
heartbeats: re-estimating every heartbeat tracks drift (perf_counter
rates differ slightly across hosts) while the window keeps one lucky
tight sample from pinning a stale offset forever. ``reset()`` discards
everything — called per connection generation, because a re-attach may
land on a different process with an unrelated epoch.

Pure arithmetic over caller-supplied timestamps: no sockets, no device,
fully deterministic under injected clocks (unit-testable on the CPU).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Optional, Tuple


class ClockSync:
    """Min-RTT offset estimator for one remote peer.

    ``window`` bounds how many recent samples compete for the estimate;
    it is the drift horizon — with heartbeats every ``h`` seconds the
    offset is never older than ``window * h``.
    """

    def __init__(self, window: int = 16) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        # (rtt_s, offset_s) most-recent-last; the estimate is the min-rtt
        # entry, ties broken toward the newest sample (drift tracking).
        self._samples: Deque[Tuple[float, float]] = deque(maxlen=self.window)
        self._n_observed = 0
        self._lock = threading.Lock()

    def observe(self, t_send: float, t_recv: float, t_remote: float) -> None:
        """Fold in one round trip. ``t_send``/``t_recv`` are LOCAL clock
        reads bracketing the RPC; ``t_remote`` is the peer's clock read
        from the reply. Samples with a non-positive RTT (a caller bug or
        a clock step mid-call) are discarded rather than poisoning the
        estimate."""
        rtt = t_recv - t_send
        if rtt < 0:
            return
        offset = (t_send + t_recv) / 2.0 - t_remote
        with self._lock:
            self._samples.append((rtt, offset))
            self._n_observed += 1

    def _best_locked(self) -> Optional[Tuple[float, float]]:
        best = None
        for rtt, offset in self._samples:  # newest-last wins ties
            if best is None or rtt <= best[0]:
                best = (rtt, offset)
        return best

    @property
    def n_samples(self) -> int:
        with self._lock:
            return self._n_observed

    @property
    def offset_s(self) -> Optional[float]:
        """Local = remote + offset; None until the first sample."""
        with self._lock:
            best = self._best_locked()
        return best[1] if best is not None else None

    @property
    def error_bound_s(self) -> Optional[float]:
        """Worst-case |true - estimated| offset: half the RTT of the
        sample the estimate came from."""
        with self._lock:
            best = self._best_locked()
        return best[0] / 2.0 if best is not None else None

    def to_local(self, t_remote: float) -> Optional[float]:
        """Map a remote perf_counter timestamp into the local timeline;
        None when no sample has been observed yet."""
        with self._lock:
            best = self._best_locked()
        if best is None:
            return None
        return t_remote + best[1]

    def reset(self) -> None:
        """Discard all samples (new connection generation: the peer —
        and therefore its clock epoch — may have been replaced)."""
        with self._lock:
            self._samples.clear()

    def snapshot(self) -> dict:
        with self._lock:
            best = self._best_locked()
            n = self._n_observed
        if best is None:
            return {"offset_s": None, "error_bound_s": None, "n_samples": n}
        return {
            "offset_s": best[1],
            "error_bound_s": best[0] / 2.0,
            "n_samples": n,
        }
