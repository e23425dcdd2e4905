"""Backpressure and deadline-aware admission for the serving frontend (the
JAX package's ``frontend/admission.py``).

The engine already has an internal admission watermark (rows + pool
blocks), but that only protects the DEVICE: an unbounded submission queue
still grows without limit under overload, and every queued request pays
its whole queue wait before learning it cannot finish by its deadline.
This controller is the gate the gateway consults BEFORE a request enters
the system:

  - bounded in-system depth: at most ``max_queue_depth`` requests admitted
    and not yet terminal -> excess is rejected with ``RejectedBusy``
    (HTTP 429 + Retry-After), the load-shedding answer that keeps queue
    waits bounded instead of letting tail latency run away;
  - outstanding-token budget: the sum of ``prompt + max_new_tokens`` over
    live requests is capped — ten 8-token requests and one 8000-token
    request are not the same load, and a depth bound alone cannot see
    that;
  - deadline-aware shedding: once a TPOT estimate exists (EWMA over
    completed requests), a request whose minimum service time already
    exceeds its deadline is rejected up front with ``RejectedInfeasible``
    (HTTP 504) instead of wasting pool pages to miss it.

All host-side, lock-protected, called from gateway threads; ``release``
is called by the engine loop at each request's terminal event.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional


class RejectedBusy(Exception):
    """The system is at capacity; retry after ``retry_after_s``."""

    def __init__(self, reason: str, retry_after_s: float) -> None:
        super().__init__(reason)
        self.reason = reason
        self.retry_after_s = retry_after_s


class RejectedInfeasible(Exception):
    """The request's deadline cannot be met even if it ran alone."""

    def __init__(self, reason: str, estimate_s: float) -> None:
        super().__init__(reason)
        self.reason = reason
        self.estimate_s = estimate_s


@dataclasses.dataclass
class Ticket:
    """One admitted request's claim on the budgets; hand back to
    ``release`` exactly once at the request's terminal event."""

    cost_tokens: int
    released: bool = False


class AdmissionController:
    def __init__(
        self,
        *,
        max_queue_depth: int = 64,
        max_outstanding_tokens: int = 0,
        retry_after_s: float = 1.0,
        shed_infeasible: bool = True,
        tpot_ewma_alpha: float = 0.2,
        registry: Optional[object] = None,
        scope: str = "",
    ) -> None:
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}"
            )
        if max_outstanding_tokens < 0:
            raise ValueError(
                f"max_outstanding_tokens must be >= 0 (0 = unlimited), got "
                f"{max_outstanding_tokens}"
            )
        if not 0.0 < tpot_ewma_alpha <= 1.0:
            raise ValueError(
                f"tpot_ewma_alpha must be in (0, 1], got {tpot_ewma_alpha}"
            )
        self.max_queue_depth = int(max_queue_depth)
        self.max_outstanding_tokens = int(max_outstanding_tokens)
        self.retry_after_s = float(retry_after_s)
        self.shed_infeasible = bool(shed_infeasible)
        self._alpha = float(tpot_ewma_alpha)
        self._lock = threading.Lock()
        self._live = 0
        self._outstanding_tokens = 0
        self._tpot_ewma: Optional[float] = None
        self.stats: Dict[str, int] = {
            "admitted": 0, "rejected_busy": 0, "rejected_infeasible": 0,
        }
        # Typed live counters (observability.metrics.MetricsRegistry):
        # the same tallies as `stats`, but as real Prometheus counters
        # with the rejection reason as a label. None = untyped only.
        self._c_admitted = self._c_rejected = None
        self._g_depth = self._g_tokens = None
        # ``scope`` distinguishes multiple controllers on ONE registry
        # (the fleet router's budget vs. each replica's own): it becomes a
        # label on every typed series here, so the names stay shared while
        # the samples stay apart. "" = no label (the single-engine case,
        # and replicas whose registries already carry a const replica
        # label).
        sl = {"scope": scope} if scope else {}
        self.scope = scope
        if registry is not None:
            self._c_admitted = registry.counter(
                "admission_admitted_total", "requests admitted", **sl)
            self._c_rejected = {
                reason: registry.counter(
                    "admission_rejected_total",
                    "requests rejected at admission", reason=reason, **sl)
                for reason in ("busy", "infeasible")
            }
            # Live-budget gauges: the numbers snapshot() reports, but as
            # typed series a scraper can alert on (depth vs. its limit is
            # the saturation signal capacity attribution keys off).
            self._g_depth = registry.gauge(
                "admission_queue_depth",
                "requests admitted and not terminal", **sl)
            self._g_tokens = registry.gauge(
                "admission_outstanding_tokens",
                "sum of prompt+max_new over live requests", **sl)
            registry.gauge(
                "admission_queue_depth_limit", "max_queue_depth", **sl
            ).set(self.max_queue_depth)
            registry.gauge(
                "admission_outstanding_tokens_limit",
                "max_outstanding_tokens (0 = unlimited)", **sl
            ).set(self.max_outstanding_tokens)

    # -- queries ------------------------------------------------------------

    @property
    def live(self) -> int:
        with self._lock:
            return self._live

    @property
    def outstanding_tokens(self) -> int:
        with self._lock:
            return self._outstanding_tokens

    def estimate_service_s(self, max_new_tokens: int) -> Optional[float]:
        """Minimum-service-time estimate for a request: decode only, zero
        queueing — deliberately OPTIMISTIC, so shedding on it never
        rejects a request that had any chance (None until a completed
        request has taught the controller a TPOT)."""
        with self._lock:
            tpot = self._tpot_ewma
        if tpot is None:
            return None
        return max_new_tokens * tpot

    # -- admit / release ----------------------------------------------------

    def try_admit(
        self,
        n_prompt_tokens: int,
        max_new_tokens: int,
        deadline_s: Optional[float] = None,
        cached_tokens: int = 0,
    ) -> Ticket:
        """Admit or raise. ``deadline_s`` is the request's REMAINING time
        budget in seconds (None = no deadline). ``cached_tokens`` is the
        engine's prefix-cache hint: prompt tokens already resident in
        shared KV blocks cost no prefill and no new pool pages, so they
        don't count against the outstanding-token budget — cache hits buy
        admission headroom. Capped at n_prompt - 1 (the final prompt
        token always prefills privately)."""
        discount = min(
            max(0, int(cached_tokens)), max(0, int(n_prompt_tokens) - 1)
        )
        cost = int(n_prompt_tokens) - discount + int(max_new_tokens)
        if self.shed_infeasible and deadline_s is not None:
            if deadline_s <= 0:
                with self._lock:
                    self.stats["rejected_infeasible"] += 1
                if self._c_rejected is not None:
                    self._c_rejected["infeasible"].inc()
                raise RejectedInfeasible("deadline already expired", 0.0)
            est = self.estimate_service_s(max_new_tokens)
            if est is not None and est > deadline_s:
                with self._lock:
                    self.stats["rejected_infeasible"] += 1
                if self._c_rejected is not None:
                    self._c_rejected["infeasible"].inc()
                raise RejectedInfeasible(
                    f"needs ~{est:.3f}s of decode but only {deadline_s:.3f}s "
                    f"remain before the deadline",
                    est,
                )
        try:
            with self._lock:
                if self._live >= self.max_queue_depth:
                    self.stats["rejected_busy"] += 1
                    raise RejectedBusy(
                        f"{self._live} requests in flight (limit "
                        f"{self.max_queue_depth})",
                        self.retry_after_s,
                    )
                if (
                    self.max_outstanding_tokens
                    and self._outstanding_tokens + cost > self.max_outstanding_tokens
                ):
                    self.stats["rejected_busy"] += 1
                    raise RejectedBusy(
                        f"outstanding-token budget exhausted "
                        f"({self._outstanding_tokens} + {cost} > "
                        f"{self.max_outstanding_tokens})",
                        self.retry_after_s,
                    )
                self._live += 1
                self._outstanding_tokens += cost
                self.stats["admitted"] += 1
        except RejectedBusy:
            if self._c_rejected is not None:
                self._c_rejected["busy"].inc()
            raise
        if self._c_admitted is not None:
            self._c_admitted.inc()
        if self._g_depth is not None:
            self._g_depth.inc()
            self._g_tokens.inc(cost)
        return Ticket(cost_tokens=cost)

    def release(self, ticket: Ticket, *, tpot_s: Optional[float] = None) -> None:
        """Return a ticket's budget; ``tpot_s`` (seconds per OUTPUT token
        of the completed request) feeds the shedding estimate."""
        with self._lock:
            if ticket.released:
                return
            ticket.released = True
            self._live -= 1
            self._outstanding_tokens -= ticket.cost_tokens
            if self._g_depth is not None:
                self._g_depth.dec()
                self._g_tokens.dec(ticket.cost_tokens)
            if tpot_s is not None and tpot_s > 0:
                if self._tpot_ewma is None:
                    self._tpot_ewma = tpot_s
                else:
                    self._tpot_ewma += self._alpha * (tpot_s - self._tpot_ewma)

    def snapshot(self) -> Dict[str, float]:
        """Counters + live budgets for /metrics and capacity sampling."""
        with self._lock:
            out: Dict[str, float] = dict(self.stats)
            out["live_requests"] = self._live
            out["outstanding_tokens"] = self._outstanding_tokens
            out["max_queue_depth"] = self.max_queue_depth
            out["max_outstanding_tokens"] = self.max_outstanding_tokens
            if self._tpot_ewma is not None:
                out["tpot_ewma_s"] = self._tpot_ewma
        return out
