"""HTTP/SSE serving gateway over the EngineLoop — stdlib only (the JAX
package's ``frontend/gateway.py``).

A deliberately small, dependency-free frontend (http.server's
ThreadingHTTPServer): one handler thread per connection blocks on its
request's stream queue while the single engine-loop thread does all
device work. Endpoints:

  POST /v1/generate   JSON in -> full JSON response, or SSE token
                      streaming when ``"stream": true`` (one
                      ``data: {...}`` event per committed token, then a
                      terminal ``data: {"done": ...}`` and
                      ``data: [DONE]``); an inbound W3C ``traceparent``
                      header joins the caller's trace (when the loop has
                      a tracer), and terminal bodies carry ``trace_id``
                      plus — behind a fleet router — ``replica`` (which
                      one served the final attempt) and ``redrives``, so
                      a client can correlate its response with the
                      request's lineage tree without parsing the trace;
  GET  /healthz       liveness + queue gauges + engine-loop staleness
                      (seconds since the last scheduler turn; 503 past
                      ``healthz_stale_after_s`` — a wedged loop must not
                      look like a healthy idle process);
  GET  /readyz        readiness, distinct from liveness: 503 while the
                      backend is draining or has no replica accepting
                      traffic (rolling restarts pull a replica from the
                      balancer via /readyz while /healthz stays green —
                      alive-but-not-ready must not get new work);
  GET  /metrics       Prometheus text exposition: the loop's typed
                      registry (counters/histograms) when wired, plus
                      loop/engine/admission gauges and typed HTTP
                      counters (``..._total``);
  GET  /slo           the live SLO snapshot (observability/slo.py):
                      rolling-window latency distributions (sketch
                      percentiles per replica + fleet-wide), per-class
                      error-budget status and burn rates, active/
                      recently-resolved alerts — and, behind a fleet
                      router, the aggregated worker health gauges
                      (Router.fleet_health). 404 when no SLO engine is
                      wired (``slo=`` here or a router with one);
  GET  /metricsz      the same numbers /metrics exposes, as one JSON
                      object (machine-readable: ``gauges`` is the
                      loop's counter snapshot, ``series`` the typed
                      registry snapshot when wired) — for pollers that
                      want values without parsing Prometheus text.

``loop`` is anything with the EngineLoop surface — a single EngineLoop or
a fleet Router (frontend/router.py); the gateway never inspects which.

Request schema (unknown keys are a 400 — a typo'd knob must not be
silently ignored):

  {"prompt": [1, 2, 3] | "text...",   # token ids, or text with a tokenizer
   "max_new_tokens": 32,              # required positive int
   "stream": false,                   # SSE streaming
   "deadline_s": 2.5,                 # optional per-request deadline
   "priority": 0}                     # brownout shedding order (fleet)

Status mapping: validation error 400, backpressure 429 (+ Retry-After),
infeasible/missed deadline 504, client-cancelled 499, engine failure 500.
The body always carries the lifecycle latencies the engine measured
(queue_wait_s / ttft_s / e2e_s).

Retry-After semantics: the header on a 429 is the admission controller's
base hint plus a small DETERMINISTIC jitter — a seeded PRNG sequence
(``retry_jitter_seed``), not wall-clock randomness — so a burst of
rejected clients that all honor the header fan out over
``[base, base * (1 + retry_jitter_frac)]`` instead of thundering back in
lockstep at a recovering fleet, while any run remains exactly
reproducible under a fixed seed. Values are whole seconds (RFC 7231
delta-seconds), never below 1.
"""

from __future__ import annotations

import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from pretraining_llm_tpu_torch.frontend.admission import (
    RejectedBusy,
    RejectedInfeasible,
)
from pretraining_llm_tpu_torch.observability.export import prometheus_lines

_MAX_BODY_BYTES = 16 * 1024 * 1024
_REQUEST_KEYS = {"prompt", "max_new_tokens", "stream", "deadline_s", "priority"}


class _BadRequest(Exception):
    pass


class ServingGateway:
    """Owns the HTTP server; ``loop`` must already be started.

    ``encode``/``decode`` (optional) let clients send/receive text instead
    of token ids. ``port=0`` binds an ephemeral port (tests); read it back
    from ``.port``.
    """

    def __init__(
        self,
        loop: Any,
        *,
        host: str = "127.0.0.1",
        port: int = 8000,
        encode: Optional[Callable[[str], Any]] = None,
        decode: Optional[Callable[[Any], str]] = None,
        default_deadline_s: float = 0.0,
        healthz_stale_after_s: float = 0.0,
        retry_jitter_frac: float = 0.25,
        retry_jitter_seed: int = 0,
        slo: Optional[Any] = None,
    ) -> None:
        if healthz_stale_after_s < 0:
            raise ValueError(
                f"healthz_stale_after_s must be >= 0 (0 = disabled), got "
                f"{healthz_stale_after_s}"
            )
        if not 0.0 <= retry_jitter_frac <= 1.0:
            raise ValueError(
                f"retry_jitter_frac must be in [0, 1] (0 = no jitter), got "
                f"{retry_jitter_frac}"
            )
        self.loop = loop
        self.encode = encode
        self.decode = decode
        # Live SLO engine for GET /slo on the single-loop path; behind a
        # fleet router the loop's own slo_snapshot() wins (it folds the
        # aggregated worker health in).
        self.slo = slo
        self.default_deadline_s = float(default_deadline_s)
        # 0 disables the staleness 503: a cold-start kernel build can
        # legitimately hold the loop thread for minutes, so the threshold
        # is opt-in and deployment-tuned.
        self.healthz_stale_after_s = float(healthz_stale_after_s)
        # Deterministic-seeded Retry-After jitter (see module docstring):
        # one PRNG sequence per gateway, lock-guarded because handler
        # threads draw from it concurrently.
        self.retry_jitter_frac = float(retry_jitter_frac)
        self._retry_rng = random.Random(int(retry_jitter_seed))
        self._retry_rng_lock = threading.Lock()
        self._counters_lock = threading.Lock()
        self.http_counters: Dict[str, int] = {}
        gateway = self

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        class _Handler(_GatewayHandler):
            pass

        _Handler.gateway = gateway
        self._server = _Server((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "ServingGateway":
        """Serve on a background thread (scripts serve_forever inline)."""
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="gateway", daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def count_response(self, code: int) -> None:
        with self._counters_lock:
            key = f"http_responses_{code}"
            self.http_counters[key] = self.http_counters.get(key, 0) + 1
            self.http_counters["http_requests_total"] = (
                self.http_counters.get("http_requests_total", 0) + 1
            )

    def _http_counter_lines(self) -> str:
        """The HTTP tallies as VALID Prometheus counters: one
        ``http_requests_total`` plus ``http_responses_total{code=...}``
        children (the per-code dict keys become a label, which is what
        they always were)."""
        with self._counters_lock:
            http = dict(self.http_counters)
        lines = [
            "# TYPE pllm_serving_http_requests_total counter",
            "pllm_serving_http_requests_total "
            f"{float(http.get('http_requests_total', 0))}",
            "# TYPE pllm_serving_http_responses_total counter",
        ]
        for key in sorted(http):
            if key.startswith("http_responses_"):
                code = key.rsplit("_", 1)[1]
                lines.append(
                    f'pllm_serving_http_responses_total{{code="{code}"}} '
                    f"{float(http[key])}"
                )
        return "\n".join(lines) + "\n"

    def retry_after_header(self, base_s: float) -> str:
        """Whole-second Retry-After value with deterministic-seeded jitter
        over ``[base, base * (1 + retry_jitter_frac)]``; never below 1."""
        with self._retry_rng_lock:
            u = self._retry_rng.random()
        jittered = float(base_s) * (1.0 + u * self.retry_jitter_frac)
        return f"{max(1, round(jittered))}"

    def metrics_text(self) -> str:
        merged: Dict[str, float] = dict(self.loop.metrics())
        render = getattr(self.loop, "render_metrics", None)
        if render is not None:
            # Fleet router: merged exposition over the fleet registry and
            # every replica's labeled registry, then the HTTP counters.
            return render(merged) + self._http_counter_lines()
        registry = getattr(self.loop, "registry", None)
        if registry is not None:
            # Typed series (counters + latency histograms) first, then the
            # legacy loop/engine/admission snapshot as gauges, then the
            # HTTP counters — one exposition, lint-clean.
            body = registry.render(extra_gauges=merged)
        else:
            body = prometheus_lines(merged, prefix="pllm_serving_")
        return body + self._http_counter_lines()


class _GatewayHandler(BaseHTTPRequestHandler):
    gateway: ServingGateway  # installed per-subclass by ServingGateway
    protocol_version = "HTTP/1.1"

    # Route server chatter away from stderr; the gateway is not a log.
    def log_message(self, fmt: str, *args: Any) -> None:
        pass

    # -- plumbing -----------------------------------------------------------

    def _send_json(self, code: int, payload: Dict[str, Any], **headers: str) -> None:
        body = (json.dumps(payload) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        for k, v in headers.items():
            self.send_header(k.replace("_", "-"), v)
        self.end_headers()
        self.wfile.write(body)
        self.gateway.count_response(code)

    def _read_json_body(self) -> Dict[str, Any]:
        length = self.headers.get("Content-Length")
        if length is None:
            raise _BadRequest("missing Content-Length")
        try:
            n = int(length)
        except ValueError:
            raise _BadRequest(f"bad Content-Length {length!r}")
        if n > _MAX_BODY_BYTES:
            raise _BadRequest(f"body too large ({n} bytes)")
        try:
            payload = json.loads(self.rfile.read(n).decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise _BadRequest(f"invalid JSON body: {e}")
        if not isinstance(payload, dict):
            raise _BadRequest("body must be a JSON object")
        return payload

    # -- GET ----------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        if self.path == "/healthz":
            gw = self.gateway
            m = gw.loop.metrics()
            age = gw.loop.last_turn_age_s()
            stale = (
                gw.healthz_stale_after_s > 0
                and age > gw.healthz_stale_after_s
            )
            self._send_json(503 if stale else 200, {
                "status": "stale" if stale else "ok",
                "active_requests": m.get("active_requests", 0),
                "completed": m.get("completed", 0),
                "engine_loop_last_turn_age_s": round(age, 3),
            })
        elif self.path == "/readyz":
            gw = self.gateway
            ready_fn = getattr(gw.loop, "readiness", None)
            if ready_fn is None:
                # Backend without drain support: ready iff alive enough to
                # take a submit (best-effort parity with old behavior).
                body = {"ready": True}
            else:
                body = dict(ready_fn())
            ok = bool(body.get("ready", False))
            body["status"] = "ready" if ok else "not-ready"
            self._send_json(200 if ok else 503, body)
        elif self.path == "/metrics":
            body = self.gateway.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            self.gateway.count_response(200)
        elif self.path.split("?", 1)[0] == "/slo":
            gw = self.gateway
            snap_fn = getattr(gw.loop, "slo_snapshot", None)
            if snap_fn is not None:
                self._send_json(200, snap_fn())
            elif gw.slo is not None:
                self._send_json(200, gw.slo.snapshot())
            else:
                self._send_json(
                    404, {"error": "no SLO engine configured"}
                )
        elif self.path.split("?", 1)[0] == "/metricsz":
            gw = self.gateway
            body: Dict[str, Any] = {"gauges": gw.loop.metrics()}
            registry = getattr(gw.loop, "registry", None)
            if registry is not None and hasattr(registry, "snapshot"):
                body["series"] = registry.snapshot()
            with gw._counters_lock:
                body["http"] = dict(gw.http_counters)
            self._send_json(200, body)
        elif self.path.split("?", 1)[0] == "/debug/requests":
            # Live per-request introspection — best-effort reads off the
            # hot path (see EngineLoop.debug_requests); stale by at most
            # one scheduler turn, never torn.
            self._send_json(200, {"requests": self.gateway.loop.debug_requests()})
        elif self.path.split("?", 1)[0] == "/debug/engine":
            self._send_json(200, self.gateway.loop.debug_engine())
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    # -- POST /v1/generate --------------------------------------------------

    def do_POST(self) -> None:  # noqa: N802
        if self.path != "/v1/generate":
            # The body was never read: on a keep-alive connection the next
            # pipelined request would be parsed from these body bytes, so
            # close instead of corrupting the framing.
            self.close_connection = True
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        gw = self.gateway
        try:
            payload = self._read_json_body()
            prompt, max_new, stream, deadline_s, priority = (
                self._parse_request(payload)
            )
        except _BadRequest as e:
            # Some rejections (missing/huge Content-Length) fire before the
            # body is read — same unread-body framing hazard as above.
            self.close_connection = True
            self._send_json(400, {"error": str(e)})
            return
        trace = None
        tracer = getattr(gw.loop, "tracer", None)
        if tracer is not None:
            # Gateway accept is where the trace is minted: an inbound W3C
            # traceparent joins the caller's trace (its sampling decision
            # honored), otherwise head-sampling applies.
            trace = tracer.begin_request(self.headers.get("traceparent"))
        err_fields = (
            {"trace_id": trace.trace_id} if trace is not None else {}
        )
        try:
            req = gw.loop.submit(
                prompt, max_new, deadline_s=deadline_s, trace=trace,
                priority=priority,
            )
        except ValueError as e:
            # The engine's submit-time validation: the 4xx that replaces a
            # downstream shape error.
            self._send_json(400, {"error": str(e), **err_fields})
            return
        except RejectedBusy as e:
            self._send_json(
                429, {"error": f"overloaded: {e.reason}", **err_fields},
                Retry_After=gw.retry_after_header(e.retry_after_s),
            )
            return
        except RejectedInfeasible as e:
            self._send_json(
                504,
                {"error": f"deadline cannot be met: {e.reason}", **err_fields},
            )
            return
        except RuntimeError as e:
            # EngineLoop stopped (or died) between the health check and the
            # enqueue: the process is going away, tell the client to go
            # elsewhere rather than killing the handler thread.
            self.close_connection = True
            self._send_json(503, {"error": str(e)})
            return
        if stream:
            self._respond_sse(req)
        else:
            self._respond_full(req)

    def _parse_request(self, payload: Dict[str, Any]):
        unknown = set(payload) - _REQUEST_KEYS
        if unknown:
            raise _BadRequest(
                f"unknown request keys {sorted(unknown)}; expected subset "
                f"of {sorted(_REQUEST_KEYS)}"
            )
        if "prompt" not in payload:
            raise _BadRequest("missing 'prompt'")
        if "max_new_tokens" not in payload:
            raise _BadRequest("missing 'max_new_tokens'")
        prompt = payload["prompt"]
        if isinstance(prompt, str):
            if self.gateway.encode is None:
                raise _BadRequest(
                    "text prompts need a tokenizer; this gateway accepts "
                    "token-id lists only"
                )
            prompt = list(self.gateway.encode(prompt))
        elif not isinstance(prompt, list):
            raise _BadRequest("'prompt' must be a string or a list of ints")
        max_new = payload["max_new_tokens"]
        if isinstance(max_new, bool) or not isinstance(max_new, int):
            raise _BadRequest("'max_new_tokens' must be an integer")
        stream = payload.get("stream", False)
        if not isinstance(stream, bool):
            raise _BadRequest("'stream' must be a boolean")
        deadline_s = payload.get("deadline_s")
        if deadline_s is not None:
            if isinstance(deadline_s, bool) or not isinstance(
                deadline_s, (int, float)
            ):
                raise _BadRequest("'deadline_s' must be a number")
            deadline_s = float(deadline_s)
            if deadline_s <= 0:
                raise _BadRequest("'deadline_s' must be > 0")
        elif self.gateway.default_deadline_s > 0:
            deadline_s = self.gateway.default_deadline_s
        priority = payload.get("priority", 0)
        if isinstance(priority, bool) or not isinstance(priority, int):
            raise _BadRequest("'priority' must be an integer")
        return prompt, max_new, stream, deadline_s, priority

    _STATUS_CODE = {"done": 200, "expired": 504, "cancelled": 499, "error": 500}

    def _respond_full(self, req: Any) -> None:
        status, tokens, info = req.result()
        body: Dict[str, Any] = {"status": status, "tokens": tokens, **info}
        if status != "done":
            body["error"] = {
                "expired": "deadline exceeded during generation",
                "cancelled": "request cancelled",
                "error": f"engine failure: {info.get('reason', 'unknown')}",
            }[status]
        if self.gateway.decode is not None:
            body["text"] = self.gateway.decode(tokens)
        try:
            self._send_json(self._STATUS_CODE[status], body)
        except (BrokenPipeError, ConnectionResetError, OSError):
            # Client went away while we were blocked on the result. The
            # request is already terminal by now, so cancel() is a no-op
            # belt-and-suspenders; what matters is not letting the handler
            # thread die with a traceback and counting the response as the
            # 499 it effectively was (the 200 in _send_json was never
            # counted — count_response comes after the failed write).
            self.gateway.loop.cancel(req)
            self.gateway.count_response(499)
            self.close_connection = True

    def _respond_sse(self, req: Any) -> None:
        gw = self.gateway
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()
        code = 200
        try:
            i = 0
            for ev in req.events():
                if ev[0] == "token":
                    self._sse_data({"token": ev[1], "index": i})
                    i += 1
                else:  # ("end", status, info)
                    _, status, info = ev
                    final: Dict[str, Any] = {
                        "done": True, "status": status, **info
                    }
                    if gw.decode is not None:
                        final["text"] = gw.decode(req.tokens)
                    self._sse_data(final)
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                    code = self._STATUS_CODE[status]
        except (BrokenPipeError, ConnectionResetError, OSError):
            # Client went away mid-stream: release the row and pool blocks
            # now rather than decoding tokens nobody will read.
            gw.loop.cancel(req)
            code = 499
        gw.count_response(code)

    def _sse_data(self, obj: Dict[str, Any]) -> None:
        self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
        self.wfile.flush()
