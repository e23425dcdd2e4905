"""Out-of-process serving worker: one Replica behind a socket (the JAX
package's ``frontend/worker.py`` over the port's engine).

``python -m pretraining_llm_tpu_torch.frontend.worker --spec-json '...'``
owns exactly one :class:`frontend.replica.Replica` (engine factory +
admission + per-replica registry — the same internals the in-process
fleet uses) and serves it over the length-prefixed JSON protocol in
``frontend/wire.py``. The parent side is
:class:`frontend.remote_replica.RemoteReplica`; together they move the
replica fault domain across a real process boundary so a kill -9, a
wedged loop, or a dropped connection exercises the SAME eject/redrive
machinery the in-process drills do.

Startup handshake: the worker binds an ephemeral port and prints one
line — ``{"worker": {"port": ..., "pid": ...}}`` — to stdout BEFORE the
slow engine build, then builds the engine and starts accepting. The
parent connects immediately (the connect lands in the listen backlog)
and sends ``hello``; the reply arrives once the engine is up, so the
parent's hello timeout is the engine-build budget.

Client protocol (every request frame carries ``id``; replies echo it):

==============  ======================================================
op              semantics
==============  ======================================================
hello           engine construction constants (validate_request inputs)
submit          lane="replica" -> Replica.submit (state gate + fault
                clock); lane="loop" -> EngineLoop.submit directly (the
                sentinel/vetting path, priority -1, no fault clock) —
                reply carries rid; token/end frames stream after it
cancel          EngineLoop.cancel by rid
drain           Replica.drain() (loop.begin_drain + state)
health          running/draining/active_requests/last_turn_age_s/...
health_pull     the health reply PLUS worker-side gauges (engine row/
                KV-pool occupancy, queue + admission depths, KV-
                migration counters, stale-frame drops, device HBM
                watermarks) and the worker's rolling-window latency
                sketches (observability/sketches.py, serialized) — the
                router's fleet health snapshot aggregates these. Doubles
                as a lease heartbeat exactly like ``health``. proto >= 4
                peers only (the parent gates sends).
metrics         EngineLoop.metrics() snapshot
debug_requests  EngineLoop.debug_requests()
debug_engine    EngineLoop.debug_engine()
probe_set       build_probe_set on the worker's own params (serialized
                prompts/expected) — runs on a side thread so health
                polls stay live during the reference generates
kv_fetch        serialize the longest cached KV chain for ``prompt``
                (frontend/kv_transfer.py): the pages stream back as
                unsolicited ``kv_page`` frames keyed by ``fetch``=id,
                then the reply summarizes pages/bytes/frames. Runs on a
                side thread (device pulls per page) so health polls stay
                live. proto >= 3 peers only (the parent gates sends).
kv_page         one inbound frame of a page PUSH (router -> this worker,
                the decode tier's receive side): frames accumulate per
                ``xfer`` id; the final frame (the one carrying ``id``)
                triggers loop-thread adoption behind the prefix-cache
                publish path and the summary reply. Frames whose fence
                generation predates this worker's current fence are
                dropped — stale pages from before an eject never enter
                the pool.
prefix_flush    flush the prefix cache on the loop thread (the port's
                op: the router pins each golden probe through a prefix-
                cache miss and a hit, and a worker's cache must be empty
                for the miss); the hello's ``prefix_cache`` says whether
                the worker has one
shutdown        reply ok, then loop.stop() and exit 0
stall           NO reply, stop reading frames (fault drill: the parent
                sees RPC timeouts from a process that is still alive)
==============  ======================================================

Unsolicited frames: ``{"token": rid, "t": tok}`` and ``{"end": rid,
"status": ..., "info": ...}`` per streamed request, and ``{"op":
"event", ...}`` forwarding the replica's bus events to the parent
(``replica_state`` is filtered out — the parent's state machine is
authoritative for fleet lifecycle events).

Robustness hooks baked into the worker itself:

- orphan detection: a reader thread blocks on stdin (the parent holds
  the write end of the pipe and never writes); EOF means the parent
  died, so the worker drains, waits briefly for in-flight work, and
  exits — killed routers never leak workers. SIGTERM takes the same
  path.
- multi-host attach mode: ``--listen host:port --token <secret>``
  serves a PRE-SPAWNED worker over TCP. The router connects by address
  instead of spawning; the first frame on every connection must be a
  ``hello`` carrying the shared token (the reply carries the engine
  weight fingerprint, so the router can refuse a worker serving the
  wrong weights). There is no stdin pipe to watch, so the orphan watch
  is replaced by a **heartbeat lease**: every frame from the router
  (health polls are the heartbeat carrier) refreshes the lease; if the
  router is unreachable for the ``lease_s`` the hello granted, the
  worker stops admitting, cancels its in-flight work (the router has
  redriven it elsewhere by now — serving it further risks double
  serve), and PARKS listening for the next attach instead of exiting.
- fencing: the hello (and every health heartbeat) carries the router's
  monotonically increasing fence generation for this replica; the
  worker stamps the generation it held AT SUBMIT TIME onto every
  stream frame (``"g"``) and the current generation onto replies and
  events. After a partition-then-heal, frames from before the router
  ejected this replica carry a stale generation and the parent drops
  them — a healed worker can never stream duplicate tokens into a
  request a survivor already answered.
- ``kill_after_submits: N`` in the spec: SIGKILL *itself* right after
  acknowledging the Nth wire submit (either lane) — this is how the
  mid-upgrade-kill drill crashes the upgrading worker inside its
  probe-vetting window, deterministically.
- ``corrupt_weights: true`` in the spec: the engine factory flips the
  sign of the largest weight leaf after build (same mutation as the
  ``corrupt_weights`` serving fault) — a checkpoint that serves wrong
  answers without crashing, for refused-upgrade drills.

The engine runs on the spec's ``device`` (default ``"cuda"``; ``"cpu"``
runs the kernels' plain versions). A worker asked for ``cuda`` without a
card fails its start: it never serves from the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Dict, Optional

from ..observability.sketches import WindowedSketch
from ..observability.slo import LATENCY_METRICS, TERMINAL_KINDS
from ..observability.spans import SpanRecorder
from ..observability.tracing import Tracer
from .wire import (
    PROTO_VERSION,
    ConnectionLost,
    ProtocolError,
    recv_frame,
    send_frame,
)

_ORPHAN_DRAIN_S = 10.0


def build_engine_factory(spec: Dict[str, Any]):
    """Engine factory from a worker spec. Two weight sources:

    - ``model_path``: load a checkpoint of either package exactly like the
      serve CLI (load_model_for_inference -> cast_params_for_inference ->
      optional quantize_params_for_serving), on the spec's device.
    - ``preset`` + ``init_seed``: the port's deterministic random init
      (``init_params`` with a CPU ``torch.Generator`` seeded from
      ``init_seed``, so every worker of a fleet holds the same weights).
      It is not the JAX package's init: a fleet held against the JAX
      engine loads a checkpoint instead.

    Imports live here, not at module top: argparse errors and wire unit
    tests must not pay (or require) the torch import.
    """
    import dataclasses

    import torch

    from ..config import get_preset
    from ..generation.serving import ServingEngine

    device = str(spec.get("device") or "cuda")
    model_path = str(spec.get("model_path") or "")
    if model_path:
        from ..generation.generate import (
            cast_params_for_inference,
            load_model_for_inference,
        )

        params, full_cfg = load_model_for_inference(
            model_path, use_ema=bool(spec.get("ema", False)), device=device
        )
        cfg = full_cfg.model
        params = cast_params_for_inference(params, cfg)
    else:
        from ..models import transformer

        cfg = get_preset(str(spec.get("preset", "tiny"))).model
        overrides = dict(spec.get("model_overrides") or {})
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        params = transformer.init_params(
            cfg,
            torch.Generator().manual_seed(int(spec.get("init_seed", 0))),
            device=device,
        )

    quantize = str(spec.get("quantize") or "none")
    if quantize != "none":
        from ..models import quantize as quantize_mod

        params = quantize_mod.quantize_params_for_serving(params, cfg)

    if spec.get("corrupt_weights"):
        from ..resilience.faults import ServingFaultInjector

        holder = type("_ParamsHolder", (), {})()
        holder.params = params
        ServingFaultInjector._fire_corrupt_weights(holder)
        params = holder.params

    engine_kw = dict(spec.get("engine") or {})
    engine_kw.setdefault("temperature", 0.0)
    engine_kw.setdefault("device", device)
    if quantize != "none":
        engine_kw.setdefault("quantize", quantize)

    def factory():
        return ServingEngine(params, cfg, **engine_kw)

    return factory


class _ForwardBus:
    """Bus facade handed to the worker's Replica: forwards events over
    the wire instead of writing JSONL. ``replica_state`` is dropped
    (the parent Replica state machine emits those); everything else is
    buffered until a client is connected, then streamed."""

    def __init__(self, worker: "WorkerServer") -> None:
        self._worker = worker

    def emit(self, kind: str, step: int = 0, **fields: Any) -> None:
        if kind == "replica_state":
            return
        self._worker.send_event(kind, step, fields)

    def close(self) -> None:  # Replica's _TaggedBus calls this; no-op
        pass


class WorkerServer:
    def __init__(self, spec: Dict[str, Any]) -> None:
        self.spec = spec
        self.index = int(spec.get("index", 0))
        self._kill_after = int(spec.get("kill_after_submits", 0))
        self._wire_submits = 0
        self._shutdown = threading.Event()
        self._conn: Optional[socket.socket] = None
        self._wlock = threading.Lock()
        self._event_buf: list = []
        # wrid -> (attempt, fence generation held when it was submitted):
        # stream frames carry the SUBMIT-time generation, so work from
        # before an eject stays distinguishable after a heal/re-attach.
        self._attempts: Dict[int, Any] = {}
        self.replica = None  # set in start_replica()

        # Cross-process tracing: the worker records the SAME engine span
        # set an in-process replica would (queue/prefill/window/...) into
        # a local recorder, then ships them to the router in batched
        # ``spans`` frames after each stream ends. sample=0.0 means the
        # worker NEVER originates a trace of its own — it only joins
        # traces the router propagates via ``traceparent`` on submit
        # (begin_request honors the inbound sampled flag verbatim). Each
        # process has its own perf_counter epoch; the parent's clock
        # estimator maps these timestamps into its own timeline.
        self.recorder = SpanRecorder(
            max_events=int(spec.get("trace_buffer", 20000))
        )
        self.tracer = Tracer(self.recorder, sample=0.0, seed=self.index)
        # Wire protocol version of the CURRENTLY connected peer (learned
        # from its hello; absent field = v1). Spans frames are only sent
        # to peers that advertised v2+.
        self._peer_proto = 1

        # Fencing + lease state (attach mode; inert for spawned children
        # until a hello grants a lease).
        self._token = str(spec.get("token") or "")
        # Disaggregation role ("prefill"|"decode"|"both"); advertised in
        # the hello so the router can place traffic without config skew.
        self.role = str(spec.get("role") or "both")
        # In-flight inbound kv-page transfers: xfer id -> frame list.
        # Cleared on every (re)connect — a half-received transfer from a
        # dead connection must never complete against a new sender.
        self._kv_rx: Dict[Any, list] = {}
        self._kv_stale_frames = 0
        # Worker-local rolling latency sketches, fed off the SAME event
        # stream this worker forwards to the router (send_event). The
        # router's SLO engine sketches the forwarded events too; these
        # local copies are the worker's own ground truth, shipped inside
        # health_pull replies so a router that attached mid-run (or
        # missed forwards across a partition) still aggregates a
        # complete fleet view.
        self._lat_sketches: Dict[str, WindowedSketch] = {
            m: WindowedSketch(window_s=60.0, buckets=6)
            for m in LATENCY_METRICS
        }
        self._fence = 0
        self._lease_s = 0.0
        self._last_contact = time.monotonic()
        self._lease_expiries = 0
        self.attached = bool(spec.get("listen"))

        listen = str(spec.get("listen") or "")
        if listen:
            host, _, port_s = listen.rpartition(":")
            if not port_s:
                raise ValueError(
                    f"--listen must be host:port, got {listen!r}"
                )
            self._listener = socket.create_server(
                (host or "127.0.0.1", int(port_s))
            )
        else:
            host = str(spec.get("host", "127.0.0.1"))
            self._listener = socket.create_server((host, 0))
        self._listener.listen(4)
        self.port = int(self._listener.getsockname()[1])

    # ---- lifecycle --------------------------------------------------

    def announce(self) -> None:
        sys.stdout.write(
            json.dumps({"worker": {"port": self.port, "pid": os.getpid()}})
            + "\n"
        )
        sys.stdout.flush()

    def start_replica(self) -> None:
        from ..frontend.admission import AdmissionController
        from ..frontend.replica import Replica

        faults = None
        fault_spec = str(self.spec.get("serving_faults") or "")
        if fault_spec:
            from ..resilience.faults import ServingFaultInjector

            faults = ServingFaultInjector(fault_spec, bus=_ForwardBus(self))

        admission_kw = dict(self.spec.get("admission") or {})
        loop_kw = dict(self.spec.get("loop") or {})

        def make_admission(reg, scope=""):
            return AdmissionController(
                registry=reg, scope=scope, **admission_kw
            )

        self.replica = Replica(
            self.index,
            build_engine_factory(self.spec),
            bus=_ForwardBus(self),
            tracer=None,
            registry_labels=dict(self.spec.get("registry_labels") or {}),
            admission_factory=make_admission,
            fault_injector=faults,
            loop_kwargs=loop_kw,
            role=self.role,
        )
        self.replica.start()

    def start_orphan_watch(self) -> None:
        threading.Thread(
            target=self._watch_parent, name="worker-orphan", daemon=True
        ).start()

    def _watch_parent(self) -> None:
        try:
            # The parent holds our stdin pipe open and never writes;
            # read() returning means the parent process is gone.
            sys.stdin.buffer.read()
        except Exception:
            pass
        self._drain_and_exit("orphaned (parent pipe closed)")

    def start_lease_watch(self) -> None:
        threading.Thread(
            target=self._watch_lease, name="worker-lease", daemon=True
        ).start()

    def _watch_lease(self) -> None:
        """Attach-mode replacement for the orphan watch: a router that
        stays unreachable for a full lease term has either died or
        already redriven our work onto survivors — keep serving it and
        a heal would double-serve. Expire the lease: drop the
        connection (the serve loop cancels every in-flight attempt,
        freeing decode slots and KV) and park listening for the next
        attach instead of exiting."""
        while not self._shutdown.wait(0.05):
            lease = self._lease_s
            if lease <= 0:
                continue
            with self._wlock:
                conn = self._conn
            if conn is None:
                continue
            age = time.monotonic() - self._last_contact
            if age <= lease:
                continue
            self._lease_expiries += 1
            sys.stderr.write(
                f"[worker {self.index}] lease expired (router silent "
                f"{age:.2f}s > lease {lease}s); draining and parking\n"
            )
            sys.stderr.flush()
            with self._wlock:
                if self._conn is conn:
                    self._conn = None
            try:
                # Wakes _serve_conn's blocking recv: its teardown path
                # cancels the attempts and returns to the accept loop.
                conn.close()
            except OSError:
                pass

    def _drain_and_exit(self, reason: str) -> None:
        try:
            sys.stderr.write(f"[worker {self.index}] {reason}; draining\n")
            sys.stderr.flush()
            rep = self.replica
            if rep is not None and rep.loop is not None:
                rep.loop.begin_drain()
                deadline = time.monotonic() + _ORPHAN_DRAIN_S
                while (
                    time.monotonic() < deadline
                    and rep.loop.active_requests > 0
                ):
                    time.sleep(0.05)
                rep.stop(timeout=5.0)
        finally:
            os._exit(0)

    # ---- wire output (single writer lock; drop when unconnected) ----

    def _send(self, payload: Dict[str, Any], g: Optional[int] = None) -> None:
        # Every outbound frame is stamped with a fence generation; the
        # parent drops (and counts) frames whose generation predates its
        # last eject of this replica. Stream frames pass the SUBMIT-time
        # generation; everything else carries the current one.
        payload = dict(payload)
        payload["g"] = self._fence if g is None else g
        with self._wlock:
            conn = self._conn
            if conn is None:
                return
            try:
                send_frame(conn, payload)
            except ConnectionLost:
                pass  # reader side notices and tears the connection down

    def send_event(self, kind: str, step: int, fields: Dict[str, Any]) -> None:
        if kind in TERMINAL_KINDS:
            for metric in LATENCY_METRICS:
                val = fields.get(metric)
                if isinstance(val, (int, float)):
                    self._lat_sketches[metric].observe(float(val))
        frame = {
            "op": "event", "kind": kind, "step": step, "fields": fields,
            "g": self._fence,
        }
        with self._wlock:
            conn = self._conn
            if conn is None:
                if len(self._event_buf) < 4096:
                    self._event_buf.append(frame)
                return
            try:
                send_frame(conn, frame)
            except ConnectionLost:
                pass

    # ---- serving ----------------------------------------------------

    def serve_forever(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            self._adopt_connection(conn)
            try:
                self._serve_conn(conn)
            except (ConnectionLost, ProtocolError):
                pass
            finally:
                with self._wlock:
                    self._conn = None
                try:
                    conn.close()
                except OSError:
                    pass
                # The client is gone: its streams have no reader, and the
                # parent will redrive them elsewhere — cancel so decode
                # slots and KV blocks free up before any reconnect.
                loop = self.replica.loop if self.replica else None
                if loop is not None:
                    for attempt, _g in list(self._attempts.values()):
                        try:
                            loop.cancel(attempt)
                        except Exception:
                            pass

    def _adopt_connection(self, conn: socket.socket) -> None:
        """Make ``conn`` the live connection and flush the events buffered
        while none was. The lease clock restarts BEFORE the connection is
        published: the lease watch reads both, and with the last
        connection's contact time it would expire this one while the
        buffered events flush (the JAX worker publishes first; a router
        re-attaching to a parked worker then saw its hello reset)."""
        self._peer_proto = 1  # until this connection's hello says more
        self._kv_rx.clear()
        self._last_contact = time.monotonic()
        with self._wlock:
            self._conn = conn
            buffered, self._event_buf = self._event_buf, []
        for frame in buffered:
            self._send(frame)
        self._last_contact = time.monotonic()

    def _serve_conn(self, conn: socket.socket) -> None:
        authed = not self._token
        while not self._shutdown.is_set():
            req = recv_frame(conn)
            self._last_contact = time.monotonic()
            op = str(req.get("op", ""))
            if op == "stall":
                # Fault drill: go silent without dying. Stop reading so
                # every parent RPC on this connection times out.
                while not self._shutdown.wait(3600.0):
                    pass
                return
            rid = req.get("id")
            if not authed:
                # Attach handshake: the FIRST frame must be a hello
                # presenting the shared token — anyone can reach a
                # listening TCP port; only the router holds the secret.
                if op != "hello" or str(req.get("token") or "") != self._token:
                    self._send(
                        {
                            "id": rid,
                            "error": "unauthorized",
                            "message": "bad or missing attach token",
                        }
                    )
                    return
                authed = True
            try:
                handled = self._dispatch(op, req)
            except Exception as e:  # handler bug: report, keep serving
                self._send(
                    {"id": rid, "error": "runtime", "message": repr(e)}
                )
                continue
            if not handled:
                self._send(
                    {
                        "id": rid,
                        "error": "runtime",
                        "message": f"unknown op {op!r}",
                    }
                )

    def _dispatch(self, op: str, req: Dict[str, Any]) -> bool:
        rid = req.get("id")
        rep = self.replica
        loop = rep.loop
        if op == "hello":
            self._adopt_lease(req)
            self._peer_proto = int(req.get("proto", 1))
            eng = loop.engine
            self._send(
                {
                    "id": rid,
                    "ok": {
                        "pid": os.getpid(),
                        "generation": rep.generation,
                        "vocab_size": int(eng.cfg.vocab_size),
                        "context_length": int(eng.cfg.context_length),
                        "max_seq": int(eng.max_seq),
                        "block_size": int(eng.block_size),
                        "n_blocks": int(eng.alloc.n_blocks),
                        "max_batch": int(eng.max_batch),
                        "temperature": float(eng.temperature),
                        # Attach handshake extras: the engine fingerprint
                        # lets the router refuse a worker serving the
                        # wrong weights; the echoed fence/lease confirm
                        # what this worker will stamp and honor.
                        "weight_fingerprint0": loop.weight_fingerprint0,
                        "weight_fingerprint": loop.weight_fingerprint,
                        "fence": self._fence,
                        "lease_s": self._lease_s,
                        "lease_expiries": self._lease_expiries,
                        # Protocol negotiation + clock alignment: the
                        # parent only sends/expects v2 frames if this
                        # advertises >= 2, and feeds the clock sample
                        # (our perf_counter epoch) into its min-RTT
                        # offset estimator.
                        "proto": PROTO_VERSION,
                        "clock": time.perf_counter(),
                        # Disaggregation: what traffic this worker takes.
                        "role": rep.role,
                        # Whether prefix_flush has a cache to flush.
                        "prefix_cache": getattr(eng, "prefix_cache", None)
                        is not None,
                    },
                }
            )
            return True
        if op == "submit":
            self._handle_submit(rid, req)
            return True
        if op == "cancel":
            ent = self._attempts.get(int(req.get("rid", -1)))
            if ent is not None:
                loop.cancel(ent[0])
            self._send({"id": rid, "ok": True})
            return True
        if op == "drain":
            rep.drain()
            self._send({"id": rid, "ok": True})
            return True
        if op == "health":
            # Health polls double as the lease heartbeat: each carries
            # the router's current fence generation + lease term.
            self._adopt_lease(req)
            self._send({"id": rid, "ok": self._health()})
            return True
        if op == "health_pull":
            # Heartbeat semantics identical to health; the reply adds
            # the gauge + sketch payload the fleet snapshot aggregates.
            self._adopt_lease(req)
            self._send({"id": rid, "ok": self._health_pull()})
            return True
        if op == "metrics":
            self._send({"id": rid, "ok": loop.metrics()})
            return True
        if op == "debug_requests":
            self._send({"id": rid, "ok": loop.debug_requests()})
            return True
        if op == "debug_engine":
            self._send({"id": rid, "ok": loop.debug_engine()})
            return True
        if op == "probe_set":
            threading.Thread(
                target=self._handle_probe_set,
                args=(rid, req),
                name="worker-probeset",
                daemon=True,
            ).start()
            return True
        if op == "kv_fetch":
            threading.Thread(
                target=self._handle_kv_fetch,
                args=(rid, req),
                name="worker-kvfetch",
                daemon=True,
            ).start()
            return True
        if op == "kv_page":
            self._handle_kv_page(req)
            return True
        if op == "prefix_flush":
            cache = getattr(loop.engine, "prefix_cache", None)
            flushed = 0
            if cache is not None:
                flushed = loop.run_on_loop(cache.flush, timeout=30.0)
            self._send({"id": rid, "ok": {"flushed": int(flushed)}})
            return True
        if op == "shutdown":
            self._send({"id": rid, "ok": True})
            self._shutdown.set()
            threading.Thread(
                target=self._exit_clean, name="worker-exit", daemon=True
            ).start()
            return True
        return False

    def _handle_submit(self, rid: Any, req: Dict[str, Any]) -> None:
        from ..frontend.admission import RejectedBusy, RejectedInfeasible
        from ..frontend.replica import ReplicaUnavailable

        rep = self.replica
        prompt = [int(t) for t in req.get("prompt", [])]
        max_new = req.get("max_new", 1)
        deadline_s = req.get("deadline_s")
        priority = int(req.get("priority", 0))
        lane = str(req.get("lane", "replica"))
        # The PARENT assigns the stream id: it registers the attempt
        # before sending, so a token frame can never race the reply.
        wrid = int(req.get("rid", 0))
        # A submit carrying ``traceparent`` joins the router's trace: the
        # local RequestTrace inherits the trace id and parents its root
        # under the router's placement-attempt span, so the worker's
        # queue/prefill/window spans nest inside the fleet lineage tree
        # once exported. No header -> local tracing stays off (the
        # worker's own sample rate is 0).
        tp = req.get("traceparent")
        trace_kw: Dict[str, Any] = {}
        if tp is not None:
            trace_kw["trace"] = self.tracer.begin_request(str(tp))
        try:
            if lane == "loop":
                attempt = rep.loop.submit(
                    prompt, max_new, deadline_s=deadline_s,
                    priority=priority, **trace_kw
                )
            else:
                attempt = rep.submit(
                    prompt, max_new, deadline_s=deadline_s,
                    priority=priority, **trace_kw
                )
        except ValueError as e:
            self._send({"id": rid, "error": "invalid", "message": str(e)})
            return
        except RejectedBusy as e:
            self._send(
                {
                    "id": rid,
                    "error": "busy",
                    "message": e.reason,
                    "retry_after_s": e.retry_after_s,
                }
            )
            return
        except RejectedInfeasible as e:
            self._send(
                {
                    "id": rid,
                    "error": "infeasible",
                    "message": e.reason,
                    "estimate_s": e.estimate_s,
                }
            )
            return
        except (ReplicaUnavailable, RuntimeError) as e:
            self._send({"id": rid, "error": "unavailable", "message": str(e)})
            return
        self._wire_submits += 1
        g = self._fence
        self._attempts[wrid] = (attempt, g)
        self._send({"id": rid, "ok": {"rid": wrid}})
        threading.Thread(
            target=self._pump,
            args=(wrid, attempt, g),
            name=f"worker-pump-{wrid}",
            daemon=True,
        ).start()
        if self._kill_after and self._wire_submits >= self._kill_after:
            # mid-upgrade-kill drill: die AFTER acking the submit, so
            # the parent is committed to waiting on this stream.
            os.kill(os.getpid(), signal.SIGKILL)

    def _pump(self, wrid: int, attempt: Any, g: int) -> None:
        try:
            for ev in attempt.events():
                if ev[0] == "token":
                    self._send({"token": wrid, "t": int(ev[1])}, g=g)
                elif ev[0] == "end":
                    self._send(
                        {
                            "end": wrid,
                            "status": attempt.status,
                            "info": dict(attempt.info),
                        },
                        g=g,
                    )
                    self._export_spans(g)
        finally:
            self._attempts.pop(wrid, None)

    def _export_spans(self, g: int) -> None:
        """Ship every span completed since the last export in one
        batched frame (piggybacked on stream ends — the recorder only
        holds COMPLETED spans, so concurrent in-flight requests lose
        nothing; their spans ride a later batch). Gated on the peer's
        advertised protocol version: a v1 router would treat the frame
        as garbage. The drop count is a delta the parent feeds into a
        monotonic counter — a saturated worker buffer is visible, never
        silent."""
        if self._peer_proto < 2:
            return
        events, dropped = self.recorder.drain()
        if not events and not dropped:
            return
        self._send(
            {
                "op": "spans",
                "spans": [
                    {"name": name, "t0": t0, "dur": dur, "meta": meta}
                    for name, t0, dur, _tid, _depth, meta in events
                ],
                "dropped": dropped,
            },
            g=g,
        )

    # ---- KV-page migration (frontend/kv_transfer.py) ----------------

    def _handle_kv_fetch(self, rid: Any, req: Dict[str, Any]) -> None:
        """Serialize the longest cached chain for the prompt and stream
        it back as kv_page frames, then the summary reply. Side thread:
        the snapshot does a device pull per page, and health polls must
        stay live underneath it."""
        try:
            from . import kv_transfer

            prompt = [int(t) for t in req.get("prompt", [])]
            max_pages = req.get("max_pages")
            eng = self.replica.engine
            xfer = kv_transfer.snapshot_chain(
                eng, prompt,
                max_pages=int(max_pages) if max_pages else None,
            )
            if xfer is None:
                self._send(
                    {"id": rid, "ok": {"pages": 0, "bytes": 0, "frames": 0}}
                )
                return
            budget = int(
                req.get("budget") or kv_transfer.KV_FRAME_BUDGET_BYTES
            )
            frames = kv_transfer.split_frames(xfer, budget=budget)
            for fr in frames:
                self._send({"op": "kv_page", "fetch": rid, **fr})
            self._send(
                {
                    "id": rid,
                    "ok": {
                        "pages": len(xfer["pages"]),
                        "bytes": kv_transfer.transfer_bytes(xfer),
                        "frames": len(frames),
                    },
                }
            )
        except Exception as e:
            self._send({"id": rid, "error": "runtime", "message": repr(e)})

    def _handle_kv_page(self, req: Dict[str, Any]) -> None:
        """Receive side of a page push. Interior frames (no ``id``)
        accumulate; the final frame triggers reassembly + loop-thread
        adoption. A frame whose fence generation predates the worker's
        current fence poisons nothing: it is dropped (with its partial
        transfer) and the sender told why."""
        xid = req.get("xfer")
        rid = req.get("id")
        g = req.get("g")
        if g is not None and int(g) < self._fence:
            self._kv_stale_frames += 1
            self._kv_rx.pop(xid, None)
            if rid is not None:
                self._send(
                    {
                        "id": rid,
                        "error": "stale_fence",
                        "message": (
                            f"kv_page frame generation {g} predates "
                            f"fence {self._fence}; pages dropped"
                        ),
                    }
                )
            return
        frames = self._kv_rx.setdefault(xid, [])
        frames.append(req)
        if rid is None:
            return
        self._kv_rx.pop(xid, None)
        threading.Thread(
            target=self._adopt_kv_pages,
            args=(rid, frames),
            name="worker-kvadopt",
            daemon=True,
        ).start()

    def _adopt_kv_pages(self, rid: Any, frames: list) -> None:
        try:
            from . import kv_transfer

            xfer = kv_transfer.join_frames(frames)
            rep = self.replica
            eng = rep.engine
            res = rep.loop.run_on_loop(
                lambda: kv_transfer.adopt_chain(eng, xfer), timeout=30.0
            )
            self._send({"id": rid, "ok": res})
        except ValueError as e:  # torn transfer
            self._send({"id": rid, "error": "torn", "message": str(e)})
        except Exception as e:
            self._send({"id": rid, "error": "runtime", "message": repr(e)})

    def _adopt_lease(self, req: Dict[str, Any]) -> None:
        fence = req.get("fence")
        if fence is not None:
            # Monotonic: a delayed heartbeat from before an eject must
            # not roll the generation back.
            self._fence = max(self._fence, int(fence))
        lease_s = req.get("lease_s")
        if lease_s is not None:
            self._lease_s = max(0.0, float(lease_s))

    def _handle_probe_set(self, rid: Any, req: Dict[str, Any]) -> None:
        try:
            from ..resilience.integrity import build_probe_set

            eng = self.replica.engine
            probes = build_probe_set(
                eng.params,
                eng.cfg,
                n_probes=int(req.get("n_probes", 2)),
                probe_len=int(req.get("probe_len", 9)),
                max_new=int(req.get("max_new", 4)),
            )
            self._send(
                {
                    "id": rid,
                    "ok": [
                        {
                            "prompt": [int(t) for t in p.prompt],
                            "expected": [int(t) for t in p.expected],
                        }
                        for p in probes
                    ],
                }
            )
        except Exception as e:
            self._send({"id": rid, "error": "runtime", "message": repr(e)})

    def _health(self) -> Dict[str, Any]:
        rep = self.replica
        loop = rep.loop
        failure = loop.failure
        return {
            "running": bool(loop.running),
            "draining": bool(loop.draining),
            "active_requests": int(loop.active_requests),
            "last_turn_age_s": float(loop.last_turn_age_s()),
            "generation": int(rep.generation),
            "submits": int(rep.submits),
            "state": rep.state,
            "role": rep.role,
            "failure": repr(failure) if failure is not None else None,
            "weight_fingerprint0": loop.weight_fingerprint0,
            "weight_fingerprint": loop.weight_fingerprint,
            "lease_expiries": self._lease_expiries,
            "fence": self._fence,
            # Heartbeat clock sample: re-read on every health poll so the
            # parent's offset estimator tracks drift continuously.
            "clock": time.perf_counter(),
        }

    def _health_pull(self) -> Dict[str, Any]:
        """health fields + worker gauges + serialized latency sketches
        (proto >= 4 reply body; see the op table in the module doc)."""
        out = self._health()
        loop = self.replica.loop
        eng = loop.engine
        gauges: Dict[str, Any] = {}
        hg = getattr(eng, "health_gauges", None)
        if hg is not None:
            gauges.update(hg())
        gauges["active_requests"] = int(loop.active_requests)
        if loop.admission is not None:
            adm = loop.admission.snapshot()
            gauges["admission_depth"] = int(adm.get("live_requests", 0))
            gauges["admission_outstanding_tokens"] = int(
                adm.get("outstanding_tokens", 0)
            )
        gauges["kv_stale_frames"] = int(self._kv_stale_frames)
        out["gauges"] = gauges
        # Device memory watermarks: the caching allocator's counters
        # (torch.cuda.memory_stats), a host-side query, never a device
        # sync; a CPU worker reports {} and the snapshot simply has no
        # hbm section for this replica.
        try:
            from ..observability.device import DeviceTelemetry

            hbm = DeviceTelemetry(bus=None).sample()
        except Exception:
            hbm = {}
        if hbm:
            out["hbm"] = hbm
        out["sketches"] = {
            m: ws.merged().to_dict()
            for m, ws in self._lat_sketches.items()
        }
        return out

    def _exit_clean(self) -> None:
        try:
            self.replica.stop(timeout=5.0)
            try:
                self._listener.close()
            except OSError:
                pass
        finally:
            os._exit(0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Serving worker: one engine replica behind a socket"
    )
    parser.add_argument(
        "--spec-json",
        required=True,
        help="worker spec as a JSON object (see module docstring)",
    )
    parser.add_argument(
        "--listen",
        default="",
        help="host:port to serve on as a PRE-SPAWNED multi-host worker "
        "(port 0 binds an ephemeral port, announced on stdout); the "
        "router attaches by address instead of spawning this process",
    )
    parser.add_argument(
        "--token",
        default="",
        help="shared secret every attaching router must present in its "
        "hello (attach mode)",
    )
    parser.add_argument(
        "--role",
        default="",
        choices=["", "prefill", "decode", "both"],
        help="disaggregation role: 'prefill' computes prompts and ships "
        "KV pages to the decode tier (the router never routes client "
        "decode traffic here), 'decode' serves clients and receives "
        "migrated pages, 'both' (default) is the classic colocated "
        "worker; overrides any role in --spec-json",
    )
    args = parser.parse_args(argv)
    spec = json.loads(args.spec_json)
    if not isinstance(spec, dict):
        raise SystemExit("--spec-json must be a JSON object")
    if args.listen:
        spec["listen"] = args.listen
    if args.token:
        spec["token"] = args.token
    if args.role:
        spec["role"] = args.role

    server = WorkerServer(spec)
    server.announce()
    signal.signal(
        signal.SIGTERM,
        lambda signum, frame: threading.Thread(
            target=server._drain_and_exit,
            args=("SIGTERM",),
            daemon=True,
        ).start(),
    )
    if server.attached:
        # Pre-spawned workers have no parent pipe; the heartbeat lease
        # (granted by the attaching router's hello) replaces the orphan
        # watch — expiry parks the worker instead of exiting it.
        server.start_lease_watch()
    else:
        server.start_orphan_watch()
    server.start_replica()
    server.serve_forever()
    # serve_forever returns only once shutting down: leave through
    # os._exit as the shutdown thread does, never through interpreter
    # finalization, which races the orphan watch's blocked stdin read
    # (a fatal error and a nonzero exit code).
    server._exit_clean()
    return 0


if __name__ == "__main__":
    sys.exit(main())
