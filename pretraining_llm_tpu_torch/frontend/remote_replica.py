"""RemoteReplica: the parent-side client for an out-of-process worker (the
JAX package's ``frontend/remote_replica.py``; it spawns the port's worker,
``python -m pretraining_llm_tpu_torch.frontend.worker``).

Duck-types the :class:`frontend.replica.Replica` surface the router
consumes — ``state``/``generation``/``submits``/``accepting``/``alive``/
``load()``/``submit()``/``drain()``/``eject()``/``relaunch()``/
``stop()``/``on_state``/``registry``/``engine``/``loop`` — so
``Router``, the integrity sentinel, and the gateway run UNCHANGED
whether a replica is an object in this process or a worker process on
the other end of a socket (``--replica_mode process``).

The key trick is that submitted attempts are real
:class:`frontend.engine_loop.FrontendRequest` objects: the reader
thread feeds ``tokens``/``out_q`` exactly the way EngineLoop does, so
the router's ``_pump``/abandonment/result machinery needs no remote
special case.

Fault domain (the robustness core of this tier):

- every RPC has a per-call timeout; idempotent ops (health, metrics,
  debug, drain, cancel) retry with seeded exponential backoff +
  jitter; ``submit`` is never retried (an accepted-but-unacked submit
  must surface as a failure, not a silent duplicate).
- a send failure, reader EOF, or final RPC timeout declares the
  connection lost: the replica stops reporting ``running``, every
  live attempt gets an ``"engine failure: worker connection lost"``
  error terminal (the redrivable prefix — the router immediately
  redrives them bit-identically onto survivors), and the router's
  health loop ejects + backs off + relaunches exactly as for an
  in-process engine crash.
- ``relaunch`` always tears the previous process down (graceful
  ``shutdown`` RPC, then SIGKILL) before spawning — a crash-looping
  worker can never accumulate orphans; the worker's own stdin-EOF
  watcher covers the reverse direction (dead parent).

Multi-host extensions (``spec["attach"] = "host:port"``):

- **attach mode** connects to a pre-spawned ``worker.py --listen``
  instead of spawning; the hello carries ``spec["token"]`` plus the
  router's fence generation and lease term, and teardown only closes
  our end — the worker survives to serve the next attach (including a
  restarted router recovering from its journal).
- **leases**: with ``lease_s > 0`` the health poll becomes the
  heartbeat. A poll window with no successful RPC for a full lease
  term declares the lease expired: live attempts fail with the
  redrivable ``engine failure`` prefix WITHOUT closing the socket —
  the connection must survive so that when a partition heals, the
  backlog the worker streamed into the void is still readable (and
  countable) rather than destroyed with the fd.
- **fencing**: ``fence`` is this replica's generation; the router
  bumps it on eject. Every inbound frame stamped with an older
  generation is dropped and counted (``fenced_frames_total``) — a
  healed partition can never stream duplicate tokens into a request
  a survivor already answered.
- **partition injection**: every connection is wrapped in a
  ``_PartitionGate`` so drills can blackhole it (reads hang, writes
  buffer — no RST, unlike ``conn_drop``) and add wire delay/jitter;
  ``heal()`` flushes buffered writes and releases the read backlog.

The engine facade also says whether the worker runs a prefix cache, and
empties it through the worker's ``prefix_flush`` op: the router pins each
golden probe through a prefix-cache miss and a hit.

The worker spec (see ``frontend/worker.py``) is stored on the replica;
``update_snapshot()``/``apply_update({...})`` snapshot and mutate it,
which is how ``Router.upgrade_replica`` swaps a checkpoint path and —
on a failed probe vetting — restores the old one.
"""

from __future__ import annotations

import json
import os
import queue
import random
import select
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np

from ..observability import spans as _spans
from ..observability.clocksync import ClockSync
from ..observability.metrics import MetricsRegistry
from . import kv_transfer
from .admission import RejectedBusy
from .engine_loop import _TRACE_UNSET, FrontendRequest
from .replica import REPLICA_STATES, ReplicaUnavailable
from .wire import PROTO_VERSION, ConnectionLost, recv_frame, send_frame

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# Transport latency buckets: LAN-ish RPCs, 1ms..5s.
_RPC_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 5.0)

# One-way delay applied by the "wire_delay" injected fault.
_WIRE_DELAY_S = 0.05


class _PartitionGate:
    """Socket wrapper that can simulate a network PARTITION, distinctly
    from ``conn_drop``: a blackholed route produces no RST and no EOF —
    reads simply hang and writes vanish into a buffer that never
    drains. The gate reproduces exactly that: while partitioned,
    ``recv`` ignores readable bytes (they stay queued in the kernel)
    and ``send``/``sendall`` divert into ``_wbuf``. ``heal()`` flushes
    the buffered writes and lets the read backlog through — the
    stale-frame flood that fencing exists to absorb. ``set_delay``
    models a slow WAN link (per-recv sleep with jitter). Transparent
    passthrough when no fault is active.

    ``recv`` polls via select rather than blocking in the kernel so a
    partition injected while the reader is mid-``recv`` takes effect
    within one poll tick, and ``close()`` always wakes it.
    """

    def __init__(self, sock: socket.socket, rng: Any = None) -> None:
        self._sock = sock
        self._partitioned = False
        self._closed = False
        self._wbuf = bytearray()
        self._wlock = threading.Lock()
        self._delay_s = 0.0
        self._jitter_frac = 0.0
        self._rng = rng if rng is not None else random.Random(0)

    # -- fault controls ----------------------------------------------

    def partition(self) -> None:
        with self._wlock:
            self._partitioned = True

    def heal(self) -> None:
        # Flush INSIDE the lock: a concurrent send observing
        # partitioned=False must not interleave its bytes with the
        # buffered backlog (a torn frame would kill the connection).
        with self._wlock:
            buf, self._wbuf = bytes(self._wbuf), bytearray()
            self._partitioned = False
            if buf and not self._closed:
                try:
                    self._sock.sendall(buf)
                except OSError:
                    pass  # peer gave up during the partition; reads will EOF

    def set_delay(self, delay_s: float, jitter_frac: float = 0.0) -> None:
        self._delay_s = max(0.0, float(delay_s))
        self._jitter_frac = max(0.0, float(jitter_frac))

    # -- socket surface ----------------------------------------------

    def recv(self, n: int) -> bytes:
        while True:
            if self._closed:
                raise OSError("socket closed")
            if self._partitioned:
                time.sleep(0.02)
                continue
            try:
                r, _, _ = select.select([self._sock], [], [], 0.05)
            except (OSError, ValueError):
                raise OSError("socket closed")
            if not r or self._partitioned:
                continue
            if self._delay_s > 0.0:
                time.sleep(
                    self._delay_s
                    * (1.0 + self._jitter_frac * self._rng.random())
                )
            return self._sock.recv(n)

    def send(self, data: bytes, flags: int = 0) -> int:
        with self._wlock:
            if self._partitioned:
                self._wbuf.extend(data)
                return len(data)
            return self._sock.send(data, flags)

    def sendall(self, data: bytes) -> None:
        with self._wlock:
            if self._partitioned:
                self._wbuf.extend(data)
                return
            self._sock.sendall(data)

    def fileno(self) -> int:
        return self._sock.fileno()

    def setsockopt(self, *args: Any) -> None:
        self._sock.setsockopt(*args)

    def settimeout(self, t: Optional[float]) -> None:
        self._sock.settimeout(t)

    def shutdown(self, how: int) -> None:
        self._sock.shutdown(how)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class _RemoteEngine:
    """Engine facade built from the worker's hello constants. Exposes
    exactly what the router needs from ``rep.engine``: submit-time
    validation (mirroring ``ServingEngine.validate_request`` so process
    mode returns the same HTTP 400s), the probe-geometry constants, and
    ``build_probe_set`` delegating to the worker (which holds the
    params this process never sees)."""

    def __init__(self, rep: "RemoteReplica", hello: Dict[str, Any]) -> None:
        self._rep = rep
        self.temperature = float(hello["temperature"])
        self.block_size = int(hello["block_size"])
        self.max_seq = int(hello["max_seq"])
        self.max_batch = int(hello["max_batch"])
        self.n_blocks = int(hello["n_blocks"])
        self.cfg = SimpleNamespace(
            vocab_size=int(hello["vocab_size"]),
            context_length=int(hello["context_length"]),
        )
        self.params = None        # weights live in the worker
        self.prefix_cache = None  # router's cached-token peek: no local view
        self.has_prefix_cache = bool(hello.get("prefix_cache", False))

    def validate_request(self, prompt_ids: Any, max_new_tokens: Any) -> int:
        from ..generation import paged

        try:
            max_new = int(max_new_tokens)
        except (TypeError, ValueError):
            raise ValueError(
                f"max_new_tokens must be an integer, got "
                f"{type(max_new_tokens).__name__}"
            )
        if max_new != max_new_tokens:
            raise ValueError(
                f"max_new_tokens must be an integer, got {max_new_tokens!r}"
            )
        p = len(prompt_ids)
        if p == 0:
            raise ValueError("empty prompt")
        ids = np.asarray(prompt_ids)
        if ids.ndim != 1:
            raise ValueError(
                f"prompt must be a flat list of token ids, got an array of "
                f"shape {ids.shape}"
            )
        if ids.dtype.kind not in "iu":
            raise ValueError(
                f"prompt must be integer token ids, got dtype {ids.dtype}"
            )
        lo, hi = int(ids.min()), int(ids.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(
                f"prompt token ids must be in [0, {self.cfg.vocab_size}); "
                f"got range [{lo}, {hi}]"
            )
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        total = p + max_new
        if total > self.max_seq:
            raise ValueError(
                f"prompt({p}) + max_new({max_new}) = {total} exceeds "
                f"max_seq={self.max_seq}"
            )
        if paged.required_blocks(total, self.block_size) > self.n_blocks - 1:
            raise ValueError(
                f"request needs "
                f"{paged.required_blocks(total, self.block_size)} "
                f"blocks; the pool only has {self.n_blocks - 1}"
            )
        return max_new

    def flush_prefix_cache(self, *, timeout: Optional[float] = None) -> int:
        """Empty the worker's prefix cache on its loop thread; the number
        of blocks freed."""
        ok = self._rep._rpc("prefix_flush", timeout=timeout, retries=0)
        return int(ok.get("flushed", 0))

    def build_probe_set(
        self, *, n_probes: int = 2, probe_len: int = 9, max_new: int = 4
    ) -> List[Any]:
        from ..resilience.integrity import GoldenProbe

        raw = self._rep._rpc(
            "probe_set",
            {"n_probes": n_probes, "probe_len": probe_len, "max_new": max_new},
            timeout=self._rep.spawn_timeout_s,
        )
        return [
            GoldenProbe(
                prompt=tuple(int(t) for t in d["prompt"]),
                expected=tuple(int(t) for t in d["expected"]),
            )
            for d in raw
        ]


class _RemoteLoop:
    """EngineLoop facade over the health snapshot + RPCs. Identity is
    stable across worker relaunches (mirroring how the router treats
    ``rep.loop`` as replaced-on-relaunch is unnecessary: the router
    only reads liveness properties and calls submit/cancel, all of
    which route to whatever connection is current)."""

    def __init__(self, rep: "RemoteReplica") -> None:
        self._rep = rep

    # -- liveness mirror ---------------------------------------------

    @property
    def running(self) -> bool:
        return self._rep._connected() and bool(
            self._rep._snapshot.get("running", False)
        )

    @property
    def draining(self) -> bool:
        return bool(self._rep._snapshot.get("draining", False))

    @property
    def active_requests(self) -> int:
        return max(
            len(self._rep._attempts),
            int(self._rep._snapshot.get("active_requests", 0)),
        )

    @property
    def failure(self) -> Optional[str]:
        return self._rep._snapshot.get("failure")

    @property
    def weight_fingerprint0(self) -> Optional[str]:
        return self._rep._snapshot.get("weight_fingerprint0")

    @property
    def weight_fingerprint(self) -> Optional[str]:
        return self._rep._snapshot.get("weight_fingerprint")

    def last_turn_age_s(self) -> float:
        snap = self._rep._snapshot
        age = float(snap.get("last_turn_age_s", 0.0))
        taken = snap.get("t")
        if taken is not None:
            age += max(0.0, self._rep._clock() - taken)
        return age

    # -- request path ------------------------------------------------

    def submit(
        self,
        prompt: Any,
        max_new_tokens: int,
        *,
        deadline_s: Optional[float] = None,
        trace: Any = _TRACE_UNSET,
        traceparent: Optional[str] = None,
        priority: int = 0,
    ) -> FrontendRequest:
        if not self.running:
            raise RuntimeError("EngineLoop is not running")
        return self._rep._wire_submit(
            prompt,
            max_new_tokens,
            deadline_s=deadline_s,
            priority=priority,
            lane="loop",
            trace=trace,
            traceparent=traceparent,
        )

    def cancel(self, req: FrontendRequest) -> None:
        try:
            self._rep._rpc("cancel", {"rid": req.rid}, retries=0)
        except Exception:
            pass  # a dead worker has already cancelled everything

    def begin_drain(self) -> None:
        self._rep._snapshot["draining"] = True
        try:
            self._rep._rpc("drain")
        except Exception:
            pass

    # -- observability passthrough -----------------------------------

    def metrics(self) -> Dict[str, Any]:
        try:
            return dict(self._rep._rpc("metrics"))
        except Exception:
            return {}

    def debug_requests(self) -> List[Dict[str, Any]]:
        try:
            return list(self._rep._rpc("debug_requests"))
        except Exception:
            return []

    def debug_engine(self) -> Dict[str, Any]:
        try:
            return dict(self._rep._rpc("debug_engine"))
        except Exception:
            return {}

    def readiness(self) -> Dict[str, Any]:
        return {
            "ready": self.running and not self.draining,
            "running": self.running,
            "draining": self.draining,
        }


class RemoteReplica:
    """One worker process + socket, presented as a Replica."""

    def __init__(
        self,
        index: int,
        spec: Dict[str, Any],
        *,
        bus: Any = None,
        registry_prefix: str = "pllm_serving_",
        registry_labels: Optional[Dict[str, Any]] = None,
        fault_injector: Any = None,
        clock: Any = time.monotonic,
        rpc_timeout_s: float = 30.0,
        rpc_retries: int = 2,
        backoff_base_s: float = 0.05,
        backoff_jitter_frac: float = 0.25,
        backoff_seed: int = 0,
        spawn_timeout_s: float = 600.0,
        health_interval_s: float = 0.05,
        lease_s: float = 0.0,
        recorder: Any = None,
        python: str = sys.executable,
    ) -> None:
        self.index = int(index)
        self.spec = dict(spec)
        self._bus = bus
        self.faults = fault_injector
        self._clock = clock
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.rpc_retries = int(rpc_retries)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_jitter_frac = float(backoff_jitter_frac)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.health_interval_s = float(health_interval_s)
        self.lease_s = float(lease_s)
        self._python = python
        self.attach = str(self.spec.get("attach") or "")
        self.mode = "attach" if self.attach else "process"
        # Disaggregation role. The spec is the request; the hello reply
        # is the truth (an attach-mode worker was launched with its own
        # --role and may disagree with a stale router config).
        self.role = str(self.spec.get("role") or "both")

        self.registry = MetricsRegistry(
            registry_prefix,
            const_labels={**(registry_labels or {}), "replica": self.index},
        )
        self._c_spawns = self.registry.counter(
            "worker_spawns_total", "worker processes launched"
        )
        self._c_retries = self.registry.counter(
            "worker_rpc_retries_total", "worker RPCs retried after timeout"
        )
        self._c_timeouts = self.registry.counter(
            "worker_rpc_timeouts_total", "worker RPC attempts that timed out"
        )
        self._h_rpc = self.registry.histogram(
            "worker_rpc_latency_seconds",
            "round-trip latency of worker RPC replies",
            buckets=_RPC_BUCKETS,
        )
        self._c_lease = self.registry.counter(
            "lease_expiries_total",
            "worker leases the router declared expired (no contact)",
        )
        self._c_fenced = self.registry.counter(
            "fenced_frames_total",
            "stale-generation frames dropped after a fence bump",
        )
        self._c_spans = self.registry.counter(
            "worker_spans_total",
            "spans imported from the worker's span-export frames",
        )
        self._c_span_drops = self.registry.counter(
            "worker_span_drops_total",
            "spans the worker dropped before export (buffer saturated)",
        )
        self._g_clock_offset = self.registry.gauge(
            "clock_offset_seconds",
            "estimated worker->router perf_counter offset (min-RTT)",
        )
        self._g_clock_err = self.registry.gauge(
            "clock_error_bound_seconds",
            "half-RTT error bound on the current clock offset estimate",
        )

        self.state = "ejected"
        self.generation = 0
        self.submits = 0
        self.on_state: Any = None
        self._lock = threading.Lock()

        # Connection plumbing. _conn_gen increments per successful
        # connect; _on_conn_lost is idempotent per generation.
        self._conn_lock = threading.Lock()
        self._wlock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._proc: Optional[subprocess.Popen] = None
        self._conn_gen = 0
        self._rpc_seq = 0
        self._pending: Dict[int, "queue.Queue"] = {}
        self._pending_lock = threading.Lock()
        self._attempts: Dict[int, FrontendRequest] = {}
        self._attempts_lock = threading.Lock()
        # KV-fetch collectors: fetch rid -> list of kv_page frames. The
        # reader thread is single-threaded and the worker streams every
        # page frame BEFORE the summary reply, so when the fetch RPC
        # returns the collector is complete by construction.
        self._kv_rx: Dict[int, List[Dict[str, Any]]] = {}
        self._kv_rx_lock = threading.Lock()
        self._snapshot: Dict[str, Any] = {"running": False}
        self._rng = random.Random(backoff_seed * 1000003 + self.index)
        self._rng_lock = threading.Lock()
        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None

        # Fencing + lease state. ``fence`` is this replica's generation
        # — bumped by the router on eject, stamped by the worker onto
        # every outbound frame, enforced in _handle_frame. ``_last_ok``
        # is the lease heartbeat (any successful RPC refreshes it);
        # ``_lease_fired_gen`` makes expiry fire once per connection.
        self.fence = 0
        self._last_ok: Optional[float] = None
        self._lease_fired_gen = 0
        self._fence_note_gen = 0
        self._parted_gate: Optional[_PartitionGate] = None

        # Cross-process tracing: spans the worker exports land in this
        # recorder (shared with the router's tracer by default, so one
        # Chrome trace holds both timelines) after the clock estimator
        # maps their worker-epoch perf_counter timestamps into ours.
        # Each process has its own perf_counter zero, so the mapping is
        # re-estimated from hello + every health heartbeat (Cristian
        # min-RTT) and reset whenever the connection generation changes
        # (a re-attached worker may be a different process entirely).
        self.recorder = (
            recorder if recorder is not None else _spans.get_recorder()
        )
        self.clock_sync = ClockSync()
        self._clock_gen = 0
        self._peer_proto = 1  # until a hello reply advertises more

        self.engine: Optional[_RemoteEngine] = None
        # None until first launch so Router.start()'s `rep.loop is None`
        # launch guard works unchanged; stable _RemoteLoop afterwards.
        self.loop: Optional[_RemoteLoop] = None

    # -- spec management (rolling upgrades) ---------------------------

    def update_snapshot(self) -> Dict[str, Any]:
        """Copy of the current worker spec — hold this to roll back."""
        with self._lock:
            return json.loads(json.dumps(self.spec))

    def apply_update(
        self, update: Optional[Dict[str, Any]], *, replace: bool = False
    ) -> None:
        """Patch (merge) worker-spec fields, e.g. ``{"model_path":
        "..."}`` for a checkpoint upgrade; takes effect at the next
        (re)launch. ``replace=True`` swaps the whole spec — the rollback
        path, so keys the refused upgrade ADDED don't survive the
        restore. ``None`` means relaunch-as-is."""
        if update is None:
            return
        with self._lock:
            if replace:
                self.spec = dict(update)
            else:
                self.spec.update(update)

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "RemoteReplica":
        with self._lock:
            self._launch_locked("start")
        return self

    def relaunch(
        self, *, stop_timeout: float = 1.0, hold: bool = False
    ) -> "RemoteReplica":
        with self._lock:
            self._teardown_locked(stop_timeout)
            self._launch_locked("relaunch", hold=hold)
        return self

    def activate(self, reason: str = "activate") -> None:
        """Promote a held (vetting) replica to traffic-eligible."""
        with self._lock:
            self._set_state("active", reason)

    def drain(self) -> None:
        with self._lock:
            if self.loop is not None:
                self.loop.begin_drain()
            self._set_state("draining", "drain")

    def eject(self, reason: str) -> None:
        with self._lock:
            self._set_state("ejected", reason)

    def stop(self, timeout: float = 5.0) -> bool:
        with self._lock:
            return self._teardown_locked(timeout)

    def _launch_locked(self, reason: str, hold: bool = False) -> None:
        proc: Optional[subprocess.Popen] = None
        if self.attach:
            # Attach mode: the worker is pre-spawned (possibly on
            # another host) behind --listen/--token. Connect by address
            # instead of spawning.
            host, _, port_s = self.attach.rpartition(":")
            try:
                port = int(port_s)
                sock = socket.create_connection(
                    (host or "127.0.0.1", port), timeout=10.0
                )
            except (OSError, ValueError) as e:
                raise ReplicaUnavailable(
                    f"replica {self.index} attach to {self.attach!r} "
                    f"failed: {e}"
                ) from e
        else:
            spec = {**self.spec, "index": self.index}
            cmd = [
                self._python,
                "-m",
                "pretraining_llm_tpu_torch.frontend.worker",
                "--spec-json",
                json.dumps(spec),
            ]
            env = dict(os.environ)
            env["PYTHONPATH"] = _REPO_ROOT + (
                os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
            )
            proc = subprocess.Popen(
                cmd,
                stdin=subprocess.PIPE,   # orphan-detection pipe; never written
                stdout=subprocess.PIPE,  # handshake line
                stderr=None,
                env=env,
            )
            try:
                hs = self._read_handshake(proc)
                port = int(hs["port"])
                sock = socket.create_connection(
                    ("127.0.0.1", port), timeout=10.0
                )
            except Exception:
                try:
                    proc.kill()
                except OSError:
                    pass
                raise
        sock.settimeout(None)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        # Every connection is wrapped so partition/wire_delay faults are
        # injectable on whatever connection is current.
        gate = _PartitionGate(
            sock, rng=random.Random(self.index * 7919 + self._conn_gen)
        )
        with self._conn_lock:
            self._proc = proc
            self._sock = gate
            self._conn_gen += 1
            gen = self._conn_gen
        threading.Thread(
            target=self._reader,
            args=(gate, gen),
            name=f"remote-replica-{self.index}-reader",
            daemon=True,
        ).start()
        # hello blocks until the worker's engine is built (the connect
        # itself only landed in the listen backlog) — so its timeout is
        # the engine-build budget, not the RPC budget. It also grants
        # the worker its lease term and current fence generation, and
        # (attach mode) presents the shared token.
        hello_payload: Dict[str, Any] = {
            "fence": self.fence,
            "lease_s": self.lease_s,
            "proto": PROTO_VERSION,
        }
        token = str(self.spec.get("token") or "")
        if token:
            hello_payload["token"] = token
        hello = self._rpc(
            "hello", hello_payload, timeout=self.spawn_timeout_s, retries=0
        )
        expect = str(self.spec.get("expect_fingerprint") or "")
        got = str(hello.get("weight_fingerprint") or "")
        if expect and got != expect:
            # Wrong weights behind the address: refuse the attach. The
            # reader's _on_conn_lost goes stale via the gen bump, so
            # this raises without emitting a spurious conn-lost event.
            with self._conn_lock:
                bad, self._sock = self._sock, None
                self._conn_gen += 1
            if bad is not None:
                try:
                    bad.close()
                except OSError:
                    pass
            raise ReplicaUnavailable(
                f"replica {self.index} attach refused: worker serves "
                f"fingerprint {got!r}, expected {expect!r}"
            )
        self._peer_proto = int(hello.get("proto", 1))
        self.role = str(hello.get("role") or self.role)
        self.engine = _RemoteEngine(self, hello)
        if self.loop is None:
            self.loop = _RemoteLoop(self)
        self._snapshot = {
            "running": True,
            "draining": False,  # a HELD launch still accepts loop submits
            "active_requests": 0,
            "last_turn_age_s": 0.0,
            "t": self._clock(),
        }
        self.generation += 1
        self._c_spawns.inc()
        self._emit(
            "worker_spawn",
            replica=self.index,
            pid=int(hello.get("pid", 0)),
            port=port,
            reason=reason,
            generation=self.generation,
            held=bool(hold),
            mode=self.mode,
        )
        self._ensure_health_thread()
        # A held launch parks in "draining": the loop accepts submits
        # (begin_drain was NOT sent), but the router will not route
        # traffic to it and the health loop ignores it — the vetting
        # window for rolling upgrades.
        self._set_state("draining" if hold else "active", reason)

    def _read_handshake(self, proc: subprocess.Popen) -> Dict[str, Any]:
        result: Dict[str, Any] = {}

        def _read() -> None:
            while True:
                line = proc.stdout.readline()
                if not line:
                    return
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if isinstance(obj, dict) and "worker" in obj:
                    result.update(obj["worker"])
                    return

        t = threading.Thread(target=_read, daemon=True)
        t.start()
        t.join(self.spawn_timeout_s)
        if "port" not in result:
            raise RuntimeError(
                f"worker {self.index} did not announce a port within "
                f"{self.spawn_timeout_s}s (exit code "
                f"{proc.poll()})"
            )
        return result

    def _teardown_locked(self, timeout: float) -> bool:
        if self.attach:
            # Detach, never shut down: the pre-spawned worker is not
            # ours to kill. Closing our end makes its serve loop cancel
            # in-flight attempts (freeing decode slots + KV) and park
            # for the next attach — including from a restarted router.
            with self._conn_lock:
                sock, self._sock = self._sock, None
            self._parted_gate = None
            had_conn = sock is not None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            self._snapshot = {"running": False}
            self._fail_pending("worker detached")
            self._fail_attempts("shutdown: router detached from worker")
            if had_conn:
                self._emit(
                    "worker_detach", replica=self.index, address=self.attach
                )
            return True
        clean = True
        proc = self._proc
        if self._connected():
            try:
                self._rpc("shutdown", timeout=min(2.0, timeout), retries=0)
            except Exception:
                clean = False
        if proc is not None:
            try:
                proc.wait(timeout=max(0.1, timeout))
            except subprocess.TimeoutExpired:
                clean = False
                try:
                    proc.kill()
                    proc.wait(timeout=5.0)
                except OSError:
                    pass
            # A worker that died on its own (SIGKILL, crash) before we
            # tore it down waits instantly — the exit code is the truth.
            if proc.returncode != 0:
                clean = False
            self._emit(
                "worker_exit",
                replica=self.index,
                pid=proc.pid,
                clean=clean,
                returncode=proc.returncode,
            )
        with self._conn_lock:
            sock, self._sock = self._sock, None
            self._proc = None
        self._parted_gate = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._snapshot = {"running": False}
        self._fail_pending("worker stopped")
        self._fail_attempts("shutdown: worker stopped")
        return clean

    # -- connection fault domain --------------------------------------

    def _connected(self) -> bool:
        return self._sock is not None

    def _reader(self, sock: socket.socket, gen: int) -> None:
        try:
            while True:
                self._handle_frame(recv_frame(sock))
        except (ConnectionLost, Exception) as e:
            self._on_conn_lost(gen, str(e) or type(e).__name__)

    def _handle_frame(self, frame: Dict[str, Any]) -> None:
        g = frame.get("g")
        if g is not None and int(g) < self.fence:
            # Stale generation: produced before the router last fenced
            # (ejected) this replica — e.g. tokens decoded behind a
            # partition that has since healed. The requests they belong
            # to were redriven onto survivors; delivering them would
            # duplicate tokens. Drop and count.
            self._c_fenced.inc()
            with self._conn_lock:
                gen = self._conn_gen
            if self._fence_note_gen != gen:
                self._fence_note_gen = gen
                self._emit(
                    "fenced_frames_dropped",
                    replica=self.index,
                    fence=self.fence,
                    stale_generation=int(g),
                )
            return
        if "id" in frame:
            with self._pending_lock:
                q = self._pending.get(frame["id"])
            if q is not None:
                q.put(frame)
            return
        if "token" in frame:
            with self._attempts_lock:
                attempt = self._attempts.get(frame["token"])
            if attempt is not None:
                tok = int(frame["t"])
                attempt.tokens.append(tok)
                attempt.out_q.put(("token", tok))
            return
        if "end" in frame:
            with self._attempts_lock:
                attempt = self._attempts.pop(frame["end"], None)
            if attempt is not None:
                attempt.status = str(frame.get("status", "error"))
                attempt.info.update(frame.get("info") or {})
                self._finish_trace(attempt)
                attempt.out_q.put(
                    ("end", attempt.status, dict(attempt.info))
                )
            return
        if frame.get("op") == "kv_page":
            # One frame of a KV fetch stream, keyed by the fetch RPC's
            # id. Unknown keys mean the fetch already gave up (timeout)
            # or this is a stale-connection straggler: drop silently —
            # pages are a cache warm-up, never correctness.
            with self._kv_rx_lock:
                lst = self._kv_rx.get(frame.get("fetch"))
            if lst is not None:
                lst.append(
                    {
                        k: v
                        for k, v in frame.items()
                        if k not in ("op", "fetch", "g")
                    }
                )
            return
        if frame.get("op") == "spans":
            self._ingest_spans(frame)
            return
        if frame.get("op") == "event" and self._bus is not None:
            try:
                self._bus.emit(
                    str(frame.get("kind", "")),
                    step=frame.get("step"),
                    **dict(frame.get("fields") or {}),
                )
            except Exception:
                pass

    def _observe_clock(
        self, gen: int, t_send: float, t_recv: float, t_remote: float
    ) -> None:
        """Feed one RPC round trip into the offset estimator. Samples
        are scoped to a connection generation: a re-attach may put a
        DIFFERENT process (different perf_counter epoch) behind the same
        address, so stale-generation samples are discarded and a new
        generation resets the estimator before its first sample."""
        with self._conn_lock:
            cur = self._conn_gen
        if gen != cur:
            return
        if self._clock_gen != gen:
            self.clock_sync.reset()
            self._clock_gen = gen
        self.clock_sync.observe(t_send, t_recv, t_remote)
        offset = self.clock_sync.offset_s
        if offset is not None:
            self._g_clock_offset.set(offset)
            self._g_clock_err.set(self.clock_sync.error_bound_s or 0.0)

    def _ingest_spans(self, frame: Dict[str, Any]) -> None:
        """Import one batched span-export frame: map each worker-epoch
        timestamp into the router timeline via the current offset
        estimate (recording the error bound alongside), tag the span as
        remote, and re-record it into the shared recorder so the merged
        Chrome trace shows worker decode windows nested inside the
        router's request spans. Spans arriving with no usable offset
        estimate are kept but flagged ``unaligned`` — obs_report
        --fleet-trace --strict fails on them rather than silently
        plotting them in the wrong decade."""
        dropped = int(frame.get("dropped", 0) or 0)
        if dropped > 0:
            self._c_span_drops.inc(dropped)
        offset = self.clock_sync.offset_s
        err = self.clock_sync.error_bound_s
        n = 0
        for ent in frame.get("spans") or []:
            try:
                name = str(ent["name"])
                t0 = float(ent["t0"])
                dur = max(0.0, float(ent.get("dur", 0.0)))
            except (KeyError, TypeError, ValueError):
                continue
            meta = dict(ent.get("meta") or {})
            track = meta.pop("_track", None)
            meta["remote"] = True
            meta["worker"] = self.index
            if offset is not None:
                t0 = t0 + offset
                meta["clock_err_s"] = err
            else:
                meta["unaligned"] = True
            self.recorder.record(name, t0, dur, meta=meta, track=track)
            n += 1
        if n:
            self._c_spans.inc(n)

    @staticmethod
    def _finish_trace(attempt: FrontendRequest) -> None:
        trace = attempt.trace
        if trace is None:
            return
        try:
            # Deferred roots (fleet lineage trees) are finished by the
            # router after redrives settle — an attempt-level end here
            # must not close them.
            if getattr(trace, "finish_deferred", False):
                return
            if not getattr(trace, "finished", True):
                trace.finish(attempt.status)
        except Exception:
            pass

    def _on_conn_lost(self, gen: int, reason: str) -> None:
        with self._conn_lock:
            if gen != self._conn_gen or self._sock is None:
                return  # stale reader, or teardown already ran
            sock, self._sock = self._sock, None
        try:
            sock.close()
        except OSError:
            pass
        self._snapshot = {"running": False, "failure": reason}
        self._fail_pending(reason)
        self._fail_attempts(f"engine failure: worker connection lost ({reason})")
        self._emit("worker_conn_lost", replica=self.index, reason=reason)

    def _fail_pending(self, reason: str) -> None:
        with self._pending_lock:
            pending, self._pending = self._pending, {}
        for rid, q in pending.items():
            q.put({"id": rid, "error": "conn_lost", "message": reason})

    def _fail_attempts(self, reason: str) -> None:
        """Terminal every live attempt the way EngineLoop.stop fails its
        requests — ``engine failure`` reasons are what the router's
        pump recognizes as redrivable."""
        with self._attempts_lock:
            attempts, self._attempts = self._attempts, {}
        for attempt in attempts.values():
            attempt.status = "error"
            attempt.info.setdefault("reason", reason)
            self._finish_trace(attempt)
            attempt.out_q.put(("end", "error", dict(attempt.info)))

    # -- RPC ----------------------------------------------------------

    def _backoff_s(self, attempt_k: int) -> float:
        with self._rng_lock:
            u = self._rng.random()
        return (
            self._backoff_base_s
            * (2.0 ** (attempt_k - 1))
            * (1.0 + self._backoff_jitter_frac * u)
        )

    def _rpc(
        self,
        op: str,
        payload: Optional[Dict[str, Any]] = None,
        *,
        timeout: Optional[float] = None,
        retries: Optional[int] = None,
        conn_lost_on_timeout: bool = True,
    ) -> Any:
        timeout = self.rpc_timeout_s if timeout is None else timeout
        retries = self.rpc_retries if retries is None else retries
        for k in range(retries + 1):
            if k:
                self._c_retries.inc()
                self._emit(
                    "rpc_retry", replica=self.index, op=op, attempt=k
                )
                time.sleep(self._backoff_s(k))
            with self._conn_lock:
                sock, gen = self._sock, self._conn_gen
            if sock is None:
                raise ReplicaUnavailable(
                    f"replica {self.index} worker not connected"
                )
            with self._pending_lock:
                self._rpc_seq += 1
                rid = self._rpc_seq
                q: "queue.Queue" = queue.Queue()
                self._pending[rid] = q
            frame = {"op": op, "id": rid, **(payload or {})}
            t0 = time.monotonic()
            # perf_counter bracket for the clock estimator: the worker
            # stamps ITS perf_counter into v2 hello/health replies, and
            # offset = midpoint(t_send, t_recv) - t_remote maps its
            # epoch into ours with error <= rtt/2.
            t_send = time.perf_counter()
            try:
                with self._wlock:
                    send_frame(sock, frame)
                reply = q.get(timeout=timeout)
            except ConnectionLost as e:
                self._on_conn_lost(gen, f"send failed during {op}: {e}")
                raise ReplicaUnavailable(
                    f"replica {self.index} worker connection lost "
                    f"during {op}: {e}"
                ) from e
            except queue.Empty:
                self._c_timeouts.inc()
                if k >= retries:
                    # Lease-mode health polls pass conn_lost_on_timeout=
                    # False: a timeout there is lease evidence, not a
                    # verdict — tearing the socket down would destroy
                    # the stale-frame backlog a healed partition must
                    # deliver (and be counted against).
                    if conn_lost_on_timeout:
                        self._on_conn_lost(
                            gen, f"rpc {op} timed out after {timeout}s"
                        )
                    raise ReplicaUnavailable(
                        f"replica {self.index} rpc {op} timed out "
                        f"after {timeout}s"
                    )
                continue
            finally:
                with self._pending_lock:
                    self._pending.pop(rid, None)
            t_recv = time.perf_counter()
            self._h_rpc.observe(time.monotonic() - t0)
            self._last_ok = time.monotonic()
            if "ok" in reply:
                ok = reply["ok"]
                if isinstance(ok, dict) and "clock" in ok:
                    try:
                        self._observe_clock(
                            gen, t_send, t_recv, float(ok["clock"])
                        )
                    except (TypeError, ValueError):
                        pass
                return ok
            kind = reply.get("error", "runtime")
            message = str(reply.get("message", kind))
            if kind == "conn_lost":
                raise ReplicaUnavailable(
                    f"replica {self.index} worker connection lost "
                    f"during {op}: {message}"
                )
            raise _RPC_ERRORS.get(kind, _raise_runtime)(reply, message)
        raise AssertionError("unreachable")

    # -- the Replica surface ------------------------------------------

    @property
    def proc(self) -> Optional[subprocess.Popen]:
        """The live worker process, if any (fleet drills SIGKILL it)."""
        return self._proc

    @property
    def accepting(self) -> bool:
        return self.state == "active" and self.loop is not None and (
            self.loop.running
        )

    @property
    def alive(self) -> bool:
        return self.loop is not None and self.loop.running

    def load(self) -> int:
        return len(self._attempts)

    # -- KV-page migration (frontend/kv_transfer.py) ------------------

    @property
    def kv_capable(self) -> bool:
        """Whether this worker can take part in a KV migration: alive
        and speaking proto >= 3 (the kv_fetch/kv_page ops). A capable
        worker without a prefix cache simply answers every fetch with
        zero pages and rejects every push — graceful, not special."""
        return self.alive and self._peer_proto >= 3

    def fetch_kv_pages(
        self,
        prompt: Any,
        *,
        max_pages: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        """Pull the longest cached KV chain for ``prompt`` from this
        worker as a transfer dict, or None. Best-effort by contract:
        every failure mode (not capable, timeout, torn stream, nothing
        cached) returns None — the router falls back to a colocated
        prefill, never an error. Single attempt, no retries: a fetch is
        an optimization racing a request that could just run."""
        if not self.kv_capable:
            return None
        timeout = self.rpc_timeout_s if timeout is None else float(timeout)
        with self._conn_lock:
            sock, gen = self._sock, self._conn_gen
        if sock is None:
            return None
        # The collector must exist before the request hits the wire:
        # the worker streams page frames ahead of the summary reply.
        with self._pending_lock:
            self._rpc_seq += 1
            rid = self._rpc_seq
            q: "queue.Queue" = queue.Queue()
            self._pending[rid] = q
        frames: List[Dict[str, Any]] = []
        with self._kv_rx_lock:
            self._kv_rx[rid] = frames
        payload: Dict[str, Any] = {
            "op": "kv_fetch",
            "id": rid,
            "prompt": [int(t) for t in prompt],
        }
        if max_pages is not None:
            payload["max_pages"] = int(max_pages)
        t0 = time.monotonic()
        try:
            try:
                with self._wlock:
                    send_frame(sock, payload)
                reply = q.get(timeout=timeout)
            except ConnectionLost as e:
                self._on_conn_lost(gen, f"send failed during kv_fetch: {e}")
                return None
            except queue.Empty:
                return None
        finally:
            with self._pending_lock:
                self._pending.pop(rid, None)
            with self._kv_rx_lock:
                self._kv_rx.pop(rid, None)
        self._h_rpc.observe(time.monotonic() - t0)
        self._last_ok = time.monotonic()
        ok = reply.get("ok")
        if not isinstance(ok, dict) or int(ok.get("pages", 0) or 0) < 1:
            return None
        try:
            return kv_transfer.join_frames(frames)
        except ValueError:
            return None  # torn mid-stream (reconnect raced the fetch)

    def push_kv_pages(
        self, xfer: Dict[str, Any], *, timeout: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        """Stream a transfer dict to this worker and adopt it behind
        its prefix-cache publish path. Returns the worker's adoption
        summary (``inserted``/``rejected``/``published``/``reason``) or
        None if the push could not run. Interior frames ride without an
        id; the final frame is a normal RPC so the adoption verdict
        comes back on the pending queue."""
        if not self.kv_capable:
            return None
        take = (
            getattr(self.faults, "take_kv_corruption", None)
            if self.faults is not None
            else None
        )
        if take is not None and take(self.index):
            kv_transfer.corrupt_first_page(xfer)
            self._emit(
                "fault_fired", fault="corrupt_kv_migration", replica=self.index
            )
        frames = kv_transfer.split_frames(xfer)
        with self._pending_lock:
            self._rpc_seq += 1
            xid = f"kvpush-{self._rpc_seq}"
        with self._conn_lock:
            sock, gen = self._sock, self._conn_gen
        if sock is None:
            return None
        try:
            for fr in frames[:-1]:
                with self._wlock:
                    send_frame(sock, {"op": "kv_page", "xfer": xid, **fr})
        except ConnectionLost as e:
            self._on_conn_lost(gen, f"send failed during kv_page push: {e}")
            return None
        try:
            res = self._rpc(
                "kv_page",
                {"xfer": xid, **frames[-1]},
                timeout=timeout,
                retries=0,
            )
        except Exception:
            return None
        return dict(res) if isinstance(res, dict) else None

    def submit(
        self,
        prompt: Any,
        max_new_tokens: int,
        *,
        deadline_s: Optional[float] = None,
        trace: Any = _TRACE_UNSET,
        traceparent: Optional[str] = None,
        priority: int = 0,
    ) -> FrontendRequest:
        with self._lock:
            if not self.accepting:
                raise ReplicaUnavailable(
                    f"replica {self.index} is {self.state}"
                )
            if self.faults is not None and self.faults.should_reject(
                self.index
            ):
                raise RejectedBusy(
                    f"replica {self.index} refusing (injected reject_storm)",
                    0.05,
                )
        attempt = self._wire_submit(
            prompt,
            max_new_tokens,
            deadline_s=deadline_s,
            priority=priority,
            lane="replica",
            trace=trace,
            traceparent=traceparent,
        )
        with self._lock:
            self.submits += 1
            nth = self.submits
        if self.faults is not None:
            self.faults.on_submit(self.index, nth)
            self._execute_process_faults()
        return attempt

    def _wire_submit(
        self,
        prompt: Any,
        max_new_tokens: int,
        *,
        deadline_s: Optional[float],
        priority: int,
        lane: str,
        trace: Any = _TRACE_UNSET,
        traceparent: Optional[str] = None,
    ) -> FrontendRequest:
        prompt_ids = [int(t) for t in prompt]
        now = time.monotonic()
        attempt = FrontendRequest(
            prompt=prompt_ids,
            max_new=int(max_new_tokens),
            deadline=(now + deadline_s) if deadline_s else None,
            submitted_s=now,
        )
        if trace is not _TRACE_UNSET:
            attempt.trace = trace
        attempt.priority = int(priority)
        with self._pending_lock:
            self._rpc_seq += 1
            wrid = self._rpc_seq
        attempt.rid = wrid
        # Register BEFORE sending: the worker may stream the first
        # token before the submit reply is even processed here.
        with self._attempts_lock:
            self._attempts[wrid] = attempt
        payload = {
            "rid": wrid,
            "prompt": prompt_ids,
            "max_new": int(max_new_tokens),
            "deadline_s": deadline_s,
            "priority": int(priority),
            "lane": lane,
        }
        # Context propagation (v2 peers only — a v1 worker would still
        # ignore the extra key, but being explicit keeps the contract
        # legible): the worker joins this trace, parenting its local
        # span tree under the router's placement-attempt span.
        if traceparent is not None and self._peer_proto >= 2:
            payload["traceparent"] = str(traceparent)
        try:
            self._rpc(
                "submit",
                payload,
                retries=0,  # NEVER retried: ambiguous submits must fail
            )
        except Exception:
            with self._attempts_lock:
                self._attempts.pop(wrid, None)
            raise
        return attempt

    def _execute_process_faults(self) -> None:
        take = getattr(self.faults, "take_process_faults", None)
        if take is None:
            return
        for kind in take(self.index):
            self._emit("fault_fired", fault=kind, replica=self.index)
            if kind == "worker_kill":
                proc = self._proc
                if proc is not None:
                    try:
                        proc.kill()
                    except OSError:
                        pass
            elif kind == "worker_stall":
                with self._conn_lock:
                    sock = self._sock
                if sock is not None:
                    try:
                        with self._wlock:
                            send_frame(sock, {"op": "stall"})
                    except ConnectionLost:
                        pass
            elif kind == "conn_drop":
                with self._conn_lock:
                    sock = self._sock
                if sock is not None:
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
            elif kind == "partition":
                self.partition()
            elif kind == "wire_delay":
                self.set_wire_delay(_WIRE_DELAY_S, jitter_frac=0.5)

    # -- partition / fencing / lease surface --------------------------

    def partition(self) -> None:
        """Blackhole the live connection: reads hang, writes buffer —
        no RST, no EOF (unlike ``conn_drop``). Detection is therefore
        the lease machinery, never the socket."""
        with self._conn_lock:
            gate = self._sock
        if gate is None:
            return
        # Remember which gate was partitioned: a relaunch swaps _sock
        # for a fresh connection, but heal() must still heal THIS one.
        self._parted_gate = gate
        gate.partition()
        self._emit("partition_injected", replica=self.index)

    def heal(self) -> None:
        """Heal the (most recently) partitioned connection: buffered
        writes flush, and the backlog the worker streamed into the void
        becomes readable — the stale-generation flood the fence filter
        exists to drop."""
        gate, self._parted_gate = self._parted_gate, None
        if gate is None:
            with self._conn_lock:
                gate = self._sock
        if gate is None:
            return
        gate.heal()
        self._emit("partition_healed", replica=self.index)

    def set_wire_delay(
        self, delay_s: float, jitter_frac: float = 0.0
    ) -> None:
        """Add one-way delay (+ jitter) to every recv on the current
        connection — a slow WAN link, injectable distinctly from a full
        partition."""
        with self._conn_lock:
            gate = self._sock
        if gate is None:
            return
        gate.set_delay(delay_s, jitter_frac)
        self._emit(
            "wire_delay_set",
            replica=self.index,
            delay_s=float(delay_s),
            jitter_frac=float(jitter_frac),
        )

    def bump_fence(self, reason: str) -> int:
        """Advance this replica's fence generation (router calls this
        on eject). Every frame the worker produced under the old
        generation — including everything buffered behind a partition —
        is dropped on arrival from now on."""
        self.fence += 1
        self._emit(
            "fence_bump", replica=self.index, fence=self.fence, reason=reason
        )
        return self.fence

    def sever(self) -> None:
        """Abrupt, event-free disconnect — the router-crash simulation.
        No shutdown RPC, no attempt terminals, no events: exactly what
        the worker observes when the router process dies mid-flight.
        The worker itself survives (attach mode: its lease expires and
        it parks; a restarted router re-attaches)."""
        with self._conn_lock:
            sock, self._sock = self._sock, None
            # Make the reader's _on_conn_lost stale so the close below
            # stays silent (no failure snapshot, no conn-lost event).
            self._conn_gen += 1
        self._parted_gate = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._snapshot = {"running": False}

    def debug_snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "replica": self.index,
            "state": self.state,
            "generation": self.generation,
            "submits": self.submits,
            "alive": self.alive,
            "mode": self.mode,
            "role": self.role,
            "fence": self.fence,
            "pid": self._proc.pid if self._proc is not None else None,
        }
        if self.attach:
            out["attach"] = self.attach
        loop = self.loop
        if loop is not None:
            out["draining"] = loop.draining
            out["last_turn_age_s"] = round(loop.last_turn_age_s(), 3)
            out["active_requests"] = loop.active_requests
            if loop.failure is not None:
                out["failure"] = loop.failure
        return out

    def health_pull(self) -> Dict[str, Any]:
        """Worker-side gauges + serialized latency sketches for the
        fleet health snapshot (Router.fleet_health). Doubles as a lease
        heartbeat like every health poll. A v<4 peer never sees the op:
        the cached plain-health snapshot is returned instead, flagged
        ``proto_fallback`` so the aggregate says WHY a replica has no
        gauge section rather than silently thinning out."""
        if self._connected() and self._peer_proto >= 4:
            try:
                out = dict(
                    self._rpc(
                        "health_pull",
                        {"fence": self.fence, "lease_s": self.lease_s},
                        timeout=self.rpc_timeout_s,
                    )
                )
                out["proto"] = self._peer_proto
                return out
            except Exception:
                pass  # fall through to the cached snapshot
        snap = dict(self._snapshot)
        snap["proto_fallback"] = True
        return snap

    # -- internals ----------------------------------------------------

    def _ensure_health_thread(self) -> None:
        if self._health_thread is not None and self._health_thread.is_alive():
            return
        self._health_stop = threading.Event()
        self._health_thread = threading.Thread(
            target=self._health_poll,
            name=f"remote-replica-{self.index}-health",
            daemon=True,
        )
        self._health_thread.start()

    def _health_poll(self) -> None:
        stop = self._health_stop
        while not stop.wait(self.health_interval_s):
            if not self._connected():
                continue
            lease = self.lease_s
            # Health polls double as the lease heartbeat: each carries
            # the current fence generation + lease term the worker
            # should honor (the hello only covers connect time; fence
            # bumps between ejects arrive this way).
            hb = {"fence": self.fence, "lease_s": lease}
            if lease > 0:
                with self._conn_lock:
                    gen = self._conn_gen
                if self._lease_fired_gen == gen:
                    # Lease already expired on this connection: stop
                    # heartbeating into the void; the router's backoff
                    # relaunch (detach + reconnect) resumes polling.
                    continue
                try:
                    snap = self._rpc(
                        "health",
                        hb,
                        timeout=min(
                            self.rpc_timeout_s, max(0.05, lease / 4.0)
                        ),
                        retries=0,
                        conn_lost_on_timeout=False,
                    )
                except Exception:
                    self._maybe_expire_lease(gen)
                    continue
            else:
                try:
                    snap = self._rpc("health", hb, timeout=self.rpc_timeout_s)
                except Exception:
                    continue  # conn-lost path already updated the snapshot
            snap["t"] = self._clock()
            self._snapshot = snap

    def _maybe_expire_lease(self, gen: int) -> None:
        """Declare the lease expired if no RPC has succeeded for a full
        lease term. Fails live attempts with the redrivable ``engine
        failure`` prefix but deliberately does NOT close the socket:
        when the partition heals, the frames the worker streamed into
        the void must still arrive — stamped with a stale generation —
        to be counted and dropped by the fence filter."""
        lease = self.lease_s
        last = self._last_ok
        if lease <= 0 or last is None:
            return
        age = time.monotonic() - last
        if age <= lease:
            return
        if self._lease_fired_gen == gen:
            return
        self._lease_fired_gen = gen
        self._c_lease.inc()
        reason = f"worker lease expired (no contact for {age:.2f}s)"
        self._snapshot = {"running": False, "failure": reason}
        self._fail_attempts(f"engine failure: {reason}")
        self._emit(
            "lease_expired", replica=self.index, age_s=round(age, 3)
        )

    def _set_state(self, state: str, reason: str) -> None:
        assert state in REPLICA_STATES, state
        self.state = state
        self._emit(
            "replica_state",
            replica=self.index,
            state=state,
            reason=reason,
            generation=self.generation,
        )
        hook = self.on_state
        if hook is not None:
            hook(self, state, reason)

    def _emit(self, kind: str, **fields: Any) -> None:
        if self._bus is None:
            return
        try:
            self._bus.emit(kind, **fields)
        except Exception:
            pass


def _raise_runtime(reply: Dict[str, Any], message: str) -> Exception:
    return ReplicaUnavailable(message)


def _raise_invalid(reply: Dict[str, Any], message: str) -> Exception:
    return ValueError(message)


def _raise_busy(reply: Dict[str, Any], message: str) -> Exception:
    return RejectedBusy(message, float(reply.get("retry_after_s", 1.0)))


def _raise_infeasible(reply: Dict[str, Any], message: str) -> Exception:
    from .admission import RejectedInfeasible

    return RejectedInfeasible(message, float(reply.get("estimate_s", 0.0)))


_RPC_ERRORS = {
    "invalid": _raise_invalid,
    "busy": _raise_busy,
    "infeasible": _raise_infeasible,
    "unavailable": _raise_runtime,
    "runtime": _raise_runtime,
}
