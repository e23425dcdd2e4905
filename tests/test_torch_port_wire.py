"""The port's process-replica plumbing that needs no worker process
(``frontend/wire.py``, ``observability/clocksync.py``, span ingest in
``frontend/remote_replica.py``, the worker's stale-fence filter, the fault
plan's split and the fleet validations) against the JAX package's.

Mirrors the wire, clock-sync, span-ingest and validation cases of
``tests/test_process_fleet.py`` and ``tests/test_multihost_fleet.py`` and
the stale-fence case of ``tests/test_kv_transfer.py``. Each framing case
runs on both packages' wire; a frame the port encodes is byte for byte the
JAX package's, and each package reads the other's frames. The clock
estimators see the same sample grids and give the same offsets and bounds.
No subprocess, no engine.
"""

import json
import socket
import struct
import threading
import time
import types

import numpy as np
import pytest

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.frontend import loadgen as jloadgen
from pretraining_llm_tpu.frontend import remote_replica as jremote
from pretraining_llm_tpu.frontend import wire as jwire
from pretraining_llm_tpu.frontend import worker as jworker
from pretraining_llm_tpu.observability import clocksync as jclock
from pretraining_llm_tpu.observability import spans as jspans
from pretraining_llm_tpu.resilience import faults as jfaults
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.frontend import loadgen as tloadgen
from pretraining_llm_tpu_torch.frontend import remote_replica as tremote
from pretraining_llm_tpu_torch.frontend import wire as twire
from pretraining_llm_tpu_torch.frontend import worker as tworker
from pretraining_llm_tpu_torch.observability import clocksync as tclock
from pretraining_llm_tpu_torch.observability import spans as tspans
from pretraining_llm_tpu_torch.resilience import faults as tfaults

JAX = types.SimpleNamespace(name="jax", wire=jwire, clock=jclock, spans=jspans, remote=jremote, worker=jworker,
                            faults=jfaults, loadgen=jloadgen, config=jcfg)
PORT = types.SimpleNamespace(name="torch", wire=twire, clock=tclock, spans=tspans, remote=tremote, worker=tworker,
                             faults=tfaults, loadgen=tloadgen, config=tcfg)
SIDES = [JAX, PORT]
SIDE_IDS = ["jax", "torch"]

# Payloads of every frame kind the protocol carries, and values JSON spells
# in more than one way (floats, unicode, numpy scalars through the default).
PAYLOADS = [
    {"op": "submit", "id": 3, "rid": 7, "prompt": [1, 2, 3], "max_new": 6, "deadline_s": None, "priority": 0,
     "lane": "replica", "traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"},
    {"id": 1, "ok": {"pid": 42, "generation": 2, "temperature": 0.0, "clock": 12345.678901234, "proto": 4,
                     "weight_fingerprint": -3.0517578125e-05, "role": "both", "fence": 3, "lease_s": 0.8}},
    {"token": 9, "t": 255, "g": 4},
    {"end": 9, "status": "done", "info": {"redrives": 1, "reason": "ü ✓  "}, "g": 4},
    {"op": "event", "kind": "req_done", "step": 0, "fields": {"ttft_s": 0.1 + 0.2, "e2e_s": 1e-7}, "g": 0},
    {"op": "spans", "g": 3, "dropped": 2, "spans": [{"name": "req.window", "t0": 1.5, "dur": 0.25,
                                                     "meta": {"trace_id": "ab" * 16, "_track": "req ab"}}]},
    {"op": "kv_page", "xfer": "kvpush-3", "seq": 0, "n_frames": 1, "pages": [{"digest": "00ff", "leaves": ["AAE="]}]},
    {"id": 5, "ok": {"gauges": {"rows": np.int64(3), "pool_frac": np.float32(0.5)}}},
    {"id": 2, "error": "busy", "message": "queue full", "retry_after_s": 0.05},
]


@pytest.mark.parametrize("payload", PAYLOADS, ids=[f"p{i}" for i in range(len(PAYLOADS))])
def test_frames_are_the_jax_packages_byte_for_byte(payload):
    frame = twire.encode_frame(payload)
    assert frame == jwire.encode_frame(payload)
    for send, recv in ((twire.send_frame, jwire.recv_frame), (jwire.send_frame, twire.recv_frame)):
        a, b = socket.socketpair()
        try:
            send(a, payload)
            assert recv(b) == json.loads(frame[4:])
        finally:
            a.close()
            b.close()


def test_wire_constants_are_the_jax_packages():
    assert (twire.PROTO_VERSION, twire.MAX_FRAME_BYTES, twire.SEND_DEADLINE_S) == (4, 64 * 1024 * 1024, 30.0)
    assert (twire.PROTO_VERSION, twire.MAX_FRAME_BYTES, twire.SEND_DEADLINE_S) == (
        jwire.PROTO_VERSION, jwire.MAX_FRAME_BYTES, jwire.SEND_DEADLINE_S)


def test_a_tensor_never_rides_a_frame():
    """A torch tensor that slips into a payload is an error, not an int()
    of its one element or a str() of a larger one."""
    import torch

    for bad in (torch.tensor(5), torch.tensor([1, 2, 3])):
        with pytest.raises(TypeError, match="torch"):
            twire.encode_frame({"token": 1, "t": bad})
    assert twire.encode_frame({"t": int(torch.tensor(5))}) == jwire.encode_frame({"t": 5})


# -- the framing cases of test_process_fleet.py / test_multihost_fleet.py ----


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_wire_roundtrip(side):
    a, b = socket.socketpair()
    try:
        payload = {"op": "submit", "prompt": [1, 2, 3], "rid": 7, "s": "x"}
        side.wire.send_frame(a, payload)
        assert side.wire.recv_frame(b) == payload
        side.wire.send_frame(b, {"id": 1, "ok": True})
        assert side.wire.recv_frame(a) == {"id": 1, "ok": True}
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_wire_peer_death_is_connection_lost(side):
    a, b = socket.socketpair()
    b.close()
    with pytest.raises(side.wire.ConnectionLost):
        side.wire.recv_frame(a)
    a.close()


@pytest.mark.parametrize("head", [struct.pack(">I", 100) + b"abc", b"\x00\x00"], ids=["body", "length"])
@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_wire_torn_frame_is_connection_lost(side, head):
    a, b = socket.socketpair()
    a.sendall(head)
    a.close()
    with pytest.raises(side.wire.ConnectionLost):
        side.wire.recv_frame(b)
    b.close()


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_wire_torn_body_is_connection_lost(side):
    a, b = socket.socketpair()
    body = json.dumps({"op": "hello"}).encode()
    a.sendall(struct.pack(">I", len(body)) + body[: len(body) // 2])
    a.close()
    with pytest.raises(side.wire.ConnectionLost):
        side.wire.recv_frame(b)
    b.close()


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_wire_garbage_is_protocol_error_not_death(side):
    a, b = socket.socketpair()
    try:
        body = json.dumps([1, 2]).encode()
        a.sendall(struct.pack(">I", len(body)) + body)
        with pytest.raises(side.wire.ProtocolError):
            side.wire.recv_frame(b)
        body = b"\xff\xfe not json"
        a.sendall(struct.pack(">I", len(body)) + body)
        with pytest.raises(side.wire.ProtocolError):
            side.wire.recv_frame(b)
        for length in (side.wire.MAX_FRAME_BYTES + 1, 0xFFFFFFFF):
            a.sendall(struct.pack(">I", length))
            with pytest.raises(side.wire.ProtocolError):
                side.wire.recv_frame(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_wire_oversized_payload_refused_at_send(side):
    with pytest.raises(side.wire.ProtocolError):
        side.wire.encode_frame({"blob": "x" * (side.wire.MAX_FRAME_BYTES + 16)})


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_wire_send_deadline_on_stuffed_peer(side):
    """A peer that stops reading surfaces as the redrivable ConnectionLost
    within the per-frame deadline, reporting the partial write."""
    a, b = socket.socketpair()
    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        payload = {"blob": "x" * 262144}
        t0 = time.monotonic()
        with pytest.raises(side.wire.ConnectionLost, match="send deadline"):
            for _ in range(64):
                side.wire.send_frame(a, payload, deadline_s=0.5)
        assert time.monotonic() - t0 < 10.0
    finally:
        a.close()
        b.close()


def _dribble(sock, pieces, pause):
    def run():
        for piece in pieces:
            sock.sendall(piece)
            time.sleep(pause)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_wire_interleaved_half_frames_reassemble(side):
    a, b = socket.socketpair()
    try:
        p1 = {"op": "submit", "rid": 1, "prompt": [1, 2, 3]}
        p2 = {"op": "health", "id": 2}
        blob = side.wire.encode_frame(p1) + side.wire.encode_frame(p2)
        n1 = len(side.wire.encode_frame(p1))
        cuts = [3, n1 - 2, n1 + 5]
        t = _dribble(a, [blob[i:j] for i, j in zip([0] + cuts, cuts + [len(blob)])], 0.02)
        assert side.wire.recv_frame(b) == p1
        assert side.wire.recv_frame(b) == p2
        t.join(timeout=5)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_wire_spans_frame_survives_dribble_and_tear(side):
    assert side.wire.PROTO_VERSION >= 2
    frame = {"op": "spans", "g": 3, "dropped": 2,
             "spans": [{"name": "req.window", "t0": 1.5 + i, "dur": 0.25,
                        "meta": {"trace_id": "ab" * 16, "_track": "req ab"}} for i in range(40)]}
    blob = side.wire.encode_frame(frame)
    a, b = socket.socketpair()
    try:
        cuts = [2, len(blob) // 3, len(blob) - 5]
        t = _dribble(a, [blob[i:j] for i, j in zip([0] + cuts, cuts + [len(blob)])], 0.01)
        assert side.wire.recv_frame(b) == frame
        t.join(timeout=5)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    a.sendall(blob[: len(blob) // 2])
    a.close()
    with pytest.raises(side.wire.ConnectionLost):
        side.wire.recv_frame(b)
    b.close()


# -- clock sync: the same sample grids through both estimators ---------------


def _round_trips(offset_s, rtts, fracs, t0=100.0):
    out, t = [], t0
    for rtt, frac in zip(rtts, fracs):
        out.append((t, t + rtt, (t + frac * rtt) - offset_s))
        t += rtt + 0.05
    return out


def _both(window, samples):
    syncs = [jclock.ClockSync(window=window), tclock.ClockSync(window=window)]
    for sample in samples:
        for s in syncs:
            s.observe(*sample)
    return syncs


@pytest.mark.parametrize("offset_s", [-5137.25, -0.5, 0.0, 0.25, 86400.0],
                         ids=["far_behind", "behind", "aligned", "ahead", "far_ahead"])
def test_clocksync_skewed_jittery_grid(offset_s):
    rng = np.random.default_rng(7)
    rtts = (0.002 + rng.random(24) * 0.040).tolist()
    fracs = rng.random(24).tolist()
    jax_sync, sync = _both(16, _round_trips(offset_s, rtts, fracs))
    assert sync.snapshot() == jax_sync.snapshot()
    assert sync.n_samples == 24
    est, bound = sync.offset_s, sync.error_bound_s
    assert (est, bound) == (jax_sync.offset_s, jax_sync.error_bound_s)
    assert abs(est - offset_s) <= bound + 1e-9
    assert bound == pytest.approx(min(rtts[-16:]) / 2.0)
    assert sync.to_local(500.0) == jax_sync.to_local(500.0)
    assert abs(sync.to_local(500.0) - (500.0 + offset_s)) <= bound + 1e-9


def test_clocksync_tracks_drift_newest_wins_ties():
    samples = [s for i in range(8) for s in _round_trips(10.0 + i * 0.001, [0.004], [0.5], t0=100.0 + i)]
    jax_sync, sync = _both(8, samples)
    assert sync.offset_s == jax_sync.offset_s == pytest.approx(10.0 + 7 * 0.001)


def test_clocksync_window_evicts_stale_tight_sample():
    samples = _round_trips(1.0, [0.001], [0.5]) + [s for _ in range(4) for s in _round_trips(2.0, [0.010], [0.5])]
    jax_sync, sync = _both(4, samples)
    assert sync.snapshot() == jax_sync.snapshot()
    assert sync.offset_s == pytest.approx(2.0)
    assert sync.error_bound_s == pytest.approx(0.005)


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_clocksync_reset_and_bad_samples(side):
    with pytest.raises(ValueError, match="window"):
        side.clock.ClockSync(window=0)
    sync = side.clock.ClockSync()
    assert sync.offset_s is None and sync.error_bound_s is None
    assert sync.to_local(1.0) is None
    sync.observe(2.0, 1.0, 50.0)
    assert sync.offset_s is None
    sync.observe(1.0, 1.01, 50.0)
    assert sync.offset_s is not None
    sync.reset()
    assert sync.offset_s is None
    snap = sync.snapshot()
    assert snap["offset_s"] is None and snap["n_samples"] == 1


# -- span ingest at the router edge -------------------------------------------


def _ingest(side):
    rec = side.spans.SpanRecorder(max_events=64)
    rep = side.remote.RemoteReplica(0, {"preset": "tiny"}, recorder=rec)
    tid = "ab" * 16
    rep._ingest_spans({"spans": [{"name": "req.window", "t0": 100.0, "dur": 0.1,
                                  "meta": {"trace_id": tid, "_track": "req " + tid[:12]}}], "dropped": 3})
    rep.clock_sync.observe(10.0, 10.01, 100.0)
    rep._ingest_spans({"spans": [{"name": "req.prefill", "t0": 100.5, "dur": 0.2, "meta": {"trace_id": tid}}],
                       "dropped": 0})
    rep._ingest_spans({"spans": [{"name": "x"}, "junk", None], "dropped": 0})
    return rep, rec.drain()


def test_remote_span_ingest_aligns_or_flags():
    """Worker-epoch timestamps go through the live offset estimate with its
    error bound on each span; spans before any estimate are kept and
    flagged ``unaligned``; malformed entries are skipped. The recorder
    holds what the JAX package's holds."""
    rep, (events, dropped) = _ingest(PORT)
    jrep, (jevents, jdropped) = _ingest(JAX)
    assert rep._c_spans.value == jrep._c_spans.value == 2
    assert rep._c_span_drops.value == jrep._c_span_drops.value == 3
    assert events == jevents and dropped == jdropped == 0
    by_name = {name: (t0, meta) for name, t0, _d, _t, _dep, meta in events}
    t0_un, meta_un = by_name["req.window"]
    assert meta_un["unaligned"] is True and meta_un["remote"] is True and meta_un["worker"] == 0
    t0_al, meta_al = by_name["req.prefill"]
    assert t0_al == pytest.approx(100.5 - 89.995)
    assert meta_al["clock_err_s"] == pytest.approx(0.005)
    assert "unaligned" not in meta_al


# -- the fault plan's split and the fleet validations -------------------------


@pytest.mark.parametrize("plan", [
    "replica_crash@req2:r0, worker_kill@req3:r1, slow_window@req5, conn_drop@req1:r0, worker_stall@req4",
    "partition@req2:r0, wire_delay@req1:r1, replica_crash@req3:r0",
    "replica_crash@req1",
    "corrupt_kv_migration@req1:r1,corrupt_weights@req8:r1",
])
def test_split_serving_plan(plan):
    got = tfaults.split_serving_plan(plan)
    assert got == jfaults.split_serving_plan(plan)
    if plan.startswith("replica_crash@req2"):
        assert got == ("replica_crash@req2:r0,slow_window@req5",
                       "worker_kill@req3:r1,conn_drop@req1:r0,worker_stall@req4")
    for side in SIDES:
        with pytest.raises(ValueError):
            side.faults.split_serving_plan("worker_vaporize@req1")


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_fleet_action_validation(side):
    FleetAction = side.loadgen.FleetAction
    assert FleetAction(at_s=0.5, kind="upgrade", replica=0, update={"model_path": "x"}).update == {"model_path": "x"}
    assert FleetAction(at_s=0.5, kind="partition", replica=0).kind == "partition"
    assert FleetAction(at_s=1.0, kind="heal", replica=1).kind == "heal"
    for bad in (dict(kind="kill", update={"x": 1}), dict(kind="defrag"), dict(kind="partition", update={"x": 1})):
        with pytest.raises(ValueError):
            FleetAction(at_s=0.5, replica=0, **bad)


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_frontend_config_process_and_multihost_validation(side):
    FrontendConfig = side.config.FrontendConfig
    assert FrontendConfig().replica_mode == "inproc"
    assert FrontendConfig(replica_mode="process").redrive_max_attempts == 3
    ok = FrontendConfig(replicas=2, replica_mode="process", worker_attach="10.0.0.1:7000,10.0.0.2:7000",
                        attach_token="s3cret", lease_s=2.0, journal_path="fleet.jsonl")
    assert ok.lease_s == 2.0
    for kw, match in (
        (dict(replica_mode="thread"), "replica_mode"), (dict(redrive_max_attempts=-1), "redrive_max_attempts"),
        (dict(lease_s=-1.0), "lease_s"), (dict(replicas=1, worker_attach="h:1"), "replica_mode"),
        (dict(replicas=2, replica_mode="process", worker_attach="h:1"), "addresses"),
        (dict(replicas=1, replica_mode="process", worker_attach="nonsense"), "host:port"),
        (dict(attach_token="s3cret"), "attach_token"),
    ):
        with pytest.raises(ValueError, match=match):
            FrontendConfig(**kw)


# -- the worker's stale-fence filter on kv_page frames -------------------------


@pytest.mark.parametrize("side", SIDES, ids=SIDE_IDS)
def test_worker_drops_stale_fence_kv_pages(side):
    """The fence filter runs before a frame is kept: a page push racing a
    fence bump never reaches the pool. A bare WorkerServer: the stale path
    touches only the fence and receive bookkeeping."""
    ws = side.worker.WorkerServer.__new__(side.worker.WorkerServer)
    ws._fence = 3
    ws._kv_rx = {}
    ws._kv_stale_frames = 0
    sent = []
    ws._send = lambda payload, g=None: sent.append(payload)
    ws._handle_kv_page({"xfer": "x1", "g": 3, "seq": 0, "n_frames": 2, "pages": []})
    assert "x1" in ws._kv_rx and not sent
    ws._handle_kv_page({"xfer": "x1", "g": 2, "id": 7, "seq": 1, "n_frames": 2, "pages": []})
    assert ws._kv_rx == {} and ws._kv_stale_frames == 1
    assert sent[-1] == {"id": 7, "error": "stale_fence", "message": sent[-1]["message"]}
    assert "predates fence 3" in sent[-1]["message"]
    sent.clear()
    ws._handle_kv_page({"xfer": "x2", "g": 0, "seq": 0, "n_frames": 1, "pages": []})
    assert ws._kv_rx == {} and not sent and ws._kv_stale_frames == 2


def test_worker_restarts_its_lease_before_publishing_a_connection():
    """A parked worker (lease expired, events buffered) takes the next
    attach: while the buffered events flush, the lease watch must see a
    fresh contact, or it expires the new connection under the router's
    hello. The JAX worker publishes the connection first, with the last
    connection's contact time; the port restarts the clock first."""
    ws = tworker.WorkerServer.__new__(tworker.WorkerServer)
    ws._wlock = threading.Lock()
    ws._kv_rx = {"old": []}
    ws._lease_s = 0.05
    ws._last_contact = time.monotonic() - 3600.0  # the last router's contact, long ago
    ws._event_buf = [{"op": "event", "kind": "req_cancelled", "step": 0, "fields": {}, "g": 0}] * 8
    ages = []
    ws._send = lambda payload, g=None: ages.append(time.monotonic() - ws._last_contact)
    a, b = socket.socketpair()
    try:
        ws._adopt_connection(a)
        assert ws._conn is a and ws._event_buf == [] and ws._kv_rx == {} and ws._peer_proto == 1
        assert len(ages) == 8 and max(ages) < ws._lease_s, ages
    finally:
        a.close()
        b.close()
