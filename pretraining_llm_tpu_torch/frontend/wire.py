"""Length-prefixed JSON framing for the worker socket protocol (the JAX
package's ``frontend/wire.py``; a frame of either package reads the same
in the other, byte for byte).

One frame = 4-byte big-endian payload length + UTF-8 JSON object. Both
sides of the worker protocol (frontend/worker.py serving, frontend/
remote_replica.py consuming) speak exactly this — the framing layer
knows nothing about ops, so it can be unit-tested without an engine or
a subprocess.

Failure surface is deliberately small: every way the peer can vanish
(EOF mid-length, EOF mid-payload, ECONNRESET, EPIPE, a closed fd)
raises ``ConnectionLost`` so callers have a single except clause for
"the other process is gone"; a frame that parses but is not a JSON
object, or whose declared length exceeds ``MAX_FRAME_BYTES``, raises
``ProtocolError`` — that peer is speaking garbage, not dying, and the
two must not be conflated because only the first is redrivable.
"""

from __future__ import annotations

import json
import select
import socket
import struct
import time
from typing import Any, Dict, Optional

# Protocol revision spoken by this build. Exchanged in the hello (each
# side sends its own; the reply echoes the worker's), so new frame kinds
# are NEGOTIABLE: a sender only emits a frame the peer's advertised
# version understands, instead of crashing an old peer on an unknown op.
# A peer whose hello carries no ``proto`` field is version 1.
#   1  original op set (hello/submit/cancel/.../stall + token/end/event)
#   2  adds the batched span-export frame ({"op": "spans", ...}) and
#      clock samples in hello/health replies
#   3  adds KV-page migration: the ``kv_fetch`` request (serialize a
#      cached prefix chain) and ``kv_page`` page-stream frames
#      (frontend/kv_transfer.py owns the payload layout); pages ride
#      base64-encoded inside the JSON frame and carry the same ``g``
#      fence stamp as every other worker frame, so stale-generation
#      pages are dropped by the existing fence filter
#   4  adds the ``health_pull`` request: like ``health`` (it doubles as
#      a lease heartbeat + clock sample the same way) but the reply also
#      carries worker-side gauges — engine row/KV-pool occupancy, queue
#      depths, KV-migration counters, device HBM watermarks — and the
#      worker's rolling-window latency sketches serialized via
#      observability/sketches.py, so the router can aggregate one fleet
#      health snapshot (GET /slo) without a debug_engine round-trip per
#      replica. A v<4 peer never sees the op; the router falls back to
#      the fields the plain health reply already carries.
PROTO_VERSION = 4

# A frame is one JSON op or one token batch — 64 MiB means a corrupt
# length prefix fails fast instead of attempting a multi-GB recv.
MAX_FRAME_BYTES = 64 * 1024 * 1024

# A peer that will not drain one frame's worth of bytes in this long is
# as gone as one that sent RST: its kernel buffer is full and nothing
# is reading (blackholed route, wedged process). Sends past the
# deadline raise ConnectionLost so the slow-peer case converges on the
# same redrive path as outright death.
SEND_DEADLINE_S = 30.0

_LEN = struct.Struct(">I")

# Per-call non-blocking send (Linux): the socket itself must stay
# blocking — it is shared with a reader thread, and both settimeout and
# setblocking are socket-wide. Elsewhere the flag degrades to 0 and the
# send falls back to kernel blocking semantics.
_MSG_DONTWAIT = getattr(socket, "MSG_DONTWAIT", 0)


class ConnectionLost(Exception):
    """The peer process went away (EOF / reset / closed socket)."""


class ProtocolError(Exception):
    """The peer sent bytes that do not decode as a protocol frame."""


def _json_default(obj: Any) -> Any:
    """Last-resort encoder for numpy scalars and other debug payload
    values; token ids and counters are native ints before they get
    here, so this only runs for debug_engine-style snapshots. A torch
    tensor is refused: ``int()`` of a one-element tensor and ``str()`` of
    a larger one would put wrong data on the wire instead of an error."""
    if type(obj).__module__.split(".")[0] == "torch":
        raise TypeError(f"a torch {type(obj).__name__} cannot ride a wire frame; convert it to Python values first")
    for cast in (int, float):
        try:
            return cast(obj)
        except (TypeError, ValueError):
            continue
    return str(obj)


def encode_frame(payload: Dict[str, Any]) -> bytes:
    """Serialize one frame (length prefix + JSON) to bytes."""
    body = json.dumps(
        payload, separators=(",", ":"), default=_json_default
    ).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame of {len(body)} bytes exceeds MAX_FRAME_BYTES"
        )
    return _LEN.pack(len(body)) + body


def send_frame(
    sock: socket.socket,
    payload: Dict[str, Any],
    deadline_s: Optional[float] = SEND_DEADLINE_S,
) -> None:
    """Send one frame; any OS-level send failure means the peer died.

    The send loop is explicit over ``sendall`` boundaries: each pass
    waits (via select) for the socket to accept bytes, bounded by a
    per-FRAME deadline, then writes one partial chunk with
    ``MSG_DONTWAIT`` — select only promises SOME buffer space, and a
    plain blocking ``send`` of the large remainder would sleep in the
    kernel until ALL of it fit, hanging the caller exactly like the
    ``sendall`` this loop replaces. A peer that stops draining (full
    kernel buffer behind a blackholed route) therefore surfaces as
    ``ConnectionLost`` within ``deadline_s``. select is used rather
    than ``settimeout``/``setblocking`` because the socket is shared
    with a reader thread and both are socket-wide.
    """
    data = encode_frame(payload)
    deadline = (
        time.monotonic() + deadline_s if deadline_s is not None else None
    )
    sent = 0
    try:
        while sent < len(data):
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConnectionLost(
                        f"send deadline exceeded: peer accepted only "
                        f"{sent}/{len(data)} bytes in {deadline_s}s"
                    )
                _, writable, _ = select.select([], [sock], [], remaining)
            else:
                _, writable, _ = select.select([], [sock], [])
            if not writable:
                raise ConnectionLost(
                    f"send deadline exceeded: peer accepted only "
                    f"{sent}/{len(data)} bytes in {deadline_s}s"
                )
            try:
                n = sock.send(data[sent:], _MSG_DONTWAIT)
            except BlockingIOError:
                # The buffer filled between select and send; wait again.
                continue
            if n == 0:
                raise ConnectionLost("send returned 0 bytes: peer gone")
            sent += n
    except (OSError, ValueError) as e:  # ValueError: fd closed under us
        raise ConnectionLost(f"send failed: {e}") from e


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except (OSError, ValueError) as e:
            raise ConnectionLost(f"recv failed: {e}") from e
        if not chunk:
            raise ConnectionLost(
                f"peer closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Dict[str, Any]:
    """Receive one frame; blocks until a full frame or the peer dies."""
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if length > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"declared frame length {length} exceeds MAX_FRAME_BYTES"
        )
    body = _recv_exact(sock, length)
    try:
        payload = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ProtocolError(f"frame payload is not JSON: {e}") from e
    if not isinstance(payload, dict):
        raise ProtocolError(
            f"frame payload must be a JSON object, got "
            f"{type(payload).__name__}"
        )
    return payload
