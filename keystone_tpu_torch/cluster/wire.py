"""The cluster wire protocol: length-framed messages over a local socket,
with deadlines and typed errors that survive the process boundary (port of
``keystone_tpu/cluster/wire.py``; frames are byte-compatible with the JAX
package's).

The router and its workers share one host, so the protocol keeps three
things intact across the boundary:

* **Framing.** Every message is a ``>I`` length prefix and a payload. The
  payload says its encoding by its first byte: hot ``req`` / ``res``
  frames ride the binary codec (:mod:`.codec`, :data:`~.codec.MAGIC`
  first), control frames (hello, ready, ping, stats, stop) are pickle
  (protocol >= 2 payloads begin with ``0x80``), so the receiver
  dispatches per frame. Senders hold the connection's lock (concurrent
  sends would interleave); a receive reads exactly one frame or raises
  :class:`ConnectionClosed` on EOF. A torn frame (the peer died mid-send)
  is a dead peer. A malformed binary frame raises the typed
  :class:`~.codec.CodecError` and is never handed to ``pickle.loads``.
* **Deadlines.** ``time.monotonic()`` is process-local, so a deadline
  travels as its remaining budget in seconds, stamped at send and
  re-anchored on the receiver's clock: the hop never extends a deadline
  (transit time comes out of the budget).
* **Typed errors.** Callers branch on the serving errors' types
  (:class:`~keystone_tpu_torch.serving.errors.Shed` against
  :class:`DeadlineExceeded` against :class:`QueueFull`). A worker-side
  error crosses by registered name and message and is raised as the same
  type router-side; an unregistered type becomes :class:`WorkerError`
  carrying the original class name, never a pickle of an arbitrary
  exception.

Payloads are dicts with a ``"type"`` key; both codecs carry the same
dicts, so ``KEYSTONE_WIRE_CODEC=pickle`` is a frame-for-frame kill switch.

A sampled request's ``req`` frame also carries ``"trace"`` (the
:class:`~keystone_tpu_torch.obs.context.TraceContext` wire form) and every
``res`` frame ``"t_unix"``; ``"priority"`` and ``"tenant"`` carry its QoS
identity (:func:`qos_to_wire` / :func:`qos_from_wire`, absent keys meaning
the defaults), so the worker's fleet applies the class the router admitted
it under. The receiver prices each direction's transport as
``time.time() - stamp`` on the host-shared unix clock and records it on its
hop span.
"""

from __future__ import annotations

import logging
import pickle
import socket
import struct
import time
from typing import Any, Optional

_LEN = struct.Struct(">I")

#: a corrupt length prefix (a desynced stream) must not drive a
#: multi-GB allocation
MAX_FRAME_BYTES = 1 << 30


class ConnectionClosed(ConnectionError):
    """The peer's socket reached EOF (or died mid-frame). A
    ``ConnectionError``, so ``faults.is_transient`` calls it transient: a
    dead worker's requests are retried on peers."""


class WorkerError(RuntimeError):
    """A worker-side failure whose type is not in the serving error
    vocabulary (a device fault among them). ``kind`` is the original class
    name."""

    def __init__(self, kind: str, message: str):
        super().__init__(f"{kind}: {message}")
        self.kind = kind


def _registry():
    from ..check import ContractMismatchError, PipelineCheckError
    from ..serving.errors import (
        CanaryMismatch,
        DeadlineExceeded,
        EngineClosed,
        EngineStopped,
        InvalidRequest,
        QueueFull,
        ServingError,
        Shed,
    )
    from ..workflow.pipeline import NotTraceableError

    types = (Shed, DeadlineExceeded, QueueFull, InvalidRequest, EngineStopped, EngineClosed,
             CanaryMismatch, ServingError, NotTraceableError, ContractMismatchError,
             PipelineCheckError, WorkerError)
    return {t.__name__: t for t in types}


def _resolve_send_timeout() -> float:
    """``KEYSTONE_WIRE_SEND_TIMEOUT`` seconds, default 15, floored at 0.1: a
    zero timeout would turn every full socket buffer into a false death."""
    from ..utils import env_float

    return env_float("KEYSTONE_WIRE_SEND_TIMEOUT", 15.0, minimum=0.1)


#: the steady-state socket timeout of both ends: a send that makes no
#: progress this long means the peer stopped reading (wedged, stopped,
#: dead) and is treated as down, so a full buffer never holds the send lock
#: forever; receives wait on across timeouts (an idle connection is fine).
#: Read once at import: each end reads its own environment, which the
#: router's spawn passes on.
SEND_TIMEOUT_S = _resolve_send_timeout()


def send_payload(sock: socket.socket, payload: bytes) -> None:
    """Write one framed, already-encoded payload (callers serialize access
    per socket). A send that times out raises :class:`ConnectionClosed`:
    the peer has left, and a partly sent frame has desynced the stream."""
    try:
        sock.sendall(_LEN.pack(len(payload)) + payload)
    except socket.timeout as e:
        raise ConnectionClosed(
            f"peer stopped reading (send stalled {SEND_TIMEOUT_S:.0f}s)") from e


def send_msg(sock: socket.socket, msg: Any) -> None:
    """Write one framed control message (pickle)."""
    send_payload(sock, pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))


def encode_msg(msg: Any, codec: str = "pickle", shm=None, min_shm_bytes: int = 1 << 16,
               metrics=None) -> bytes:
    """One message as frame payload bytes. ``codec="binary"`` tries the hot
    codec for member-list ``req`` / ``res`` dicts (``shm`` this direction's
    sending ring) and falls back to pickle for a frame it cannot describe;
    the receiver dispatches on the first byte, so the fallback needs no
    signal."""
    if codec == "binary":
        from . import codec as codec_mod

        try:
            payload = codec_mod.encode(msg, shm=shm, min_shm_bytes=min_shm_bytes,
                                       metrics=metrics)
        except Exception:
            logging.getLogger(__name__).debug("binary encode failed; falling back to pickle",
                                              exc_info=True)
            payload = None
        if payload is not None:
            return payload
    return pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)


def decode_payload(payload: bytes, shm=None, copy: bool = True) -> Any:
    """One frame payload back into its message: the binary magic goes to
    :mod:`.codec` (a malformed frame raises its ``CodecError``; binary bytes
    are never unpickled), anything else is a pickle control frame."""
    if payload[:1] and payload[0] != 0x80:
        from . import codec as codec_mod

        if payload[0] == codec_mod.MAGIC:
            return codec_mod.decode(payload, shm=shm, copy=copy)
    return pickle.loads(payload)


def recv_payload(sock: socket.socket, deadline: Optional[float] = None) -> bytes:
    """Read exactly one frame's payload; :class:`ConnectionClosed` on EOF or
    a torn frame. Timeouts while waiting are not errors, unless
    ``deadline`` (a ``time.monotonic()`` reading; the handshake) passes."""
    header = _recv_exact(sock, _LEN.size, deadline)
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME_BYTES:
        raise ConnectionClosed(f"frame length {n} exceeds {MAX_FRAME_BYTES} — desynced stream")
    return _recv_exact(sock, n, deadline)


def recv_msg(sock: socket.socket, deadline: Optional[float] = None, shm=None,
             copy: bool = True) -> Any:
    """Read and decode exactly one framed message."""
    return decode_payload(recv_payload(sock, deadline), shm=shm, copy=copy)


def _recv_exact(sock: socket.socket, n: int, deadline: Optional[float] = None) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            part = sock.recv(n - len(buf))
        except socket.timeout:
            # idle is fine; only EOF, errors or an explicit deadline end it
            if deadline is not None and time.monotonic() >= deadline:
                raise ConnectionClosed("peer sent nothing before the deadline") from None
            continue
        except OSError as e:
            raise ConnectionClosed(f"socket error mid-frame: {e}") from e
        if not part:
            raise ConnectionClosed("peer closed the connection" + (" mid-frame" if buf else ""))
        buf.extend(part)
    return bytes(buf)


# -- deadlines across the boundary -------------------------------------------


def deadline_to_wire(deadline: Optional[float]) -> Optional[float]:
    """Absolute ``time.monotonic()`` deadline to a remaining budget, clamped
    at 0 (an expired deadline stays expired)."""
    if deadline is None:
        return None
    return max(0.0, deadline - time.monotonic())


def deadline_from_wire(remaining: Optional[float]) -> Optional[float]:
    """Remaining budget to an absolute deadline on this process's clock."""
    if remaining is None:
        return None
    return time.monotonic() + float(remaining)


# -- QoS identity across the boundary ----------------------------------------


def qos_to_wire(priority: Optional[str], tenant: Optional[str]) -> dict:
    """The ``req`` keys of a request's QoS identity; only values other than
    the defaults are shipped."""
    out = {}
    if priority and priority != "normal":
        out["priority"] = str(priority)
    if tenant and tenant != "default":
        out["tenant"] = str(tenant)
    return out


def qos_from_wire(msg: dict) -> "tuple[str, str]":
    """``(priority, tenant)`` of a ``req`` member, absent keys the
    defaults."""
    return (str(msg.get("priority") or "normal"), str(msg.get("tenant") or "default"))


# -- cost accounting across the boundary -------------------------------------


def costs_to_wire(table: Optional[dict]) -> Optional[dict]:
    """A cost table (``{tenant: {priority: {device_s, queue_s,
    payload_bytes, items}}}``) in the compact wire form ``{tenant:
    {priority: [device_s, queue_s, payload_bytes, items]}}``; rows that
    charge nothing are dropped, and an empty table is None."""
    out: dict = {}
    for tenant, prios in (table or {}).items():
        for priority, row in (prios or {}).items():
            vals = [round(float(row.get("device_s") or 0.0), 6),
                    round(float(row.get("queue_s") or 0.0), 6),
                    int(row.get("payload_bytes") or 0), int(row.get("items") or 0)]
            if any(vals):
                out.setdefault(str(tenant), {})[str(priority)] = vals
    return out or None


def costs_from_wire(payload: Optional[dict]) -> list:
    """Wire cost rows to ``[(tenant, priority, {field: value})]``; malformed
    rows are skipped."""
    rows = []
    for tenant, prios in (payload or {}).items():
        if not isinstance(prios, dict):
            continue
        for priority, vals in prios.items():
            if not isinstance(vals, (list, tuple)) or len(vals) < 4:
                continue
            try:
                rows.append((str(tenant), str(priority),
                             {"device_s": float(vals[0]), "queue_s": float(vals[1]),
                              "payload_bytes": int(vals[2]), "items": int(vals[3])}))
            except (TypeError, ValueError):
                continue
    return rows


# -- typed errors across the boundary ----------------------------------------


def encode_error(exc: BaseException) -> dict:
    """A registered serving error (anything else degraded) as a wire-safe
    dict."""
    kind = type(exc).__name__
    if kind not in _registry():
        return {"kind": "WorkerError", "message": str(exc), "original": kind}
    return {"kind": kind, "message": str(exc)}


def decode_error(enc: dict) -> BaseException:
    """The typed error back; unknown kinds come back as
    :class:`WorkerError`."""
    kind = str(enc.get("kind", "WorkerError"))
    message = str(enc.get("message", ""))
    cls = _registry().get(kind)
    if cls is None or cls is WorkerError:
        return WorkerError(enc.get("original", kind), message)
    if cls.__name__ == "NotTraceableError":
        return cls([message])  # it takes the label list, not a message
    try:
        return cls(message)
    except Exception:
        logging.getLogger(__name__).debug(
            "decoding %s with a message-only constructor failed; degrading to WorkerError",
            kind, exc_info=True)
        return WorkerError(kind, message)
