"""The binary hot codec: fixed-layout ``req`` / ``res`` frames with raw
ndarray bytes, no pickle on the serving path (port of
``keystone_tpu/cluster/codec.py``; a frame is byte-equal to the JAX
package's for the same message).

Layout: ``MAGIC VERSION KIND FLAGS COUNT`` (header), then ``COUNT``
members, each a fixed member header (id, flags, deadline budget, QoS
identity, trace context) and one ndarray descriptor (dtype code, ndim,
dims, byte length) followed by the raw C-contiguous bytes, either inline
in the frame or as a (slot, nbytes) descriptor into a negotiated
shared-memory ring (:mod:`.shm`), so the socket frame carries only the
header.

Interop is per frame: a pickle payload (protocol >= 2) begins with
``0x80``, so :data:`MAGIC` is a first byte no pickle starts with, and a
receiver accepts either encoding whatever it negotiated to send. The kill
switch ``KEYSTONE_WIRE_CODEC=pickle`` needs no protocol reset, and a
malformed, torn or future-versioned binary frame raises
:class:`CodecError` and is never handed to ``pickle.loads``.

A frame whose members the dtype table cannot describe (object arrays,
non-array payloads) is not encodable: :func:`encode` returns None and the
caller pickles the same dict.
"""

from __future__ import annotations

import struct
from typing import Any, List, Optional

import numpy as np

from .wire import ConnectionClosed

#: first payload byte of a binary frame. Pickle protocol >= 2 payloads
#: always begin with 0x80 (the PROTO opcode), so any value != 0x80
#: discriminates per-frame; 0xB5 also cannot begin a protocol-0/1 text
#: pickle (those start with ASCII opcodes).
MAGIC = 0xB5
VERSION = 1

KIND_REQ = 1
KIND_RES = 2
_KIND_NAMES = {KIND_REQ: "req", KIND_RES: "res"}

# member flag bits
_MF_DEADLINE = 0x01
_MF_TRACE = 0x02
_MF_SHM = 0x04
_MF_ERROR = 0x08

_HDR = struct.Struct(">BBBBH")  # magic, version, kind, flags, count
_MEMBER = struct.Struct(">QB")  # id, member flags
_F64 = struct.Struct(">d")
_STR = struct.Struct(">I")  # utf-8 byte length prefix
_ARR = struct.Struct(">BB")  # dtype code, ndim
_DIM = struct.Struct(">I")
_NBYTES = struct.Struct(">Q")
_SLOT = struct.Struct(">IQ")  # shm slot index, byte length

#: the closed dtype vocabulary: codes are wire format, append-only.
#: bfloat16 (code 14) joins when ml_dtypes is importable, as in the JAX
#: package. Without it (a machine with no JAX) this end never emits code 14
#: and refuses a received one with CodecError ("unknown dtype code"),
#: rather than reading its bytes as another type.
_DTYPE_NAMES = [
    "bool", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64", "complex64", "complex128",
]
try:  # pragma: no cover - environment-dependent
    import ml_dtypes as _ml_dtypes

    _BF16: Optional[np.dtype] = np.dtype(_ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BF16 = None
except TypeError:  # pragma: no cover - ml_dtypes/numpy skew
    _BF16 = None

_CODE_TO_DTYPE = {i: np.dtype(n) for i, n in enumerate(_DTYPE_NAMES)}
if _BF16 is not None:  # pragma: no branch
    _CODE_TO_DTYPE[len(_DTYPE_NAMES)] = _BF16
_DTYPE_TO_CODE = {dt: code for code, dt in _CODE_TO_DTYPE.items()}

#: a corrupt dim count must not drive a giant allocation before the
#: nbytes cross-check catches it
_MAX_NDIM = 32


class CodecError(ConnectionClosed):
    """A binary frame that cannot be decoded: truncated, corrupt, of a
    future codec version, or of a dtype this end cannot represent. A
    :class:`~keystone_tpu_torch.cluster.wire.ConnectionClosed`, because the
    hot stream that produced it is desynced: the connection is treated as
    down and the requests it carried requeue on peers."""


def _as_wire_array(value: Any) -> Optional[np.ndarray]:
    """``value`` as a C-contiguous ndarray the dtype table can describe,
    or None (caller falls back to pickle). Only array-shaped values are
    eligible — a Python scalar stays a scalar through the pickle path so
    the two codecs return bit-identical result OBJECTS, not just bytes."""
    if not (hasattr(value, "shape") and hasattr(value, "dtype")):
        return None
    try:
        arr = np.asarray(value)
    except Exception:  # lint: allow-silent -- unconvertible: pickle path
        return None
    if arr.dtype not in _DTYPE_TO_CODE:
        return None
    if not arr.flags["C_CONTIGUOUS"]:
        # NB: guarded — np.ascontiguousarray promotes 0-d to 1-d, and a
        # 0-d array is always contiguous, so it never reaches this
        arr = np.ascontiguousarray(arr)
    return arr


def _put_str(parts: List[Any], s: Optional[str]) -> None:
    raw = (s or "").encode("utf-8")
    parts.append(_STR.pack(len(raw)))
    parts.append(raw)


def _put_array(
    parts: List[Any],
    arr: np.ndarray,
    shm=None,
    min_shm_bytes: int = 1 << 16,
    metrics=None,
) -> None:
    """One ndarray descriptor + its bytes: into a ring slot when the
    payload clears the threshold and a slot is free, inline otherwise
    (counted — ring exhaustion degrades, never blocks)."""
    parts.append(_ARR.pack(_DTYPE_TO_CODE[arr.dtype], arr.ndim))
    for dim in arr.shape:
        parts.append(_DIM.pack(dim))
    nbytes = arr.nbytes
    try:
        # zero-copy byte view; extension dtypes (bfloat16) don't export
        # the buffer protocol and take the one-copy tobytes path
        view: Any = memoryview(arr).cast("B")
    except (ValueError, TypeError):
        view = arr.tobytes()
    if shm is not None and nbytes >= min_shm_bytes:
        slot = shm.alloc(nbytes)
        if slot is not None:
            shm.write(slot, view)
            parts.append(b"\x01")
            parts.append(_SLOT.pack(slot, nbytes))
            if metrics is not None:
                metrics.inc("shm.payloads")
                metrics.inc("shm.bytes", nbytes)
            return
        if metrics is not None:
            metrics.inc("shm.fallback")
    parts.append(b"\x00")
    parts.append(_NBYTES.pack(nbytes))
    parts.append(view)


def encode(
    msg: dict,
    shm=None,
    min_shm_bytes: int = 1 << 16,
    metrics=None,
) -> Optional[bytes]:
    """``msg`` (a member-list ``req``/``res`` dict — the wire schema
    :mod:`.router` and :mod:`.worker` speak) as one binary frame, or
    None when any member's payload falls outside the dtype table (the
    caller then pickles the SAME dict: the two encodings are
    interchangeable per frame).

    ``shm`` is this direction's TX ring; payloads of at least
    ``min_shm_bytes`` land in slots when one is free. The sender must
    not touch a written slot again — the receiver frees it once the
    member is answered (reply receipt IS the reclamation signal)."""
    kind = msg.get("type")
    if kind == "req":
        return _encode_req(msg, shm, min_shm_bytes, metrics)
    if kind == "res":
        return _encode_res(msg, shm, min_shm_bytes, metrics)
    return None


def _encode_req(msg, shm, min_shm_bytes, metrics) -> Optional[bytes]:
    from ..autoscale.qos import PRIORITY_RANK

    members = msg.get("members")
    if not isinstance(members, list) or len(members) > 0xFFFF:
        return None
    arrays = []
    for m in members:
        arr = _as_wire_array(m.get("datum"))
        if arr is None:
            return None
        prio = m.get("priority") or "normal"
        if prio not in PRIORITY_RANK:
            return None
        arrays.append(arr)
    parts: List[Any] = [_HDR.pack(MAGIC, VERSION, KIND_REQ, 0, len(members))]
    for m, arr in zip(members, arrays):
        mflags = 0
        deadline_rem = m.get("deadline_rem")
        trace = m.get("trace")
        if deadline_rem is not None:
            mflags |= _MF_DEADLINE
        if trace is not None:
            mflags |= _MF_TRACE
        parts.append(_MEMBER.pack(int(m["id"]), mflags))
        if deadline_rem is not None:
            parts.append(_F64.pack(float(deadline_rem)))
        parts.append(bytes([PRIORITY_RANK[m.get("priority") or "normal"]]))
        _put_str(parts, m.get("tenant") or "")
        if trace is not None:
            _put_str(parts, str(trace.get("id") or ""))
            _put_str(parts, trace.get("hop"))
            parts.append(_F64.pack(float(trace.get("sent_unix") or 0.0)))
        _put_array(parts, arr, shm, min_shm_bytes, metrics)
    return b"".join(parts)


def _encode_res(msg, shm, min_shm_bytes, metrics) -> Optional[bytes]:
    members = msg.get("members")
    if not isinstance(members, list) or len(members) > 0xFFFF:
        return None
    arrays: List[Optional[np.ndarray]] = []
    for m in members:
        if m.get("ok"):
            arr = _as_wire_array(m.get("value"))
            if arr is None:
                return None
            arrays.append(arr)
        else:
            if not isinstance(m.get("error"), dict):
                return None
            arrays.append(None)
    parts: List[Any] = [_HDR.pack(MAGIC, VERSION, KIND_RES, 0, len(members))]
    parts.append(_F64.pack(float(msg.get("t_unix") or 0.0)))
    for m, arr in zip(members, arrays):
        if arr is None:
            parts.append(_MEMBER.pack(int(m["id"]), _MF_ERROR))
            err = m["error"]
            _put_str(parts, str(err.get("kind") or "WorkerError"))
            _put_str(parts, str(err.get("message") or ""))
            _put_str(parts, err.get("original"))
        else:
            parts.append(_MEMBER.pack(int(m["id"]), 0))
            _put_array(parts, arr, shm, min_shm_bytes, metrics)
    return b"".join(parts)


class _Reader:
    """Bounds-checked cursor over one frame's bytes; every overrun is a
    :class:`CodecError` (torn frame), never an IndexError."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise CodecError(
                f"binary frame truncated: wanted {n} byte(s) at offset "
                f"{self.pos}, frame is {len(self.buf)}"
            )
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))

    def string(self) -> str:
        (n,) = self.unpack(_STR)
        try:
            return self.take(n).decode("utf-8")
        except UnicodeDecodeError as e:
            raise CodecError(f"binary frame corrupt: bad utf-8 ({e})") from e


def _read_array(r: _Reader, shm, copy: bool, slots: List[int]) -> np.ndarray:
    code, ndim = r.unpack(_ARR)
    dtype = _CODE_TO_DTYPE.get(code)
    if dtype is None:
        raise CodecError(f"binary frame corrupt: unknown dtype code {code}")
    if ndim > _MAX_NDIM:
        raise CodecError(f"binary frame corrupt: ndim {ndim}")
    shape = tuple(r.unpack(_DIM)[0] for _ in range(ndim))
    placement = r.take(1)[0]
    expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if placement == 0:
        (nbytes,) = r.unpack(_NBYTES)
        if nbytes != expect:
            raise CodecError(
                f"binary frame corrupt: {nbytes} payload byte(s) for "
                f"shape {shape} dtype {dtype} (expected {expect})"
            )
        raw: Any = r.take(nbytes)
    elif placement == 1:
        slot, nbytes = r.unpack(_SLOT)
        if nbytes != expect:
            raise CodecError(
                f"binary frame corrupt: shm slot {slot} carries {nbytes} "
                f"byte(s) for shape {shape} dtype {dtype} "
                f"(expected {expect})"
            )
        if shm is None:
            raise CodecError(
                f"frame references shm slot {slot} but no ring is "
                "attached on this connection"
            )
        raw = shm.view(slot, nbytes)
        if copy:
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
            shm.free(slot)
            return arr
        slots.append(slot)
    else:
        raise CodecError(
            f"binary frame corrupt: payload placement {placement}"
        )
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    return arr.copy() if copy and placement == 0 else arr


def decode(payload: bytes, shm=None, copy: bool = True) -> dict:
    """One binary frame back into the member-list dict :func:`encode`
    took. ``shm`` is this direction's RX ring (required iff the sender
    negotiated one). ``copy=True`` (the router's reply path) detaches
    every array from the frame/ring — slots are freed HERE, before any
    caller-visible object can alias reusable memory. ``copy=False`` (the
    worker's request path) hands out zero-copy read-only views; the
    frame's ring slots ride out under ``msg["_shm_slots"]`` and the
    caller frees them when the members are answered."""
    from ..autoscale.qos import PRIORITIES

    r = _Reader(payload)
    magic, version, kind, _flags, count = r.unpack(_HDR)
    if magic != MAGIC:
        raise CodecError(f"not a binary frame (first byte {magic:#x})")
    if version != VERSION:
        raise CodecError(
            f"binary codec version skew: frame v{version}, this peer "
            f"speaks v{VERSION} — negotiate pickle or upgrade"
        )
    if kind not in _KIND_NAMES:
        raise CodecError(f"binary frame corrupt: unknown kind {kind}")
    slots: List[int] = []
    members = []
    if kind == KIND_RES:
        (t_unix,) = r.unpack(_F64)
    for _ in range(count):
        member_id, mflags = r.unpack(_MEMBER)
        if kind == KIND_REQ:
            m: dict = {"id": member_id}
            if mflags & _MF_DEADLINE:
                (m["deadline_rem"],) = r.unpack(_F64)
            rank = r.take(1)[0]
            if rank >= len(PRIORITIES):
                raise CodecError(
                    f"binary frame corrupt: priority rank {rank}"
                )
            prio = PRIORITIES[rank]
            if prio != "normal":
                m["priority"] = prio
            tenant = r.string()
            if tenant:
                m["tenant"] = tenant
            if mflags & _MF_TRACE:
                trace_id = r.string()
                hop = r.string()
                (sent_unix,) = r.unpack(_F64)
                m["trace"] = {
                    "id": trace_id, "hop": hop or None,
                    "sent_unix": sent_unix,
                }
            m["datum"] = _read_array(r, shm, copy, slots)
        else:
            if mflags & _MF_ERROR:
                m = {
                    "id": member_id, "ok": False,
                    "error": {"kind": r.string(), "message": r.string()},
                }
                original = r.string()
                if original:
                    m["error"]["original"] = original
            else:
                m = {
                    "id": member_id, "ok": True,
                    "value": _read_array(r, shm, copy, slots),
                }
        members.append(m)
    if r.pos != len(payload):
        raise CodecError(
            f"binary frame corrupt: {len(payload) - r.pos} trailing "
            "byte(s)"
        )
    msg: dict = {"type": _KIND_NAMES[kind], "members": members}
    if kind == KIND_RES:
        msg["t_unix"] = t_unix
    if slots:
        msg["_shm_slots"] = slots
    return msg
