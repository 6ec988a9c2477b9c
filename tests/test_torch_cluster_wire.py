"""The cluster wire and its binary codec on the port, held against the JAX
package's: the cases of ``tests/cluster/test_wire.py`` and
``tests/cluster/test_codec.py`` run on ``keystone_tpu_torch.cluster``; for
each message kind and each dtype the codec carries, a frame the JAX
package encodes decodes in the port to equal values and the reverse, and
the port's encoding is byte-equal to JAX's (tolerance: none, bytes and
values equal); typed errors arrive as the port's own types; and without
``ml_dtypes`` a bfloat16 frame raises ``CodecError`` instead of decoding
to other bytes."""

import pickle
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from keystone_tpu.cluster import codec as jcodec
from keystone_tpu.cluster import wire as jwire
from keystone_tpu.serving import errors as jerrors
from keystone_tpu_torch.cluster import codec as tcodec
from keystone_tpu_torch.cluster import wire as twire
from keystone_tpu_torch.cluster.codec import MAGIC, VERSION, CodecError, decode, encode
from keystone_tpu_torch.cluster.shm import ShmRing
from keystone_tpu_torch.cluster.wire import (
    ConnectionClosed,
    WorkerError,
    deadline_from_wire,
    deadline_to_wire,
    decode_error,
    decode_payload,
    encode_error,
    recv_msg,
    send_msg,
    send_payload,
)
from keystone_tpu_torch.serving import errors as terrors
from keystone_tpu_torch.workflow.pipeline import NotTraceableError

ROOT = Path(__file__).resolve().parent.parent
DTYPES = sorted(tcodec._CODE_TO_DTYPE.values(), key=str)


class _Counters:
    """The codec calls only ``inc``."""

    def __init__(self):
        self.counts = {}

    def inc(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n


def _roundtrip(msg, **kw):
    payload = encode(msg, **kw)
    assert payload is not None, msg
    assert payload[0] == MAGIC
    return decode(payload)


def _assert_msgs_equal(a, b):
    """Two decoded messages equal: arrays by dtype, shape and bytes."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert set(a) == set(b), (a, b)
        for k in a:
            _assert_msgs_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_msgs_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


# ---------------------------------------------------------------------------
# the JAX package's and the port's frames: byte-equal, decodable both ways
# ---------------------------------------------------------------------------


def _members(dtype):
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 2, size=(3, 5)).astype(dtype)
    return arr, [
        {"id": 11, "datum": arr, "deadline_rem": 0.25, "priority": "high", "tenant": "acme",
         "trace": {"id": "1f-2", "hop": "rpc.request", "sent_unix": 1700000000.5}},
        {"id": 12, "datum": arr[:1]},
        {"id": 13, "datum": arr[0, 0], "priority": "low"},
    ]


def _res(dtype):
    arr = np.arange(6).reshape(2, 3).astype(dtype)
    return {"type": "res", "t_unix": 1700000000.25, "members": [
        {"id": 5, "ok": True, "value": arr},
        {"id": 6, "ok": False, "error": {"kind": "Shed", "message": "late"}},
        {"id": 7, "ok": False, "error": {"kind": "WorkerError", "message": "odd",
                                         "original": "Weird"}},
    ]}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("kind", ["req", "res"])
def test_frames_are_byte_equal_to_jax_and_decode_both_ways(kind, dtype):
    msg = {"type": "req", "members": _members(dtype)[1]} if kind == "req" else _res(dtype)
    mine, theirs = tcodec.encode(msg), jcodec.encode(msg)
    assert mine is not None and mine == theirs
    _assert_msgs_equal(tcodec.decode(theirs), jcodec.decode(theirs))
    _assert_msgs_equal(jcodec.decode(mine), tcodec.decode(mine))
    # through each side's frame dispatcher too
    _assert_msgs_equal(twire.decode_payload(theirs), jwire.decode_payload(mine))


@pytest.mark.parametrize("codec", ["binary", "pickle"])
@pytest.mark.parametrize("msg", [
    {"type": "hello", "token": "ab" * 16, "worker": 1, "pid": 4242, "codec": 1},
    {"type": "ready", "worker": 0, "compiles": 0, "aot_loads": 4, "capacity": 64,
     "replicas": 1, "devices": ["cuda:0"], "shm": True},
    {"type": "ping", "t": 12.5},
    {"type": "pong", "t": 12.5, "service_estimate": 0.004,
     "costs": {"acme": {"high": [0.5, 0.1, 2048, 4]}}},
    {"type": "stats", "seq": 3},
    {"type": "stop", "drain": True},
    {"type": "bye", "worker": 1},
], ids=lambda m: m["type"])
def test_control_frames_are_byte_equal_to_jax(codec, msg):
    mine = twire.encode_msg(msg, codec=codec)
    theirs = jwire.encode_msg(msg, codec=codec)
    assert mine == theirs and mine[0] == 0x80  # control frames stay pickle
    assert twire.decode_payload(theirs) == msg == jwire.decode_payload(mine)


def test_shm_frames_interoperate_with_jax_rings():
    from multiprocessing import resource_tracker

    from keystone_tpu.cluster.shm import ShmRing as JShmRing

    ring = ShmRing("kstwireshm", 2, 1 << 12, create=True)
    jring = JShmRing("kstwireshm", 2, 1 << 12, create=False)
    # the attach dropped this process's tracker claim, which the creator
    # shares here (in production the attacher is another process)
    resource_tracker.register("/kstwireshm", "shared_memory")
    try:
        arr = np.arange(512, dtype=np.float32)
        msg = {"type": "req", "members": [{"id": 1, "datum": arr}]}
        mine = tcodec.encode(msg, shm=ring, min_shm_bytes=1024)
        got = jcodec.decode(mine, shm=jring, copy=True)
        np.testing.assert_array_equal(got["members"][0]["datum"], arr)
        assert ring.in_use == 0  # the JAX reader freed the port writer's slot
        theirs = jcodec.encode(msg, shm=jring, min_shm_bytes=1024)
        assert theirs == mine  # the same slot, the same descriptor
        np.testing.assert_array_equal(
            tcodec.decode(theirs, shm=ring, copy=True)["members"][0]["datum"], arr)
    finally:
        jring.close()
        ring.close()
        ring.unlink()


@pytest.mark.parametrize("exc,port_type", [
    (jerrors.Shed("late"), terrors.Shed),
    (jerrors.DeadlineExceeded("x"), terrors.DeadlineExceeded),
    (jerrors.QueueFull("full"), terrors.QueueFull),
    (jerrors.EngineStopped("bye"), terrors.EngineStopped),
    (jerrors.InvalidRequest("shape"), terrors.InvalidRequest),
    (jerrors.CanaryMismatch("diverged"), terrors.CanaryMismatch),
], ids=lambda v: getattr(v, "__name__", type(v).__name__))
def test_jax_typed_errors_arrive_as_the_ports_types(exc, port_type):
    enc = jwire.encode_error(exc)
    assert encode_error(port_type(str(exc))) == enc
    back = decode_error(enc)
    assert type(back) is port_type and str(exc) in str(back)
    # and the port's error, decoded by the JAX package, is JAX's type
    assert type(jwire.decode_error(encode_error(back))) is type(exc)


def test_not_traceable_and_unknown_errors_cross_typed():
    from keystone_tpu.workflow.pipeline import NotTraceableError as JNotTraceableError

    back = decode_error(jwire.encode_error(JNotTraceableError(["n"])))
    assert isinstance(back, NotTraceableError)
    oom = decode_error(encode_error(MemoryError("CUDA out of memory")))
    assert isinstance(oom, WorkerError) and oom.kind == "MemoryError"
    assert type(jwire.decode_error(encode_error(MemoryError("x")))) is jwire.WorkerError


def test_bf16_without_ml_dtypes_is_a_codec_error():
    """A machine without JAX has no ``ml_dtypes``: the codec there never
    emits code 14 and refuses a received bfloat16 frame, typed."""
    import ml_dtypes

    arr = np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16)
    frame = jcodec.encode({"type": "req", "members": [{"id": 1, "datum": arr}]})
    assert frame is not None and tcodec.decode(frame)["members"][0]["datum"].dtype == arr.dtype
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import numpy as np\n"
        "from keystone_tpu_torch.cluster import codec\n"
        "assert codec._BF16 is None and 14 not in codec._CODE_TO_DTYPE\n"
        "frame = bytes.fromhex(sys.stdin.read())\n"
        "try:\n"
        "    codec.decode(frame)\n"
        "except codec.CodecError as e:\n"
        "    assert 'dtype code 14' in str(e), e\n"
        "    print('REFUSED')\n"
        "assert codec.encode({'type': 'req', 'members': [{'id': 1, 'datum': "
        "np.ones(2, np.float32)}]}) is not None\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], input=frame.hex(), cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "REFUSED"


# ---------------------------------------------------------------------------
# tests/cluster/test_wire.py on the port
# ---------------------------------------------------------------------------


def test_frame_round_trip_with_arrays():
    a, b = socket.socketpair()
    try:
        msg = {"type": "req", "id": 7, "datum": np.arange(12, dtype=np.float32).reshape(3, 4)}
        send_msg(a, msg)
        got = recv_msg(b)
        assert got["type"] == "req" and got["id"] == 7
        np.testing.assert_array_equal(got["datum"], msg["datum"])
    finally:
        a.close()
        b.close()


def test_a_jax_sender_and_a_port_receiver_share_a_socket():
    a, b = socket.socketpair()
    try:
        jwire.send_payload(a, jwire.encode_msg(
            {"type": "req", "members": [{"id": 3, "datum": np.ones(4, np.float32)}]},
            codec="binary"))
        jwire.send_msg(a, {"type": "ping", "t": 1.0})
        got = recv_msg(b)
        np.testing.assert_array_equal(got["members"][0]["datum"], np.ones(4, np.float32))
        assert recv_msg(b) == {"type": "ping", "t": 1.0}
        send_payload(b, twire.encode_msg({"type": "res", "t_unix": 2.0, "members": [
            {"id": 3, "ok": True, "value": np.zeros(2, np.float64)}]}, codec="binary"))
        back = jwire.recv_msg(a)
        assert back["t_unix"] == 2.0 and back["members"][0]["id"] == 3
    finally:
        a.close()
        b.close()


def test_interleaved_frames_stay_ordered():
    a, b = socket.socketpair()
    try:
        lock = threading.Lock()

        def sender(lo, hi):
            for i in range(lo, hi):
                with lock:
                    send_msg(a, {"i": i})

        ts = [threading.Thread(target=sender, args=(k * 50, k * 50 + 50)) for k in range(2)]
        for t in ts:
            t.start()
        seen = sorted(recv_msg(b)["i"] for _ in range(100))
        for t in ts:
            t.join()
        assert seen == list(range(100))
    finally:
        a.close()
        b.close()


def test_eof_raises_connection_closed():
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(ConnectionClosed):
        recv_msg(b)
    b.close()


def test_mid_frame_eof_raises_connection_closed():
    a, b = socket.socketpair()
    a.sendall(b"\x00\x00\x01\x00partial")
    a.close()
    with pytest.raises(ConnectionClosed, match="mid-frame"):
        recv_msg(b)
    b.close()


def test_deadline_travels_as_remaining_budget():
    deadline = time.monotonic() + 5.0
    rem = deadline_to_wire(deadline)
    assert 4.9 < rem <= 5.0
    # re-anchored on this clock: the hop only shrinks the budget
    assert deadline_from_wire(rem) - time.monotonic() <= 5.0
    assert deadline_to_wire(None) is None and deadline_from_wire(None) is None
    assert deadline_to_wire(time.monotonic() - 10.0) == 0.0  # expired stays expired
    # a JAX sender's budget re-anchors the same way
    assert deadline_from_wire(jwire.deadline_to_wire(deadline)) - time.monotonic() <= 5.0


@pytest.mark.parametrize("exc", [terrors.Shed("late"), terrors.DeadlineExceeded("x"),
                                 terrors.QueueFull("full"), terrors.EngineStopped("bye")],
                         ids=lambda e: type(e).__name__)
def test_typed_errors_round_trip(exc):
    back = decode_error(encode_error(exc))
    assert type(back) is type(exc) and str(exc) in str(back)


def test_unknown_error_degrades_to_worker_error():
    class Weird(Exception):
        pass

    back = decode_error(encode_error(Weird("odd")))
    assert isinstance(back, WorkerError) and "Weird" in str(back)


def test_send_timeout_knob(monkeypatch):
    from keystone_tpu_torch.cluster.wire import _resolve_send_timeout

    monkeypatch.delenv("KEYSTONE_WIRE_SEND_TIMEOUT", raising=False)
    assert _resolve_send_timeout() == 15.0
    monkeypatch.setenv("KEYSTONE_WIRE_SEND_TIMEOUT", "7.5")
    assert _resolve_send_timeout() == 7.5
    monkeypatch.setenv("KEYSTONE_WIRE_SEND_TIMEOUT", "0")
    assert _resolve_send_timeout() == 0.1
    monkeypatch.setenv("KEYSTONE_WIRE_SEND_TIMEOUT", "soon")
    assert _resolve_send_timeout() == 15.0


def test_stalled_send_degrades_typed():
    a, b = socket.socketpair()
    try:
        a.settimeout(0.2)
        chunk = b"\x00" * (1 << 20)
        with pytest.raises(ConnectionClosed, match="stopped reading"):
            for _ in range(256):
                send_payload(a, chunk)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# tests/cluster/test_codec.py on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_req_round_trip_every_wire_dtype(dtype):
    arr = np.random.RandomState(0).randint(0, 2, size=(3, 5)).astype(dtype)
    got = _roundtrip({"type": "req", "members": [{"id": 11, "datum": arr, "deadline_rem": 0.25}]})
    m = got["members"][0]
    assert got["type"] == "req" and m["id"] == 11 and m["deadline_rem"] == 0.25
    assert m["datum"].dtype == dtype and m["datum"].shape == arr.shape
    assert m["datum"].tobytes() == arr.tobytes()


@pytest.mark.parametrize("arr", [
    np.float32(3.5) * np.ones(()),
    np.zeros((0,), np.float64),
    np.zeros((4, 0, 2), np.int32),
    np.arange(24, dtype=np.int16).reshape(2, 3, 4),
], ids=["zero-d", "empty", "zero-dim", "three-d"])
def test_req_round_trip_shapes(arr):
    m = _roundtrip({"type": "req", "members": [{"id": 1, "datum": arr}]})["members"][0]
    np.testing.assert_array_equal(m["datum"], arr)
    assert m["datum"].shape == arr.shape and m["datum"].dtype == arr.dtype
    assert encode({"type": "req", "members": [{"id": 1, "datum": arr}]}) == jcodec.encode(
        {"type": "req", "members": [{"id": 1, "datum": arr}]})


def test_req_members_keep_individual_identity():
    members = [
        {"id": 1, "datum": np.ones((2,), np.float32), "deadline_rem": 0.5, "priority": "high",
         "tenant": "acme", "trace": {"id": "t-1", "hop": "router", "sent_unix": 123.5}},
        {"id": 2, "datum": np.zeros((2,), np.float32)},
        {"id": 3, "datum": np.full((2,), 7, np.float32), "priority": "low", "tenant": "beta"},
    ]
    got = _roundtrip({"type": "req", "members": members})["members"]
    assert [m["id"] for m in got] == [1, 2, 3]
    assert got[0]["priority"] == "high" and got[0]["tenant"] == "acme"
    assert got[0]["trace"] == {"id": "t-1", "hop": "router", "sent_unix": 123.5}
    assert "priority" not in got[1] and "tenant" not in got[1]
    assert "deadline_rem" not in got[1] and "trace" not in got[1]
    assert got[2]["priority"] == "low" and got[2]["tenant"] == "beta"


def test_res_round_trip_values_and_typed_errors():
    msg = _res(np.float64)
    got = _roundtrip(msg)
    assert got["t_unix"] == msg["t_unix"]
    ok, shed, weird = got["members"]
    np.testing.assert_array_equal(ok["value"], msg["members"][0]["value"])
    assert shed == {"id": 6, "ok": False, "error": {"kind": "Shed", "message": "late"}}
    assert weird["error"]["original"] == "Weird"


def test_non_describable_frames_return_none():
    for msg in (
        {"type": "req", "members": [{"id": 1, "datum": np.array([object()])}]},
        {"type": "req", "members": [{"id": 1, "datum": np.ones(2, np.float32),
                                     "priority": "vip"}]},
        {"type": "req", "members": [{"id": 1, "datum": 3.5}]},
        {"type": "res", "members": [{"id": 1, "ok": True, "value": "not an array"}]},
        {"type": "res", "members": [{"id": 1, "ok": False, "error": "not a dict"}]},
        {"type": "hello"},
    ):
        assert encode(msg) is None and jcodec.encode(msg) is None


def test_non_contiguous_input_round_trips():
    view = np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2]
    m = _roundtrip({"type": "req", "members": [{"id": 1, "datum": view}]})["members"][0]
    np.testing.assert_array_equal(m["datum"], view)


def _valid_req_payload():
    payload = encode({"type": "req", "members": [{"id": 9, "datum": np.arange(8, dtype=np.float32)}]})
    assert payload is not None
    return payload


def test_truncated_frame_degrades_typed():
    payload = _valid_req_payload()
    for cut in (1, 3, len(payload) // 2, len(payload) - 1):
        with pytest.raises(CodecError):
            decode(payload[:cut])


def test_trailing_bytes_degrade_typed():
    with pytest.raises(CodecError, match="trailing"):
        decode(_valid_req_payload() + b"\x00")


def test_version_skew_degrades_typed():
    payload = bytearray(_valid_req_payload())
    payload[1] = VERSION + 1
    with pytest.raises(CodecError, match="version skew"):
        decode(bytes(payload))


def test_corrupt_fields_degrade_typed():
    base = _valid_req_payload()
    dtype_code_off = 6 + 8 + 1 + 1 + 4  # header, id, flags, priority, tenant length
    for offset, value in [(2, 99), (dtype_code_off, 200), (dtype_code_off + 1, 40)]:
        payload = bytearray(base)
        payload[offset] = value
        with pytest.raises(CodecError):
            decode(bytes(payload))


def test_codec_error_is_connection_closed():
    assert issubclass(CodecError, ConnectionClosed)
    with pytest.raises(ConnectionClosed):
        decode(b"\xb5garbage")


def test_binary_bytes_never_reach_the_unpickler(monkeypatch):
    calls = []
    real_loads = pickle.loads

    def spy(data, *a, **kw):
        calls.append(data[:1])
        return real_loads(data, *a, **kw)

    monkeypatch.setattr("keystone_tpu_torch.cluster.wire.pickle.loads", spy)
    with pytest.raises(CodecError):
        decode_payload(bytes([MAGIC]) + b"\x00" * 32)
    assert calls == [], "binary payload was handed to pickle.loads"
    assert decode_payload(pickle.dumps({"type": "ping"})) == {"type": "ping"}
    assert calls


def test_magic_collides_with_no_pickle_protocol():
    for proto in range(2, pickle.HIGHEST_PROTOCOL + 1):
        assert pickle.dumps({"x": 1}, protocol=proto)[0] == 0x80
    assert MAGIC != 0x80 and MAGIC == jcodec.MAGIC and VERSION == jcodec.VERSION
