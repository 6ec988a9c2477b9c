"""The cluster worker process: one device slice, one local ServingFleet,
one socket back to the router (port of ``keystone_tpu/cluster/worker.py``).

The router starts it as a fresh interpreter, ``python -m
keystone_tpu_torch.cluster.worker host port token worker_id``, with the
boot spec pickled on stdin: never a fork (a forked CUDA context is
unusable) and never ``multiprocessing``'s spawn. A worker's life:

1. **Connect and hello.** Dial the router, present the spawn token and the
   worker id (the router refuses strangers).
2. **Warm boot.** Configure the shared AOT cache directory, build the
   model (a ``"module:callable"`` factory re-run deterministically with
   ``device=`` this worker's device, or a shipped model whose tensors
   arrive as host bytes and load onto this worker's device), place the
   replicas (:func:`_worker_devices`: the card unless the spec's
   ``device`` names the CPU) and start a local
   :class:`~keystone_tpu_torch.serving.ServingFleet`. ``start()`` warms
   every bucket and every signature of the shared manifest, so a worker
   against a warm cache pays zero traces; ``ready`` reports ``compiles``
   and ``aot_loads``. A worker that cannot reach the card fails its boot;
   it never serves on the CPU unless asked.
3. **Serve.** Each request frame's members become ``fleet.submit`` calls
   with their deadlines re-anchored from the wire budget; one reply frame
   goes back when the frame's last member settles (replica threads answer
   out of order; the router matches by id). Typed serving errors cross by
   name (:mod:`.wire`).
4. **Die loudly or drain cleanly.** ``stop`` drains the fleet and answers
   ``bye``; a dead router (EOF) shuts the fleet down and exits nonzero;
   SIGTERM drains too; SIGQUIT dumps the flight ring.

**A device fault ends the worker.** A kernel, out-of-memory or CUDA error
in a batch stops the local fleet (``serving/fleet.py``): the batch's
requests and every admitted one are answered with it (a
:class:`~.wire.WorkerError` naming the fault's class at the router, not
requeued: the same model would meet it again). The worker then closes its
connection and exits with code 3, so the router respawns it with a fresh
CUDA context within its restart budget, and requeues what the worker had
not answered. The JAX package's worker has no such path: a fault there
fails its batch and the worker serves on.
"""

from __future__ import annotations

import io
import logging
import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Optional

logger = logging.getLogger(__name__)

#: the exit code of a worker that a device fault ended
DEVICE_FAULT_EXIT = 3


def model_bytes(fitted: Any) -> bytes:
    """A fitted pipeline as bytes to ship to worker processes: its tensors
    as host bytes (``torch.save`` copies each storage off the card), so a
    worker loads them onto its own device and never onto the device index
    they came from."""
    import torch

    buf = io.BytesIO()
    torch.save(fitted, buf)
    return buf.getvalue()


def load_model_bytes(data: bytes, device: Any) -> Any:
    """:func:`model_bytes` back into a fitted pipeline with every tensor on
    ``device``. Only for bytes this program's router wrote (unpickling runs
    code)."""
    import torch

    return torch.load(io.BytesIO(data), map_location=torch.device(device),
                      weights_only=False)


def resolve_model(model_spec: Any, device: Any):
    """The FittedPipeline a worker serves. ``("factory", "module:callable",
    kwargs)`` imports the callable and calls it with ``kwargs`` and
    ``device=`` (the deterministic rebuild: same fit, same AOT fingerprint,
    warm boot from the shared cache); ``("pickle", bytes)`` loads a shipped
    model (:func:`model_bytes`) onto ``device``."""
    kind = model_spec[0]
    if kind == "factory":
        import importlib

        path, kwargs = model_spec[1], dict(model_spec[2] or {})
        mod_name, _, fn_name = path.partition(":")
        if not fn_name:
            raise ValueError(f"model factory {path!r} must be 'module:callable'")
        fn = getattr(importlib.import_module(mod_name), fn_name)
        kwargs.setdefault("device", str(device))
        return fn(**kwargs)
    if kind == "pickle":
        return load_model_bytes(model_spec[1], device)
    raise ValueError(f"unknown model spec kind {kind!r}")


def _worker_devices(worker_id: int, n_workers: int, replicas: Optional[int],
                    device: Any = None) -> list:
    """This worker's replica devices: its slice of
    :func:`~keystone_tpu_torch.parallel.placement.data_axis_devices` (the
    data axis of the default mesh: every card, or the provisioned virtual
    devices; or the one device ``device`` names), round robin up to
    ``replicas``. With more workers than cards, workers share a card, each
    in its own CUDA context, which the card time-slices. A worker that owns
    several cards resolves its model once, onto the first, and serves on
    each through the fleet's copy of the model there."""
    from ..parallel.placement import data_axis_devices, worker_device_indices

    devs = data_axis_devices(device)
    idxs = worker_device_indices(worker_id, n_workers, device)
    n = replicas if replicas is not None else len(idxs)
    return [devs[idxs[i % len(idxs)]] for i in range(max(1, n))]


def worker_main(host: str, port: int, token: str, worker_id: int, spec: dict) -> int:
    """The spawned process's entry point; returns its exit code."""
    logging.basicConfig(
        level=getattr(logging, str(spec.get("log_level", "warning")).upper(), logging.WARNING),
        format=f"[worker-{worker_id}] %(levelname)s %(name)s: %(message)s")
    if spec.get("virtual_devices"):
        # the worker serves its replicas over that many slots of the CPU,
        # as the JAX worker does over its virtual devices
        from ..parallel.virtual import provision_virtual_devices

        provision_virtual_devices(int(spec["virtual_devices"]))
    if spec.get("aot_cache"):
        from .. import compile as compile_mod

        compile_mod.configure(spec["aot_cache"])

    from ..obs import flight as _flight
    from ..obs import tracer as _obs_tracer
    from ..obs.context import TraceContext
    from ..obs.export import wire_spans
    from ..obs.span import Span
    from ..serving import ServingFleet
    from ..utils import env_int
    from .wire import (
        SEND_TIMEOUT_S,
        ConnectionClosed,
        costs_to_wire,
        deadline_from_wire,
        decode_payload,
        encode_error,
        encode_msg,
        qos_from_wire,
        recv_payload,
        send_payload,
    )

    # the flight recorder is always on; SIGQUIT dumps it from a live worker
    _flight.install_sigquit_dump()
    # a traced router asks for traced workers: their spans ship back on
    # stats replies and stitch into one cross-process trace
    tracer = _obs_tracer.start() if spec.get("trace") else None
    process_name = f"keystone:worker-{worker_id}/{os.getpid()}"
    span_cursor = [0]  # spans_since bookmark: each span ships once
    # (tenant, priority) -> the cumulative cost row last shipped: pongs
    # ship deltas, which the router folds additively
    cost_cursor: dict = {}

    def _cost_deltas(cursor: dict, table: dict) -> dict:
        out: dict = {}
        for tenant, prios in table.items():
            for priority, row in prios.items():
                prev = cursor.get((tenant, priority)) or {}
                delta = {k: row.get(k, 0) - prev.get(k, 0)
                         for k in ("device_s", "queue_s", "payload_bytes", "items")}
                cursor[(tenant, priority)] = dict(row)
                if any(v > 1e-9 if isinstance(v, float) else v for v in delta.values()):
                    out.setdefault(tenant, {})[priority] = delta
        return out

    # the hot-wire negotiation: the spec names the codec the router sends
    # (and expects back) and the shared-memory ring pair to attach; a
    # failed attach is an answer (shm false in ready), not an error
    reply_codec = "binary" if (spec.get("wire") or {}).get("codec") == "binary" else "pickle"
    shm_min_bytes = env_int("KEYSTONE_SHM_MIN_BYTES", 1 << 16, minimum=1)
    shm_rx = shm_tx = None
    shm_cfg = spec.get("shm")
    if shm_cfg and reply_codec == "binary":
        from .shm import ShmRing

        try:
            shm_rx = ShmRing(shm_cfg["c2w"], shm_cfg["slots"], shm_cfg["slot_bytes"])
            shm_tx = ShmRing(shm_cfg["w2c"], shm_cfg["slots"], shm_cfg["slot_bytes"])
        except Exception:
            logger.warning("worker %d: shared-memory attach failed — wire payloads stay "
                           "inline", worker_id, exc_info=True)
            if shm_rx is not None:
                shm_rx.close()
            shm_rx = shm_tx = None

    sock = socket.create_connection((host, port), timeout=30.0)
    sock.settimeout(SEND_TIMEOUT_S)  # bounded sends, receives ride timeouts out
    send_lock = threading.Lock()
    # control replies go out before the fleet (and its registry) exists
    metrics_ref: list = [None]

    def reply(msg: dict) -> None:
        payload = encode_msg(msg)  # control frames: pickle
        with send_lock:
            send_payload(sock, payload)
        m = metrics_ref[0]
        if m is not None:
            kind = msg.get("type")
            m.inc(f"wire.frames.{kind}")
            m.inc(f"wire.bytes_sent.{kind}", len(payload))

    # the codec capability: the router sends binary hot frames only to
    # peers that advertise at least this version
    reply({"type": "hello", "token": token, "worker": worker_id, "pid": os.getpid(),
           "codec": 1})

    devices = _worker_devices(worker_id, int(spec.get("n_workers", 1)), spec.get("replicas"),
                              None if spec.get("virtual_devices") else spec.get("device"))
    fitted = resolve_model(spec["model"], devices[0])
    # the router's datum contract against the model's static check: a
    # mis-deployed model fails the boot with a node-attributed error
    fitted.check(span=False).require_contract(spec.get("datum_shape"), spec.get("dtype"),
                                              verb="boot")
    fault_exit = threading.Event()

    def _on_device_fault(error: BaseException) -> None:
        # every admitted request is answered by now: close the connection,
        # so the router respawns this slot and requeues the rest
        logger.error("worker %d: device fault (%r) — exiting for a fresh CUDA context",
                     worker_id, error)
        fault_exit.set()
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    fleet = ServingFleet(
        fitted,
        devices=devices,
        buckets=tuple(spec.get("buckets") or (1, 8, 32, 64)),
        datum_shape=spec.get("datum_shape"),
        dtype=spec.get("dtype"),
        max_queue=int(spec.get("max_queue", 1024)),
        max_wait_ms=float(spec.get("max_wait_ms", 2.0)),
        tenant_weights=spec.get("tenant_weights"),
        on_device_fault=_on_device_fault,
    )
    fleet.start(warmup=spec.get("warmup"))
    metrics_ref[0] = fleet.metrics
    snap = fleet.metrics.snapshot()
    reply({
        "type": "ready",
        "worker": worker_id,
        "compiles": snap["counters"].get("compiles", 0),
        "aot_loads": snap["counters"].get("aot_loads", 0),
        "capacity": fleet.n_replicas * fleet.policy.max_size,
        "replicas": fleet.n_replicas,
        "devices": [str(d) for d in devices],
        # the shm negotiation's answer: both rings attached
        "shm": shm_rx is not None,
    })
    logger.info("worker %d ready: %d replica(s) on %s (compiles=%d aot_loads=%d)",
                worker_id, fleet.n_replicas, [str(d) for d in devices],
                snap["counters"].get("compiles", 0), snap["counters"].get("aot_loads", 0))

    stopping = threading.Event()

    def _drain_and_exit(signum, frame):
        # run on a thread of its own, never in the handler's frame: the
        # signal may land inside fleet.submit holding the scheduler's lock,
        # which shutdown() takes too
        if stopping.is_set():
            return
        stopping.set()

        def _stop():
            try:
                fleet.shutdown(drain=True)
            finally:
                os._exit(0)

        threading.Thread(target=_stop, name="ks-worker-sigterm", daemon=False).start()

    try:
        signal.signal(signal.SIGTERM, _drain_and_exit)
    except ValueError:
        pass  # not the main thread (embedded use): the router's stop still works

    class _ReplyGroup:
        """One request frame's answers: members settle out of order on
        replica threads, one reply frame goes back when the last lands, and
        only then are the request frame's shm slots freed (reply receipt is
        the ring's reclamation signal)."""

        def __init__(self, n: int, legacy: bool, req_shm_slots):
            self._lock = threading.Lock()
            self._remaining = n
            self.members: list = [None] * n
            self.legacy = legacy
            self.req_shm_slots = tuple(req_shm_slots or ())
            #: the first traced member's id: the reply's wire.encode span
            #: hangs off it
            self.traced_id: Optional[str] = None

        def settle(self, pos: int, member: dict) -> None:
            with self._lock:
                self.members[pos] = member
                self._remaining -= 1
                done = self._remaining == 0
            if done:
                _send_res(self)

    def _send_res(group: "_ReplyGroup") -> None:
        # t_unix prices the reply hop's transport (unix clocks are shared
        # on a host; monotonic ones are not)
        t_unix = time.time()
        t0 = t1 = 0.0
        try:
            if group.legacy:
                # a single-request frame gets the single-request reply
                msg = dict(group.members[0])
                msg["type"] = "res"
                msg["t_unix"] = t_unix
                payload = encode_msg(msg)
            else:
                t0 = time.perf_counter()
                payload = encode_msg({"type": "res", "members": group.members, "t_unix": t_unix},
                                     codec=reply_codec, shm=shm_tx, min_shm_bytes=shm_min_bytes,
                                     metrics=fleet.metrics)
                t1 = time.perf_counter()
            with send_lock:
                send_payload(sock, payload)
            fleet.metrics.inc("wire.frames.res")
            fleet.metrics.inc("wire.bytes_sent.res", len(payload))
            if group.traced_id is not None and tracer is not None and not group.legacy:
                tracer.record_complete(Span(
                    name="wire.encode", start=t0, end=t1, op_type="ClusterWorker",
                    attrs={"trace_id": group.traced_id, "codec": reply_codec,
                           "bytes": len(payload), "members": len(group.members)}))
        except Exception:
            # the router is gone; its down-handler requeues
            logger.debug("reply frame undeliverable (router gone?)", exc_info=True)
        finally:
            if shm_rx is not None:
                for s in group.req_shm_slots:
                    shm_rx.free(s)

    def _member_done(pos: int, req_id: int, fut, group, ctx=None, t_recv_pc=None,
                     transport_s=None) -> None:
        try:
            member = {"id": req_id, "ok": True, "value": fut.result()}
        except BaseException as e:  # noqa: BLE001 — typed over the wire
            member = {"id": req_id, "ok": False, "error": encode_error(e)}
        group.settle(pos, member)
        if ctx is not None and tracer is not None:
            # the worker-residency hop: wire arrival to reply settled, under
            # the request's identity, with the inbound transport it measured
            tracer.record_complete(Span(
                name="cluster.handle", start=t_recv_pc, end=time.perf_counter(),
                op_type="ClusterWorker",
                attrs={"trace_id": ctx.trace_id, "parent_hop": ctx.hop, "worker": worker_id,
                       "transport_s": round(transport_s or 0.0, 6)}))

    rc = 0
    try:
        while True:
            payload = recv_payload(sock)
            t_dec0 = time.perf_counter()
            # copy=False: a datum may view an shm slot; the fleet consumes
            # it before its reply frees the slot
            msg = decode_payload(payload, shm=shm_rx, copy=False)
            t_recv_pc = time.perf_counter()
            kind = msg.get("type")
            if kind == "req":
                members = msg.get("members")
                legacy = members is None
                if legacy:
                    members = [msg]  # a single-request frame
                group = _ReplyGroup(len(members), legacy, msg.get("_shm_slots"))
                for pos, m in enumerate(members):
                    req_id = m["id"]
                    deadline = deadline_from_wire(m.get("deadline_rem"))
                    ctx = TraceContext.from_wire(m.get("trace"))
                    transport_s = ctx.transport_seconds() if ctx is not None else None
                    if ctx is not None and group.traced_id is None:
                        group.traced_id = ctx.trace_id
                    try:
                        timeout = (None if deadline is None
                                   else max(0.0, deadline - time.monotonic()))
                        priority, tenant = qos_from_wire(m)
                        # each member keeps its own QoS, deadline and trace
                        # identity: coalescing shares the frame only
                        fut = fleet.submit(m["datum"], timeout=timeout, trace=ctx,
                                           priority=priority, tenant=tenant)
                    except BaseException as e:  # Shed / QueueFull typed back
                        group.settle(pos, {"id": req_id, "ok": False,
                                           "error": encode_error(e)})
                        continue
                    fut.add_done_callback(
                        lambda f, p=pos, rid=req_id, g=group, c=ctx, t=t_recv_pc,
                        tr=transport_s: _member_done(p, rid, f, g, ctx=c, t_recv_pc=t,
                                                     transport_s=tr))
                if group.traced_id is not None and tracer is not None:
                    tracer.record_complete(Span(
                        name="wire.decode", start=t_dec0, end=t_recv_pc,
                        op_type="ClusterWorker",
                        attrs={"trace_id": group.traced_id,
                               "codec": "pickle" if payload[:1] == b"\x80" else "binary",
                               "bytes": len(payload), "members": len(members)}))
            elif kind == "ping":
                # the health cadence doubles as the timeline sampler
                fleet.metrics.sample_timeline()
                pong = {"type": "pong", "t": msg.get("t"),
                        "service_estimate": fleet.scheduler.service_estimate}
                # per-tenant cost deltas since the last pong
                wired = costs_to_wire(_cost_deltas(cost_cursor, fleet.metrics.cost_table()))
                if wired:
                    pong["costs"] = wired
                reply(pong)
            elif kind == "stats":
                fleet.metrics.sample_timeline()
                shipped = []
                spans_dropped = 0
                if tracer is not None:
                    fresh, span_cursor[0] = tracer.spans_since(span_cursor[0])
                    # a stats reply stays a small frame: overflow is dropped
                    # and counted
                    spans_dropped = max(0, len(fresh) - 4096)
                    if spans_dropped:
                        _flight.record_instant("trace.spans_dropped", n=spans_dropped,
                                               worker=worker_id)
                    shipped = wire_spans(fresh[-4096:], tracer.epoch, tracer.epoch_unix,
                                         process_name=process_name)
                    # the router owns these spans now
                    tracer.discard_through(span_cursor[0])
                reply({"type": "stats", "worker": worker_id, "seq": msg.get("seq"),
                       "snapshot": fleet.metrics.snapshot(sketches=True),
                       "qos": fleet.qos_snapshot(), "spans": shipped,
                       "spans_dropped": spans_dropped})
            elif kind == "stop":
                fleet.shutdown(drain=bool(msg.get("drain", True)))
                reply({"type": "bye", "worker": worker_id})
                break
            else:
                logger.warning("worker %d: unknown message %r", worker_id, kind)
    except ConnectionClosed:
        if fault_exit.is_set():
            rc = DEVICE_FAULT_EXIT
        elif not stopping.is_set():
            logger.warning("worker %d: router connection lost — shutting down", worker_id)
            rc = 1
    finally:
        try:
            fleet.shutdown(drain=False)
        except Exception:
            if not fault_exit.is_set():  # a device fault re-raises here, by design
                logger.exception("worker %d: fleet shutdown failed", worker_id)
        try:
            sock.close()
        except OSError:
            pass
        # the router owns unlink; a worker only drops its mappings
        for ring in (shm_rx, shm_tx):
            if ring is not None:
                ring.close()
    return rc


def main(argv=None) -> int:
    """``python -m keystone_tpu_torch.cluster.worker host port token
    worker_id`` with the boot spec pickled on stdin."""
    import pickle

    host, port, token, worker_id = argv or sys.argv[1:5]
    spec = pickle.load(sys.stdin.buffer)  # the parent router's boot spec
    return worker_main(host, int(port), token, int(worker_id), spec)


if __name__ == "__main__":
    raise SystemExit(main())
