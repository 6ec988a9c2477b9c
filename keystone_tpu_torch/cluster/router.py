"""The cluster front door: admission control and load balancing over
worker processes (port of ``keystone_tpu/cluster/router.py``).

``ClusterRouter`` lifts the ServingFleet's disciplines one level up: the
fleet schedules replica threads in one process, the router schedules
worker processes (``cluster/worker.py``), each running a fleet of its own:

* **Admission and deadline shedding at the front door.** The learned
  batch-service EWMA of the fleet scheduler
  (:class:`~keystone_tpu_torch.serving.scheduler.ServiceEstimate`), priced
  from the aggregate queue depth over the fleet-wide capacity: a request
  whose deadline cannot be met is refused with
  :class:`~keystone_tpu_torch.serving.errors.Shed` before it crosses a
  process boundary. Evidence comes from worker pongs and the
  ``observe_service`` seam; a cold router never sheds.
* **Load balancing.** Least-outstanding placement over live workers;
  compatible admitted requests coalesce into one member-list frame
  (:meth:`ServiceEstimate.coalesce_window` prices the hold).
* **Supervision.** A worker whose socket drops (killed, crashed, wedged,
  or ended by a device fault) has its unanswered requests requeued to live
  peers with their deadlines (one that can no longer make it is answered
  with ``Shed``; at most ``MAX_REQUEUE_HOPS`` hops) and is respawned within
  its slot's ``max_restarts``; ``restarts`` and ``requeues`` are counted,
  ``fault.worker_down`` / ``fault.worker_restart`` recorded, and the flight
  ring dumped (``worker_down``).
* **Warm boots.** Workers share one AOT cache directory and its manifest;
  each ``ready`` reports the traces and loads it paid
  (:attr:`worker_reports`).
* **Merged observability.** ``snapshot()`` folds every worker's snapshot
  (with its raw quantile sketches) through :meth:`MetricsRegistry.merge`;
  ``status()`` / :func:`format_status` give the operator's view;
  ``collect_trace`` / ``export_trace`` stitch the processes' spans into one
  trace; ``metrics_port`` serves the merged snapshot as Prometheus text
  (``obs/prom.py``).
* **Bounded, signal-safe shutdown.** ``shutdown`` (and the SIGTERM handler
  of ``install_signal_handlers``) drains with a time limit, stops workers
  with join limits, terminates a wedged one and answers every admitted
  request typed.
* **QoS and autoscaling.** ``submit`` takes ``priority`` / ``tenant``
  (``autoscale/qos.py``); with ``autoscale=ScalePolicy`` an
  :class:`~keystone_tpu_torch.autoscale.Autoscaler` rides the health loop,
  and the router is its actuator (``scale_view`` / ``scale_up_slot`` /
  ``pick_drain_candidate`` / ``begin_drain`` / ``reap_slot``).

Workers start as fresh interpreters (``python -m
keystone_tpu_torch.cluster.worker``, the spec pickled on stdin), never as
forks of a process that holds a CUDA context. ``device`` decides where
they serve: the card unless the caller names the CPU. On one card every
worker lands on ``cuda:0`` in a CUDA context of its own, and the card
time-slices itself between them (no MPS). A fitted model is shipped with
its tensors as host bytes (``worker.model_bytes``) and loaded onto each
worker's device; a ``"module:callable"`` factory is rebuilt in each worker
instead. With ``virtual_devices=N`` each worker provisions N virtual
devices (slots of the CPU, ``parallel/virtual.py``) before its fleet
starts and serves its share of them, as the JAX package's worker does,
whatever ``device`` says.
"""

from __future__ import annotations

import itertools
import logging
import os
import secrets
import signal
import socket
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from ..autoscale import Autoscaler, ScalePolicy
from ..autoscale.qos import (
    DEFAULT_TENANT,
    PRIORITIES,
    SHED_BIAS,
    normalize_priority,
)
from ..faults import WORKER_SPAWN, fault_point
from ..obs import flight as _flight
from ..obs.context import Sampler, TraceContext, new_trace_id
from ..obs.span import Span
from ..obs.tracer import current as _trace_current
from ..serving.errors import EngineStopped, QueueFull, Shed
from ..serving.metrics import MetricsRegistry
from ..serving.scheduler import ServiceEstimate
from ..serving.replica import settle_future
from ..serving.slo import SloPolicy, SloWatchdog
from ..utils import (
    env_flag as _env_flag,
    env_int as _env_int,
    env_str as _env_str,
)
from . import shm as shm_mod
from . import wire as wire_mod
from .wire import (
    ConnectionClosed,
    costs_from_wire,
    deadline_to_wire,
    decode_error,
    qos_to_wire,
    recv_msg,
)

logger = logging.getLogger(__name__)

_SPAWN_TIMEOUT_S = 180.0
_JOIN_TIMEOUT_S = 10.0
_DRAIN_TIMEOUT_S = 60.0


def default_workers() -> int:
    """Worker-process count: ``KEYSTONE_WORKERS``, default 2 (the
    smallest fleet that is actually a fleet)."""
    return _env_int("KEYSTONE_WORKERS", 2)


#: numbers the routers of this process, so their shm segments never share
#: a name (the JAX package names them by pid alone, so two routers in one
#: process collide on their first rings)
_ROUTER_IDS = itertools.count()


def ring_base(pid: int, router: int, index: int, generation: int) -> str:
    """The shared-memory name prefix of one incarnation of a worker slot:
    the process, the router within it, the slot and its spawn generation,
    so a respawn gets fresh segments and no two routers on a host
    collide."""
    return f"ks{pid:x}r{router}w{index}g{generation}"


@dataclass
class _PendingReq:
    datum: Any
    deadline: Optional[float]  # router-clock monotonic, or None
    enqueued: float
    future: Future = field(default_factory=Future)
    hops: int = 0
    #: cross-process trace identity for a sampled request (None when
    #: tracing is off or the request lost the sampling draw)
    trace: Optional[TraceContext] = None
    #: perf_counter at admission — the rpc.request span's start
    t_submit_pc: float = 0.0
    #: QoS identity (autoscale/qos.py) — preserved across requeues and
    #: shipped on the wire so the worker fleet re-applies the same class
    priority: str = "normal"
    tenant: str = DEFAULT_TENANT


class _WorkerSlot:
    """Router-side state for one worker process slot (the slot survives
    respawns; the process and socket are replaced)."""

    def __init__(self, index: int):
        self.index = index
        self.proc = None
        self.sock: Optional[socket.socket] = None
        self.send_lock = threading.Lock()
        self.alive = False
        self.capacity = 0
        self.restarts = 0
        #: a respawn is scheduled/booting: requests may PARK awaiting it
        #: (set by the down-handler, cleared on ready or failed respawn)
        self.respawning = False
        #: the process whose death the respawn replaces: until the new one
        #: is spawned ``proc`` is still it, which the failed-respawn reaper
        #: must not take for a respawn that died booting
        self.down_proc = None
        #: autoscale lifecycle: a spawned-but-not-ready scale-up slot
        #: (booting), a slot no longer admitting while its outstanding
        #: work finishes (draining), and a slot given back (retired —
        #: terminal until the scaler re-arms it for a later scale-up)
        self.booting = False
        self.draining = False
        self.retired = False
        self.outstanding: set = set()
        self.depth = 0  # worker-reported local queue depth (pongs)
        self.ready_report: Optional[dict] = None
        self.last_snapshot: Optional[dict] = None
        #: stats request/reply matching: a stats reply only lands if it
        #: echoes the CURRENT sequence — a late reply from a previous
        #: cycle (wedged worker) can neither satisfy this cycle's wait
        #: nor masquerade stale counters as fresh
        self.stats_seq = 0
        self.stats_event = threading.Event()
        self.recv_thread: Optional[threading.Thread] = None
        #: negotiated per connection: binary hot frames only when the
        #: router wants them AND the worker's hello advertised the codec
        #: (an old peer keeps pickle — version skew degrades, not breaks)
        self.codec_binary = False
        #: same-host zero-copy rings (router→worker tx, worker→router
        #: rx), generation-named so a respawn gets fresh segments
        self.shm_tx = None
        self.shm_rx = None
        self.shm_gen = 0
        #: worker spans accumulated off stats replies (each worker ships
        #: its fresh spans exactly once, cursor-tracked worker-side) —
        #: what export_trace stitches into cross-process tracks. Kept
        #: across respawns: a dead worker's spans are the evidence.
        self.trace_spans: List[dict] = []


class ClusterRouter:
    """Front-door router over worker processes. ``model`` is either a
    :class:`~keystone_tpu_torch.workflow.pipeline.FittedPipeline` (shipped to
    the workers) or a ``"module:callable"`` factory string (each worker
    rebuilds deterministically — the warm-boot-friendly spelling),
    optionally ``(path, kwargs)``."""

    MAX_REQUEUE_HOPS = 3

    def __init__(
        self,
        model: Any,
        *,
        workers: Optional[int] = None,
        device: Any = None,
        replicas_per_worker: Optional[int] = None,
        buckets: Sequence[int] = (1, 8, 32, 64),
        datum_shape: Optional[Sequence[int]] = None,
        dtype: Any = None,
        max_queue: int = 4096,
        worker_max_queue: int = 1024,
        max_wait_ms: float = 2.0,
        aot_cache: Optional[str] = None,
        warmup: Optional[bool] = None,
        metrics: Optional[MetricsRegistry] = None,
        max_restarts: int = 2,
        spawn_timeout_s: float = _SPAWN_TIMEOUT_S,
        join_timeout_s: float = _JOIN_TIMEOUT_S,
        drain_timeout_s: float = _DRAIN_TIMEOUT_S,
        health_interval_s: float = 2.0,
        log_interval_s: float = 10.0,
        virtual_devices: Optional[int] = None,
        log_level: Optional[str] = None,
        slo: Optional[SloPolicy] = None,
        trace_sample: Optional[float] = None,
        autoscale: Optional[ScalePolicy] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        metrics_port: Optional[int] = None,
        wire_codec: Optional[str] = None,
        wire_shm: Optional[bool] = None,
        coalesce: Optional[bool] = None,
    ):
        self._n = workers if workers is not None else default_workers()
        if self._n < 1:
            raise ValueError(f"need at least one worker, got {self._n}")
        self._model_spec = self._resolve_model_spec(model)
        self._spec = {
            "model": self._model_spec,
            "n_workers": self._n,
            "replicas": replicas_per_worker,
            "buckets": tuple(buckets),
            "datum_shape": (
                tuple(datum_shape) if datum_shape is not None else None
            ),
            "dtype": str(dtype) if dtype is not None else None,
            "max_queue": int(worker_max_queue),
            "max_wait_ms": float(max_wait_ms),
            "aot_cache": aot_cache,
            "warmup": warmup,
            "virtual_devices": virtual_devices,
            "log_level": log_level,
            "tenant_weights": (
                dict(tenant_weights) if tenant_weights else None
            ),
            # where workers serve: None is the card, which a worker that
            # cannot reach fails its boot on; "cpu" only when asked
            "device": str(device) if device is not None else None,
        }
        # hot-wire negotiation knobs: the codec the router WANTS (the
        # worker's hello must still advertise it — version skew keeps
        # pickle), whether same-host shm rings are offered, and whether
        # the front door coalesces compatible requests into one frame.
        # KEYSTONE_WIRE_CODEC=pickle is the kill switch for all three
        # hot-path layers at once (shm and member framing only ride the
        # binary codec).
        codec = (
            wire_codec if wire_codec is not None
            else _env_str("KEYSTONE_WIRE_CODEC", "binary")
        )
        self._codec = (
            "pickle" if str(codec).lower() == "pickle" else "binary"
        )
        self._spec["wire"] = {"codec": self._codec}
        self._shm_enabled = self._codec == "binary" and (
            wire_shm if wire_shm is not None
            else _env_flag("KEYSTONE_WIRE_SHM", True)
        )
        self._shm_slots = _env_int("KEYSTONE_SHM_SLOTS", 8, minimum=1)
        self._shm_slot_bytes = _env_int(
            "KEYSTONE_SHM_SLOT_BYTES", 1 << 20, minimum=1024
        )
        self._shm_min_bytes = _env_int(
            "KEYSTONE_SHM_MIN_BYTES", 1 << 16, minimum=1
        )
        self._coalesce = (
            coalesce if coalesce is not None
            else _env_flag("KEYSTONE_COALESCE", True)
        )
        #: members per coalesced frame: the largest bucket (one full
        #: worker batch) unless KEYSTONE_COALESCE_MAX overrides
        cap = _env_int("KEYSTONE_COALESCE_MAX", 0, minimum=0)
        self._coalesce_cap = cap or max(
            int(b) for b in (tuple(buckets) or (1,))
        )
        #: the operator ceiling on the coalesce hold (the same knob the
        #: worker scheduler's batch window uses), in seconds
        self._max_coalesce_wait_s = float(max_wait_ms) / 1e3
        self._metrics = metrics or MetricsRegistry(name="cluster-router")
        self._max_queue = int(max_queue)
        self._max_restarts = int(max_restarts)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._join_timeout_s = float(join_timeout_s)
        self._drain_timeout_s = float(drain_timeout_s)
        self._health_interval_s = float(health_interval_s)
        self._log_interval_s = float(log_interval_s)
        self._service = ServiceEstimate()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._slots = [_WorkerSlot(i) for i in range(self._n)]
        self._pending: Dict[int, _PendingReq] = {}
        self._parked: List[_PendingReq] = []
        #: admitted, not yet placed: the coalescer's intake (admission
        #: already priced these — the dispatch thread only groups and
        #: sends, it never re-admits)
        self._coalesce_q: deque = deque()
        self._dispatch_thread: Optional[threading.Thread] = None
        self._req_ids = itertools.count()
        self._router_id = next(_ROUTER_IDS)
        self._token = secrets.token_hex(16)
        self._listener: Optional[socket.socket] = None
        self._port: Optional[int] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None
        self._started = False
        self._closed = False
        self._prev_sigterm = None
        self._metrics.set_gauge("queue_depth", lambda: self.outstanding)
        #: per-request trace sampling (KEYSTONE_TRACE_SAMPLE unless the
        #: trace_sample arg overrides); drawn under the admission lock
        self._sampler = Sampler(trace_sample)
        self._trace_seq = itertools.count()
        #: the SLO watchdog rides the health loop's cadence; without a
        #: policy the loop still samples the metrics timeline
        self._watchdog = (
            SloWatchdog(self._metrics, slo, source="cluster-router")
            if slo is not None else None
        )
        #: the breach-driven scaler rides the health loop; the router is
        #: its actuator (scale_view / scale_up_slot / begin_drain / ...)
        self._autoscaler = (
            Autoscaler(autoscale, self, metrics=self._metrics)
            if autoscale is not None else None
        )
        #: the router's own spans, moved out of the process tracer into
        #: this bounded buffer at each collect_trace (mirrors the
        #: per-slot worker buffers) — a long-lived traced router that
        #: exports periodically stays bounded instead of holding every
        #: sampled request's spans for its whole uptime
        self._own_trace_spans: List[dict] = []
        self._own_span_cursor = 0
        self._own_trace_lock = threading.Lock()
        #: Prometheus scrape plane: metrics_port= wins, else
        #: KEYSTONE_METRICS_PORT; 0 binds an ephemeral port, unset (or a
        #: negative env value) disables the endpoint entirely
        if metrics_port is None:
            env_port = _env_int("KEYSTONE_METRICS_PORT", -1, minimum=-1)
            metrics_port = env_port if env_port >= 0 else None
        self._metrics_port = metrics_port
        self._exporter = None

    @staticmethod
    def _resolve_model_spec(model) -> tuple:
        if isinstance(model, tuple) and model and model[0] in (
            "factory", "pickle"
        ):
            return model
        if isinstance(model, str):
            return ("factory", model, {})
        from ..workflow.pipeline import FittedPipeline

        if isinstance(model, FittedPipeline):
            from .worker import model_bytes

            try:
                # the tensors as host bytes, loaded onto each worker's
                # device there (never onto the index they came from)
                return ("pickle", model_bytes(model))
            except Exception as e:
                raise ValueError(
                    "this FittedPipeline cannot be pickled to worker "
                    "processes — pass a 'module:callable' factory string "
                    f"that rebuilds it instead ({e})"
                ) from e
        raise TypeError(
            f"model must be a FittedPipeline, 'module:callable' string, "
            f"or ('factory'|'pickle', ...) tuple — got {type(model).__name__}"
        )

    # -- introspection ---------------------------------------------------

    @property
    def metrics(self) -> MetricsRegistry:
        return self._metrics

    @property
    def n_workers(self) -> int:
        return self._n

    @property
    def outstanding(self) -> int:
        """Requests admitted and not yet answered — the aggregate queue
        depth the shed pricing divides by fleet capacity."""
        with self._lock:
            return (
                len(self._pending) + len(self._parked)
                + len(self._coalesce_q)
            )

    @property
    def capacity(self) -> int:
        """Fleet-wide concurrent batch capacity (admitting workers only
        — a draining slot finishes its outstanding work but takes no
        more, so it no longer backs the shed pricing)."""
        with self._lock:
            return sum(
                s.capacity for s in self._slots
                if s.alive and not s.draining
            )

    @property
    def autoscaler(self) -> Optional[Autoscaler]:
        """The riding scaler, None without an ``autoscale`` policy."""
        return self._autoscaler

    @property
    def metrics_address(self) -> Optional[tuple]:
        """``(host, port)`` of the Prometheus scrape endpoint, None when
        the export plane is disabled (no ``metrics_port`` and no
        ``KEYSTONE_METRICS_PORT``)."""
        exporter = self._exporter
        return exporter.address if exporter is not None else None

    @property
    def live_workers(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s.alive)

    @property
    def worker_reports(self) -> List[Optional[dict]]:
        """Each slot's latest ``ready`` report (compiles/aot_loads paid
        at boot, replica count, devices) — the warm-boot evidence."""
        with self._lock:
            return [
                dict(s.ready_report) if s.ready_report else None
                for s in self._slots
            ]

    @property
    def worker_pids(self) -> List[Optional[int]]:
        with self._lock:
            return [
                s.proc.pid if s.proc is not None else None
                for s in self._slots
            ]

    def observe_service(self, seconds: float) -> None:
        """Seed/fold one batch-service observation (the test/bench seam,
        same name as the fleet scheduler's)."""
        with self._lock:
            self._service.observe(seconds)

    @property
    def service_estimate(self) -> Optional[float]:
        return self._service.estimate

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ClusterRouter":
        with self._lock:
            if self._started:
                raise RuntimeError("router already started")
            if self._closed:
                raise EngineStopped("router was shut down")
            self._started = True
            # tracing propagates at boot: a traced router asks its
            # workers to install tracers too, so their spans ship back
            # and stitch (decided here, not __init__, because configure/
            # --trace may install the tracer between construct and start)
            self._spec["trace"] = _trace_current() is not None
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(self._n + 4)
        self._listener.settimeout(0.5)
        self._port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="ks-router-accept", daemon=True
        )
        self._accept_thread.start()
        for slot in self._slots:
            self._spawn_worker(slot)
        deadline = time.monotonic() + self._spawn_timeout_s
        with self._cond:
            while not all(s.alive for s in self._slots):
                if self._closed:
                    raise EngineStopped("router shut down during start")
                dead = [
                    s.index for s in self._slots
                    if s.proc is not None and not s.alive
                    and s.proc.poll() is not None
                ]
                if dead:
                    break
                if not self._cond.wait(timeout=0.2):
                    if time.monotonic() >= deadline:
                        break
        missing = [s.index for s in self._slots if not s.alive]
        if missing:
            self.shutdown(drain=False)
            raise RuntimeError(
                f"cluster workers {missing} failed to boot within "
                f"{self._spawn_timeout_s:.0f}s — check worker stderr "
                "(spawned processes inherit this process's streams)"
            )
        self._health_thread = threading.Thread(
            target=self._health_loop, name="ks-router-health", daemon=True
        )
        self._health_thread.start()
        if self._coalesce:
            self._dispatch_thread = threading.Thread(
                target=self._dispatch_loop,
                name="ks-router-dispatch", daemon=True,
            )
            self._dispatch_thread.start()
        if self._metrics_port is not None:
            # the scrape plane serves the MERGED fleet snapshot the
            # router already computes: a scrape is one stats round-trip,
            # never a touch on the request path
            from ..obs.prom import PrometheusExporter

            self._exporter = PrometheusExporter(
                lambda: self.snapshot(timeout=2.0),
                port=self._metrics_port,
            )
            self._exporter.start()
        logger.info(
            "cluster router up on 127.0.0.1:%d — %d worker(s), "
            "capacity %d", self._port, self._n, self.capacity,
        )
        return self

    def _spawn_worker(self, slot: _WorkerSlot) -> None:
        """Launch one worker as a fresh interpreter running ``python -m
        keystone_tpu_torch.cluster.worker`` (the spec pickled over stdin),
        not a ``multiprocessing`` fork or spawn of this process: a forked
        CUDA context is unusable, and spawn re-executes the parent's
        ``__main__``; a clean exec does neither."""
        import pickle
        import subprocess
        import sys

        fault_point(WORKER_SPAWN, replica=slot.index)
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else pkg_root
        )
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "keystone_tpu_torch.cluster.worker",
                "127.0.0.1", str(self._port), self._token,
                str(slot.index),
            ],
            stdin=subprocess.PIPE,
            env=env,
        )
        # a scaled-up slot's index can exceed the boot-time worker count;
        # device carving (worker_device_indices) needs n_workers to cover
        # it, so the slot ships a widened per-slot spec (co-residency on
        # one device is placement's round-robin job)
        spec = self._spec
        if slot.index >= int(spec.get("n_workers") or 1):
            spec = dict(spec)
            spec["n_workers"] = slot.index + 1
        if self._shm_enabled:
            # fresh generation-named segments per spawn: slots a dead
            # incarnation held can never leak into the new one
            self._release_rings(slot)
            slot.shm_gen += 1
            base = ring_base(os.getpid(), self._router_id, slot.index, slot.shm_gen)
            tx, rx = shm_mod.make_ring_pair(
                base, self._shm_slots, self._shm_slot_bytes
            )
            slot.shm_tx, slot.shm_rx = tx, rx
            if tx is not None:
                spec = dict(spec)
                spec["shm"] = {
                    "c2w": tx.name,
                    "w2c": rx.name,
                    "slots": self._shm_slots,
                    "slot_bytes": self._shm_slot_bytes,
                }
        try:
            proc.stdin.write(
                pickle.dumps(spec, protocol=pickle.HIGHEST_PROTOCOL)
            )
            proc.stdin.close()
        except BrokenPipeError:
            pass  # instant death: start()/down-handler reports it
        slot.proc = proc
        logger.info(
            "cluster: spawned worker %d (pid %s)", slot.index, proc.pid
        )

    def _release_rings(self, slot: _WorkerSlot) -> None:
        """Close + unlink a slot's shm rings (idempotent). Called on
        every death/retire path AND before a respawn's fresh pair — the
        router owns ring lifetime, the worker only attaches."""
        tx, rx = slot.shm_tx, slot.shm_rx
        slot.shm_tx = slot.shm_rx = None
        for ring in (tx, rx):
            if ring is not None:
                ring.close()
                ring.unlink()

    def _accept_loop(self) -> None:
        """Match incoming worker connections (hello + ready, token
        checked) to their slots — runs for the router's life so
        respawned workers re-register through the same door."""
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed: shutdown
            try:
                # short poll interval + an explicit overall deadline:
                # receives ride out socket timeouts by design, so the
                # handshake bounds itself with the deadline instead
                conn.settimeout(1.0)
                handshake_by = time.monotonic() + self._spawn_timeout_s
                hello = recv_msg(conn, deadline=handshake_by)
                if (
                    hello.get("type") != "hello"
                    or hello.get("token") != self._token
                ):
                    raise ConnectionClosed("bad hello")
                ready = recv_msg(conn, deadline=handshake_by)
                if ready.get("type") != "ready":
                    raise ConnectionClosed(
                        f"expected ready, got {ready.get('type')!r}"
                    )
                # steady state: bounded SENDS (a wedged worker's full
                # buffer must not hold the send lock forever); receives
                # ride out timeouts (wire._recv_exact)
                conn.settimeout(wire_mod.SEND_TIMEOUT_S)
            except Exception:
                logger.warning(
                    "cluster: rejected connection during handshake",
                    exc_info=True,
                )
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            self._register_ready(int(hello["worker"]), conn, hello, ready)

    def _register_ready(
        self, index: int, conn, hello: dict, ready: dict
    ) -> None:
        slot = self._slots[index]
        with self._cond:
            if slot.retired:
                # reaped while booting (an aborted scale-up): the process
                # was told to die; refuse the late registration
                try:
                    conn.close()
                except OSError:
                    pass
                return
            slot.sock = conn
            slot.alive = True
            slot.respawning = False
            slot.booting = False
            slot.capacity = int(ready.get("capacity", 1))
            slot.ready_report = dict(ready)
            slot.outstanding = set()
            # codec negotiation: binary only when this router wants it
            # AND the hello advertised it — an old worker that never
            # heard of the codec keeps receiving pickle frames
            try:
                peer_codec = int(hello.get("codec") or 0)
            except (TypeError, ValueError):
                peer_codec = 0
            slot.codec_binary = self._codec == "binary" and peer_codec >= 1
            # shm negotiation closes on the ready report: a worker that
            # could not attach (or predates the rings) answers without
            # shm=true and the router tears the segments down — payloads
            # stay inline, nothing leaks
            if slot.shm_tx is not None and not ready.get("shm"):
                logger.info(
                    "cluster: worker %d did not attach shared-memory "
                    "rings — payloads stay inline", index,
                )
                self._release_rings(slot)
            slot.recv_thread = threading.Thread(
                target=self._recv_loop, args=(slot, conn),
                name=f"ks-router-recv-{index}", daemon=True,
            )
            slot.recv_thread.start()
            parked, self._parked = self._parked, []
            self._cond.notify_all()
        logger.info(
            "cluster: worker %d ready (capacity %d, compiles %s, "
            "aot_loads %s)", index, slot.capacity,
            ready.get("compiles"), ready.get("aot_loads"),
        )
        # flush requests parked while no worker was live
        for req in parked:
            self._route(req, from_requeue=True)

    # -- receive path ----------------------------------------------------

    def _recv_loop(self, slot: _WorkerSlot, conn) -> None:
        try:
            while True:
                payload = wire_mod.recv_payload(conn)
                t_dec0 = time.perf_counter()
                # copy=True: decoded values must survive the shm slot's
                # reclamation (the worker reuses it for the next reply),
                # so anything slot-backed is copied out and freed HERE —
                # user-visible results never alias reusable memory
                msg = wire_mod.decode_payload(
                    payload, shm=slot.shm_rx, copy=True
                )
                t_dec1 = time.perf_counter()
                kind = msg.get("type")
                if kind == "res":
                    members = msg.get("members")
                    if members is None:
                        members = [msg]  # legacy single-request reply
                    t_unix = msg.get("t_unix")
                    traced_id = None
                    for member in members:
                        tid = self._settle_member(slot, member, t_unix)
                        if traced_id is None:
                            traced_id = tid
                    if traced_id is not None:
                        tracer = _trace_current()
                        if tracer is not None:
                            tracer.record_complete(Span(
                                name="wire.decode", start=t_dec0,
                                end=t_dec1, op_type="ClusterRouter",
                                attrs={
                                    "trace_id": traced_id,
                                    "codec": (
                                        "pickle"
                                        if payload[:1] == b"\x80"
                                        else "binary"
                                    ),
                                    "bytes": len(payload),
                                    "members": len(members),
                                },
                            ))
                elif kind == "pong":
                    with self._lock:
                        est = msg.get("service_estimate")
                        if est is not None:
                            self._service.observe(float(est))
                    # fold the worker's cost DELTAS into the router's own
                    # registry: the health-loop timeline (and the SLO
                    # watchdog's per-tenant spend budget) then sees
                    # fleet-wide charges continuously. snapshot() strips
                    # this mirror before merging so worker tables stay
                    # the single authoritative count.
                    for tenant, priority, cost in costs_from_wire(
                        msg.get("costs")
                    ):
                        self._metrics.observe_cost(tenant, priority, **cost)
                elif kind == "stats":
                    if msg.get("spans_dropped"):
                        logger.warning(
                            "cluster: worker %d overflowed its span "
                            "shipping window — %s span(s) lost to the "
                            "stitched trace (collect more often)",
                            slot.index, msg["spans_dropped"],
                        )
                    spans = msg.get("spans")
                    if spans:
                        # accumulate every worker's shipped spans for
                        # stitching (cursor-tracked worker-side, so this
                        # never double-counts); bounded like a ring
                        slot.trace_spans.extend(spans)
                        del slot.trace_spans[:-8192]
                    if msg.get("seq") == slot.stats_seq:
                        slot.last_snapshot = msg.get("snapshot")
                        slot.stats_event.set()
                elif kind == "bye":
                    return
        except ConnectionClosed as e:
            self._on_worker_down(slot, e)
        except Exception:
            logger.exception(
                "cluster: receive loop for worker %d failed", slot.index
            )
            self._on_worker_down(
                slot, ConnectionClosed("receive loop failed")
            )

    def _settle_member(
        self,
        slot: _WorkerSlot,
        msg: dict,
        frame_t_unix: Optional[float] = None,
    ) -> Optional[str]:
        """Settle ONE answered member (coalesced frames carry several;
        legacy replies are a one-member frame). Returns the member's
        trace_id when it was traced — the caller hangs the frame-level
        wire.decode span off the first one."""
        req_id = msg.get("id")
        with self._lock:
            req = self._pending.pop(req_id, None)
            if req is not None:
                slot.outstanding.discard(req_id)
            self._cond.notify_all()
        if req is None:
            return None  # already settled (requeue raced a late answer)
        latency = time.monotonic() - req.enqueued
        ok = bool(msg.get("ok"))
        # the always-on flight ring: every answered request leaves a
        # round-trip summary regardless of sampling, so a worker-death
        # dump shows exactly what the tier was serving when it happened
        _flight.record_span(
            "rpc.request", latency, worker=slot.index, ok=ok,
        )
        if req.trace is not None:
            tracer = _trace_current()
            if tracer is not None:
                end_pc = time.perf_counter()
                reply_unix = msg.get("t_unix", frame_t_unix)
                tracer.record_complete(Span(
                    name="rpc.request",
                    start=req.t_submit_pc,
                    end=end_pc,
                    op_type="ClusterRouter",
                    attrs={
                        "trace_id": req.trace.trace_id,
                        "worker": slot.index,
                        "ok": ok,
                        "hops": req.hops,
                        "reply_transport_s": (
                            round(max(0.0, time.time() - reply_unix), 6)
                            if reply_unix is not None else None
                        ),
                    },
                ))
        if ok:
            if settle_result(req.future, msg.get("value")):
                self._metrics.inc("completed")
                self._metrics.observe_latency(latency, priority=req.priority)
        else:
            exc = decode_error(msg.get("error") or {})
            # a decoded worker-side Shed is NOT counted here: the worker
            # fleet's own registry already counted it, and the merged
            # snapshot sums both registries — the router's 'shed' means
            # front-door sheds (its own refusals), nothing else
            if not isinstance(exc, Shed):
                self._metrics.inc("worker_errors")
            settle_future(req.future, exc)
        return req.trace.trace_id if req.trace is not None else None

    # -- worker failure --------------------------------------------------

    def _on_worker_down(self, slot: _WorkerSlot, exc: Exception) -> None:
        with self._lock:
            if not slot.alive:
                return  # double report (send failure + recv EOF)
            slot.alive = False
            try:
                if slot.sock is not None:
                    slot.sock.close()
            except OSError:
                pass
            slot.sock = None
            # a dead peer's mappings die with it: tear the rings down
            # (a respawn creates a fresh generation pair)
            self._release_rings(slot)
            orphans = [
                self._pending.pop(rid)
                for rid in sorted(slot.outstanding)
                if rid in self._pending
            ]
            slot.outstanding = set()
            # a draining slot's death IS its drain finishing early; a
            # retired slot never comes back by itself — neither respawns
            # (the scaler owns their lifecycle, the restart budget does
            # not)
            if slot.draining or slot.retired:
                slot.draining = False
                slot.retired = True
                will_restart = False
            else:
                will_restart = (
                    not self._closed and slot.restarts < self._max_restarts
                )
            if will_restart:
                slot.restarts += 1
                slot.respawning = True
                slot.down_proc = slot.proc
                self._metrics.inc("restarts")
            self._cond.notify_all()
        if self._closed:
            for req in orphans:
                settle_future(
                    req.future,
                    EngineStopped("router shut down while this request's "
                                  "worker was down"),
                )
            return
        logger.warning(
            "cluster: worker %d down (%s) — rerouting %d in-flight "
            "request(s); restart %s (budget %d/%d used)",
            slot.index, exc, len(orphans),
            "scheduled" if will_restart else "refused",
            slot.restarts, self._max_restarts,
        )
        tracer = _trace_current()
        if tracer is not None:
            tracer.instant(
                "fault.worker_down", op_type="ClusterRouter",
                worker=slot.index, requeued=len(orphans),
                restarting=will_restart,
            )
        # the post-mortem artifact: the kill instant plus the last ring
        # of span summaries — always on, sampling does not apply
        _flight.record_instant(
            "fault.worker_down", worker=slot.index,
            requeued=len(orphans), restarting=will_restart,
            cause=str(exc)[:200],
        )
        _flight.dump("worker_down")
        moved = 0
        for req in orphans:
            if req.future.done():
                continue
            req.hops += 1
            if req.hops > self.MAX_REQUEUE_HOPS:
                settle_future(req.future, exc)
                continue
            if self._route(req, from_requeue=True):
                moved += 1
        if moved:
            self._metrics.inc("requeues", moved)
        if will_restart:
            try:
                self._spawn_worker(slot)
            except Exception:
                logger.exception(
                    "cluster: respawn of worker %d failed", slot.index
                )
                # no new process: the dead one is now the failed respawn,
                # which the reaper retries within the budget or gives up
                with self._lock:
                    slot.down_proc = None
            else:
                _flight.record_instant(
                    "fault.worker_restart", worker=slot.index,
                    attempt=slot.restarts,
                )
                if tracer is not None:
                    tracer.instant(
                        "fault.worker_restart", op_type="ClusterRouter",
                        worker=slot.index, attempt=slot.restarts,
                    )

    # -- admission -------------------------------------------------------

    def submit(
        self,
        datum: Any,
        timeout: Optional[float] = None,
        priority: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> Future:
        """Enqueue one datum; returns a Future of its prediction row.
        Raises typed: :class:`QueueFull` at capacity, :class:`Shed` when
        the learned estimate says the deadline cannot be met given the
        aggregate queue depth ÷ fleet capacity, :class:`EngineStopped`
        after shutdown.

        ``priority`` (``high``/``normal``/``low``) scales the shed
        estimate by its :data:`~keystone_tpu_torch.autoscale.qos.SHED_BIAS` —
        the router cannot see inside worker queues, so the bias is the
        coarse front-door form of the worker scheduler's exact per-rank
        pricing; both orderings shed low strictly before high at equal
        deadline slack. ``tenant`` names the weighted-fair share the
        worker fleet serves the request from. Both ride the wire."""
        now = time.monotonic()
        priority = normalize_priority(priority)
        tenant = str(tenant) if tenant else DEFAULT_TENANT
        with self._lock:
            if self._closed:
                raise EngineStopped("cluster router is shut down")
            if not self._started:
                raise RuntimeError(
                    "submit() needs a started router (call start() or "
                    "use the context manager)"
                )
            depth = (
                len(self._pending) + len(self._parked)
                + len(self._coalesce_q)
            )
            if depth >= self._max_queue:
                self._metrics.inc("rejected")
                raise QueueFull(
                    f"router queue at capacity ({self._max_queue})"
                )
            if timeout is not None:
                cap = sum(
                    s.capacity for s in self._slots
                    if s.alive and not s.draining
                )
                est = self._service.wait(depth, cap) * SHED_BIAS[priority]
                if now + est > now + timeout:
                    self._metrics.inc("shed")
                    self._metrics.inc(f"shed.{priority}")
                    raise Shed(
                        f"deadline unmeetable at the front door: "
                        f"estimated wait {est:.4f}s (at priority "
                        f"{priority!r}) exceeds the request's "
                        f"{timeout:.4f}s budget "
                        f"(depth {depth} / capacity {cap})"
                    )
            req = _PendingReq(
                datum=datum,
                deadline=(now + timeout) if timeout is not None else None,
                enqueued=now,
                t_submit_pc=time.perf_counter(),
                priority=priority,
                tenant=tenant,
            )
            self._metrics.inc("submitted")
            # the sampling draw happens under the admission lock (the
            # sampler is a plain counter); an unsampled request pays
            # exactly this one modulo check
            if self._sampler.admit() and _trace_current() is not None:
                req.trace = TraceContext(
                    trace_id=new_trace_id(next(self._trace_seq)),
                    hop="rpc.request",
                )
            if self._coalesce:
                # hand off to the coalescer: compatible neighbors already
                # waiting (or arriving within the priced window) share
                # one wire frame. Admission is done — the dispatch thread
                # only groups and places.
                self._coalesce_q.append(req)
                self._cond.notify_all()
                return req.future
        self._route(req)
        return req.future

    def predict(self, datum: Any, timeout: Optional[float] = None) -> Any:
        return self.submit(datum, timeout=timeout).result()

    def _route(self, req: _PendingReq, from_requeue: bool = False) -> bool:
        """Single-request dispatch (requeues, parked flushes, and the
        ``coalesce=False`` spelling) — one member, no coalesce wait."""
        return self._dispatch([req], from_requeue=from_requeue)

    @staticmethod
    def _compat_key(req: _PendingReq) -> tuple:
        """Requests that may share a wire frame: same priority class and
        the same bucket signature (shape + dtype — what the worker's
        bucket ladder pads against). The model digest needs no key
        component: one router serves one model."""
        d = req.datum
        return (
            req.priority,
            tuple(getattr(d, "shape", ()) or ()),
            str(getattr(d, "dtype", type(d).__name__)),
        )

    def _drain_compatible(self, batch: list, key: tuple, cap: int) -> None:
        """Move every queued compatible request into ``batch`` (up to
        ``cap``), preserving queue order for the rest. Lock held."""
        if len(batch) >= cap or not self._coalesce_q:
            return
        kept: deque = deque()
        while self._coalesce_q and len(batch) < cap:
            r = self._coalesce_q.popleft()
            if self._compat_key(r) == key:
                batch.append(r)
            else:
                kept.append(r)
        kept.extend(self._coalesce_q)
        self._coalesce_q = kept

    def _dispatch_loop(self) -> None:
        """The coalescer: pop the queue head, drain everything
        compatible, and — only for a PARTIAL batch with nothing else
        waiting — hold the frame open for the priced window
        (:meth:`ServiceEstimate.coalesce_window`: a fraction of one
        learned batch-service time, capped by the operator's max-wait
        and the tightest member deadline; zero while cold). A lone
        request with an empty queue dispatches immediately, and any
        incompatible arrival closes the window early — coalescing never
        buys head-of-line blocking."""
        while True:
            with self._cond:
                while not self._coalesce_q and not self._closed:
                    self._cond.wait(timeout=0.5)
                if self._closed:
                    return  # shutdown flushed/swept the queue
                batch = [self._coalesce_q.popleft()]
                key = self._compat_key(batch[0])
                cap = self._coalesce_cap
                self._drain_compatible(batch, key, cap)
                if 1 < len(batch) < cap and not self._coalesce_q:
                    now = time.monotonic()
                    tightest = min(
                        (
                            r.deadline for r in batch
                            if r.deadline is not None
                        ),
                        default=None,
                    )
                    until = now + self._service.coalesce_window(
                        now, tightest, cap=self._max_coalesce_wait_s
                    )
                    while len(batch) < cap and not self._closed:
                        remaining = until - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                        self._drain_compatible(batch, key, cap)
                        if self._coalesce_q:
                            break  # other traffic waits for no window
            self._dispatch(batch)

    def _dispatch(
        self,
        reqs: List[_PendingReq],
        from_requeue: bool = False,
        during_shutdown: bool = False,
    ) -> bool:
        """Place a compatible group on the least-outstanding live worker
        and send it as ONE wire frame; every member keeps its own
        pending entry (and so its own identity through requeues — a
        worker death mid-frame re-places members individually). Returns
        True when the group was handed to a worker (or parked); settles
        futures typed otherwise."""
        reqs = [r for r in reqs if not r.future.done()]
        if not reqs:
            return True
        while True:
            with self._lock:
                if self._closed and not during_shutdown:
                    for r in reqs:
                        settle_future(
                            r.future,
                            EngineStopped(
                                "router shut down before dispatch"
                            ),
                        )
                    return False
                if from_requeue:
                    survivors = []
                    for r in reqs:
                        if r.deadline is None:
                            survivors.append(r)
                            continue
                        cap = sum(
                            s.capacity for s in self._slots
                            if s.alive and not s.draining
                        )
                        est = (
                            self._service.wait(len(self._pending), cap)
                            * SHED_BIAS[r.priority]
                        )
                        if time.monotonic() + est > r.deadline:
                            self._metrics.inc("shed")
                            self._metrics.inc(f"shed.{r.priority}")
                            settle_future(
                                r.future,
                                Shed(
                                    "deadline unmeetable after worker "
                                    f"failure: estimated wait {est:.4f}s "
                                    "exceeds the remaining budget"
                                ),
                            )
                            continue
                        survivors.append(r)
                    reqs = survivors
                    if not reqs:
                        return False
                live = [
                    s for s in self._slots if s.alive and not s.draining
                ]
                if not live:
                    if any(
                        s.respawning or s.booting for s in self._slots
                    ):
                        self._parked.extend(reqs)
                        return True
                    for r in reqs:
                        settle_future(
                            r.future,
                            EngineStopped(
                                "no live workers (restart budget "
                                "exhausted)"
                            ),
                        )
                    return False
                slot = min(live, key=lambda s: len(s.outstanding))
                ids = []
                for r in reqs:
                    rid = next(self._req_ids)
                    self._pending[rid] = r
                    slot.outstanding.add(rid)
                    ids.append(rid)
            try:
                members = []
                for rid, r in zip(ids, reqs):
                    members.append({
                        "id": rid,
                        "datum": r.datum,
                        "deadline_rem": deadline_to_wire(r.deadline),
                        **qos_to_wire(r.priority, r.tenant),
                    })
                traced = [r for r in reqs if r.trace is not None]
                tracer = _trace_current() if traced else None
                # the stamp necessarily precedes encoding (it rides the
                # frame), so the receiver's transport_s INCLUDES
                # serialize + send — consumers summing hops must use
                # transport_s OR the rpc.send span, never both
                t_send_pc = time.perf_counter()
                for m, r in zip(members, reqs):
                    if r.trace is not None:
                        m["trace"] = r.trace.to_wire()
                payload = wire_mod.encode_msg(
                    {"type": "req", "members": members},
                    codec=(
                        "binary" if slot.codec_binary else "pickle"
                    ),
                    shm=slot.shm_tx,
                    min_shm_bytes=self._shm_min_bytes,
                    metrics=self._metrics,
                )
                t_enc_pc = time.perf_counter()
                with slot.send_lock:
                    wire_mod.send_payload(slot.sock, payload)
                done_pc = time.perf_counter()
                self._count_frame("req", len(payload))
                if len(members) > 1:
                    self._metrics.inc("coalesce.frames")
                    self._metrics.inc("coalesce.members", len(members))
                if tracer is not None:
                    # the admission hop (submit -> send start:
                    # front-door pricing + coalescing + placement) and
                    # the wire-send hop (encode + sendall) per traced
                    # member, plus ONE nested wire.encode span for the
                    # frame — recorded completed: the dispatch thread
                    # cannot hold spans open across the reply
                    for r in traced:
                        attrs = {
                            "trace_id": r.trace.trace_id,
                            "worker": slot.index,
                            "hops": r.hops,
                            "members": len(members),
                        }
                        tracer.record_complete(Span(
                            name="rpc.admission", start=r.t_submit_pc,
                            end=t_send_pc, op_type="ClusterRouter",
                            attrs=dict(attrs),
                        ))
                        tracer.record_complete(Span(
                            name="rpc.send", start=t_send_pc,
                            end=done_pc, op_type="ClusterRouter",
                            attrs=dict(attrs),
                        ))
                    tracer.record_complete(Span(
                        name="wire.encode", start=t_send_pc,
                        end=t_enc_pc, op_type="ClusterRouter",
                        attrs={
                            "trace_id": traced[0].trace.trace_id,
                            "codec": (
                                "binary" if slot.codec_binary
                                else "pickle"
                            ),
                            "bytes": len(payload),
                            "members": len(members),
                        },
                    ))
                return True
            except Exception as e:
                # the worker died under us: undo the bookkeeping for the
                # whole group and let the down-handler (idempotent) run,
                # then try a peer with whoever is still unanswered
                with self._lock:
                    for rid in ids:
                        self._pending.pop(rid, None)
                        slot.outstanding.discard(rid)
                self._on_worker_down(
                    slot, ConnectionClosed(f"send failed: {e}")
                )
                reqs = [r for r in reqs if not r.future.done()]
                if not reqs:
                    return False

    def _count_frame(self, kind: str, nbytes: int) -> None:
        """Per-kind wire accounting (frames out + payload bytes out) —
        what the hot-wire bench reads to show the codec shrinking the
        hop."""
        self._metrics.inc(f"wire.frames.{kind}")
        self._metrics.inc(f"wire.bytes_sent.{kind}", nbytes)

    def _send_control(self, slot: _WorkerSlot, msg: dict) -> None:
        """Send one control frame (always pickle — control dicts carry
        arbitrary values and never ride the hot path) with per-kind wire
        accounting. Raises on a dead socket like ``send_msg``."""
        payload = wire_mod.encode_msg(msg)
        with slot.send_lock:
            wire_mod.send_payload(slot.sock, payload)
        self._count_frame(str(msg.get("type")), len(payload))

    # -- health + merged metrics ----------------------------------------

    def _health_loop(self) -> None:
        last_log = 0.0
        while not self._closed:
            time.sleep(self._health_interval_s)
            if self._closed:
                return
            self._reap_failed_respawns()
            with self._lock:
                live = [s for s in self._slots if s.alive]
            for slot in live:
                try:
                    self._send_control(
                        slot, {"type": "ping", "t": time.monotonic()}
                    )
                except Exception as e:
                    self._on_worker_down(
                        slot, ConnectionClosed(f"ping failed: {e}")
                    )
            fresh: List = []
            row: Optional[dict] = None
            try:
                # one timeline row per health tick; with a policy set the
                # watchdog samples AND judges it (breaches land in the
                # flight ring + counters), without one the row still
                # accumulates for status()/snapshot() readers
                if self._watchdog is not None:
                    fresh = self._watchdog.tick()
                    rows = self._metrics.timeline()
                    row = rows[-1] if rows else None
                else:
                    row = self._metrics.sample_timeline()
            except Exception:
                logger.exception("cluster: timeline sample failed")
            if self._autoscaler is not None:
                try:
                    # the closed control loop: this tick's breach rows +
                    # timeline row become scale decisions, applied through
                    # the actuator verbs below
                    self._autoscaler.tick(fresh, row=row)
                except Exception:
                    logger.exception("cluster: autoscaler tick failed")
            now = time.monotonic()
            if now - last_log >= self._log_interval_s:
                last_log = now
                try:
                    self._log_merged()
                except Exception:
                    logger.exception("cluster: merged metrics log failed")

    def _reap_failed_respawns(self) -> None:
        """A respawned worker whose process died BEFORE registering
        (boot crash) would otherwise leave its slot 'respawning' and
        parked requests waiting forever: retry within the budget, else
        give the slot up — and if nobody is left to come back, answer
        everything parked typed."""
        retry: List[_WorkerSlot] = []
        with self._lock:
            for s in self._slots:
                if not (
                    s.respawning and s.proc is not None
                    and s.proc is not s.down_proc
                    and s.proc.poll() is not None
                ):
                    continue
                if s.restarts < self._max_restarts and not self._closed:
                    s.restarts += 1
                    self._metrics.inc("restarts")
                    retry.append(s)
                else:
                    s.respawning = False
                    logger.warning(
                        "cluster: worker %d died during respawn boot "
                        "and its restart budget is exhausted — giving "
                        "the slot up", s.index,
                    )
            give_up = (
                not any(s.alive or s.respawning for s in self._slots)
                and not retry
            )
            failed = self._parked if give_up else []
            if give_up:
                self._parked = []
        for req in failed:
            settle_future(
                req.future,
                EngineStopped(
                    "no live workers remain and the restart budget is "
                    "exhausted"
                ),
            )
        for s in retry:
            try:
                self._spawn_worker(s)
            except Exception:
                logger.exception(
                    "cluster: re-spawn of worker %d failed", s.index
                )

    # -- autoscale actuator (driven by Autoscaler.tick) ------------------

    def scale_view(self) -> Dict[str, int]:
        """The slot census the scaler budgets against: ``admitting``
        (alive, taking traffic), ``booting`` (spawned or respawning, not
        ready yet — already-committed capacity, so the scaler must not
        buy it twice), ``draining`` (finishing, no longer admitting)."""
        with self._lock:
            admitting = booting = draining = 0
            for s in self._slots:
                if s.retired:
                    continue
                if s.alive:
                    if s.draining:
                        draining += 1
                    else:
                        admitting += 1
                elif s.booting or s.respawning:
                    booting += 1
        return {
            "admitting": admitting,
            "booting": booting,
            "draining": draining,
        }

    def scale_up_slot(self) -> int:
        """Add one worker slot and spawn its process through the same
        ``_spawn_worker`` path boot uses — against a warm shared AOT
        cache the new worker pre-warms every manifest signature and
        boots with ZERO compiles. Returns the slot index; the slot takes
        no traffic until its ``ready`` registers (``_register_ready``),
        so a death mid-boot can never fail an admitted request.
        Retired slots are re-armed before the list grows (indices must
        stay stable — ``_register_ready`` addresses ``_slots[index]``)."""
        with self._lock:
            if self._closed:
                raise EngineStopped("router is shut down")
            slot = next(
                (
                    s for s in reversed(self._slots)
                    if s.retired and (
                        s.proc is None or s.proc.poll() is not None
                    )
                ),
                None,
            )
            if slot is not None:
                slot.retired = False
                slot.draining = False
                slot.respawning = False
                slot.restarts = 0
                slot.ready_report = None
            else:
                slot = _WorkerSlot(len(self._slots))
                self._slots.append(slot)
            slot.booting = True
        try:
            self._spawn_worker(slot)
        except BaseException:
            with self._lock:
                slot.booting = False
                slot.retired = True
            raise
        return slot.index

    def pick_drain_candidate(self) -> Optional[int]:
        """The slot a scale-down should release: the HIGHEST-index
        admitting worker (LIFO — scale-ups appended it last, and the
        boot-time slots keep the stable low indices), or None when no
        slot can drain."""
        with self._lock:
            for s in reversed(self._slots):
                if s.alive and not s.draining and not s.retired:
                    return s.index
        return None

    def begin_drain(self, index: int) -> None:
        """Stop admitting to slot ``index`` and retire it off-thread:
        wait (bounded) for its outstanding requests to finish, send the
        worker a draining stop, join the process, release the slot. A
        drain that times out terminates the process — the down-handler
        then requeues whatever was left with deadlines intact, so the
        slow path strands nothing either."""
        with self._lock:
            slot = self._slots[index]
            if not slot.alive or slot.draining or slot.retired:
                raise RuntimeError(
                    f"worker {index} cannot drain (alive={slot.alive}, "
                    f"draining={slot.draining}, retired={slot.retired})"
                )
            slot.draining = True
            self._cond.notify_all()
        threading.Thread(
            target=self._drain_worker, args=(slot,),
            name=f"ks-router-drain-{index}", daemon=True,
        ).start()

    def _drain_worker(self, slot: _WorkerSlot) -> None:
        import subprocess

        deadline = time.monotonic() + self._drain_timeout_s
        with self._cond:
            while (
                slot.outstanding and slot.alive and not self._closed
                and time.monotonic() < deadline
            ):
                self._cond.wait(timeout=0.2)
            timed_out = bool(slot.outstanding) and slot.alive
        if slot.alive and slot.sock is not None:
            try:
                self._send_control(slot, {"type": "stop", "drain": True})
            except Exception:
                logger.debug(
                    "drain stop to worker %d failed (already dead?)",
                    slot.index, exc_info=True,
                )
        proc = slot.proc
        if proc is not None:
            try:
                proc.wait(timeout=self._join_timeout_s)
            except subprocess.TimeoutExpired:
                logger.warning(
                    "cluster: draining worker %d did not exit within "
                    "%.1fs — terminating it (its in-flight work "
                    "requeues)", slot.index, self._join_timeout_s,
                )
                proc.terminate()
                try:
                    proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
        # the socket death has (or will have) run the down-handler for
        # any stranded work; all that is left is releasing the slot
        with self._cond:
            slot.alive = False
            slot.draining = False
            slot.retired = True
            try:
                if slot.sock is not None:
                    slot.sock.close()
            except OSError:
                pass
            slot.sock = None
            self._release_rings(slot)
            self._cond.notify_all()
        _flight.record_instant(
            "scale.drained", worker=slot.index, timed_out=timed_out,
        )
        logger.info(
            "cluster: worker %d drained and released%s", slot.index,
            " (drain timed out; process terminated)" if timed_out else "",
        )

    def reap_slot(self, index: int) -> None:
        """Force-retire slot ``index`` — the scaler's abort path for a
        half-born (killed mid-scale-up) or half-drained slot. Kills the
        process if still up and requeues anything outstanding; the slot
        stays retired until a later scale-up re-arms it."""
        import subprocess

        with self._lock:
            slot = self._slots[index]
            slot.booting = False
            slot.respawning = False
            slot.draining = False
            slot.retired = True
            slot.alive = False
            sock, slot.sock = slot.sock, None
            self._release_rings(slot)
            proc = slot.proc
            orphans = [
                self._pending.pop(rid)
                for rid in sorted(slot.outstanding)
                if rid in self._pending
            ]
            slot.outstanding = set()
            self._cond.notify_all()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                proc.kill()
        moved = 0
        for req in orphans:
            if not req.future.done() and self._route(req, from_requeue=True):
                moved += 1
        if moved:
            self._metrics.inc("requeues", moved)

    def _log_merged(self) -> None:
        snap = self.snapshot(timeout=1.0)
        c = snap.get("counters", {})
        lat = snap.get("latency", {})
        age = snap.get("queue_age", {})
        occ = (snap.get("batch_occupancy") or {}).get("ratio")
        logger.info(
            "cluster-router: workers=%d/%d outstanding=%d counters=%s "
            "occupancy=%s shed=%s p99=%s queue_age_p99=%s slo_breaches=%s",
            sum(1 for s in self._slots if s.alive), len(self._slots),
            self.outstanding, c,
            None if occ is None else round(occ, 3),
            c.get("shed", 0),
            round(lat["p99"], 4) if "p99" in lat else None,
            round(age["p99"], 4) if "p99" in age else None,
            c.get("slo_breaches", 0),
        )

    def worker_snapshots(self, timeout: float = 2.0) -> List[dict]:
        """Fresh metrics snapshots (with quantile sketches) from every
        live worker, named ``worker-<i>`` — the worker-tier-only view
        (benches gate on worker-measured latency: it excludes the
        CLIENT process's own scheduling noise)."""
        with self._lock:
            live = [s for s in self._slots if s.alive]
            for slot in live:
                slot.stats_seq += 1
                slot.last_snapshot = None  # stale data never re-served
                slot.stats_event.clear()
        for slot in live:
            try:
                self._send_control(
                    slot, {"type": "stats", "seq": slot.stats_seq}
                )
            except Exception:
                logger.debug(
                    "stats request to worker %d failed", slot.index,
                    exc_info=True,
                )
        deadline = time.monotonic() + timeout
        out = []
        for slot in live:
            slot.stats_event.wait(
                timeout=max(0.0, deadline - time.monotonic())
            )
            if slot.last_snapshot is not None:
                snap = dict(slot.last_snapshot)
                snap["name"] = f"worker-{slot.index}"
                out.append(snap)
        return out

    def snapshot(self, timeout: float = 2.0) -> dict:
        """ONE fleet-wide view: the router's own registry (submissions,
        front-door sheds, restarts, end-to-end latency) merged with
        every live worker's snapshot (batches, occupancy, worker-side
        sheds, queue-age sketches) via :meth:`MetricsRegistry.merge`."""
        own = self._metrics.snapshot(sketches=True)
        # the router's cost table is a pong-fed MIRROR of the workers'
        # (kept so the router-side timeline/watchdog track spend live);
        # merging it alongside the authoritative worker tables would
        # double every charge
        own.pop("costs", None)
        workers = self.worker_snapshots(timeout=timeout)
        # every completed request has a latency sample in BOTH tiers
        # (router end-to-end, worker-internal) — merging both sketches
        # into one quantile pool would double the count and blend two
        # populations. The merged 'latency' is the END-TO-END tier;
        # worker-internal latency stays readable via worker_snapshots().
        # Worker queue-age sketches have no router counterpart and merge
        # as-is.
        workers = [
            (
                {**snap, "sketch": {
                    k: v for k, v in (snap.get("sketch") or {}).items()
                    if k != "latencies"
                }}
                if snap.get("sketch") else snap
            )
            for snap in workers
        ]
        merged = MetricsRegistry.merge([own] + workers, name="cluster")
        # 'submitted'/'completed' exist at BOTH tiers for the same
        # requests (front door and worker fleet) — a blind sum double
        # counts. The fleet-wide truth is the router's own count; the
        # worker-tier sum (which can exceed it under requeues) keeps its
        # own key.
        c = merged["counters"]
        for key in ("submitted", "completed"):
            total, mine = c.get(key, 0), own["counters"].get(key, 0)
            if total - mine:
                c[f"worker_{key}"] = total - mine
            c[key] = mine
        return merged

    # -- cross-process trace stitching + fleet status --------------------

    def collect_trace(self, timeout: float = 2.0) -> List[List[dict]]:
        """Every process's span set in wire form: the router's own spans
        plus what each worker has shipped (a stats round-trip first, so
        fresh worker spans arrive). Ready for
        :func:`keystone_tpu_torch.obs.export.stitch_chrome_trace`.

        Collection COMPACTS: the router's fresh spans move from the
        process tracer into a bounded buffer (and workers discard what
        they ship), so a deployment that exports periodically holds a
        bounded window per process — the stitched file is the archive.
        A traced router that never collects keeps the ordinary
        process-tracer contract (spans retained for the atexit export)."""
        from ..obs.export import wire_spans

        # a stats request makes every live worker ship its fresh spans;
        # the reply handler accumulates them on the slots
        self.worker_snapshots(timeout=timeout)
        sets: List[List[dict]] = []
        tracer = _trace_current()
        if tracer is not None:
            # serialized OUTSIDE the admission lock (a first collect
            # after a long traced window may hold many spans, and
            # submit()/answer settlement must not stall behind it);
            # _own_trace_lock serializes concurrent collectors
            with self._own_trace_lock:
                fresh, self._own_span_cursor = tracer.spans_since(
                    self._own_span_cursor
                )
                # only what the bounded buffer will keep gets serialized
                self._own_trace_spans.extend(wire_spans(
                    fresh[-8192:], tracer.epoch, tracer.epoch_unix,
                    process_name=f"keystone:router/{os.getpid()}",
                ))
                del self._own_trace_spans[:-8192]
                tracer.discard_through(self._own_span_cursor)
                if self._own_trace_spans:
                    sets.append(list(self._own_trace_spans))
        with self._lock:
            for slot in self._slots:
                if slot.trace_spans:
                    sets.append(list(slot.trace_spans))
        return sets

    def export_trace(self, path: str, timeout: float = 2.0) -> str:
        """Write ONE stitched Chrome-trace/Perfetto JSON covering the
        whole process tier: real per-pid process tracks, worker spans
        rebased onto the shared unix clock, and each sampled request's
        hops tied together by its ``trace_id`` attr."""
        from ..obs.export import write_stitched_trace

        return write_stitched_trace(self.collect_trace(timeout=timeout), path)

    @staticmethod
    def _qos_view(snap: dict) -> dict:
        """The QoS digest off a merged snapshot: per-tenant served
        counts (and their share of total service — the weighted-fair
        convergence evidence, summed across worker processes), sheds by
        priority class (all tiers), and per-priority latency
        quantiles."""
        c = snap.get("counters") or {}
        served = {
            k[len("tenant.served."):]: int(v)
            for k, v in c.items()
            if k.startswith("tenant.served.")
        }
        total = sum(served.values())
        return {
            "tenant_served": served,
            "tenant_share": (
                {t: round(n / total, 4) for t, n in sorted(served.items())}
                if total else {}
            ),
            "shed_by_priority": {
                p: int(c.get(f"shed.{p}", 0)) for p in PRIORITIES
            },
            "priority_latency": snap.get("priority_latency") or {},
        }

    def status(self, timeout: float = 2.0, snap: Optional[dict] = None) -> dict:
        """The fleet-wide timeline view: liveness + capacity, the merged
        counters/quantiles, each tier's bounded metrics timeline (kept
        per-process — see ``MetricsRegistry.merge``), restart budgets,
        and the SLO verdicts. The programmatic form behind the demo
        CLI's ``--status`` rendering (:func:`format_status`). ``snap``
        reuses a merged snapshot the caller already paid the worker
        stats round-trip for."""
        if snap is None:
            snap = self.snapshot(timeout=timeout)
        with self._lock:
            workers = [
                {
                    "index": s.index,
                    "alive": s.alive,
                    "pid": s.proc.pid if s.proc is not None else None,
                    "capacity": s.capacity,
                    "restarts": s.restarts,
                    "outstanding": len(s.outstanding),
                    "respawning": s.respawning,
                    "booting": s.booting,
                    "draining": s.draining,
                    "retired": s.retired,
                }
                for s in self._slots
            ]
        timelines = dict(snap.get("timelines") or {})
        # the router's own rows ride under its registry name so the view
        # shows every tier side by side, never blended; a status read
        # before the first health tick samples one row rather than
        # rendering an empty tier
        own_rows = self._metrics.timeline()
        if not own_rows:
            own_rows = [self._metrics.sample_timeline()]
        timelines.setdefault(self._metrics.name, own_rows)
        out = {
            "workers": workers,
            "live_workers": sum(1 for w in workers if w["alive"]),
            "outstanding": self.outstanding,
            "capacity": self.capacity,
            "counters": snap.get("counters", {}),
            "costs": snap.get("costs", {}),
            "latency": snap.get("latency", {}),
            "queue_age": snap.get("queue_age", {}),
            "batch_occupancy": snap.get("batch_occupancy"),
            "timelines": timelines,
            "slo": None,
            "qos": self._qos_view(snap),
            "autoscale": (
                dict(
                    self._autoscaler.describe(),
                    view=self.scale_view(),
                )
                if self._autoscaler is not None else None
            ),
        }
        if self._watchdog is not None:
            from dataclasses import asdict

            out["slo"] = {
                "policy": {
                    k: v
                    for k, v in asdict(self._watchdog.policy).items()
                    if v is not None
                },
                "breaches": [
                    b.as_attrs() | {"ts": b.ts}
                    for b in self._watchdog.breaches[-32:]
                ],
            }
        return out

    # -- shutdown --------------------------------------------------------

    def install_signal_handlers(self) -> None:
        """SIGTERM → bounded drain-and-stop (satellite contract: a
        TERM'd router drains workers with per-process join timeouts and
        never hangs a smoke run).

        The handler only SPAWNS the shutdown thread: it may interrupt
        the main thread INSIDE a router critical section, and calling
        ``shutdown`` (which takes the same non-reentrant lock) from the
        handler frame would deadlock exactly the path this exists to
        keep bounded."""

        def _on_term(signum, frame):
            logger.warning(
                "cluster: SIGTERM — draining and shutting down"
            )

            def _stop():
                self.shutdown(drain=True)
                if callable(self._prev_sigterm):
                    self._prev_sigterm(signum, frame)

            threading.Thread(
                target=_stop, name="ks-router-sigterm", daemon=False
            ).start()

        self._prev_sigterm = signal.signal(signal.SIGTERM, _on_term)

    def shutdown(self, drain: bool = True) -> None:
        """Stop the tier. Bounded: the drain wait, every worker stop,
        every process join, and every receive-thread join have timeouts;
        a wedged worker is WARNed, force-killed, and its in-flight
        requests failed typed. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            flush: List[_PendingReq] = list(self._coalesce_q)
            self._coalesce_q = deque()
            self._cond.notify_all()
        exporter, self._exporter = self._exporter, None
        if exporter is not None:
            exporter.stop()
        if drain and flush:
            # admitted but not yet placed when the shutdown hit: a
            # draining shutdown still owes these real answers — dispatch
            # the tail now (workers are stopped only after the drain
            # wait), single frames, no coalesce window
            for req in flush:
                self._dispatch([req], during_shutdown=True)
            flush = []
        if drain:
            deadline = time.monotonic() + self._drain_timeout_s
            with self._cond:
                while self._pending:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        logger.warning(
                            "cluster shutdown: drain did not finish "
                            "within %.1fs (%d request(s) in flight; "
                            "wedged worker?) — failing the remainder",
                            self._drain_timeout_s, len(self._pending),
                        )
                        break
                    self._cond.wait(timeout=min(0.2, remaining))
        for slot in self._slots:
            if slot.alive and slot.sock is not None:
                try:
                    self._send_control(
                        slot, {"type": "stop", "drain": drain}
                    )
                except Exception:
                    logger.debug(
                        "stop message to worker %d failed (already dead?)",
                        slot.index, exc_info=True,
                    )
        import subprocess

        for slot in self._slots:
            proc = slot.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=self._join_timeout_s)
            except subprocess.TimeoutExpired:
                logger.warning(
                    "cluster shutdown: worker %d (pid %s) did not exit "
                    "within %.1fs — terminating it and failing its "
                    "in-flight work", slot.index, proc.pid,
                    self._join_timeout_s,
                )
                proc.terminate()
                try:
                    proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    try:
                        proc.wait(timeout=2.0)
                    except subprocess.TimeoutExpired:
                        pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for slot in self._slots:
            slot.alive = False
            t = slot.recv_thread
            if t is not None and t is not threading.current_thread():
                t.join(timeout=2.0)
                if t.is_alive():
                    logger.warning(
                        "cluster shutdown: receive thread for worker %d "
                        "did not exit — abandoning it (daemon)",
                        slot.index,
                    )
        # the belt-and-braces sweep: every admitted request gets an
        # answer, typed — including anything a non-draining shutdown
        # left in the coalesce queue
        with self._lock:
            remaining = (
                list(self._pending.values()) + self._parked
                + flush + list(self._coalesce_q)
            )
            self._pending.clear()
            self._parked = []
            self._coalesce_q = deque()
            for slot in self._slots:
                self._release_rings(slot)
        for req in remaining:
            settle_future(
                req.future, EngineStopped("cluster router is shut down")
            )
        if remaining:
            logger.warning(
                "cluster shutdown: failed %d unanswered request(s) typed",
                len(remaining),
            )

    def __enter__(self) -> "ClusterRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)


def format_status(status: dict) -> str:
    """Render :meth:`ClusterRouter.status` as the operator-facing text
    view: a worker table, headline counters, and each tier's metrics
    timeline as one line per sample (windowed counters + p99s) — the
    queue-age-over-time picture a point snapshot cannot give."""
    lines = [
        "cluster status: workers {}/{} capacity {} outstanding {}".format(
            status.get("live_workers", 0),
            len(status.get("workers") or []),
            status.get("capacity", 0),
            status.get("outstanding", 0),
        )
    ]
    for w in status.get("workers") or []:
        lines.append(
            "  worker {index}: {state} pid={pid} capacity={capacity} "
            "restarts={restarts} outstanding={outstanding}".format(
                state=(
                    "draining" if w.get("draining")
                    else "retired" if w.get("retired")
                    else "booting" if w.get("booting")
                    else "respawning" if w.get("respawning")
                    else "up" if w.get("alive") else "DOWN"
                ),
                **{k: w.get(k) for k in (
                    "index", "pid", "capacity", "restarts", "outstanding"
                )},
            )
        )
    c = status.get("counters") or {}
    lat = status.get("latency") or {}
    lines.append(
        "  counters: completed={} shed={} rejected={} restarts={} "
        "requeues={} slo_breaches={} p99={}".format(
            c.get("completed", 0), c.get("shed", 0), c.get("rejected", 0),
            c.get("restarts", 0), c.get("requeues", 0),
            c.get("slo_breaches", 0),
            round(lat["p99"], 4) if "p99" in lat else None,
        )
    )
    wire = {
        k[len("wire.frames."):]: v for k, v in c.items()
        if k.startswith("wire.frames.")
    }
    if wire:
        sent = {
            k[len("wire.bytes_sent."):]: v for k, v in c.items()
            if k.startswith("wire.bytes_sent.")
        }
        lines.append(
            "  wire: " + " ".join(
                "{}={}f/{}B".format(kind, n, sent.get(kind, 0))
                for kind, n in sorted(wire.items())
            ) + " coalesce_frames={} coalesce_members={} "
            "shm_payloads={} shm_fallback={}".format(
                c.get("coalesce.frames", 0),
                c.get("coalesce.members", 0),
                c.get("shm.payloads", 0),
                c.get("shm.fallback", 0),
            )
        )
    qos = status.get("qos") or {}
    served = qos.get("tenant_served") or {}
    sheds = qos.get("shed_by_priority") or {}
    if served:
        shares = qos.get("tenant_share") or {}
        lines.append(
            "  qos tenants: " + ", ".join(
                "{}: served={} share={}".format(t, n, shares.get(t))
                for t, n in sorted(served.items())
            )
        )
    if any(sheds.values()):
        lines.append(
            "  qos shed by priority: " + " ".join(
                f"{p}={sheds.get(p, 0)}" for p in ("high", "normal", "low")
            )
        )
    costs = status.get("costs") or {}
    if costs:
        for tenant, prios in sorted(costs.items()):
            total = {
                "device_s": 0.0, "queue_s": 0.0,
                "payload_bytes": 0, "items": 0,
            }
            for row in prios.values():
                for k in total:
                    total[k] += row.get(k) or 0
            split = " ".join(
                f"{p}={round(r.get('device_s') or 0.0, 4)}s"
                for p, r in sorted(prios.items())
            )
            lines.append(
                "  cost [{}]: device_s={} queue_s={} payload_mb={} "
                "items={} ({})".format(
                    tenant,
                    round(total["device_s"], 4),
                    round(total["queue_s"], 4),
                    round(total["payload_bytes"] / 1e6, 3),
                    int(total["items"]),
                    split,
                )
            )
    plat = qos.get("priority_latency") or {}
    if plat:
        lines.append(
            "  qos p99 by priority: " + " ".join(
                "{}={}".format(
                    p, round(q["p99"], 4) if "p99" in q else None
                )
                for p, q in sorted(plat.items())
            )
        )
    asc = status.get("autoscale")
    if asc:
        view = asc.get("view") or {}
        lines.append(
            "  autoscale: target={} admitting={} booting={} draining={} "
            "policy={}".format(
                asc.get("target"), view.get("admitting"),
                view.get("booting"), view.get("draining"),
                asc.get("policy"),
            )
        )
        for d in (asc.get("decisions") or [])[-8:]:
            lines.append(
                "    SCALE {action} {from_workers}->{to_workers} "
                "[{verdict}] worker={worker} reason={reason}{trig}".format(
                    action=d.get("action"),
                    from_workers=d.get("from_workers"),
                    to_workers=d.get("to_workers"),
                    verdict="ok" if d.get("ok") else "ABORTED",
                    worker=d.get("worker"),
                    reason=d.get("reason"),
                    trig=(
                        f" trigger={d.get('trigger')}"
                        if d.get("trigger") else ""
                    ),
                )
            )
    slo = status.get("slo")
    if slo:
        lines.append(f"  slo policy: {slo.get('policy')}")
        for b in (slo.get("breaches") or [])[-8:]:
            lines.append(
                "    BREACH {objective}{who}: observed {observed} vs "
                "budget {budget}".format(
                    who=(
                        " [{}]".format(b["detail"]) if b.get("detail") else ""
                    ),
                    **{k: v for k, v in b.items() if k != "detail"},
                )
            )
    for name, rows in sorted((status.get("timelines") or {}).items()):
        lines.append(f"  timeline [{name}] ({len(rows)} samples):")
        for row in rows[-10:]:
            lat = row.get("latency") or {}
            age = row.get("queue_age") or {}
            lines.append(
                "    t={:.1f} counters={} p99={} queue_age_p99={}".format(
                    row.get("ts", 0.0),
                    row.get("counters") or {},
                    round(lat["p99"], 4) if "p99" in lat else None,
                    round(age["p99"], 4) if "p99" in age else None,
                )
            )
    return "\n".join(lines)


def settle_result(fut: Future, value: Any) -> bool:
    """set_result regardless of PENDING/RUNNING state; False when the
    future was already settled (a requeue raced the original answer)."""
    if fut.done():
        return False
    try:
        try:
            if not fut.set_running_or_notify_cancel():
                return False
        except Exception:  # already running: settle it
            pass
        fut.set_result(value)
        return True
    except Exception:  # lost the set-once race: the other answer stands
        return False
