"""The replicated serving fleet: N replicas behind one admission surface
(port of ``keystone_tpu/serving/fleet.py``).

``ServingEngine`` spreads one compiled chain over concurrent callers
through one worker. :class:`ServingFleet` runs N
:class:`~.replica.Replica` workers (by default one a device,
``parallel/placement.py``) that drain one :class:`~.scheduler.FleetScheduler`:
continuous batching, deadline-aware admission shedding (typed
:class:`Shed`), work stealing and weighted-fair QoS. A model version is one
trace function (or, with an AOT executable cache, one program a bucket),
so the fleet pays each bucket signature once however many replicas serve
it (the ``compiles`` counter); on the card each replica captures its own
CUDA graph of it on its own stream (:attr:`ServedChain.captures`), since a
graph shared by co-resident replicas would run one batch at a time.

``swap(fitted)`` is fleet-wide with no downtime: the replacement compiles
and warms every bucket on every replica off the serving path, then the
replicas flip; admission never pauses, every micro-batch runs whole on one
chain, and no request is dropped. With ``canary_fraction > 0`` a shadow
phase first mirrors a fraction of live batches through the candidate
(after their answers are out), compares outputs and latency, and on a
mismatch rolls back by raising :class:`CanaryMismatch` with the evidence.

``start()`` warms every bucket and every signature the pipeline ever
exported by the AOT cache's manifest, and pre-warms the segment programs
the cache indexes.

**Supervision** (on by default): a replica whose thread dies (an injected
``ReplicaKilled``, a real crash) or trips the consecutive-failure breaker
(:class:`~.replica.ReplicaQuarantined`) has its queued and in-flight
requests requeued to live peers with their deadlines (one that can no
longer make it is answered with ``Shed``), and restarts up to
``max_restarts`` times; ``restarts``, ``requeues`` and ``quarantined`` are
counted, ``fault.replica_down`` / ``fault.replica_restart`` recorded.
Shutdown is bounded: a wedged replica is joined with a time limit, logged
and abandoned, and its work failed typed.

**A kernel or device fault is the card's** (``ops.is_device_fault``: a
kernel's build or launch failure, an out-of-memory error, a CUDA error).
On one card a restart or a peer would meet it again, so the port neither
restarts nor requeues for it, and a canary candidate's device fault is not
a mismatch: the fleet fails every admitted request with that error, stops
admitting, dumps the flight ring (``device_fault``), and ``swap`` and
``shutdown`` re-raise it. The JAX package restarts and requeues on any
failure and counts any candidate failure as a mismatch.
"""

from __future__ import annotations

import logging
import statistics
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..autoscale.qos import DEFAULT_TENANT, normalize_priority
from ..faults import ReplicaKilled
from ..obs import flight, resource
from ..obs.tracer import current as _trace_current
from ..ops import is_device_fault
from ..workflow.pipeline import FittedPipeline
from .batching import BucketPolicy
from .engine import PREDICT_GRACE_S
from .errors import CanaryMismatch, EngineStopped
from .metrics import MetricsRegistry
from .replica import (
    Replica,
    ReplicaQuarantined,
    _Request,
    check_swap_contract,
    compile_pipeline,
    serving_contract,
    settle_future,
)
from .scheduler import FleetScheduler

logger = logging.getLogger(__name__)

#: manifest entries above this many elements are not warmed (another
#: process may have exported a whole-dataset apply shape)
_MAX_WARM_ELEMENTS = 1 << 24

#: shutdown never blocks forever on a wedged replica: seconds to wait for
#: the drain to go idle, and for each thread to join after the stop
_DRAIN_TIMEOUT_S = 60.0
_JOIN_TIMEOUT_S = 10.0


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.type == "cpu" or (a.index or 0) == (b.index or 0))


class ServingFleet:
    """Serves a :class:`FittedPipeline` from N replica workers behind one
    deadline-aware admission queue.

    The parameters shared with :class:`~.engine.ServingEngine` mean the
    same; the others:

    replicas:
        The worker count; None is one a device of the chain's device (one
        on one card). More replicas than devices share them (co-resident
        replicas overlap their host work and replays).
    devices:
        Explicit placement, one device a replica; default
        :func:`keystone_tpu_torch.parallel.placement.replica_devices` over
        the device the chain's parameters live on. A replica serves on the
        device of the model's tensors. The port makes no copy of the model
        for a replica on another card of the mesh: that needs two cards to
        exercise, and stays for later (ROADMAP).
    steal:
        Work stealing between the per-replica queues.
    supervise:
        Replica supervision: restarts up to ``max_restarts`` and the
        ``quarantine_after`` breaker. Off, a dead replica's work is still
        requeued but the replica is not restarted.
    tenant_weights:
        Weighted-fair shares of named tenants (others weigh 1.0).
    on_device_fault:
        Called with the error once a device fault has stopped the fleet and
        every admitted request is answered (a cluster worker exits on it,
        so its router respawns a fresh CUDA context).
    """

    def __init__(self, fitted: FittedPipeline, *, replicas: Optional[int] = None,
                 buckets: Sequence[int] = (1, 8, 32, 64),
                 datum_shape: Optional[Sequence[int]] = None, dtype: Any = None,
                 max_queue: int = 1024, max_wait_ms: float = 2.0,
                 metrics: Optional[MetricsRegistry] = None, log_interval_s: float = 10.0,
                 devices: Optional[Sequence[Any]] = None, steal: bool = True,
                 supervise: bool = True, max_restarts: int = 2, quarantine_after: int = 3,
                 join_timeout_s: float = _JOIN_TIMEOUT_S,
                 drain_timeout_s: float = _DRAIN_TIMEOUT_S,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 on_device_fault: Optional[Callable[[BaseException], None]] = None):
        from ..parallel.placement import replica_devices

        self._fitted = fitted
        datum_shape, dtype = serving_contract(fitted, datum_shape, dtype)
        self._policy = BucketPolicy(buckets, datum_shape, dtype)
        self._metrics = metrics or MetricsRegistry(name="serving-fleet")
        self._compiled_signatures: list = []
        # one trace function (or AOT program a bucket) per model version,
        # shared by every replica; each replica captures its own graphs
        compiled = compile_pipeline(fitted, metrics=self._metrics,
                                    signatures=self._compiled_signatures, label="serving")
        if devices is None:
            devices = replica_devices(replicas, device=compiled.device)
        elif replicas is not None and len(devices) != replicas:
            raise ValueError(f"devices list ({len(devices)}) does not match replicas={replicas}")
        self._devices = [torch.device(d) for d in devices]
        for d in self._devices:
            if not _same_device(d, compiled.device):
                raise ValueError(
                    f"a replica on {d} cannot serve a chain whose tensors live on "
                    f"{compiled.device}: the port makes no copy of the model for another "
                    "device of the mesh")
        n = len(self._devices)
        self._replicas = [
            Replica(compiled, self._policy, self._metrics, index=i, device=self._devices[i],
                    span_name="serve.replica", log_interval_s=log_interval_s,
                    # the breaker needs a supervisor to catch it
                    quarantine_after=quarantine_after if supervise else 0,
                    on_device_fault=self._on_device_fault)
            for i in range(n)
        ]
        # the published model: the version and chain every replica must
        # serve. A restarted replica is pinned to it again, so a canary
        # window that outlives a restart cannot leak the candidate onto the
        # new thread. Guarded by _supervise_lock: the supervisor pins from
        # the dying replica's thread, which must not take the lifecycle lock.
        self._model_version = 1
        self._model_digest = getattr(compiled.dispatcher, "digest", None)
        self._published_exec = compiled
        for rep in self._replicas:
            rep.version = self._model_version
        self._scheduler = FleetScheduler(n, self._policy, self._metrics, max_queue=max_queue,
                                         max_wait_ms=max_wait_ms, steal=steal,
                                         tenant_weights=tenant_weights)
        self._lifecycle_lock = threading.RLock()
        # serializes whole swaps (the canary window included, which runs
        # without the lifecycle lock so a shutdown is never held up by it)
        self._swap_lock = threading.Lock()
        # supervision's own lock: the supervisor runs in the dying replica's
        # thread, which a shutdown holding the lifecycle lock may be joining
        self._supervise_lock = threading.Lock()
        self._supervise = bool(supervise)
        self._max_restarts = max_restarts if supervise else 0
        self._restart_counts = [0] * n
        self._join_timeout_s = float(join_timeout_s)
        self._drain_timeout_s = float(drain_timeout_s)
        self._threads: List[threading.Thread] = []
        self._closed = False
        self._ran = False
        #: the kernel or device fault that stopped the fleet, None while none
        self._device_fault: Optional[BaseException] = None
        self._on_device_fault_cb = on_device_fault
        self._metrics.set_gauge("queue_depth", lambda: self._scheduler.depth)
        # the device-memory watermark gauges; no-ops without KEYSTONE_ACCOUNTING
        resource.install_memory_gauges(self._metrics)

    # -- introspection ---------------------------------------------------

    @property
    def metrics(self) -> MetricsRegistry:
        return self._metrics

    @property
    def policy(self) -> BucketPolicy:
        return self._policy

    @property
    def scheduler(self) -> FleetScheduler:
        return self._scheduler

    @property
    def replicas(self) -> tuple:
        return tuple(self._replicas)

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    def qos_snapshot(self) -> Dict[str, object]:
        """Each tenant's queued depth and weight, and the queued count of
        each priority (:meth:`FleetScheduler.qos_snapshot`)."""
        return self._scheduler.qos_snapshot()

    @property
    def compiled_signatures(self) -> list:
        """``(shape, dtype)`` of every signature the fleet paid, in order;
        its length is the ``compiles`` counter."""
        return list(self._compiled_signatures)

    @property
    def captures(self) -> int:
        """The CUDA graphs the published chain holds, over every replica."""
        with self._supervise_lock:
            return self._published_exec.captures

    @property
    def fitted(self) -> FittedPipeline:
        """The published model (moves only on a promoted swap)."""
        return self._fitted

    @property
    def model_version(self) -> int:
        """1 at boot, one more a promoted swap."""
        with self._supervise_lock:
            return self._model_version

    def version_report(self) -> dict:
        """The published ``version`` and ``digest`` and what each replica
        serves. ``skew`` is True when a replica disagrees with the
        published version: possible only inside a promotion's flip."""
        with self._supervise_lock:
            replicas = {rep.index: {"version": rep.version,
                                    "restarts": self._restart_counts[rep.index]}
                        for rep in self._replicas}
            return {"version": self._model_version, "digest": self._model_digest,
                    "replicas": replicas,
                    "skew": any(row["version"] != self._model_version
                                for row in replicas.values())}

    # -- lifecycle -------------------------------------------------------

    def warm_up(self, required: bool = True) -> int:
        """Capture (or AOT-load) every bucket on every replica, and every
        signature of the pipeline's AOT manifest, so a fresh fleet against
        a warm cache boots with zero traces and no cold first request.
        Returns the distinct signatures warmed. ``required`` is the
        engine's: True raises when no datum shape is known, False warns."""
        inputs = []
        if self._policy.datum_shape is None:
            if required:
                raise ValueError(
                    "warm-up requested but impossible: no datum shape is known — pass "
                    "datum_shape= to the fleet, or fit the pipeline through "
                    "and_then(estimator, data) so the contract is recorded on the "
                    "FittedPipeline")
            logger.warning("fleet warm-up skipped: no datum_shape configured — the first live "
                           "batch of each bucket will pay its capture")
        else:
            inputs = list(self._policy.warmup_inputs())
        seen = {(tuple(x.shape), str(x.dtype)) for x in inputs}
        for shape, dtype in self._manifest_signatures():
            if (shape, dtype) in seen:
                continue
            n_elem = 1
            for d in shape:
                n_elem *= max(int(d), 1)
            if n_elem > _MAX_WARM_ELEMENTS:
                logger.info("fleet warm-up: skipping oversized manifest signature %s "
                            "(%s elements)", shape, n_elem)
                continue
            seen.add((shape, dtype))
            inputs.append(np.zeros(shape, dtype=dtype))
        self._warm_inputs(self._replicas[0].compiled, inputs)
        self._prewarm_segments()
        logger.info("fleet warm-up: %d signature(s) ready on %d replica(s) (%d traced, %d "
                    "loaded from the AOT cache)", len(inputs), len(self._replicas),
                    self._metrics.count("compiles"), self._metrics.count("aot_loads"))
        return len(inputs)

    def _prewarm_segments(self) -> None:
        """Pre-warm every segment program the AOT cache's segment manifest
        indexes, so a warm fit on this host loads instead of exporting.
        Best effort: a fleet that serves without it must not fail for it."""
        from .. import compile as compile_mod

        cache = compile_mod.get_cache()
        if cache is None:
            return
        try:
            warmed = compile_mod.prewarm_segment_artifacts(cache)
        except Exception:
            logger.warning("fleet warm-up: segment pre-warm failed — warm fits will load "
                           "lazily", exc_info=True)
            return
        if warmed:
            logger.info("fleet warm-up: %d segment program(s) pre-warmed", warmed)

    def _warm_inputs(self, compiled, inputs) -> None:
        """Run each input through ``compiled`` on every replica's lane and
        stream: each replica captures its own graphs (the program a
        signature is shared, so ``compiles`` counts it once)."""
        for rep in self._replicas:
            for x in inputs:
                rep.run_chain(compiled, x)  # returns host arrays: the batch has run

    def _manifest_signatures(self) -> list:
        """The signatures the pipeline ever exported (the AOT manifest)
        that match this fleet's per-item contract and dtype; [] without a
        cache or a content key."""
        from .. import compile as compile_mod

        digest = getattr(self._replicas[0].compiled.dispatcher, "digest", None)
        cache = compile_mod.get_cache()
        want = self._policy.datum_shape
        if digest is None or cache is None or want is None:
            return []
        return [(shape, dtype) for shape, dtype in compile_mod.exported_signatures(cache, digest)
                if tuple(shape[1:]) == tuple(want) and str(dtype) == str(self._policy.dtype)]

    def start(self, warmup: Optional[bool] = None) -> "ServingFleet":
        """Warm up (``warmup`` as the engine's), then start every replica
        and admit."""
        with self._lifecycle_lock:
            if self._threads:
                raise RuntimeError("fleet already started")
            if self._closed:
                raise EngineStopped("fleet was shut down")
            if warmup or warmup is None:
                self.warm_up(required=warmup is True)
            for rep in self._replicas:
                self._spawn_replica_thread(rep)
            self._ran = True
        return self

    def _spawn_replica_thread(self, rep: Replica) -> threading.Thread:
        attempt = self._restart_counts[rep.index]
        t = threading.Thread(
            target=self._run_replica, args=(rep,),
            name=f"keystone-serving-replica-{rep.index}" + (f"-r{attempt}" if attempt else ""),
            daemon=True)
        with self._supervise_lock:
            self._threads.append(t)
        t.start()
        return t

    # -- supervision -------------------------------------------------------

    def _run_replica(self, rep: Replica) -> None:
        """Each replica thread's target: the loop and its supervisor. A loop
        that ends with any ``BaseException`` is a down worker: its work is
        requeued and it restarts within its budget."""
        try:
            rep.serve_forever(self._scheduler)
        except BaseException as e:  # noqa: BLE001 — the supervision seam
            try:
                self._on_replica_down(rep, e)
            except Exception:
                logger.exception("fleet supervisor failed for replica %s", rep.index)

    def _on_replica_down(self, rep: Replica, exc: BaseException) -> None:
        pending = getattr(exc, "pending", None) or []
        quarantined = isinstance(exc, ReplicaQuarantined)
        kind = ("quarantined" if quarantined
                else "killed" if isinstance(exc, ReplicaKilled) else "died")
        with self._supervise_lock:
            used = self._restart_counts[rep.index]
            will_restart = (not self._closed and self._device_fault is None
                            and used < self._max_restarts)
            if quarantined:
                self._metrics.inc("quarantined")
            # a replica down for good receives no admission; a restarting
            # one keeps its slot (a requeue with no peer retries in place)
            self._scheduler.set_active(rep.index, will_restart)
            moved = 0
            if pending:
                moved += self._scheduler.requeue_batch(
                    pending, rep, cause=exc if isinstance(exc, Exception) else None)
            moved += self._scheduler.requeue_replica(rep.index, keep_if_no_peer=will_restart)
            logger.warning("fleet: replica %s %s (%s) — requeued %d request(s); restart %s "
                           "(budget %d/%d used)", rep.index, kind, exc, moved,
                           "scheduled" if will_restart else "refused", used, self._max_restarts)
            tracer = _trace_current()
            if tracer is not None:
                tracer.instant("fault.replica_down", op_type="ServingFleet", replica=rep.index,
                               kind=kind, requeued=moved, restarting=will_restart)
            flight.record_instant("fault.replica_down", replica=rep.index, kind=kind,
                                  requeued=moved, restarting=will_restart)
            if will_restart:
                self._restart_counts[rep.index] = used + 1
                self._metrics.inc("restarts")
                rep.consecutive_failures = 0
                # pinned to the published model: only a promotion, which
                # flips every replica under this lock, moves it forward
                rep.flip(self._published_exec)
                rep.version = self._model_version
            elif not self._scheduler.any_active():
                failed = self._scheduler.fail_remaining(
                    "every replica is down and the restart budget is exhausted")
                if failed:
                    logger.warning("fleet: no live replicas remain — failed %d queued "
                                   "request(s)", failed)
        # post-mortem files, outside the lock (file IO): a quarantine always
        # leaves one, as does a replica down for good
        if quarantined:
            flight.dump("replica_quarantine")
        elif not will_restart:
            flight.dump("replica_down")
        if will_restart:
            # outside the lock: registering the thread takes it again
            self._spawn_replica_thread(rep)
            flight.record_instant("fault.replica_restart", replica=rep.index, attempt=used + 1)
            tracer = _trace_current()
            if tracer is not None:
                tracer.instant("fault.replica_restart", op_type="ServingFleet",
                               replica=rep.index, attempt=used + 1)

    def _on_device_fault(self, error: BaseException, rep: Optional[Replica]) -> None:
        """A kernel or device fault in a live batch (``rep``) or in the
        canary candidate (``rep`` None): the card's, so nothing restarts or
        requeues. Every queued request fails with ``error``, admission
        stops, every replica's loop ends, and the flight ring is dumped;
        ``swap`` and ``shutdown`` re-raise it. Runs on the faulting thread
        and takes no lifecycle lock."""
        with self._supervise_lock:
            if self._device_fault is not None:
                return
            self._device_fault = error
        self._metrics.inc("device_faults")
        replica = None if rep is None else rep.index
        logger.error("fleet: device fault in %s (%r) — failing every admitted request and "
                     "stopping", "the canary candidate" if rep is None else f"replica {replica}",
                     error)
        self._scheduler.close()
        for i in range(len(self._replicas)):
            self._scheduler.set_active(i, False)
        failed = self._scheduler.fail_remaining(error=error)
        self._scheduler.stop()
        flight.record_instant("fault.device", replica=replica, failed=failed,
                              error=repr(error)[:200])
        tracer = _trace_current()
        if tracer is not None:
            tracer.instant("fault.device", op_type="ServingFleet", replica=replica,
                           failed=failed)
        flight.dump("device_fault")
        if self._on_device_fault_cb is not None:
            self._on_device_fault_cb(error)

    def _raise_device_fault(self) -> None:
        if self._device_fault is not None:
            raise self._device_fault

    def drain(self) -> None:
        """Stop admitting, answer every queued request, stop every worker."""
        self.shutdown(drain=True)

    def shutdown(self, drain: bool = True) -> None:
        """Stop the fleet. ``drain=True`` answers queued requests first;
        ``drain=False`` fails them with :class:`EngineStopped`. Idempotent
        and safe from several threads; re-raises the device fault that
        stopped the fleet, if one did.

        Never blocks forever: the drain and each join are bounded
        (``drain_timeout_s`` / ``join_timeout_s``). A wedged replica is
        logged and abandoned (its thread is a daemon), its in-flight
        requests fail typed, and the final sweep answers everything
        queued."""
        with self._lifecycle_lock:
            self._closed = True
            self._scheduler.close()
            with self._supervise_lock:
                started = bool(self._threads)
            if not started:
                self._scheduler.fail_remaining(
                    "fleet is shut down" if self._ran else "fleet never started")
                return
            if drain and not self._scheduler.wait_idle(timeout=self._drain_timeout_s):
                logger.warning("fleet shutdown: drain did not go idle within %.1fs (wedged "
                               "replica?) — failing the remaining work instead of blocking "
                               "forever", self._drain_timeout_s)
            self._scheduler.stop()
            with self._supervise_lock:
                threads, self._threads = self._threads, []
            for t in threads:
                t.join(timeout=self._join_timeout_s)
                if t.is_alive():
                    logger.warning("fleet shutdown: thread %s did not exit within %.1fs — "
                                   "abandoning it (daemon) and failing its remaining work",
                                   t.name, self._join_timeout_s)
            # a wedged replica's batch would hang its callers: answer them
            # typed (a late real result loses the set-once race)
            for rep in self._replicas:
                for r in rep.current_batch or ():
                    settle_future(r.future, EngineStopped(
                        "fleet shut down while this request's replica was wedged"))
            # admission and close are one step in the scheduler, so nothing
            # lands after this; the sweep answers anything left
            self._scheduler.fail_remaining()
            self._raise_device_fault()

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- admission -------------------------------------------------------

    def submit(self, datum: Any, timeout: Optional[float] = None, trace: Any = None,
               priority: Optional[str] = None, tenant: Optional[str] = None) -> Future:
        """Enqueue one datum; a Future of its prediction row.

        ``timeout`` (seconds) is the request's deadline. Raises typed:
        :class:`QueueFull` at capacity, :class:`Shed` when the deadline
        cannot be met given the learned service time and the queue, and
        :class:`EngineStopped` after shutdown or a device fault (chained to
        the fault). ``trace`` is a
        :class:`~keystone_tpu_torch.obs.context.TraceContext`: the replica
        records the request's queue wait and batch under its id.
        ``priority`` (``high`` / ``normal`` / ``low``) is its shedding
        class, ``tenant`` its weighted-fair share (``autoscale/qos.py``)."""
        if self._device_fault is not None:
            raise EngineStopped("the fleet stopped on a device fault") from self._device_fault
        now = time.monotonic()
        req = _Request(datum=datum, deadline=(now + timeout) if timeout is not None else None,
                       enqueued=now, trace=trace, priority=normalize_priority(priority),
                       tenant=str(tenant) if tenant else DEFAULT_TENANT)
        self._scheduler.admit(req)  # counts "submitted" under its lock
        return req.future

    def predict(self, datum: Any, timeout: Optional[float] = None) -> Any:
        """Submit and wait; as the engine's, the wait ends
        :data:`~.engine.PREDICT_GRACE_S` past the deadline."""
        if not self._threads:
            raise RuntimeError("predict() needs a started fleet (call start() or use the "
                               "context manager)")
        fut = self.submit(datum, timeout=timeout)
        return fut.result(timeout=None if timeout is None else timeout + PREDICT_GRACE_S)

    # -- the fleet-wide swap -----------------------------------------------

    def swap(self, fitted: FittedPipeline, *, warmup: Optional[bool] = None,
             canary_fraction: float = 0.0, canary_batches: int = 4,
             canary_timeout_s: float = 30.0, atol: float = 1e-5, rtol: float = 1e-5,
             max_latency_ratio: Optional[float] = None) -> dict:
        """Replace the served model fleet-wide with no downtime.

        The replacement compiles strictly and warms every bucket on every
        replica off the serving path; then the replicas flip (each batch
        runs whole on one chain, admission never pauses, nothing is
        dropped).

        With ``canary_fraction > 0`` a shadow phase first mirrors that
        fraction of live batches through the candidate, after their answers
        are out, and compares outputs (``atol`` / ``rtol``) and latency. A
        mismatch, or a latency ratio above ``max_latency_ratio``, rolls
        back: the candidate is dropped, the old model serves on, and
        :class:`CanaryMismatch` carries the evidence. The phase ends after
        ``canary_batches`` mirrored batches or ``canary_timeout_s`` seconds
        (a quiet fleet promotes on what arrived). A kernel or device fault
        of the candidate is no mismatch: it stops the fleet and is raised.

        Returns a report: replicas flipped, signatures warmed, compiles and
        AOT loads paid, the canary's verdict and the new version."""
        check_swap_contract(fitted, self._policy)
        with self._swap_lock:
            with self._lifecycle_lock:
                if self._closed:
                    self._raise_device_fault()
                    raise EngineStopped("fleet is draining / shut down")
            # compile, warm-up and canary run without the lifecycle lock, so
            # a shutdown is never held up; _promote checks closed again
            compiles_before = self._metrics.count("compiles")
            loads_before = self._metrics.count("aot_loads")
            candidate = compile_pipeline(fitted, metrics=self._metrics,
                                         signatures=self._compiled_signatures, label="serving")
            warmed = 0
            if (warmup or warmup is None) and self._policy.datum_shape is not None:
                inputs = list(self._policy.warmup_inputs())
                self._warm_inputs(candidate, inputs)
                warmed = len(inputs)
            elif warmup is True:
                raise ValueError("swap(warmup=True) but no datum shape is known — the fleet "
                                 "cannot pre-pay the replacement's compiles")
            canary_report = None
            if canary_fraction > 0:
                canary_report = self._run_canary(
                    candidate, fraction=canary_fraction, target_batches=canary_batches,
                    timeout_s=canary_timeout_s, atol=atol, rtol=rtol,
                    max_latency_ratio=max_latency_ratio)
            return self._promote(fitted, candidate, warmed, canary_report, compiles_before,
                                 loads_before)

    def _promote(self, fitted, candidate, warmed, canary_report, compiles_before,
                 loads_before) -> dict:
        with self._lifecycle_lock:
            self._raise_device_fault()
            if self._closed:
                raise EngineStopped("fleet shut down during the swap — nothing promoted")
            # the flip: one reference store a replica, each batch whole on
            # the chain it read at dispatch. The published version moves
            # first under the supervise lock, so a restart racing the flip
            # pins to the candidate too.
            with self._supervise_lock:
                self._model_version += 1
                self._model_digest = getattr(candidate.dispatcher, "digest", None)
                self._published_exec = candidate
                version = self._model_version
                for rep in self._replicas:
                    rep.flip(candidate)
                    rep.version = version
            self._fitted = fitted
            self._metrics.inc("swaps")
            report = {"replicas_flipped": len(self._replicas), "buckets_warmed": warmed,
                      "compiles": self._metrics.count("compiles") - compiles_before,
                      "aot_loads": self._metrics.count("aot_loads") - loads_before,
                      "canary": canary_report, "version": version}
            flight.record_instant("serve.swap", version=version, replicas=len(self._replicas),
                                  buckets_warmed=warmed)
            tracer = _trace_current()
            if tracer is not None:
                with tracer.span("serve.swap", op_type="ServingFleet",
                                 replicas=len(self._replicas), version=version,
                                 buckets_warmed=warmed, compiles=report["compiles"],
                                 aot_loads=report["aot_loads"],
                                 canary="pass" if canary_report else None,
                                 queue_depth=self._scheduler.depth, live=bool(self._threads)):
                    pass
            logger.info("fleet swap: model replaced on %d replica(s) (%d signature(s) warmed, "
                        "%d traced, %d AOT-loaded%s)", len(self._replicas), warmed,
                        report["compiles"], report["aot_loads"],
                        (f"; canary pass on {canary_report['batches_compared']} mirrored "
                         "batch(es)" if canary_report else ""))
            return report

    def _run_canary(self, candidate, *, fraction: float, target_batches: int, timeout_s: float,
                    atol: float, rtol: float, max_latency_ratio: Optional[float]) -> dict:
        """Mirror live traffic through ``candidate``: raise
        :class:`CanaryMismatch` on an output mismatch or a latency blow-up,
        re-raise a device fault of the candidate, else the pass report."""
        shadow = _Shadow(candidate, fraction=fraction, target_batches=target_batches,
                         atol=atol, rtol=rtol)
        for rep in self._replicas:
            rep.set_shadow(shadow.observe)
        try:
            # polled, so a shutdown or a device fault mid-canary ends the
            # window at once
            deadline = time.monotonic() + timeout_s
            while not shadow.wait(0.2):
                if (self._closed or self._device_fault is not None
                        or time.monotonic() >= deadline):
                    break
        finally:
            for rep in self._replicas:
                rep.set_shadow(None)
        if shadow.fault is not None:
            self._on_device_fault(shadow.fault, None)
        self._raise_device_fault()
        report = shadow.report()
        ratio = report.get("latency_ratio")
        too_slow = max_latency_ratio is not None and ratio is not None and ratio > max_latency_ratio
        if report["mismatches"] or too_slow:
            self._metrics.inc("canary_fail")
            why = (f"{report['mismatches']} mismatched batch(es) of "
                   f"{report['batches_compared']} mirrored" if report["mismatches"]
                   else f"candidate latency ratio {ratio:.2f} exceeds {max_latency_ratio}")
            logger.warning("fleet canary FAILED — rolling back: %s", why)
            flight.record_instant("serve.canary_rollback", mismatches=report["mismatches"],
                                  batches_compared=report["batches_compared"],
                                  latency_ratio=ratio)
            flight.dump("canary_rollback")
            raise CanaryMismatch(f"canary auto-rollback: {why}; the fleet is still serving the "
                                 "previous model", report)
        self._metrics.inc("canary_pass")
        return report


def _leaves(out: Any) -> list:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


class _Shadow:
    """Mirrors sampled live batches through a candidate chain and gathers
    the comparison's evidence. Installed as every replica's shadow hook
    during a canaried swap; thread-safe (N replicas call ``observe``).

    A Python-level failure of the candidate is a mismatch, as in the JAX
    package; a kernel or device fault is kept in :attr:`fault` and ends
    the window, for the swap to stop the fleet and raise it."""

    def __init__(self, candidate, *, fraction: float, target_batches: int, atol: float,
                 rtol: float):
        self._candidate = candidate
        # deterministic sampling: every k-th finished batch mirrors
        self._every = max(1, int(round(1.0 / max(fraction, 1e-9))))
        self._target = max(1, int(target_batches))
        self._atol = atol
        self._rtol = rtol
        self._lock = threading.Lock()
        self._seen = 0
        self._compared = 0
        self._n_mismatch = 0  # the full count; the details below are capped
        self._mismatches: list = []
        self._ratios: list = []
        self._done = threading.Event()
        #: the candidate's kernel or device fault, None while none
        self.fault: Optional[BaseException] = None

    def observe(self, replica, padded, primary_out, n_valid, bucket) -> None:
        with self._lock:
            self._seen += 1
            if self._compared >= self._target or self.fault is not None:
                self._done.set()
                return
            if (self._seen - 1) % self._every:
                return
        t0 = time.perf_counter()
        try:
            # on the replica's lane and stream: the candidate's graphs for
            # this replica were captured at the swap's warm-up
            cand = replica.run_chain(self._candidate, padded)
        except Exception as e:
            with self._lock:
                if is_device_fault(e):
                    self.fault = e
                else:
                    # a candidate that cannot run its bucket is the clearest
                    # mismatch; the live batch is already answered
                    self._compared += 1
                    self._n_mismatch += 1
                    if len(self._mismatches) < 8:
                        self._mismatches.append({"replica": replica.index, "bucket": bucket,
                                                 "error": repr(e)[:200]})
                self._done.set()
            return
        cand_s = time.perf_counter() - t0
        primary_leaves, cand_leaves = _leaves(primary_out), _leaves(cand)
        detail = None
        if len(primary_leaves) != len(cand_leaves):
            detail = {"structure": "output tree shape differs"}
        else:
            for a, b in zip(primary_leaves, cand_leaves):
                a, b = np.asarray(a)[:n_valid], np.asarray(b)[:n_valid]
                if a.shape != b.shape:
                    detail = {"shapes": [list(a.shape), list(b.shape)]}
                    break
                if not np.allclose(a, b, atol=self._atol, rtol=self._rtol):
                    diff = np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))
                    detail = {"max_abs_diff": float(diff)}
                    break
        with self._lock:
            self._compared += 1
            if replica.last_exec_seconds:
                self._ratios.append(cand_s / replica.last_exec_seconds)
            if detail is not None:
                self._n_mismatch += 1
                if len(self._mismatches) < 8:
                    detail.update({"replica": replica.index, "bucket": bucket})
                    self._mismatches.append(detail)
            if detail is not None or self._compared >= self._target:
                # a mismatch decides the verdict: the swap wakes and rolls back
                self._done.set()

    def wait(self, timeout_s: float) -> bool:
        return self._done.wait(timeout=timeout_s)

    def report(self) -> dict:
        with self._lock:
            return {"batches_compared": self._compared, "mismatches": self._n_mismatch,
                    "mismatch_details": list(self._mismatches),
                    "latency_ratio": (round(statistics.median(self._ratios), 3)
                                      if self._ratios else None)}
