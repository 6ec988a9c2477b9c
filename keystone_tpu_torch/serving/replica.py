"""The serving worker: one replica is one compiled chain behind one batch
loop (port of ``keystone_tpu/serving/replica.py``).

:class:`~keystone_tpu_torch.serving.engine.ServingEngine` (one replica,
gather-then-dispatch batching) and
:class:`~keystone_tpu_torch.serving.fleet.ServingFleet` (N replicas behind
one continuous-batching scheduler) both run this worker; they differ only
in the batch source that forms each micro-batch. The replica owns:

* the **compiled-chain reference**, read once per batch at dispatch, so a
  swap is one reference store and every micro-batch runs whole on one
  chain, never a mix;
* **device pinning**: a replica placed on a CUDA device
  (``parallel/placement.py``) copies its batches in, replays its own CUDA
  graphs and copies out on a ``torch.cuda.Stream`` of its own, so
  co-resident replicas overlap one another's host work and replays;
* the **batch discipline**: deadline expiry, per-request validation
  isolation, padding to the bucket, one host-to-device copy, the replay,
  one device-to-host copy, per-request results, the queue-age, latency and
  occupancy metrics, the batch span, and the ``serve.queue`` span of a
  request that carries a trace context (``obs/context.py``);
* the **failure discipline**: a transient batch failure hands its requests
  back to a source that can requeue them (the fleet scheduler), a kernel
  or device fault goes to the fleet's handler instead (the card's fault, so
  neither a restart nor a peer on the card would get past it), and
  ``quarantine_after`` consecutive failed batches raise
  :class:`ReplicaQuarantined` to the fleet's supervisor;
* the **shadow hook**: during a canaried swap the fleet mirrors finished
  batches through the candidate after their results are handed out, so the
  comparison adds no latency to live requests.

:func:`compile_pipeline` builds the chain a replica serves, a
:class:`ServedChain`: one trace function a model version (or, with an AOT
executable cache, one program a bucket from ``compile/aot.py``'s
dispatcher), and on the card one CUDA graph a bucket **per replica**, each
captured on the replica's stream into its own static buffers over the one
set of model tensors. ``compiles`` counts the distinct bucket signatures a
version paid; :attr:`ServedChain.captures` counts the graphs. The JAX
package shares one executable across replicas because XLA specializes it
per device; one shared graph would serialize the replicas on one lock and
one stream. :func:`compile_model` builds a fleet's version, a
:class:`ServedModel`: one served chain a physical device of the replicas,
each over that device's copy of the model
(``parallel.placement.copy_to_device``; the chain itself on its own
device), with one ``compiles`` count a signature over all of them.

Each batch leaves one span summary in the always-on flight recorder
(``obs/flight.py``), samples the device-memory watermark, and, with
``KEYSTONE_ACCOUNTING`` on, charges its seconds to its requests' tenants
(``obs/resource.py``).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..faults import REPLICA_BATCH, ReplicaDown, fault_point, is_transient
from ..obs import flight, resource
from ..obs.span import Span
from ..obs.tracer import current as _trace_current
from ..ops import is_device_fault
from ..parallel.mesh import physical
from ..utils import timing
from ..workflow.cuda_graph import dtype_name
from ..workflow.pipeline import FittedPipeline, NotTraceableError, _Compiled
from .batching import BucketPolicy
from .errors import DeadlineExceeded, EngineStopped, InvalidRequest
from .metrics import MetricsRegistry

logger = logging.getLogger(__name__)

#: sentinel a batch source returns to stop the replica's loop
STOP = object()


class ReplicaQuarantined(ReplicaDown):
    """The circuit breaker tripped: this replica failed ``quarantine_after``
    consecutive batches, so its loop exits and the fleet's supervisor takes
    over (requeues its work, restarts it within the restart budget). A
    ``BaseException`` like its base, so it passes the loop's backstop."""


class _TransientBatchFault(Exception):
    """A batch failed for a transient reason (an injected fault, a flaky
    copy): its unanswered requests go back to the source to be requeued
    rather than failed, since a retry elsewhere is expected to succeed.
    ``pending`` is those requests, ``cause`` the original error."""

    def __init__(self, cause: BaseException, pending: list):
        super().__init__(str(cause))
        self.cause = cause
        self.pending = pending


def settle_future(fut: Future, exc: BaseException) -> bool:
    """Answer a request future with ``exc`` whether it is still pending or
    already running (taken into a batch that never finished). True when
    this call delivered the answer."""
    if fut.done():
        return False
    try:
        try:
            live = fut.set_running_or_notify_cancel()
        except Exception:  # already running: settle it
            live = True
        if not live:
            return False  # cancelled by the caller
        fut.set_exception(exc)
        return True
    except Exception:  # lost the set-once race: the other answer stands
        return False


@dataclass
class _Request:
    datum: Any
    deadline: Optional[float]  # a time.monotonic() reading, or None
    enqueued: float
    future: Future = field(default_factory=Future)
    #: times this request was requeued off a failed replica: bounds the
    #: reroute loop of a request without a deadline, which the shed test
    #: can never retire
    hops: int = 0
    #: the trace context of a sampled request (``obs/context.py``): the
    #: replica records its queue wait and batch under this identity
    trace: Any = None
    #: QoS identity (``autoscale/qos.py``): ``priority`` is the shedding
    #: axis (low sheds before high), ``tenant`` the fairness axis. Carried
    #: on the request, so a requeue clone or a steal keeps both.
    priority: str = "normal"
    tenant: str = "default"


# ---------------------------------------------------------------------------
# the compile path
# ---------------------------------------------------------------------------


def _to_host(res: Any) -> Any:
    """A chain's output copied to host numpy arrays (one device-to-host copy
    a tensor, which waits for the stream's work before it): what a replay's
    static output is read into before the next replay overwrites it."""
    if isinstance(res, (tuple, list)):
        return tuple(_to_host(r) for r in res)
    return res.detach().cpu().numpy()


def _row(out: Any, i: int) -> Any:
    if isinstance(out, tuple):
        return tuple(_row(o, i) for o in out)
    return out[i]


class ServedChain:
    """A fitted chain as replicas serve it: a padded numpy batch in, host
    numpy arrays out. The batch is copied once to where the chain's
    parameters live and run through the compiled chain of the caller's
    ``lane`` (on CUDA, that lane's graph replay a bucket shape); the output
    is copied out under that lane's lock, on the caller's ``stream``.

    One trace function (or AOT dispatcher) serves every lane; each lane
    keeps its own CUDA graphs, static buffers and capture stream, so lanes
    replay concurrently. The first lane to meet a signature notes it (the
    ``compiles`` counter); every lane's capture counts in
    :attr:`captures`. An ``eager`` chain (one with a host step, see
    :func:`compile_pipeline`) runs its forwards on every call, uncaptured."""

    def __init__(self, fitted: FittedPipeline, note: Callable[[tuple], None],
                 dispatcher: Optional[Callable] = None, eager: bool = False, *,
                 device: Any):
        #: the chain this serves (on a fleet, its device's copy of the model)
        self.fitted = fitted
        #: where batches run: the physical device the chain's tensors are on
        self.device = physical(device)
        #: the AOT dispatcher, None when the chain serves without a cache
        self.dispatcher = dispatcher
        #: True for a chain with a host step: every batch runs the chain's
        #: forwards, uncaptured (:func:`compile_pipeline`)
        self.eager = bool(eager)
        if dispatcher is None:
            self._fn, self._note = fitted._build_trace_fn(), note
        else:
            # the dispatcher counts the exports and loads; a capture is
            # neither
            self._fn, self._note = dispatcher, None
        self._lock = threading.Lock()
        self._noted: set = set()
        self._lanes: Dict[Any, _Compiled] = {}

    def _note_once(self, sig: tuple) -> None:
        with self._lock:
            if sig in self._noted:
                return
            self._noted.add(sig)
        if self._note is not None:
            self._note(sig)

    def _lane(self, lane: Any) -> _Compiled:
        with self._lock:
            compiled = self._lanes.get(lane)
            if compiled is None:
                compiled = self._lanes[lane] = _Compiled(self._fn, self._note_once)
            return compiled

    @property
    def captures(self) -> int:
        """The CUDA graphs captured so far, over every lane (one a bucket
        and lane on the card)."""
        with self._lock:
            lanes = list(self._lanes.values())
        return sum(len(c._graphs) for c in lanes)

    def __call__(self, batch: Any, lane: Any = None,
                 stream: Optional[torch.cuda.Stream] = None) -> Any:
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            x = torch.as_tensor(batch).to(self.device)
            if self.eager:
                self._note_once((tuple(x.shape), dtype_name(x.dtype)))
                return _to_host(self._fn(x))
            return self._lane(lane)(x, _to_host)


def compile_pipeline(fitted: FittedPipeline, *, metrics: MetricsRegistry,
                     signatures: list, label: str = "serving") -> ServedChain:
    """``fitted`` compiled against private accounting: each signature paid
    (its first capture over any lane on the card, its first run on the CPU;
    with an AOT cache, each export) appends its ``(shape, dtype)`` to
    ``signatures`` and bumps the ``compiles`` counter, and each program
    loaded from the cache bumps ``aot_loads`` instead, so a warm boot pays
    zero traces. Raises :class:`NotTraceableError` for a chain that cannot
    be compiled, here at construction and never per request under
    traffic.

    One exception: a chain whose only blockers are host steps (nodes whose
    operator sets ``host_step = True`` and whose verdict is
    ``host_callback``: a host sync that is the node's purpose, as a
    ``jax.pure_callback`` is in the JAX package) is served eagerly. A CUDA
    graph would run such a step once, at capture, and never on replay; run
    eagerly, every batch runs it. Such a chain exports nothing, so it has no
    AOT programs either."""
    (chain,) = compile_model(fitted, [None], metrics=metrics, signatures=signatures,
                             label=label).chains.values()
    return chain


class ServedModel:
    """One model version as a fleet serves it: a :class:`ServedChain` a
    physical device of the replicas, each over that device's copy of the
    model (the published chain itself on its own device)."""

    def __init__(self, fitted: FittedPipeline, chains: Dict[torch.device, ServedChain]):
        self.fitted = fitted
        self._chains = chains

    @property
    def chains(self) -> Dict[torch.device, ServedChain]:
        return dict(self._chains)

    def chain_for(self, device: Any) -> ServedChain:
        """The chain a replica on ``device`` serves."""
        return self._chains[physical(device)]

    @property
    def copies(self) -> int:
        """The chains that serve a copy of the model (one a device other
        than the model's own)."""
        return sum(1 for c in self._chains.values() if c.fitted is not self.fitted)

    @property
    def captures(self) -> int:
        return sum(c.captures for c in self._chains.values())

    @property
    def digest(self) -> Optional[str]:
        """The content fingerprint (every copy's is the source's), None
        without an AOT cache."""
        return next((c.dispatcher.digest for c in self._chains.values()
                     if c.dispatcher is not None), None)

    def release(self) -> None:
        """Drop every chain: a rolled-back candidate's copies and their
        graphs are freed even while its exception is held."""
        self._chains.clear()


def compile_model(fitted: FittedPipeline, devices: Sequence[Any], *, metrics: MetricsRegistry,
                  signatures: list, label: str = "serving",
                  home: Optional[torch.device] = None) -> ServedModel:
    """``fitted`` as :func:`compile_pipeline` compiles it, once a distinct
    physical device of ``devices`` (None: its home). On ``home`` (found by
    ``parallel.placement.home_device`` unless given) the chain is
    ``fitted`` itself; on any other device it is
    ``copy_to_device(fitted, device)``. So a version on one device walks
    the chain once and copies nothing. The chains share one account: a
    signature is one compile however many devices pay it (an AOT cache
    exports it once a backend, the program's environment, so ``compiles``
    counts distinct signatures fleet-wide, not exports), and every program
    loaded is one ``aot_load``."""
    from ..parallel.placement import copy_to_device, home_device

    # one static check gives the blockers and the export verdict; the
    # chains are built from the fitted graph (or its copy) directly
    report = fitted.check(span=False)
    blockers = report.untraceable_labels()
    if blockers and not _host_steps_only(fitted, report):
        raise NotTraceableError(blockers)
    lock = threading.Lock()
    noted: set = set()

    def note(sig):
        with lock:
            if sig in noted:
                return
            noted.add(sig)
        signatures.append(sig)
        metrics.inc("compiles")

    def note_load(sig):
        # not a compiled signature: no trace was paid for this bucket
        metrics.inc("aot_loads")

    home = home_device(fitted) if home is None else physical(home)
    chains: Dict[torch.device, ServedChain] = {}
    for device in devices:
        device = home if device is None else physical(device)
        if device in chains:
            continue  # slots of one device share its chain
        chain = fitted if device == home else copy_to_device(fitted, device)
        if blockers:
            served = ServedChain(chain, note, eager=True, device=device)
        else:
            dispatcher = chain._aot_dispatcher(
                chain._build_trace_fn(), "auto", note, exportable=report.exportable,
                label=label, on_load=note_load, device=device)
            served = ServedChain(chain, note, dispatcher, device=device)
        chains[served.device] = served
    return ServedModel(fitted, chains)


def _host_steps_only(fitted: FittedPipeline, report) -> bool:
    """Is every node that blocks capture a declared host step?"""
    from ..check.lattice import HOST_CALLBACK

    blocking = report.untraceable_nodes()
    return bool(blocking) and all(
        report.verdicts.get(n) == HOST_CALLBACK
        and getattr(fitted.graph.get_operator(n), "host_step", False) for n in blocking)


def serving_report(fitted: FittedPipeline):
    """The static check report of a pipeline about to serve: the datum
    contract (the fit-time hint) and the verdicts every serving validation
    reads. One call, zero executions."""
    return fitted.check(span=False)


def serving_contract(fitted: FittedPipeline, datum_shape: Optional[Sequence[int]], dtype: Any,
                     *, verb: str = "serve", report=None):
    """The per-item ``(shape, dtype)`` contract, with chains the bucket
    padding would corrupt refused through the static checker's report, so
    the refusal names the node. Explicit arguments win; otherwise the
    contract recorded on the fitted pipeline at fit time."""
    if report is None:
        report = serving_report(fitted)
    # bucket padding repeats rows, so a node with whole-batch statistics
    # would fold the padding into every real request's answer; an open
    # shape and dtype check only the coupling here
    report.require_contract(None, None, verb=verb)
    # shape and dtype fall back apart: an explicit shape must not drop the
    # recorded dtype (float32 buckets for float64 traffic would recapture)
    if datum_shape is None:
        datum_shape = report.datum_shape
    if dtype is None:
        dtype = report.datum_dtype or "float32"
    return datum_shape, dtype


def check_swap_contract(fitted: FittedPipeline, policy: BucketPolicy) -> None:
    """A replacement must meet the live datum contract (shape and dtype)
    and must not be batch-coupled: re-bucketing or re-shaping a live
    engine or fleet is a restart, not a swap. A mismatch raises the
    node-attributed ``ContractMismatchError``."""
    serving_report(fitted).require_contract(policy.datum_shape, policy.dtype, verb="swap")


# ---------------------------------------------------------------------------
# the replica worker
# ---------------------------------------------------------------------------


class Replica:
    """One serving worker: a compiled-chain reference, an optional pinned
    device, and the batch loop. The batching policy lives in the ``source``
    handed to :meth:`serve_forever`; the replica runs what the source
    forms.

    ``on_device_fault(error, replica)``, when given (the fleet), takes a
    kernel or device fault of a batch after the batch's requests have been
    answered with it; without it (the engine) such a batch fails like any
    other."""

    def __init__(self, compiled: ServedChain, policy: BucketPolicy, metrics: MetricsRegistry, *,
                 index: Optional[int] = None, device: Any = None,
                 span_name: str = "serve.replica", log_interval_s: float = 10.0,
                 quarantine_after: int = 0,
                 on_device_fault: Optional[Callable[[BaseException, "Replica"], None]] = None):
        #: the position among several workers, None for a single one (the
        #: engine): None keeps per-replica rows out of the snapshot
        self.index = index
        self.device = None if device is None else torch.device(device)
        #: the stream this replica's copies and replays run on (a CUDA
        #: device only; None replays on the calling thread's stream)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device is not None and self.device.type == "cuda" else None)
        self._compiled = compiled
        self._policy = policy
        self._metrics = metrics
        self._span_name = span_name
        self._log_interval = log_interval_s
        self._shadow: Optional[Callable] = None
        self._on_device_fault = on_device_fault
        #: seconds of the last executed batch: the copy in, the replay and
        #: the copy out, which waits for the card, so the fleet scheduler's
        #: service estimate learns the device's time, not the launch's
        self.last_exec_seconds: Optional[float] = None
        #: the circuit breaker: this many consecutive failed batches raise
        #: :class:`ReplicaQuarantined` out of the loop (0: off, the engine,
        #: which has no supervisor to catch it)
        self.quarantine_after = int(quarantine_after)
        self.consecutive_failures = 0
        #: the batch running now, for the fleet's bounded shutdown to fail
        #: if this worker wedges (None between batches)
        self.current_batch: Optional[list] = None
        #: the model version this replica serves, stamped by the fleet at
        #: construction and at every flip (the skew check of long rollouts)
        self.version: int = 0

    @property
    def compiled(self) -> ServedChain:
        return self._compiled

    def flip(self, compiled: ServedChain) -> None:
        """The swap: one reference store, read once per batch at dispatch,
        so each batch runs whole on one chain."""
        self._compiled = compiled

    def set_shadow(self, shadow: Optional[Callable]) -> None:
        """Install (or clear) the canary mirror: ``shadow(replica, padded,
        primary_out, n_valid, bucket)`` runs after a batch's results are
        handed out, so mirroring never delays a live answer."""
        self._shadow = shadow

    def run_chain(self, compiled: ServedChain, padded: Any) -> Any:
        """``padded`` through ``compiled`` on this replica's lane and
        stream, with the replica's card current (its captures, graph pool
        and kernels on that card): host arrays out, the card's work done."""
        if self.stream is None:
            return compiled(padded, lane=self.index)
        with torch.cuda.device(self.device):
            return compiled(padded, lane=self.index, stream=self.stream)

    # -- the loop -------------------------------------------------------

    def serve_forever(self, source) -> None:
        """Run batches from ``source`` until it returns :data:`STOP`.
        ``source.next_batch(replica)`` returns a request list, None (poll
        again) or STOP; ``source.batch_done(batch, replica)`` runs after
        every batch, failed or not.

        A transient batch failure requeues its unanswered requests through
        ``source.requeue_batch`` when the source has one (the fleet
        scheduler), and fails them otherwise (the engine). Any other
        ``Exception`` fails the unanswered ones as an internal failure, and
        the loop goes on. A ``BaseException`` (an injected
        ``ReplicaKilled``, the quarantine breaker, interpreter shutdown)
        escapes with the unanswered requests attached as ``pending``, so
        the fleet's supervisor can requeue them and restart the worker."""
        while True:
            batch = source.next_batch(self)
            if batch is STOP:
                return
            if batch:
                self.current_batch = batch
                try:
                    self.run_batch(batch)
                except _TransientBatchFault as e:
                    self._requeue_or_fail(e, source)
                except Exception:  # run_batch isolates; this is the backstop
                    logger.exception("serving replica %s: unexpected batch failure", self.index)
                    self.consecutive_failures += 1
                    for r in batch:
                        if not r.future.done():
                            settle_future(r.future, EngineStopped("internal batch failure"))
                except BaseException as e:
                    if getattr(e, "pending", None) is None:
                        try:
                            e.pending = [r for r in batch if not r.future.done()]
                        except Exception:  # an exception type that refuses attributes
                            logger.debug("could not attach pending batch to %r",
                                         type(e).__name__, exc_info=True)
                    raise
                finally:
                    self.current_batch = None
                    source.batch_done(batch, self)
                self._maybe_quarantine()
            try:
                # user gauges run inside snapshot(); one that raises must
                # not end the worker
                self._metrics.maybe_log(self._log_interval)
            except Exception:
                logger.exception("serving replica: metrics logging failed")

    def _requeue_or_fail(self, fault: _TransientBatchFault, source) -> None:
        """A transient failure's unanswered requests go back to the fleet,
        deadlines intact, or fail when the source cannot requeue (the
        engine)."""
        pending = [r for r in fault.pending if not r.future.done()]
        requeue = getattr(source, "requeue_batch", None)
        if requeue is not None and pending:
            n = requeue(pending, self, fault.cause)
            logger.warning("serving replica %s: transient batch failure (%s): requeued %d "
                           "of %d request(s) to peers", self.index, fault.cause, n, len(pending))
            return
        self._metrics.inc("batch_errors")
        for r in pending:
            settle_future(r.future, fault.cause)

    def _maybe_quarantine(self) -> None:
        if self.quarantine_after and self.consecutive_failures >= self.quarantine_after:
            raise ReplicaQuarantined(
                f"replica {self.index} circuit-broken after "
                f"{self.consecutive_failures} consecutive batch failures")

    # -- one batch --------------------------------------------------------

    def run_batch(self, batch: Sequence[_Request]) -> int:
        """Run one micro-batch through the current chain on this replica's
        device. Returns the number of requests answered with a result."""
        # cleared first: a batch that never runs must not leave the previous
        # batch's seconds for the scheduler to fold in again
        self.last_exec_seconds = None
        try:
            # the fault seam, before any future is marked running: a kill
            # escapes as ReplicaDown, a transient fault hands the batch back
            # for a requeue, and any other fault reaches the backstop
            fault_point(REPLICA_BATCH, replica=self.index)
        except ReplicaDown:
            raise
        except Exception as e:
            if is_transient(e):
                self._metrics.inc("batch_transient")
                self.consecutive_failures += 1
                raise _TransientBatchFault(e, list(batch)) from e
            raise
        now = time.monotonic()
        tracer = _trace_current()
        live = []
        for r in batch:
            if not r.future.set_running_or_notify_cancel():
                self._metrics.inc("cancelled")
                continue
            if r.deadline is not None and now > r.deadline:
                self._metrics.inc("expired")
                r.future.set_exception(DeadlineExceeded(
                    f"deadline passed {now - r.deadline:.4f}s before batching"))
                continue
            queue_age = now - r.enqueued
            self._metrics.observe_queue_age(queue_age)
            if r.trace is not None and tracer is not None:
                # a traced request's queue wait: a finished span dated back
                # over the enqueued-to-dispatched window
                end = time.perf_counter()
                tracer.record_complete(Span(
                    name="serve.queue", start=end - queue_age, end=end,
                    op_type="FleetScheduler",
                    attrs={"trace_id": r.trace.trace_id, "replica": self.index,
                           "queue_age_s": round(queue_age, 6)}))
            live.append(r)

        valid, rows = [], []
        for r in live:
            try:
                rows.append(self._policy.validate(r.datum))
                valid.append(r)
            except InvalidRequest as e:
                self._metrics.inc("invalid")
                r.future.set_exception(e)
        if not valid:
            return 0

        bucket = self._policy.bucket_for(len(valid))
        padded = self._policy.pad(np.stack(rows), bucket)
        compiled = self._compiled  # one read: the whole batch runs on it
        traced_ids = [r.trace.trace_id for r in valid if r.trace is not None]
        t0 = time.perf_counter()
        try:
            # the span is not named "serve.batch" (the phase's name), so an
            # export joining phases and spans has no clash
            span_attrs = {"items": len(valid), "bucket": bucket}
            if self.index is not None:
                span_attrs["replica"] = self.index
            if traced_ids:
                # the batch span carries the first sampled member's id; the
                # others get their own spans over the batch below
                span_attrs["trace_id"] = traced_ids[0]
            with contextlib.ExitStack() as stack:
                if tracer is not None:
                    stack.enter_context(tracer.span(self._span_name, op_type="Replica",
                                                    **span_attrs))
                with timing.phase("serve.batch"):
                    # the copy in, the replay and the copy out: the output
                    # is on the host when this returns
                    out = self.run_chain(compiled, padded)
        except Exception as e:  # a batch-level failure: every member errors
            self.consecutive_failures += 1
            if is_device_fault(e) and self._on_device_fault is not None:
                # the card's fault: a peer or a restart on the card would
                # meet it again, so it is not requeued; the fleet fails
                # every admitted request with it and stops
                self._fail(valid, e)
                self._on_device_fault(e, self)
                return 0
            if is_transient(e):
                # a retry on a peer is expected to succeed: hand the batch
                # back instead of failing every member
                self._metrics.inc("batch_transient")
                raise _TransientBatchFault(e, valid) from e
            self._fail(valid, e)
            return 0
        self.last_exec_seconds = time.perf_counter() - t0
        self.consecutive_failures = 0
        # with tracing off, this summary is what a post-mortem dump shows the
        # replica doing in the seconds before its trigger
        flight.record_span(self._span_name, self.last_exec_seconds, items=len(valid),
                           bucket=bucket, replica=self.index)
        if len(traced_ids) > 1 and tracer is not None:
            # each further traced member owns a span over the shared batch
            # (at most 15 more, so a full bucket of sampled traffic does not
            # multiply the span volume)
            for extra in traced_ids[1:16]:
                tracer.record_complete(Span(
                    name=self._span_name, start=t0, end=t0 + self.last_exec_seconds,
                    op_type="Replica",
                    attrs={"trace_id": extra, "replica": self.index, "bucket": bucket,
                           "coalesced": True}))

        done = time.monotonic()
        for i, r in enumerate(valid):
            try:
                r.future.set_result(_row(out, i))
            except Exception:  # already settled by a bounded shutdown: the
                continue       # rest of the batch still gets its answers
            self._metrics.observe_latency(done - r.enqueued, priority=r.priority)
        self._metrics.inc("completed", len(valid))
        self._metrics.observe_batch(len(valid), bucket, replica=self.index)
        if resource.accounting_enabled():
            # the batch's seconds split across its members, keyed by each
            # request's (tenant, priority)
            for (tenant, priority), cost in resource.split_batch_cost(
                    valid, self.last_exec_seconds, now, payloads=rows).items():
                self._metrics.observe_cost(tenant, priority, **cost)
        # the batch seam of the device-memory watermark (throttled)
        resource.sample_memory()

        shadow = self._shadow
        if shadow is not None:
            # canary mirroring runs after the answers are out: the
            # candidate's cost lands on the worker, never on live latency
            try:
                shadow(self, padded, out, len(valid), bucket)
            except Exception:
                logger.exception("serving replica %s: canary shadow failed", self.index)
        return len(valid)

    def _fail(self, requests: Sequence[_Request], error: Exception) -> None:
        if is_transient(error):
            self._metrics.inc("batch_transient")
        self._metrics.inc("batch_errors")
        for r in requests:
            settle_future(r.future, error)
