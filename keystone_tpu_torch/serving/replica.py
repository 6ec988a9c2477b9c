"""The serving worker: one replica is one compiled chain behind one batch
loop (port of ``keystone_tpu/serving/replica.py``).

:class:`~keystone_tpu_torch.serving.engine.ServingEngine` runs this worker
with its gather-then-dispatch batch source. The replica owns:

* the **compiled-chain reference**, read once per batch at dispatch, so a
  swap is one reference store and every micro-batch runs whole on one
  chain, never a mix;
* the **batch discipline**: deadline expiry, per-request validation
  isolation, padding to the bucket, one host-to-device copy, the replay,
  one device-to-host copy, per-request results, the queue-age, latency and
  occupancy metrics, and the ``serve.microbatch`` span.

:func:`compile_pipeline` builds the chain the replica serves: a private
CUDA graph per bucket shape over ``FittedPipeline._build_trace_fn()``,
never ``fitted.compile()``, which would replace the pipeline's own
compiled state. On a CPU pipeline the chain runs eagerly with the same
accounting.

With an AOT executable cache configured (``compile.configure``,
``--aot-cache``), the chain's per-bucket programs come from
``compile/aot.py``'s dispatcher: loaded from the cache on a warm boot (the
``aot_loads`` counter, zero traces), exported and saved on a miss (the
``compiles`` counter), and captured as one CUDA graph a bucket either way.

Each batch leaves one span summary in the always-on flight recorder
(``obs/flight.py``) and samples the device-memory watermark
(``obs/resource.py``). Not ported yet: the per-request cost split by
tenant (the port's requests carry no tenant until the fleet's
quality-of-service identity), the cross-process trace hooks, and the
fleet's parts.
"""

from __future__ import annotations

import contextlib
import logging
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..faults import REPLICA_BATCH, ReplicaDown, fault_point, is_transient
from ..obs import flight, resource
from ..obs.tracer import current as _trace_current
from ..utils import timing
from ..workflow.pipeline import FittedPipeline, NotTraceableError, _Compiled, _param_device
from .batching import BucketPolicy
from .errors import DeadlineExceeded, EngineStopped, InvalidRequest
from .metrics import MetricsRegistry

logger = logging.getLogger(__name__)

#: sentinel a batch source returns to stop the replica's loop
STOP = object()


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
    #: the QoS class its latency is filed under
    priority: str = "normal"


# ---------------------------------------------------------------------------
# the compile path
# ---------------------------------------------------------------------------


def _to_host(res: Any) -> Any:
    """A chain's output copied to host numpy arrays (one device-to-host copy
    a tensor): what a replay's static output is read into before the next
    replay overwrites it."""
    if isinstance(res, (tuple, list)):
        return tuple(_to_host(r) for r in res)
    return res.detach().cpu().numpy()


def _row(out: Any, i: int) -> Any:
    if isinstance(out, tuple):
        return tuple(_row(o, i) for o in out)
    return out[i]


class ServedChain:
    """A fitted chain as the replica serves it: a padded numpy batch in,
    host numpy arrays out. The batch is copied once to where the chain's
    parameters live and run through the private compiled chain (on CUDA a
    graph replay per bucket shape); the output is copied out under the
    graphs' lock.

    With an AOT dispatcher (``compile/aot.py``) the graphs are captured over
    its per-bucket program, loaded from the cache or freshly exported;
    without one, over the chain's trace function."""

    def __init__(self, fitted: FittedPipeline, note: Callable[[tuple], None],
                 dispatcher: Optional[Callable] = None):
        self.device = _param_device(fitted.graph)
        #: the AOT dispatcher, None when the chain serves without a cache
        self.dispatcher = dispatcher
        if dispatcher is None:
            self._compiled = _Compiled(fitted._build_trace_fn(), note)
        else:
            # the dispatcher counts the traces; a capture is not one
            self._compiled = _Compiled(dispatcher, lambda sig: None)

    @property
    def captures(self) -> int:
        """The CUDA graphs captured so far (one per bucket on the card)."""
        return len(self._compiled._graphs)

    def __call__(self, batch: Any) -> Any:
        x = torch.as_tensor(batch).to(self.device)
        return self._compiled(x, _to_host)


def compile_pipeline(fitted: FittedPipeline, *, metrics: MetricsRegistry,
                     signatures: list, label: str = "serving") -> ServedChain:
    """``fitted`` compiled against private accounting: each trace paid (each
    capture, or each new signature on the CPU; with an AOT cache, each
    export) appends its ``(shape, dtype)`` to ``signatures`` and bumps the
    ``compiles`` counter, and each program loaded from the cache bumps
    ``aot_loads`` instead, so a warm boot pays zero traces. Raises
    :class:`NotTraceableError` for a chain that cannot be compiled, here at
    construction and never per request under traffic."""
    # one static check gives the blockers and the export verdict; the chain
    # is built from the fitted graph directly
    report = fitted.check(span=False)
    blockers = report.untraceable_labels()
    if blockers:
        raise NotTraceableError(blockers)

    def note(sig):
        signatures.append(sig)
        metrics.inc("compiles")

    def note_load(sig):
        # not a compiled signature: no trace was paid for this bucket
        metrics.inc("aot_loads")

    dispatcher = fitted._aot_dispatcher(fitted._build_trace_fn(), "auto", note,
                                        exportable=report.exportable, label=label,
                                        on_load=note_load)
    return ServedChain(fitted, note, dispatcher)


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
    engine is a restart, not a swap. A mismatch raises the node-attributed
    ``ContractMismatchError``."""
    serving_report(fitted).require_contract(policy.datum_shape, policy.dtype, verb="swap")


# ---------------------------------------------------------------------------
# the replica worker
# ---------------------------------------------------------------------------


class Replica:
    """One serving worker: a compiled-chain reference and the batch loop.
    The batching policy lives in the ``source`` handed to
    :meth:`serve_forever`; the replica runs what the source forms."""

    def __init__(self, compiled: Callable, policy: BucketPolicy, metrics: MetricsRegistry, *,
                 index: Optional[int] = None, log_interval_s: float = 10.0):
        #: the position among several workers, None for a single one (the
        #: engine): None keeps per-replica rows out of the snapshot
        self.index = index
        self._compiled = compiled
        self._policy = policy
        self._metrics = metrics
        self._log_interval = log_interval_s

    @property
    def compiled(self) -> Callable:
        return self._compiled

    def flip(self, compiled: Callable) -> None:
        """The swap: one reference store, read once per batch at dispatch,
        so each batch runs whole on one chain."""
        self._compiled = compiled

    # -- the loop -------------------------------------------------------

    def serve_forever(self, source) -> None:
        """Run batches from ``source`` until it returns :data:`STOP`.
        ``source.next_batch(replica)`` returns a request list, None (poll
        again) or STOP; ``source.batch_done(batch, replica)`` runs after
        every batch, failed or not.

        ``run_batch`` answers every request of a failed batch; any other
        ``Exception`` fails the unanswered ones as an internal failure, and
        the loop goes on. A ``BaseException`` (an injected
        ``ReplicaKilled``, interpreter shutdown) escapes with the unanswered
        requests attached as ``pending``."""
        while True:
            batch = source.next_batch(self)
            if batch is STOP:
                return
            if batch:
                try:
                    self.run_batch(batch)
                except Exception:  # run_batch isolates; this is the backstop
                    logger.exception("serving replica %s: unexpected batch failure", self.index)
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
                    source.batch_done(batch, self)
            try:
                # user gauges run inside snapshot(); one that raises must
                # not end the worker
                self._metrics.maybe_log(self._log_interval)
            except Exception:
                logger.exception("serving replica: metrics logging failed")

    # -- one batch --------------------------------------------------------

    def run_batch(self, batch: Sequence[_Request]) -> int:
        """Run one micro-batch through the current chain. Returns the number
        of requests answered with a result. A failure of the batch fails
        each of its requests with the error (a transient one, such as an
        injected fault, is counted apart: the single engine has no peer to
        retry on). A fault at the seam that is not transient propagates to
        :meth:`serve_forever`'s backstop."""
        try:
            # the fault seam, before any future is marked running: a kill
            # escapes as ReplicaDown, a transient fault fails the batch
            # (counted apart), and any other fault reaches the loop's
            # backstop, which answers "internal batch failure"
            fault_point(REPLICA_BATCH, replica=self.index)
        except ReplicaDown:
            raise
        except Exception as e:
            if not is_transient(e):
                raise
            self._fail(batch, e)
            return 0
        now = time.monotonic()
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
            self._metrics.observe_queue_age(now - r.enqueued)
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
        tracer = _trace_current()
        t0 = time.perf_counter()
        try:
            # the span is not named "serve.batch" (the phase's name), so an
            # export joining phases and spans has no clash
            span_attrs = {"items": len(valid), "bucket": bucket}
            if self.index is not None:
                span_attrs["replica"] = self.index
            with contextlib.ExitStack() as stack:
                if tracer is not None:
                    stack.enter_context(tracer.span("serve.microbatch", op_type="Replica",
                                                    **span_attrs))
                with timing.phase("serve.batch"):
                    # the copy in, the replay and the copy out: the output
                    # is on the host when this returns
                    out = compiled(padded)
        except Exception as e:  # a batch-level failure: every member errors
            self._fail(valid, e)
            return 0
        # with tracing off, this summary is what a post-mortem dump shows the
        # replica doing in the seconds before its trigger
        flight.record_span("serve.microbatch", time.perf_counter() - t0, items=len(valid),
                           bucket=bucket, replica=self.index)

        done = time.monotonic()
        for i, r in enumerate(valid):
            try:
                r.future.set_result(_row(out, i))
            except Exception:  # already settled by a bounded shutdown: the
                continue       # rest of the batch still gets its answers
            self._metrics.observe_latency(done - r.enqueued, priority=r.priority)
        self._metrics.inc("completed", len(valid))
        self._metrics.observe_batch(len(valid), bucket, replica=self.index)
        # the batch seam of the device-memory watermark (throttled)
        resource.sample_memory()
        return len(valid)

    def _fail(self, requests: Sequence[_Request], error: Exception) -> None:
        if is_transient(error):
            self._metrics.inc("batch_transient")
        self._metrics.inc("batch_errors")
        for r in requests:
            settle_future(r.future, error)
