"""The serving engine: admission queue → micro-batches → compiled chain
(port of ``keystone_tpu/serving/engine.py``).

Lifecycle: construct (the chain is compiled strictly, so a chain that
cannot be captured fails here with :class:`NotTraceableError`, not per
request under traffic), ``start()`` (captures one CUDA graph per bucket,
then admits traffic), ``submit`` / ``predict`` from any number of threads,
``drain()`` / ``shutdown()``. Also a context manager: ``with engine:``
starts and drains.

Batching: the worker blocks for the first queued request, then gathers
more until the largest bucket is full or ``max_wait_ms`` has passed.
Backpressure is a refusal at admission (:class:`QueueFull`) on a bounded
queue. A request may carry a deadline; one that expires while queued gets
:class:`DeadlineExceeded` instead of a batch slot. A datum that fails
validation gets :class:`InvalidRequest` while the rest of its micro-batch
completes.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Optional, Sequence

from ..obs.tracer import current as _trace_current
from ..workflow.pipeline import FittedPipeline
from .batching import BucketPolicy
from .errors import EngineClosed, EngineStopped, QueueFull
from .metrics import MetricsRegistry
from .replica import (
    STOP,
    Replica,
    _Request,
    check_swap_contract,
    compile_pipeline,
    serving_contract,
    settle_future,
)

logger = logging.getLogger(__name__)

#: how long past its deadline :meth:`ServingEngine.predict` waits for an
#: answer before it gives up on the worker
PREDICT_GRACE_S = 60.0


class ServingEngine:
    """Serves a :class:`FittedPipeline` to concurrent callers.

    Parameters
    ----------
    fitted:
        The estimator-free pipeline; compiled strictly at construction.
    buckets:
        Static batch-size buckets (largest = max micro-batch size).
    datum_shape / dtype:
        Per-item array contract. With ``datum_shape`` given, ``start()``
        captures every bucket before traffic. When omitted, the contract
        recorded on the fitted pipeline at fit time
        (``FittedPipeline.datum_shape``/``datum_dtype``) is used; only
        when neither exists does the shape lock to the first request
        (whose batch then pays its capture).
    max_queue:
        Admission-queue bound; submissions beyond it raise
        :class:`QueueFull`.
    max_wait_ms:
        Micro-batch gather window after the first request of a batch.
    """

    def __init__(
        self,
        fitted: FittedPipeline,
        *,
        buckets: Sequence[int] = (1, 8, 32, 64),
        datum_shape: Optional[Sequence[int]] = None,
        dtype: Any = None,
        max_queue: int = 256,
        max_wait_ms: float = 2.0,
        metrics: Optional[MetricsRegistry] = None,
        log_interval_s: float = 10.0,
    ):
        self._fitted = fitted
        if max_queue < 1:
            # Queue(maxsize=0) would mean UNBOUNDED in python — the exact
            # opposite of the backpressure contract
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        # the per-item serving contract: explicit args win; otherwise fall
        # back to what the pipeline recorded at fit time, so a warm-up-able
        # engine needs no out-of-band shape plumbing (replica.py holds the
        # shared resolution + batch-coupled rejection)
        datum_shape, dtype = serving_contract(fitted, datum_shape, dtype)
        self._policy = BucketPolicy(buckets, datum_shape, dtype)
        self._metrics = metrics or MetricsRegistry()
        # Strict compile: fail at construction, naming the blocking node.
        # The compiled chain is private to this engine: fitted.compile()
        # would replace the pipeline's own compiled state, so unrelated
        # apply_compiled / apply_chunked calls would enter this engine's
        # accounting (and a second engine drop the first's graphs). Every
        # capture, one per padded shape, records its signature and bumps
        # the "compiles" counter, which the bucket policy keeps at the
        # bucket count.
        self._compiled_signatures: list = []
        # the worker loop lives in replica.py; the engine's
        # gather-then-dispatch batching is the replica's batch source
        self._replica = Replica(self._compile_for(fitted), self._policy, self._metrics,
                                span_name="serve.microbatch", log_interval_s=log_interval_s)
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._max_wait = max_wait_ms / 1000.0
        self._log_interval = log_interval_s
        # orders every admission against the _closed flip in drain/shutdown:
        # a put either completes before _closed is set (and is answered by
        # the drain) or observes _closed and is rejected — no request can
        # land in the queue after the post-join sweep
        self._admit_lock = threading.Lock()
        # serializes start/drain/shutdown against each other (e.g. an
        # atexit handler racing the context manager's __exit__)
        self._lifecycle_lock = threading.RLock()
        self._closed = False
        self._abort = False
        self._stop = False
        self._ran = False  # distinguishes never-started from shut-down
        self._thread: Optional[threading.Thread] = None
        self._metrics.set_gauge("queue_depth", self._queue.qsize)

    def _compile_for(self, fitted: FittedPipeline):
        """``fitted`` compiled strictly against this engine's private
        accounting (the ``compiles`` counter and the signature list): the
        constructor's path, shared by :meth:`swap`, so a replacement's
        captures are counted as the original's were."""
        return compile_pipeline(fitted, metrics=self._metrics,
                                signatures=self._compiled_signatures)

    @property
    def _compiled(self):
        return self._replica.compiled

    @property
    def metrics(self) -> MetricsRegistry:
        return self._metrics

    @property
    def policy(self) -> BucketPolicy:
        return self._policy

    @property
    def compiled_signatures(self) -> list:
        """``(shape, dtype)`` of every capture this engine paid, in order;
        its length is the metrics' ``compiles`` counter."""
        return list(self._compiled_signatures)

    # -- lifecycle ------------------------------------------------------

    def warm_up(self, required: bool = True) -> int:
        """Run one zero batch per bucket through the compiled chain, paying
        every bucket's capture before traffic. Returns the buckets warmed.

        ``required=True`` (the default, and any direct call) raises when no
        datum shape is known: a service that asked to pre-pay its captures
        must not boot cold and pay them under traffic. ``required=False``
        (``start()``'s best-effort default) warns and returns 0."""
        if self._policy.datum_shape is None:
            if required:
                raise ValueError(
                    "warm-up requested but impossible: no datum shape is "
                    "known — pass datum_shape= to the engine, or fit the "
                    "pipeline through and_then(estimator, data) so the "
                    "contract is recorded on the FittedPipeline"
                )
            logger.warning(
                "serving warm-up skipped: no datum_shape configured — the "
                "first live batch of each bucket will pay its capture"
            )
            return 0
        n = 0
        for x in self._policy.warmup_inputs():
            self._compiled(x)  # returns host arrays: the batch has run
            n += 1
        logger.info("serving warm-up: %d bucket(s) %s ready (%d captured)",
                    n, self._policy.batch_sizes, self._metrics.count("compiles"))
        return n

    def start(self, warmup: Optional[bool] = None) -> "ServingEngine":
        """Start the worker. ``warmup=None`` (default) warms up when the
        datum shape is known and skips with a warning otherwise;
        ``warmup=True`` demands it (raises if impossible); ``warmup=False``
        boots cold."""
        with self._lifecycle_lock:
            if self._thread is not None:
                raise RuntimeError("engine already started")
            if self._closed:
                raise EngineClosed("engine was shut down")
            if warmup or warmup is None:
                self.warm_up(required=warmup is True)
            self._thread = threading.Thread(
                target=self._worker_main,
                name="keystone-serving-worker",
                daemon=True,
            )
            self._thread.start()
            self._ran = True
        return self

    def _worker_main(self) -> None:
        """The worker thread body. The engine has no supervisor, so a death
        that escapes the loop (an injected ``faults.ReplicaKilled``,
        interpreter shutdown) fails the queue with a typed error instead of
        stranding every queued future."""
        try:
            self._replica.serve_forever(_GatherSource(self))
        except BaseException as e:  # noqa: BLE001 — last-resort backstop
            logger.exception(
                "serving engine: worker thread died — closing admission "
                "and failing queued requests"
            )
            try:
                # close FIRST: with no consumer left, a later submit
                # would strand its future and a drain-shutdown would
                # deadlock on queue.join() — the _admit_lock ordering
                # guarantees every request either lands before this flip
                # (swept below) or is typed-refused at submit
                with self._admit_lock:
                    self._closed = True
                for r in getattr(e, "pending", None) or []:
                    settle_future(
                        r.future, EngineStopped("engine worker died")
                    )
                self._reject_queued("engine worker died")
            except Exception:
                logger.exception(
                    "engine worker death cleanup failed; queued requests "
                    "may be stranded"
                )

    def swap(self, fitted: FittedPipeline, *, warmup: Optional[bool] = None) -> int:
        """Replace the served model with ``fitted`` in one step: the
        publish step of an incremental refit (``FittedPipeline.absorb``).

        The replacement compiles strictly and captures every bucket off the
        serving path; only then does the dispatch reference flip, one store
        read once per micro-batch at dispatch. No request is dropped: every
        batch runs whole on one chain (whichever the worker reads when it
        dispatches), and admission never pauses.

        The new pipeline must meet the engine's datum contract (shape and
        dtype) and bucket policy: re-bucketing a live engine is a restart,
        not a swap; a mismatch raises ``ContractMismatchError``. ``warmup``
        follows :meth:`start`: None warms when the shape is known, True
        demands it, False flips cold (the first batch of each bucket pays
        its capture). Returns the number of buckets warmed.
        """
        check_swap_contract(fitted, self._policy)
        cur_shape = self._policy.datum_shape
        with self._lifecycle_lock:
            if self._closed:
                raise EngineClosed("engine is draining / shut down")
            compiles_before = self._metrics.count("compiles")
            compiled = self._compile_for(fitted)
            warmed = 0
            if (warmup or warmup is None) and cur_shape is not None:
                for x in self._policy.warmup_inputs():
                    compiled(x)
                    warmed += 1
            elif warmup is True:
                raise ValueError(
                    "swap(warmup=True) but no datum shape is known — the "
                    "engine cannot pre-pay the replacement's compiles"
                )
            # the swap: one reference store, read once per batch by the
            # worker at dispatch, so each batch runs whole on one chain
            self._replica.flip(compiled)
            self._fitted = fitted
            self._metrics.inc("swaps")
            tracer = _trace_current()
            if tracer is not None:
                with tracer.span(
                    "serve.swap",
                    op_type="ServingEngine",
                    buckets_warmed=warmed,
                    compiles=self._metrics.count("compiles") - compiles_before,
                    queue_depth=self._queue.qsize(),
                    live=self._thread is not None,
                ):
                    pass
            logger.info(
                "serving swap: model replaced (%d bucket(s) warmed, %d captured; "
                "queue depth %d)",
                warmed, self._metrics.count("compiles") - compiles_before,
                self._queue.qsize(),
            )
            return warmed

    def drain(self) -> None:
        """Stop admitting, answer every queued request, stop the worker.
        Equivalent to ``shutdown(drain=True)`` — a drained engine must not
        leave its worker polling an empty queue for the process lifetime."""
        self.shutdown(drain=True)

    def shutdown(self, drain: bool = True) -> None:
        """Stop the engine. ``drain=True`` answers queued requests first;
        ``drain=False`` fails them with :class:`EngineClosed`. Idempotent
        and safe to call from multiple threads."""
        with self._lifecycle_lock:
            with self._admit_lock:
                self._closed = True
            if self._thread is None:
                self._reject_queued(
                    "engine is shut down" if self._ran else "engine never started"
                )
                return
            if drain:
                self._queue.join()
            else:
                self._abort = True
            self._stop = True
            self._thread.join()
            self._thread = None
            # _admit_lock ordered every put against the _closed flip above,
            # so nothing can land after this point; the sweep is a belt-and-
            # braces guarantee no admitted request is ever left unanswered.
            self._reject_queued()

    def _reject_queued(self, reason: str = "engine is shut down") -> None:
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                return
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(EngineStopped(reason))
            self._queue.task_done()

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- admission ------------------------------------------------------

    def submit(self, datum: Any, timeout: Optional[float] = None) -> Future:
        """Enqueue one datum; returns a Future of its prediction row.

        ``timeout`` (seconds) is the request's deadline: if the batch it
        would join runs after the deadline, the Future fails with
        :class:`DeadlineExceeded`. Raises :class:`QueueFull` immediately
        when the admission queue is at capacity."""
        now = time.monotonic()
        req = _Request(
            datum=datum,
            deadline=(now + timeout) if timeout is not None else None,
            enqueued=now,
        )
        with self._admit_lock:
            if self._closed:
                raise EngineStopped("engine is draining / shut down")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                self._metrics.inc("rejected")
                raise QueueFull(
                    f"admission queue at capacity ({self._queue.maxsize})"
                ) from None
        self._metrics.inc("submitted")
        return req.future

    def predict(self, datum: Any, timeout: Optional[float] = None) -> Any:
        """Synchronous convenience: submit + wait for the result.

        On a started engine every admitted request reaches a terminal
        state, a result or a typed ``serving.errors`` exception (the worker
        decides deadline expiry at batch time; shutdown sweeps the queue).
        ``timeout`` is the request's deadline; with one, the wait itself
        ends :data:`PREDICT_GRACE_S` after it (a capture in flight can hold
        the first request of a bucket; warm up to avoid that), raising
        ``TimeoutError``: a request that far past its deadline has a stuck
        worker behind it. ``submit()`` may buffer
        before ``start()``, but a synchronous wait would then have nothing
        to wake it, so this raises instead."""
        if self._thread is None:
            raise RuntimeError(
                "predict() needs a started engine (call start() or use "
                "the context manager); submit() may buffer before start"
            )
        fut = self.submit(datum, timeout=timeout)
        return fut.result(timeout=None if timeout is None else timeout + PREDICT_GRACE_S)

    def _fail_and_drain(self, first: _Request) -> None:
        """Abortive shutdown: answer everything queued with EngineClosed."""
        reqs = [first]
        while True:
            try:
                reqs.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for r in reqs:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(EngineClosed("engine aborted"))
            self._queue.task_done()


class _GatherSource:
    """The engine's batching policy as a replica batch source: block for
    the first queued request, then gather more until the largest bucket is
    full or ``max_wait_ms`` has passed."""

    def __init__(self, engine: ServingEngine):
        self._engine = engine

    def next_batch(self, replica):
        e = self._engine
        try:
            first = e._queue.get(timeout=0.05)
        except queue.Empty:
            return STOP if e._stop else None
        if e._abort:
            e._fail_and_drain(first)
            return None
        batch = [first]
        gather_until = time.monotonic() + e._max_wait
        while len(batch) < e._policy.max_size:
            remaining = gather_until - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(e._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def batch_done(self, batch, replica) -> None:
        for _ in batch:
            self._engine._queue.task_done()
