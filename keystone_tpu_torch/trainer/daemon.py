"""The supervised trainer daemon: the closed continual-learning loop (port
of ``keystone_tpu/trainer/daemon.py``).

One background thread turns "fit then serve" into a hands-free online
system by connecting machinery that exists apart:

* **tail**: read the append-only :class:`~.source.ChunkLog` strictly
  forward (fault site ``trainer.ingest``; transient faults are retried a
  bounded number of times, then escalate to the supervisor);
* **monitor**: featurize each appended chunk through the serving model's
  frozen prefix (``FittedPipeline.prefix_features``) on the model's
  device, fold it into the :class:`~.drift.DriftMonitor` against the
  fitted solver state's own moments, and score the residual of labeled
  appends with the model's ``forward`` on the features where they lie;
* **decide**: refit on a wall-clock cadence or when a drift trigger trips
  (both visible as the ``drift_score`` gauge);
* **absorb**: fold the pending chunk batch into the model with
  ``FittedPipeline.absorb`` in O(new chunks), checkpointed through
  :class:`~keystone_tpu_torch.faults.FitCheckpoint` (``trainer.absorb``
  fires for each folded chunk, so a kill mid-fold leaves the last completed
  block on disk and the retried attempt resumes bit for bit);
* **canary and swap**: publish through
  :meth:`~keystone_tpu_torch.serving.fleet.ServingFleet.swap` with a
  canary fraction; the evidence promotes or rolls back (``trainer.canary``
  fires before the swap; an injected transient there counts as a canary
  failure);
* **survive**: every failure leaves the old model serving. An absorb crash
  or a canary mismatch retries its batch a bounded number of times, then
  parks it (quarantine and a warning, never a poison-pill loop); the loop
  thread restarts within a restart budget when something punches through
  (an injected kill, a crash), with its cursor and batch state kept on the
  object.

**A kernel or device fault is the card's** (``ops.is_device_fault``: a
kernel's build or launch failure, an out-of-memory error, a CUDA error).
Retried, restarted or parked, it would meet the card again, so the daemon
neither counts it a monitor failure, nor retries or parks its batch, nor
restarts its loop: it stops, records ``trainer.dead``, dumps the flight
ring (``device_fault``), and a later :meth:`TrainerDaemon.start` raises
:class:`TrainerStopped` chained to the fault. The fleet serves on with
the old model (unless the fault was the canary candidate's, which stops
the fleet too). The JAX package handles every failure alike.

**Streams.** The candidate's tensors are written on the trainer thread's
stream while the replicas replay on their own; the daemon waits for that
stream before the swap captures the candidate, so no replica reads a
weight before the work that wrote it is done.

Metrics land in the fleet's registry (``refits``, ``rollbacks``,
``parked_batches``, ``absorb_failures``, ``absorbed_chunks``,
``absorbed_rows``, the ``drift_score`` / ``staleness_s`` /
``trainer_backlog`` gauges); promote, rollback, park and restart are trace
and flight instants, and each refit attempt is a ``trainer.refit`` span.
The seconds of each chunk's monitoring and of each absorb and swap are the
``trainer.monitor`` / ``trainer.absorb`` / ``trainer.canary`` phases of
``utils.timing``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from ..faults import TRAINER_ABSORB, TRAINER_CANARY, TRAINER_INGEST, fault_point, is_transient
from ..obs.tracer import current as _trace_current
from ..ops import is_device_fault
from ..serving.errors import CanaryMismatch, EngineStopped
from ..utils import timing
from .drift import DriftMonitor
from .source import ChunkLog

logger = logging.getLogger(__name__)


class TrainerStopped(RuntimeError):
    """The daemon is not running (never started, stopped, its restart
    budget spent, or stopped by a device fault, to which it is chained)."""


class _Attempt:
    """One frozen chunk batch being refit: ``[start, stop)`` log indices
    and its retry count. Frozen at the first attempt, so retries are
    deterministic and the absorb checkpoint key stays the same; chunks
    appended later join the next batch."""

    def __init__(self, start: int, stop: int):
        self.start = start
        self.stop = stop
        self.retries = 0

    @property
    def key(self) -> str:
        return f"trainer-batch-{self.start}-{self.stop}"


def _device_of(fitted) -> torch.device:
    from ..workflow.pipeline import _param_device

    return _param_device(fitted.graph)


class TrainerDaemon:
    """Supervised continual-learning loop over a fleet and a chunk log.

    Parameters (each an explicit budget or threshold), as the JAX
    package's:

    fleet:
        The live :class:`~keystone_tpu_torch.serving.fleet.ServingFleet`;
        its published model is the absorb base and the swap target.
    source:
        The :class:`~.source.ChunkLog` to tail.
    poll_interval_s:
        Idle sleep between loop ticks.
    refit_interval_s:
        Cadence trigger: refit when this much wall clock passed since the
        last promoted refresh (None: drift only).
    min_refit_chunks:
        Never refit on fewer pending chunks.
    drift:
        A :class:`~.drift.DriftMonitor`, or None for one over the fitted
        solver state's moments (``drift_kwargs`` overrides its defaults).
    canary_fraction / canary_batches / canary_timeout_s / canary_atol /
    canary_rtol / max_latency_ratio:
        Forwarded to ``fleet.swap``: the promote-or-rollback evidence. The
        tolerances say how far a refreshed model may move: a healthy
        absorb moves the outputs a little, a poisoned batch wildly.
    max_batch_retries:
        Absorb crashes or canary rollbacks a batch survives before it is
        parked.
    max_restarts:
        The loop thread's restart budget.
    max_ingest_failures:
        Consecutive transient ingest failures tolerated before the tick
        escalates to the supervisor.
    checkpoint_dir:
        Directory of the absorb checkpoints (None: an attempt folds from
        its first chunk).
    """

    def __init__(self, fleet, source: ChunkLog, *, poll_interval_s: float = 0.05,
                 refit_interval_s: Optional[float] = None, min_refit_chunks: int = 1,
                 drift: Optional[DriftMonitor] = None, drift_kwargs: Optional[dict] = None,
                 canary_fraction: float = 0.25, canary_batches: int = 2,
                 canary_timeout_s: float = 5.0, canary_atol: float = 0.25,
                 canary_rtol: float = 0.25, max_latency_ratio: Optional[float] = None,
                 max_batch_retries: int = 1, max_restarts: int = 2,
                 max_ingest_failures: int = 8, checkpoint_dir: Optional[str] = None,
                 join_timeout_s: float = 10.0):
        self._fleet = fleet
        self._source = source
        self._fitted = fleet.fitted
        self.poll_interval_s = float(poll_interval_s)
        self.refit_interval_s = None if refit_interval_s is None else float(refit_interval_s)
        self.min_refit_chunks = int(min_refit_chunks)
        self.canary_fraction = float(canary_fraction)
        self.canary_batches = int(canary_batches)
        self.canary_timeout_s = float(canary_timeout_s)
        self.canary_atol = float(canary_atol)
        self.canary_rtol = float(canary_rtol)
        self.max_latency_ratio = max_latency_ratio
        self.max_batch_retries = int(max_batch_retries)
        self.max_restarts = int(max_restarts)
        self.max_ingest_failures = int(max_ingest_failures)
        self.checkpoint_dir = checkpoint_dir

        self._metrics = fleet.metrics
        self._monitor = drift or DriftMonitor(self._state_of(self._fitted).moments(),
                                              **(drift_kwargs or {}))
        #: log index up to which chunks are resolved (promoted or parked)
        self._resolved = 0
        #: log index up to which chunks were ingested into the monitor
        self._ingested = 0
        self._attempt: Optional[_Attempt] = None
        self._parked: List[tuple] = []
        self._consecutive_ingest_failures = 0
        self._last_promote = time.monotonic()
        self._restarts_used = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._join_timeout_s = float(join_timeout_s)
        #: the kernel or device fault that stopped the daemon, None while none
        self._device_fault: Optional[BaseException] = None
        # drift and staleness are watermarks (the worst process is the
        # fleet's truth, a sum of two drift scores is fiction); the
        # backlog adds up
        self._metrics.set_gauge("drift_score", lambda: self._monitor.score()["drift_score"],
                                merge="max")
        self._metrics.set_gauge("staleness_s", self.staleness_s, merge="max")
        self._metrics.set_gauge("trainer_backlog", lambda: len(self._source) - self._resolved)

    # -- introspection ---------------------------------------------------

    @property
    def fitted(self):
        """The daemon's view of the published model (moves only on a
        promoted refresh)."""
        return self._fitted

    @property
    def monitor(self) -> DriftMonitor:
        return self._monitor

    @property
    def device_fault(self) -> Optional[BaseException]:
        """The kernel or device fault that stopped the daemon, or None."""
        return self._device_fault

    @property
    def parked_batches(self) -> List[tuple]:
        """Quarantined ``(start, stop)`` chunk-index ranges: appended data
        the loop gave up on after its retries. Their chunks stay in the log
        for offline forensics."""
        with self._lock:
            return list(self._parked)

    def staleness_s(self) -> float:
        """Seconds since the last promoted refresh (or the daemon's start)."""
        return time.monotonic() - self._last_promote

    @staticmethod
    def _state_of(fitted):
        return fitted._absorb_node()[1].solver_state

    @staticmethod
    def _mapper_of(fitted):
        return fitted._absorb_node()[1]

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "TrainerDaemon":
        with self._lock:
            if self._device_fault is not None:
                raise TrainerStopped("the trainer stopped on a device fault") \
                    from self._device_fault
            if self._thread is not None:
                raise RuntimeError("trainer already started")
            if self._stop.is_set():
                raise TrainerStopped("trainer was stopped")
            self._spawn_thread()
        return self

    def _spawn_thread(self) -> None:
        attempt = self._restarts_used
        self._thread = threading.Thread(
            target=self._run, name="keystone-trainer" + (f"-r{attempt}" if attempt else ""),
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Idempotent bounded shutdown: the loop exits at the next tick
        boundary; a loop wedged inside a canary window is joined with a time
        limit, logged and abandoned (a daemon thread)."""
        self._stop.set()
        with self._lock:
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self._join_timeout_s)
            if t.is_alive():
                logger.warning("trainer shutdown: thread %s did not exit within %.1fs — "
                               "abandoning it (daemon)", t.name, self._join_timeout_s)

    def __enter__(self) -> "TrainerDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- supervision -----------------------------------------------------

    def _run(self) -> None:
        """The thread's target: the loop under its own supervisor. An escape
        (an injected kill at a trainer site, a crash) restarts the loop
        within the restart budget, with the batch and cursor state kept on
        the object, so a killed absorb's next attempt resumes from its
        checkpoint. A device fault stops the daemon instead."""
        try:
            self._loop()
        except BaseException as e:  # noqa: BLE001 — the supervision seam
            if self._stop.is_set():
                return
            fault = is_device_fault(e)
            with self._lock:
                will_restart = not fault and self._restarts_used < self.max_restarts
                if will_restart:
                    self._restarts_used += 1
                if fault:
                    self._device_fault = e
                self._metrics.inc("trainer_crashes")
            logger.warning("trainer: loop died (%s: %s) — restart %s (budget %d/%d used)%s",
                           type(e).__name__, e, "scheduled" if will_restart else "REFUSED",
                           self._restarts_used, self.max_restarts,
                           " — a device fault: the trainer stops" if fault else "")
            self._instant("trainer.restart" if will_restart else "trainer.dead",
                          kind=type(e).__name__)
            if will_restart:
                # a fresh loop gets a fresh ingest-fault budget: the
                # escalation that caused this restart must not leave the
                # counter saturated
                self._consecutive_ingest_failures = 0
                with self._lock:
                    self._spawn_thread()
                self._metrics.inc("trainer_restarts")
            else:
                self._stop.set()
                if fault:
                    from ..obs import flight as _flight

                    _flight.dump("device_fault")

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self._tick():
                self._stop.wait(self.poll_interval_s)

    # -- one tick --------------------------------------------------------

    def _tick(self) -> bool:
        """Ingest, decide, maybe refit. True when it did real work (the
        idle sleep is skipped)."""
        new = self._ingest()
        for chunk in new:
            self._observe(chunk)
        if self._attempt is None and self._should_refit():
            self._attempt = _Attempt(self._resolved, self._ingested)
        if self._attempt is not None:
            self._refit(self._attempt)
            return True
        return bool(new)

    def _ingest(self) -> list:
        """Tail the source; transient faults (``trainer.ingest``) are
        tolerated up to ``max_ingest_failures`` consecutive times, then
        escalate to the supervisor."""
        try:
            fault_point(TRAINER_INGEST)
            new = self._source.tail(self._ingested)
        except Exception as e:
            if not is_transient(e):
                raise
            self._consecutive_ingest_failures += 1
            self._metrics.inc("ingest_failures")
            logger.warning("trainer: transient ingest failure %d/%d (%s)",
                           self._consecutive_ingest_failures, self.max_ingest_failures, e)
            self._instant("trainer.ingest_fault", consecutive=self._consecutive_ingest_failures,
                          budget=self.max_ingest_failures)
            if self._consecutive_ingest_failures >= self.max_ingest_failures:
                raise
            return []
        self._consecutive_ingest_failures = 0
        self._ingested += len(new)
        return new

    def _observe(self, chunk) -> None:
        """Monitor one appended chunk: featurize it through the frozen
        prefix on the model's device, score moment drift against the fitted
        moments and, on labeled appends, the model's residual. A chunk that
        fails monitoring is logged and still joins its batch (if it is
        poisoned, the absorb and canary path catches it); a device fault
        stops the daemon."""
        from ..data.dataset import Dataset

        try:
            with timing.phase("trainer.monitor"):
                dev = _device_of(self._fitted)
                x = torch.as_tensor(chunk.data).to(dev)
                feats = Dataset.of(self._fitted.prefix_features(Dataset.of(x))).to_array()
                residual = None
                if chunk.labels is not None:
                    # the model's forward where the features lie; the
                    # residual in float64, as the JAX package's host numpy
                    preds = self._mapper_of(self._fitted).forward(feats.float())
                    y = torch.as_tensor(np.asarray(chunk.labels), dtype=torch.float64,
                                        device=preds.device)
                    residual = float(((preds.double() - y) ** 2).mean())
                self._monitor.observe(feats, residual)
        except Exception as e:
            if is_device_fault(e):
                raise
            self._metrics.inc("monitor_failures")
            logger.warning("trainer: chunk %d failed featurize-for-monitoring (drift evidence "
                           "skipped; the absorb path will judge it)", chunk.index,
                           exc_info=True)

    def _should_refit(self) -> bool:
        pending = self._ingested - self._resolved
        if pending < self.min_refit_chunks:
            return False
        reason = self._monitor.should_refit()
        if reason is not None:
            logger.info("trainer: drift trigger (%s) — refitting %d pending chunk(s)", reason,
                        pending)
            return True
        return (self.refit_interval_s is not None
                and self.staleness_s() >= self.refit_interval_s)

    # -- the refit attempt ----------------------------------------------

    def _refit(self, attempt: _Attempt) -> None:
        """One absorb → canary → swap attempt of the frozen batch. Every
        failure leaves the old model serving; success publishes and
        re-baselines."""
        tracer = _trace_current()
        with contextlib.ExitStack() as stack:
            if tracer is not None:
                stack.enter_context(tracer.span(
                    "trainer.refit", op_type=type(self).__name__, batch_start=attempt.start,
                    batch_stop=attempt.stop, retry=attempt.retries))
            try:
                candidate = self._absorb(attempt)
            except Exception as e:
                if is_device_fault(e):
                    raise
                self._metrics.inc("absorb_failures")
                self._batch_failed(attempt, e, phase="absorb")
                return
            try:
                fault_point(TRAINER_CANARY)
                with timing.phase("trainer.canary"):
                    report = self._fleet.swap(
                        candidate, canary_fraction=self.canary_fraction,
                        canary_batches=self.canary_batches,
                        canary_timeout_s=self.canary_timeout_s, atol=self.canary_atol,
                        rtol=self.canary_rtol, max_latency_ratio=self.max_latency_ratio)
            except EngineStopped:
                # the fleet is going away: nothing was promoted and there is
                # nothing left to publish to
                logger.info("trainer: fleet stopped — trainer stopping")
                self._stop.set()
                return
            except CanaryMismatch as e:
                self._metrics.inc("rollbacks")
                self._instant("trainer.rollback", batch_start=attempt.start,
                              batch_stop=attempt.stop, evidence=str(e)[:200])
                self._batch_failed(attempt, e, phase="canary")
                return
            except Exception as e:
                if is_transient(e):
                    # an injected or flaky canary failure: the verdict of a
                    # mismatch, nothing promoted, the old model serves
                    self._metrics.inc("rollbacks")
                    self._instant("trainer.rollback", batch_start=attempt.start,
                                  batch_stop=attempt.stop, evidence=f"canary fault: {e}")
                    self._batch_failed(attempt, e, phase="canary")
                    return
                raise
            self._promoted(attempt, candidate, report)

    def _absorb(self, attempt: _Attempt):
        """The checkpointed fold: ``trainer.absorb`` fires for each folded
        chunk inside the checkpoint discipline, so a kill here resumes from
        the last completed block on the next attempt. Returns once the
        candidate's tensors are written (its stream waited for)."""
        ds, labels = self._source.as_chunked(attempt.start, attempt.stop)

        def on_chunk(i, _chunk):
            fault_point(TRAINER_ABSORB)

        with timing.phase("trainer.absorb"):
            candidate = self._fitted.absorb(ds, labels, checkpoint=self.checkpoint_dir,
                                            checkpoint_key=attempt.key, on_chunk=on_chunk)
            dev = _device_of(candidate)
            if dev.type == "cuda":
                # the replicas replay on streams of their own: the swap's
                # captures must not read a weight before it is written
                torch.cuda.current_stream(dev).synchronize()
        self._metrics.inc("absorbed_chunks", attempt.stop - attempt.start)
        self._metrics.inc("absorbed_rows", int(labels.shape[0]))
        # the memory watermark's fit seam: absorb holds the candidate's whole
        # accumulator state, a footprint peak
        from ..obs import resource as _resource

        _resource.sample_memory()
        return candidate

    def _batch_failed(self, attempt: _Attempt, exc, *, phase: str) -> None:
        attempt.retries += 1
        if attempt.retries > self.max_batch_retries:
            self._park(attempt.start, attempt.stop, f"{phase} failed {attempt.retries}x: {exc}")
            self._resolved = attempt.stop
            self._attempt = None
            self._discard_checkpoint(attempt)
        else:
            self._metrics.inc("batch_retries")
            logger.warning("trainer: %s failed for batch [%d, %d) (%s) — retry %d/%d%s", phase,
                           attempt.start, attempt.stop, exc, attempt.retries,
                           self.max_batch_retries,
                           " (will resume from checkpoint)"
                           if phase == "absorb" and self.checkpoint_dir else "")

    def _park(self, start: int, stop: int, why: str) -> None:
        with self._lock:
            self._parked.append((start, stop))
        self._metrics.inc("parked_batches")
        logger.warning("trainer: PARKING chunk batch [%d, %d) — %s. The old model keeps "
                       "serving; the chunks stay in the log for forensics.", start, stop, why)
        self._instant("trainer.park", batch_start=start, batch_stop=stop)
        # a parked batch is quarantined data: leave the post-mortem file of
        # what the loop did on the way here
        from ..obs import flight as _flight

        _flight.dump("trainer_park")

    def _discard_checkpoint(self, attempt: _Attempt) -> None:
        """A parked batch's half-folded checkpoint must not survive: it
        would be garbage to a later attempt under the same key."""
        if self.checkpoint_dir is None:
            return
        from ..faults import FitCheckpoint

        FitCheckpoint(self.checkpoint_dir, attempt.key).complete()

    def _promoted(self, attempt: _Attempt, candidate, report) -> None:
        self._fitted = candidate
        self._resolved = attempt.stop
        self._attempt = None
        self._last_promote = time.monotonic()
        self._metrics.inc("refits")
        self._monitor.rebaseline(self._state_of(candidate).moments())
        canary = report.get("canary") or {}
        logger.info("trainer: PROMOTED refresh v%s (batch [%d, %d), %d mirrored canary "
                    "batch(es))", report.get("version"), attempt.start, attempt.stop,
                    canary.get("batches_compared", 0))
        self._instant("trainer.promote", version=report.get("version"),
                      batch_start=attempt.start, batch_stop=attempt.stop)

    def _instant(self, name: str, **attrs: Any) -> None:
        # every verdict lands in the always-on flight ring too: a promote,
        # rollback, park or restart shows in a post-mortem dump even when
        # tracing was never configured
        from ..obs import flight as _flight

        _flight.record_instant(name, **attrs)
        tracer = _trace_current()
        if tracer is not None:
            tracer.instant(name, op_type=type(self).__name__, **attrs)
