"""Typed serving errors (port of ``keystone_tpu/serving/errors.py``).

Every way a request can fail without the engine itself being broken has
its own type, so callers can branch (retry, shed, fix the datum) instead
of matching strings, and a failed request never stalls the worker loop:
the error becomes that request's result and the batch goes on.
"""

from __future__ import annotations


class ServingError(Exception):
    """Base of all serving-layer errors."""


class QueueFull(ServingError):
    """Admission queue at capacity — the request was rejected at submit
    time (backpressure by load-shedding, never unbounded growth)."""


class Shed(ServingError):
    """The request's deadline cannot be met given the fleet's queue depth
    and learned batch service time, so it was refused at admission, before
    it took a queue slot and card time only to expire. :class:`DeadlineExceeded`
    is the late detection of the same condition at batch time; a shed
    request never entered the system, so its caller can retry elsewhere at
    once or degrade."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed while it waited in the queue; it was
    dropped before wasting a batch slot on an answer nobody is waiting
    for."""


class InvalidRequest(ServingError):
    """The request's datum failed validation (wrong shape / uncastable
    payload). Isolated per request: the rest of its micro-batch completes
    normally."""


class EngineClosed(ServingError):
    """Submit after :meth:`ServingEngine.drain` / ``shutdown``."""


class EngineStopped(EngineClosed):
    """The engine or fleet has been stopped: admission saw the closed flag (the
    check and the enqueue are atomic against shutdown, so a submit either
    lands before the close and is answered by the drain, or gets this;
    never a stranded future). Subclasses :class:`EngineClosed`; the
    distinct type tells an orderly stop from other ways of closing."""


class CanaryMismatch(ServingError):
    """A canaried :meth:`ServingFleet.swap` rolled back: the candidate's
    outputs (or its latency) diverged from the live model's on mirrored
    traffic. The fleet still serves the old model; nothing was promoted.
    ``report`` carries the evidence (batches compared, mismatch details,
    latency ratio)."""

    def __init__(self, message: str, report: dict = None):
        super().__init__(message)
        self.report = report or {}
