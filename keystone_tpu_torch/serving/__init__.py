"""Online serving: micro-batched, shape-bucketed inference over a compiled
fitted pipeline (port of ``keystone_tpu/serving/``).

* :class:`ServingEngine`: a bounded admission queue and a worker that
  drains requests into micro-batches (largest bucket, ``max_wait_ms``),
  with per-request deadlines, backpressure and per-request error
  isolation; a same-contract ``swap`` under traffic.
* :class:`BucketPolicy`: pads micro-batches to a few static bucket sizes,
  so the chain is captured as one CUDA graph per bucket and steady traffic
  captures nothing.
* :class:`MetricsRegistry`: queue depth, batch occupancy, captures
  (``compiles``), latency and queue-age quantiles, the cost table, the
  timeline, ``snapshot()`` and ``merge``.

* :class:`ServingFleet`: N :class:`Replica` workers (co-resident on one
  card, each replaying its own CUDA graphs on its own stream) behind one
  :class:`FleetScheduler`: continuous batching, deadline-aware admission
  shedding (typed :class:`Shed`), work stealing, weighted-fair QoS,
  supervision with restarts and quarantine, and a fleet-wide swap with an
  optional canary that rolls back with :class:`CanaryMismatch`.
* :class:`SloPolicy` / :class:`SloWatchdog`: budgets judged over the
  metrics timeline, each violation a typed :class:`SloBreach`.
"""

from .batching import BucketPolicy
from .engine import ServingEngine
from .errors import (
    CanaryMismatch,
    DeadlineExceeded,
    EngineClosed,
    EngineStopped,
    InvalidRequest,
    QueueFull,
    ServingError,
    Shed,
)
from .fleet import ServingFleet
from .metrics import MetricsRegistry
from .replica import Replica
from .scheduler import FleetScheduler
from .slo import SloBreach, SloPolicy, SloWatchdog

__all__ = [
    "SloBreach",
    "SloPolicy",
    "SloWatchdog",
    "ServingEngine",
    "ServingFleet",
    "Replica",
    "FleetScheduler",
    "BucketPolicy",
    "MetricsRegistry",
    "ServingError",
    "QueueFull",
    "Shed",
    "DeadlineExceeded",
    "InvalidRequest",
    "EngineClosed",
    "EngineStopped",
    "CanaryMismatch",
]
