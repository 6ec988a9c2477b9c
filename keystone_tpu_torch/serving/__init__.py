"""Online serving: micro-batched, shape-bucketed inference over a compiled
fitted pipeline (port of ``keystone_tpu/serving/``, its single-engine
path).

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

The replicated fleet, its scheduler and SLO watchdog come in a later
slice.
"""

from .batching import BucketPolicy
from .engine import ServingEngine
from .errors import (
    DeadlineExceeded,
    EngineClosed,
    EngineStopped,
    InvalidRequest,
    QueueFull,
    ServingError,
)
from .metrics import MetricsRegistry
from .replica import Replica

__all__ = [
    "ServingEngine",
    "Replica",
    "BucketPolicy",
    "MetricsRegistry",
    "ServingError",
    "QueueFull",
    "DeadlineExceeded",
    "InvalidRequest",
    "EngineClosed",
    "EngineStopped",
]
