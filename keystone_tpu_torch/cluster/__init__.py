"""The multi-process serving tier: a front-door router over worker
processes (port of ``keystone_tpu/cluster/``).

The serving package runs N replica threads in one process; this package
is the layer above it:

* :class:`ClusterRouter`: admission and deadline shedding at the front
  door, least-outstanding load balancing, health checks, respawn within a
  restart budget, merged metrics, a Prometheus scrape plane, stitched
  cross-process traces, the autoscaler's actuator, and a bounded,
  signal-safe shutdown.
* :mod:`~keystone_tpu_torch.cluster.worker`: the worker process, a local
  :class:`~keystone_tpu_torch.serving.ServingFleet` on its device (the
  card unless the CPU is asked for), booting warm from the shared AOT
  cache and reporting the traces it paid in its ``ready`` message.
* :mod:`~keystone_tpu_torch.cluster.wire`: the length-framed socket
  protocol; deadlines cross as remaining budget and the serving errors
  arrive as the same types.
* The hot wire path: compatible admitted requests coalesce into one
  member-list frame, which rides the binary codec
  (:mod:`~keystone_tpu_torch.cluster.codec`, negotiated at the handshake;
  ``KEYSTONE_WIRE_CODEC=pickle`` turns it off), and payloads above
  ``KEYSTONE_SHM_MIN_BYTES`` move through
  :mod:`~keystone_tpu_torch.cluster.shm` rings.

``KEYSTONE_WORKERS`` (and the serve demo's ``--workers N``) sizes the tier.
"""

from .codec import CodecError
from .router import ClusterRouter, default_workers, format_status
from .shm import ShmRing
from .wire import ConnectionClosed, WorkerError

__all__ = [
    "ClusterRouter",
    "CodecError",
    "ConnectionClosed",
    "ShmRing",
    "WorkerError",
    "default_workers",
    "format_status",
]
