"""Fault-tolerant out-of-core fits (port of ``keystone_tpu/faults``).

* :mod:`~keystone_tpu_torch.faults.plan`: seeded, deterministic fault
  injection (``KEYSTONE_FAULTS`` or :func:`install`) through named
  :func:`fault_point` hooks, and the typed errors that say what recovery
  applies (:class:`TransientError`, :class:`FatalFaultInjected`,
  :class:`ReplicaKilled`). The scans' two seams, ``scan.chunk`` and
  ``scan.stage``, are installed, as are ``replica.batch`` (the serving
  fleet), ``aot.read`` (the AOT cache), ``worker.spawn`` (the cluster
  router) and ``scale.spawn`` / ``scale.drain`` (the autoscaler); the
  ``trainer.*`` constants are here for the trainer, which comes later.
* :mod:`~keystone_tpu_torch.faults.retry`: the bounded-backoff retry of
  transient failures, one budget a scan (``KEYSTONE_SCAN_RETRIES``, off by
  default).
* :mod:`~keystone_tpu_torch.faults.checkpoint`: atomic on-disk snapshots of
  the streaming fits' accumulators, so ``checkpoint=dir`` resumes a killed
  out-of-core fit from its last completed block.
"""

from .checkpoint import FitCheckpoint
from .plan import (
    AOT_READ,
    REPLICA_BATCH,
    SCALE_DRAIN,
    SCALE_SPAWN,
    SCAN_CHUNK,
    SCAN_STAGE,
    TRAINER_ABSORB,
    TRAINER_CANARY,
    TRAINER_INGEST,
    WORKER_SPAWN,
    FatalFaultInjected,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    ReplicaDown,
    ReplicaKilled,
    TransientError,
    active_plan,
    clear,
    fault_point,
    install,
    is_transient,
    parse_plan,
)
from .retry import RetryBudget, retry_call

__all__ = [
    "AOT_READ",
    "WORKER_SPAWN",
    "REPLICA_BATCH",
    "SCALE_DRAIN",
    "SCALE_SPAWN",
    "SCAN_CHUNK",
    "SCAN_STAGE",
    "TRAINER_ABSORB",
    "TRAINER_CANARY",
    "TRAINER_INGEST",
    "FatalFaultInjected",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "FitCheckpoint",
    "ReplicaDown",
    "ReplicaKilled",
    "RetryBudget",
    "TransientError",
    "active_plan",
    "clear",
    "fault_point",
    "install",
    "is_transient",
    "parse_plan",
    "retry_call",
]
