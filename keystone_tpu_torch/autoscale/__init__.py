"""QoS for the serving fleet (port of ``keystone_tpu/autoscale/``, its
``qos`` module): the priority vocabulary (``high`` / ``normal`` / ``low``,
the shedding axis) and the per-tenant :class:`WeightedFairQueue` (deficit
round robin, the fairness axis) that the fleet scheduler's queues are.

The autoscaler (``policy.py``'s ``ScalePolicy``, ``scaler.py``'s
``Autoscaler``) rides the cluster router's health loop and comes with
``cluster/``.
"""

from .qos import (
    DEFAULT_PRIORITY,
    DEFAULT_TENANT,
    PRIORITIES,
    PRIORITY_RANK,
    SHED_BIAS,
    WeightedFairQueue,
    normalize_priority,
    request_rank,
    request_tenant,
)

__all__ = [
    "DEFAULT_PRIORITY",
    "DEFAULT_TENANT",
    "PRIORITIES",
    "PRIORITY_RANK",
    "SHED_BIAS",
    "WeightedFairQueue",
    "normalize_priority",
    "request_rank",
    "request_tenant",
]
