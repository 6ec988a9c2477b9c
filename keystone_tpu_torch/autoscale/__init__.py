"""Autoscaling and QoS: the acting half of the serving control loop (port
of ``keystone_tpu/autoscale/``).

* :mod:`~keystone_tpu_torch.autoscale.qos`: the priority vocabulary
  (``high`` / ``normal`` / ``low``, the shedding axis) and the per-tenant
  :class:`WeightedFairQueue` (deficit round robin, the fairness axis) that
  the fleet scheduler's queues are.
* :mod:`~keystone_tpu_torch.autoscale.policy`: :class:`ScalePolicy`, the
  declarative bounds (min / max workers, cooldowns, breach hysteresis).
* :mod:`~keystone_tpu_torch.autoscale.scaler`: :class:`Autoscaler`, riding
  the cluster router's health loop: breach rows and timeline rows in,
  policy-bounded spawn and drain decisions out, each a counter, a flight
  instant and a ``scale.*`` span.
"""

from .policy import ScalePolicy
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
from .scaler import Autoscaler, ScaleDecision

__all__ = [
    "Autoscaler",
    "DEFAULT_PRIORITY",
    "DEFAULT_TENANT",
    "PRIORITIES",
    "PRIORITY_RANK",
    "SHED_BIAS",
    "ScaleDecision",
    "ScalePolicy",
    "WeightedFairQueue",
    "normalize_priority",
    "request_rank",
    "request_tenant",
]
