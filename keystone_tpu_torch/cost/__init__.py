"""Cost-model solver selection, cold path (port of the part of
``keystone_tpu/cost/`` that runs without a profile store): shape
signatures, analytic pricing, the solver chooser, and the count of
sampled-scale executions the planner paid. The profile store, re-plan and
optimize memo are later work."""

from __future__ import annotations

import threading
from typing import Dict

from .chooser import SolverChoice, SolverChooser
from .model import CostEstimator, ShapeSignature, op_key

__all__ = [
    "CostEstimator", "ShapeSignature", "SolverChoice", "SolverChooser", "op_key",
    "get_estimator", "count_sampling", "sampling_executions", "reset_sampling",
]


def get_estimator() -> CostEstimator:
    """The estimator the chooser prices with."""
    return CostEstimator()


_sampling_lock = threading.Lock()
_sampling: Dict[str, int] = {}


def count_sampling(kind: str, n: int = 1) -> None:
    """Record ``n`` sampled-scale executions of ``kind`` (such as
    ``node_optimization``)."""
    with _sampling_lock:
        _sampling[kind] = _sampling.get(kind, 0) + n


def sampling_executions() -> Dict[str, int]:
    """Per-kind counts of sampled-scale executions since the last reset,
    with a ``"total"``."""
    with _sampling_lock:
        out = dict(_sampling)
    out["total"] = sum(out.values())
    return out


def reset_sampling() -> None:
    with _sampling_lock:
        _sampling.clear()
