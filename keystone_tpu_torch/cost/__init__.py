"""The cost-model subsystem: learned operator profiles, per-node solver
choice, trace-informed re-planning (port of ``keystone_tpu/cost/``).

The optimizer's decisions are priced by
:class:`~keystone_tpu_torch.cost.model.CostEstimator`, chosen by
:class:`~keystone_tpu_torch.cost.chooser.SolverChooser`, observed by the
tracer (``obs/``) and fed back through :mod:`~keystone_tpu_torch.cost.replan`
into a persistent :class:`~keystone_tpu_torch.cost.store.ProfileStore`, so
the second fit of a pipeline is planned from evidence, not samples.

Store layout (one checksummed JSON record a file, written atomically,
isolated by environment; ``cost/store.py``):

* ``op/<OperatorClass>``: class-level throughput, ``spu`` (EWMA seconds
  per analytic cost unit, solvers), ``seconds_per_item`` and
  ``bytes_per_item`` (EWMA node throughput), observation counts;
* ``solver/<graph-fp>``: the auto-solver node's observed shape and chosen
  implementation for one pipeline;
* ``plan/<graph-fp>``: per-node observed seconds and bytes (and the
  measured estimate-against-observed ``ratio``) for one pipeline, what the
  cache planner plans from with zero sampling executions;
* ``plan/segment/<digest>``: one dispatched segment's compiles, runs and
  seconds, and whether the evidence demoted it to node dispatch
  (``cost/segments.py``).

``KEYSTONE_PROFILE_DIR=<dir>`` (or the CLI's ``--profiles``, or
``utils.obs.configure(profiles=...)``) turns the store on. Without it the
subsystem stays cold: choices are the analytic cost model's and nothing
touches the disk.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional

from . import segments
from .chooser import SolverChoice, SolverChooser
from .model import CostEstimator, ShapeSignature, op_key
from .replan import PendingPlan, current_plan, finalize, graph_fingerprint, pending_plan
from .store import ProfileStore, profile_environment

__all__ = [
    "CostEstimator", "PendingPlan", "ProfileStore", "ShapeSignature", "SolverChoice",
    "SolverChooser", "configure", "count_sampling", "current_plan", "finalize",
    "get_estimator", "get_store", "graph_fingerprint", "op_key", "pending_plan",
    "profile_environment", "reset", "reset_sampling", "sampling_executions", "segments",
]

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_store: Optional[ProfileStore] = None
_initialized = False  # False: the next get_store() reads KEYSTONE_PROFILE_DIR


def configure(path: Optional[str] = None, device=None) -> Optional[ProfileStore]:
    """Install the process-wide profile store. ``path=None`` follows
    ``KEYSTONE_PROFILE_DIR`` (unset or empty: learning off). ``device`` is
    where the fits run, which keys the store's environment (default: CUDA
    when available). An unusable directory turns learning off, never
    raises."""
    global _store, _initialized
    with _lock:
        _initialized = True
        if path is None:
            path = (os.environ.get("KEYSTONE_PROFILE_DIR") or "").strip()
        if not path:
            _store = None
            return None
        try:
            _store = ProfileStore(path, device=device)
        except Exception:
            logger.warning("cost: profile dir %r unusable — profile learning disabled",
                           path, exc_info=True)
            _store = None
        return _store


def get_store() -> Optional[ProfileStore]:
    """The installed store, or None (cold). Reads ``KEYSTONE_PROFILE_DIR``
    on first use."""
    if not _initialized:
        return configure()
    return _store


def get_estimator() -> CostEstimator:
    """A CostEstimator over the installed store (store-less when cold)."""
    return CostEstimator(get_store())


def reset() -> None:
    """Forget the installed store and the sampling counts."""
    global _store, _initialized
    with _lock:
        _store = None
        _initialized = False
    reset_sampling()


# ---------------------------------------------------------------------------
# Sampling executions: how many sampled-scale executions the planner paid
# (zero on a fit planned from evidence)
# ---------------------------------------------------------------------------

_sampling_lock = threading.Lock()
_sampling: Dict[str, int] = {}


def count_sampling(kind: str, n: int = 1) -> None:
    """Record ``n`` sampled-scale executions of ``kind`` (such as
    ``node_optimization`` or ``autocache``)."""
    with _sampling_lock:
        _sampling[kind] = _sampling.get(kind, 0) + n
    plan = current_plan()
    if plan is not None:
        plan.sampling_executions += n


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
