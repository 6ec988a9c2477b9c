"""The static pipeline checker: shape, dtype and traceability inference
over the whole DAG, and the segment plan, before anything runs (port of
``keystone_tpu/check/``).

* :mod:`~keystone_tpu_torch.check.abstract` propagates specs from the
  data leaves through every node on fake tensors (with the ``out_spec``
  and ``fitted_out_spec`` declarations for nodes that cannot run
  abstractly), so a shape, dtype or rank mismatch raises a node-attributed
  :class:`PipelineCheckError` at ``and_then`` or ``fit()`` entry instead of
  in the middle of a scan;
* :mod:`~keystone_tpu_torch.check.lattice` gives every node a verdict
  (``traceable | host_callback | batch_coupled | stateful | opaque``) from
  static evidence, which compile and serving read;
* :mod:`~keystone_tpu_torch.check.segments` cuts the DAG into maximal
  traceable segments between materialization barriers.

Front doors: ``Pipeline.check()`` / ``FittedPipeline.check()``, the
``--check`` command-line mode, and :func:`check_graph` for raw graphs. A
check executes zero chunks and zero samples (``cost.count_sampling`` stays
untouched), launches no kernel and allocates no device memory.

``KEYSTONE_STATIC_CHECK=0`` turns off the implicit checks at ``and_then``
and fit entry; an explicit ``check()`` always runs.
"""

from __future__ import annotations

from .abstract import (
    SYMBOLIC_LEAD,
    EstimatorSpec,
    Spec,
    SpecTuple,
    infer_specs,
    spec_from_item,
    spec_of_array,
)
from .errors import CheckOnlyExit, ContractMismatchError, PipelineCheckError
from .lattice import (
    BATCH_COUPLED,
    HOST_CALLBACK,
    OPAQUE,
    STATEFUL,
    TRACEABLE,
    blocks_export,
    blocks_jit,
    classify,
    register_verdict,
)
from .report import CheckReport, check_graph
from .segments import Segment, plan_segments

__all__ = [
    "BATCH_COUPLED",
    "CheckOnlyExit",
    "CheckReport",
    "ContractMismatchError",
    "EstimatorSpec",
    "HOST_CALLBACK",
    "OPAQUE",
    "PipelineCheckError",
    "STATEFUL",
    "SYMBOLIC_LEAD",
    "Segment",
    "Spec",
    "SpecTuple",
    "TRACEABLE",
    "blocks_export",
    "blocks_jit",
    "check_enabled",
    "check_graph",
    "check_only_mode",
    "classify",
    "infer_specs",
    "plan_segments",
    "register_verdict",
    "set_check_only",
    "spec_from_item",
    "spec_of_array",
]


def check_enabled() -> bool:
    """Are the implicit checks at ``and_then`` and fit entry on?
    (``KEYSTONE_STATIC_CHECK=0`` turns them off.)"""
    from ..utils import env_flag

    return env_flag("KEYSTONE_STATIC_CHECK", True)


# -- the --check command-line mode ------------------------------------------

_check_only = False


def set_check_only(on: bool) -> None:
    """Arm or disarm check-only mode: the next ``Pipeline.fit()`` runs the
    static check, prints the report and raises :class:`CheckOnlyExit`
    instead of fitting (the ``--check`` flag)."""
    global _check_only
    _check_only = bool(on)


def check_only_mode() -> bool:
    return _check_only
