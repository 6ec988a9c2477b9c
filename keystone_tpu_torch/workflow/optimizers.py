"""Named optimizer rule stacks (port of ``keystone_tpu/workflow/optimizers.py``;
parity: ``workflow/DefaultOptimizer.scala``).

:class:`DefaultOptimizer` loads saved state, merges common subexpressions
to a fixpoint, then fuses traceable chains. Left out of this port, each
with its own later item of work:

* ``NodeOptimizationRule`` (node-level implementation choice from data
  samples): no estimator of the ported applications is ``Optimizable``
  (``KernelRidgeRegression`` is not; ``KernelRidgeEstimator`` is not
  ported yet), and without such a node the JAX rule changes nothing.
* the optimize memo, which caches rule-stack results keyed by
  ``cost.replan.graph_fingerprint``; every ``fit`` and ``apply`` here runs
  the stack, and the tensor digests of :func:`~.operators.structural_key`
  are cached per tensor instead.
* ``AutoCachingOptimizer``, with the auto-cache rule.
"""

from __future__ import annotations

from typing import List

from .fusion import TraceFusionRule
from .rules import (
    Batch,
    EquivalentNodeMergeRule,
    ExtractSaveablePrefixes,
    RuleExecutor,
    SavedStateLoadRule,
    Strategy,
    UnusedBranchRemovalRule,
)


class Optimizer(RuleExecutor):
    """Base optimizer type registered in :class:`~.env.PipelineEnv`."""


class DefaultOptimizer(Optimizer):
    """Load saved state, then CSE, then trace fusion."""

    def batches(self) -> List[Batch]:
        return [
            Batch(
                "Load Saved State",
                Strategy.ONCE,
                [ExtractSaveablePrefixes(), SavedStateLoadRule(), UnusedBranchRemovalRule()],
            ),
            Batch(
                "Common Sub-expression Elimination",
                Strategy.FIXED_POINT,
                [EquivalentNodeMergeRule()],
            ),
            # last: every structural rule has run, so estimators and
            # delegating nodes bound the fused groups
            Batch("Trace Fusion", Strategy.ONCE, [TraceFusionRule()]),
        ]
