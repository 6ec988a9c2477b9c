"""Named optimizer rule stacks (port of ``keystone_tpu/workflow/optimizers.py``;
parity: ``workflow/DefaultOptimizer.scala``).

:class:`DefaultOptimizer` loads saved state, merges common subexpressions
to a fixpoint, lets ``Optimizable`` nodes choose their implementation
from data samples (``node_optimization.py``), then fuses traceable
chains. Left out of this port, each
with its own later item of work:

* the optimize memo, which caches rule-stack results keyed by
  ``cost.replan.graph_fingerprint``; every ``fit`` and ``apply`` here runs
  the stack, and the tensor digests of :func:`~.operators.structural_key`
  are cached per tensor instead.
* ``AutoCachingOptimizer``, with the auto-cache rule.
"""

from __future__ import annotations

from typing import List

from .fusion import TraceFusionRule
from .node_optimization import NodeOptimizationRule
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
    """Load saved state, then CSE, then node-level choice, then trace
    fusion."""

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
            Batch("Node Level Optimization", Strategy.ONCE, [NodeOptimizationRule()]),
            # last: every structural rule has run, so estimators and
            # delegating nodes bound the fused groups
            Batch("Trace Fusion", Strategy.ONCE, [TraceFusionRule()]),
        ]
