"""Named optimizer rule stacks (port of ``keystone_tpu/workflow/optimizers.py``;
parity: ``workflow/DefaultOptimizer.scala``).

:class:`DefaultOptimizer` loads saved state, merges common subexpressions
to a fixpoint, lets ``Optimizable`` nodes choose their implementation
from data samples (``node_optimization.py``), then fuses traceable
chains. :class:`AutoCachingOptimizer` adds profile-guided cache planning
(``autocache.py``) before the fusion.

Optimization is memoized process-wide: the rule stack is deterministic in
(the optimizer's configuration, the graph's structure, the operator
objects themselves, the saved-state table), so running it twice on the
same inputs is waste. The key holds the
:class:`~keystone_tpu_torch.workflow.env.VersionedState` version, because
``SavedStateLoadRule`` bakes saved expressions into the optimized graph:
any state mutation invalidates every memoized plan. A fit that is
learning (an open cost-model pending plan) bypasses the memo, since its
rules must deposit their decisions again. So does a graph whose data
leaves hold more than 64 MiB in memory (an entry pins its graph, and so
its leaves' payloads), which at full width is every fit's graph.
``KEYSTONE_OPT_MEMO=0`` is the kill switch; ``memo_stats`` counts hits,
misses and bypasses.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

from ..utils import env_flag
from .fusion import TraceFusionRule
from .node_optimization import NodeOptimizationRule
from .rules import (
    Annotations,
    Batch,
    EquivalentNodeMergeRule,
    ExtractSaveablePrefixes,
    RuleExecutor,
    SavedStateLoadRule,
    Strategy,
    UnusedBranchRemovalRule,
)

logger = logging.getLogger(__name__)

#: bounded process-wide memo: key -> (input graph, optimized graph,
#: annotations). The input graph rides in the entry so the operator
#: objects its key holds by identity stay alive as long as the entry.
_MEMO_MAX = 32
#: an entry pins its graphs, and a graph's data leaves pin their payloads:
#: a graph whose in-memory leaf payloads exceed this is not memoized, so a
#: long-lived process cannot hold 32 training sets behind dropped
#: pipelines (chunked datasets hold factories and memoize freely)
_MEMO_MAX_PAYLOAD_BYTES = 64 << 20
_memo: "OrderedDict[tuple, tuple]" = OrderedDict()
_memo_lock = threading.Lock()
#: hits, misses and bypasses of the memo
memo_stats = {"hits": 0, "misses": 0, "bypasses": 0}


def _payload_bytes(graph) -> int:
    """In-memory bytes the graph's data leaves would pin (materialized
    payloads only; factories and tuples count 0, as in the JAX package)."""
    from .operators import DatasetOperator, DatumOperator

    total = 0
    for node in graph.nodes:
        op = graph.get_operator(node)
        payload = None
        if isinstance(op, DatasetOperator):
            payload = op.dataset.payload
        elif isinstance(op, DatumOperator):
            payload = op.datum
        if payload is not None:
            total += int(getattr(payload, "nbytes", 0) or 0)
    return total


def memo_enabled() -> bool:
    return env_flag("KEYSTONE_OPT_MEMO", True)


def clear_memo() -> None:
    """Drop every memoized plan and zero ``memo_stats``."""
    with _memo_lock:
        _memo.clear()
        memo_stats.update(hits=0, misses=0, bypasses=0)


def _memo_key(optimizer: "Optimizer", graph) -> Optional[tuple]:
    """The identity of one optimize run, or None when the graph cannot be
    fingerprinted. Operators take part as objects (by identity, but for
    the payload-identity data leaves): two equal-looking graphs over other
    estimator instances must never share a plan, or the wrong instances
    would be fitted."""
    from ..cost.replan import graph_fingerprint
    from . import analysis
    from .env import PipelineEnv
    from .graph import NodeId

    try:
        ops = tuple(graph.get_operator(gid) for gid in analysis.linearize(graph)
                    if isinstance(gid, NodeId) and gid in graph.operators)
        return (type(optimizer), optimizer.memo_config(),
                PipelineEnv.get_or_create().state.version, graph_fingerprint(graph), ops)
    except Exception:
        # an unkeyable graph bypasses the memo: correct, only slower
        logger.debug("optimize memo key not derivable; bypassing", exc_info=True)
        return None


class Optimizer(RuleExecutor):
    """Base optimizer type registered in :class:`~.env.PipelineEnv`."""

    def memo_config(self) -> tuple:
        """Hashable configuration in the memo key: a subclass with knobs
        that change the plan includes them."""
        return ()

    def execute(self, graph, annotations: Optional[Annotations] = None
                ) -> Tuple[object, Annotations]:
        from ..cost import current_plan

        key = None
        if (memo_enabled() and not annotations and current_plan() is None
                and _payload_bytes(graph) <= _MEMO_MAX_PAYLOAD_BYTES):
            key = _memo_key(self, graph)
        if key is None:
            memo_stats["bypasses"] += 1
            return super().execute(graph, annotations)
        with _memo_lock:
            entry = _memo.get(key)
            if entry is not None:
                _memo.move_to_end(key)
                memo_stats["hits"] += 1
                # copied out: callers hand them to executors that may
                # extend them in place
                return entry[1], dict(entry[2])
        memo_stats["misses"] += 1
        out_graph, ann = super().execute(graph, annotations)
        with _memo_lock:
            _memo[key] = (graph, out_graph, dict(ann))
            while len(_memo) > _MEMO_MAX:
                _memo.popitem(last=False)
        return out_graph, ann


class DefaultOptimizer(Optimizer):
    """Load saved state, then CSE, then node-level choice, then trace
    fusion."""

    def batches(self) -> List[Batch]:
        return self._head_batches() + [
            Batch("Node Level Optimization", Strategy.ONCE, [NodeOptimizationRule()]),
            self._fusion_batch(),
        ]

    def _head_batches(self) -> List[Batch]:
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
        ]

    def _fusion_batch(self) -> Batch:
        """Last: every structural rule has run, so estimators, Cachers and
        delegating nodes bound the fused groups."""
        return Batch("Trace Fusion", Strategy.ONCE, [TraceFusionRule()])


class AutoCachingOptimizer(DefaultOptimizer):
    """DefaultOptimizer plus profile-guided cache planning before the
    fusion (parity: ``DefaultOptimizer.scala:19-26``): ``strategy`` is
    ``"greedy"`` (a memory budget, by default 0.75 × what the card can
    still hand out) or ``"aggressive"`` (every reused node)."""

    def __init__(self, strategy: str = "greedy", mem_budget_bytes: Optional[int] = None):
        self.strategy = strategy
        self.mem_budget_bytes = mem_budget_bytes

    def memo_config(self) -> tuple:
        return (self.strategy, self.mem_budget_bytes)

    def batches(self) -> List[Batch]:
        from .autocache import AutoCacheRule

        return self._head_batches() + [
            Batch("Node Level Optimization", Strategy.ONCE, [NodeOptimizationRule()]),
            Batch("Auto Cache", Strategy.ONCE,
                  [AutoCacheRule(self.strategy, self.mem_budget_bytes)]),
            self._fusion_batch(),
        ]
