"""Rule-based graph optimizer machinery (port of
``keystone_tpu/workflow/rules.py``).

Parity targets: ``workflow/Rule.scala``, ``RuleExecutor.scala``,
``EquivalentNodeMergeRule.scala``, ``UnusedBranchRemovalRule.scala``,
``ExtractSaveablePrefixes.scala``, ``SavedStateLoadRule.scala``.

A rule transforms ``(graph, annotations)`` where the annotations carry the
node → prefix map used for the fit-once state table. Batches of rules run
either once or to fixpoint. With a tracer installed, each optimizer pass
opens a new estimate epoch (``Tracer.begin_plan_epoch``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

from . import analysis
from .env import PipelineEnv
from .graph import Graph, GraphError, NodeId
from .operators import Cacheable, EstimatorOperator, ExpressionOperator, structural_key
from .prefix import Prefix, find_prefix

logger = logging.getLogger(__name__)

#: node → prefix annotations threaded through the rule pipeline.
Annotations = Dict[NodeId, Prefix]


class Rule:
    name: str

    def apply(self, graph: Graph, annotations: Annotations) -> Tuple[Graph, Annotations]:
        raise NotImplementedError


class Strategy:
    ONCE = "once"
    FIXED_POINT = "fixed_point"


@dataclass
class Batch:
    name: str
    strategy: str
    rules: Sequence[Rule]
    max_iterations: int = 100


class RuleExecutor:
    """Runs batches of rules; fixpoint batches iterate until the graph stops
    changing (parity: ``RuleExecutor.scala:29-84``)."""

    def batches(self) -> List[Batch]:
        raise NotImplementedError

    def execute(self, graph: Graph, annotations: Optional[Annotations] = None
                ) -> Tuple[Graph, Annotations]:
        from ..obs import tracer as obs_tracer

        t = obs_tracer.current()
        if t is not None:
            # one optimize pass, one estimate epoch (Tracer.record_node_estimate)
            t.begin_plan_epoch()
        ann = dict(annotations or {})
        for batch in self.batches():
            iteration = 0
            while True:
                iteration += 1
                before = (graph, dict(ann))
                for rule in batch.rules:
                    graph, ann = rule.apply(graph, ann)
                if batch.strategy == Strategy.ONCE:
                    break
                # Cost note: every rule returns its input graph object
                # unchanged on a no-op pass, and tuple/dict equality
                # short-circuits on identity (PyObject_RichCompareBool), so
                # the converged iteration costs O(len(ann)) identity checks,
                # not a whole-graph structural compare; the deep compare
                # only runs when a rule rebuilt the graph, where it fails
                # fast on the first differing field.
                if (graph, ann) == before:
                    break
                if iteration >= batch.max_iterations:
                    logger.warning("batch %s hit max iterations (%d)", batch.name,
                                   batch.max_iterations)
                    break
        return graph, ann


class ExtractSaveablePrefixes(Rule):
    """Annotate estimator and cache-marked nodes with their prefixes, so the
    executor knows which results to persist in the global state table."""

    def apply(self, graph: Graph, annotations: Annotations) -> Tuple[Graph, Annotations]:
        ann = dict(annotations)
        for node in graph.nodes:
            op = graph.get_operator(node)
            if isinstance(op, (EstimatorOperator, Cacheable)) or getattr(op, "saveable", False):
                prefix = find_prefix(graph, node)
                if prefix is not None:
                    ann[node] = prefix
        return graph, ann


class SavedStateLoadRule(Rule):
    """Substitute :class:`ExpressionOperator` leaves for nodes whose prefix is
    already in :class:`PipelineEnv` state — this is what makes a second
    ``fit``/``apply`` skip refitting."""

    def apply(self, graph: Graph, annotations: Annotations) -> Tuple[Graph, Annotations]:
        state = PipelineEnv.get_or_create().state
        for node, prefix in list(annotations.items()):
            if node not in graph.operators:
                continue
            op = graph.get_operator(node)
            if isinstance(op, ExpressionOperator):
                continue
            expr = state.get(prefix)
            if expr is not None:
                graph = graph.set_operator(node, ExpressionOperator(expr))
                graph = graph.set_dependencies(node, [])
        return graph, annotations


class UnusedBranchRemovalRule(Rule):
    """Remove nodes from which no sink is reachable
    (parity: ``UnusedBranchRemovalRule.scala``)."""

    def apply(self, graph: Graph, annotations: Annotations) -> Tuple[Graph, Annotations]:
        needed = set()
        for sink in graph.sinks:
            dep = graph.get_sink_dependency(sink)
            needed.add(dep)
            needed.update(analysis.get_ancestors(graph, sink))
        unused = [n for n in graph.nodes if n not in needed]
        # remove in reverse-dependency order
        while unused:
            progressed = False
            for n in list(unused):
                try:
                    graph = graph.remove_node(n)
                except GraphError:
                    continue  # still referenced; later iterations free it
                unused.remove(n)
                progressed = True
            if not progressed:  # pragma: no cover - cycle guard
                break
        ann = {n: p for n, p in annotations.items() if n in graph.operators}
        return graph, ann


class EquivalentNodeMergeRule(Rule):
    """Common-subexpression elimination: merge nodes with structurally
    equal operators and identical dependencies, to fixpoint (parity:
    ``EquivalentNodeMergeRule.scala:13`` — Scala case-class equality merges
    separately-constructed equal nodes; :func:`structural_key` recovers
    that here, falling back to object identity for uncanonicalizable
    state such as closures)."""

    def apply(self, graph: Graph, annotations: Annotations) -> Tuple[Graph, Annotations]:
        # Merging only rewires dependencies — operator keys never change
        # within one apply(), so memoize the (sha1-of-params) key per
        # operator instance across fixpoint passes.
        key_cache: Dict[int, object] = {}

        def op_key(op):
            k = key_cache.get(id(op))
            if k is None:
                k = key_cache[id(op)] = structural_key(op)
            return k

        while True:
            groups: Dict[Tuple, List[NodeId]] = {}
            for node in graph.nodes:
                key = (op_key(graph.get_operator(node)),
                       tuple(graph.get_dependencies(node)))
                groups.setdefault(key, []).append(node)
            # each group of equal nodes folds into its smallest id; a pass
            # merges every group it found with one rebuild of the maps (the
            # groups are disjoint, and equal dependencies stay equal when
            # rewritten alike), then the next pass finds the nodes that the
            # merges made equal
            merged = {n: nodes[0] for nodes in map(sorted, groups.values())
                      if len(nodes) > 1 for n in nodes[1:]}
            if not merged:
                return graph, annotations
            graph = replace(
                graph,
                operators={n: op for n, op in graph.operators.items() if n not in merged},
                dependencies={n: tuple(merged.get(d, d) for d in deps)
                              for n, deps in graph.dependencies.items() if n not in merged},
                sink_dependencies={k: merged.get(d, d)
                                   for k, d in graph.sink_dependencies.items()},
            )
            for n in merged:
                annotations.pop(n, None)
