"""Node-level implementation choice driven by data samples and profiles
(port of ``keystone_tpu/workflow/node_optimization.py``; parity:
``workflow/NodeOptimizationRule.scala``, ``OptimizableNodes.scala``).

An ``Optimizable`` node (such as the auto-solver ``KernelRidgeEstimator``)
looks at a small sample of its input and the full dataset size and
returns the operator to run. The rule runs the graph on sampled leaf
datasets to produce those samples, then swaps the operators in place.

Nodes with the cost-model protocol (``shape_from_samples`` and
``choose_solver``) are planned through the solver chooser. When a profile
store is configured and holds this pipeline's solver shape from a previous
traced run, the rule plans without running the sampled graph at all (the
zero-sampling second fit). Either way the decision (shape, choice,
pricing) goes into the pending re-plan, so the fit's observed cost feeds
the store (``cost/replan.py``).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence, Tuple

from ..data.dataset import Dataset
from ..parallel.mesh import mesh_size
from . import analysis
from .executor import GraphExecutor
from .graph import Graph, NodeId
from .operators import DatasetOperator, Operator
from .rules import Annotations, Rule

logger = logging.getLogger(__name__)

#: how many items to sample from each leaf dataset
DEFAULT_SAMPLE_SIZE = 24


class Optimizable:
    """Mixin: a node that can pick its implementation given a data sample.

    ``sample_optimize(samples, num_items)`` receives one sampled ``Dataset``
    per dependency and the full input size, and returns the replacement
    operator. Nodes that also implement ``shape_from_samples(samples,
    num_items, chunked=...)`` and ``choose_solver(shape, node_id=...)``
    are planned through the cost-model chooser, and can skip sampling on
    stored evidence."""

    def sample_optimize(self, samples: Sequence[Dataset], num_items: int) -> Operator:
        raise NotImplementedError


def _sampled_graph(graph: Graph, sample_size: int) -> Graph:
    """``graph`` with every leaf dataset cut to its first ``sample_size``
    items (a chunked leaf pays for its leading chunks only)."""
    for node in graph.nodes:
        op = graph.get_operator(node)
        if isinstance(op, DatasetOperator):
            ds = op.dataset
            if len(ds) > sample_size:
                graph = graph.set_operator(node, DatasetOperator(ds.take(sample_size)))
    return graph


def _total_items(graph: Graph, node: NodeId) -> int:
    """The size of the largest leaf dataset upstream of ``node``."""
    n = 0
    for anc in analysis.get_ancestors(graph, node) | {node}:
        if isinstance(anc, NodeId):
            op = graph.get_operator(anc)
            if isinstance(op, DatasetOperator):
                n = max(n, len(op.dataset))
    return n


def _chunked_input(graph: Graph, node: NodeId) -> bool:
    """True when the node's data input (its first dependency) flows from an
    out-of-core chunked leaf: only streaming solvers can take it."""
    deps = graph.get_dependencies(node)
    if not deps:
        return False
    data_dep = deps[0]
    for anc in analysis.get_ancestors(graph, data_dep) | {data_dep}:
        if isinstance(anc, NodeId):
            op = graph.get_operator(anc)
            if isinstance(op, DatasetOperator) and op.dataset.is_chunked:
                return True
    return False


class _SamplingFailed(Exception):
    """A sampled-scale dependency pull failed: the one condition that
    skips a node instead of failing the optimize."""


class NodeOptimizationRule(Rule):
    name = "NodeOptimizationRule"

    def __init__(self, sample_size: int = DEFAULT_SAMPLE_SIZE):
        self.sample_size = sample_size

    def apply(self, graph: Graph, annotations: Annotations) -> Tuple[Graph, Annotations]:
        optimizable = [
            n for n in analysis.linearize(graph)
            if isinstance(n, NodeId) and n in graph.operators
            and isinstance(graph.get_operator(n), Optimizable)
        ]
        if not optimizable:
            return graph, annotations

        from .. import cost as cost_mod
        from ..cost.replan import topo_node_index

        store = cost_mod.get_store()
        fp: Optional[str] = None
        index: Dict[NodeId, int] = {}
        if store is not None:
            fp = cost_mod.graph_fingerprint(graph)
            index = topo_node_index(graph)

        # built on first use: a run planned from evidence pays not even the
        # truncated graph's construction
        executor = None

        def sampled_deps(node: NodeId):
            nonlocal executor
            if executor is None:
                # sampled pulls stay serial: at 24 items a pool only adds noise
                executor = GraphExecutor(_sampled_graph(graph, self.sample_size),
                                         optimize=False, parallel=False)
            deps = graph.get_dependencies(node)
            try:
                samples = [executor.execute(d).get() for d in deps]
            except Exception as e:  # an estimator upstream of the sample path
                raise _SamplingFailed(e) from e
            cost_mod.count_sampling("node_optimization", len(deps))
            return [s if isinstance(s, Dataset) else Dataset.of([s]) for s in samples]

        for node in optimizable:
            op = graph.get_operator(node)
            num_items = _total_items(graph, node)
            cost_protocol = hasattr(op, "shape_from_samples") and hasattr(op, "choose_solver")
            # only a failed sampled pull skips the node; a fault in the
            # choice itself propagates
            try:
                if cost_protocol:
                    chosen = self._choose_with_cost_model(op, graph, node, num_items, store, fp,
                                                          index.get(node), sampled_deps)
                else:
                    chosen = op.sample_optimize(sampled_deps(node), num_items)
            except _SamplingFailed as e:
                logger.warning("node optimization skipped for %s: %s", op.label, e.__cause__)
                continue
            if chosen is not op:
                logger.info("node optimization: %s -> %s", op.label, chosen.label)
                graph = graph.set_operator(node, chosen)
        return graph, annotations

    @staticmethod
    def _choose_with_cost_model(op, graph: Graph, node: NodeId, num_items: int, store,
                                fp: Optional[str], node_idx: Optional[int], sampled_deps):
        """Plan one cost-protocol node: from the stored shape when the
        profile store has seen this pipeline (no sampling), else from its
        sampled shape (``chunked`` when its data input is out-of-core);
        the choice goes through the chooser and into the pending re-plan."""
        import dataclasses

        from .. import cost as cost_mod
        from ..cost import replan as cost_replan

        chunked = _chunked_input(graph, node)
        shape = None
        source = "sampled"
        if store is not None and fp is not None and node_idx is not None:
            stored = cost_replan.stored_solver_shape(store, fp, node_idx)
            if stored is not None:
                # n, chunkedness and machines come from this run (the data
                # may have grown); d, k and sparsity are the evidence
                shape = dataclasses.replace(
                    stored, n=int(num_items) or stored.n, chunked=chunked,
                    machines=int(getattr(op, "num_machines", None) or mesh_size()))
                source = "profiles"
                logger.info("node optimization: %s planned from stored profile (no sampling)",
                            op.label)
        if shape is None:
            shape = op.shape_from_samples(sampled_deps(node), num_items, chunked=chunked)
        choice = op.choose_solver(shape, node_id=str(node.id))
        plan = cost_mod.current_plan()
        # the first deposit wins: the outer fit's optimizer runs before any
        # estimator, so a nested fit must not overwrite the plan observed
        if plan is not None and plan.solver is None and fp is not None and node_idx is not None:
            units = choice.costs.get(choice.label, {}).get("units")
            plan.solver = {
                "fp": fp, "node_idx": int(node_idx), "node_id": str(node.id),
                "shape": shape.to_record(), "chosen": choice.label,
                "units": float(units) if units is not None else 0.0, "source": source,
            }
        return choice.chosen
