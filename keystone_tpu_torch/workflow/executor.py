"""Pull-based memoized graph executor (port of the serial pull of
``keystone_tpu/workflow/executor.py``; parity: ``workflow/GraphExecutor.scala``).

The executor optimizes its graph lazily on first use, then
``execute(graph_id)`` recursively pulls dependency expressions, memoizing
one expression per node. Results of saveable prefixes (annotated by the
optimizer) are written into the global :class:`PipelineEnv` state so later
executions skip the work entirely.

Every node's result is retained for the executor's life, the JAX
package's default when no auto-cache plan is present: a graph's results
live as long as the executor that computed them, so an owner that keeps
an executor past its use (``Pipeline._fit``) releases its state itself.
Not ported: segment dispatch, the concurrent scheduler and trace spans.
"""

from __future__ import annotations

from typing import Dict, Optional

from .env import PipelineEnv
from .expressions import Expression
from .graph import Graph, GraphId, SinkId, SourceId
from .rules import Annotations


class GraphExecutor:
    def __init__(self, graph: Graph, optimize: bool = True):
        self._input_graph = graph
        self._optimize = optimize
        self._optimized: Optional[Graph] = None
        self._annotations: Annotations = {}
        self._state: Dict[GraphId, Expression] = {}

    @property
    def input_graph(self) -> Graph:
        """The graph as handed in, without forcing the lazy optimize (the
        composition seam: ``attach_data`` splices this)."""
        return self._input_graph

    @property
    def graph(self) -> Graph:
        """The optimized graph (optimization happens once, lazily)."""
        if self._optimized is None:
            if self._optimize:
                optimizer = PipelineEnv.get_or_create().optimizer
                self._optimized, self._annotations = optimizer.execute(self._input_graph)
            else:
                self._optimized = self._input_graph
        return self._optimized

    def execute(self, graph_id: GraphId) -> Expression:
        graph = self.graph  # optimize before anything runs
        if isinstance(graph_id, SourceId):
            raise ValueError(f"cannot execute unconnected {graph_id}")
        if isinstance(graph_id, SinkId):
            return self.execute(graph.get_sink_dependency(graph_id))
        expr = self._state.get(graph_id)
        if expr is not None:
            return expr
        deps = [self.execute(d) for d in graph.get_dependencies(graph_id)]
        expr = graph.get_operator(graph_id).execute(deps)
        self._state[graph_id] = expr
        prefix = self._annotations.get(graph_id)
        if prefix is not None:
            PipelineEnv.get_or_create().state[prefix] = expr
        return expr
