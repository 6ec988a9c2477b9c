"""Graph traversal helpers (port of ``keystone_tpu/workflow/analysis.py``;
parity: ``workflow/AnalysisUtils.scala``)."""

from __future__ import annotations

from typing import List, Set

from .graph import Graph, GraphId, NodeId, NodeOrSourceId, SinkId


def get_parents(graph: Graph, gid: GraphId) -> List[NodeOrSourceId]:
    """Immediate dependencies of ``gid`` (ordered, possibly repeated)."""
    if isinstance(gid, SinkId):
        return [graph.get_sink_dependency(gid)]
    if isinstance(gid, NodeId):
        return list(graph.get_dependencies(gid))
    return []


def get_ancestors(graph: Graph, gid: GraphId) -> Set[NodeOrSourceId]:
    """All transitive dependencies of ``gid`` (not including itself)."""
    seen: Set[NodeOrSourceId] = set()
    stack = list(get_parents(graph, gid))
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(get_parents(graph, cur))
    return seen


def get_children(graph: Graph, gid: GraphId) -> Set[GraphId]:
    out: Set[GraphId] = set()
    for node, deps in graph.dependencies.items():
        if gid in deps:
            out.add(node)
    for sink, dep in graph.sink_dependencies.items():
        if dep == gid:
            out.add(sink)
    return out


def get_descendants(graph: Graph, gid: GraphId) -> Set[GraphId]:
    seen: Set[GraphId] = set()
    stack = list(get_children(graph, gid))
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(get_children(graph, cur))
    return seen


def linearize(graph: Graph) -> List[GraphId]:
    """A topological order over sources, nodes, and sinks (dependencies first)."""
    order: List[GraphId] = []
    visited: Set[GraphId] = set()

    def visit(gid: GraphId) -> None:
        if gid in visited:
            return
        visited.add(gid)
        for p in get_parents(graph, gid):
            visit(p)
        order.append(gid)

    for sink in sorted(graph.sinks):
        visit(sink)
    # include disconnected nodes/sources too
    for node in sorted(graph.nodes):
        visit(node)
    for source in sorted(graph.sources):
        visit(source)
    return order
