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
    """A topological order over sources, nodes, and sinks (dependencies
    first): the post-order of a depth-first walk from the sinks, then from
    the nodes and sources no sink reaches.

    The walk keeps its own stack: a recursive local function would refer
    to itself and so make a reference cycle holding ``graph``, which frees
    the graph's data leaves only when the garbage collector next runs."""
    order: List[GraphId] = []
    visited: Set[GraphId] = set()
    roots = [*sorted(graph.sinks), *sorted(graph.nodes), *sorted(graph.sources)]
    for root in roots:
        if root in visited:
            continue
        visited.add(root)
        stack = [(root, iter(get_parents(graph, root)))]
        while stack:
            gid, parents = stack[-1]
            for p in parents:
                if p not in visited:
                    visited.add(p)
                    stack.append((p, iter(get_parents(graph, p))))
                    break
            else:
                stack.pop()
                order.append(gid)
    return order
