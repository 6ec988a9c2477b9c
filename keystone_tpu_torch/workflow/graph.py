"""Immutable untyped dataflow DAG (a copy of
``keystone_tpu/workflow/graph.py``: pure Python, kept here so that the
port imports nothing of the JAX package).

This is the middle of the three-level pipeline representation: the typed
``andThen`` chaining API (``Chainable`` in ``pipeline.py``) builds one of these, the rule
based optimizer (``rules.py``) rewrites it, and the pull-based executor
(``executor.py``) runs it.

Behavioral parity target: ``workflow/Graph.scala`` and ``workflow/GraphId.scala``
in the reference (KeystoneML). The design here is a frozen dataclass with pure
rewriting methods that each return a new ``Graph``; nothing mutates.

Identity model:
  * ``SourceId`` — a named input slot of the graph (data fed at execution time).
  * ``NodeId`` — an operator instance in the DAG.
  * ``SinkId`` — a named output slot, depending on exactly one node or source.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Dict, FrozenSet, Iterable, Mapping, Sequence, Tuple, Union

if TYPE_CHECKING:  # pragma: no cover
    from .operators import Operator


@dataclass(frozen=True, order=True)
class NodeId:
    id: int

    def __repr__(self) -> str:
        return f"node[{self.id}]"


@dataclass(frozen=True, order=True)
class SourceId:
    id: int

    def __repr__(self) -> str:
        return f"source[{self.id}]"


@dataclass(frozen=True, order=True)
class SinkId:
    id: int

    def __repr__(self) -> str:
        return f"sink[{self.id}]"


#: Anything a node or sink may depend on.
NodeOrSourceId = Union[NodeId, SourceId]
#: Anything with an integer id in the graph.
GraphId = Union[NodeId, SourceId, SinkId]


class GraphError(ValueError):
    """Raised on structurally-invalid graph edits (missing ids, collisions)."""


def _max_id(ids: Iterable[int]) -> int:
    m = -1
    for i in ids:
        if i > m:
            m = i
    return m


@dataclass(frozen=True)
class Graph:
    """An immutable DAG of untyped operators.

    Attributes:
      sources: input slots of the graph.
      sink_dependencies: sink -> the node/source it reads.
      operators: node -> operator.
      dependencies: node -> ordered dependencies (nodes or sources).
    """

    sources: FrozenSet[SourceId] = frozenset()
    sink_dependencies: Mapping[SinkId, NodeOrSourceId] = field(default_factory=dict)
    operators: Mapping[NodeId, "Operator"] = field(default_factory=dict)
    dependencies: Mapping[NodeId, Tuple[NodeOrSourceId, ...]] = field(default_factory=dict)

    # ---- accessors ------------------------------------------------------

    @property
    def nodes(self) -> FrozenSet[NodeId]:
        return frozenset(self.operators.keys())

    @property
    def sinks(self) -> FrozenSet[SinkId]:
        return frozenset(self.sink_dependencies.keys())

    def get_operator(self, node: NodeId) -> "Operator":
        self._require_node(node)
        return self.operators[node]

    def get_dependencies(self, node: NodeId) -> Tuple[NodeOrSourceId, ...]:
        self._require_node(node)
        return self.dependencies[node]

    def get_sink_dependency(self, sink: SinkId) -> NodeOrSourceId:
        if sink not in self.sink_dependencies:
            raise GraphError(f"{sink} is not in the graph")
        return self.sink_dependencies[sink]

    # ---- id allocation --------------------------------------------------

    def _next_node_id(self) -> NodeId:
        return NodeId(_max_id(n.id for n in self.operators) + 1)

    def _next_source_id(self) -> SourceId:
        return SourceId(_max_id(s.id for s in self.sources) + 1)

    def _next_sink_id(self) -> SinkId:
        return SinkId(_max_id(s.id for s in self.sink_dependencies) + 1)

    # ---- validation helpers --------------------------------------------

    def _require_node(self, node: NodeId) -> None:
        if node not in self.operators:
            raise GraphError(f"{node} is not in the graph")

    def _require_dep_exists(self, dep: NodeOrSourceId) -> None:
        if isinstance(dep, NodeId):
            if dep not in self.operators:
                raise GraphError(f"dependency {dep} is not in the graph")
        elif isinstance(dep, SourceId):
            if dep not in self.sources:
                raise GraphError(f"dependency {dep} is not in the graph")
        else:  # pragma: no cover - type guard
            raise GraphError(f"invalid dependency {dep!r}")

    # ---- single-element edits ------------------------------------------

    def add_node(self, op: "Operator", deps: Sequence[NodeOrSourceId]) -> Tuple["Graph", NodeId]:
        """Add an operator with the given dependencies; returns (graph, new id)."""
        for d in deps:
            self._require_dep_exists(d)
        node = self._next_node_id()
        ops = dict(self.operators)
        ops[node] = op
        dep_map = dict(self.dependencies)
        dep_map[node] = tuple(deps)
        return replace(self, operators=ops, dependencies=dep_map), node

    def add_source(self) -> Tuple["Graph", SourceId]:
        source = self._next_source_id()
        return replace(self, sources=self.sources | {source}), source

    def add_sink(self, dep: NodeOrSourceId) -> Tuple["Graph", SinkId]:
        self._require_dep_exists(dep)
        sink = self._next_sink_id()
        sink_deps = dict(self.sink_dependencies)
        sink_deps[sink] = dep
        return replace(self, sink_dependencies=sink_deps), sink

    def set_dependencies(self, node: NodeId, deps: Sequence[NodeOrSourceId]) -> "Graph":
        self._require_node(node)
        for d in deps:
            self._require_dep_exists(d)
        dep_map = dict(self.dependencies)
        dep_map[node] = tuple(deps)
        return replace(self, dependencies=dep_map)

    def set_operator(self, node: NodeId, op: "Operator") -> "Graph":
        self._require_node(node)
        ops = dict(self.operators)
        ops[node] = op
        return replace(self, operators=ops)

    def set_sink_dependency(self, sink: SinkId, dep: NodeOrSourceId) -> "Graph":
        if sink not in self.sink_dependencies:
            raise GraphError(f"{sink} is not in the graph")
        self._require_dep_exists(dep)
        sink_deps = dict(self.sink_dependencies)
        sink_deps[sink] = dep
        return replace(self, sink_dependencies=sink_deps)

    def remove_sink(self, sink: SinkId) -> "Graph":
        if sink not in self.sink_dependencies:
            raise GraphError(f"{sink} is not in the graph")
        sink_deps = dict(self.sink_dependencies)
        del sink_deps[sink]
        return replace(self, sink_dependencies=sink_deps)

    def remove_source(self, source: SourceId) -> "Graph":
        """Remove a source. It must not be depended on by any node or sink."""
        if source not in self.sources:
            raise GraphError(f"{source} is not in the graph")
        for node, deps in self.dependencies.items():
            if source in deps:
                raise GraphError(f"cannot remove {source}: {node} depends on it")
        for sink, dep in self.sink_dependencies.items():
            if dep == source:
                raise GraphError(f"cannot remove {source}: {sink} depends on it")
        return replace(self, sources=self.sources - {source})

    def remove_node(self, node: NodeId) -> "Graph":
        """Remove a node. It must not be depended on by any node or sink."""
        self._require_node(node)
        for other, deps in self.dependencies.items():
            if other != node and node in deps:
                raise GraphError(f"cannot remove {node}: {other} depends on it")
        for sink, dep in self.sink_dependencies.items():
            if dep == node:
                raise GraphError(f"cannot remove {node}: {sink} depends on it")
        ops = dict(self.operators)
        del ops[node]
        dep_map = dict(self.dependencies)
        del dep_map[node]
        return replace(self, operators=ops, dependencies=dep_map)

    def replace_dependency(self, old: NodeOrSourceId, new: NodeOrSourceId) -> "Graph":
        """Point every edge that read ``old`` at ``new`` instead."""
        self._require_dep_exists(new)
        dep_map = {
            node: tuple(new if d == old else d for d in deps)
            for node, deps in self.dependencies.items()
        }
        sink_deps = {
            sink: (new if d == old else d) for sink, d in self.sink_dependencies.items()
        }
        return replace(self, dependencies=dep_map, sink_dependencies=sink_deps)

    # ---- whole-graph edits ---------------------------------------------

    def add_graph(self, other: "Graph") -> Tuple["Graph", Dict[SourceId, SourceId], Dict[SinkId, SinkId]]:
        """Disjoint union with ``other``; its ids are renumbered.

        Returns (merged graph, other's source id -> new id, other's sink id -> new id).
        """
        node_base = _max_id(n.id for n in self.operators) + 1
        source_base = _max_id(s.id for s in self.sources) + 1
        sink_base = _max_id(s.id for s in self.sink_dependencies) + 1

        node_map = {n: NodeId(node_base + i) for i, n in enumerate(sorted(other.operators.keys()))}
        source_map = {s: SourceId(source_base + i) for i, s in enumerate(sorted(other.sources))}
        sink_map = {s: SinkId(sink_base + i) for i, s in enumerate(sorted(other.sink_dependencies.keys()))}

        def remap(d: NodeOrSourceId) -> NodeOrSourceId:
            return node_map[d] if isinstance(d, NodeId) else source_map[d]

        ops = dict(self.operators)
        dep_map = dict(self.dependencies)
        for n, op in other.operators.items():
            ops[node_map[n]] = op
            dep_map[node_map[n]] = tuple(remap(d) for d in other.dependencies[n])
        sink_deps = dict(self.sink_dependencies)
        for s, d in other.sink_dependencies.items():
            sink_deps[sink_map[s]] = remap(d)
        merged = replace(
            self,
            sources=self.sources | frozenset(source_map.values()),
            operators=ops,
            dependencies=dep_map,
            sink_dependencies=sink_deps,
        )
        return merged, source_map, sink_map

    def connect_graph(
        self, other: "Graph", splice: Mapping[SinkId, SourceId]
    ) -> Tuple["Graph", Dict[SourceId, SourceId], Dict[SinkId, SinkId]]:
        """Union with ``other`` wiring this graph's sinks into other's sources.

        ``splice`` maps a sink of ``self`` to a source of ``other``; each spliced
        pair disappears (consumers of the source read the sink's dependency).
        Returns (graph, other-source map for unspliced sources, other-sink map).
        """
        for snk, src in splice.items():
            if snk not in self.sink_dependencies:
                raise GraphError(f"{snk} is not a sink of the base graph")
            if src not in other.sources:
                raise GraphError(f"{src} is not a source of the appended graph")
        merged, source_map, sink_map = self.add_graph(other)
        for snk, src in splice.items():
            target = self.sink_dependencies[snk]
            merged = merged.replace_dependency(source_map[src], target)
            merged = merged.remove_source(source_map[src])
            merged = merged.remove_sink(snk)
        final_source_map = {s: m for s, m in source_map.items() if s not in splice.values()}
        return merged, final_source_map, sink_map

    def replace_nodes(self, to_remove: FrozenSet[NodeId], replacement: "Graph",
                      dep_splice: Mapping[SourceId, NodeOrSourceId],
                      out_splice: Mapping[NodeId, SinkId]) -> "Graph":
        """Swap the subgraph ``to_remove`` for ``replacement``.

        ``dep_splice`` wires each replacement source to an id of the remaining
        graph; ``out_splice`` says which replacement sink stands in for each
        removed node that the remaining graph depended on.
        """
        for n in to_remove:
            self._require_node(n)
        for src in replacement.sources:
            if src not in dep_splice:
                raise GraphError(f"replacement {src} not spliced")
        # every removed node that is still referenced must have a replacement sink
        referenced = set()
        for node, deps in self.dependencies.items():
            if node in to_remove:
                continue
            referenced.update(d for d in deps if isinstance(d, NodeId) and d in to_remove)
        referenced.update(
            d for d in self.sink_dependencies.values() if isinstance(d, NodeId) and d in to_remove
        )
        for n in referenced:
            if n not in out_splice:
                raise GraphError(f"removed {n} is referenced but has no replacement sink")
        for src, tgt in dep_splice.items():
            if isinstance(tgt, NodeId) and tgt in to_remove:
                raise GraphError("dep_splice target is being removed")

        merged, source_map, sink_map = self.add_graph(replacement)
        # rewire edges into removed nodes -> replacement sinks' dependencies
        for removed, sink in out_splice.items():
            new_target = merged.get_sink_dependency(sink_map[sink])
            merged = merged.replace_dependency(removed, new_target)
        # wire replacement sources to their splice targets
        for src, tgt in dep_splice.items():
            merged = merged.replace_dependency(source_map[src], tgt)
            merged = merged.remove_source(source_map[src])
        # drop replacement sinks
        for sink in replacement.sink_dependencies:
            merged = merged.remove_sink(sink_map[sink])
        # drop removed nodes (reverse topological: repeatedly remove unreferenced)
        remaining = set(to_remove)
        while remaining:
            progressed = False
            for n in list(remaining):
                try:
                    merged = merged.remove_node(n)
                except GraphError:
                    continue
                remaining.discard(n)
                progressed = True
            if not progressed:
                raise GraphError(f"could not remove nodes {remaining}: still referenced")
        return merged

    # ---- debugging ------------------------------------------------------

    def to_dot(self, name: str = "pipeline") -> str:
        """Graphviz DOT rendering (parity: Graph.toDOTString in the reference)."""
        lines = [f"digraph {name} {{", "  rankdir=LR;"]
        for s in sorted(self.sources):
            lines.append(f'  source_{s.id} [label="source {s.id}" shape=oval];')
        for n in sorted(self.operators):
            label = type(self.operators[n]).__name__
            op_label = getattr(self.operators[n], "label", None) or label
            lines.append(f'  node_{n.id} [label="{op_label}" shape=box];')
        for s in sorted(self.sink_dependencies):
            lines.append(f'  sink_{s.id} [label="sink {s.id}" shape=oval];')

        def ref(d: NodeOrSourceId) -> str:
            return f"node_{d.id}" if isinstance(d, NodeId) else f"source_{d.id}"

        for n in sorted(self.operators):
            for d in self.dependencies[n]:
                lines.append(f"  {ref(d)} -> node_{n.id};")
        for s in sorted(self.sink_dependencies):
            lines.append(f"  {ref(self.sink_dependencies[s])} -> sink_{s.id};")
        lines.append("}")
        return "\n".join(lines)
