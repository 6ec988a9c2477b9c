"""Segment planning: the DAG cut into maximal traceable segments between
materialization barriers (port of ``keystone_tpu/check/segments.py``).

Each segment is a connected sub-DAG every node of which could run inside
one captured program; each barrier is a point where data must
materialize: a Cacher, an out-of-core scan seam (a chunked leaf), a host
node (opaque, host sync, stateful), an estimator, saved state, or a
gather join. The plan is read for validation and reporting
(``Pipeline.check()``, ``--check``); dispatching segments is the compile
plane's work.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import lattice
from .abstract import Spec, SpecTuple, leaf_is_chunked

logger = logging.getLogger(__name__)

BARRIER_CACHER = "cacher"
BARRIER_SCAN_SEAM = "scan_seam"
BARRIER_HOST = "host"
BARRIER_ESTIMATOR = "estimator"
BARRIER_GATHER = "gather_join"
BARRIER_SAVED = "saved_state"
BARRIER_DATA = "data_leaf"


@dataclass
class Segment:
    """One maximal traceable sub-DAG between barriers."""

    index: int
    nodes: List[Any] = field(default_factory=list)  # topological order
    #: the external inputs (barrier nodes, sources) the segment reads, in
    #: the topological order of their producers: a stable positional
    #: contract across processes
    inputs: List[Any] = field(default_factory=list)
    #: nodes whose value leaves the segment (read outside it or by a sink)
    outputs: List[Any] = field(default_factory=list)
    #: bytes one item makes across the segment's node outputs (from the
    #: specs, else the cost model's evidence), None when nothing was known
    est_item_bytes: Optional[int] = None

    def __len__(self) -> int:
        return len(self.nodes)


def barrier_reason(op: Any, verdict: str, *, is_chunked_leaf: bool = False) -> Optional[str]:
    """Why ``op`` is a materialization barrier, or None (segment-eligible).
    A Cacher is a barrier whatever its verdict: it is traceable (the
    identity), but it exists to materialize."""
    from ..workflow.operators import (
        DatasetOperator,
        DatumOperator,
        DelegatingOperator,
        EstimatorOperator,
        ExpressionOperator,
        GatherTransformerOperator,
    )

    if isinstance(op, (DatasetOperator, DatumOperator)):
        return BARRIER_SCAN_SEAM if is_chunked_leaf else BARRIER_DATA
    if isinstance(op, ExpressionOperator):
        return BARRIER_SAVED
    if isinstance(op, (DelegatingOperator, EstimatorOperator)):
        return BARRIER_ESTIMATOR
    if isinstance(op, GatherTransformerOperator):
        return BARRIER_GATHER
    if type(op).__name__ == "Cacher":
        return BARRIER_CACHER
    if lattice.blocks_jit(verdict) or verdict == lattice.HOST_CALLBACK:
        return BARRIER_HOST
    return None


def _spec_item_bytes(av: Any) -> Optional[int]:
    if isinstance(av, Spec):
        return av.item_bytes()
    if isinstance(av, SpecTuple):
        known = [b for b in (_spec_item_bytes(e) for e in av.elems) if b is not None]
        return sum(known) if known else None
    return None


def plan_segments(graph: Any, verdicts: Dict[Any, str], specs: Dict[Any, Any], *,
                  cost_estimator: Any = None) -> Tuple[List[Segment], Dict[Any, str]]:
    """Partition ``graph`` into maximal traceable segments: the connected
    components of the segment-eligible nodes under graph edges, numbered
    in topological order of their first node. Returns ``(segments,
    barriers)``, ``barriers`` mapping each other node to its reason."""
    from ..workflow import analysis
    from ..workflow.graph import NodeId

    full_order = list(analysis.linearize(graph))
    full_pos = {gid: i for i, gid in enumerate(full_order)}
    order = [n for n in full_order if isinstance(n, NodeId) and n in graph.operators]
    barriers: Dict[Any, str] = {}
    eligible = set()
    for n in order:
        op = graph.get_operator(n)
        reason = barrier_reason(op, verdicts.get(n, lattice.OPAQUE),
                                is_chunked_leaf=leaf_is_chunked(op))
        if reason is None:
            eligible.add(n)
        else:
            barriers[n] = reason

    parent: Dict[Any, Any] = {n: n for n in eligible}

    def find(x):
        while parent[x] is not x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for n in eligible:
        for d in graph.get_dependencies(n):
            if d in eligible:
                ra, rb = find(n), find(d)
                if ra is not rb:
                    parent[ra] = rb

    groups: Dict[Any, List[Any]] = {}
    for n in order:
        if n in eligible:
            groups.setdefault(find(n), []).append(n)

    consumers: Dict[Any, set] = {}
    for n in order:
        for d in graph.get_dependencies(n):
            consumers.setdefault(d, set()).add(n)
    sink_deps = set(graph.sink_dependencies.values())

    topo_pos = {n: i for i, n in enumerate(order)}
    segments: List[Segment] = []
    for i, members in enumerate(sorted(groups.values(), key=lambda ms: topo_pos[ms[0]])):
        mset = set(members)
        seen, inputs = set(), []
        for n in members:
            for d in graph.get_dependencies(n):
                if d not in mset and d not in seen:
                    seen.add(d)
                    inputs.append(d)
        inputs.sort(key=lambda d: full_pos[d])
        outputs = [n for n in members
                   if n in sink_deps or (consumers.get(n, set()) - mset)]
        seg = Segment(index=i, nodes=list(members), inputs=inputs, outputs=outputs)
        seg.est_item_bytes = _estimate_item_bytes(graph, members, specs, cost_estimator)
        segments.append(seg)
    return segments, barriers


def _estimate_item_bytes(graph, members, specs, cost_estimator) -> Optional[int]:
    total, any_known = 0, False
    for n in members:
        b = _spec_item_bytes(specs.get(n))
        if b is None and cost_estimator is not None:
            priced = cost_estimator.node_profile_ns(type(graph.get_operator(n)).__name__, 1)
            if priced is not None:
                b = int(priced[1])
        if b is not None:
            total += b
            any_known = True
    return total if any_known else None
