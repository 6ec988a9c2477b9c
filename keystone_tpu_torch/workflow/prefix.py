"""Logical identity of a node's upstream computation.

Port of ``keystone_tpu/workflow/prefix.py`` (parity target:
``workflow/Prefix.scala``). A prefix is the tree of operators
feeding a node — it is the *key* under which fit results are saved in
:class:`~keystone_tpu_torch.workflow.env.PipelineEnv` so that repeated ``apply`` /
``fit`` calls never refit an estimator. Operator identity is object identity,
exactly as in the reference (the same estimator instance applied to the same
dataset instance hits the cache; a structurally-equal copy does not).

A prefix only exists for nodes whose ancestry contains no unbound sources.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .graph import Graph, NodeOrSourceId, SourceId
from .operators import Operator


@dataclass(frozen=True)
class Prefix:
    operator: Operator  # identity-hashed unless the operator overrides eq/hash
    children: Tuple["Prefix", ...]

    def __hash__(self) -> int:
        return hash((self.operator, self.children))

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Prefix)
            and self.operator == other.operator
            and self.children == other.children
        )


def find_prefix(graph: Graph, gid: NodeOrSourceId) -> Optional[Prefix]:
    """The prefix tree rooted at ``gid``, or None if it depends on a source.

    Iterative with per-node memoization: shared subgraphs (diamonds, merged
    CSE nodes) are visited once, and deep chains don't hit the recursion limit.
    """
    memo: dict = {}
    UNRESOLVED = object()

    stack = [gid]
    while stack:
        cur = stack[-1]
        if cur in memo and memo[cur] is not UNRESOLVED:
            stack.pop()
            continue
        if isinstance(cur, SourceId):
            memo[cur] = None
            stack.pop()
            continue
        deps = graph.get_dependencies(cur)
        pending = [d for d in deps if d not in memo or memo[d] is UNRESOLVED]
        unvisited = [d for d in pending if d not in memo]
        if unvisited:
            memo[cur] = UNRESOLVED
            stack.extend(unvisited)
            continue
        children = [memo[d] for d in deps]
        if any(c is None or c is UNRESOLVED for c in children):
            memo[cur] = None
        else:
            memo[cur] = Prefix(graph.get_operator(cur), tuple(children))
        stack.pop()
    result = memo[gid]
    return None if result is UNRESOLVED else result
