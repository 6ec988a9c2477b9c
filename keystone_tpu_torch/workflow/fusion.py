"""Whole-chain fusion: collapse traceable transformer subgraphs into one
operator (port of ``keystone_tpu/workflow/fusion.py``).

The JAX package compiles each fused group to one XLA program, which keeps
every intermediate on the device and frees it as the program goes. The
counterpart here is one operator per group that runs its steps, when
every step is row-local, over row chunks of :data:`ROW_CHUNK`: the large
intermediates of a featurizer (a conv output of 14.6 GB for 50000 CIFAR
images, 200 FFT branches of 24.6 GB for 60000 MNIST images) then never
exist for the whole batch at once, and the chunk outputs are written into
one output allocated at the first chunk. On CUDA each chunk (or the whole
batch, for a group that is not row-local) is one replay of a CUDA graph
captured per input signature (``cuda_graph.py``), as XLA compiles one
program per shape; on the CPU the steps run eagerly.

A node is traceable here when it is a ``TransformerOperator`` with a
``forward`` and no ``no_fuse`` mark, or a gather.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, List, Sequence, Tuple

import torch

from ..data.dataset import Dataset, Payload, first_leaf, map_leaves
from . import analysis
from .cuda_graph import GraphCache
from .expressions import DatasetExpression, DatumExpression
from .graph import Graph, NodeId
from .operators import GatherTransformerOperator, TransformerOperator, structural_key
from .rules import Annotations, Rule

#: rows per chunk when a fused group of row-local steps runs over a batch
ROW_CHUNK = 2500

#: the CUDA graphs of fused groups, shared by every group of equal content
#: on one device (the JAX package's ``_FUSED_JIT_CACHE``): each
#: ``Pipeline.apply`` optimizes anew and builds new fused operators, which
#: then replay the graphs an equal group captured before. LRU, so that a
#: process fitting many pipelines does not keep every one's graphs and
#: parameters; an entry holds its graphs' memory pool while it lives.
_FUSED_GRAPHS: "OrderedDict[tuple, GraphCache]" = OrderedDict()
_FUSED_GRAPHS_MAX = 64


def clear_graph_cache() -> None:
    """Drop the shared graphs of fused groups, and the device memory they
    hold (each group's own reference goes when the group goes)."""
    _FUSED_GRAPHS.clear()


def _rows(X: Payload, start: int, end: int) -> Payload:
    return map_leaves(lambda t: t[start:end], X)


def _copy_rows(out: Payload, part: Payload, start: int) -> None:
    if isinstance(out, tuple):
        for o, p in zip(out, part):
            _copy_rows(o, p, start)
    else:
        out[start:start + part.shape[0]].copy_(part)


def forward_in_row_chunks(forward, arrays: Sequence[Payload], n: int) -> Payload:
    """``forward(*arrays)`` of a row-local function, run over row chunks of
    :data:`ROW_CHUNK` and writing each chunk's output into one output
    allocated at the first chunk (never a list of chunk outputs joined at
    the end, which would hold the output twice)."""
    out = None
    for s in range(0, n, ROW_CHUNK):
        part = forward(*[_rows(a, s, s + ROW_CHUNK) for a in arrays])
        if out is None:
            out = map_leaves(
                lambda p: torch.empty((n,) + tuple(p.shape[1:]), dtype=p.dtype,
                                      device=p.device),
                part)
        _copy_rows(out, part, s)
        del part
    return out


def _run_steps(steps, last_use, xs: Sequence[Payload]) -> Payload:
    """A fused group's steps on its inputs ``xs``, each value dropped after
    the last step that reads it."""
    values: List[Any] = list(xs)
    for k, (op, deps) in enumerate(steps):
        args = [values[i] for i in deps]
        if isinstance(op, GatherTransformerOperator):
            values.append(tuple(args))
        else:
            values.append(op.forward(*args))
        del args
        for i in deps:
            if last_use[i] == k:
                values[i] = None
    return values[-1]


class FusedTransformerOperator(TransformerOperator):
    """A linearized traceable sub-DAG run as one operator.

    ``steps`` is a topologically-ordered list of ``(op, dep_indices)``; the
    value index space is ``[0, n_inputs)`` for the fused node's inputs
    followed by one slot per step. The last step is the output.
    """

    def __init__(self, steps: Sequence[Tuple[TransformerOperator, Tuple[int, ...]]],
                 n_inputs: int):
        self.steps = list(steps)
        self.n_inputs = n_inputs
        # the last step that reads each value: forward drops a value there,
        # so a chunk holds the live intermediates only, as XLA's program does
        last = [-1] * (n_inputs + len(self.steps))
        for k, (_, deps) in enumerate(self.steps):
            for i in deps:
                last[i] = k
        self.last_use = tuple(last)
        #: the CUDA graphs of this group, one per input signature; built at
        #: the first CUDA call (the counterpart of the JAX package's ``_jit``)
        self._graphs = None

    @property
    def label(self) -> str:
        inner = " » ".join(op.label for op, _ in self.steps)
        return f"Fused[{inner}]"

    @property
    def row_local(self) -> bool:
        return all(getattr(op, "row_local", False) for op, _ in self.steps)

    @property
    def batch_coupled(self) -> bool:
        return any(getattr(op, "batch_coupled", False) for op, _ in self.steps)

    def graphs(self, device: torch.device) -> GraphCache:
        """This group's CUDA graphs on ``device``: those of an equal group
        (equal steps, as CSE compares them) when one ran there before,
        else new ones."""
        if self._graphs is None:
            # a step whose state has no content form keys by identity: the
            # groups that each ``Pipeline.apply`` builds anew hold the same
            # step objects, so they still share
            key = (str(device), self.n_inputs,
                   tuple((structural_key(op), deps) for op, deps in self.steps))
            try:
                cache = _FUSED_GRAPHS.get(key)
            except TypeError:  # a step that cannot be hashed
                key = cache = None
            if cache is None:
                # a function of the steps, not a bound method: the cache
                # must not hold the operator, or a dropped operator would
                # keep its graphs' memory until the garbage collector finds
                # the cycle
                steps, last_use = self.steps, self.last_use
                cache = GraphCache(lambda *xs: _run_steps(steps, last_use, xs))
                if key is not None:
                    _FUSED_GRAPHS[key] = cache
                    while len(_FUSED_GRAPHS) > _FUSED_GRAPHS_MAX:
                        _FUSED_GRAPHS.popitem(last=False)
            else:
                _FUSED_GRAPHS.move_to_end(key)
            self._graphs = cache
        return self._graphs

    def forward(self, *xs: Payload) -> Payload:
        return _run_steps(self.steps, self.last_use, xs)

    # -- operator glue --------------------------------------------------

    def batch_transform(self, inputs: Sequence[DatasetExpression]) -> Dataset:
        datasets = [d.get() for d in inputs]
        if all(ds.is_batched for ds in datasets):
            arrays = [ds.payload for ds in datasets]
            n = len(datasets[0])
            chunked = (self.row_local and n > ROW_CHUNK
                       and all(len(ds) == n for ds in datasets))
            lead = first_leaf(arrays[0])
            if lead.is_cuda:
                graphs = self.graphs(lead.device)
                # the graphs' static output is overwritten by the next
                # replay: it is copied out before another thread replays
                with graphs.lock:
                    if chunked:
                        return Dataset(forward_in_row_chunks(graphs, arrays, n))
                    return Dataset(map_leaves(torch.clone, graphs(*arrays)))
            if chunked:
                return Dataset(forward_in_row_chunks(self.forward, arrays, n))
            return Dataset(self.forward(*arrays))
        # item-list inputs: the per-op Dataset semantics the unfused graph
        # would have used
        values = list(datasets)
        for op, deps in self.steps:
            args = [DatasetExpression.now(values[i]) for i in deps]
            values.append(op.batch_transform(args))
        return values[-1]

    def single_transform(self, inputs: Sequence[DatumExpression]):
        values = [d.get() for d in inputs]
        for op, deps in self.steps:
            args = [DatumExpression.now(values[i]) for i in deps]
            values.append(op.single_transform(args))
        return values[-1]

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_graphs"] = None  # CUDA graphs do not pickle
        return state


class TraceFusionRule(Rule):
    """Replace maximal traceable transformer subgraphs (≥2 nodes) with
    :class:`FusedTransformerOperator` nodes.

    A node joins a group only if every consumer of its result is inside the
    group (so no fused intermediate is needed elsewhere), no sink reads it,
    and it carries no saveable-prefix annotation (those results must hit
    the state table). Estimators, delegating nodes and nodes without a
    ``forward`` bound the groups.
    """

    name = "TraceFusionRule"

    @staticmethod
    def _traceable(op) -> bool:
        if getattr(op, "no_fuse", False):
            return False
        if isinstance(op, GatherTransformerOperator):
            return True
        return (
            isinstance(op, TransformerOperator)
            and getattr(op, "forward", None) is not None
        )

    def apply(self, graph: Graph, annotations: Annotations) -> Tuple[Graph, Annotations]:
        consumers = {}
        for node in graph.nodes:
            for d in graph.get_dependencies(node):
                if isinstance(d, NodeId):
                    consumers.setdefault(d, set()).add(node)
        sink_consumed = set()
        for sink in graph.sinks:
            d = graph.get_sink_dependency(sink)
            if isinstance(d, NodeId):
                sink_consumed.add(d)

        order = [n for n in analysis.linearize(graph) if isinstance(n, NodeId)]
        assigned = set()
        groups: List[Tuple[NodeId, set]] = []
        for out in reversed(order):
            if (
                out in assigned
                or out in annotations
                or not self._traceable(graph.get_operator(out))
            ):
                continue
            group = {out}
            changed = True
            while changed:
                changed = False
                for member in list(group):
                    for d in graph.get_dependencies(member):
                        if (
                            isinstance(d, NodeId)
                            and d not in group
                            and d not in assigned
                            and d not in annotations
                            and d not in sink_consumed
                            and self._traceable(graph.get_operator(d))
                            and consumers.get(d, set()) <= group
                        ):
                            group.add(d)
                            changed = True
            if len(group) >= 2:
                groups.append((out, group))
                assigned |= group

        for out, group in groups:
            inner_order = [n for n in order if n in group]
            pos = {n: i for i, n in enumerate(inner_order)}
            ext: List = []
            for n in inner_order:
                for d in graph.get_dependencies(n):
                    if (not isinstance(d, NodeId) or d not in group) and d not in ext:
                        ext.append(d)
            ext_index = {d: i for i, d in enumerate(ext)}
            steps = []
            for n in inner_order:
                dep_idx = tuple(
                    len(ext) + pos[d]
                    if isinstance(d, NodeId) and d in group
                    else ext_index[d]
                    for d in graph.get_dependencies(n)
                )
                steps.append((graph.get_operator(n), dep_idx))
            fused = FusedTransformerOperator(steps, len(ext))

            rep = Graph()
            src_ids = []
            for _ in ext:
                rep, s = rep.add_source()
                src_ids.append(s)
            rep, fused_node = rep.add_node(fused, src_ids)
            rep, rep_sink = rep.add_sink(fused_node)
            graph = graph.replace_nodes(
                frozenset(group),
                rep,
                dep_splice={s: d for s, d in zip(src_ids, ext)},
                out_splice={out: rep_sink},
            )

        ann = {n: p for n, p in annotations.items() if n in graph.operators}
        return graph, ann
