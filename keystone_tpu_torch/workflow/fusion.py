"""Whole-chain fusion: collapse traceable transformer subgraphs into one
operator (port of ``keystone_tpu/workflow/fusion.py``).

The JAX package compiles each fused group to one XLA program, which keeps
every intermediate on the device and frees it as the program goes. The
counterpart here is one operator per group that runs its steps, when
every step is row-local, over row chunks: the large intermediates of a
featurizer (a conv output of 14.6 GB for 50000 CIFAR images, 200 FFT
branches of 24.6 GB for 60000 MNIST images) then never exist for the
whole batch at once, and the chunk outputs are written into one output
allocated at the first chunk. A chunk is at most :data:`ROW_CHUNK` rows
and at most :data:`CHUNK_BYTES` of live values (:func:`chunk_rows`): a row
of dense SIFT descriptors of one 256² image is 12 MB, so an image
featurizer's chunk is a few dozen rows where a CIFAR chunk is 2500. On
CUDA each chunk (or the whole batch, for a group that is not row-local)
is one replay of a CUDA graph captured per input signature
(``cuda_graph.py``), as XLA compiles one program per shape; on the CPU the
steps run eagerly.

On an out-of-core ``ChunkedDataset`` a fused group runs lazily, chunk by
chunk, on the scan's consumer: a ragged chunk is padded up to one of a
few row buckets (``pipeline_scan.ChunkPadder``), so a scan replays at most
``len(bucket_ladder(lead rows))`` graphs of chunk shape, and several
inputs are zipped per chunk (``chunked.align_and_zip``). A group with a
batch-coupled step refuses chunked input.

A node is traceable here when it is a ``TransformerOperator`` with a
``forward``, no ``no_fuse`` mark and no host sync in its ``forward`` (the
``host_callback`` verdict of ``check/lattice.py``), or a gather.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ..data.chunked import align_and_zip
from ..data.dataset import Dataset, Payload, first_leaf, map_leaves
from ..data.pipeline_scan import ChunkPadder
from ..data.sparse import SparseRows
from ..check import lattice
from . import analysis
from .cuda_graph import GraphCache, leaves, signature
from .expressions import DatasetExpression, DatumExpression
from .graph import Graph, NodeId
from .operators import GatherTransformerOperator, TransformerOperator, structural_key
from .rules import Annotations, Rule

#: rows per chunk when a fused group of row-local steps runs over a batch
ROW_CHUNK = 2500

#: bytes a chunk's live values may take: its inputs, the step outputs alive
#: at once and the temporaries a step declares (``row_work_bytes``). CIFAR's
#: (0.9 MB a row), MNIST's at 200 FFTs (0.8 MB) and TIMIT's at 50 branches
#: (1.6 MB) stay at ROW_CHUNK rows under it
CHUNK_BYTES = 4 << 30

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


def payload_bytes(values: Sequence[Any]) -> int:
    """Bytes of the tensors in ``values`` (payloads, tuples of them, or
    None), each tensor counted once however often it appears."""
    seen = set()
    total = 0
    for t in leaves([v for v in values if v is not None]):
        key = (t.data_ptr(), t.numel())
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def chunk_rows(row_bytes: int) -> int:
    """Rows of a chunk whose rows take ``row_bytes`` each: as many as fit
    in :data:`CHUNK_BYTES`, at least one and at most :data:`ROW_CHUNK`."""
    return max(1, min(ROW_CHUNK, CHUNK_BYTES // max(1, int(row_bytes))))


def forward_in_row_chunks(forward, arrays: Sequence[Payload], n: int,
                          rows: Optional[int] = None) -> Payload:
    """``forward(*arrays)`` of a row-local function, run over chunks of
    ``rows`` rows (:data:`ROW_CHUNK` by default) and writing each chunk's
    output into one output allocated at the first chunk (never a list of
    chunk outputs joined at the end, which would hold the output twice)."""
    rows = ROW_CHUNK if rows is None else rows
    out = None
    for s in range(0, n, rows):
        part = forward(*[_rows(a, s, s + rows) for a in arrays])
        if out is None:
            out = map_leaves(
                lambda p: torch.empty((n,) + tuple(p.shape[1:]), dtype=p.dtype,
                                      device=p.device),
                part)
        _copy_rows(out, part, s)
        del part
    return out


def _run_steps(steps, last_use, xs: Sequence[Payload], meter: Optional[list] = None) -> Payload:
    """A fused group's steps on its inputs ``xs``, each value dropped after
    the last step that reads it. With ``meter`` (a one-element list), the
    most bytes alive at once is kept in ``meter[0]``: after each step, the
    live values plus what the step declares beyond its output
    (``row_work_bytes``)."""
    values: List[Any] = list(xs)
    for k, (op, deps) in enumerate(steps):
        args = [values[i] for i in deps]
        if isinstance(op, GatherTransformerOperator):
            values.append(tuple(args))
        else:
            values.append(op.forward(*args))
        if meter is not None:
            work = getattr(op, "row_work_bytes", None)
            extra = max(0, work(*args) - payload_bytes([values[-1]])) if work else 0
            meter[0] = max(meter[0], payload_bytes(values) + extra)
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

    #: the CUDA graphs and the measured row bytes are memos of this
    #: process: a warm group fingerprints as a fresh one (AOT cache key)
    aot_fingerprint_exclude = ("_graphs", "_row_bytes")

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
        #: bytes one row keeps alive, by the signature of one input row
        self._row_bytes: Dict[tuple, int] = {}

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

    def row_bytes(self, xs: Sequence[Payload]) -> int:
        """The most bytes one row of ``xs`` keeps alive while the steps run,
        measured once per input signature by running the steps on the
        first row (eagerly, outside any CUDA graph)."""
        one = [_rows(x, 0, 1) for x in xs]
        sig = signature(tuple(one))
        hit = self._row_bytes.get(sig)
        if hit is None:
            meter = [payload_bytes(one)]
            with torch.no_grad():
                _run_steps(self.steps, self.last_use, one, meter)
            hit = self._row_bytes[sig] = meter[0]
        return hit

    def chunk_rows(self, xs: Sequence[Payload]) -> int:
        """Rows per chunk of this group on ``xs``: the whole batch when the
        group is not row-local, else :func:`chunk_rows` of its row bytes."""
        n = int(first_leaf(xs[0]).shape[0])
        if not self.row_local or n == 0:
            return max(n, 1)
        return chunk_rows(self.row_bytes(xs))

    def forward(self, *xs: Payload) -> Payload:
        """The steps on ``xs``; a row-local group on more rows than
        :meth:`chunk_rows` runs them chunk by chunk into one output, so a
        whole-chain program (``FittedPipeline.compile``) holding this group
        keeps its intermediates to a chunk as well."""
        n = int(first_leaf(xs[0]).shape[0]) if xs else 0
        if xs and is_fake(first_leaf(xs[0])):
            # fake tensors (the static checker, a torch.export trace) measure
            # nothing: the row chunks a real run measured for this signature
            # are kept, else the whole batch runs at once
            known = self._row_bytes.get(signature(tuple(_rows(x, 0, 1) for x in xs)))
            rows = chunk_rows(known) if known is not None and self.row_local else n
        else:
            rows = self.chunk_rows(xs) if xs else 1
        if n > rows:
            return forward_in_row_chunks(
                lambda *c: _run_steps(self.steps, self.last_use, c), xs, n, rows)
        return _run_steps(self.steps, self.last_use, xs)

    # -- operator glue --------------------------------------------------

    def _transform_arrays(self, arrays: Sequence[Payload]) -> Payload:
        """The group on batched payloads: in row chunks when row-local, as
        CUDA-graph replays on the card."""
        n = int(first_leaf(arrays[0]).shape[0])
        rows = n
        if self.row_local and all(int(first_leaf(a).shape[0]) == n for a in arrays):
            rows = self.chunk_rows(arrays)
        chunked = n > rows
        lead = first_leaf(arrays[0])
        if lead.is_cuda:
            graphs = self.graphs(lead.device)
            # the graphs' static output is overwritten by the next replay:
            # it is copied out before another thread replays
            with graphs.lock:
                if chunked:
                    return forward_in_row_chunks(graphs, arrays, n, rows)
                return map_leaves(torch.clone, graphs(*arrays))
        if chunked:
            return forward_in_row_chunks(self.forward, arrays, n, rows)
        return self.forward(*arrays)

    def batch_transform(self, inputs: Sequence[DatasetExpression]) -> Dataset:
        datasets = [d.get() for d in inputs]
        if any(ds.is_chunked for ds in datasets):
            if self.batch_coupled:
                coupled = [op.label for op, _ in self.steps if getattr(op, "batch_coupled", False)]
                raise ValueError(f"batch-coupled node(s) {coupled} cannot run per chunk: "
                                 "their batch statistics would be a chunk's; materialize "
                                 "the dataset first")
            if len(datasets) == 1:
                return datasets[0].map_batch(ChunkPadder(lambda c: self._transform_arrays([c])))
            return align_and_zip(datasets).map_batch(
                ChunkPadder(lambda t: self._transform_arrays(list(t))))
        if all(ds.is_batched and not isinstance(ds.payload, SparseRows) for ds in datasets):
            return Dataset(self._transform_arrays([ds.payload for ds in datasets]))
        # item-list or sparse-row inputs: the per-op Dataset semantics the
        # unfused graph would have used (a SparseRows batch has no rows to
        # chunk into a CUDA graph; each step's own apply_batch reads it)
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
        # a node with a host sync runs alone: a fused group is captured as
        # a CUDA graph, and a sync cannot be captured (the JAX package fuses
        # a host callback, which its jit keeps on the host)
        return (
            isinstance(op, TransformerOperator)
            and getattr(op, "forward", None) is not None
            and lattice.classify(op) != lattice.HOST_CALLBACK
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
