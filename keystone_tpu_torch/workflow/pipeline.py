"""The typed pipeline layer: Chainable / Pipeline / lazy results /
FittedPipeline (port of ``keystone_tpu/workflow/pipeline.py``; parity:
``workflow/Chainable.scala``, ``Pipeline.scala``, ``PipelineResult.scala``,
``FittedPipeline.scala``).

A pipeline is an immutable graph (``graph.py``) with one unbound source
and one sink. ``and_then`` splices graphs; ``and_then(est, data[,
labels])`` adds the estimator fitted on ``self(data)`` and a delegating
node that applies its model. Nothing runs until ``.get()`` or ``fit()``:
then the rule optimizer (``optimizers.py``: saved-state load, CSE, trace
fusion) rewrites the graph and the pull executor (``executor.py``) runs
it. Fitted estimators are saved in :class:`~.env.PipelineEnv` under their
prefix, so an estimator fits once across ``fit`` and every application
of every pipeline that shares its prefix.

Ported: ``attach_data``/``attach_datum``, ``Chainable``, ``Pipeline``
(``apply``, ``apply_datum``, ``fit``, ``gather``, ``identity``),
``FittedPipeline`` (``apply``, ``apply_datum``, ``save``/``load``).
Left out, each with its own later item of work: the static checker
(``check``, ``_static_check``), ``fit_instrumentation`` (tracing and the
cost-model loop), one-program apply (``compile``, ``apply_compiled``,
``apply_chunked``) and the prefix absorption (``absorb``,
``prefix_features``) of the out-of-core tier.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..data.dataset import Dataset
from . import analysis
from .env import PipelineEnv
from .executor import GraphExecutor
from .expressions import Expression
from .graph import Graph, NodeId, NodeOrSourceId, SinkId, SourceId
from .operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    ExpressionOperator,
    GatherTransformerOperator,
    TransformerOperator,
)
from .rules import EquivalentNodeMergeRule, UnusedBranchRemovalRule


def clock() -> float:
    """Host time after the card has finished the work queued on it (a
    plain host clock measures only the enqueue on CUDA)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


# ---------------------------------------------------------------------------
# Lazy results
# ---------------------------------------------------------------------------


class PipelineResult:
    """A lazy handle on the output of a pipeline execution."""

    def __init__(self, executor: GraphExecutor, sink: SinkId):
        self._executor = executor
        self._sink = sink
        self._spliced: Optional[Graph] = None

    @property
    def spliced_graph(self) -> Graph:
        """The graph composition splices: CSE-canonicalized, not fully
        optimized. The structural merge is load-bearing: the serving-path
        and estimator-data copies of a prefix both root at the same data
        leaf here, and merging them keeps an L-stage chain's graph linear
        instead of 2^L. Everything else waits for the one ``fit``/``get``
        pass over the composed graph."""
        if self._executor._optimized is not None:
            return self._executor._optimized
        if self._spliced is None:
            self._spliced, _ = EquivalentNodeMergeRule().apply(
                self._executor.input_graph, {}
            )
        return self._spliced

    @property
    def sink(self) -> SinkId:
        return self._sink

    def expression(self) -> Expression:
        return self._executor.execute(self._sink)

    def get(self) -> Any:
        return self.expression().get()


class PipelineDataset(PipelineResult):
    """Lazy dataset result; also usable as the data input of another
    pipeline or estimator (its graph is spliced in, staying lazy)."""

    def get(self) -> Dataset:
        return super().get()


class PipelineDatum(PipelineResult):
    """Lazy single-datum result."""


# ---------------------------------------------------------------------------
# Graph-building helpers
# ---------------------------------------------------------------------------


def attach_data(graph: Graph, data: Any) -> tuple:
    """Add ``data`` to ``graph`` as a dependency-able id.

    Raw datasets, tensors and arrays become :class:`DatasetOperator`
    leaves, identified by the object passed. Lazy :class:`PipelineResult`
    values have their whole graph spliced in (so shared prefixes merge and
    stay lazy). Returns ``(graph, dep_id)``.
    """
    if isinstance(data, PipelineResult):
        merged, _, sink_map = graph.add_graph(data.spliced_graph)
        dep = merged.get_sink_dependency(sink_map[data.sink])
        for new_sink in sink_map.values():
            merged = merged.remove_sink(new_sink)
        return merged, dep
    return graph.add_node(DatasetOperator(data), [])


def attach_datum(graph: Graph, datum: Any) -> tuple:
    if isinstance(datum, PipelineResult):
        return attach_data(graph, datum)
    return graph.add_node(DatumOperator(datum), [])


def _bind_source(graph: Graph, source: SourceId, attach, data: Any) -> Graph:
    """``graph`` with ``data`` fed at ``source``."""
    graph, data_id = attach(graph, data)
    graph = graph.replace_dependency(source, data_id)
    return graph.remove_source(source)


# ---------------------------------------------------------------------------
# Chainable
# ---------------------------------------------------------------------------


class Chainable:
    """Anything composable with ``and_then`` into a :class:`Pipeline`:
    :class:`Pipeline`, :class:`FittedPipeline` and ``Transformer``."""

    def to_pipeline(self) -> "Pipeline":
        raise NotImplementedError

    def and_then(self, nxt: Any, *fit_data: Any) -> "Pipeline":
        """``self`` then ``nxt``.

        * ``and_then(transformer_or_pipeline)`` — plain composition.
        * ``and_then(estimator, data)`` — fit ``estimator`` on ``self(data)``
          and append the fitted model.
        * ``and_then(label_estimator, data, labels)`` — ditto with labels.
        """
        if isinstance(nxt, EstimatorOperator):
            if not hasattr(nxt, "with_data"):
                raise TypeError(
                    f"{type(nxt).__name__} is a bare EstimatorOperator; chainable "
                    "estimators must subclass the typed Estimator/LabelEstimator "
                    "(which provide with_data)"
                )
            if not fit_data:
                raise ValueError(
                    "and_then(estimator) needs training data: and_then(est, data[, labels])"
                )
            fitted = nxt.with_data(self(fit_data[0]), *fit_data[1:])
            return self.to_pipeline()._compose(fitted)
        if isinstance(nxt, Chainable):
            if fit_data:
                raise ValueError("fit data only applies when chaining an estimator")
            return self.to_pipeline()._compose(nxt.to_pipeline())
        raise TypeError(f"cannot chain {type(nxt).__name__}")

    def __rshift__(self, nxt: Any) -> "Pipeline":
        return self.and_then(nxt)

    def __call__(self, data: Any) -> PipelineResult:
        return self.to_pipeline().apply(data)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class Pipeline(Chainable):
    """A graph with exactly one unbound source and one sink."""

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId):
        self._graph = graph
        self._source = source
        self._sink = sink

    @property
    def graph(self) -> Graph:
        return self._graph

    @property
    def source(self) -> SourceId:
        return self._source

    @property
    def sink(self) -> SinkId:
        return self._sink

    def to_pipeline(self) -> "Pipeline":
        return self

    def _compose(self, nxt: "Pipeline") -> "Pipeline":
        """Splice self's sink into nxt's source (the ``and_then`` core)."""
        merged, _, sink_map = self._graph.connect_graph(
            nxt._graph, {self._sink: nxt._source}
        )
        return Pipeline(merged, self._source, sink_map[nxt._sink])

    # -- application ----------------------------------------------------

    def apply(self, data: Any) -> PipelineDataset:
        """Lazily apply to a dataset; nothing executes until ``.get()``."""
        graph = _bind_source(self._graph, self._source, attach_data, data)
        return PipelineDataset(GraphExecutor(graph), self._sink)

    def apply_datum(self, datum: Any) -> PipelineDatum:
        """Lazily apply to a single datum."""
        graph = _bind_source(self._graph, self._source, attach_datum, datum)
        return PipelineDatum(GraphExecutor(graph), self._sink)

    def __call__(self, data: Any) -> PipelineResult:
        return self.apply(data)

    # -- fitting --------------------------------------------------------

    def fit(self) -> "FittedPipeline":
        """Fit every estimator now and return the transformer-only pipeline.

        The returned pipeline's ``seconds`` holds the host seconds of the
        rule stack ("optimize"), of forcing each estimator's data
        dependencies ("featurize"), of each estimator's fit (by class
        name), and of the rest of this method ("executor": the graph edits
        and the pull bookkeeping). The card is synchronized at those
        boundaries only."""
        seconds: Dict[str, float] = {}

        def add(key: str, dt: float) -> None:
            seconds[key] = seconds.get(key, 0.0) + dt

        start = clock()
        graph, annotations = PipelineEnv.get_or_create().optimizer.execute(self._graph)
        optimized = clock()
        add("optimize", optimized - start)
        executor = GraphExecutor(graph, optimize=False)
        executor._annotations = annotations

        for node in list(analysis.linearize(graph)):
            if not isinstance(node, NodeId) or node not in graph.operators:
                continue
            if not isinstance(graph.get_operator(node), DelegatingOperator):
                continue
            est_dep, *data_deps = graph.get_dependencies(node)
            est = graph.get_operator(est_dep) if isinstance(est_dep, NodeId) else None
            if isinstance(est, EstimatorOperator):
                t0 = clock()
                for d in graph.get_dependencies(est_dep):
                    executor.execute(d).get()
                t1 = clock()
                fitted = executor.execute(est_dep).get()
                t2 = clock()
                add("featurize", t1 - t0)
                add(type(est).__name__, t2 - t1)
            else:
                fitted = executor.execute(est_dep).get()
            if not isinstance(fitted, TransformerOperator):
                raise TypeError(
                    f"estimator at {est_dep} produced {type(fitted).__name__}, "
                    "expected a TransformerOperator"
                )
            graph = graph.set_operator(node, fitted)
            graph = graph.set_dependencies(node, data_deps)
            # Re-point the executor at the edited graph but keep memoized
            # upstream results — only the edited node and its descendants
            # are stale. Without this, fitting K chained estimators
            # re-executes shared featurization K times.
            stale = {node} | analysis.get_descendants(graph, node)
            fresh = GraphExecutor(graph, optimize=False)
            fresh._annotations = annotations
            fresh._state = {
                gid: expr for gid, expr in executor._state.items() if gid not in stale
            }
            executor = fresh
        # the fit data's features (24.6 GB at MnistRandomFFT's 200 FFTs)
        # live in the executor's state: free them before the caller applies
        executor._state.clear()
        del executor

        graph, _ = UnusedBranchRemovalRule().apply(graph, {})
        for node in graph.nodes:
            op = graph.get_operator(node)
            if not isinstance(op, (TransformerOperator, ExpressionOperator,
                                   DatasetOperator, DatumOperator)):
                raise TypeError(f"fit() left a non-transformer operator in the graph: {op.label}")
        spent = sum(seconds.values())
        add("executor", clock() - start - spent)
        return FittedPipeline(graph, self._source, self._sink, seconds)

    # -- combinators ----------------------------------------------------

    @staticmethod
    def gather(branches: Sequence[Chainable]) -> "Pipeline":
        """Fan one input through every branch and zip the outputs into a
        per-item sequence (parity: ``Pipeline.scala:119-154``)."""
        if not branches:
            raise ValueError("gather of zero branches")
        graph = Graph()
        graph, source = graph.add_source()
        branch_outs: List[NodeOrSourceId] = []
        for branch in branches:
            bp = branch.to_pipeline()
            merged, source_map, sink_map = graph.add_graph(bp.graph)
            merged = merged.replace_dependency(source_map[bp.source], source)
            merged = merged.remove_source(source_map[bp.source])
            branch_outs.append(merged.get_sink_dependency(sink_map[bp.sink]))
            graph = merged.remove_sink(sink_map[bp.sink])
        graph, gather_node = graph.add_node(GatherTransformerOperator(), branch_outs)
        graph, sink = graph.add_sink(gather_node)
        return Pipeline(graph, source, sink)

    @staticmethod
    def identity() -> "Pipeline":
        graph = Graph()
        graph, source = graph.add_source()
        graph, sink = graph.add_sink(source)
        return Pipeline(graph, source, sink)


# ---------------------------------------------------------------------------
# FittedPipeline
# ---------------------------------------------------------------------------


class FittedPipeline(Chainable):
    """An estimator-free pipeline: pure transformer application, picklable.

    It applies its graph as ``fit`` left it, with no optimizer pass and no
    re-fusion (parity with the reference, and a numerical invariant: every
    estimator was fit on features computed under exactly this partition
    into fused groups, and another partition may sum in another order)."""

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId,
                 seconds: Optional[Dict[str, float]] = None):
        self._graph = graph
        self._source = source
        self._sink = sink
        self.seconds = dict(seconds or {})

    @property
    def graph(self) -> Graph:
        return self._graph

    def to_pipeline(self) -> Pipeline:
        return Pipeline(self._graph, self._source, self._sink)

    def apply(self, data: Any) -> Dataset:
        graph = _bind_source(self._graph, self._source, attach_data, data)
        return GraphExecutor(graph, optimize=False).execute(self._sink).get()

    def apply_datum(self, datum: Any) -> Any:
        graph = _bind_source(self._graph, self._source, attach_datum, datum)
        return GraphExecutor(graph, optimize=False).execute(self._sink).get()

    def __call__(self, data: Any) -> Any:
        return self.apply(data)

    # -- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        from ..utils.serialization import save_pickle

        save_pickle(self, path)

    @staticmethod
    def load(path: str) -> "FittedPipeline":
        from ..utils.serialization import load_pickle

        obj = load_pickle(path)
        if not isinstance(obj, FittedPipeline):
            raise TypeError(f"{path} does not contain a FittedPipeline")
        return obj
