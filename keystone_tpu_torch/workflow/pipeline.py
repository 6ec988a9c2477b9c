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
``FittedPipeline`` (``apply``, ``apply_datum``, ``save``/``load``, and the
one-program apply: ``compile``, ``apply_compiled``, ``apply_chunked``,
with the traceability verdicts of ``check/lattice.py``). On CUDA a
compiled chain is one CUDA graph per input signature (``cuda_graph.py``),
the counterpart of the JAX package's one XLA program per shape.
The incremental refit of the out-of-core tier is ported too:
``FittedPipeline.absorb`` folds appended chunks, featurized through the
frozen prefix, into a snapshot fit's solver state and solves again, and
``prefix_features`` runs data through that prefix; ``absorb(checkpoint=)``
resumes a killed absorb from its last saved block.

Every fit runs under :func:`fit_instrumentation`, the observe-and-learn
loop: a ``pipeline.fit`` root span when a tracer is installed, and with a
profile store configured a fit-local tracer and a pending re-plan, joined
with the fit's observed per-node costs afterwards (``cost/replan.py``), so
the next fit of the pipeline plans with zero sampling executions. A pull
(``pipeline.pull``), an apply (``pipeline.apply``) and an absorb
(``pipeline.absorb``) record their spans under a tracer.

The static checker (``check/``) runs at ``and_then(estimator, data)``
and at fit entry (``_static_check``), and ``Pipeline.check`` /
``FittedPipeline.check`` return its report, whose verdicts
``untraceable_nodes`` and ``compile`` read. Left out, with the compile
plane: the AOT cache of ``compile``.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Dataset, map_leaves
from ..obs.tracer import current as _trace_current, layer
from . import analysis
from .cuda_graph import GraphCache, dtype_name
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

logger = logging.getLogger(__name__)


class NotTraceableError(ValueError):
    """A pipeline holds nodes that cannot run inside one captured program
    (no ``forward``, or Python-side state); ``labels`` names them."""

    def __init__(self, labels: Sequence[str]):
        self.labels = list(labels)
        super().__init__(
            "pipeline not traceable: " + ", ".join(self.labels)
            + " (no forward, or Python-side state)"
        )

    def __reduce__(self):
        # the default reduction would call __init__ with the message and
        # make .labels a list of characters
        return (NotTraceableError, (self.labels,))


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
        tracer = _trace_current()
        if tracer is None:
            return self.expression().get()
        # the pull's root: every node span of it nests here, the scheduler
        # workers' too (Tracer.adopt)
        with tracer.span("pipeline.pull", op_type=type(self).__name__) as sp:
            value = self.expression().get()
            sp.sync_on(value)
        return value


class PipelineDataset(PipelineResult):
    """Lazy dataset result; also usable as the data input of another
    pipeline or estimator (its graph is spliced in, staying lazy)."""

    def get(self) -> Dataset:
        return super().get()


class PipelineDatum(PipelineResult):
    """Lazy single-datum result."""


# ---------------------------------------------------------------------------
# Fit instrumentation: the tracer and the cost-model loop around a fit
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fit_instrumentation(op_type: str, span_name: str = "pipeline.fit"):
    """The observe-and-learn wrapper every fit runs under: a root span, and
    with a profile store configured a pending re-plan joined with the
    fit's observed per-node costs afterwards. Shared by
    :meth:`Pipeline.fit` and :class:`~keystone_tpu_torch.sweep.GridSweep`,
    whose merged graph earns its own plan records through this loop."""
    from .. import cost as cost_mod
    from ..obs import tracer as obs_tracer_mod

    store = cost_mod.get_store()
    tracer = _trace_current()
    own_tracer = None
    if store is not None and tracer is None:
        # two concurrent fits race for the global slot; the loser does not
        # learn (joining the winner's tracer would merge both fits' spans
        # by small-int node id into both records): it fits plain
        own_tracer = obs_tracer_mod.install_if_absent(obs_tracer_mod.Tracer())
        tracer = own_tracer
        if own_tracer is None:
            store = None
    try:
        with cost_mod.pending_plan(store) as plan:
            if plan is not None and tracer is not None:
                plan.span_watermark = len(tracer.spans())
            if tracer is None:
                yield
            else:
                with tracer.span(span_name, op_type=op_type):
                    yield
            # after the fit span has closed, every node span is complete
            cost_mod.finalize(plan, tracer)
    finally:
        if own_tracer is not None:
            obs_tracer_mod.uninstall(own_tracer)


# ---------------------------------------------------------------------------
# Static checking (check/)
# ---------------------------------------------------------------------------


def _static_check(pipeline: "Pipeline", where: str):
    """The implicit check at ``and_then`` and fit entry: executes nothing,
    raises a node-attributed ``PipelineCheckError`` on a proven defect, and
    fails a pipeline for no other reason (a fault of the checker itself is
    logged and passed over). ``KEYSTONE_STATIC_CHECK=0`` turns it off."""
    from .. import check as check_mod

    if not check_mod.check_enabled():
        return None
    with layer("check.static", where=where):
        try:
            return pipeline.check(span=False)
        except check_mod.PipelineCheckError:
            raise
        except Exception:
            logger.warning("static check failed internally at %s; continuing unchecked",
                           where, exc_info=True)
            return None


def _run_check(graph: Graph, source: SourceId, spec: Optional[tuple], span: bool,
               op_type: str):
    """The static check of ``graph`` fed ``spec`` at ``source``; with
    ``span`` and a tracer installed, a ``check.report`` span whose attrs
    carry the summary and the process's sampling count (a trace shows the
    check sampled nothing)."""
    from .. import check as check_mod
    from .. import cost as cost_mod

    report = check_mod.check_graph(graph, source=source, datum_spec=spec,
                                   cost_estimator=cost_mod.get_estimator())
    tracer = _trace_current()
    if span and tracer is not None:
        s = report.summary()
        with tracer.span("check.report", op_type=op_type) as sp:
            sp.attrs.update(
                nodes=s["nodes"], segments=s["segments"], barriers=s["barriers"],
                jit_compilable=s["jit_compilable"], exportable=s["exportable"],
                verdicts=dict(s["verdicts"]),
                sampling_total=cost_mod.sampling_executions()["total"],
            )
    return report


# ---------------------------------------------------------------------------
# Graph-building helpers
# ---------------------------------------------------------------------------


def datum_spec_of(data: Any) -> Optional[tuple]:
    """The per-item ``(shape, dtype)`` of a batch, when cheaply known: None
    for lazy results, item lists and chunked scans (a hint, never a reason
    to materialize anything). The dtype is numpy's spelling."""
    if isinstance(data, PipelineResult):
        return None
    payload = data
    if isinstance(payload, Dataset):
        if payload.is_chunked or not payload.is_batched:
            return None
        payload = payload.payload
    shape = getattr(payload, "shape", None)
    dtype = getattr(payload, "dtype", None)
    if shape is None or dtype is None or len(shape) < 1:
        return None
    if isinstance(dtype, torch.dtype):
        dtype = dtype_name(dtype)
    return (tuple(int(d) for d in shape[1:]), str(dtype))


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
            composed = self.to_pipeline()._compose(fitted)
            # fit_data[0] is fed at the chain's source, so its per-item spec
            # is the datum a fitted chain serves: kept as a hint
            if composed._datum_hint is None:
                composed._datum_hint = datum_spec_of(fit_data[0])
            # the estimator's data path is known now, so an incompatible
            # composition raises here, not minutes into the fit's scan
            _static_check(composed, where="and_then")
            return composed
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
        #: the per-item (shape, dtype) of the data the estimators were fed
        #: at the source (``datum_spec_of``), carried to the fitted pipeline
        self._datum_hint: Optional[tuple] = None

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

    def to_dot(self, name: str = "pipeline") -> str:
        return self._graph.to_dot(name)

    def _compose(self, nxt: "Pipeline") -> "Pipeline":
        """Splice self's sink into nxt's source (the ``and_then`` core)."""
        merged, _, sink_map = self._graph.connect_graph(
            nxt._graph, {self._sink: nxt._source}
        )
        composed = Pipeline(merged, self._source, sink_map[nxt._sink])
        composed._datum_hint = self._datum_hint
        return composed

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

    # -- static checking ------------------------------------------------

    def check(self, datum_spec: Optional[tuple] = None, *, span: bool = True):
        """The static check of this graph (``keystone_tpu_torch.check``):
        specs propagated from the data leaves, a verdict per node and the
        segment plan, executing zero chunks and zero samples and launching
        no kernel. Raises a node-attributed ``PipelineCheckError`` on a
        proven defect; returns the ``CheckReport`` otherwise.
        ``datum_spec`` is the per-item ``(shape, dtype)`` fed at the source;
        by default the fit data's hint."""
        spec = datum_spec if datum_spec is not None else self._datum_hint
        return _run_check(self._graph, self._source, spec, span, type(self).__name__)

    # -- fitting --------------------------------------------------------

    def fit(self) -> "FittedPipeline":
        """Fit every estimator now and return the transformer-only pipeline.

        The returned pipeline's ``seconds`` holds the host seconds of the
        rule stack ("optimize"), of forcing each estimator's data
        dependencies ("featurize"; under an auto-cache plan whose retention
        would drop them, they are forced inside the estimator's own pull
        and counted there), of each estimator's fit (by class name), and
        of the rest of this method ("executor": the graph edits and the
        pull bookkeeping). The card is synchronized at those boundaries
        only. The featurize and estimator intervals are also layer spans
        (``obs.layer``: ``fit.featurize``, ``fit.<estimator class>``), as
        is the checker at fit entry and at ``and_then`` (``check.static``).

        With a profile store configured (``KEYSTONE_PROFILE_DIR``) the fit
        closes the cost-model loop (:func:`fit_instrumentation`): the
        solver choice and cache plan are joined with the fit's observed
        per-node costs, and the next fit of this pipeline plans from them
        with zero sampling executions.

        Fit entry runs the static checker first: a proven mismatch raises a
        node-attributed ``PipelineCheckError`` before the optimizer samples
        anything or a chunk is produced. In ``--check`` mode the fit stops
        there: the report is printed and ``CheckOnlyExit`` raised."""
        from .. import check as check_mod

        if check_mod.check_only_mode():
            report = self.check()
            print(report.render())
            raise check_mod.CheckOnlyExit(report)
        _static_check(self, where="fit")
        with fit_instrumentation(type(self).__name__):
            return self._fit()

    def _fit(self) -> "FittedPipeline":
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
            est_deps = graph.get_dependencies(est_dep) if est is not None else ()
            if not isinstance(est, EstimatorOperator):
                fitted = executor.execute(est_dep).get()
            # the data is forced apart (the "featurize" seconds) only where
            # the executor keeps it for the estimator's pull: under an
            # auto-cache plan an uncached input would be computed twice
            elif all(executor._retain(graph, d) for d in est_deps if isinstance(d, NodeId)):
                # each interval is read inside its own span, so the span
                # covers what ``seconds`` counts
                with layer("fit.featurize"):
                    t0 = clock()
                    for d in est_deps:
                        executor.execute(d).get()
                    add("featurize", clock() - t0)
                with layer(f"fit.{type(est).__name__}"):
                    t0 = clock()
                    fitted = executor.execute(est_dep).get()
                    add(type(est).__name__, clock() - t0)
            else:
                with layer(f"fit.{type(est).__name__}"):
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
        hint = self._datum_hint
        return FittedPipeline(graph, self._source, self._sink, seconds,
                              datum_shape=hint[0] if hint else None,
                              datum_dtype=hint[1] if hint else None)

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

    #: the per-item input recorded at fit time, None when not known
    datum_shape: Optional[tuple] = None
    datum_dtype: Optional[str] = None
    #: the memo of :meth:`fingerprint`
    _fingerprint: Optional[str] = None

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId,
                 seconds: Optional[Dict[str, float]] = None, *,
                 datum_shape: Optional[tuple] = None, datum_dtype: Optional[str] = None):
        self._graph = graph
        self._source = source
        self._sink = sink
        self.seconds = dict(seconds or {})
        if datum_shape is not None:
            self.datum_shape = tuple(int(d) for d in datum_shape)
        if datum_dtype is not None:
            self.datum_dtype = str(datum_dtype)
        self._compiled: Optional[_Compiled] = None
        self._compiled_signatures: List[tuple] = []
        self._fingerprint: Optional[str] = None
        #: the segment-dispatch plan, kept across applies: each apply splices
        #: an identical graph (deterministic node ids, shared operators), so
        #: the first apply's plan holds for the later ones, which skip the
        #: fingerprints and the lattice
        self._segment_plan: Optional[dict] = None

    @property
    def graph(self) -> Graph:
        return self._graph

    def to_pipeline(self) -> Pipeline:
        p = Pipeline(self._graph, self._source, self._sink)
        if self.datum_shape is not None:
            p._datum_hint = (self.datum_shape, self.datum_dtype)
        return p

    def _executor(self, graph: Graph, data: Any) -> GraphExecutor:
        """The executor of one apply, seeded with the cached segment plan.
        The plan holds for a single-leaf splice only: a PipelineResult
        splices its whole prefix graph, whose node ids do not line up with
        the plan's, so it neither reads nor leaves a plan."""
        plain = not isinstance(data, PipelineResult)
        return GraphExecutor(graph, optimize=False,
                             segment_plan=self._segment_plan if plain else None)

    def _keep_plan(self, executor: GraphExecutor, data: Any) -> None:
        if self._segment_plan is None and not isinstance(data, PipelineResult):
            self._segment_plan = executor.segment_plan

    def apply(self, data: Any) -> Dataset:
        graph = _bind_source(self._graph, self._source, attach_data, data)
        executor = self._executor(graph, data)
        tracer = _trace_current()
        if tracer is None:
            value = executor.execute(self._sink).get()
        else:
            with tracer.span("pipeline.apply", op_type=type(self).__name__) as sp:
                value = executor.execute(self._sink).get()
                sp.sync_on(value)
        self._keep_plan(executor, data)
        return value

    def apply_datum(self, datum: Any) -> Any:
        graph = _bind_source(self._graph, self._source, attach_datum, datum)
        executor = self._executor(graph, datum)
        value = executor.execute(self._sink).get()
        self._keep_plan(executor, datum)
        return value

    def __call__(self, data: Any) -> Any:
        return self.apply(data)

    # -- one-program apply ----------------------------------------------

    def batch_coupled_nodes(self) -> List[str]:
        """Labels of the nodes whose ``forward`` couples rows (whole-batch
        statistics): such a chain must not be served through a
        pad-and-slice path (:meth:`apply_chunked`), where padded rows would
        fold into every real row's answer."""
        return [op.label for op in self._graph.operators.values()
                if getattr(op, "batch_coupled", False)]

    def check(self, datum_spec: Optional[tuple] = None, *, span: bool = True):
        """The static check of the fitted chain (see :meth:`Pipeline.check`),
        fed the datum recorded at fit time unless ``datum_spec`` is given.
        Not memoized: a caller may change an operator's flags after the
        fit."""
        spec = datum_spec
        if spec is None and self.datum_shape is not None:
            spec = (self.datum_shape, self.datum_dtype or "float32")
        return _run_check(self._graph, self._source, spec, span, type(self).__name__)

    def untraceable_nodes(self) -> List[str]:
        """Labels of the nodes that block whole-chain compilation (verdict
        ``opaque``, ``stateful`` or ``host_callback`` in the static check's
        report), in topological order. Empty: the pipeline compiles."""
        return self.check(span=False).untraceable_labels()

    @property
    def is_traceable(self) -> bool:
        return not self.untraceable_nodes()

    def trace_fn(self) -> Optional[Callable]:
        """One function (stacked batch in, stacked batch out) of the whole
        chain, or None when a node blocks it (:meth:`untraceable_nodes`)."""
        blockers = self.untraceable_nodes()
        if blockers:
            logger.debug("pipeline not traceable: %s", ", ".join(blockers))
            return None
        return self._build_trace_fn()

    def _build_trace_fn(self) -> Callable:
        """The chain of every node's ``forward``, ``no_fuse`` nodes
        included, each value dropped after its last reader; callers have
        cleared :meth:`untraceable_nodes` first."""
        graph, source, sink = self._graph, self._source, self._sink
        order = [n for n in analysis.linearize(graph) if isinstance(n, NodeId)]
        steps = [(graph.get_operator(n), graph.get_dependencies(n)) for n in order]
        out = graph.get_sink_dependency(sink)
        last_use: Dict[Any, int] = {}
        for k, (_, deps) in enumerate(steps):
            for d in deps:
                last_use[d] = k

        def fn(x):
            values: Dict[Any, Any] = {source: x}
            for k, (node, (op, deps)) in enumerate(zip(order, steps)):
                args = [values[d] for d in deps]
                if isinstance(op, GatherTransformerOperator):
                    values[node] = tuple(args)
                else:
                    values[node] = op.forward(*args)
                del args
                for d in deps:
                    if last_use[d] == k and d != out:
                        del values[d]
            return values[out]

        return fn

    def fingerprint(self) -> str:
        """The content digest of this pipeline: topology, operator
        identities and fitted-parameter digests, stable across processes
        (``compile/fingerprint.py``). Raises ``FingerprintError`` when an
        operator's state has no content-stable form. Memoized: the graph
        does not change after the fit."""
        if self._fingerprint is None:
            from ..compile import pipeline_fingerprint

            self._fingerprint = pipeline_fingerprint(self)
        return self._fingerprint

    def compile(self, strict: bool = True,
                on_trace: Optional[Callable[[tuple], None]] = None,
                cache: Any = "auto") -> Optional[Callable]:
        """The whole chain as one program per input signature.

        On CUDA input the returned callable captures one CUDA graph per new
        ``(shape, dtype)`` and replays it after; on CPU input it runs the
        chain eagerly. ``strict=True`` raises :class:`NotTraceableError`
        naming the blocking nodes; ``strict=False`` returns None for them.

        Every trace paid (each new signature; with a cache, each export) is
        appended to :attr:`compiled_signatures` as ``(shape, dtype name)``
        (numpy's spelling, ``'float32'``) and passed to ``on_trace``: the
        JAX package's accounting of one trace per shape.

        ``cache`` selects the AOT executable cache (:mod:`keystone_tpu_torch.
        compile`): ``"auto"`` (the default) is the process's cache
        (``KEYSTONE_AOT_CACHE`` / ``--aot-cache``), an ``ExecutableCache``
        is that cache, and None is none. With a cache and a pipeline that
        fingerprints, each signature first loads a saved ``torch.export``
        program (a hit pays no trace and leaves :attr:`compiled_signatures`
        as it was), and a miss exports the chain once and saves it for
        every later process; the CUDA graph is captured over the program
        either way."""
        report = self.check(span=False)
        blockers = report.untraceable_labels()
        if blockers:
            if strict:
                raise NotTraceableError(blockers)
            return None
        fn = self._build_trace_fn()
        # counts belong to the live program: a recompile starts them anew
        self._compiled_signatures = []
        signatures = self._compiled_signatures

        def note(sig):
            signatures.append(sig)
            if on_trace is not None:
                on_trace(sig)

        aot = self._aot_dispatcher(fn, cache, note, exportable=report.exportable,
                                   label="pipeline.compile")
        if aot is None:
            self._compiled = _Compiled(fn, note)
        else:
            # the dispatcher counts the traces; a capture over its program
            # is not one
            self._compiled = _Compiled(aot, lambda sig: None)
        return self._compiled

    def _aot_dispatcher(self, fn: Callable, cache: Any, note_trace: Callable, *,
                        exportable: Optional[bool], label: str,
                        on_load: Optional[Callable] = None, device: Any = None):
        """The cache-first per-signature dispatcher over ``fn``, or None
        when there is no cache, the checker proved the chain cannot export,
        or the pipeline cannot be fingerprinted (then the chain compiles
        as it would without a cache). ``device`` is where its programs run
        (default: where the chain's tensors live)."""
        from .. import compile as compile_mod

        if cache == "auto":
            cache = compile_mod.get_cache()
        if cache is None:
            return None
        if exportable is False:
            logger.info("aot cache skipped (static checker: the chain does not export)")
            return None
        try:
            digest = self.fingerprint()
        except compile_mod.FingerprintError as e:
            logger.info("aot cache skipped (pipeline not fingerprintable): %s", e)
            return None
        except Exception:
            # a fingerprint walk that fails (self-referential state, exotic
            # objects) costs the cache, never the compile
            logger.warning("aot cache skipped (fingerprinting failed)", exc_info=True)
            return None
        return compile_mod.AotDispatcher(
            fn, digest, cache, on_trace=note_trace, on_load=on_load, label=label,
            expected_exportable=bool(exportable),
            device=_param_device(self._graph) if device is None else device)

    @property
    def compiled_signatures(self) -> List[tuple]:
        """``(shape, dtype)`` of every compile paid so far, in order."""
        return list(self._compiled_signatures)

    @property
    def compile_count(self) -> int:
        return len(self._compiled_signatures)

    def apply_compiled(self, data: Any) -> Any:
        """The compiled chain on ``data`` (compiled first if need be); the
        result is the caller's own, not a buffer the next call writes."""
        if self._compiled is None:
            self.compile()
        return self._compiled(self._as_input(data))

    def apply_chunked(self, data: Any, chunk_size: int = 64) -> Dataset:
        """Serve any batch size through one compiled program: the input is
        cut into ``chunk_size`` row blocks, the tail padded by repeating its
        first row and the padding sliced off after, and each chunk's output
        is written into one preallocated output.

        Valid only for row-wise chains; a chain with a ``batch_coupled``
        node is refused. Numpy input is staged in pinned memory and copied
        to the card on a side stream one chunk ahead, while the card runs
        the chunk before (the JAX package's double buffering)."""
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        coupled = self.batch_coupled_nodes()
        if coupled:
            raise ValueError(
                f"apply_chunked on a batch-coupled chain ({coupled[0]}): "
                "the padded tail chunk would corrupt batch statistics — "
                "use apply() instead"
            )
        if self._compiled is None:
            self.compile()
        arr = data if isinstance(data, (np.ndarray, torch.Tensor)) else Dataset.of(data).to_array()
        n = int(arr.shape[0])
        if n == 0:  # no chunk to run; apply() handles empty input
            return self.apply(data)
        if isinstance(arr, torch.Tensor):
            chunks = _tensor_chunks(arr, chunk_size)
        else:
            device = _param_device(self._graph)
            chunks = (_staged_chunks(arr, chunk_size, device) if device.type == "cuda"
                      else _host_chunks(arr, chunk_size))
        out = None
        for start, chunk, rows in chunks:
            def take(res, start=start, rows=rows):
                nonlocal out
                if not isinstance(res, torch.Tensor):
                    raise TypeError(
                        "apply_chunked needs a single-array output; use apply() "
                        "for gathered/tuple sinks"
                    )
                if out is None:
                    out = torch.empty((n,) + tuple(res.shape[1:]), dtype=res.dtype,
                                      device=res.device)
                out[start:start + rows].copy_(res[:rows])

            self._compiled(chunk, take)
        return Dataset(out)

    def _as_input(self, data: Any) -> torch.Tensor:
        """``data`` as one tensor; numpy arrays go where the parameters are."""
        arr = data if isinstance(data, (np.ndarray, torch.Tensor)) else Dataset.of(data).to_array()
        if isinstance(arr, np.ndarray):
            return torch.as_tensor(arr, device=_param_device(self._graph))
        return arr

    def __getstate__(self):
        state = dict(self.__dict__)
        # a compiled program belongs to this process (its CUDA graphs do not
        # pickle), and its signatures with it
        state["_compiled"] = None
        state["_compiled_signatures"] = []
        state["_segment_plan"] = None  # lowered closures do not pickle
        return state

    # -- incremental refit ----------------------------------------------

    def absorbable_nodes(self) -> List[NodeId]:
        """The nodes whose operator carries a snapshot-able solver state
        (``linalg/accumulators.py``, ``linalg/weighted.py``): the models
        :meth:`absorb` can fold appended chunks into."""
        return [n for n in self._graph.nodes
                if getattr(self._graph.get_operator(n), "solver_state", None) is not None]

    def _absorb_node(self) -> Tuple[NodeId, Any]:
        """The one solver-state node, and its operator; a typed refusal
        when there is none, a ValueError when there are several."""
        from ..linalg.accumulators import NotAbsorbable

        nodes = self.absorbable_nodes()
        if not nodes:
            raise NotAbsorbable(
                "absorb needs a model fitted with a snapshot-able solver state: fit with "
                "LinearMapEstimator(snapshot=True) or PerClassWeightedLeastSquaresEstimator("
                "snapshot=True) (the iterated block families have no associative state and "
                "cannot absorb)")
        if len(nodes) > 1:
            labels = [self._graph.get_operator(n).label for n in nodes]
            raise ValueError(f"absorb is ambiguous: {len(nodes)} solver-state nodes "
                             f"({', '.join(labels)})")
        (node,) = nodes
        return node, self._graph.get_operator(node)

    def _prefix_executor(self, node: NodeId, data: Any) -> Tuple[GraphExecutor, SinkId]:
        """An executor of this pipeline's frozen prefix (everything upstream
        of the model ``node``) fed ``data``, run without a new optimizer
        pass, as :meth:`apply` runs: another partition into fused groups
        could sum in another order than the fit's features did."""
        deps = self._graph.get_dependencies(node)
        if len(deps) != 1:
            raise ValueError(f"absorb expects a single-input model node, got {len(deps)} inputs")
        graph, sink = self._graph.add_sink(deps[0])
        graph = _bind_source(graph, self._source, attach_data, data)
        return GraphExecutor(graph, optimize=False), sink

    def prefix_features(self, data: Any) -> Any:
        """``data`` through the frozen featurizer prefix of the absorbable
        model node: the features that node would see at fit time (a
        ``ChunkedDataset`` stays lazy)."""
        node, _ = self._absorb_node()
        executor, sink = self._prefix_executor(node, data)
        return executor.execute(sink).get()

    def absorb(self, new_data: Any, new_labels: Any, *, checkpoint: Optional[str] = None,
               checkpoint_key: Optional[str] = None, checkpoint_every: int = 1,
               on_chunk: Optional[Callable[[int, Any], None]] = None) -> "FittedPipeline":
        """Fold appended training data into the fitted model without a fit
        from scratch, and return a new FittedPipeline; this one is left as
        it was.

        The model must come from a snapshot fit
        (``LinearMapEstimator(snapshot=True)``,
        ``PerClassWeightedLeastSquaresEstimator(snapshot=True)``): its state
        holds the raw sums of every row seen so far. The new data runs
        through the frozen prefix (one scan of a ``ChunkedDataset``, the old
        training data never read again), its chunks are folded into a copy
        of the state, and the model is solved again at the recorded λ. The
        upstream fitted transformers stay as they are: fitting them again
        would change the features of every row already absorbed. A model
        without such a state raises the typed ``NotAbsorbable``.

        ``checkpoint`` (a directory) makes a chunked absorb resumable: the
        folding state is saved every ``checkpoint_every`` chunks
        (``faults.FitCheckpoint``), an absorb killed while folding and run
        again with the same arguments resumes from the last saved block
        (bit for bit) without producing the chunks before it, and the
        checkpoint is removed when the absorb completes. The key binds the
        appended data through a digest of its labels, so a later absorb of
        other data of the same shape starts fresh; ``checkpoint_key`` sets
        the key instead (a caller retrying one batch passes its id).

        ``on_chunk(chunk_index, features)`` runs before each chunk is
        folded, for the chunks this call produces (a resumed absorb skips
        the folded ones)."""
        from ..faults import FitCheckpoint
        from ..linalg.accumulators import fold_into

        node, mapper = self._absorb_node()
        executor, sink = self._prefix_executor(node, new_data)
        device = _first_device(mapper) or torch.device("cpu")
        y = Dataset.of(new_labels).to_array().float().to(device)
        state = mapper.solver_state.snapshot()
        tracer = _trace_current()
        with contextlib.ExitStack() as stack:
            sp = None if tracer is None else stack.enter_context(tracer.span(
                "pipeline.absorb", op_type=type(self).__name__, prior_rows=int(state.n)))
            feats = executor.execute(sink).get()
            ckpt = None
            if checkpoint is not None and getattr(feats, "is_chunked", False):
                digest = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
                ckpt = FitCheckpoint(checkpoint, checkpoint_key or (
                    f"absorb|base={state.n}|new={len(feats)}|y={tuple(int(s) for s in y.shape)}"
                    f"|ydig={digest}|lam={state.lam}"))
            state = fold_into(state, feats, y, label="absorb", on_chunk=on_chunk,
                              checkpoint=ckpt, checkpoint_every=checkpoint_every)
            new_mapper = state.rebuild_mapper(mapper)
            if sp is not None:
                sp.attrs["absorbed_rows"] = int(state.rows_folded)
                sp.attrs["total_rows"] = int(state.n)
                solved_w = getattr(new_mapper, "W", None)
                if solved_w is not None:
                    sp.sync_on(solved_w)
        return FittedPipeline(self._graph.set_operator(node, new_mapper),
                              self._source, self._sink, self.seconds,
                              datum_shape=self.datum_shape, datum_dtype=self.datum_dtype)

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


# ---------------------------------------------------------------------------
# One-program apply helpers
# ---------------------------------------------------------------------------


def _own(res: Any) -> Any:
    return map_leaves(torch.clone, res)


class _Compiled:
    """A compiled chain: on CUDA input one CUDA graph per input signature,
    on CPU input the chain run eagerly; ``note(signature)`` once per new
    signature either way."""

    def __init__(self, fn: Callable, note: Callable[[tuple], None]):
        self._fn = fn
        self._note = note
        self._graphs = GraphCache(fn, on_capture=lambda sig: note(sig[0]))
        self._seen: set = set()

    def __call__(self, x: torch.Tensor, take: Callable[[Any], Any] = _own) -> Any:
        """``take`` of the chain's output on ``x``. ``take`` reads the
        output before the next call can overwrite it (on CUDA it is the
        graph's static output); the default copies it out."""
        if x.is_cuda:
            with self._graphs.lock:
                return take(self._graphs(x))
        sig = (tuple(x.shape), dtype_name(x.dtype))
        if sig not in self._seen:
            self._seen.add(sig)
            self._note(sig)
        res = self._fn(x)
        return res if take is _own else take(res)


def _first_device(v: Any, depth: int = 4) -> Optional[torch.device]:
    """The device of the first tensor found in ``v`` (its attributes and
    containers, ``depth`` levels down), or None."""
    if isinstance(v, torch.Tensor):
        return v.device
    if depth == 0:
        return None
    if isinstance(v, dict):
        items = v.values()
    elif isinstance(v, (list, tuple)):
        items = v
    elif hasattr(v, "__dict__") and not isinstance(v, type):
        items = vars(v).values()
    else:
        return None
    for item in items:
        found = _first_device(item, depth - 1)
        if found is not None:
            return found
    return None


def _param_device(graph: Graph) -> torch.device:
    """Where a graph's parameters live (the first tensor found in its
    operators), the CPU when it holds none: where numpy input is sent."""
    for op in graph.operators.values():
        found = _first_device(op)
        if found is not None:
            return found
    return torch.device("cpu")


def _pad_rows(chunk, size: int):
    """``chunk`` padded to ``size`` rows by repeating its first row."""
    pad = size - int(chunk.shape[0])
    if not pad:
        return chunk
    if isinstance(chunk, np.ndarray):
        return np.concatenate([chunk, np.repeat(chunk[:1], pad, axis=0)], axis=0)
    return torch.cat([chunk, chunk[:1].expand(pad, *chunk.shape[1:])], dim=0)


def _tensor_chunks(arr: torch.Tensor, size: int) -> Iterator[Tuple[int, torch.Tensor, int]]:
    """(start, padded chunk, real rows) of a tensor, padded where it lies."""
    for start in range(0, int(arr.shape[0]), size):
        chunk = arr[start:start + size]
        yield start, _pad_rows(chunk, size), int(chunk.shape[0])


def _host_chunks(arr: np.ndarray, size: int) -> Iterator[Tuple[int, torch.Tensor, int]]:
    """(start, padded chunk, real rows) of a numpy array, on the CPU."""
    for start in range(0, int(arr.shape[0]), size):
        chunk = arr[start:start + size]
        yield start, torch.from_numpy(_pad_rows(chunk, size)), int(chunk.shape[0])


def _staged_chunks(arr: np.ndarray, size: int,
                   device: torch.device) -> Iterator[Tuple[int, torch.Tensor, int]]:
    """(start, padded chunk on the card, real rows) of a numpy array, double
    buffered: chunk i+1 is written into pinned memory and copied to the card
    with ``non_blocking`` on a side stream before chunk i is handed out, so
    the copy runs while the card computes chunk i. Two pinned and two device
    buffers take turns; a buffer is refilled only after the copy out of it
    (host side) and the work that read it (device side) are done."""
    n = int(arr.shape[0])
    starts = list(range(0, n, size))
    shape = (size,) + tuple(arr.shape[1:])
    dtype = torch.from_numpy(arr[:0]).dtype
    compute = torch.cuda.current_stream(device)
    copy_stream = torch.cuda.Stream(device)
    host = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(2)]
    dev = [torch.empty(shape, dtype=dtype, device=device) for _ in range(2)]
    copied = [torch.cuda.Event() for _ in range(2)]
    used: List[Optional[torch.cuda.Event]] = [None, None]
    rows: Dict[int, int] = {}

    def stage(i: int) -> None:
        b = i % 2
        copied[b].synchronize()  # the last copy out of this pinned buffer
        chunk = arr[starts[i]:starts[i] + size]
        rows[i] = int(chunk.shape[0])
        host[b].copy_(torch.from_numpy(_pad_rows(chunk, size)))
        with torch.cuda.stream(copy_stream):
            if used[b] is not None:
                copy_stream.wait_event(used[b])
            dev[b].copy_(host[b], non_blocking=True)
            copied[b].record(copy_stream)

    stage(0)
    for i, start in enumerate(starts):
        if i + 1 < len(starts):
            stage(i + 1)
        b = i % 2
        compute.wait_event(copied[b])
        yield start, dev[b], rows.pop(i)
        used[b] = compute.record_event()
