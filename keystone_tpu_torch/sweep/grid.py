"""GridSweep: fit a whole hyperparameter grid as one merged DAG (port of
``keystone_tpu/sweep/grid.py``).

``Pipeline.fit`` featurizes the same data once per grid member, so a
G-point λ grid pays G fits. Here the G members' graphs are unioned into
one multi-sink graph before the optimizer runs, so

* the CSE rule merges the shared featurize prefix across members (the
  member graphs are built from one prefix instance and one data leaf, so
  their fit-path chains are structurally identical): it runs once,
  retained by the executor (and behind an explicit Cacher when the
  auto-cache rule's budgeted retention is on);
* estimators with the ``grid_family()`` / ``fit_lambda_grid()`` hooks
  (``LinearMapEstimator``'s Gram family, the augmented TSQR, BCD when
  warm-started) fit their whole λ group from one accumulation pass;
* the other members' solves overlap on a worker pool (the executor's
  ``KEYSTONE_EXEC_WORKERS``).

The merged graph rides the same cost-model loop as one fit
(``workflow.pipeline.fit_instrumentation``): with a profile store, the
sweep's solver choices and cache plan are joined with what it was
observed to cost, and the second run of the same sweep plans every member
with zero sampling executions.
"""

from __future__ import annotations

import inspect
import itertools
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from ..obs.tracer import current as _trace_current
from ..workflow import analysis
from ..workflow.env import PipelineEnv
from ..workflow.executor import GraphExecutor, exec_workers, parallel_enabled
from ..workflow.graph import Graph, NodeId, SinkId, SourceId
from ..workflow.operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    ExpressionOperator,
    TransformerOperator,
)
from ..workflow.pipeline import (
    Chainable,
    FittedPipeline,
    Pipeline,
    attach_data,
    datum_spec_of,
    fit_instrumentation,
)
from ..workflow.rules import UnusedBranchRemovalRule

logger = logging.getLogger(__name__)


def expand_grid(grid: Mapping[str, Sequence]) -> List[Dict[str, Any]]:
    """The cartesian product of a ``{param: [values...]}`` grid, in
    key-then-value order."""
    if not grid:
        raise ValueError("empty parameter grid")
    keys = list(grid.keys())
    values = [list(grid[k]) for k in keys]
    for k, vs in zip(keys, values):
        if not vs:
            raise ValueError(f"grid axis {k!r} has no values")
    return [dict(zip(keys, combo)) for combo in itertools.product(*values)]


@dataclass
class SweepMember:
    """One fitted grid point."""

    params: Dict[str, Any]
    fitted: FittedPipeline
    estimator_label: str


@dataclass
class SweepResult:
    members: List[SweepMember]
    #: the work done: ``groups``, ``grouped_solves`` (per-λ solves served
    #: from a shared accumulation, by family), ``gram_reuse_solves``,
    #: ``warm_starts``, ``overlapped_fits``
    stats: Dict[str, Any] = field(default_factory=dict)

    def __iter__(self):
        return iter(self.members)

    def __len__(self) -> int:
        return len(self.members)

    def fitted_for(self, **params) -> FittedPipeline:
        for m in self.members:
            if all(m.params.get(k) == v for k, v in params.items()):
                return m.fitted
        raise KeyError(f"no sweep member matches {params}")


class GridSweep:
    """Fit ``prefix >> make_estimator(**params) [>> final]`` for every point
    of ``grid`` as one merged DAG.

    ``prefix`` is the shared featurize chain (one instance: sharing is what
    lets CSE merge the members' copies) or None. ``make_estimator(**params)``
    returns each member's estimator. ``data`` and ``labels`` are fed once
    (one data leaf for every member); ``labels=None`` fits label-free
    estimators. ``final`` is a shared stage after the fitted model.
    ``warm_start`` turns on nearest-λ warm starts for iterative (BCD)
    families: warm iterates differ from cold ones, so members are no
    longer bit-comparable to independent cold fits (off by default)."""

    def __init__(self, prefix: Optional[Chainable], make_estimator: Callable[..., Any],
                 grid: Mapping[str, Sequence], data: Any, labels: Any = None, *,
                 final: Optional[Chainable] = None, warm_start: bool = False):
        self.prefix = prefix
        self.make_estimator = make_estimator
        self.param_grid = expand_grid(grid)
        self.data = data
        self.labels = labels
        self.final = final
        self.warm_start = warm_start

    # -- graph construction ---------------------------------------------

    @staticmethod
    def _splice(graph: Graph, chain: Pipeline, input_id) -> Tuple[Graph, Any]:
        """``chain``'s graph copied into ``graph`` with its source replaced
        by ``input_id``; returns (graph, output id). The copies share the
        operator instances, which is what CSE keys uncanonical state on."""
        merged, smap, kmap = graph.add_graph(chain.graph)
        merged = merged.replace_dependency(smap[chain.source], input_id)
        merged = merged.remove_source(smap[chain.source])
        out = merged.get_sink_dependency(kmap[chain.sink])
        return merged.remove_sink(kmap[chain.sink]), out

    def _member_graph(self, graph: Graph, estimator, data_id, labels_id
                      ) -> Tuple[Graph, SourceId, SinkId]:
        """Add one member: the serving prefix from a fresh source, the
        fitting prefix from the shared data leaf, the estimator, its
        delegating apply, the final stage. Built directly, not by
        ``and_then``, so the fitting chains stay unfused until the merged
        graph's optimize, where CSE merges them across members first."""
        graph, source = graph.add_source()
        prefix = self.prefix.to_pipeline() if self.prefix is not None else Pipeline.identity()
        graph, serve_out = self._splice(graph, prefix, source)
        graph, feat_out = self._splice(graph, prefix, data_id)
        est_deps = [feat_out] if labels_id is None else [feat_out, labels_id]
        if not isinstance(estimator, EstimatorOperator):
            raise TypeError(f"make_estimator returned {type(estimator).__name__}, "
                            "expected an Estimator/LabelEstimator")
        graph, est_node = graph.add_node(estimator, est_deps)
        graph, deleg = graph.add_node(DelegatingOperator(), [est_node, serve_out])
        out = deleg
        if self.final is not None:
            graph, out = self._splice(graph, self.final.to_pipeline(), deleg)
        graph, sink = graph.add_sink(out)
        return graph, source, sink

    # -- fitting ---------------------------------------------------------

    def fit(self) -> SweepResult:
        """Fit the whole grid; returns each member's fitted pipeline and the
        work counters."""
        with fit_instrumentation("GridSweep", span_name="sweep.fit"):
            return self._fit_merged()

    def _fit_merged(self) -> SweepResult:
        tracer = _trace_current()
        graph = Graph()
        graph, data_id = attach_data(graph, self.data)
        labels_id = None
        if self.labels is not None:
            graph, labels_id = attach_data(graph, self.labels)
        sources: List[SourceId] = []
        sinks: List[SinkId] = []
        est_labels: List[str] = []
        for params in self.param_grid:
            est = self.make_estimator(**params)
            est_labels.append(getattr(est, "label", type(est).__name__))
            graph, source, sink = self._member_graph(graph, est, data_id, labels_id)
            sources.append(source)
            sinks.append(sink)
        if tracer is not None:
            with tracer.span("sweep.plan", op_type="GridSweep", members=len(self.param_grid),
                             nodes=len(graph.nodes)):
                pass

        graph, annotations = PipelineEnv.get_or_create().optimizer.execute(graph)
        graph = self._ensure_shared_retention(graph, annotations)
        executor = GraphExecutor(graph, optimize=False)
        executor._annotations = annotations

        stats: Dict[str, Any] = {"members": len(self.param_grid), "groups": 0,
                                 "grouped_solves": {}, "gram_reuse_solves": 0,
                                 "warm_starts": 0, "overlapped_fits": 0}
        graph, executor = self._fit_estimators(graph, executor, annotations, stats, tracer)
        # the featurized fit data lives in the executor's state: free it
        # before the members are applied
        executor._state.clear()
        del executor

        graph, _ = UnusedBranchRemovalRule().apply(graph, {})
        for node in graph.nodes:
            op = graph.get_operator(node)
            if not isinstance(op, (TransformerOperator, ExpressionOperator, DatasetOperator,
                                   DatumOperator)):
                raise TypeError(f"sweep fit left a non-transformer operator: {op.label}")

        hint = datum_spec_of(self.data)
        members = []
        for params, label, source, sink in zip(self.param_grid, est_labels, sources, sinks):
            members.append(SweepMember(params, _extract_member(graph, source, sink, hint), label))
            if tracer is not None:
                with tracer.span("sweep.member", op_type="GridSweep", **{
                    str(k): v if isinstance(v, (int, float, bool)) else str(v)
                    for k, v in params.items()
                }):
                    pass
        return SweepResult(members, stats)

    @staticmethod
    def _ensure_shared_retention(graph: Graph, annotations) -> Graph:
        """Under the auto-cache rule's retention, only Cacher, leaf and
        estimator results outlive a pull, so a shared prefix the greedy
        plan skipped would run once per member: every node with several
        consumers goes behind a Cacher (a sweep reuses it once per member,
        which a plan priced on one pipeline's shape undercounts)."""
        from ..workflow.autocache import AUTOCACHE_ACTIVE, _is_cacher, insert_cachers

        if not annotations.get(AUTOCACHE_ACTIVE):
            return graph
        shared = []
        for node in graph.nodes:
            op = graph.get_operator(node)
            if _is_cacher(op) or isinstance(op, (DatasetOperator, DatumOperator,
                                                 EstimatorOperator)):
                continue
            consumers = analysis.get_children(graph, node)
            if len(consumers) > 1 and not any(
                    isinstance(c, NodeId) and _is_cacher(graph.get_operator(c))
                    for c in consumers):
                shared.append(node)
        if shared:
            logger.info("sweep: pinning %d shared node(s) behind Cachers", len(shared))
            graph = insert_cachers(graph, sorted(shared))
        return graph

    # -- estimator fitting ----------------------------------------------

    def _fit_estimators(self, graph: Graph, executor: GraphExecutor, annotations, stats,
                        tracer) -> Tuple[Graph, GraphExecutor]:
        """``Pipeline.fit``'s estimator loop on the merged graph: groupable
        estimators fit as families from one accumulation pass, the rest
        pull through the executor, overlapped on a pool when independent."""
        deleg_nodes = [n for n in analysis.linearize(graph)
                       if isinstance(n, NodeId) and n in graph.operators
                       and isinstance(graph.get_operator(n), DelegatingOperator)]
        est_of = {}
        for n in deleg_nodes:
            deps = graph.get_dependencies(n)
            est_of[n] = (deps[0], deps[1:])

        fitted_by_est: Dict[NodeId, TransformerOperator] = {}
        for family, nodes in self._plan_groups(graph, [e for e, _ in est_of.values()]):
            ests = [graph.get_operator(n) for n in nodes]
            deps = graph.get_dependencies(nodes[0])
            data = executor.execute(deps[0]).get()
            labels = executor.execute(deps[1]).get() if len(deps) > 1 else None
            fit_grid = type(ests[0]).fit_lambda_grid
            params = inspect.signature(fit_grid).parameters
            kwargs = {}
            # a member fitted with checkpoint=dir keeps its resume through
            # the grouped accumulation (the family key holds the directory)
            ckpt = getattr(ests[0], "checkpoint", None)
            if ckpt is not None:
                if "checkpoint" in params:
                    kwargs["checkpoint"] = ckpt
                    kwargs["checkpoint_every"] = getattr(ests[0], "checkpoint_every", 1)
                else:
                    logger.warning("sweep: %s members requested checkpoint=%r but the "
                                   "family's grouped fit is not resumable",
                                   type(ests[0]).__name__, ckpt)
            if "warm_start" in params:
                kwargs["warm_start"] = self.warm_start
                # a chunked input fits each member cold inside the hook
                if self.warm_start and not getattr(data, "is_chunked", False):
                    stats["warm_starts"] += len(nodes) - 1
            models = (fit_grid(ests, data, labels, **kwargs) if labels is not None
                      else fit_grid(ests, data, **kwargs))
            for n, m in zip(nodes, models):
                fitted_by_est[n] = m
            key = str(family[0])
            stats["groups"] += 1
            stats["grouped_solves"][key] = stats["grouped_solves"].get(key, 0) + len(nodes)
            if key == "gram_ne":
                stats["gram_reuse_solves"] += len(nodes)
            if tracer is not None:
                with tracer.span("sweep.grid_solve", op_type=type(ests[0]).__name__,
                                 family=key, members=len(nodes),
                                 warm_start=bool(kwargs.get("warm_start", False))):
                    pass

        ungrouped = [est for est, _ in est_of.values()
                     if est not in fitted_by_est
                     and isinstance(graph.get_operator(est), EstimatorOperator)]
        if len(ungrouped) > 1 and parallel_enabled():
            self._prefetch_concurrent(executor, ungrouped, fitted_by_est, stats, tracer)

        # the graph edits stay on this thread
        for node in deleg_nodes:
            if node not in graph.operators:
                continue
            est_dep, data_deps = est_of[node]
            fitted = fitted_by_est.get(est_dep)
            if fitted is None:
                fitted = executor.execute(est_dep).get()
            if not isinstance(fitted, TransformerOperator):
                raise TypeError(f"estimator at {est_dep} produced {type(fitted).__name__}, "
                                "expected a TransformerOperator")
            graph = graph.set_operator(node, fitted)
            graph = graph.set_dependencies(node, list(data_deps))
            stale = {node} | analysis.get_descendants(graph, node)
            fresh = GraphExecutor(graph, optimize=False)
            fresh._annotations = annotations
            fresh._state = {gid: expr for gid, expr in executor._state.items()
                            if gid not in stale}
            executor = fresh
        return graph, executor

    def _plan_groups(self, graph: Graph, est_nodes: Sequence[NodeId]):
        """Estimator nodes that fit as one λ family: one concrete class, one
        non-λ configuration (``grid_family()``), the same data. A family
        whose hook warm-starts (BCD) groups only when the sweep asked for
        warm starts: grouped cold, it would be a plain sequential fit."""
        clusters: Dict[tuple, List[NodeId]] = {}
        for n in est_nodes:
            if n not in graph.operators:
                continue
            op = graph.get_operator(n)
            if not (hasattr(op, "grid_family") and hasattr(type(op), "fit_lambda_grid")
                    and hasattr(op, "lam")):
                continue
            warm_family = "warm_start" in inspect.signature(type(op).fit_lambda_grid).parameters
            if warm_family and not self.warm_start:
                continue
            try:
                key = (type(op).__name__, op.grid_family(), tuple(graph.get_dependencies(n)))
                hash(key)
            except TypeError:
                continue
            clusters.setdefault(key, []).append(n)
        return [((key[1][0],) if key[1] else (key[0],), sorted(nodes))
                for key, nodes in clusters.items() if len(nodes) >= 2]

    @staticmethod
    def _prefetch_concurrent(executor: GraphExecutor, est_nodes: Sequence[NodeId],
                             out: Dict[NodeId, TransformerOperator], stats, tracer) -> None:
        """Force the independent estimator expressions on a bounded pool.
        The shared prefix's once-latch runs it once; the solves overlap
        after it. A failure is left for the sequential loop to raise."""
        exprs = {n: executor.execute(n) for n in est_nodes}
        parent = tracer.current_span() if tracer is not None else None
        lock = threading.Lock()

        def run(n):
            try:
                if tracer is not None:
                    with tracer.adopt(parent):
                        value = exprs[n].get()
                else:
                    value = exprs[n].get()
            except Exception:
                logger.debug("overlapped sweep fit failed; the sequential pull raises it",
                             exc_info=True)
                return
            if isinstance(value, TransformerOperator):
                with lock:
                    out[n] = value
                    stats["overlapped_fits"] += 1

        workers = min(exec_workers(), len(est_nodes))
        with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="keystone-sweep") as pool:
            list(pool.map(run, est_nodes))


def _extract_member(graph: Graph, source: SourceId, sink: SinkId, hint) -> FittedPipeline:
    """One member's transformer-only subgraph (the ancestors of its sink)
    lifted out of the fitted merged graph as a standalone FittedPipeline."""
    dep = graph.get_sink_dependency(sink)
    keep = {n for n in (analysis.get_ancestors(graph, sink) | {dep}) if isinstance(n, NodeId)}
    for n in keep:
        for d in graph.get_dependencies(n):
            if isinstance(d, SourceId) and d != source:
                raise ValueError(f"member subgraph reaches foreign {d} — sweep members "
                                 "must be single-source")
    new = Graph()
    new, new_source = new.add_source()
    mapping: Dict[Any, Any] = {source: new_source}
    for n in analysis.linearize(graph):
        if isinstance(n, NodeId) and n in keep:
            new, mapping[n] = new.add_node(graph.get_operator(n),
                                           [mapping[d] for d in graph.get_dependencies(n)])
    new, new_sink = new.add_sink(mapping[dep])
    return FittedPipeline(new, new_source, new_sink,
                          datum_shape=hint[0] if hint else None,
                          datum_dtype=hint[1] if hint else None)
