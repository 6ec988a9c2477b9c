"""Pull-based memoized graph executor with dependency-scheduled concurrency
(port of ``keystone_tpu/workflow/executor.py``; parity:
``workflow/GraphExecutor.scala``).

The executor optimizes its graph lazily on first use, then
``execute(graph_id)`` recursively pulls dependency expressions, memoizing
one expression per node. Results of saveable prefixes (annotated by the
optimizer) are written into the global :class:`PipelineEnv` state so later
executions skip the work entirely.

Retention: by default every node's result is retained for the
executor's life, so a graph's results live as long as the executor that
computed them, and an owner that keeps an executor past its use
(``Pipeline.fit``) releases its state itself. Once the auto-cache rule has
planned the graph (the ``autocache_active`` annotation), only Cacher,
data-leaf, saved-state and fitted-estimator results outlive a pull; every
other intermediate is shared within its pull (a diamond computes once)
and recomputed by the next, as an unpersisted RDD in the reference, so the
cache budget bounds what stays resident.

Concurrency: the recursive pull builds the expression web serially, and
when the pending work has width (two or more nodes ready at once), the
pull root's thunk is armed with a dependency-counted scheduler: ready
nodes go to a bounded worker pool in topological order
(``KEYSTONE_EXEC_WORKERS``, default ``min(8, cpu)``), each forced after
all of its dependencies. A strict chain never pays for a pool.
``KEYSTONE_PAR_EXEC=0`` is the kill switch. The first branch exception
wins: no further node is started, running ones drain, and the exception
propagates with its traceback.

An out-of-core ``ChunkedDataset`` flowing between nodes stays a lazy scan:
every transform of a chunked input returns a chunked dataset without
producing a chunk, so forcing a branch on the pool builds its chain and
runs none of its scan; the chunks are produced when a consumer (an
estimator's streaming fit, ``to_array``) scans them.

Tracing (``obs/``): with a tracer installed, a node's span opens when its
thunk is first forced, so the upstream thunks it forces nest as child
spans, and closes after waiting for the card's work on its result
(``sync_seconds``, ``output_bytes``). An eager leaf records a finished
span; a memoized result returned records a ``hit`` instant. A node forced
by the scheduler carries ``queue_wait_seconds`` (ready to started) and
``worker``, and nests under the pull that armed it. Off, the cost is one
``None`` check a node.

Segment dispatch (``compile/segment.py``), on by default: the first pull
of an executor plans the optimized graph's maximal traceable segments
(``check/segments.py``), binds each eligible one, and keys the bindings by
their output nodes. A pull of such an output builds one thunk for the
whole segment, which forces the segment's external inputs and runs the
members as one program (per row chunk when they are all row-local;
captured as CUDA graphs on the card; exported into the AOT cache when one
is configured), under one ``exec.segment`` span whose ``path`` says which
runtime path served it. A segment one of whose nodes already holds a
result (a fit's next executor keeps its predecessor's) is not run again:
the pull takes node dispatch from that result. The members emit no node spans of their
own. ``KEYSTONE_SEGMENT_COMPILE=0``, read per pull, restores node
dispatch. Planning that fails in Python leaves the executor on node
dispatch; a kernel or device fault propagates.
"""

from __future__ import annotations

import heapq
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from ..obs.tracer import current as _trace_current
from ..utils import env_flag, env_int
from .env import PipelineEnv
from .expressions import DatasetExpression, Expression
from .graph import Graph, GraphId, NodeId, SinkId, SourceId
from .operators import DatasetOperator, DatumOperator, EstimatorOperator, ExpressionOperator
from .rules import Annotations


logger = logging.getLogger(__name__)


def parallel_enabled() -> bool:
    """The ``KEYSTONE_PAR_EXEC`` kill switch (default on), read per pull."""
    return env_flag("KEYSTONE_PAR_EXEC", True)


def segment_compile_enabled() -> bool:
    """The ``KEYSTONE_SEGMENT_COMPILE`` switch (default on), read per pull:
    off, every node is dispatched on its own, with no executor rebuilt."""
    return env_flag("KEYSTONE_SEGMENT_COMPILE", True)


def exec_workers() -> int:
    """Worker-pool width of a scheduled pull: ``KEYSTONE_EXEC_WORKERS``,
    default ``min(8, cpu)``."""
    return env_int("KEYSTONE_EXEC_WORKERS", min(8, os.cpu_count() or 1))


#: the transient-table key of this pull's segment outputs (node -> binding)
_SEGMENT_OUTPUTS = "__segment_outputs__"

#: per-thread scheduler task context: the worker forcing a node publishes
#: its queue wait and name here, for the node's span to pick up
_TASK_CTX = threading.local()


class GraphExecutor:
    def __init__(self, graph: Graph, optimize: bool = True,
                 parallel: Optional[bool] = None,
                 segment_plan: Optional[Dict[NodeId, Any]] = None):
        self._input_graph = graph
        self._optimize = optimize
        self._optimized: Optional[Graph] = None
        self._annotations: Annotations = {}
        self._state: Dict[GraphId, Expression] = {}
        #: None follows KEYSTONE_PAR_EXEC; False pins the serial pull
        self._parallel = parallel
        #: guards building the expression web, so that concurrent pulls
        #: see one ``_state``
        self._build_lock = threading.Lock()
        #: the segment-dispatch table, output node -> SegmentBinding, planned
        #: at the first pull with segments on (None: not planned; {}: nothing
        #: eligible). ``segment_plan`` seeds it with a plan a caller cached: a
        #: FittedPipeline splices an identical graph each apply (node ids are
        #: deterministic, operators shared), so its first apply's plan holds
        #: for every later one, which then skips the fingerprints
        self._seg_bindings: Optional[Dict[NodeId, Any]] = segment_plan
        #: a seeded plan is checked against this graph at the first pull
        self._seg_seeded = segment_plan is not None

    @property
    def segment_plan(self) -> Optional[Dict[NodeId, Any]]:
        """The planned segment-dispatch table (None until a pull with
        segments on plans it), reusable by an executor over an identically
        spliced graph."""
        return self._seg_bindings

    @property
    def input_graph(self) -> Graph:
        """The graph as handed in, without forcing the lazy optimize (the
        composition seam: ``attach_data`` splices this)."""
        return self._input_graph

    @property
    def graph(self) -> Graph:
        """The optimized graph (optimization happens once, lazily)."""
        if self._optimized is None:
            if self._optimize:
                optimizer = PipelineEnv.get_or_create().optimizer
                self._optimized, self._annotations = optimizer.execute(self._input_graph)
            else:
                self._optimized = self._input_graph
        return self._optimized

    def _retain(self, graph: Graph, graph_id: NodeId) -> bool:
        """Whether this node's result stays resident across pulls: all of
        them by default; under an auto-cache plan only Cacher, data-leaf,
        saved-state and fitted-estimator results. Concurrency widens no
        retention (a scheduled pull shares its transient table and drops
        it at the pull's end), but the transient peak can grow by up to
        the worker count, which ``KEYSTONE_EXEC_WORKERS`` bounds."""
        from ..nodes.util.core import Cacher
        from .autocache import AUTOCACHE_ACTIVE

        if not self._annotations.get(AUTOCACHE_ACTIVE):
            return True
        return isinstance(graph.get_operator(graph_id), (
            Cacher, DatasetOperator, DatumOperator, EstimatorOperator, ExpressionOperator))

    def _use_parallel(self) -> bool:
        if self._parallel is not None:
            return self._parallel
        return parallel_enabled()

    def execute(self, graph_id: GraphId) -> Expression:
        with self._build_lock:
            segments: Optional[Dict[NodeId, Any]] = None
            if segment_compile_enabled():
                if self._seg_seeded:
                    self._seg_seeded = False
                    if not all(b.holds_for(self.graph) for b in set(self._seg_bindings.values())):
                        logger.debug("segment plan does not fit this graph — planning anew")
                        self._seg_bindings = None
                if self._seg_bindings is None:
                    self._seg_bindings = self._plan_segment_bindings()
                segments = self._seg_bindings or None
            built: Dict[NodeId, Expression] = {}
            transient: Dict[Any, Any] = {}
            expr = self._execute(graph_id, transient, built, segments)
            if self._use_parallel():
                self._arm_concurrent(expr, built, transient.get(_SEGMENT_OUTPUTS, {}))
        return expr

    def _execute(self, graph_id: GraphId, transient: Dict[Any, Any],
                 built: Dict[NodeId, Expression],
                 segments: Optional[Dict[NodeId, Any]] = None) -> Expression:
        graph = self.graph  # optimize before anything runs
        if isinstance(graph_id, SourceId):
            raise ValueError(f"cannot execute unconnected {graph_id}")
        if isinstance(graph_id, SinkId):
            return self._execute(graph.get_sink_dependency(graph_id), transient, built, segments)
        tracer = _trace_current()
        expr = self._state.get(graph_id)
        if expr is not None:
            built.setdefault(graph_id, expr)
            if tracer is not None:
                _trace_hit(tracer, graph, graph_id, "state")
            return expr
        expr = transient.get(graph_id)
        if expr is not None:
            if tracer is not None:
                _trace_hit(tracer, graph, graph_id, "transient")
            return expr
        if segments is not None:
            binding = segments.get(graph_id)
            if binding is not None:
                expr = self._execute_segment(binding, graph_id, transient, built, segments)
                if expr is not None:
                    return expr
                # a datum pull, or a member that holds a result: node dispatch
        deps = [self._execute(d, transient, built, segments)
                for d in graph.get_dependencies(graph_id)]
        op = graph.get_operator(graph_id)
        retained = self._retain(graph, graph_id)
        if tracer is None:
            expr = op.execute(deps)
        else:
            expr = _traced_execute(tracer, graph_id, op, deps, retained)
        # every node of this pull, dependencies first: the scheduler's
        # topological order comes straight from it
        built[graph_id] = expr
        if retained:
            self._state[graph_id] = expr
        else:
            # shared within this pull (diamonds compute once), dropped after
            transient[graph_id] = expr
        prefix = self._annotations.get(graph_id)
        if prefix is not None:
            PipelineEnv.get_or_create().state[prefix] = expr
        return expr

    # -- segment dispatch ----------------------------------------------------

    def _plan_segment_bindings(self) -> Dict[NodeId, Any]:
        """This executor's segment-dispatch table: the planner's segments of
        the optimized graph, each eligible one lowered by
        ``compile/segment.py`` and keyed by its output nodes (its interior
        nodes get no thunk of their own). A Python-level failure leaves an
        empty table, node dispatch; a kernel or device fault propagates."""
        from ..check import lattice
        from ..check.segments import plan_segments
        from ..compile.segment import bind_segment
        from ..ops import is_device_fault

        try:
            graph = self.graph
            verdicts = {n: lattice.classify(graph.get_operator(n)) for n in graph.nodes}
            planned, _ = plan_segments(graph, verdicts, {})
            table: Dict[NodeId, Any] = {}
            for seg in planned:
                binding = bind_segment(graph, seg, annotations=self._annotations)
                if binding is not None:
                    for out in binding.outputs:
                        table[out] = binding
            return table
        except Exception as e:
            if is_device_fault(e):
                raise
            logger.warning("segment planning failed — node dispatch for this executor",
                           exc_info=True)
            return {}

    def _execute_segment(self, binding: Any, graph_id: NodeId, transient: Dict[Any, Any],
                         built: Dict[NodeId, Expression],
                         segments: Dict[NodeId, Any]) -> Optional[Expression]:
        """Build (or reuse, within this pull) the one bundle expression of
        ``binding`` and return the expression of its output ``graph_id``;
        None when this pull's inputs are not datasets (a datum pull)."""
        outs_key = ("__segment_outs__", binding.index)
        out_exprs = transient.get(outs_key)
        if out_exprs is None:
            if any(n in self._state or n in transient for n in binding.nodes):
                # a member holds a result already (a fit's next executor keeps
                # what its predecessor computed): node dispatch reads it, where
                # the segment would compute every member again
                return None
            in_exprs = [self._execute(d, transient, built, segments) for d in binding.inputs]
            if not all(isinstance(e, DatasetExpression) for e in in_exprs):
                return None
            bundle = _segment_bundle(binding, in_exprs)
            graph = self.graph
            out_exprs = {}
            for j, out in enumerate(binding.outputs):
                oe = DatasetExpression(lambda j=j: bundle.get()[j])
                out_exprs[out] = oe
                built[out] = oe
                if self._retain(graph, out):
                    self._state[out] = oe
                else:
                    transient[out] = oe
                prefix = self._annotations.get(out)
                if prefix is not None:
                    PipelineEnv.get_or_create().state[prefix] = oe
            transient[outs_key] = out_exprs
            transient.setdefault(_SEGMENT_OUTPUTS, {}).update(
                {out: binding for out in binding.outputs})
        return out_exprs.get(graph_id)

    def _arm_concurrent(self, root_expr: Expression, built: Dict[NodeId, Expression],
                        segment_outputs: Optional[Dict[NodeId, Any]] = None) -> None:
        """Wrap the pull root's thunk so that its first forcing runs every
        other pending node of this pull through the worker pool, then the
        root on the calling thread. A pull whose pending nodes never have
        two ready at once is left alone."""
        if getattr(root_expr, "_sched_armed", False):
            return
        pending = {n: e for n, e in built.items() if not e.computed}
        root_node = next((n for n, e in built.items() if e is root_expr), None)
        sched = [n for n in pending if n != root_node]
        if len(sched) < 2:
            return

        graph = self.graph
        in_sched = set(sched)
        deps_of: Dict[NodeId, List[NodeId]] = {}
        children: Dict[NodeId, List[NodeId]] = {n: [] for n in sched}
        for n in sched:
            ds = []
            # a segment output of this pull: its graph dependencies are the
            # segment's interior nodes, absent from ``built``, so its
            # scheduling edges are the segment's external inputs
            dep_src = (segment_outputs[n].inputs if segment_outputs and n in segment_outputs
                       else graph.get_dependencies(n))
            for d in dep_src:
                if isinstance(d, NodeId) and d in in_sched and d not in ds:
                    ds.append(d)
            deps_of[n] = ds
            for d in ds:
                children[d].append(n)

        # width probe (Kahn waves): a strict chain stays on the serial path
        indeg = {n: len(deps_of[n]) for n in sched}
        wave = [n for n in sched if indeg[n] == 0]
        width = 0
        while wave:
            width = max(width, len(wave))
            nxt: List[NodeId] = []
            for n in wave:
                for c in children[n]:
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        nxt.append(c)
            wave = nxt
        if width < 2:
            return

        # submitting ready nodes lowest-index first keeps the device work in
        # the order the serial pull would have queued it
        topo = {n: i for i, n in enumerate(built) if n in in_sched}
        exprs = {n: built[n] for n in sched}

        def wrap(thunk):
            def scheduled_pull():
                _force_scheduled(exprs, deps_of, children, topo)
                return thunk()

            return scheduled_pull

        root_expr.map_thunk(wrap)
        root_expr._sched_armed = True


def _segment_bundle(binding: Any, in_exprs: List[Expression]) -> Expression:
    """The segment's one lazy thunk: force the input expressions (outside
    the segment's span, so upstream spans keep their own time), then run the
    whole segment under one ``exec.segment`` span, the span that stands for
    the members' node spans."""

    def run_bundle():
        xs = [e.get() for e in in_exprs]
        tracer = _trace_current()
        if tracer is None:
            return binding.run(xs)[0]
        with tracer.span("exec.segment", op_type="Segment", segment=binding.index,
                         nodes=len(binding.node_ids), node_ids=list(binding.node_ids),
                         digest=(binding.known_digest or "")[:16], label=binding.label) as sp:
            outs, path = binding.run(xs)
            sp.attrs["path"] = path
            if path != "chunked":
                # a chunked output is a lazy scan: waiting on it here would
                # run the whole out-of-core pass inside this span
                sp.sync_on(tuple(d.payload for d in outs))
        return outs

    return Expression(run_bundle)


def _trace_hit(tracer, graph: Graph, graph_id: NodeId, store: str) -> None:
    """A memoized result was returned instead of recomputed."""
    op = graph.get_operator(graph_id)
    tracer.instant(f"node.{op.label}", node_id=str(graph_id.id), op_type=type(op).__name__,
                   cache="hit", store=store)


def _traced_execute(tracer, graph_id: NodeId, op, deps, retained: bool) -> Expression:
    """The node's expression with its evaluation wrapped in a span. The
    span opens when ``get()`` first forces the node, so the upstream
    thunks forced inside it become its children; it closes after waiting
    for the card's work on the result."""
    from ..obs.span import Span, cheap_nbytes

    name = f"node.{op.label}"
    op_type = type(op).__name__
    node_id = str(graph_id.id)
    t0 = time.perf_counter()
    expr = op.execute(deps)
    if expr.computed:
        # an eager leaf (data, saved state): its work happened above
        tracer.record_complete(Span(
            name=name, start=t0, end=time.perf_counter(), node_id=node_id, op_type=op_type,
            cache="miss", output_bytes=cheap_nbytes(expr.get()),
            attrs={"retained": retained, "eager": True},
        ))
        return expr

    def wrap(thunk):
        def traced_thunk():
            extra = {}
            if getattr(_TASK_CTX, "node_id", None) == node_id:
                # consumed once: a nested pull inside this thunk may reuse
                # the id string (ids count per graph)
                _TASK_CTX.node_id = None
                extra = {"queue_wait_seconds": round(_TASK_CTX.queue_wait, 6),
                         "worker": _TASK_CTX.worker}
            with tracer.span(name, node_id=node_id, op_type=op_type, cache="miss",
                             retained=retained, **extra) as sp:
                value = thunk()
                sp.sync_on(value)
            return value

        return traced_thunk

    expr.map_thunk(wrap)
    return expr


def _force_scheduled(
    exprs: Dict[NodeId, Expression],
    deps_of: Dict[NodeId, List[NodeId]],
    children: Dict[NodeId, List[NodeId]],
    topo: Dict[NodeId, int],
) -> None:
    """Force every expression of ``exprs`` on a bounded worker pool, each
    only after its scheduled dependencies. On a branch exception: start
    nothing more, drain the running workers, re-raise the first exception
    with its traceback."""
    remaining = [n for n, e in exprs.items() if not e.computed]
    if not remaining:
        return
    tracer = _trace_current()
    parent = tracer.current_span() if tracer is not None else None
    in_remaining = set(remaining)
    indeg = {n: sum(1 for d in deps_of[n] if d in in_remaining) for n in remaining}
    now = time.perf_counter()
    # an entry carries the instant its node became ready: the queue wait is
    # ready to started, time parked here while the workers are busy included
    ready = [(topo[n], n, now) for n in remaining if indeg[n] == 0]
    heapq.heapify(ready)
    cond = threading.Condition()
    state = {"pending": len(remaining), "inflight": 0}
    failures: List[BaseException] = []

    def run_one(node: NodeId, expr: Expression, ready_since: float) -> None:
        err: Optional[BaseException] = None
        _TASK_CTX.node_id = str(node.id)
        _TASK_CTX.queue_wait = time.perf_counter() - ready_since
        _TASK_CTX.worker = threading.current_thread().name
        try:
            if tracer is not None:
                with tracer.adopt(parent):
                    expr.get()
            else:
                expr.get()
        except BaseException as e:  # noqa: BLE001 — must reach the caller
            err = e
        finally:
            _TASK_CTX.node_id = None
        with cond:
            state["inflight"] -= 1
            if err is not None:
                failures.append(err)
            else:
                state["pending"] -= 1
                # consumers hold their own references through their thunks,
                # so a result frees after its last consumer, as in the
                # serial pull
                exprs.pop(node, None)
                t_ready = time.perf_counter()
                for c in children[node]:
                    if c in indeg:
                        indeg[c] -= 1
                        if indeg[c] == 0:
                            heapq.heappush(ready, (topo[c], c, t_ready))
            cond.notify_all()

    # one pool per pull: a process-wide bounded pool would deadlock when a
    # scheduled node's thunk runs a nested pull
    workers = min(exec_workers(), len(remaining))
    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="keystone-exec")
    try:
        with cond:
            while state["pending"] and not failures:
                while ready and state["inflight"] < workers and not failures:
                    _, node, since = heapq.heappop(ready)
                    state["inflight"] += 1
                    pool.submit(run_one, node, exprs[node], since)
                if state["pending"] and not failures:
                    cond.wait()
            while state["inflight"]:
                cond.wait()
    finally:
        pool.shutdown(wait=True)
    if failures:
        raise failures[0]
