"""Pull-based memoized graph executor with dependency-scheduled concurrency
(port of ``keystone_tpu/workflow/executor.py``; parity:
``workflow/GraphExecutor.scala``).

The executor optimizes its graph lazily on first use, then
``execute(graph_id)`` recursively pulls dependency expressions, memoizing
one expression per node. Results of saveable prefixes (annotated by the
optimizer) are written into the global :class:`PipelineEnv` state so later
executions skip the work entirely.

Every node's result is retained for the executor's life, the JAX
package's default when no auto-cache plan is present: a graph's results
live as long as the executor that computed them, so an owner that keeps
an executor past its use (``Pipeline._fit``) releases its state itself.

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

Not ported: segment dispatch and trace spans.
"""

from __future__ import annotations

import heapq
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from ..utils import env_flag, env_int
from .env import PipelineEnv
from .expressions import Expression
from .graph import Graph, GraphId, NodeId, SinkId, SourceId
from .rules import Annotations


def parallel_enabled() -> bool:
    """The ``KEYSTONE_PAR_EXEC`` kill switch (default on), read per pull."""
    return env_flag("KEYSTONE_PAR_EXEC", True)


def exec_workers() -> int:
    """Worker-pool width of a scheduled pull: ``KEYSTONE_EXEC_WORKERS``,
    default ``min(8, cpu)``."""
    return env_int("KEYSTONE_EXEC_WORKERS", min(8, os.cpu_count() or 1))


class GraphExecutor:
    def __init__(self, graph: Graph, optimize: bool = True,
                 parallel: Optional[bool] = None):
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

    def _use_parallel(self) -> bool:
        if self._parallel is not None:
            return self._parallel
        return parallel_enabled()

    def execute(self, graph_id: GraphId) -> Expression:
        with self._build_lock:
            built: Dict[NodeId, Expression] = {}
            expr = self._execute(graph_id, built)
            if self._use_parallel():
                self._arm_concurrent(expr, built)
        return expr

    def _execute(self, graph_id: GraphId, built: Dict[NodeId, Expression]) -> Expression:
        graph = self.graph  # optimize before anything runs
        if isinstance(graph_id, SourceId):
            raise ValueError(f"cannot execute unconnected {graph_id}")
        if isinstance(graph_id, SinkId):
            return self._execute(graph.get_sink_dependency(graph_id), built)
        expr = self._state.get(graph_id)
        if expr is not None:
            built.setdefault(graph_id, expr)
            return expr
        deps = [self._execute(d, built) for d in graph.get_dependencies(graph_id)]
        expr = graph.get_operator(graph_id).execute(deps)
        # every node of this pull, dependencies first: the scheduler's
        # topological order comes straight from it
        built[graph_id] = expr
        self._state[graph_id] = expr
        prefix = self._annotations.get(graph_id)
        if prefix is not None:
            PipelineEnv.get_or_create().state[prefix] = expr
        return expr

    def _arm_concurrent(self, root_expr: Expression, built: Dict[NodeId, Expression]) -> None:
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
            for d in graph.get_dependencies(n):
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
    in_remaining = set(remaining)
    indeg = {n: sum(1 for d in deps_of[n] if d in in_remaining) for n in remaining}
    ready = [(topo[n], n) for n in remaining if indeg[n] == 0]
    heapq.heapify(ready)
    cond = threading.Condition()
    state = {"pending": len(remaining), "inflight": 0}
    failures: List[BaseException] = []

    def run_one(node: NodeId, expr: Expression) -> None:
        err: Optional[BaseException] = None
        try:
            expr.get()
        except BaseException as e:  # noqa: BLE001 — must reach the caller
            err = e
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
                for c in children[node]:
                    if c in indeg:
                        indeg[c] -= 1
                        if indeg[c] == 0:
                            heapq.heappush(ready, (topo[c], c))
            cond.notify_all()

    # one pool per pull: a process-wide bounded pool would deadlock when a
    # scheduled node's thunk runs a nested pull
    workers = min(exec_workers(), len(remaining))
    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="keystone-exec")
    try:
        with cond:
            while state["pending"] and not failures:
                while ready and state["inflight"] < workers and not failures:
                    _, node = heapq.heappop(ready)
                    state["inflight"] += 1
                    pool.submit(run_one, node, exprs[node])
                if state["pending"] and not failures:
                    cond.wait()
            while state["inflight"]:
                cond.wait()
    finally:
        pool.shutdown(wait=True)
    if failures:
        raise failures[0]
