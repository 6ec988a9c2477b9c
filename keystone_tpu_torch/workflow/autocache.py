"""Profile-guided cache insertion (port of
``keystone_tpu/workflow/autocache.py``; parity: ``workflow/AutoCacheRule.scala``).

The reference profiles nodes at several sample scales, fits linear
time-and-memory against scale models (``generalizeProfiles``), estimates
per-node run counts from downstream weights (``getRuns``) and inserts
Cacher nodes: after everything reused (``aggressiveCache``) or greedily,
maximizing saved time under a memory budget (``greedyCache``).

Here the same algorithm runs over the card's memory: once this rule has
run, the executor retains only Cacher, data-leaf, saved-state and
fitted-estimator results across pulls (``executor.GraphExecutor._retain``),
so the budget bounds what stays resident, and an uncached intermediate
recomputes as an unpersisted RDD does.

Three things differ from the JAX package. No Cacher goes after an
estimator: its result is a fitted transformer, which the executor retains
anyway and which a Cacher (a transformer of datasets) cannot take; the JAX
package inserts one after an estimator consumed twice (any chain of two
estimators) and the fit raises. The other two are for the card:

* **Timing.** A timed sampled pull synchronizes the device before each
  clock reading, so a profile times the work, not its launch (a pull
  returns when its kernels are queued; the JAX package's ``.get()`` does
  not block either).
* **The budget.** 0.75 × what the caching allocator can still hand out on
  the device the graph runs on (``_graph_device``): the card's free bytes
  (``torch.cuda.mem_get_info``) plus the bytes it has reserved and not
  allocated. On the CPU it stays 4 GiB.
* **Failures at sample scale.** A node that fails on its truncated inputs
  goes unprofiled, as in the JAX package, but a kernel's build or launch
  failure (:class:`~keystone_tpu_torch.ops._build.KernelError`) and a
  device fault (out of memory, an accelerator error) propagate.

With a profile store (``cost/``) the greedy plan comes from a previous
traced run's observed per-node costs when they cover the graph (no
sampling at all); otherwise from sampling, corrected by the stored
per-node calibration ratios, with the unprofiled nodes priced from their
class's stored throughput.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Dataset
from ..obs import tracer as obs_tracer
from ..ops import DEVICE_FAULTS
from . import analysis
from .executor import GraphExecutor
from .graph import Graph, NodeId
from .node_optimization import _sampled_graph
from .operators import DatasetOperator, EstimatorOperator
from .rules import Annotations, Rule

logger = logging.getLogger(__name__)

#: the annotation marking that cache planning ran (the executor switches
#: from retaining everything to retaining Cachers and leaves)
AUTOCACHE_ACTIVE = "autocache_active"

#: the budget off the card
_HOST_BUDGET_BYTES = 4 << 30


@dataclass
class Profile:
    """One node's cost estimate (parity: ``AutoCacheRule.scala:12``)."""

    ns: float  # nanoseconds to compute
    mem_bytes: float  # size of the materialized result

    def __add__(self, other: "Profile") -> "Profile":
        return Profile(self.ns + other.ns, self.mem_bytes + other.mem_bytes)


def _result_bytes(value) -> float:
    """A sampled result's size; profiling may force an item list (that is
    its job, unlike the tracer's sizing)."""
    from ..obs.span import cheap_nbytes

    if isinstance(value, Dataset) and not value.is_batched:
        return float(sum(int(getattr(x, "nbytes", 64)) for x in value.collect()))
    n = cheap_nbytes(value)
    return 64.0 if n is None else float(n)


def _sync_device() -> None:
    """Wait for the card's queued work, so the clock reads finished work."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _profile_at_scale(graph: Graph, sample_size: int) -> Dict[NodeId, Profile]:
    """Each node's seconds and bytes with every leaf cut to
    ``sample_size`` items. The pulls are serial: the fitted time-against-
    scale model needs each node's own time, which sibling branches on the
    pool would inflate or hide."""
    from .. import cost as cost_mod

    sampled = _sampled_graph(graph, sample_size)
    executor = GraphExecutor(sampled, optimize=False, parallel=False)
    profiles: Dict[NodeId, Profile] = {}
    # the truncated graph's node ids collide with the real graph's: its
    # pulls must not reach the trace
    with obs_tracer.suspended():
        for gid in analysis.linearize(sampled):
            if not isinstance(gid, NodeId):
                continue
            try:
                _sync_device()
                t0 = time.perf_counter_ns()
                cost_mod.count_sampling("autocache")
                value = executor.execute(gid).get()
                _sync_device()
                elapsed = time.perf_counter_ns() - t0
            except DEVICE_FAULTS:
                raise
            except Exception as e:
                logger.debug("profiling skipped %s: %s", gid, e)
                continue
            profiles[gid] = Profile(float(elapsed), _result_bytes(value))
    return profiles


def profile_nodes(graph: Graph, sample_sizes: Sequence[int] = (8, 16, 24),
                  full_size: Optional[int] = None,
                  calibration: Optional[Dict[NodeId, float]] = None) -> Dict[NodeId, Profile]:
    """Profile at several sample scales and fit a line per node,
    extrapolated to the full input size (parity: ``generalizeProfiles``;
    the minimum time of the scales floors it, damping warm-up noise).

    ``calibration`` holds per-node observed/estimated seconds ratios from a
    previous traced run of the same pipeline
    (``cost.replan.stored_calibration``): each node's extrapolation is
    scaled by its own measured ratio, clamped to [1/64, 64] so one corrupt
    observation cannot erase or explode a plan."""
    input_size = _full_input_size(graph)
    # the truncated size actually run: the scale capped by the data's size
    scales = sorted({min(s, input_size) for s in sample_sizes})
    per_scale = [(s, _profile_at_scale(graph, s)) for s in scales]
    nodes = set().union(*[set(p) for _, p in per_scale]) if per_scale else set()
    out: Dict[NodeId, Profile] = {}
    for n in nodes:
        xs, ts, bs = [], [], []
        for s, profs in per_scale:
            if n in profs:
                xs.append(float(s))
                ts.append(profs[n].ns)
                bs.append(profs[n].mem_bytes)
        target = float(full_size if full_size is not None else max(xs))
        if len(set(xs)) >= 2:
            A = np.stack([np.ones(len(xs)), np.asarray(xs)], axis=1)
            t_coef, *_ = np.linalg.lstsq(A, np.asarray(ts), rcond=None)
            b_coef, *_ = np.linalg.lstsq(A, np.asarray(bs), rcond=None)
            ns = max(t_coef[0] + t_coef[1] * target, min(ts))
            mem = max(b_coef[0] + b_coef[1] * target, 0.0)
        else:
            scale = target / xs[-1]
            ns, mem = ts[-1] * scale, bs[-1] * scale
        ratio = (calibration or {}).get(n)
        if ratio is not None:
            ns *= float(np.clip(ratio, 1.0 / 64.0, 64.0))
        out[n] = Profile(float(ns), float(mem))
    return out


def _children_map(graph: Graph) -> Dict[object, set]:
    """Every node's and source's consumers (nodes and sinks), in one pass:
    ``analysis.get_children`` scans the whole graph for one id."""
    children: Dict[object, set] = {}
    for node, deps in graph.dependencies.items():
        for d in deps:
            children.setdefault(d, set()).add(node)
    for sink, dep in graph.sink_dependencies.items():
        children.setdefault(dep, set()).add(sink)
    return children


def estimate_runs(graph: Graph, weights: Dict[NodeId, int], cached: set,
                  children: Optional[Dict[object, set]] = None) -> Dict[NodeId, int]:
    """How often each node runs given the cached nodes: once per weighted
    downstream path that no cached node cuts (parity: ``getRuns``).
    ``children`` is the graph's consumer map, when the caller has it."""
    if children is None:
        children = _children_map(graph)
    runs: Dict[NodeId, int] = {}

    def runs_of(gid) -> int:
        if gid in runs:
            return runs[gid]
        consumers = children.get(gid, ())
        if not consumers:
            total = 1
        else:
            total = 0
            for c in consumers:
                if isinstance(c, NodeId):
                    total += weights.get(c, 1) * (1 if c in cached else runs_of(c))
                else:  # a sink
                    total += 1
        runs[gid] = max(total, 1)
        return runs[gid]

    for n in graph.nodes:
        runs_of(n)
    return runs


def _graph_device(graph: Graph, store=None) -> torch.device:
    """Where the graph's work runs, whose memory the budget is: the CUDA
    device of any tensor its in-memory data holds, else the CPU when that
    data lies there (the caller asked for it). A graph with no such data (a
    chunked or host-fed source, or the re-fit of a fitted pipeline, which
    binds none) runs where the port's fits run: ``store``'s device (the
    command line's ``--device``), else the card when there is one."""
    from ..cost.store import fit_device
    from ..data.dataset import first_leaf

    on_cpu = False
    for n in graph.nodes:
        op = graph.get_operator(n)
        if isinstance(op, DatasetOperator) and op.dataset.is_batched \
                and not op.dataset.is_chunked:
            leaf = first_leaf(op.dataset.payload)
            if isinstance(leaf, torch.Tensor):
                if leaf.is_cuda:
                    return leaf.device
                on_cpu = True
    if on_cpu:
        return torch.device("cpu")
    return store.device if store is not None else fit_device()


def _device_budget_bytes(device: Optional[torch.device] = None) -> int:
    """0.75 × the bytes the caching allocator can still hand out on a CUDA
    ``device`` (free on the card plus reserved and unallocated); 4 GiB
    elsewhere."""
    if device is None or device.type != "cuda":
        return _HOST_BUDGET_BYTES
    free, _ = torch.cuda.mem_get_info(device)
    slack = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return int(0.75 * (free + slack))


def _is_cacher(op) -> bool:
    from ..nodes.util.core import Cacher

    return isinstance(op, Cacher)


def _candidate(op) -> bool:
    """Whether a Cacher may go after this node: not after a Cacher, and not
    after an estimator, whose result (a fitted transformer, not a dataset)
    the executor retains anyway and a Cacher cannot take: the JAX package
    inserts one there and the fit raises."""
    return not (_is_cacher(op) or isinstance(op, EstimatorOperator))


def insert_cachers(graph: Graph, nodes: Sequence[NodeId]) -> Graph:
    """Splice a Cacher after each selected node and reroute every consumer
    through it, reusing a Cacher already there (parity:
    ``addCachesToPipeline``)."""
    from ..nodes.util.core import Cacher

    for n in nodes:
        children = analysis.get_children(graph, n)
        existing = [c for c in children
                    if isinstance(c, NodeId) and _is_cacher(graph.get_operator(c))]
        if existing:
            cacher = sorted(existing)[0]
        else:
            graph, cacher = graph.add_node(Cacher(), [n])
        for c in children:
            if c == cacher:
                continue
            if isinstance(c, NodeId):
                if _is_cacher(graph.get_operator(c)):
                    continue  # a second Cacher: left alone
                deps = [cacher if d == n else d for d in graph.get_dependencies(c)]
                graph = graph.set_dependencies(c, deps)
            else:  # a sink
                graph = graph.set_sink_dependency(c, cacher)
    return graph


class AutoCacheRule(Rule):
    """Insert Cacher nodes by the aggressive or the greedy policy; the
    executor then retains only cached results across pulls."""

    def __init__(self, strategy: str = "greedy", mem_budget_bytes: Optional[int] = None,
                 profiles: Optional[Dict[NodeId, Profile]] = None):
        self.strategy = strategy
        self.mem_budget_bytes = mem_budget_bytes
        self.profiles = profiles  # injectable (parity: the reference's suite)

    def _select_aggressive(self, graph: Graph) -> set:
        """Every node consumed along more than one downstream path."""
        children = _children_map(graph)
        return {n for n in graph.nodes
                if len(children.get(n, ())) > 1 and _candidate(graph.get_operator(n))}

    def _select_greedy(self, graph: Graph, profiles: Dict[NodeId, Profile],
                       budget: float) -> set:
        """Repeatedly cache the node whose caching saves the most time and
        still fits the budget, until no node saves anything."""
        nodes = graph.nodes  # a property that builds the set anew
        weights = {n: getattr(graph.get_operator(n), "weight", 1) for n in nodes}
        # Cachers already in the graph cut recomputation: the run estimate
        # starts from them, so their upstreams' savings are not counted twice
        preexisting = {n for n in nodes if _is_cacher(graph.get_operator(n))}
        cached: set = set(preexisting)
        children = _children_map(graph)
        candidates = sorted((n, p) for n, p in profiles.items()
                            if n in nodes and _candidate(graph.get_operator(n)))
        spent = 0.0
        while True:
            runs = estimate_runs(graph, weights, cached, children)
            best, best_save = None, 0.0
            for n, p in candidates:
                if n in cached:
                    continue
                if spent + p.mem_bytes > budget:
                    continue
                save = (runs[n] - 1) * p.ns
                if save > best_save:
                    best, best_save = n, save
            if best is None:
                break
            cached.add(best)
            spent += profiles[best].mem_bytes
        return cached - preexisting

    def apply(self, graph: Graph, annotations: Annotations) -> Tuple[Graph, Annotations]:
        from .. import cost as cost_mod
        from ..cost import replan as cost_replan

        store = cost_mod.get_store()
        fp = cost_mod.graph_fingerprint(graph) if store is not None else None
        index = cost_replan.topo_node_index(graph) if store is not None else None
        plan_rec = cost_replan.load_plan_record(store, fp) if store is not None else None
        profiles: Optional[Dict[NodeId, Profile]] = None
        source = "none"
        budget: Optional[float] = None
        if self.strategy == "aggressive":
            selected = self._select_aggressive(graph)
        else:
            full_n = _full_input_size(graph)
            profiles = self.profiles
            source = "injected" if profiles is not None else source
            if profiles is None and store is not None:
                # a traced run of this pipeline left observed per-node
                # costs: plan from them, with no sampling
                profiles = cost_replan.stored_profiles(store, graph, full_n, fp=fp,
                                                       index=index, rec=plan_rec)
                if profiles is not None:
                    source = "profiles"
                    logger.info("auto-cache: planning %d nodes from stored profiles "
                                "(no sampling)", len(profiles))
            if profiles is None:
                calibration = cost_replan.stored_calibration(store, graph, fp=fp,
                                                             index=index, rec=plan_rec)
                profiles = profile_nodes(graph, full_size=full_n, calibration=calibration)
                source = "sampled+calibrated" if calibration else "sampled"
                self._fill_from_class_throughput(graph, profiles, full_n)
                if store is not None:
                    # persisted now: a graph optimized outside a fit never
                    # reaches the re-plan hook and would sample every run;
                    # a traced fit of it overwrites this with observations
                    self._persist_sampled_plan(store, graph, profiles, full_n, source, fp,
                                               index)
            budget = float(self.mem_budget_bytes if self.mem_budget_bytes is not None
                           else _device_budget_bytes(_graph_device(graph, store)))
            selected = self._select_greedy(graph, profiles, budget)
        self._record_plan(graph, profiles, selected)
        self._record_pending(graph, profiles, selected, source, budget, fp, index)
        self._record_estimate_span(profiles, selected, source)
        if selected:
            logger.info("auto-cache (%s): inserting Cacher after %d nodes (%s)", self.strategy,
                        len(selected),
                        ", ".join(graph.get_operator(n).label for n in sorted(selected)))
            graph = insert_cachers(graph, sorted(selected))
        annotations = dict(annotations)
        annotations[AUTOCACHE_ACTIVE] = True  # type: ignore[index]
        return graph, annotations

    @staticmethod
    def _record_plan(graph: Graph, profiles: Optional[Dict[NodeId, Profile]],
                     selected: set) -> None:
        """Record the per-node estimates in the trace for the audit. Node ids
        are recorded before the Cachers go in (``insert_cachers`` keeps the
        planned nodes' ids) and match the executor's spans while later
        rewrites leave the node in place; the audit flags the others."""
        tracer = obs_tracer.current()
        if tracer is None:
            return
        for n in (set(profiles or ()) | set(selected)) & graph.nodes:
            p = (profiles or {}).get(n)
            tracer.record_node_estimate(
                str(n.id), graph.get_operator(n).label,
                est_seconds=None if p is None else p.ns / 1e9,
                est_bytes=None if p is None else p.mem_bytes,
                cacher=n in selected,
            )

    @staticmethod
    def _fill_from_class_throughput(graph: Graph, profiles: Dict[NodeId, Profile],
                                    full_n: int) -> None:
        """Price the nodes sampled profiling skipped (an upstream failure at
        sample scale, an estimator that cannot run truncated) from the
        store's per-class throughput: evidence from other pipelines on
        this environment."""
        from .. import cost as cost_mod

        estimator = cost_mod.get_estimator()
        for n in graph.nodes:
            if n in profiles:
                continue
            op = graph.get_operator(n)
            if isinstance(op, DatasetOperator) or _is_cacher(op):
                continue
            priced = estimator.node_profile_ns(type(op).__name__, full_n)
            if priced is not None:
                profiles[n] = Profile(priced[0], priced[1])
                logger.info("auto-cache: priced unprofiled %s from class throughput evidence",
                            op.label)

    @staticmethod
    def _persist_sampled_plan(store, graph: Graph, profiles: Dict[NodeId, Profile],
                              full_n: int, source: str, fp: str,
                              index: Dict[NodeId, int]) -> None:
        from ..cost.replan import PLAN_VERSION

        nodes = {}
        for n in graph.nodes:
            p = profiles.get(n)
            if p is None:
                continue
            op = graph.get_operator(n)
            nodes[str(index[n])] = {
                "idx": index[n], "label": op.label, "op_class": type(op).__name__,
                "n": max(int(full_n), 1), "observed": False,
                "seconds": round(p.ns / 1e9, 9), "bytes": float(p.mem_bytes),
            }
        if len(nodes) != len(graph.nodes):
            return  # a partial plan would be sampled again anyway
        store.update(f"plan/{fp}", lambda rec: {
            "version": PLAN_VERSION, "strategy": "greedy", "budget": None,
            "full_n": max(int(full_n), 1), "source": source, "nodes": nodes,
        })

    @staticmethod
    def _record_pending(graph: Graph, profiles: Optional[Dict[NodeId, Profile]], selected: set,
                        source: str, budget: Optional[float], fp: Optional[str],
                        index: Optional[Dict[NodeId, int]]) -> None:
        """Deposit the cache plan in the pending re-plan (``cost/replan.py``):
        what ``finalize`` joins with the observations."""
        from .. import cost as cost_mod
        from ..cost.replan import topo_node_index

        plan = cost_mod.current_plan()
        # the first deposit wins: a sub-pipeline optimized while the outer
        # fit runs must not replace the outer fit's plan
        if plan is None or plan.autocache is not None:
            return
        if index is None:
            index = topo_node_index(graph)
        nodes = {}
        for n in graph.nodes:
            op = graph.get_operator(n)
            p = (profiles or {}).get(n)
            nodes[str(n.id)] = {
                "idx": index[n], "label": op.label, "op_class": type(op).__name__,
                "est_ns": None if p is None else p.ns,
                "est_bytes": None if p is None else p.mem_bytes,
                "cacher": n in selected, "leaf": isinstance(op, DatasetOperator),
            }
        plan.autocache = {
            "fp": fp if fp is not None else cost_mod.graph_fingerprint(graph),
            "graph": graph,
            "strategy": "greedy" if budget is not None else "aggressive",
            "budget": budget if budget is not None else 0.0,
            "full_n": _full_input_size(graph),
            "selected": set(selected),
            "source": source,
            "nodes": nodes,
        }

    @staticmethod
    def _record_estimate_span(profiles: Optional[Dict[NodeId, Profile]], selected: set,
                              source: str) -> None:
        tracer = obs_tracer.current()
        if tracer is None:
            return
        with tracer.span("cost.estimate", op_type="AutoCacheRule", source=source,
                         nodes=0 if profiles is None else len(profiles),
                         cachers=len(selected)):
            pass


def _full_input_size(graph: Graph) -> int:
    n = 1
    for node in graph.nodes:
        op = graph.get_operator(node)
        if isinstance(op, DatasetOperator):
            n = max(n, len(op.dataset))
    return n
