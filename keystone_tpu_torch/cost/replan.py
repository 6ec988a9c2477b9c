"""Trace-informed re-planning: the loop that turns plans into evidence
(port of ``keystone_tpu/cost/replan.py``).

``Pipeline.fit`` opens a :class:`PendingPlan` around the optimizer run;
the planning rules deposit what they decided (solver choice and shape,
per-node cost estimates, the cache plan and its budget). After the fit,
:func:`finalize` joins those decisions with the trace's observed per-node
costs (``obs/audit.py``) and

1. updates the profile store's ``op/<OperatorClass>`` throughput records
   (solver seconds per unit, per-item node seconds and bytes);
2. writes ``solver/<fp>`` and ``plan/<fp>`` records, so the next fit of
   the same pipeline plans from evidence with zero sampling executions;
3. selects the greedy cache plan again from the observed node costs and
   logs the difference from the sampled plan (a ``cost.replan`` span
   carries the added and removed node labels).

A graph's identity is a structural fingerprint (:func:`graph_fingerprint`)
over the deterministic linearization: operator class, label, a leaf's data
shape, the dependencies, and, for an operator whose parameters have a
canonical form, the content digest CSE merges by
(``workflow/operators.structural_key``), so two pipelines of one shape
with other parameters are two records. Node ids are never persisted:
records address nodes by their linearized index, stable across processes
for the same pipeline build.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

logger = logging.getLogger(__name__)

#: plan-record schema version; a bump invalidates persisted plans
PLAN_VERSION = 1


def _leaf_signature(op) -> str:
    """A data leaf's shape: the label holds n only, and a stored solver
    shape replayed against data of another width would be stale."""
    from ..workflow.operators import DatasetOperator

    if not isinstance(op, DatasetOperator):
        return ""
    ds = op.dataset
    if ds.is_chunked:
        return f"|chunked[{len(ds)}]"
    shape = getattr(ds.payload, "shape", None)
    if shape is not None:
        return f"|shape{tuple(int(s) for s in shape)}"
    return f"|items[{len(ds)}]"


def _param_digest(op) -> str:
    """The content digest of an operator's parameters, or "" when they
    have no canonical form (closures, datasets: identity is all CSE has)."""
    from ..workflow.operators import structural_key

    key = structural_key(op)
    if key is op:
        return ""
    return "|" + hashlib.sha256(repr(key[1]).encode()).hexdigest()[:16]


def graph_fingerprint(graph) -> str:
    """The sha256 of a workflow graph's structure, stable across processes:
    one line per linearized id (kind, operator class, label, leaf shape,
    parameter digest, dependency indices)."""
    from ..workflow import analysis
    from ..workflow.graph import NodeId, SinkId, SourceId

    order = analysis.linearize(graph)
    index = {gid: i for i, gid in enumerate(order)}
    h = hashlib.sha256()
    for gid in order:
        if isinstance(gid, NodeId):
            op = graph.get_operator(gid)
            deps = ",".join(str(index[d]) for d in graph.get_dependencies(gid))
            line = (f"N|{type(op).__module__}.{type(op).__qualname__}|{op.label}"
                    f"{_leaf_signature(op)}{_param_digest(op)}|{deps}")
        elif isinstance(gid, SourceId):
            line = "S"
        elif isinstance(gid, SinkId):
            line = f"K|{index[graph.get_sink_dependency(gid)]}"
        else:  # pragma: no cover - no other id kinds exist
            line = f"?|{gid!r}"
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


def topo_node_index(graph) -> Dict[object, int]:
    """NodeId -> linearized index (the persistent node address)."""
    from ..workflow import analysis
    from ..workflow.graph import NodeId

    return {gid: i for i, gid in enumerate(analysis.linearize(graph))
            if isinstance(gid, NodeId)}


# ---------------------------------------------------------------------------
# The pending plan: rules deposit decisions here during one fit
# ---------------------------------------------------------------------------


@dataclass
class PendingPlan:
    store: object  # ProfileStore
    #: {"fp", "node_idx", "node_id", "shape", "chosen", "units", "source"}
    solver: Optional[Dict] = None
    #: {"fp", "graph", "budget", "strategy", "selected", "source", "full_n",
    #:  "nodes": {node_id_str: {...}}}
    autocache: Optional[Dict] = None
    #: sampling executions performed while planning this fit
    sampling_executions: int = 0
    #: the tracer's span count when this fit opened: finalize joins only
    #: the spans recorded after it
    span_watermark: int = 0


_local = threading.local()


def current_plan() -> Optional[PendingPlan]:
    return getattr(_local, "plan", None)


@contextlib.contextmanager
def pending_plan(store):
    """Arm a PendingPlan for the calling thread's fit (nothing without a
    store, or inside another fit's plan). Yields the plan or None."""
    if store is None or current_plan() is not None:
        yield None
        return
    plan = PendingPlan(store=store)
    _local.plan = plan
    try:
        yield plan
    finally:
        _local.plan = None


# ---------------------------------------------------------------------------
# Finalize: join plan and observation, update the store, re-plan
# ---------------------------------------------------------------------------


def finalize(plan: Optional[PendingPlan], tracer) -> None:
    """Close the loop after a fit. Never raises: a failed profile update
    must not fail a fit that already produced a model."""
    if plan is None or plan.store is None or tracer is None:
        return
    try:
        _finalize(plan, tracer)
    except Exception:
        logger.warning("cost: trace-informed re-plan failed", exc_info=True)


def _finalize(plan: PendingPlan, tracer) -> None:
    from ..obs.audit import observed_by_node
    from ..workflow.autocache import Profile
    from .model import CostEstimator

    observed = observed_by_node(tracer, start=plan.span_watermark)
    estimator = CostEstimator(plan.store)

    if plan.solver is not None:
        sol = plan.solver
        obs = observed.get(str(sol["node_id"]))
        if obs is not None and obs["seconds"] > 0:
            estimator.observe_solver(sol["chosen"], float(sol["units"]), obs["seconds"])
        plan.store.update(f"solver/{sol['fp']}", lambda rec: {
            "version": PLAN_VERSION,
            "node_idx": int(sol["node_idx"]),
            "shape": sol["shape"],
            "chosen": sol["chosen"],
            "observed_seconds": None if obs is None else round(obs["seconds"], 6),
        })

    if plan.autocache is None:
        return
    ac = plan.autocache
    graph = ac["graph"]
    node_at = {i: n for n, i in topo_node_index(graph).items()}
    nodes_rec: Dict[str, Dict] = {}
    replan_input = {}
    class_obs: Dict[str, List] = {}
    n_full = max(int(ac.get("full_n", 1)), 1)
    for node_id_str, meta in ac["nodes"].items():
        obs = observed.get(node_id_str)
        est_ns = meta.get("est_ns")
        row = {"idx": meta["idx"], "label": meta["label"], "op_class": meta["op_class"],
               "n": n_full, "observed": obs is not None}
        if obs is not None:
            row["seconds"] = round(obs["seconds"], 6)
            row["bytes"] = obs["bytes"] if obs["bytes"] is not None \
                else (meta.get("est_bytes") or 0.0)
            if est_ns:
                # this node's measured sample-to-full ratio: the correction
                # the next sampled extrapolation applies
                row["ratio"] = round(obs["seconds"] * 1e9 / est_ns, 6)
            if not meta.get("leaf"):
                class_obs.setdefault(meta["op_class"], []).append(
                    (n_full, obs["seconds"], obs["bytes"]))
        else:
            # fused away or never pulled: carry the estimate forward so the
            # next run's plan still covers the node (no estimate: 0 s, a
            # node the greedy selection never picks, as when sampled)
            row["seconds"] = (est_ns or 0.0) / 1e9
            row["bytes"] = meta.get("est_bytes") or 0.0
        nodes_rec[str(meta["idx"])] = row
        node = node_at.get(meta["idx"])
        if node is not None:
            replan_input[node] = Profile(float(row["seconds"]) * 1e9, float(row["bytes"] or 0.0))

    for op_class, observations in class_obs.items():
        estimator.observe_nodes(op_class, observations)

    plan.store.update(f"plan/{ac['fp']}", lambda rec: {
        "version": PLAN_VERSION,
        "strategy": ac["strategy"],
        "budget": ac["budget"],
        "full_n": n_full,
        "source": ac["source"],
        "nodes": nodes_rec,
    })
    _replan_cache(plan, tracer, graph, replan_input)


def _replan_cache(plan: PendingPlan, tracer, graph, profiles) -> None:
    """Select the greedy cache plan again from observed costs and log how
    it differs from the plan that ran."""
    from ..workflow.autocache import AutoCacheRule

    ac = plan.autocache
    planned: Set = set(ac["selected"])
    if ac["strategy"] != "greedy" or not profiles:
        return
    evidence = AutoCacheRule("greedy", ac["budget"])._select_greedy(
        graph, profiles, float(ac["budget"]))
    added = sorted(graph.get_operator(n).label for n in evidence - planned)
    removed = sorted(graph.get_operator(n).label for n in planned - evidence)
    changed = bool(added or removed)
    with tracer.span("cost.replan", op_type="AutoCacheRule", plan_changed=changed,
                     added=",".join(added), removed=",".join(removed), nodes=len(profiles)):
        pass
    if changed:
        logger.info("cost re-plan: observed costs change the cache plan (+%s / -%s)",
                    added or "none", removed or "none")
    else:
        logger.info("cost re-plan: observed costs confirm the cache plan (%d nodes priced)",
                    len(profiles))


# ---------------------------------------------------------------------------
# Planning-side reads: evidence in, sampling out
# ---------------------------------------------------------------------------


def stored_solver_shape(store, fp: str, node_idx: int):
    """The shape observed for this pipeline's solver node by an earlier
    run, or None."""
    from .model import ShapeSignature

    if store is None:
        return None
    rec = store.load(f"solver/{fp}")
    if not rec or rec.get("version") != PLAN_VERSION:
        return None
    if int(rec.get("node_idx", -1)) != int(node_idx):
        return None
    return ShapeSignature.from_record(rec.get("shape") or {})


#: "the caller did not load the plan record" (None is a real miss)
_UNLOADED = object()


def load_plan_record(store, fp: str):
    """The raw ``plan/<fp>`` record or None, loaded once for both
    :func:`stored_profiles` and :func:`stored_calibration`."""
    return store.load(f"plan/{fp}") if store is not None else None


def stored_profiles(store, graph, full_n: int, fp: Optional[str] = None,
                    index: Optional[Dict] = None, rec=_UNLOADED):
    """Per-node Profiles of this graph from a persisted plan record, or
    None unless every current node is covered (labels checked). Seconds
    and bytes scale by the ratio of the current item count to the
    recorded one."""
    from ..workflow.autocache import Profile

    if store is None:
        return None
    fp = fp or graph_fingerprint(graph)
    if rec is _UNLOADED:
        rec = store.load(f"plan/{fp}")
    if not rec or rec.get("version") != PLAN_VERSION:
        return None
    nodes = rec.get("nodes") or {}
    if index is None:
        index = topo_node_index(graph)
    out = {}
    for node, idx in index.items():
        row = nodes.get(str(idx))
        if row is None:
            return None  # partial evidence: sample instead
        if row.get("label") != graph.get_operator(node).label:
            return None
        scale = float(max(full_n, 1)) / max(int(row.get("n", 1)), 1)
        out[node] = Profile(float(row.get("seconds", 0.0)) * 1e9 * scale,
                            float(row.get("bytes", 0.0) or 0.0) * scale)
    return out


def stored_calibration(store, graph, fp: Optional[str] = None,
                       index: Optional[Dict] = None, rec=_UNLOADED) -> Dict[object, float]:
    """Per-node observed/estimated seconds ratios from the last traced run
    of this pipeline: the measured correction of a fresh sampled
    extrapolation (empty without evidence)."""
    if store is None:
        return {}
    if rec is _UNLOADED:
        rec = store.load(f"plan/{fp or graph_fingerprint(graph)}")
    if not rec or rec.get("version") != PLAN_VERSION:
        return {}
    nodes = rec.get("nodes") or {}
    if index is None:
        index = topo_node_index(graph)
    out = {}
    for node, idx in index.items():
        row = nodes.get(str(idx))
        if not row:
            continue
        ratio = row.get("ratio")
        if isinstance(ratio, (int, float)) and ratio > 0:
            out[node] = float(ratio)
    return out
