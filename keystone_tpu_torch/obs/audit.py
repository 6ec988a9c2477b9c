"""The cache planner's estimates against what the executor observed (port
of ``keystone_tpu/obs/audit.py``).

The auto-cache rule records its per-node estimated seconds and bytes in
the tracer (``AutoCacheRule.apply``), the solver chooser records its
predicted fit seconds, the executor's spans record what each node cost,
and :func:`cache_audit` joins the two: one row per estimated node with
estimate, observation and their ratio. A row with ``observed=False`` is a
finding itself: the node never ran under its planned identity (trace
fusion absorbed it, which voids its Cacher too), unless ``segment`` says
that a segment dispatch ran it inside one ``exec.segment`` span, which is
what segment dispatch is for.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from .tracer import Tracer

logger = logging.getLogger(__name__)


def observed_by_node(tracer: Tracer, start: int = 0) -> Dict[str, dict]:
    """Executor spans aggregated per DAG node id: observed exclusive
    seconds, the largest materialized bytes, computes and hits.

    Exclusive: evaluation is lazy, so a node's span contains the spans of
    the upstream thunks it forced; each span's direct children's time is
    subtracted first, as the planner's estimates are per node. ``start``
    keeps the spans recorded at index >= start (one fit's window of a
    long-lived tracer: NodeIds are small per-graph ints)."""
    spans = tracer.spans()[start:]
    child_seconds: Dict[int, float] = {}
    for sp in spans:
        if sp.parent_id is not None:
            child_seconds[sp.parent_id] = child_seconds.get(sp.parent_id, 0.0) + sp.seconds
    out: Dict[str, dict] = {}
    for sp in spans:
        if sp.node_id is None:
            continue
        row = out.setdefault(sp.node_id, {"label": sp.name, "seconds": 0.0, "bytes": None,
                                          "computes": 0, "hits": 0})
        if sp.cache == "hit":
            row["hits"] += 1
            continue
        row["seconds"] += max(sp.seconds - child_seconds.get(sp.span_id, 0.0), 0.0)
        row["computes"] += 1
        if sp.output_bytes is not None:
            row["bytes"] = max(row["bytes"] or 0, sp.output_bytes)
    return out


def segment_member_ids(tracer: Tracer, start: int = 0) -> set:
    """The node ids run inside a dispatched segment (each ``exec.segment``
    span carries its members' ``node_ids``): such nodes record no span of
    their own, by design."""
    out: set = set()
    for sp in tracer.spans()[start:]:
        if sp.name == "exec.segment":
            out.update(str(nid) for nid in sp.attrs.get("node_ids") or ())
    return out


def _ratio(observed: Optional[float], estimated: Optional[float]) -> Optional[float]:
    if observed is None or not estimated:
        return None
    return round(observed / estimated, 3)


def cache_audit(tracer: Optional[Tracer] = None) -> List[dict]:
    """One row per node a planner estimated: estimated against observed
    seconds and bytes, whether the node got a Cacher, and whether it was
    observed at all. Cacher rows first, then by estimated seconds."""
    if tracer is None:
        from . import tracer as tracer_mod

        tracer = tracer_mod.current()
    if tracer is None:
        return []
    observed = observed_by_node(tracer)
    in_segment = segment_member_ids(tracer)
    rows = []
    for node_id, est in tracer.estimates.items():
        obs = observed.get(node_id)
        obs_seconds = None if obs is None else obs["seconds"]
        obs_bytes = None if obs is None else obs["bytes"]
        row = {
            "node": node_id,
            "label": est["label"],
            "cacher": est["cacher"],
            # "node" rows come from the cache planner, "solver" rows from
            # the chooser (its estimate is the predicted fit time)
            "kind": est.get("kind", "node"),
            "est_seconds": est["est_seconds"],
            "obs_seconds": None if obs is None else round(obs_seconds, 4),
            "seconds_ratio": _ratio(obs_seconds, est["est_seconds"]),
            "est_bytes": est["est_bytes"],
            "obs_bytes": obs_bytes,
            "bytes_ratio": _ratio(obs_bytes, est["est_bytes"]),
            "cache_hits": 0 if obs is None else obs["hits"],
            "observed": obs is not None,
            # unobserved because a segment dispatch ran it: expected, not a
            # finding
            "segment": obs is None and node_id in in_segment,
        }
        if est.get("kind") == "solver":
            row["solver"] = est.get("solver")
            row["source"] = est.get("source")
            row["alternatives"] = est.get("alternatives")
            row["solver_est_seconds"] = est.get("solver_est_seconds")
            row["solver_seconds_ratio"] = _ratio(obs_seconds, est.get("solver_est_seconds"))
        rows.append(row)
    rows.sort(key=lambda r: (not r["cacher"], -(r["est_seconds"] or 0.0)))
    return rows


def log_cache_audit(tracer: Optional[Tracer] = None) -> List[dict]:
    """Log the audit at INFO, one line a row; returns the rows."""
    rows = cache_audit(tracer)
    if not rows:
        return rows
    logger.info("autocache audit: %d estimated node(s), %d Cacher-annotated",
                len(rows), sum(1 for r in rows if r["cacher"]))

    def fmt(v):
        return "?" if v is None else f"{v:.4g}"

    for r in rows:
        label = f"[solver:{r.get('source', '?')}] {r['label']}" if r["kind"] == "solver" \
            else r["label"]
        logger.info(
            "  node %-4s %-40s %s est %ss/%sB observed %ss/%sB (ratio t=%s mem=%s, hits=%d)%s",
            r["node"], label[:40], "[cached]" if r["cacher"] else "        ",
            fmt(r["est_seconds"]), fmt(r["est_bytes"]), fmt(r["obs_seconds"]),
            fmt(r["obs_bytes"]), fmt(r["seconds_ratio"]), fmt(r["bytes_ratio"]),
            r["cache_hits"],
            "" if r["observed"] else (
                " SUBSUMED BY SEGMENT (run inside a dispatched segment)" if r["segment"]
                else " NEVER OBSERVED (fused away or unexecuted)"),
        )
    return rows
