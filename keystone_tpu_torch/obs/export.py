"""Trace exporters: Chrome-trace JSON, cross-process stitching and a
plain-text top-N summary (port of ``keystone_tpu/obs/export.py``).

The JSON form is the ``chrome://tracing`` / Perfetto "Trace Event Format"
in the JAX package's schema, so one viewer reads the traces of both: one
``"X"`` complete event per span (``ts`` and ``dur`` in microseconds from
the tracer's epoch), ``"i"`` instant events for cache hits, and ``"M"``
metadata events naming the process and its threads. Events are sorted by
``ts``.

Cross-process stitching (:func:`stitch_chrome_trace`): each process of the
cluster tier serializes its spans with :func:`wire_spans`, rebased onto
the unix clock the processes of a host share (perf_counter epochs are
process-local), and the router merges the span sets into one document
with a process track per pid. Events carry no raw span ids, and the
``trace_id`` attr that ties one request's hops together is namespaced by
the originating pid (``obs/context.py``), so nothing collides in the
merge.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .tracer import Tracer


def _json_safe(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


def _span_args(sp) -> dict:
    """One span's exported args (typed fields, then free-form attrs)."""
    args = {
        k: _json_safe(v)
        for k, v in (
            ("node", sp.node_id),
            ("op_type", sp.op_type),
            ("cache", sp.cache),
            ("sync_ms", round(sp.sync_seconds * 1e3, 3) or None),
            ("output_bytes", sp.output_bytes),
            ("compiles", sp.compiles or None),
        )
        if v is not None
    }
    args.update({k: _json_safe(v) for k, v in sp.attrs.items()})
    return args


def _process_meta(pid: int, process_name: Optional[str]) -> List[dict]:
    if not process_name:
        return []
    return [{"name": "process_name", "ph": "M", "ts": 0.0, "pid": pid, "tid": 0,
             "args": {"name": process_name}}]


def default_process_name() -> str:
    """``keystone:<argv0 basename>/<pid>``."""
    base = os.path.basename(sys.argv[0] or "python") or "python"
    return f"keystone:{base}/{os.getpid()}"


def to_chrome_trace(tracer: Tracer, process_name: Optional[str] = None) -> Dict[str, object]:
    """The trace as a Chrome-trace dict: ``{"traceEvents": [...], ...}``."""
    pid = os.getpid()
    events: List[dict] = []
    thread_names = {}
    for sp in tracer.spans():
        ev = {
            "name": sp.name,
            "cat": "keystone",
            "ph": "i" if sp.instant else "X",
            "ts": round((sp.start - tracer.epoch) * 1e6, 3),
            "pid": pid,
            "tid": sp.tid,
            "args": _span_args(sp),
        }
        if sp.instant:
            ev["s"] = "t"  # thread-scoped instant marker
        else:
            ev["dur"] = round(sp.seconds * 1e6, 3)
        events.append(ev)
        thread_names.setdefault(sp.tid, sp.thread_name)
    events.sort(key=lambda e: e["ts"])
    meta = _process_meta(pid, process_name or default_process_name())
    meta += [{"name": "thread_name", "ph": "M", "ts": 0.0, "pid": pid, "tid": tid,
              "args": {"name": name}} for tid, name in sorted(thread_names.items())]
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "keystone_tpu_torch.obs",
                      "epoch_unix_seconds": tracer.epoch_unix},
    }


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer), f)
    return path


# -- cross-process stitching --------------------------------------------------


def wire_spans(spans: Iterable, epoch: float, epoch_unix: float, pid: Optional[int] = None,
               process_name: Optional[str] = None) -> List[dict]:
    """Spans serialized to cross a process boundary: start times rebased
    from the process's perf_counter epoch onto the unix clock
    (``epoch_unix + (start - epoch)``), with the pid and thread identity
    the stitcher needs. Plain JSON-safe dicts."""
    pid = os.getpid() if pid is None else pid
    return [{
        "name": sp.name,
        "start_unix": epoch_unix + (sp.start - epoch),
        "dur_s": sp.seconds,
        "instant": bool(sp.instant),
        "pid": pid,
        "tid": sp.tid,
        "thread_name": sp.thread_name,
        "process_name": process_name,
        "args": _span_args(sp),
    } for sp in spans]


def stitch_chrome_trace(span_sets: Sequence[List[dict]],
                        base_unix: Optional[float] = None) -> Dict[str, object]:
    """N processes' :func:`wire_spans` merged into one Chrome-trace document
    with a process track per pid. ``ts`` is rebased to ``base_unix``
    (default: the earliest span), so the timeline starts near 0; each pid
    contributes its own ``process_name`` and ``thread_name`` metadata."""
    all_spans = [s for spans in span_sets for s in spans]
    if base_unix is None:
        base_unix = min((s["start_unix"] for s in all_spans), default=0.0)
    events: List[dict] = []
    proc_names: Dict[int, str] = {}
    thread_names: Dict[Tuple[int, int], str] = {}
    for s in all_spans:
        pid = int(s.get("pid") or 0)
        ev = {
            "name": s["name"],
            "cat": "keystone",
            "ph": "i" if s.get("instant") else "X",
            "ts": round((s["start_unix"] - base_unix) * 1e6, 3),
            "pid": pid,
            "tid": s.get("tid", 0),
            "args": dict(s.get("args") or {}),
        }
        if s.get("instant"):
            ev["s"] = "t"
        else:
            ev["dur"] = round(float(s.get("dur_s") or 0.0) * 1e6, 3)
        events.append(ev)
        if s.get("process_name"):
            proc_names.setdefault(pid, str(s["process_name"]))
        if s.get("thread_name"):
            thread_names.setdefault((pid, s.get("tid", 0)), str(s["thread_name"]))
    events.sort(key=lambda e: e["ts"])
    meta: List[dict] = []
    for pid, name in sorted(proc_names.items()):
        meta.extend(_process_meta(pid, name))
    meta.extend({"name": "thread_name", "ph": "M", "ts": 0.0, "pid": pid, "tid": tid,
                 "args": {"name": name}} for (pid, tid), name in sorted(thread_names.items()))
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "keystone_tpu_torch.obs (stitched)",
                      "epoch_unix_seconds": base_unix,
                      "processes": sorted(proc_names.values())},
    }


def write_stitched_trace(span_sets: Sequence[List[dict]], path: str) -> str:
    with open(path, "w") as f:
        json.dump(stitch_chrome_trace(span_sets), f)
    return path


def format_top_spans(tracer: Tracer, n: int = 10, prefix: Optional[str] = None) -> str:
    """The top ``n`` span names by total seconds, as plain text."""
    rows = sorted(tracer.span_summary(prefix=prefix).items(),
                  key=lambda kv: kv[1]["seconds"], reverse=True)[:n]
    if not rows:
        return "(no spans)"
    width = min(max(len(name) for name, _ in rows), 64)
    lines = [f"{'span':<{width}} {'seconds':>9} {'calls':>6} {'sync_s':>8} "
             f"{'hits':>5} {'MB':>9} {'compiles':>8}"]
    for name, row in rows:
        mb = (row["bytes"] or 0) / 2**20
        lines.append(
            f"{name[:width]:<{width}} {row['seconds']:>9.4f} {row['calls']:>6} "
            f"{row['sync_seconds']:>8.4f} {row['cache_hits']:>5} {mb:>9.2f} "
            f"{row['compiles']:>8}"
        )
    return "\n".join(lines)
