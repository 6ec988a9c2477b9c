"""Trace exporters: Chrome-trace JSON and a plain-text top-N summary (port
of ``keystone_tpu/obs/export.py``; the cross-process stitching comes with
the cluster tier).

The JSON form is the ``chrome://tracing`` / Perfetto "Trace Event Format"
in the JAX package's schema, so one viewer reads the traces of both: one
``"X"`` complete event per span (``ts`` and ``dur`` in microseconds from
the tracer's epoch), ``"i"`` instant events for cache hits, and ``"M"``
metadata events naming the process and its threads. Events are sorted by
``ts``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

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
    meta = [{"name": "process_name", "ph": "M", "ts": 0.0, "pid": pid, "tid": 0,
             "args": {"name": process_name or default_process_name()}}]
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
