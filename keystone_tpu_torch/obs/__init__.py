"""Pipeline tracing and per-node profiling (port of the core of
``keystone_tpu/obs/``).

A :class:`~keystone_tpu_torch.obs.tracer.Tracer` collects a span tree
across the graph executor's pulls, the auto-cache planner and the
cost-model chooser; ``export`` writes it as Chrome-trace JSON in the JAX
package's schema with a plain-text top-N summary, and ``audit`` joins the
planner's estimates with what each node was observed to cost.

Enable with ``KEYSTONE_TRACE=/path/trace.json`` (or the CLI's ``--trace
PATH``); off, every instrumentation point is one ``current() is None``
check.

Always on beside it: the flight recorder (``flight``, a bounded ring of
span summaries and instants, dumped atomically when asked) and the
device-memory watermark (``resource``), sampled at a scan's end and at a
served batch. ``context`` carries one request's trace identity
(:class:`TraceContext`, :class:`Sampler`) into the serving fleet's spans.
``export`` stitches the span sets of the cluster tier's processes into
one trace (:func:`stitch_chrome_trace`), and ``prom`` renders a metrics
snapshot as Prometheus text behind a scrape server.
"""

from . import flight, resource
from .audit import cache_audit, log_cache_audit, observed_by_node
from .context import Sampler, TraceContext, new_trace_id, sample_rate
from .export import (
    format_top_spans,
    stitch_chrome_trace,
    to_chrome_trace,
    wire_spans,
    write_chrome_trace,
    write_stitched_trace,
)
from .scan import SCAN_LANE_SPAN, SCAN_SPAN, record_scan_span
from .span import Span, cheap_nbytes, sync_value
from .tracer import (
    Tracer,
    current,
    export,
    install,
    install_if_absent,
    reset,
    start,
    stop,
    suspended,
    uninstall,
)

__all__ = [
    "SCAN_LANE_SPAN",
    "SCAN_SPAN",
    "Sampler",
    "Span",
    "TraceContext",
    "Tracer",
    "cache_audit",
    "cheap_nbytes",
    "current",
    "export",
    "flight",
    "format_top_spans",
    "install",
    "install_if_absent",
    "log_cache_audit",
    "new_trace_id",
    "observed_by_node",
    "record_scan_span",
    "reset",
    "resource",
    "sample_rate",
    "start",
    "stitch_chrome_trace",
    "stop",
    "suspended",
    "sync_value",
    "to_chrome_trace",
    "uninstall",
    "wire_spans",
    "write_chrome_trace",
    "write_stitched_trace",
]
