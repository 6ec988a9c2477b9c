"""Prometheus text exposition over a metrics snapshot, and a scrape server
(port of ``keystone_tpu/obs/prom.py``; the text is byte-equal to the JAX
package's for one snapshot).

:func:`render_prometheus` turns one ``MetricsRegistry`` snapshot (one
process's, or the cluster router's merged fleet view) into text exposition
format 0.0.4: counters become ``<prefix>_<name>_total`` counter families;
dotted per-identity counters (``tenant.served.<t>``,
``slo_breach.<objective>``, ``shed.<priority>``, ``wire.frames.<kind>``,
``wire.bytes_sent.<kind>``) become one family each with the identity as a
label; the per-tenant cost table becomes four labelled counter families
(device seconds, queue seconds, payload bytes, items); gauges render with
their live values; the latency and queue-age reservoirs render as
summaries with ``quantile`` labels, ``_count`` and ``_sum``.

:class:`PrometheusExporter` is the scrape plane: one stdlib
``ThreadingHTTPServer`` (daemon threads, bound to the loopback by default)
serving ``GET /metrics`` from a snapshot callback. The router hangs it off
its merged snapshot, so a scrape costs one stats round trip and never
touches the request path. Enable it on ``ClusterRouter`` with
``metrics_port=`` or ``KEYSTONE_METRICS_PORT`` (0 binds an ephemeral
port).
"""

from __future__ import annotations

import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: scrape content type for text exposition format 0.0.4
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: the counter families of the serving and cluster tiers (a trailing ``.``
#: marks a dotted per-identity family); the JAX package's list, kept equal
KNOWN_COUNTERS = (
    "submitted",
    "completed",
    "rejected",
    "expired",
    "cancelled",
    "invalid",
    "shed",
    "shed.",
    "batches",
    "batch_errors",
    "batch_retries",
    "batch_transient",
    "requeues",
    "steals",
    "restarts",
    "quarantined",
    "compiles",
    "aot_loads",
    "slo_breaches",
    "slo_breach.",
    "tenant.served.",
    "scale_ups",
    "scale_downs",
    "scale_aborts",
    "worker_errors",
    "swaps",
    "rollbacks",
    "canary_pass",
    "canary_fail",
    "trainer_restarts",
    "trainer_crashes",
    "wire.frames.",
    "wire.bytes_sent.",
    "coalesce.frames",
    "coalesce.members",
    "shm.payloads",
    "shm.bytes",
    "shm.fallback",
)

_HELP = {
    "submitted": "requests admitted by a serving front door",
    "completed": "requests answered",
    "shed": "requests refused by deadline/queue admission",
    "batches": "compiled micro-batches executed",
    "restarts": "supervised replica/worker restarts",
    "slo_breaches": "SLO objectives breached across all policies",
    "compiles": "cold pipeline traces paid",
    "aot_loads": "warm executable loads from the AOT cache",
    "coalesce.frames": "coalesced multi-member wire frames sent",
    "coalesce.members": "requests that rode a coalesced frame",
    "shm.payloads": "wire payloads moved through shared-memory slots",
    "shm.bytes": "payload bytes moved through shared-memory slots",
    "shm.fallback": "payloads degraded inline (ring full/too large)",
}

#: dotted counter prefix -> (family suffix, label name)
_LABELED_FAMILIES = (
    ("tenant.served.", "tenant_served", "tenant"),
    ("slo_breach.", "slo_breach", "objective"),
    ("shed.", "shed_by_priority", "priority"),
    ("wire.frames.", "wire_frames", "kind"),
    ("wire.bytes_sent.", "wire_bytes_sent", "kind"),
)

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Fold an internal metric name onto the Prometheus charset
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (dots and dashes become ``_``; a
    leading digit gains a ``_`` prefix)."""
    out = _NAME_BAD_CHARS.sub("_", str(name))
    if not out or not _NAME_OK.match(out):
        out = "_" + out
    return out


def escape_label_value(value: object) -> str:
    """Escape per exposition rules: backslash, double-quote, newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(value: float) -> str:
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Family:
    """One metric family: a # TYPE line plus its sample lines."""

    def __init__(self, name: str, kind: str, help_text: Optional[str] = None):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.samples: List[str] = []

    def add(
        self,
        value: float,
        labels: Optional[Dict[str, object]] = None,
        suffix: str = "",
    ) -> None:
        label_str = ""
        if labels:
            parts = ",".join(
                f'{sanitize_metric_name(k)}="{escape_label_value(v)}"'
                for k, v in labels.items()
            )
            label_str = "{" + parts + "}"
        self.samples.append(f"{self.name}{suffix}{label_str} {_fmt(value)}")

    def render(self) -> List[str]:
        if not self.samples:
            return []
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        out.extend(self.samples)
        return out


def _counter_family(
    families: Dict[str, _Family], prefix: str, raw_name: str
) -> Tuple[_Family, Optional[Dict[str, object]]]:
    """Resolve one internal counter name to (family, labels)."""
    for dot_prefix, suffix, label in _LABELED_FAMILIES:
        if raw_name.startswith(dot_prefix) and len(raw_name) > len(dot_prefix):
            fam_name = f"{prefix}_{suffix}_total"
            fam = families.get(fam_name)
            if fam is None:
                fam = families[fam_name] = _Family(fam_name, "counter")
            return fam, {label: raw_name[len(dot_prefix):]}
    fam_name = f"{prefix}_{sanitize_metric_name(raw_name)}_total"
    fam = families.get(fam_name)
    if fam is None:
        fam = families[fam_name] = _Family(
            fam_name, "counter", _HELP.get(raw_name)
        )
    return fam, None


def _summary(
    prefix: str, name: str, quantiles: Dict[str, float],
    labels: Optional[Dict[str, object]] = None,
) -> _Family:
    fam = _Family(f"{prefix}_{name}", "summary")
    count = int(quantiles.get("count") or 0)
    for key, q in (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99")):
        if key in quantiles:
            fam.add(quantiles[key], dict(labels or {}, quantile=q))
    fam.add(count, labels, suffix="_count")
    mean = quantiles.get("mean")
    if mean is not None:
        fam.add(float(mean) * count, labels, suffix="_sum")
    return fam


def render_prometheus(snapshot: Dict[str, object], prefix: str = "keystone") -> str:
    """Render one snapshot (plain or merged) as exposition text."""
    prefix = sanitize_metric_name(prefix)
    families: Dict[str, _Family] = {}
    lines: List[str] = []

    for raw_name in sorted(snapshot.get("counters") or {}):
        value = snapshot["counters"][raw_name]
        if not isinstance(value, (int, float)):
            continue
        fam, labels = _counter_family(families, prefix, raw_name)
        fam.add(value, labels)

    for tenant, prios in sorted((snapshot.get("costs") or {}).items()):
        for priority, row in sorted(prios.items()):
            labels = {"tenant": tenant, "priority": priority}
            for field, suffix in (
                ("device_s", "tenant_device_seconds"),
                ("queue_s", "tenant_queue_seconds"),
                ("payload_bytes", "tenant_payload_bytes"),
                ("items", "tenant_items"),
            ):
                fam_name = f"{prefix}_{suffix}_total"
                fam = families.get(fam_name)
                if fam is None:
                    fam = families[fam_name] = _Family(fam_name, "counter")
                fam.add(float(row.get(field) or 0.0), labels)

    for raw_name in sorted(snapshot.get("gauges") or {}):
        value = snapshot["gauges"][raw_name]
        if not isinstance(value, (int, float)):
            continue
        fam_name = f"{prefix}_{sanitize_metric_name(raw_name)}"
        fam = families.setdefault(fam_name, _Family(fam_name, "gauge"))
        fam.add(value)

    occ = (snapshot.get("batch_occupancy") or {}).get("ratio")
    if isinstance(occ, (int, float)):
        fam_name = f"{prefix}_batch_occupancy_ratio"
        fam = families.setdefault(fam_name, _Family(fam_name, "gauge"))
        fam.add(occ)

    wm = snapshot.get("merged_from")
    if isinstance(wm, int):
        fam_name = f"{prefix}_merged_processes"
        fam = families.setdefault(fam_name, _Family(fam_name, "gauge"))
        fam.add(wm)

    for fam in families.values():
        lines.extend(fam.render())
    lat = snapshot.get("latency") or {}
    if lat.get("count"):
        lines.extend(_summary(prefix, "latency_seconds", lat).render())
    age = snapshot.get("queue_age") or {}
    if age.get("count"):
        lines.extend(_summary(prefix, "queue_age_seconds", age).render())
    prio = snapshot.get("priority_latency") or {}
    prio_fam = _Family(f"{prefix}_priority_latency_seconds", "summary")
    for pclass, quantiles in sorted(prio.items()):
        if not quantiles.get("count"):
            continue
        sub = _summary(
            prefix, "priority_latency_seconds", quantiles,
            labels={"priority": pclass},
        )
        prio_fam.samples.extend(sub.samples)
    lines.extend(prio_fam.render())
    return "\n".join(lines) + "\n"


class PrometheusExporter:
    """Bounded stdlib scrape server: ``GET /metrics`` renders the
    snapshot callback. Daemon threads, loopback by default, stopped with
    :meth:`stop` (the router's shutdown path)."""

    def __init__(
        self,
        snapshot_fn: Callable[[], Dict[str, object]],
        host: str = "127.0.0.1",
        port: int = 0,
        prefix: str = "keystone",
    ):
        self._snapshot_fn = snapshot_fn
        self._host = host
        self._port = int(port)
        self._prefix = prefix
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        if self._server is None:
            return None
        return self._server.server_address[:2]

    def start(self) -> Tuple[str, int]:
        if self._server is not None:
            return self.address
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib handler API)
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = render_prometheus(
                        exporter._snapshot_fn(), prefix=exporter._prefix
                    ).encode("utf-8")
                except Exception:
                    logger.warning("scrape render failed", exc_info=True)
                    self.send_error(500, "snapshot failed")
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                logger.debug("scrape: " + fmt, *args)

        server = ThreadingHTTPServer((self._host, self._port), _Handler)
        server.daemon_threads = True
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="keystone-metrics-http",
            daemon=True,
        )
        self._thread.start()
        logger.info(
            "metrics exposition on http://%s:%d/metrics", *self.address
        )
        return self.address

    def stop(self) -> None:
        server, thread = self._server, self._thread
        self._server = self._thread = None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)


__all__ = [
    "CONTENT_TYPE",
    "KNOWN_COUNTERS",
    "PrometheusExporter",
    "escape_label_value",
    "render_prometheus",
    "sanitize_metric_name",
]
