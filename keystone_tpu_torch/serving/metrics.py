"""Serving metrics: counters, gauges, latency quantiles, the cost table,
the timeline and the phase export (port of
``keystone_tpu/serving/metrics.py``).

A process-local registry, thread-safe (the engine's worker and any number
of submitter threads write to it). ``snapshot()`` is the programmatic read
the tests and the demo use; ``maybe_log`` writes a rate-limited one-line
INFO summary through the logging ``utils.obs.configure`` levels.

Phase totals from ``utils.timing`` ride every snapshot under ``"phases"``:
the engine wraps each batch in ``timing.phase("serve.batch")``. Tracer
spans (``keystone_tpu_torch.obs``) land under ``"spans"`` in the same
``{name: {"seconds", "calls", ...}}`` schema; the engine's span is
``serve.microbatch``, apart from the phase's ``serve.batch``, so an export
can join the two tables without a collision.

``observe_batch(..., replica=i)`` attributes occupancy to one worker,
``observe_queue_age`` keeps time-queued quantiles apart from end-to-end
latency (p99 queue age grows before p99 latency does), ``merge`` folds
snapshots of several processes into one, and the cost table and the
timeline keep per-tenant spend and windowed counter deltas.
"""

from __future__ import annotations

import logging
import math
import threading
from collections import defaultdict, deque
from typing import Callable, Dict, Optional, Sequence

from ..utils import timing
from ..utils.obs import every

logger = logging.getLogger(__name__)

#: quantiles reported by :meth:`MetricsRegistry.latency_quantiles`
_QUANTILES = (0.50, 0.95, 0.99)

#: how a gauge folds across process snapshots in :meth:`MetricsRegistry.merge`
#: — additive quantities sum (queue depth, live bytes across distinct
#: devices), watermarks take the max (peak memory), ratios average
#: (utilization fractions: summing two 0.9s into 1.8 is fiction)
GAUGE_MERGE_MODES = ("sum", "max", "mean")

#: per-(tenant, priority) accumulator columns, in storage order
_COST_FIELDS = ("device_s", "queue_s", "payload_bytes", "items")


class MetricsRegistry:
    """Thread-safe counters + gauges + a bounded latency reservoir."""

    def __init__(
        self,
        name: str = "serving",
        latency_window: int = 4096,
        timeline_window: int = 256,
    ):
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._gauge_modes: Dict[str, str] = {}
        # (tenant, priority) -> [device_s, queue_s, payload_bytes, items]:
        # the per-identity cost table every replica batch is split into
        self._costs: Dict[tuple, list] = {}
        # device_s/items cursor per tenant for timeline cost deltas
        self._costs_prev: Dict[str, list] = {}
        self._latencies: deque = deque(maxlen=latency_window)
        self._queue_ages: deque = deque(maxlen=latency_window)
        # priority class -> bounded reservoir: the per-class latency the
        # QoS gates assert (high's p99 in budget while low absorbs shed)
        self._priority_latencies: Dict[str, deque] = {}
        self._latency_window = latency_window
        self._batch_items = 0
        self._batch_capacity = 0
        # replica index -> [items, capacity, batches]: per-replica
        # occupancy for the fleet (one registry, N replica workers)
        self._replica_batches: Dict[int, list] = {}
        #: the bounded metrics timeline: one row per sample_timeline()
        #: call (the health/periodic loops drive the cadence) — the
        #: queue-age-over-time view a point-in-time snapshot cannot give
        self._timeline: deque = deque(maxlen=timeline_window)
        self._timeline_prev: Dict[str, int] = {}

    # -- writes ---------------------------------------------------------

    def inc(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._counters[counter] += n

    def set_gauge(
        self, name: str, read: Callable[[], float], merge: str = "sum"
    ) -> None:
        """Register a live-value gauge (e.g. queue depth); ``read`` is
        called at snapshot time. ``merge`` declares how the gauge folds
        across process snapshots (see :data:`GAUGE_MERGE_MODES`): additive
        quantities ``sum``, watermarks ``max``, ratios ``mean``."""
        if merge not in GAUGE_MERGE_MODES:
            raise ValueError(
                f"gauge merge mode {merge!r} not in {GAUGE_MERGE_MODES}"
            )
        with self._lock:
            self._gauges[name] = read
            self._gauge_modes[name] = merge

    def observe_cost(
        self,
        tenant: str,
        priority: str = "normal",
        device_s: float = 0.0,
        queue_s: float = 0.0,
        payload_bytes: int = 0,
        items: int = 0,
    ) -> None:
        """Charge one batch share to a (tenant, priority) identity:
        attributed device-seconds, queue-seconds waited before dispatch,
        and payload bytes carried. Accumulates the per-tenant cost table
        that ``snapshot()["costs"]`` exposes, :meth:`merge` folds
        fleet-wide, and :meth:`sample_timeline` emits as windowed
        ``device_s`` deltas for per-tenant spend budgeting."""
        with self._lock:
            row = self._costs.setdefault(
                (str(tenant), str(priority)), [0.0, 0.0, 0, 0]
            )
            row[0] += float(device_s)
            row[1] += float(queue_s)
            row[2] += int(payload_bytes)
            row[3] += int(items)

    def observe_latency(
        self, seconds: float, priority: Optional[str] = None
    ) -> None:
        """One end-to-end request latency; ``priority`` additionally
        files it under that QoS class's own reservoir so per-priority
        quantiles survive (aggregate p99 hides a starved class)."""
        with self._lock:
            self._latencies.append(seconds)
            if priority is not None:
                res = self._priority_latencies.get(priority)
                if res is None:
                    res = self._priority_latencies[priority] = deque(
                        maxlen=self._latency_window
                    )
                res.append(seconds)

    def observe_queue_age(self, seconds: float) -> None:
        """Time one request spent queued before its batch dispatched —
        the queueing-delay component of latency. p99 queue age is the
        fleet's early-warning signal: it grows before end-to-end p99
        does, because it excludes compute."""
        with self._lock:
            self._queue_ages.append(seconds)

    def observe_batch(
        self, items: int, capacity: int, replica: Optional[int] = None
    ) -> None:
        """One executed micro-batch: ``items`` real rows in a
        ``capacity``-row bucket. The running ratio is batch occupancy —
        how much of each compiled program's work is real traffic vs
        padding. ``replica`` additionally attributes the batch to one
        fleet worker so per-replica occupancy (and a stalled or starved
        replica) is visible in the snapshot."""
        with self._lock:
            self._counters["batches"] += 1
            self._batch_items += items
            self._batch_capacity += capacity
            if replica is not None:
                row = self._replica_batches.setdefault(replica, [0, 0, 0])
                row[0] += items
                row[1] += capacity
                row[2] += 1

    # -- reads ----------------------------------------------------------

    def count(self, counter: str) -> int:
        with self._lock:
            return self._counters[counter]

    def cost_table(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """The cumulative cost table as ``{tenant: {priority: {device_s,
        queue_s, payload_bytes, items}}}`` (seconds rounded to µs)."""
        with self._lock:
            rows = {key: list(row) for key, row in self._costs.items()}
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for (tenant, priority), row in sorted(rows.items()):
            out.setdefault(tenant, {})[priority] = {
                "device_s": round(row[0], 6),
                "queue_s": round(row[1], 6),
                "payload_bytes": int(row[2]),
                "items": int(row[3]),
            }
        return out

    def latency_quantiles(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._latencies)
        return self._quantiles(lat)

    def queue_age_quantiles(self) -> Dict[str, float]:
        """p50/p95/p99 of time-spent-queued, same schema as latency."""
        with self._lock:
            ages = sorted(self._queue_ages)
        return self._quantiles(ages)

    def priority_latency_quantiles(self) -> Dict[str, Dict[str, float]]:
        """Per-priority-class latency quantiles, one row per class that
        has observed traffic (same schema per row as ``latency``)."""
        with self._lock:
            per = {
                p: sorted(res) for p, res in self._priority_latencies.items()
            }
        return {p: self._quantiles(vals) for p, vals in sorted(per.items())}

    @staticmethod
    def _quantiles(vals: list) -> Dict[str, float]:
        out: Dict[str, float] = {"count": len(vals)}
        if not vals:
            return out
        out["mean"] = sum(vals) / len(vals)
        for q in _QUANTILES:
            # nearest-rank: ceil(q*n)-1, clamped (int(q*n) alone is biased
            # one rank high — p99 of a full window would report the max)
            idx = min(len(vals) - 1, max(0, math.ceil(q * len(vals)) - 1))
            out[f"p{int(q * 100)}"] = vals[idx]
        return out

    # -- the timeline ---------------------------------------------------

    def sample_timeline(self, now: Optional[float] = None) -> Dict[str, object]:
        """Append one ``(ts, counter deltas, gauges, quantiles,
        occupancy)`` row to the bounded timeline ring and return it.

        Counters land as DELTAS since the previous sample (a timeline of
        cumulative totals only ever goes up and hides the burst), so a
        row reads as "what happened in this window"; quantiles are the
        reservoir's current view. Callers drive the cadence — the
        cluster router's health loop, the worker's ping handler — so one
        registry never pays two samplers."""
        import time as _time

        ts = _time.time() if now is None else float(now)
        with self._lock:
            counters = dict(self._counters)
            gauges = list(self._gauges.items())
            items, capacity = self._batch_items, self._batch_capacity
            prev = self._timeline_prev
            deltas = {
                k: v - prev.get(k, 0)
                for k, v in counters.items()
                if v - prev.get(k, 0)
            }
            self._timeline_prev = counters
            # per-tenant spend THIS window (device_s/items deltas summed
            # across priorities) — what SloPolicy's tenant budget judges
            tenant_totals: Dict[str, list] = {}
            for (tenant, _prio), row in self._costs.items():
                slot = tenant_totals.setdefault(tenant, [0.0, 0])
                slot[0] += row[0]
                slot[1] += row[3]
            cost_deltas = {}
            for tenant, (dev, n) in tenant_totals.items():
                pdev, pn = self._costs_prev.get(tenant, (0.0, 0))
                if dev - pdev > 1e-9 or n - pn:
                    cost_deltas[tenant] = {
                        "device_s": round(dev - pdev, 6),
                        "items": n - pn,
                    }
            self._costs_prev = {
                t: list(v) for t, v in tenant_totals.items()
            }
        gauge_vals = {}
        for k, read in gauges:
            try:
                v = read()
            except Exception:
                logger.debug("timeline gauge %s failed", k, exc_info=True)
                continue
            if isinstance(v, (int, float)):
                gauge_vals[k] = round(float(v), 6)
        row: Dict[str, object] = {
            "ts": ts,
            "counters": deltas,
            "gauges": gauge_vals,
            "latency": self.latency_quantiles(),
            "queue_age": self.queue_age_quantiles(),
            "occupancy": (items / capacity) if capacity else None,
        }
        if cost_deltas:
            row["costs"] = cost_deltas
        with self._lock:
            self._timeline.append(row)
        return row

    def timeline(self) -> list:
        """The bounded sample rows, oldest first."""
        with self._lock:
            return [dict(r) for r in self._timeline]

    def snapshot(self, sketches: bool = False) -> Dict[str, object]:
        """Everything at once: counters, evaluated gauges, occupancy,
        latency quantiles, and the process phase-timing table.

        ``sketches=True`` additionally includes the raw bounded latency /
        queue-age reservoirs under ``"sketch"`` — the mergeable form a
        worker process ships to the cluster router so :meth:`merge` can
        recompute exact fleet-wide quantiles instead of averaging
        per-process percentiles (which is statistically meaningless)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = list(self._gauges.items())
            gauge_modes = dict(self._gauge_modes)
            items, capacity = self._batch_items, self._batch_capacity
            replicas = {
                idx: list(row) for idx, row in self._replica_batches.items()
            }
            sketch = (
                {
                    "latencies": [float(x) for x in self._latencies],
                    "queue_ages": [float(x) for x in self._queue_ages],
                    "priority_latencies": {
                        p: [float(x) for x in res]
                        for p, res in self._priority_latencies.items()
                    },
                }
                if sketches
                else None
            )
        snap: Dict[str, object] = {
            "name": self.name,
            "counters": counters,
            "gauges": {k: read() for k, read in gauges},
            "gauge_modes": gauge_modes,
            "costs": self.cost_table(),
            "batch_occupancy": {
                "items": items,
                "capacity": capacity,
                "ratio": (items / capacity) if capacity else None,
            },
            "replicas": {
                str(idx): {
                    "items": row[0],
                    "capacity": row[1],
                    "batches": row[2],
                    "occupancy": (row[0] / row[1]) if row[1] else None,
                }
                for idx, row in sorted(replicas.items())
            },
            "latency": self.latency_quantiles(),
            "queue_age": self.queue_age_quantiles(),
            "priority_latency": self.priority_latency_quantiles(),
            "phases": timing.snapshot(prefix="serve."),
            "spans": self._span_summary(),
            # the bounded timeline rides every snapshot (cheap: <=
            # timeline_window small dicts) so a worker's rows cross the
            # wire with its stats reply and survive the merge intact
            "timeline": self.timeline(),
        }
        if sketch is not None:
            snap["sketch"] = sketch
        return snap

    @staticmethod
    def merge(
        snapshots: "Sequence[Dict[str, object]]", name: str = "merged"
    ) -> Dict[str, object]:
        """Aggregate N process/worker snapshots into ONE snapshot-shaped
        view: counters and occupancy summed, numeric gauges summed,
        per-replica rows namespaced ``<snapshot-name>/<replica>``, and
        latency / queue-age quantiles recomputed from the merged raw
        sketches (take the inputs with ``snapshot(sketches=True)``).
        Phase/span tables fold per key (seconds and calls summed).

        A snapshot without a sketch still contributes its counters and
        occupancy; its latency reservoir simply cannot participate in
        the merged quantiles (the merged ``count`` reflects only
        sketch-bearing inputs — exact over what was shipped, never a
        made-up percentile). This is what the cluster router's periodic
        INFO line and ``snapshot()`` report: fleet-wide shed / queue-age
        / occupancy, not per-process shards."""
        counters: Dict[str, int] = defaultdict(int)
        # gauge name -> list of observed values; folded per declared mode
        gauge_vals: Dict[str, list] = defaultdict(list)
        gauge_modes: Dict[str, str] = {}
        costs: Dict[tuple, list] = {}
        items = capacity = 0
        replicas: Dict[str, object] = {}
        lats: list = []
        ages: list = []
        prio_lats: Dict[str, list] = defaultdict(list)
        phases: Dict[str, Dict[str, float]] = {}
        spans: Dict[str, Dict[str, float]] = {}
        timelines: Dict[str, list] = {}

        def _fold_table(dst, src):
            for key, row in (src or {}).items():
                if not isinstance(row, dict):
                    continue
                slot = dst.setdefault(key, defaultdict(float))
                for k, v in row.items():
                    if isinstance(v, (int, float)):
                        slot[k] += v

        for i, snap in enumerate(snapshots):
            if not snap:
                continue
            label = str(snap.get("name") or i)
            for k, v in (snap.get("counters") or {}).items():
                counters[k] += int(v)
            modes = snap.get("gauge_modes") or {}
            for k, v in (snap.get("gauges") or {}).items():
                if isinstance(v, (int, float)):
                    gauge_vals[k].append(float(v))
                    # first declared mode wins; undeclared gauges sum
                    # (the historical behavior — correct for depths)
                    gauge_modes.setdefault(k, modes.get(k, "sum"))
            for tenant, prios in (snap.get("costs") or {}).items():
                for priority, row in prios.items():
                    slot = costs.setdefault(
                        (str(tenant), str(priority)), [0.0, 0.0, 0, 0]
                    )
                    slot[0] += float(row.get("device_s") or 0.0)
                    slot[1] += float(row.get("queue_s") or 0.0)
                    slot[2] += int(row.get("payload_bytes") or 0)
                    slot[3] += int(row.get("items") or 0)
            occ = snap.get("batch_occupancy") or {}
            items += int(occ.get("items") or 0)
            capacity += int(occ.get("capacity") or 0)
            for idx, row in (snap.get("replicas") or {}).items():
                replicas[f"{label}/{idx}"] = dict(row)
            sketch = snap.get("sketch") or {}
            lats.extend(sketch.get("latencies") or [])
            ages.extend(sketch.get("queue_ages") or [])
            for p, vals in (sketch.get("priority_latencies") or {}).items():
                prio_lats[p].extend(vals)
            _fold_table(phases, snap.get("phases"))
            _fold_table(spans, snap.get("spans"))
            # timelines stay PER-PROCESS, never blended: each row is one
            # process's windowed view, and summing two processes' p99
            # columns (or interleaving their delta rows) would fabricate
            # a timeline no process ever observed
            rows = snap.get("timeline")
            if rows:
                timelines[label] = [dict(r) for r in rows]
        gauges: Dict[str, float] = {}
        for k, vals in gauge_vals.items():
            mode = gauge_modes.get(k, "sum")
            if mode == "max":
                gauges[k] = max(vals)
            elif mode == "mean":
                gauges[k] = sum(vals) / len(vals)
            else:
                gauges[k] = sum(vals)
        merged_costs: Dict[str, Dict[str, Dict[str, float]]] = {}
        for (tenant, priority), row in sorted(costs.items()):
            merged_costs.setdefault(tenant, {})[priority] = {
                "device_s": round(row[0], 6),
                "queue_s": round(row[1], 6),
                "payload_bytes": int(row[2]),
                "items": int(row[3]),
            }
        return {
            "name": name,
            "merged_from": len(list(snapshots)),
            "counters": dict(counters),
            "gauges": gauges,
            "gauge_modes": gauge_modes,
            "costs": merged_costs,
            "batch_occupancy": {
                "items": items,
                "capacity": capacity,
                "ratio": (items / capacity) if capacity else None,
            },
            "replicas": replicas,
            "latency": MetricsRegistry._quantiles(sorted(lats)),
            "queue_age": MetricsRegistry._quantiles(sorted(ages)),
            "priority_latency": {
                p: MetricsRegistry._quantiles(sorted(vals))
                for p, vals in sorted(prio_lats.items())
            },
            "phases": {k: dict(v) for k, v in phases.items()},
            "spans": {k: dict(v) for k, v in spans.items()},
            "timelines": timelines,
        }

    @staticmethod
    def _span_summary() -> Dict[str, object]:
        """Serving spans from the installed tracer, ``{}`` when tracing is
        off — same shape as ``"phases"`` (see module docstring). Like
        ``"phases"``, this is PROCESS scope (the tracer registry is one
        per process): with several engines live, it aggregates all of
        them, whereas ``"counters"``/``"latency"`` are per-engine."""
        from ..obs.tracer import current

        tracer = current()
        if tracer is None:
            return {}
        return tracer.span_summary(prefix="serve.")

    # -- periodic logging ----------------------------------------------

    def maybe_log(self, interval_s: float = 10.0) -> bool:
        """Log a one-line INFO summary, at most once per ``interval_s``
        per registry instance (two engines with the same registry name
        must not suppress each other's summaries). Returns True when it
        logged."""
        if not every(f"metrics:{self.name}:{id(self)}", interval_s):
            return False
        snap = self.snapshot()
        lat = snap["latency"]
        age = snap["queue_age"]
        occ = snap["batch_occupancy"]["ratio"]
        c = snap["counters"]
        canary = (
            f"{c.get('canary_pass', 0)}pass/{c.get('canary_fail', 0)}fail"
            if c.get("canary_pass") or c.get("canary_fail")
            else None
        )
        logger.info(
            "%s: counters=%s queue=%s occupancy=%s shed=%s canary=%s "
            "p50=%s p99=%s queue_age_p99=%s",
            self.name,
            c,
            snap["gauges"].get("queue_depth"),
            None if occ is None else round(occ, 3),
            c.get("shed", 0),
            canary,
            round(lat["p50"], 4) if "p50" in lat else None,
            round(lat["p99"], 4) if "p99" in lat else None,
            round(age["p99"], 4) if "p99" in age else None,
        )
        return True
