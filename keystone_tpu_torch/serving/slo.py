"""Declarative SLO policy over the metrics timeline (port of
``keystone_tpu/serving/slo.py``).

``MetricsRegistry.sample_timeline`` turns the registry's snapshot into
rows of windowed evidence; this module judges them. A :class:`SloPolicy`
names the budgets (p99 against a deadline budget, shed rate, restart burn,
trainer staleness and drift, a tenant's device-seconds, the device-memory
watermark), :meth:`SloPolicy.evaluate` prices one row against them, and
the :class:`SloWatchdog` evaluates each sample, sending every violation,
a typed :class:`SloBreach`, to

* the **flight recorder** (``slo.breach`` instants),
* the **trace** (when a tracer is installed),
* the **metrics** (an ``slo_breaches`` counter and one
  ``slo_breach.<objective>`` counter an objective), and
* a rate-limited WARNING log.

Every budget is optional: an unset objective is not judged.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..obs import flight
from ..obs.tracer import current as _trace_current
from ..utils.obs import every

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class SloBreach:
    """One objective violated by one timeline row."""

    objective: str  # the policy's field name, e.g. "p99_budget_s"
    observed: float
    budget: float
    ts: float
    #: whom the breach is charged to (the overspending tenant of
    #: ``tenant_device_s_budget``); "" for a fleet-wide one
    detail: str = ""

    def as_attrs(self) -> Dict[str, object]:
        attrs: Dict[str, object] = {"objective": self.objective,
                                    "observed": round(self.observed, 6),
                                    "budget": self.budget}
        if self.detail:
            attrs["detail"] = self.detail
        return attrs


@dataclass
class SloPolicy:
    """Budgets by objective; None leaves an objective out.

    p99_budget_s / queue_age_p99_budget_s:
        End-to-end and time-queued p99 ceilings (seconds), judged only in
        windows that saw traffic (a ``submitted`` or ``completed`` delta):
        the reservoirs are cumulative, so a quiet window's quantiles are a
        past burst's evidence.
    max_shed_rate:
        The share of offered traffic refused in one window,
        ``(shed + rejected) / (submitted + shed + rejected)``; a window
        without traffic is not judged.
    max_restart_burn:
        Supervised restarts (replica and trainer) tolerated a window.
    max_staleness_s / max_drift_score:
        Ceilings on the trainer's ``staleness_s`` / ``drift_score`` gauges.
    tenant_device_s_budget:
        The device-seconds one tenant may spend in one window (the cost
        table's deltas on the row); the breach's ``detail`` names it.
    device_mem_budget_bytes:
        A ceiling on the ``device_mem_bytes`` watermark gauge.
    """

    p99_budget_s: Optional[float] = None
    queue_age_p99_budget_s: Optional[float] = None
    max_shed_rate: Optional[float] = None
    max_restart_burn: Optional[int] = None
    max_staleness_s: Optional[float] = None
    max_drift_score: Optional[float] = None
    tenant_device_s_budget: Optional[float] = None
    device_mem_budget_bytes: Optional[float] = None

    def evaluate(self, row: Dict[str, object]) -> List[SloBreach]:
        """Judge one ``sample_timeline`` row; the breaches, empty when
        every set objective holds."""
        ts = float(row.get("ts") or time.time())
        counters: Dict[str, int] = dict(row.get("counters") or {})
        gauges: Dict[str, float] = dict(row.get("gauges") or {})
        out: List[SloBreach] = []

        def breach(objective: str, observed, budget) -> None:
            out.append(SloBreach(objective, float(observed), float(budget), ts))

        # quantiles of cumulative reservoirs judge only a window with traffic
        active = counters.get("submitted", 0) + counters.get("completed", 0) > 0
        lat = row.get("latency") or {}
        if active and self.p99_budget_s is not None and lat.get("p99", 0.0) > self.p99_budget_s:
            breach("p99_budget_s", lat["p99"], self.p99_budget_s)
        age = row.get("queue_age") or {}
        if (active and self.queue_age_p99_budget_s is not None
                and age.get("p99", 0.0) > self.queue_age_p99_budget_s):
            breach("queue_age_p99_budget_s", age["p99"], self.queue_age_p99_budget_s)
        if self.max_shed_rate is not None:
            submitted = counters.get("submitted", 0)
            refused = counters.get("shed", 0) + counters.get("rejected", 0)
            if submitted + refused > 0:
                rate = refused / (submitted + refused)
                if rate > self.max_shed_rate:
                    breach("max_shed_rate", rate, self.max_shed_rate)
        if self.max_restart_burn is not None:
            burn = counters.get("restarts", 0) + counters.get("trainer_restarts", 0)
            if burn > self.max_restart_burn:
                breach("max_restart_burn", burn, self.max_restart_burn)
        if self.max_staleness_s is not None:
            staleness = gauges.get("staleness_s")
            if staleness is not None and staleness > self.max_staleness_s:
                breach("max_staleness_s", staleness, self.max_staleness_s)
        if self.max_drift_score is not None:
            drift = gauges.get("drift_score")
            if drift is not None and drift > self.max_drift_score:
                breach("max_drift_score", drift, self.max_drift_score)
        if self.tenant_device_s_budget is not None:
            for tenant, cost in sorted((row.get("costs") or {}).items()):
                spent = float((cost or {}).get("device_s") or 0.0)
                if spent > self.tenant_device_s_budget:
                    out.append(SloBreach("tenant_device_s_budget", spent,
                                         float(self.tenant_device_s_budget), ts,
                                         detail=str(tenant)))
        if self.device_mem_budget_bytes is not None:
            mem = gauges.get("device_mem_bytes")
            if mem is not None and mem > self.device_mem_budget_bytes:
                breach("device_mem_budget_bytes", mem, self.device_mem_budget_bytes)
        return out


class SloWatchdog:
    """One registry's per-sample SLO evaluation. ``tick()`` samples the
    registry's timeline and judges the new row; the caller owns the cadence.
    ``source`` labels the evidence so a merged view can tell tiers apart."""

    #: breaches kept in :attr:`breaches`
    MAX_KEPT = 256

    def __init__(self, metrics, policy: SloPolicy, source: str = "serving"):
        self._metrics = metrics
        self.policy = policy
        self.source = source
        self.breaches: List[SloBreach] = []

    def tick(self) -> List[SloBreach]:
        found = self.policy.evaluate(self._metrics.sample_timeline())
        for b in found:
            self._emit(b)
        if found:
            self.breaches.extend(found)
            del self.breaches[:-self.MAX_KEPT]
        return found

    def _emit(self, b: SloBreach) -> None:
        self._metrics.inc("slo_breaches")
        self._metrics.inc(f"slo_breach.{b.objective}")
        attrs = b.as_attrs()
        flight.record_instant("slo.breach", source=self.source, **attrs)
        tracer = _trace_current()
        if tracer is not None:
            tracer.instant("slo.breach", op_type=type(self).__name__, source=self.source,
                           **attrs)
        if every(f"slo:{self.source}:{b.objective}", 10.0):
            logger.warning("SLO breach [%s] %s: observed %.4f vs budget %.4f",
                           self.source, b.objective, b.observed, b.budget)
