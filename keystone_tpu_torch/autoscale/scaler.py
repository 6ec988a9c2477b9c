"""The breach-driven scaler: SLO evidence in, worker-count decisions out
(port of ``keystone_tpu/autoscale/scaler.py``).

The :class:`Autoscaler` rides the cluster router's health loop, the cadence
that pings workers and drives the
:class:`~keystone_tpu_torch.serving.slo.SloWatchdog`, and closes the loop
the watchdog only observes: fresh breach rows and the timeline's
queue-depth gauge become scale-up and scale-down decisions, bounded by a
:class:`~keystone_tpu_torch.autoscale.policy.ScalePolicy`.

The scaler touches no socket and no process. It drives an actuator (the
router, duck-typed) through these verbs::

    service_estimate        -> Optional[float]  (a cold fleet does nothing)
    scale_view()            -> {"admitting", "booting", "draining"}
    scale_up_slot()         -> new slot index (spawned as at boot: a warm
                               boot from the shared AOT cache, 0 traces)
    pick_drain_candidate()  -> slot index or None
    begin_drain(index)      -> stop admitting, drain, join, release
    reap_slot(index)        -> force-retire a half-born or wedged slot

so the control plane is testable against a stub. Both apply paths run
through the fault sites ``scale.spawn`` / ``scale.drain``; a kill injected
mid-apply reaps the half-born slot, records a ``scale.abort`` instant and
leaves the next tick (after the cooldown) to bring the fleet back inside
the policy. No admitted request fails for a scaling accident: a slot is
routed to only once it reports ready.

Every decision leaves evidence three ways: the ``scale_ups`` /
``scale_downs`` / ``scale_aborts`` counters, a flight instant
(``scale.up`` / ``scale.down`` / ``scale.abort``) and, with a tracer
installed, a ``scale.*`` span; :attr:`Autoscaler.decisions` keeps the last
ones with their triggering breach for the status view.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from ..faults import SCALE_DRAIN, SCALE_SPAWN, fault_point
from ..obs import flight as _flight
from ..obs.span import Span
from ..obs.tracer import current as _trace_current
from .policy import ScalePolicy

logger = logging.getLogger(__name__)

#: decisions kept for the status view
_MAX_DECISIONS = 64

#: SLO objectives that do NOT evidence a capacity shortage — adding a
#: worker cannot fix a tenant blowing its spend budget or one process's
#: device-memory footprint, so their breaches never buy scale-ups
NON_CAPACITY_OBJECTIVES = frozenset(
    {"tenant_device_s_budget", "device_mem_budget_bytes"}
)


@dataclass(frozen=True)
class ScaleDecision:
    """One scaling decision, with the evidence that triggered it."""

    action: str  # "up" | "down"
    ok: bool  # False: the apply was aborted (fault/spawn failure)
    reason: str  # "breach" | "below_min" | "idle"
    from_workers: int
    to_workers: int
    ts: float  # unix time, for rendering next to timeline rows
    worker: Optional[int] = None  # slot index acted on, when known
    #: the breach that bought this decision (objective/observed/budget),
    #: empty for idle-driven scale-downs and min-bound restores
    trigger: Dict[str, object] = field(default_factory=dict)

    def as_row(self) -> dict:
        return asdict(self)


class Autoscaler:
    """Policy-bounded scale decisions off breach + timeline evidence.

    Not thread-safe by itself: ``tick`` is called from exactly one
    thread (the router's health loop; tests call it directly)."""

    def __init__(self, policy: ScalePolicy, actuator, metrics=None):
        self.policy = policy
        self._actuator = actuator
        self._metrics = metrics
        self.decisions: deque = deque(maxlen=_MAX_DECISIONS)
        self._breach_window: deque = deque()  # (monotonic ts, breach)
        self._idle_ticks = 0
        self._last_up = -float("inf")
        self._last_down = -float("inf")
        self._target: Optional[int] = None

    # -- introspection ---------------------------------------------------

    @property
    def target_workers(self) -> Optional[int]:
        """The worker count the scaler currently wants (None before the
        first tick)."""
        return self._target

    def describe(self) -> dict:
        """The status-view payload: policy knobs, current target, and
        the last decisions newest-last."""
        return {
            "policy": self.policy.as_dict(),
            "target": self._target,
            "decisions": [d.as_row() for d in self.decisions],
        }

    # -- the control loop ------------------------------------------------

    def tick(self, breaches=None, row: Optional[dict] = None) -> List[ScaleDecision]:
        """One control-loop step: fold this tick's fresh breach rows and
        timeline row in, decide. Returns the decisions made (usually
        none). A COLD fleet — no learned service estimate yet — never
        scales: the scaler prices capacity from the same evidence the
        admission surfaces price waits from, and without it a breach row
        cannot exist and an idle queue proves nothing."""
        if getattr(self._actuator, "service_estimate", None) is None:
            return []
        now = time.monotonic()
        for b in breaches or ():
            if getattr(b, "objective", None) in NON_CAPACITY_OBJECTIVES:
                # a tenant overspending its device-second budget or a
                # per-process memory watermark is not a capacity
                # shortage: buying a worker fixes neither, so these
                # breaches warn (flight/status/counters) without feeding
                # the scale-up hysteresis
                continue
            self._breach_window.append((now, b))
        horizon = now - self.policy.breach_window_s
        while self._breach_window and self._breach_window[0][0] < horizon:
            self._breach_window.popleft()

        view = self._actuator.scale_view()
        committed = int(view.get("admitting", 0)) + int(view.get("booting", 0))
        self._target = self.policy.clamp(committed)
        out: List[ScaleDecision] = []

        # -- scale-up: bounds first, then breach hysteresis --------------
        up_ready = now - self._last_up >= self.policy.up_cooldown_s
        if committed < self.policy.min_workers and up_ready:
            out.append(self._apply_up(committed, reason="below_min"))
        elif (
            committed < self.policy.max_workers
            and up_ready
            and len(self._breach_window) >= self.policy.up_breaches
        ):
            trigger = self._trigger_attrs(self._breach_window[-1][1])
            self._breach_window.clear()  # each worker needs fresh evidence
            out.append(
                self._apply_up(committed, reason="breach", trigger=trigger)
            )

        # -- scale-down: consecutive idle ticks, bounded below by min ----
        if not out:
            queue_depth = float(
                ((row or {}).get("gauges") or {}).get("queue_depth", 0.0)
            )
            idle = (
                not breaches
                and not self._breach_window
                and queue_depth <= self.policy.idle_queue_depth
            )
            self._idle_ticks = self._idle_ticks + 1 if idle else 0
            if (
                self._idle_ticks >= self.policy.down_after_idle_ticks
                and committed > self.policy.min_workers
                and now - self._last_down >= self.policy.down_cooldown_s
                and now - self._last_up >= self.policy.down_cooldown_s
            ):
                d = self._apply_down(committed)
                if d is not None:
                    self._idle_ticks = 0
                    out.append(d)

        if out:
            self._target = self.policy.clamp(
                committed
                + sum(1 for d in out if d.action == "up" and d.ok)
                - sum(1 for d in out if d.action == "down" and d.ok)
            )
        return out

    # -- apply paths (fault-instrumented) --------------------------------

    def _apply_up(
        self, committed: int, reason: str, trigger: Optional[dict] = None
    ) -> ScaleDecision:
        self._last_up = time.monotonic()
        t0 = time.perf_counter()
        index: Optional[int] = None
        try:
            index = self._actuator.scale_up_slot()
            # the registered chaos seam sits BETWEEN spawn and ready —
            # a kill here is a worker dying mid-scale-up, before the
            # router ever admits traffic to it
            fault_point(SCALE_SPAWN, worker=index)
        except BaseException as e:  # noqa: BLE001 — incl. injected kills
            logger.warning(
                "autoscale: scale-up aborted (%s) — reaping slot %s",
                e, index,
            )
            return self._abort(
                "up", committed, index, reason, trigger, t0, cause=e
            )
        return self._commit(
            "up", committed, committed + 1, index, reason, trigger, t0
        )

    def _apply_down(self, committed: int) -> Optional[ScaleDecision]:
        index = self._actuator.pick_drain_candidate()
        if index is None:
            return None
        self._last_down = time.monotonic()
        t0 = time.perf_counter()
        try:
            self._actuator.begin_drain(index)
            # chaos seam: a kill here is a worker dying mid-drain — the
            # reap force-retires it and the router's down-handler
            # requeues its in-flight work with deadlines intact
            fault_point(SCALE_DRAIN, worker=index)
        except BaseException as e:  # noqa: BLE001 — incl. injected kills
            logger.warning(
                "autoscale: drain of worker %s aborted (%s) — reaping it",
                index, e,
            )
            return self._abort(
                "down", committed, index, "idle", None, t0, cause=e
            )
        return self._commit(
            "down", committed, committed - 1, index, "idle", None, t0
        )

    # -- decision bookkeeping + evidence ---------------------------------

    def _trigger_attrs(self, breach) -> dict:
        out = {}
        for k in ("objective", "observed", "budget"):
            v = getattr(breach, k, None)
            if v is None and isinstance(breach, dict):
                v = breach.get(k)
            if v is not None:
                out[k] = v
        return out

    def _commit(
        self, action, from_n, to_n, index, reason, trigger, t0
    ) -> ScaleDecision:
        d = ScaleDecision(
            action=action, ok=True, reason=reason,
            from_workers=from_n, to_workers=to_n,
            ts=time.time(), worker=index, trigger=dict(trigger or {}),
        )
        self._record(d, t0)
        logger.info(
            "autoscale: scale-%s -> %d worker(s) (reason: %s, slot %s)",
            action, to_n, reason, index,
        )
        return d

    def _abort(
        self, action, committed, index, reason, trigger, t0, cause
    ) -> ScaleDecision:
        if index is not None:
            try:
                self._actuator.reap_slot(index)
            except Exception:
                logger.exception(
                    "autoscale: reaping slot %d after a failed scale-%s "
                    "failed too", index, action,
                )
        d = ScaleDecision(
            action=action, ok=False, reason=reason,
            from_workers=committed, to_workers=committed,
            ts=time.time(), worker=index,
            trigger=dict(trigger or {}, cause=str(cause)[:200]),
        )
        self._record(d, t0)
        return d

    def _record(self, d: ScaleDecision, t0: float) -> None:
        self.decisions.append(d)
        name = f"scale.{d.action}" if d.ok else "scale.abort"
        attrs = {
            "action": d.action, "reason": d.reason, "worker": d.worker,
            "from_workers": d.from_workers, "to_workers": d.to_workers,
            **{f"trigger_{k}": v for k, v in d.trigger.items()},
        }
        if d.ok:
            _flight.record_instant(
                "scale.up" if d.action == "up" else "scale.down", **attrs
            )
        else:
            # the recovery instant both scale.* fault sites map to in
            # obs/flight.SITE_INSTANTS: the half-born (or half-drained)
            # slot was reaped and the fleet stays inside policy bounds
            _flight.record_instant("scale.abort", **attrs)
        if self._metrics is not None:
            if not d.ok:
                self._metrics.inc("scale_aborts")
            elif d.action == "up":
                self._metrics.inc("scale_ups")
            else:
                self._metrics.inc("scale_downs")
        tracer = _trace_current()
        if tracer is not None:
            tracer.record_complete(Span(
                name=name, start=t0, end=time.perf_counter(),
                op_type="Autoscaler", attrs=attrs,
            ))
