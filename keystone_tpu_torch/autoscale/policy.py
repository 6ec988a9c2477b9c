"""The declarative bounds on fleet elasticity (port of
``keystone_tpu/autoscale/policy.py``).

A :class:`ScalePolicy` is everything the operator says about scaling and
everything the :class:`~keystone_tpu_torch.autoscale.Autoscaler` may do:
hard worker-count bounds, breach-count hysteresis (one noisy sample must
not buy a worker) and per-direction cooldowns (a scale-up shows its effect
only after a boot; deciding again before the evidence reflects the last
decision oscillates). The scaler reads the policy, never the reverse:
policies are plain data, picklable into status views and decision rows.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class ScalePolicy:
    """Bounds + hysteresis for breach-driven fleet scaling.

    min_workers / max_workers:
        Hard bounds on the worker-process count. The scaler restores a
        fleet below ``min_workers`` (e.g. after a failed spawn) and
        never grows past ``max_workers`` no matter how red the SLO.
    up_breaches / breach_window_s:
        Scale-up hysteresis: at least ``up_breaches`` SLO breach rows
        within the trailing ``breach_window_s`` seconds before one
        worker is added. The window is cleared by a scale-up decision,
        so each worker is bought by fresh evidence.
    up_cooldown_s / down_cooldown_s:
        Minimum seconds between same-direction decisions. Up-cooldown
        should cover a worker boot (the breach stream does not reflect
        the new capacity until it serves); down-cooldown should be the
        longer of the two — releasing capacity is cheap to delay and
        expensive to regret.
    idle_queue_depth / down_after_idle_ticks:
        Scale-down evidence: a health tick is "idle" when the timeline
        row shows no fresh breach and the queue-depth gauge at or below
        ``idle_queue_depth``; after ``down_after_idle_ticks``
        CONSECUTIVE idle ticks (any loaded tick resets the run) one
        worker is drained, down to ``min_workers``.
    """

    min_workers: int = 1
    max_workers: int = 4
    up_breaches: int = 2
    breach_window_s: float = 30.0
    up_cooldown_s: float = 20.0
    down_cooldown_s: float = 60.0
    idle_queue_depth: float = 0.0
    down_after_idle_ticks: int = 5

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError(
                f"min_workers must be >= 1, got {self.min_workers}"
            )
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) must be >= min_workers "
                f"({self.min_workers})"
            )
        if self.up_breaches < 1:
            raise ValueError(
                f"up_breaches must be >= 1, got {self.up_breaches}"
            )
        if self.down_after_idle_ticks < 1:
            raise ValueError(
                "down_after_idle_ticks must be >= 1, got "
                f"{self.down_after_idle_ticks}"
            )

    def as_dict(self) -> dict:
        return asdict(self)

    def clamp(self, n: int) -> int:
        return max(self.min_workers, min(self.max_workers, n))
