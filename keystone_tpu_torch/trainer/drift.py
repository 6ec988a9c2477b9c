"""Drift detection: when has the world moved enough to refit? (port of
``keystone_tpu/trainer/drift.py``)

The monitor compares the stream of appended FEATURE chunks against the
fitted model's own moment snapshot
(:meth:`~keystone_tpu_torch.linalg.accumulators.GramSolverState.moments`,
derived from the solver state's raw sums, so the baseline costs no extra
statistics pass) and, on labeled appends, tracks the model's streaming
residual error. Three triggers, each with a stated false-positive bound:

* **mean shift**: per-column z-statistic of the recent mean against the
  baseline, ``z_j = |μ̂_j − μ_j| / sqrt(σ²_j / n_recent)``. Under a
  stationary stream ``max_j z_j`` exceeds ``z_threshold`` with
  probability ≤ ``d · 2Φ(−z)`` a check: the default ``z = 6`` keeps it
  below 2e-8 even at d = 10⁴.
* **variance shift**: per-column ratio ``max(σ̂²/σ², σ²/σ̂²)`` against
  ``var_ratio``; the sample ratio concentrates as ``1 ± sqrt(2/n)``, so
  the default 4.0 with ``min_rows`` ≥ 64 is more than 20 null standard
  deviations out.
* **residual shift**: an EWMA of each chunk's mean-squared residual
  against the level set over the first ``residual_warmup`` labeled chunks
  after each (re)baseline; trips when the ratio exceeds
  ``residual_ratio``. Without labels it is skipped and the moment
  triggers decide alone.

No trigger fires before ``min_rows`` recent rows were observed.
``rebaseline()`` is called by the daemon after every promoted refresh, so
drift is measured against what the serving model absorbed.

The moments are host float64 (:class:`MomentsState`, Chan/Welford): a
chunk handed over as a card tensor is copied to the host once, inside
:meth:`MomentsState.update`.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Optional

import numpy as np

from ..linalg.accumulators import MomentsState


class DriftMonitor:
    """Feature-moment and residual drift triggers for the trainer daemon.

    Thread-safe: the daemon observes from its loop thread while tests and
    metrics gauges read scores from others."""

    def __init__(self, baseline: MomentsState, *, z_threshold: float = 6.0,
                 var_ratio: float = 4.0, residual_ratio: float = 2.0, min_rows: int = 64,
                 residual_warmup: int = 2, residual_alpha: float = 0.5):
        if baseline.mean is None or baseline.n <= 1:
            raise ValueError("drift baseline must hold fitted moments")
        self._lock = threading.Lock()
        self._base = baseline.snapshot()
        self.z_threshold = float(z_threshold)
        self.var_ratio = float(var_ratio)
        self.residual_ratio = float(residual_ratio)
        self.min_rows = int(min_rows)
        self.residual_warmup = int(residual_warmup)
        self.residual_alpha = float(residual_alpha)
        self._recent = MomentsState()
        self._resid_base: Optional[float] = None
        self._resid_base_chunks = 0
        self._resid_ewma: Optional[float] = None

    # -- observation -----------------------------------------------------

    def observe(self, feats: Any, residual_mse: Optional[float] = None) -> None:
        """Fold one featurized chunk (a host array or a tensor) and, when
        given, its model residual's mean-squared error into the recent
        window."""
        if not hasattr(feats, "ndim"):
            feats = np.asarray(feats, dtype=np.float64)
        with self._lock:
            if feats.ndim == 2 and feats.shape[0]:
                self._recent.update(feats)
            if residual_mse is not None and math.isfinite(residual_mse):
                if self._resid_base_chunks < self.residual_warmup:
                    # the post-(re)baseline residual level comes first
                    self._resid_base_chunks += 1
                    self._resid_base = (
                        residual_mse if self._resid_base is None
                        else self._resid_base
                        + (residual_mse - self._resid_base) / self._resid_base_chunks)
                    self._resid_ewma = self._resid_base
                else:
                    a = self.residual_alpha
                    self._resid_ewma = (residual_mse if self._resid_ewma is None
                                        else a * residual_mse + (1 - a) * self._resid_ewma)

    # -- verdicts --------------------------------------------------------

    def score(self) -> dict:
        """The current evidence: max mean-shift z, max variance ratio, the
        residual ratio (None before the labeled warm-up completes), the
        recent row count, and the composite ``drift_score`` the metrics
        gauge exports (the largest trigger ratio; 1.0 is at threshold)."""
        with self._lock:
            out = {"rows": int(self._recent.n), "z_max": 0.0, "var_ratio_max": 1.0,
                   "residual_ratio": None}
            if self._recent.mean is not None and self._recent.n >= max(2, self.min_rows):
                n = float(self._recent.n)
                base_var = np.maximum(self._base.m2 / max(self._base.n - 1, 1), 1e-12)
                z = np.abs(self._recent.mean - self._base.mean) / np.sqrt(base_var / n)
                out["z_max"] = float(np.max(z))
                recent_var = np.maximum(self._recent.m2 / max(self._recent.n - 1, 1), 1e-12)
                ratio = recent_var / base_var
                out["var_ratio_max"] = float(np.max(np.maximum(ratio, 1.0 / ratio)))
            if (self._resid_ewma is not None
                    # "is not None", not truthiness: a warm-up that fits
                    # perfectly (mse exactly 0.0) must not disable the
                    # trigger; the divide below is floored
                    and self._resid_base is not None
                    and self._resid_base_chunks >= self.residual_warmup):
                out["residual_ratio"] = float(self._resid_ewma / max(self._resid_base, 1e-12))
            ratios = [out["z_max"] / self.z_threshold, out["var_ratio_max"] / self.var_ratio]
            if out["residual_ratio"] is not None:
                ratios.append(out["residual_ratio"] / self.residual_ratio)
            out["drift_score"] = float(max(ratios))
            return out

    def should_refit(self) -> Optional[str]:
        """The trigger verdict: a readable reason when a threshold is
        crossed, else None."""
        s = self.score()
        if s["rows"] < self.min_rows:
            return None
        if s["z_max"] > self.z_threshold:
            return f"mean shift z={s['z_max']:.1f} > {self.z_threshold}"
        if s["var_ratio_max"] > self.var_ratio:
            return f"variance ratio {s['var_ratio_max']:.1f} > {self.var_ratio}"
        r = s["residual_ratio"]
        if r is not None and r > self.residual_ratio:
            return f"residual ratio {r:.2f} > {self.residual_ratio}"
        return None

    # -- lifecycle -------------------------------------------------------

    def rebaseline(self, baseline: MomentsState) -> None:
        """Start over against a freshly promoted model's moments: the
        recent window and the residual baseline are reset (the new model
        was solved on the absorbed data, so the old residual level no
        longer describes it)."""
        if baseline.mean is None or baseline.n <= 1:
            raise ValueError("drift baseline must hold fitted moments")
        with self._lock:
            self._base = baseline.snapshot()
            self._recent = MomentsState()
            self._resid_base = None
            self._resid_base_chunks = 0
            self._resid_ewma = None
