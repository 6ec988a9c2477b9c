"""The cost model: predicted per-node time and memory from data shape and
measured operator throughput (port of ``keystone_tpu/cost/model.py``).

Every solver exposes ``cost(n, d, k, ...)`` in analytic units of the
reference's functional form, ``max(cpu·flops, mem·bytes) + net·network``
(``nodes/learning/cost.py``). Two learned profiles, kept in the
:class:`~keystone_tpu_torch.cost.store.ProfileStore` under
``op/<OperatorClass>`` keys, turn units into seconds:

* **seconds per unit (spu)**, per solver class: the EWMA of observed fit
  seconds over predicted cost units from traced fits. A candidate's
  predicted seconds are its units times its class's spu; a class without
  evidence borrows the geometric mean of the classes that have it, so one
  observed fit calibrates the whole option set's scale and keeps the
  analytic ranking among the others. With no evidence (or no store) every
  ``seconds`` is None and the ranking is the cold analytic one.
* **per-item node throughput**, per operator class: EWMA seconds and bytes
  per item from executor span observations, which the cache planner uses
  to price a node its sampled profiling skipped.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

logger = logging.getLogger(__name__)

#: EWMA weight of a new observation merged into stored evidence: a
#: regressed operator re-prices within a few runs, one noisy run cannot
#: flip a stable plan
EWMA_ALPHA = 0.5


@dataclass(frozen=True)
class ShapeSignature:
    """What the chooser needs to know about a solve: the design-matrix
    shape (n, d), label width k, sparsity, whether the input arrives as
    out-of-core chunks, and the number of machines."""

    n: int
    d: int
    k: int
    sparsity: float = 1.0
    chunked: bool = False
    machines: int = 1

    def to_record(self) -> Dict:
        return {
            "n": int(self.n), "d": int(self.d), "k": int(self.k),
            "sparsity": float(self.sparsity), "chunked": bool(self.chunked),
            "machines": int(self.machines),
        }

    @staticmethod
    def from_record(rec: Dict) -> Optional["ShapeSignature"]:
        try:
            return ShapeSignature(
                n=int(rec["n"]), d=int(rec["d"]), k=int(rec["k"]),
                sparsity=float(rec.get("sparsity", 1.0)),
                chunked=bool(rec.get("chunked", False)),
                machines=int(rec.get("machines", 1)),
            )
        except (KeyError, TypeError, ValueError):
            return None


def op_key(op_or_class) -> str:
    """The profile-store key of one operator class: ``op/<ClassName>``."""
    cls = op_or_class if isinstance(op_or_class, type) else type(op_or_class)
    return f"op/{cls.__name__}"


def ewma(old: Optional[float], new: float, alpha: float = EWMA_ALPHA) -> float:
    if old is None or not math.isfinite(old):
        return float(new)
    return float(alpha * new + (1.0 - alpha) * old)


class CostEstimator:
    """Prices solver candidates and previously seen nodes from the profile
    store; the analytic model alone when the store is absent or empty."""

    def __init__(self, store=None):
        self.store = store

    # -- solver pricing -------------------------------------------------

    def seconds_per_unit(self, op_class) -> Optional[float]:
        """The learned spu of one solver class, or None without evidence."""
        if self.store is None:
            return None
        rec = self.store.load(op_key(op_class))
        if not rec:
            return None
        spu = rec.get("spu")
        if isinstance(spu, (int, float)) and spu > 0 and math.isfinite(spu):
            return float(spu)
        return None

    def solver_costs(self, options: Sequence, shape: ShapeSignature, cpu_weight: float,
                     mem_weight: float, network_weight: float
                     ) -> Dict[str, Dict[str, Optional[float]]]:
        """Per option (by class name): its analytic ``units`` (its own
        ``cost``), its learned ``spu``, its predicted ``seconds`` (None
        when no option has evidence) and whether ``learned``. An option
        that cannot take the shape (no streaming fit for a chunked input)
        prices to +inf units."""
        units: Dict[str, float] = {}
        spus: Dict[str, Optional[float]] = {}
        for opt in options:
            label = type(opt).__name__
            if shape.chunked and not getattr(opt, "supports_streaming", False):
                units[label] = math.inf
                spus[label] = None
                continue
            units[label] = float(opt.cost(
                shape.n, shape.d, shape.k, shape.sparsity, shape.machines,
                cpu_weight, mem_weight, network_weight,
            ))
            spus[label] = self.seconds_per_unit(type(opt))
        known = [s for s in spus.values() if s is not None]
        fallback = math.exp(sum(math.log(s) for s in known) / len(known)) if known else None
        out: Dict[str, Dict[str, Optional[float]]] = {}
        for label, u in units.items():
            spu = spus[label] if spus[label] is not None else fallback
            out[label] = {
                "units": u,
                "spu": spus[label],
                "seconds": None if spu is None or not math.isfinite(u) else u * spu,
                "learned": spus[label] is not None,
            }
        return out

    # -- node pricing ---------------------------------------------------

    def node_profile_ns(self, op_class_name: str, n_items: int):
        """(ns, bytes) of ``n_items`` through one operator class from its
        stored per-item throughput, or None without evidence."""
        if self.store is None:
            return None
        rec = self.store.load(f"op/{op_class_name}")
        if not rec:
            return None
        spi = rec.get("seconds_per_item")
        bpi = rec.get("bytes_per_item")
        if not isinstance(spi, (int, float)) or spi < 0:
            return None
        if not isinstance(bpi, (int, float)) or bpi < 0:
            # no bytes evidence: pricing it at 0 bytes would hand the greedy
            # planner a free cache candidate it always selects
            return None
        return (float(spi) * n_items * 1e9, float(bpi) * n_items)

    # -- evidence updates -----------------------------------------------

    def observe_solver(self, op_class_name: str, units: float, seconds: float) -> None:
        """Fold one measured fit into the class's spu EWMA."""
        if self.store is None or units <= 0 or seconds <= 0:
            return

        def merge(rec):
            rec = dict(rec or {})
            rec["spu"] = ewma(rec.get("spu"), seconds / units)
            rec["solver_observations"] = int(rec.get("solver_observations", 0)) + 1
            return rec

        self.store.update(f"op/{op_class_name}", merge)

    def observe_node(self, op_class_name: str, n_items: int, seconds: float,
                     out_bytes: Optional[float]) -> None:
        """Fold one observed node execution into the class's per-item EWMAs."""
        self.observe_nodes(op_class_name, [(n_items, seconds, out_bytes)])

    def observe_nodes(self, op_class_name: str, observations) -> None:
        """Fold several ``(n_items, seconds, out_bytes)`` observations into
        the class's per-item EWMAs with one store round trip."""
        if self.store is None:
            return
        obs = [(n, s, b) for n, s, b in observations if n > 0 and s >= 0]
        if not obs:
            return

        def merge(rec):
            rec = dict(rec or {})
            for n_items, seconds, out_bytes in obs:
                rec["seconds_per_item"] = ewma(rec.get("seconds_per_item"), seconds / n_items)
                if out_bytes is not None:
                    rec["bytes_per_item"] = ewma(rec.get("bytes_per_item"),
                                                 float(out_bytes) / n_items)
                rec["node_observations"] = int(rec.get("node_observations", 0)) + 1
            return rec

        self.store.update(f"op/{op_class_name}", merge)
