"""Per-node solver selection from predicted cost (port of
``keystone_tpu/cost/chooser.py``, without its trace spans): price every
option of an auto-solver for one shape and take the cheapest."""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from .model import CostEstimator, ShapeSignature

logger = logging.getLogger(__name__)


@dataclass
class SolverChoice:
    """One selection: the winning option and the whole pricing table."""

    chosen: object
    label: str
    shape: ShapeSignature
    #: per option {"units", "spu", "seconds", "learned"}
    costs: Dict[str, Dict[str, Optional[float]]] = field(default_factory=dict)
    #: "cold": analytic units only (learned profiles are later work)
    source: str = "cold"


class SolverChooser:
    """Ranks solver options by their analytic cost units."""

    def __init__(self, estimator: Optional[CostEstimator] = None):
        if estimator is None:
            from . import get_estimator

            estimator = get_estimator()
        self.estimator = estimator

    def choose(
        self,
        options: Sequence,
        shape: ShapeSignature,
        cpu_weight: float,
        mem_weight: float,
        network_weight: float,
        owner_label: str = "solver",
    ) -> SolverChoice:
        if not options:
            raise ValueError("no solver options to choose from")
        costs = self.estimator.solver_costs(
            options, shape, cpu_weight, mem_weight, network_weight
        )

        def rank(opt) -> float:
            return costs[type(opt).__name__]["units"]

        viable = [o for o in options if math.isfinite(rank(o))]
        if not viable:
            # every option priced out: keep the first, whose fit raises a
            # real error if it truly cannot run
            logger.warning("%s: no viable solver for %s — keeping %s",
                           owner_label, shape, type(options[0]).__name__)
            viable = [options[0]]
        chosen = min(viable, key=rank)
        return SolverChoice(chosen=chosen, label=type(chosen).__name__, shape=shape,
                            costs=costs)
