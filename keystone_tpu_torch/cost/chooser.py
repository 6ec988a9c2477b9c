"""Per-node solver selection from predicted cost (port of
``keystone_tpu/cost/chooser.py``).

Given an auto-solver's options and a
:class:`~keystone_tpu_torch.cost.model.ShapeSignature`, the chooser prices
every option through :class:`~keystone_tpu_torch.cost.model.CostEstimator`
and takes the cheapest: by analytic units when cold, by predicted seconds
once the profile store holds evidence. A chunked input restricts the
field to options with a streaming fit.

With a tracer installed, every choice records a ``cost.estimate`` span
(shape, winner, whether evidence took part) and, when the DAG node is
known, a tracer estimate row, so the estimate-against-observed audit
(``obs/audit.py``) covers solver nodes as it covers cached ones.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from ..obs import tracer as obs_tracer
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
    #: "learned" when stored evidence priced at least one option, else
    #: "cold" (analytic units only)
    source: str = "cold"

    @property
    def est_seconds(self) -> Optional[float]:
        return self.costs.get(self.label, {}).get("seconds")


class SolverChooser:
    """Ranks solver options by predicted cost."""

    def __init__(self, estimator: Optional[CostEstimator] = None):
        if estimator is None:
            from . import get_estimator

            estimator = get_estimator()
        self.estimator = estimator

    def choose(self, options: Sequence, shape: ShapeSignature, cpu_weight: float,
               mem_weight: float, network_weight: float, node_id: Optional[str] = None,
               owner_label: str = "solver") -> SolverChoice:
        if not options:
            raise ValueError("no solver options to choose from")
        costs = self.estimator.solver_costs(options, shape, cpu_weight, mem_weight,
                                            network_weight)

        def rank(opt) -> float:
            row = costs[type(opt).__name__]
            if row["seconds"] is not None:
                return row["seconds"]
            return row["units"]

        viable = [o for o in options if math.isfinite(rank(o))]
        if not viable:
            # every option priced out: keep the first, whose fit raises a
            # real error if it truly cannot run
            logger.warning("%s: no viable solver for %s — keeping %s",
                           owner_label, shape, type(options[0]).__name__)
            viable = [options[0]]
        chosen = min(viable, key=rank)
        learned = any(row["learned"] for row in costs.values())
        choice = SolverChoice(chosen=chosen, label=type(chosen).__name__, shape=shape,
                              costs=costs, source="learned" if learned else "cold")
        self._record(choice, node_id, owner_label)
        return choice

    @staticmethod
    def _record(choice: SolverChoice, node_id: Optional[str], owner_label: str) -> None:
        tracer = obs_tracer.current()
        if tracer is None:
            return
        with tracer.span("cost.estimate", node_id=node_id, op_type=owner_label,
                         solver=choice.label, source=choice.source, n=choice.shape.n,
                         d=choice.shape.d, k=choice.shape.k, chunked=choice.shape.chunked):
            pass
        if node_id is None:
            return
        est = choice.est_seconds
        tracer.record_node_estimate(
            node_id,
            choice.label,
            est_seconds=None if est is None else float(est),
            # the fitted model is the node's materialized result
            est_bytes=float(choice.shape.d * choice.shape.k * 4),
            cacher=False,
            kind="solver",
            solver=choice.label,
            # kept when the cache planner later overwrites est_seconds
            solver_est_seconds=None if est is None else float(est),
            source=choice.source,
            alternatives={
                lbl: row["seconds"] if row["seconds"] is not None
                else (row["units"] if math.isfinite(row["units"]) else None)
                for lbl, row in choice.costs.items()
            },
        )
