"""The cost model's cold path (port of ``keystone_tpu/cost/model.py``).

Every solver exposes ``cost(n, d, k, ...)`` in analytic units of the
reference's functional form, ``max(cpu·flops, mem·bytes) + net·network``
(``nodes/learning/cost.py``). :class:`CostEstimator` prices a set of
candidate solvers for one :class:`ShapeSignature` in those units. The JAX
package also learns seconds-per-unit for each solver class from traced
runs kept in a profile store; the store, and with it every ``seconds``
figure, is later work here, so every price is cold: ``seconds`` is None
and the ranking is the analytic one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence


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


def op_key(op_or_class) -> str:
    """The profile-store key of one operator class: ``op/<ClassName>``."""
    cls = op_or_class if isinstance(op_or_class, type) else type(op_or_class)
    return f"op/{cls.__name__}"


class CostEstimator:
    """Prices solver candidates in analytic units."""

    def solver_costs(
        self,
        options: Sequence,
        shape: ShapeSignature,
        cpu_weight: float,
        mem_weight: float,
        network_weight: float,
    ) -> Dict[str, Dict[str, Optional[float]]]:
        """Per option (by class name): its ``units`` (its own ``cost``),
        and ``spu``/``seconds`` None and ``learned`` False (no profiles).
        An option that cannot take the shape (no streaming fit for a
        chunked input) prices to +inf units."""
        out: Dict[str, Dict[str, Optional[float]]] = {}
        for opt in options:
            if shape.chunked and not getattr(opt, "supports_streaming", False):
                units = math.inf
            else:
                units = float(opt.cost(
                    shape.n, shape.d, shape.k, shape.sparsity, shape.machines,
                    cpu_weight, mem_weight, network_weight,
                ))
            out[type(opt).__name__] = {
                "units": units, "spu": None, "seconds": None, "learned": False,
            }
        return out
