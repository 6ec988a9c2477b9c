"""The traceability lattice: a static verdict per operator (port of
``keystone_tpu/check/lattice.py``).

"Traceable" here means that the node's ``forward`` can run inside one
captured CUDA graph: a function of the stacked batch with no host
synchronisation. Verdicts, worst first::

    opaque         no ``forward``: host per-item work. Blocks whole-chain
                   compilation.
    stateful       the class says its ``forward`` keeps Python-side state
                   (``check_verdict = "stateful"`` or
                   :func:`register_verdict`): a replayed graph would freeze
                   that state. Blocks whole-chain compilation.
    batch_coupled  ``forward`` couples rows (``batch_coupled = True``):
                   compiles, but must never be served through a
                   pad-and-slice path.
    traceable      a pure function of the stacked batch.

The JAX package's fifth verdict, ``host_callback``, and its inspection of
code objects for callbacks and for writes to ``self`` are not ported: an
operator class states its verdict.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

TRACEABLE = "traceable"
BATCH_COUPLED = "batch_coupled"
STATEFUL = "stateful"
OPAQUE = "opaque"

#: worst-first severity order (index = badness rank)
SEVERITY = (OPAQUE, STATEFUL, BATCH_COUPLED, TRACEABLE)

VERDICTS = frozenset(SEVERITY)


def worst(verdicts: Iterable[str]) -> str:
    """The worst verdict present (traceable if none)."""
    best = len(SEVERITY) - 1
    for v in verdicts:
        best = min(best, SEVERITY.index(v))
    return SEVERITY[best]


def blocks_jit(verdict: str) -> bool:
    """Does this verdict block building the whole-chain function? (the
    ``NotTraceableError`` criterion)"""
    return verdict in (OPAQUE, STATEFUL)


_VERDICT_OVERRIDES: Dict[type, str] = {}


def register_verdict(op_class: type, verdict: str) -> None:
    """Pin the verdict of every node of ``op_class``."""
    if verdict not in VERDICTS:
        raise ValueError(f"unknown verdict {verdict!r}")
    _VERDICT_OVERRIDES[op_class] = verdict


def classify(op: Any) -> str:
    """The static verdict of one operator instance."""
    from ..workflow.fusion import FusedTransformerOperator
    from ..workflow.operators import GatherTransformerOperator

    cls = type(op)
    if cls in _VERDICT_OVERRIDES:
        return _VERDICT_OVERRIDES[cls]
    declared = getattr(op, "check_verdict", None)
    if declared is not None:
        if declared not in VERDICTS:
            raise ValueError(
                f"{cls.__name__}.check_verdict={declared!r} is not a "
                f"lattice verdict {sorted(VERDICTS)}"
            )
        return declared
    if isinstance(op, FusedTransformerOperator):
        # a fused chain is as good as its worst step
        return worst(classify(s) for s, _ in op.steps)
    if isinstance(op, GatherTransformerOperator):
        return TRACEABLE  # a structural zip
    if getattr(op, "forward", None) is None:
        return OPAQUE
    if getattr(op, "batch_coupled", False):
        return BATCH_COUPLED
    return TRACEABLE
