"""CheckReport: the product of one static pipeline check (port of
``keystone_tpu/check/report.py``).

``check_graph`` runs the three layers (abstract spec interpretation,
traceability classification, segment planning) over a raw or fitted
pipeline graph, executing zero chunks and zero samples, and returns a
:class:`CheckReport` that its consumers read:

* ``Pipeline.check()`` / ``FittedPipeline.check()`` return it (and record
  a ``check.report`` trace span);
* ``FittedPipeline.compile`` and ``untraceable_nodes`` take its verdicts;
* ``ServingEngine`` and its ``swap`` validate a pipeline with
  :meth:`CheckReport.require_contract`;
* the ``--check`` command-line mode renders :meth:`CheckReport.render`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import lattice
from .abstract import (
    Spec,
    SpecTuple,
    infer_specs,
    spec_from_item,
)
from .errors import ContractMismatchError
from .segments import Segment, plan_segments

logger = logging.getLogger(__name__)


@dataclass
class CheckReport:
    """Everything the static checker proved about one pipeline graph."""

    #: per-node abstract output value (Spec | SpecTuple | None=unknown)
    specs: Dict[Any, Any]
    #: per-node lattice verdict (see :mod:`keystone_tpu_torch.check.lattice`)
    verdicts: Dict[Any, str]
    #: per-node operator label (for attribution without the graph)
    labels: Dict[Any, str]
    #: maximal traceable segments between materialization barriers
    segments: List[Segment]
    #: barrier node -> reason
    barriers: Dict[Any, str]
    #: nodes whose operator couples rows (the ``batch_coupled`` attribute,
    #: fused steps included), apart from the verdict: a coupled node with
    #: a host sync classifies ``host_callback`` but must still never be
    #: served through a pad-and-slice path
    coupled_nodes: List[Any] = field(default_factory=list)
    #: the graph's serving input contract: per-item shape/dtype at the
    #: unbound source (None when not statically known)
    datum_shape: Optional[Tuple[int, ...]] = None
    datum_dtype: Optional[str] = None
    #: spec of the sink value, when derivable
    sink_spec: Any = None
    #: node ids in topological order (reporting convenience)
    order: List[Any] = field(default_factory=list)

    # -- verdict projections -------------------------------------------

    @property
    def segment_count(self) -> int:
        return len(self.segments)

    def nodes_with_verdict(self, *verdicts: str) -> List[Any]:
        return [
            n for n in self.order if self.verdicts.get(n) in verdicts
        ]

    def untraceable_nodes(self) -> List[Any]:
        """Nodes that block building the whole-chain function (the
        ``NotTraceableError`` set)."""
        return [
            n for n in self.order
            if lattice.blocks_jit(self.verdicts.get(n, lattice.OPAQUE))
        ]

    def untraceable_labels(self) -> List[str]:
        return [self.labels[n] for n in self.untraceable_nodes()]

    def batch_coupled_labels(self) -> List[str]:
        return [self.labels[n] for n in self.coupled_nodes]

    @property
    def jit_compilable(self) -> bool:
        return not self.untraceable_nodes()

    @property
    def exportable(self) -> bool:
        """Can the whole chain be exported as one artifact?"""
        return not any(
            lattice.blocks_export(v) for v in self.verdicts.values()
        )

    def verdict_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.verdicts.values():
            out[v] = out.get(v, 0) + 1
        return out

    # -- serving-contract validation ------------------------------------

    def require_contract(
        self,
        datum_shape: Optional[Sequence[int]],
        dtype: Any,
        *,
        verb: str = "serve",
    ) -> None:
        """Validate this pipeline against a live serving contract.

        Raises a node-attributed :class:`ContractMismatchError` when the
        pipeline is batch-coupled (bucket padding would corrupt its
        whole-batch statistics) or its statically-known datum shape/dtype
        disagrees with the live engine's. Unknown facts never fail: the
        checker has no false positives."""
        import numpy as np

        coupled = self.coupled_nodes
        if coupled:
            n = coupled[0]
            raise ContractMismatchError(
                f"cannot {verb} a batch-coupled chain: bucket padding "
                "would corrupt its whole-batch statistics — use "
                "FittedPipeline.apply() instead",
                node=n, label=self.labels.get(n),
            )
        if (
            self.datum_shape is not None
            and datum_shape is not None
            and tuple(self.datum_shape) != tuple(datum_shape)
        ):
            raise ContractMismatchError(
                f"datum shape {tuple(self.datum_shape)} does not match "
                f"the live contract {tuple(datum_shape)} — a re-shaped "
                f"model needs a new engine, not a {verb}",
                label="source",
            )
        if (
            self.datum_dtype is not None
            and dtype is not None
            and np.dtype(self.datum_dtype) != np.dtype(dtype)
        ):
            raise ContractMismatchError(
                f"datum dtype {np.dtype(self.datum_dtype)} does not "
                f"match the live contract {np.dtype(dtype)} — batches "
                f"would silently cast; a re-typed model needs a new "
                f"engine, not a {verb}",
                label="source",
            )

    # -- rendering ------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        counts = self.verdict_counts()
        return {
            "nodes": len(self.order),
            "segments": self.segment_count,
            "barriers": len(self.barriers),
            "verdicts": counts,
            "jit_compilable": self.jit_compilable,
            "exportable": self.exportable,
            "datum_shape": (
                list(self.datum_shape)
                if self.datum_shape is not None else None
            ),
            "datum_dtype": self.datum_dtype,
        }

    def render(self) -> str:
        """Human-readable multi-line report (the --check CLI output)."""
        lines = ["static check report", "===================="]
        s = self.summary()
        lines.append(
            f"nodes: {s['nodes']}  segments: {s['segments']}  "
            f"barriers: {s['barriers']}  "
            f"jit: {'yes' if s['jit_compilable'] else 'NO'}  "
            f"export: {'yes' if s['exportable'] else 'NO'}"
        )
        if self.datum_shape is not None:
            lines.append(
                f"datum contract: {tuple(self.datum_shape)} "
                f"{self.datum_dtype or '?'}"
            )
        lines.append("")
        for n in self.order:
            spec = self.specs.get(n)
            if isinstance(spec, Spec):
                sdesc = f"{spec.display_shape()} {spec.dtype}"
            elif isinstance(spec, SpecTuple):
                sdesc = f"tuple[{len(spec.elems)}]"
            elif spec is None:
                sdesc = "?"
            else:
                sdesc = type(spec).__name__
            verdict = self.verdicts.get(n, "-")
            barrier = self.barriers.get(n)
            extra = f"  BARRIER({barrier})" if barrier else ""
            lines.append(
                f"  {str(n):<12} {self.labels.get(n, '?')[:48]:<48} "
                f"{verdict:<14} {sdesc}{extra}"
            )
        lines.append("")
        for seg in self.segments:
            size = (
                f"{seg.est_item_bytes}B/item"
                if seg.est_item_bytes is not None else "?B/item"
            )
            lines.append(
                f"  segment {seg.index}: {len(seg)} node(s), "
                f"{len(seg.inputs)} input(s), "
                f"{len(seg.outputs)} output(s), {size}"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


def check_graph(
    graph: Any,
    *,
    source: Any = None,
    datum_spec: Optional[tuple] = None,
    cost_estimator: Any = None,
) -> CheckReport:
    """Run the full static check over ``graph``.

    ``datum_spec`` is the per-item ``(shape, dtype)`` of data fed at the
    graph's unbound ``source`` (the fit-time hint); None leaves the
    source spec unknown. Raises :class:`PipelineCheckError` on a defect
    proven without running; returns the report otherwise. Executes
    nothing: no chunks, no samples, no captures, no kernels."""
    from ..workflow import analysis
    from ..workflow.graph import NodeId

    source_specs = {}
    if source is not None and datum_spec is not None:
        source_specs[source] = spec_from_item(tuple(datum_spec))

    values, verdicts = infer_specs(graph, source_specs)
    order = [
        n for n in analysis.linearize(graph)
        if isinstance(n, NodeId) and n in graph.operators
    ]
    labels = {
        n: getattr(graph.get_operator(n), "label", type(
            graph.get_operator(n)
        ).__name__)
        for n in order
    }
    segments, barriers = plan_segments(
        graph, verdicts, values, cost_estimator=cost_estimator
    )
    # coupling by the attribute, not the verdict: a coupled node with a
    # worse trait (a host sync, state) is still refused by every
    # pad-and-slice serving path
    coupled_nodes = [
        n for n in order
        if getattr(graph.get_operator(n), "batch_coupled", False)
    ]

    sink_spec = None
    for sink in sorted(graph.sinks):
        sink_spec = values.get(sink)
        break

    datum_shape = datum_dtype = None
    if datum_spec is not None:
        datum_shape = tuple(datum_spec[0])
        datum_dtype = str(datum_spec[1])

    return CheckReport(
        specs=values,
        verdicts=verdicts,
        labels=labels,
        segments=segments,
        barriers=barriers,
        coupled_nodes=coupled_nodes,
        datum_shape=datum_shape,
        datum_dtype=datum_dtype,
        sink_spec=sink_spec,
        order=order,
    )
