"""Abstract interpretation of a pipeline graph: shape and dtype propagation
that runs nothing (port of ``keystone_tpu/check/abstract.py``).

Specs start at the data leaves (an in-memory tensor reports its shape; a
chunked source reports the per-item spec its constructor recorded; the
pipeline's unbound source takes the fit-time datum hint) and flow through
every node:

* a node with a ``forward`` is run on fake tensors
  (``torch._subclasses.fake_tensor.FakeTensorMode``): the tensors carry
  shape, dtype and device and no data, so nothing computes, no kernel
  launches and no device memory is allocated. A fitted parameter (a real
  tensor, on the card or not) enters the fake mode by conversion, not by
  copy. This takes the place of the JAX package's ``jax.eval_shape``;
* an operator whose apply cannot be run abstractly declares
  ``out_spec(*in_item_specs)`` instead (host featurizers, per-item nodes);
* an estimator declares ``fitted_out_spec(fit_item_specs,
  apply_item_specs)``: the per-item spec of its fitted transformer's
  output, which the delegating node applies on the serve path.

A node whose inputs are known and whose evaluation or declaration rejects
them raises a node-attributed :class:`PipelineCheckError`. A node that
needs concrete values (a data-dependent shape, a host read such as
``.item()``, an operator fake tensors do not support) gives an unknown
spec instead, and unknown inputs propagate as unknown: the checker never
guesses, so it has no false positives.

The leading (batch) dimension is symbolic: a spec seeded per item gets the
:data:`SYMBOLIC_LEAD` placeholder, and an output whose lead equals it
stays symbolic.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import lattice
from .errors import PipelineCheckError

logger = logging.getLogger(__name__)

#: placeholder extent of the symbolic batch dimension: an unlikely prime, so
#: a real dimension is never taken for it (the JAX package's value, so the
#: two packages' reports compare)
SYMBOLIC_LEAD = 11939

#: ``out_spec(*in_item_specs) -> item_spec``, where an item spec is
#: ``(shape_tuple, dtype_str)`` (numpy's dtype spelling), a tuple of item
#: specs, or None for unknown; ``fitted_out_spec(fit_item_specs,
#: apply_item_specs) -> item_spec`` on estimators. A declaration returns
#: None for unknown inputs it needs; raising means "these known inputs are
#: incompatible" and becomes a node-attributed PipelineCheckError.
OUT_SPEC_PROTOCOL = "out_spec"
FITTED_OUT_SPEC_PROTOCOL = "fitted_out_spec"


# ---------------------------------------------------------------------------
# abstract values
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Spec:
    """One array-shaped abstract value: the full shape (lead included) and
    the dtype (numpy's spelling). ``sym`` marks the lead as the symbolic
    batch placeholder; ``chunked`` marks a value that flows chunk by chunk
    from an out-of-core scan."""

    shape: Tuple[int, ...]
    dtype: str
    sym: bool = False
    chunked: bool = False

    @property
    def item_shape(self) -> Tuple[int, ...]:
        return self.shape[1:]

    @property
    def item(self) -> Tuple[Tuple[int, ...], str]:
        return (self.item_shape, self.dtype)

    def item_bytes(self) -> Optional[int]:
        """Bytes of one item of this value, or None when not derivable."""
        try:
            n = 1
            for d in self.item_shape:
                n *= int(d)
            return n * np.dtype(self.dtype).itemsize
        except TypeError:
            logger.debug("item_bytes failed for %s", self, exc_info=True)
            return None

    def display_shape(self) -> Tuple[Optional[int], ...]:
        """The shape with a symbolic lead shown as None."""
        if self.sym and self.shape:
            return (None, *self.shape[1:])
        return self.shape


@dataclass(frozen=True)
class SpecTuple:
    """A tuple-of-arrays abstract value (a gather's output, split blocks)."""

    elems: Tuple[Any, ...]  # Spec | SpecTuple | None

    @property
    def chunked(self) -> bool:
        return any(getattr(e, "chunked", False) for e in self.elems)


@dataclass(frozen=True)
class EstimatorSpec:
    """The abstract value of an estimator node: a transformer to be. The
    operator rides along for its ``fitted_out_spec``."""

    op: Any


AbstractValue = Any  # Spec | SpecTuple | EstimatorSpec | None (unknown)


# ---------------------------------------------------------------------------
# building specs
# ---------------------------------------------------------------------------


def _dtype_name(dtype: Any) -> str:
    """numpy's spelling of a torch or numpy dtype (``'float32'``)."""
    return str(dtype).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"no torch dtype {name!r}")
    return dtype


def spec_of_array(value: Any, *, chunked: bool = False) -> Optional[Spec]:
    """The spec of an in-memory tensor or numpy array, else None. Reads
    only ``shape`` and ``dtype``."""
    if not isinstance(value, (torch.Tensor, np.ndarray)):
        return None
    return Spec(tuple(int(d) for d in value.shape), _dtype_name(value.dtype),
                chunked=chunked)


def spec_from_item(item: Any, *, chunked: bool = False) -> Optional[AbstractValue]:
    """A per-item declaration ``(shape, dtype)`` (or a tuple of them, or
    None) as a batched abstract value with a symbolic lead."""
    if item is None:
        return None
    if isinstance(item, Spec):
        return item
    if (isinstance(item, tuple) and len(item) == 2 and isinstance(item[1], str)
            and isinstance(item[0], (tuple, list))
            and all(isinstance(d, int) for d in item[0])):
        return Spec((SYMBOLIC_LEAD, *tuple(item[0])), item[1], sym=True, chunked=chunked)
    if isinstance(item, (tuple, list)):
        return SpecTuple(tuple(spec_from_item(e, chunked=chunked) for e in item))
    return None


def _to_item(av: AbstractValue) -> Any:
    """An abstract value as the per-item form a declaration takes."""
    if isinstance(av, Spec):
        return av.item
    if isinstance(av, SpecTuple):
        return tuple(_to_item(e) for e in av.elems)
    return None


def _fully_known(av: AbstractValue) -> bool:
    if isinstance(av, Spec):
        return True
    if isinstance(av, SpecTuple):
        return all(_fully_known(e) for e in av.elems)
    return False


def _to_fake(av: AbstractValue, device: torch.device) -> Any:
    """Fake tensors of a known abstract value (call inside the fake mode)."""
    if isinstance(av, Spec):
        return torch.empty(av.shape, dtype=_torch_dtype(av.dtype), device=device)
    if isinstance(av, SpecTuple):
        return tuple(_to_fake(e, device) for e in av.elems)
    raise TypeError(f"not a concrete spec: {av!r}")


def _from_fake(out: Any, sym_lead: bool, chunked: bool) -> AbstractValue:
    """A forward's fake result as an abstract value."""
    if isinstance(out, torch.Tensor):
        shape = tuple(int(d) for d in out.shape)
        sym = bool(sym_lead and shape and shape[0] == SYMBOLIC_LEAD)
        return Spec(shape, _dtype_name(out.dtype), sym=sym, chunked=chunked)
    if isinstance(out, (tuple, list)):
        return SpecTuple(tuple(_from_fake(e, sym_lead, chunked) for e in out))
    return None


def _fake_device(out: Any) -> Optional[torch.device]:
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, (tuple, list)):
        for e in out:
            found = _fake_device(e)
            if found is not None:
                return found
    return None


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------


def _leaf_value(op: Any) -> Tuple[AbstractValue, Optional[torch.device]]:
    """The abstract value and device of a data leaf, by reading metadata."""
    from ..workflow.operators import DatasetOperator

    if not isinstance(op, DatasetOperator):
        # a single datum goes through single_transform, not forward: unknown
        return None, None
    ds = op.dataset
    if ds.is_chunked:
        return spec_from_item(ds.item_spec, chunked=True), None
    if not ds.is_batched:
        # an item list may be ragged: unknown
        return None, None
    payload = ds.payload
    if isinstance(payload, tuple):
        return (SpecTuple(tuple(spec_of_array(p) for p in payload)),
                _fake_device(payload))
    return spec_of_array(payload), _fake_device(payload)


def leaf_is_chunked(op: Any) -> bool:
    from ..workflow.operators import DatasetOperator

    return isinstance(op, DatasetOperator) and op.dataset.is_chunked


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


def _concretization_errors() -> tuple:
    """The exceptions that mean "this forward needs concrete values" under
    fake tensors: a data-dependent output or shape (``.item()``,
    ``nonzero``), an operator without a fake implementation."""
    from torch._subclasses import fake_tensor

    names = ("DataDependentOutputException", "DynamicOutputShapeException",
             "UnsupportedOperatorException", "UnsupportedFakeTensorException")
    return tuple(getattr(fake_tensor, n) for n in names if hasattr(fake_tensor, n))


class _QuietFakeFailures(logging.Filter):
    """Drops the fake-tensor module's error log of a failed meta kernel
    while this thread runs a check: a rejected input is the check's
    finding, raised as a ``PipelineCheckError``, not a fault to log."""

    local = threading.local()

    def filter(self, record: logging.LogRecord) -> bool:
        return not getattr(self.local, "active", False)


_QUIET = _QuietFakeFailures()
logging.getLogger("torch._subclasses.fake_tensor").addFilter(_QUIET)


#: products and convolutions whose real kernels refuse operands of two
#: dtypes, where the fake tensors' meta kernels do not check
_SAME_DTYPE_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
                             "vdot", "convolution", "_convolution", "_cdist_forward"})


def _abstract_only(fake_mode):
    """A dispatch mode, entered inside ``fake_mode``, that sees every op
    first and

    * converts each real tensor argument (a fitted parameter, a constant a
      node built from host data) to a fake tensor of ``fake_mode`` before
      the op runs: the fake mode alone runs an op whose inputs are all real
      on the real data, on the card for a card parameter;
    * raises as the real kernel would when a product or convolution gets
      tensors of two dtypes (float64 data into float32 weights, uint8
      images into a float filter bank), which the meta kernels let pass."""
    from torch.utils import _pytree as pytree
    from torch._subclasses.fake_tensor import is_fake
    from torch.utils._python_dispatch import TorchDispatchMode

    lift = {torch.ops.aten.lift_fresh.default, torch.ops.aten.lift_fresh_copy.default}

    def fake(t):
        return t if is_fake(t) else fake_mode.from_tensor(t)

    class AbstractOnly(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func not in lift:
                args, kwargs = pytree.tree_map_only(torch.Tensor, fake, (args, kwargs))
            if func.overloadpacket.__name__ in _SAME_DTYPE_OPS:
                dtypes = {a.dtype for a in args if isinstance(a, torch.Tensor)}
                if len(dtypes) > 1:
                    raise RuntimeError(f"{func.overloadpacket.__name__} of operands of "
                                       f"dtypes {sorted(str(d) for d in dtypes)}")
            return func(*args, **kwargs)

    return AbstractOnly()


def _fake_mode():
    """A ``FakeTensorMode`` that keeps no constants. A plain one keeps the
    real value of a tensor built from Python data (``torch.tensor([...])``)
    and runs ops whose inputs are all such constants for real, on the card
    when they move there: a filter bank's taps would be copied and
    multiplied on the card by a check."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class NoConstants(FakeTensorMode):
        def may_turn_const(self, t) -> bool:
            return False

    return NoConstants(allow_non_fake_inputs=True)


def graph_device(graph: Any) -> torch.device:
    """Where data fed at the graph's source goes: where its parameters and
    data live (the first tensor found), the CPU when it holds none."""
    from ..workflow.pipeline import _param_device

    return _param_device(graph)


def infer_specs(graph: Any, source_specs: Optional[Dict[Any, AbstractValue]] = None,
                verdicts: Optional[Dict[Any, str]] = None
                ) -> Tuple[Dict[Any, AbstractValue], Dict[Any, str]]:
    """Propagate abstract values through ``graph`` in topological order.

    Returns ``(values, verdicts)``: per-graph-id abstract values and the
    per-node verdicts (a traceable node that needs concrete values is
    downgraded to opaque). Raises :class:`PipelineCheckError` on a proven
    incompatibility: a node whose inputs are fully known rejecting them, or
    a batch-coupled node fed a chunked stream."""
    from ..workflow import analysis
    from ..workflow.graph import NodeId, SourceId
    from ..workflow.operators import (
        DatasetOperator,
        DatumOperator,
        DelegatingOperator,
        EstimatorOperator,
        ExpressionOperator,
        GatherTransformerOperator,
    )

    values: Dict[Any, AbstractValue] = {}
    devices: Dict[Any, Optional[torch.device]] = {}
    chunked_flow: Dict[Any, bool] = {}
    verdicts = dict(verdicts or {})
    default_device = graph_device(graph)
    for src, av in (source_specs or {}).items():
        values[src] = av
        chunked_flow[src] = bool(getattr(av, "chunked", False))

    conc_errors = _concretization_errors()
    # one mode for the whole check: a real parameter is converted to a fake
    # tensor once (metadata only) and reused by every node that reads it
    fake_mode = _fake_mode()

    for gid in analysis.linearize(graph):
        if isinstance(gid, SourceId):
            values.setdefault(gid, None)
            chunked_flow.setdefault(gid, False)
            continue
        if not isinstance(gid, NodeId) or gid not in graph.operators:
            continue
        op = graph.get_operator(gid)
        deps = graph.get_dependencies(gid)
        dep_vals = [values.get(d) for d in deps]
        dep_chunked = any(chunked_flow.get(d, False) for d in deps)
        label = getattr(op, "label", type(op).__name__)

        if gid not in verdicts:
            verdicts[gid] = lattice.classify(op)
        verdict = verdicts[gid]

        if not deps and isinstance(op, (DatasetOperator, DatumOperator)):
            values[gid], devices[gid] = _leaf_value(op)
            chunked_flow[gid] = leaf_is_chunked(op)
            continue

        # a Cacher materializes: below it the stream is no longer chunked
        out_chunked = dep_chunked and type(op).__name__ != "Cacher"

        # a batch-coupled node on an out-of-core stream would compute its
        # statistics per chunk; the attribute decides, not the verdict
        if getattr(op, "batch_coupled", False) and dep_chunked:
            raise PipelineCheckError(
                "batch-coupled node consumes an out-of-core chunked stream: its "
                "whole-batch statistics would be computed per chunk — materialize "
                "upstream (e.g. .cache()) first",
                node=gid, label=label,
            )

        if isinstance(op, EstimatorOperator) and not isinstance(op, DelegatingOperator):
            values[gid] = EstimatorSpec(op)
            chunked_flow[gid] = False
            continue

        if isinstance(op, DelegatingOperator):
            est, data_vals = dep_vals[0], dep_vals[1:]
            out = None
            if isinstance(est, EstimatorSpec):
                decl = getattr(est.op, FITTED_OUT_SPEC_PROTOCOL, None)
                if decl is not None:
                    fit_in = [_to_item(values.get(d)) for d in graph.get_dependencies(deps[0])]
                    apply_in = [_to_item(v) for v in data_vals]
                    try:
                        out = spec_from_item(decl(fit_in, apply_in), chunked=out_chunked)
                    except PipelineCheckError:
                        raise
                    except Exception as e:
                        raise PipelineCheckError(
                            f"declared fitted_out_spec of {type(est.op).__name__} "
                            f"rejects the input spec: {e}",
                            node=gid, label=label,
                        ) from e
            values[gid] = out
            devices[gid] = devices.get(deps[1]) if len(deps) > 1 else None
            chunked_flow[gid] = out_chunked
            continue

        if isinstance(op, ExpressionOperator):
            expr = op.expression
            value = expr._value if getattr(expr, "computed", False) else None
            values[gid] = spec_of_array(value)
            devices[gid] = _fake_device(value)
            chunked_flow[gid] = False
            continue

        if isinstance(op, GatherTransformerOperator):
            values[gid] = (SpecTuple(tuple(dep_vals))
                           if all(v is not None for v in dep_vals) else None)
            devices[gid] = next((devices.get(d) for d in deps if devices.get(d)), None)
            chunked_flow[gid] = out_chunked
            continue

        # a declared spec wins for nodes whose apply cannot run abstractly,
        # even with inputs partly unknown (it may not need them)
        decl = getattr(op, OUT_SPEC_PROTOCOL, None)
        if decl is not None:
            try:
                out = decl(*[_to_item(v) for v in dep_vals])
            except PipelineCheckError:
                raise
            except Exception as e:
                raise PipelineCheckError(
                    f"declared out_spec rejects the input spec: {e}",
                    node=gid, label=label,
                ) from e
            values[gid] = spec_from_item(out, chunked=out_chunked)
            devices[gid] = next((devices.get(d) for d in deps if devices.get(d)), None)
            chunked_flow[gid] = out_chunked
            continue

        fn = getattr(op, "forward", None)
        if fn is None or not all(_fully_known(v) for v in dep_vals):
            values[gid] = None
            chunked_flow[gid] = out_chunked
            continue

        sym_lead = any(
            getattr(v, "sym", False)
            or (isinstance(v, SpecTuple) and any(getattr(e, "sym", False) for e in v.elems))
            for v in dep_vals
        )
        _QUIET.local.active = True
        try:
            with fake_mode, _abstract_only(fake_mode), torch.no_grad():
                args = [_to_fake(v, devices.get(d) or default_device)
                        for v, d in zip(dep_vals, deps)]
                out = fn(*args)
        except conc_errors:
            # the node needs concrete values, so it cannot be captured either
            logger.warning(
                "check: %s claimed %s but cannot be evaluated abstractly; "
                "downgrading to opaque", label, verdict, exc_info=True,
            )
            verdicts[gid] = lattice.OPAQUE
            values[gid] = None
            chunked_flow[gid] = out_chunked
            continue
        except Exception as e:
            if verdict in (lattice.TRACEABLE, lattice.BATCH_COUPLED):
                in_desc = ", ".join(
                    str(v.display_shape() if isinstance(v, Spec) else _to_item(v))
                    + (f":{v.dtype}" if isinstance(v, Spec) else "")
                    for v in dep_vals
                )
                raise PipelineCheckError(
                    f"node rejects input spec [{in_desc}]: {e}", node=gid, label=label,
                ) from e
            # a node with a host sync or Python-side state: its abstract
            # evaluation is evidence, not a contract — unknown, not an error
            logger.debug("check: abstract evaluation of %s (%s) failed; spec unknown",
                         label, verdict, exc_info=True)
            values[gid] = None
            chunked_flow[gid] = out_chunked
            continue
        finally:
            _QUIET.local.active = False
        values[gid] = _from_fake(out, sym_lead, out_chunked)
        devices[gid] = _fake_device(out)
        chunked_flow[gid] = out_chunked

    for sink, dep in graph.sink_dependencies.items():
        values[sink] = values.get(dep)
        chunked_flow[sink] = chunked_flow.get(dep, False)

    return values, verdicts
