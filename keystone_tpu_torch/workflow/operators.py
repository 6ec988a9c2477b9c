"""Untyped execution units that live at graph nodes (port of
``keystone_tpu/workflow/operators.py``; parity: ``workflow/Operator.scala``).

Each operator's ``execute`` consumes the lazy :class:`Expression`s of its
dependencies and returns a lazy expression of its own result, so graph
execution builds a web of thunks that the executor memoizes.
"""

from __future__ import annotations

import hashlib
from typing import Any, Sequence

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..data.dataset import Dataset
from .expressions import (
    DatasetExpression,
    DatumExpression,
    Expression,
    TransformerExpression,
)


class Operator:
    """Base of all graph operators. Identity-based equality (two separately
    constructed operators are distinct nodes even with equal parameters);
    the CSE rule merges structurally-equal ones via :func:`structural_key`."""

    @property
    def label(self) -> str:
        return type(self).__name__

    def execute(self, deps: Sequence[Expression]) -> Expression:
        raise NotImplementedError


class _Uncanonical(Exception):
    """Raised when an operator's state has no content-based canonical form."""


#: tensor → (its ``_version`` when digested, digest). Parameters live on
#: the device, where a digest costs a copy to the host and a sync; every
#: optimize pass (each ``and_then`` splice, each ``fit`` and ``apply``)
#: canonicalizes every operator again, so each tensor is digested once
#: until it is written in place.
_TENSOR_DIGESTS = WeakIdKeyDictionary()


def _tensor_digest(t: torch.Tensor) -> tuple:
    hit = _TENSOR_DIGESTS.get(t)
    if hit is not None and hit[0] == t._version:
        return hit[1]
    raw = t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy()
    digest = ("tensor", tuple(t.shape), str(t.dtype), hashlib.sha1(raw.tobytes()).hexdigest())
    _TENSOR_DIGESTS[t] = (t._version, digest)
    return digest


def _canon(v):
    """Canonicalize one parameter value into a hashable content digest."""
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        return v
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, torch.Tensor):
        # by content wherever it lives: equal parameters on the card and on
        # the CPU canonicalize alike, so CSE merges the same nodes on both
        return _tensor_digest(v)
    if isinstance(v, np.ndarray):
        return (
            "ndarray", v.shape, str(v.dtype),
            hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest(),
        )
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_canon(x) for x in v))
    if isinstance(v, dict):
        return ("dict", tuple(sorted((k, _canon(x)) for k, x in v.items())))
    if isinstance(v, (set, frozenset)):
        return ("set", tuple(sorted(map(repr, v))))
    # Callables, datasets, arbitrary objects: two separately constructed
    # values cannot be proven equal — bail to identity.
    raise _Uncanonical(type(v).__name__)


def structural_key(op: "Operator"):
    """Content-based identity for CSE (parity: Scala case-class equality in
    ``EquivalentNodeMergeRule.scala:13``).

    Returns ``(type, canonical-params)`` when every attribute of the
    operator canonicalizes (scalars, strings, tuples, tensors and numpy
    arrays by content digest). Operators defining their own ``__eq__``
    (Dataset/Datum leaves) and operators holding closures or arbitrary
    objects fall back to the operator instance itself, i.e. object
    identity — conservative, never merges wrongly."""
    cls = type(op)
    if cls.__eq__ is not object.__eq__:
        return op  # operator defines its own (payload-identity) equality
    try:
        return (cls, _canon(vars(op)))
    except _Uncanonical:
        return op


class Cacheable:
    """Marker mixin: nodes of this operator are saveable prefixes — the
    executor persists their result in the global state table."""


def _origin(data: Any) -> Any:
    """What a data leaf is identified by: the payload of a Dataset, else
    the object the caller passed. ``Dataset.of(ndarray)`` makes a fresh
    tensor on each call, so keying on the wrapped payload would make two
    applications of one numpy array two leaves (and refit)."""
    return data.payload if isinstance(data, Dataset) else data


class DatasetOperator(Operator):
    """A leaf wrapping an already-materialized dataset."""

    def __init__(self, data: Any):
        self.dataset = Dataset.of(data)
        self.origin = _origin(data)

    # Two DatasetOperators over the same caller object are the same logical
    # leaf; this is what lets prefixes from separate with_data() calls on
    # the same data hit the fit-once state table.
    def __eq__(self, other: object) -> bool:
        return isinstance(other, DatasetOperator) and other.origin is self.origin

    def __hash__(self) -> int:
        return hash(("DatasetOperator", id(self.origin)))

    @property
    def label(self) -> str:
        return f"Dataset[n={len(self.dataset)}]"

    def execute(self, deps: Sequence[Expression]) -> DatasetExpression:
        if deps:
            raise ValueError("DatasetOperator takes no dependencies")
        return DatasetExpression.now(self.dataset)


class DatumOperator(Operator):
    """A leaf wrapping a single datum."""

    def __init__(self, datum: Any):
        self.datum = datum

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DatumOperator) and other.datum is self.datum

    def __hash__(self) -> int:
        return hash(("DatumOperator", id(self.datum)))

    @property
    def label(self) -> str:
        return f"Datum[{type(self.datum).__name__}]"

    def execute(self, deps: Sequence[Expression]) -> DatumExpression:
        if deps:
            raise ValueError("DatumOperator takes no dependencies")
        return DatumExpression.now(self.datum)


class TransformerOperator(Operator):
    """An operator that maps inputs to outputs, itself a first-class value
    (it can flow through the graph as the result of an estimator fit)."""

    def single_transform(self, inputs: Sequence[DatumExpression]) -> Any:
        raise NotImplementedError

    def batch_transform(self, inputs: Sequence[DatasetExpression]) -> Dataset:
        raise NotImplementedError

    def execute(self, deps: Sequence[Expression]) -> Expression:
        if not deps:
            raise ValueError("TransformerOperator requires at least one dependency")
        if all(isinstance(d, DatasetExpression) for d in deps):
            return DatasetExpression(lambda: self.batch_transform(deps))
        if all(isinstance(d, DatumExpression) for d in deps):
            return DatumExpression(lambda: self.single_transform(deps))
        raise ValueError("TransformerOperator dependencies must be all-dataset or all-datum")


class EstimatorOperator(Operator):
    """An operator whose result is a fitted :class:`TransformerOperator`.
    Subclasses implement ``fit(*datasets)``."""

    def fit(self, *datasets: Dataset) -> TransformerOperator:
        raise NotImplementedError

    def fit_expressions(self, inputs: Sequence[DatasetExpression]) -> TransformerOperator:
        return self.fit(*[d.get() for d in inputs])

    def execute(self, deps: Sequence[Expression]) -> TransformerExpression:
        for d in deps:
            if not isinstance(d, DatasetExpression):
                raise ValueError("EstimatorOperator dependencies must be datasets")
        return TransformerExpression(lambda: self.fit_expressions(deps))


class DelegatingOperator(Operator):
    """Applies the transformer produced by its first dependency to the rest
    (parity: ``Operator.scala:135-164``). This is the node an estimator's
    ``with_data`` splices in so the fitted model can be applied downstream."""

    def execute(self, deps: Sequence[Expression]) -> Expression:
        if len(deps) < 2:
            raise ValueError("DelegatingOperator requires a transformer dep plus data deps")
        t_expr, *data = deps
        if not isinstance(t_expr, TransformerExpression):
            raise ValueError("first dependency must be a TransformerExpression")
        if all(isinstance(d, DatasetExpression) for d in data):
            return DatasetExpression(lambda: t_expr.get().batch_transform(data))
        if all(isinstance(d, DatumExpression) for d in data):
            return DatumExpression(lambda: t_expr.get().single_transform(data))
        raise ValueError("DelegatingOperator data dependencies must be all-dataset or all-datum")


class ExpressionOperator(Operator):
    """A leaf wrapping an already-computed expression — how saved state is
    spliced back into a graph (parity: ``Operator.scala:172``)."""

    def __init__(self, expression: Expression):
        self.expression = expression

    @property
    def label(self) -> str:
        return f"Saved[{type(self.expression).__name__}]"

    def execute(self, deps: Sequence[Expression]) -> Expression:
        return self.expression


class GatherTransformerOperator(TransformerOperator):
    """Zips N dependency branches into one per-item sequence (parity:
    ``GatherTransformerOperator.scala:9``). Batched branches stay a tuple
    payload, which ``VectorCombiner`` joins into one feature matrix."""

    #: item i of the output is item i of each branch
    row_local = True

    def single_transform(self, inputs: Sequence[DatumExpression]) -> Any:
        return [d.get() for d in inputs]

    def batch_transform(self, inputs: Sequence[DatasetExpression]) -> Dataset:
        datasets = [d.get() for d in inputs]
        if any(ds.is_chunked for ds in datasets):
            # chunked branches zip per chunk and stay lazy; a materialized
            # branch is sliced at the chunk bounds as the scan runs
            from ..data.chunked import align_and_zip

            return align_and_zip(datasets)
        if all(ds.is_batched for ds in datasets):
            return Dataset(tuple(ds.payload for ds in datasets))
        first, *rest = datasets
        return first.zip(*rest)
