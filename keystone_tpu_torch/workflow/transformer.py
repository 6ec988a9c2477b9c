"""Typed Transformer / Estimator / LabelEstimator (port of
``keystone_tpu/workflow/transformer.py``; parity: ``workflow/Transformer.scala``,
``Estimator.scala``, ``LabelEstimator.scala``).

A Transformer is at once a chainable pipeline stage and the untyped
operator that runs at its node, as in the reference. Numeric nodes
implement ``forward(X)``: a function of the stacked batch tensor (leading
dimension = items) or of a tuple payload. ``forward`` is what fusion runs;
``apply(x)`` of one item is ``forward(x[None])[0]`` unless a node gives its
own. ``row_local`` marks the nodes whose output row i depends on input row
i alone; a fused group of them, or one of them alone, runs in row
chunks.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from ..data.dataset import Dataset, map_leaves
from . import fusion
from .expressions import DatasetExpression, DatumExpression
from .graph import Graph
from .operators import DelegatingOperator, EstimatorOperator, TransformerOperator
from .pipeline import Chainable, Pipeline, attach_data

__all__ = [
    "Transformer",
    "Estimator",
    "LabelEstimator",
    "FunctionNode",
    "Identity",
]


def _one_row(x: Any) -> Any:
    """An item as a batch of one: a tensor gets a leading dimension, and a
    gathered item (a list or tuple of parts) becomes a tuple payload."""
    if isinstance(x, (list, tuple)):
        return tuple(_one_row(p) for p in x)
    return x[None]


class Transformer(Chainable, TransformerOperator):
    """A deterministic per-item function, applied to whole batches.

    Implement at least one of:
      * ``forward(X)`` — torch over the stacked batch (preferred), or
      * ``apply(x)`` — per-item function.
    """

    #: override in subclasses: a function of the whole batch
    forward: Optional[Callable] = None

    #: output row i depends on input row i alone
    row_local: bool = False

    #: ``forward`` couples rows (batch statistics): such a node refuses a
    #: chunked input, whose chunks would each get their own statistics
    batch_coupled: bool = False

    #: the host sync in ``forward`` is the node's purpose, a per-batch host
    #: step (as a ``jax.pure_callback`` is in the JAX package): the serving
    #: tiers run a chain that holds one eagerly, since a CUDA graph would
    #: run the step once, at capture (``serving/replica.py``)
    host_step: bool = False

    def row_work_bytes(self, *rows: Any) -> int:
        """Bytes that ``forward`` allocates for one row (``rows``: each
        input cut to its first row): its output and its temporaries. 0, the
        default, for nodes whose rows are small; a node with large rows
        (image descriptors, posteriors) says how large, and the row chunks
        it runs in are cut to fit ``fusion.CHUNK_BYTES``."""
        return 0

    def apply(self, x: Any) -> Any:
        if self.forward is not None:
            return map_leaves(lambda t: t[0], self.forward(_one_row(x)))
        raise NotImplementedError(f"{type(self).__name__} implements neither apply nor forward")

    def apply_batch(self, data: Any) -> Dataset:
        data = Dataset.of(data)
        if data.is_chunked:
            # out-of-core: lazily, chunk by chunk
            if self.batch_coupled:
                raise ValueError(
                    f"{type(self).__name__} is batch-coupled: run per chunk it would "
                    "compute its batch statistics per chunk; materialize the dataset "
                    "(e.g. .cache()) first")
            if self.forward is not None:
                return data.map_batch(self._forward_rows)
            return data.map(self.apply)
        if self.forward is not None and data.is_batched:
            return Dataset(self._forward_rows(data.payload))
        return data.map(self.apply)

    def _forward_rows(self, X: Any) -> Any:
        """``forward(X)``. A row-local node that no fused group took (one
        fit after fusion, such as the linear model after the featurizer)
        runs in row chunks as a fused group would: its whole-batch
        temporaries (X − μ of a 24.6 GB feature matrix) never exist."""
        if self.row_local:
            one = map_leaves(lambda t: t[:1], X)
            rows = fusion.chunk_rows(fusion.payload_bytes([one]) + self.row_work_bytes(one))
            n = int(fusion.first_leaf(X).shape[0])
            if n > rows:
                return fusion.forward_in_row_chunks(self.forward, [X], n, rows)
        return self.forward(X)

    # -- operator-level glue -------------------------------------------

    def single_transform(self, inputs: Sequence[DatumExpression]) -> Any:
        (x,) = [d.get() for d in inputs]
        return self.apply(x)

    def batch_transform(self, inputs: Sequence[DatasetExpression]) -> Dataset:
        (ds,) = [d.get() for d in inputs]
        return self.apply_batch(ds)

    # -- chainable glue -------------------------------------------------

    def to_pipeline(self) -> Pipeline:
        graph = Graph()
        graph, source = graph.add_source()
        graph, node = graph.add_node(self, [source])
        graph, sink = graph.add_sink(node)
        return Pipeline(graph, source, sink)

    def __call__(self, data: Any):
        return self.to_pipeline().apply(data)


class FunctionNode(Transformer):
    """Wrap plain functions as a transformer: ``FunctionNode(item_fn=...)``
    or ``FunctionNode(batch_fn=...)``."""

    def __init__(self, item_fn: Callable = None, batch_fn: Callable = None, label: str = None):
        if item_fn is None and batch_fn is None:
            raise ValueError("need item_fn or batch_fn")
        self._item_fn = item_fn
        self._label = label
        if batch_fn is not None:
            self.forward = batch_fn

    @property
    def label(self) -> str:
        return self._label or getattr(
            self._item_fn or self.forward, "__name__", type(self).__name__
        )

    def apply(self, x: Any) -> Any:
        if self._item_fn is not None:
            return self._item_fn(x)
        return super().apply(x)


class Identity(Transformer):
    """Pass-through (parity: ``workflow/Identity.scala``)."""

    row_local = True

    def forward(self, X):
        return X

    def apply(self, x: Any) -> Any:
        return x


class Estimator(Chainable, EstimatorOperator):
    """Fits on a dataset, producing a Transformer.

    Implement ``fit(data: Dataset) -> Transformer``. Use via
    ``est.with_data(data)`` or ``pipeline.and_then(est, data)``.
    """

    def fit(self, data: Dataset) -> Transformer:
        raise NotImplementedError

    def with_data(self, data: Any) -> Pipeline:
        """A pipeline that fits this estimator on ``data`` (lazily, once)
        and applies the fitted transformer to the pipeline input
        (parity: ``Estimator.scala:29-46``)."""
        graph = Graph()
        graph, source = graph.add_source()
        graph, data_id = attach_data(graph, data)
        graph, est_node = graph.add_node(self, [data_id])
        graph, delegating = graph.add_node(DelegatingOperator(), [est_node, source])
        graph, sink = graph.add_sink(delegating)
        return Pipeline(graph, source, sink)

    def to_pipeline(self) -> Pipeline:
        raise TypeError(
            "an Estimator is not directly chainable; use with_data(data) or "
            "and_then(est, data)"
        )

    def __call__(self, data: Any) -> Pipeline:
        return self.with_data(data)


class LabelEstimator(Chainable, EstimatorOperator):
    """Fits on (data, labels), producing a Transformer.

    Implement ``fit(data: Dataset, labels: Dataset) -> Transformer``.
    """

    def fit(self, data: Dataset, labels: Dataset) -> Transformer:
        raise NotImplementedError

    def with_data(self, data: Any, labels: Any = None) -> Pipeline:
        if labels is None:
            raise ValueError("LabelEstimator.with_data requires labels")
        graph = Graph()
        graph, source = graph.add_source()
        graph, data_id = attach_data(graph, data)
        graph, labels_id = attach_data(graph, labels)
        graph, est_node = graph.add_node(self, [data_id, labels_id])
        graph, delegating = graph.add_node(DelegatingOperator(), [est_node, source])
        graph, sink = graph.add_sink(delegating)
        return Pipeline(graph, source, sink)

    def to_pipeline(self) -> Pipeline:
        raise TypeError(
            "a LabelEstimator is not directly chainable; use with_data(data, labels)"
        )

    def __call__(self, data: Any, labels: Any = None) -> Pipeline:
        return self.with_data(data, labels)
