"""Transformer / Estimator / LabelEstimator (port of
``keystone_tpu/workflow/transformer.py``).

A transformer implements ``forward(X)``: a function of the stacked
batch tensor (leading dimension = items). ``row_local`` marks those whose
output row i depends on input row i alone; the pipeline may apply a run
of them in row chunks.
"""

from __future__ import annotations

from typing import Any

import torch

from ..data.dataset import Dataset
from .pipeline import Chainable, Pipeline


class Transformer(Chainable):
    """A deterministic function of each item, applied to whole batches."""

    #: output row i depends on input row i alone
    row_local: bool = False

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply_batch(self, data: Any) -> Dataset:
        return Dataset.of(data).map_batch(self.forward)

    def to_pipeline(self) -> Pipeline:
        return Pipeline((self,))


class Estimator(Chainable):
    """Fits on a dataset, producing a Transformer. Chain it with
    ``pipeline.and_then(est, data)``."""

    def fit(self, data: Dataset) -> Transformer:
        raise NotImplementedError

    def to_pipeline(self) -> Pipeline:
        raise TypeError(
            "an Estimator is not directly chainable; use and_then(est, data)"
        )


class LabelEstimator(Chainable):
    """Fits on (data, labels), producing a Transformer. Chain it with
    ``pipeline.and_then(est, data, labels)``."""

    def fit(self, data: Dataset, labels: Dataset) -> Transformer:
        raise NotImplementedError

    def to_pipeline(self) -> Pipeline:
        raise TypeError(
            "a LabelEstimator is not directly chainable; "
            "use and_then(est, data, labels)"
        )
