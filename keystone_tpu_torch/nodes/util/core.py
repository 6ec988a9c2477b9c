"""Glue nodes (port of ``ClassLabelIndicators`` and ``MaxClassifier`` from
``keystone_tpu/nodes/util/core.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...workflow.transformer import Transformer


class ClassLabelIndicators(Transformer):
    """Int label → ±1 indicator vector: −1 everywhere, +1 at the class."""

    row_local = True

    def __init__(self, num_classes: int):
        if num_classes <= 1:
            raise ValueError("num_classes must be > 1")
        self.num_classes = num_classes

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return 2.0 * F.one_hot(y.long(), self.num_classes).float() - 1.0


class MaxClassifier(Transformer):
    """argmax over the score vector; ties go to the first maximum, as
    ``jnp.argmax`` breaks them."""

    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.argmax(X, dim=-1)
