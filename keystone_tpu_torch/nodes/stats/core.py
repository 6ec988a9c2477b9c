"""Stats nodes (port of the in-memory ``StandardScaler`` and ``Sampler`` of
``keystone_tpu/nodes/stats/core.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...data.dataset import Dataset
from ...workflow.transformer import Estimator, Transformer


class StandardScalerModel(Transformer):
    """(x − mean) / std; std of None means center-only."""

    row_local = True

    def __init__(self, mean: torch.Tensor, std: Optional[torch.Tensor] = None):
        self.mean = mean
        self.std = std

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        out = X - self.mean
        if self.std is not None:
            out = out / self.std
        return out


class StandardScaler(Estimator):
    """Fit column mean and std (ddof=1); a degenerate std (0, NaN or inf)
    becomes 1.0."""

    def __init__(self, normalize_std_dev: bool = True, eps: float = 1e-12):
        self.normalize_std_dev = normalize_std_dev
        self.eps = eps

    def fit(self, data: Dataset) -> StandardScalerModel:
        X = Dataset.of(data).to_array()
        mean = X.mean(dim=0)
        if not self.normalize_std_dev:
            return StandardScalerModel(mean, None)
        std = torch.sqrt(X.var(dim=0, correction=1))
        bad = torch.isnan(std) | torch.isinf(std) | (std.abs() < self.eps)
        std = torch.where(bad, torch.ones_like(std), std)
        return StandardScalerModel(mean, std)


class Sampler(Transformer):
    """A seeded sample of ``size`` rows without replacement, kept in row
    order. The indices are numpy ``default_rng(seed).choice``, as in the
    JAX package, so both packages pick the same rows."""

    def __init__(self, size: int, seed: int = 42):
        self.size = size
        self.seed = seed

    def indices(self, n: int) -> np.ndarray:
        k = min(self.size, n)
        return np.sort(np.random.default_rng(self.seed).choice(n, size=k, replace=False))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        idx = torch.from_numpy(self.indices(X.shape[0])).to(X.device)
        return X[idx]
