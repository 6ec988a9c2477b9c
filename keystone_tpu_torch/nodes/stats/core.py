"""Stats nodes (port of ``PaddedFFT``, ``RandomSignNode``,
``LinearRectifier`` and the in-memory ``StandardScaler`` and ``Sampler`` of
``keystone_tpu/nodes/stats/core.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import device as pick_device
from ...data.dataset import Dataset
from ...workflow.transformer import Estimator, Transformer


class PaddedFFT(Transformer):
    """Zero-pad each row to the next power of two and keep the real part of
    the first half of its FFT: d → 2^ceil(log2 d) / 2 features."""

    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        d = X.shape[-1]
        padded = 1 << max(0, d - 1).bit_length()
        # rfft gives padded/2 + 1 bins, of which the first padded/2 are kept;
        # ``.real`` of a complex tensor is a strided view, so copy it out
        # once here rather than hand a strided operand to the next GEMM
        return torch.fft.rfft(X, n=padded, dim=-1).real[..., : padded // 2].contiguous()


class RandomSignNode(Transformer):
    """Elementwise multiply by a fixed ±1 vector."""

    row_local = True

    def __init__(self, signs: torch.Tensor):
        self.signs = signs

    @staticmethod
    def create(size: int, seed: int = 0, device=None) -> "RandomSignNode":
        """Signs drawn with numpy ``default_rng(seed)``: another stream than
        the JAX package's ``jax.random``, so the two packages' nodes of one
        seed differ; parity tests copy the JAX node's signs instead."""
        draw = np.random.default_rng(seed).integers(0, 2, size=size)
        signs = torch.from_numpy((2.0 * draw - 1.0).astype(np.float32))
        return RandomSignNode(signs.to(pick_device(device)))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X * self.signs


class LinearRectifier(Transformer):
    """max(max_val, x − alpha)."""

    row_local = True

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = max_val
        self.alpha = alpha

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(X - self.alpha if self.alpha else X, self.max_val)


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
