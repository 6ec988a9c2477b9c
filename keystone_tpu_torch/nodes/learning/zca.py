"""ZCA whitening (port of ``keystone_tpu/nodes/learning/zca.py``).

W = Vᵀ diag((σ²/(n−1) + ε)^−½) V from a float32 SVD of the centered
sample; W does not depend on the signs the SVD picks for V's rows.
"""

from __future__ import annotations

import torch

from ...data.dataset import Dataset
from ...workflow.transformer import Estimator, Transformer


class ZCAWhitener(Transformer):
    """x → (x − means) · W."""

    row_local = True

    def __init__(self, whitener: torch.Tensor, means: torch.Tensor):
        self.whitener = whitener
        self.means = means

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return (X - self.means) @ self.whitener

    # the name Convolver.build and host-side callers use
    transform = forward


class ZCAWhitenerEstimator(Estimator):
    """Fit the whitening rotation from a sample matrix."""

    def __init__(self, eps: float = 0.1):
        self.eps = eps

    def fit(self, data: Dataset) -> ZCAWhitener:
        return self.fit_single(Dataset.of(data).to_array())

    def fit_single(self, X: torch.Tensor) -> ZCAWhitener:
        X = X.float()
        means = X.mean(dim=0)
        Xc = X - means
        n = X.shape[0]
        _, s, vt = torch.linalg.svd(Xc, full_matrices=False)
        scale = (s * s / (n - 1.0) + self.eps) ** -0.5
        return ZCAWhitener(vt.T @ (scale[:, None] * vt), means)
