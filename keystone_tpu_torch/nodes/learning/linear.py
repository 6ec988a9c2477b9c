"""Linear solvers: exact normal equations, block coordinate descent and
the augmented TSQR (port of the in-memory paths of
``keystone_tpu/nodes/learning/linear.py``).

Features and labels are mean-centered before solving; the label mean
becomes the intercept, and the block estimator centers each feature block
by its own column means. The fitted models apply as one GEMM,
(X − μ)·W + b, which is row-local: a pipeline applies them in row chunks.

Each solver prices itself with ``cost`` (the JAX package's analytic
units), which the cost-model chooser of ``LeastSquaresEstimator`` ranks.

Not ported: the snapshot, checkpoint and streaming fits and
``fit_lambda_grid``; without a streaming fit no solver here sets
``supports_streaming``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ...data.dataset import Dataset
from ...data.sparse import SparseRows
from ...linalg import bcd, normal_equations, tsqr
from ...linalg.bcd import _block_means, solve_blockwise_l2
from ...linalg.normal_equations import solve_centered
from ...workflow.transformer import LabelEstimator, Transformer
from .cost import CostModel, combine_cost


class LinearMapper(Transformer):
    """out = (x − feature_mean) · W + b."""

    row_local = True

    def __init__(self, W: torch.Tensor, b: Optional[torch.Tensor] = None,
                 feature_mean: Optional[torch.Tensor] = None):
        self.W = W
        self.b = b
        self.feature_mean = feature_mean

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        if self.feature_mean is not None:
            X = X - self.feature_mean
        out = X @ self.W
        if self.b is not None:
            out = out + self.b
        return out


class LinearMapEstimator(LabelEstimator, CostModel):
    """Exact ridge regression by normal equations on centered data."""

    def __init__(self, lam: Optional[float] = None):
        self.lam = lam

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        A = Dataset.of(data).to_array()
        b = Dataset.of(labels).to_array().to(A.device)
        W, a_mean, b_mean = solve_centered(A, b, reg=self.lam or 0.0)
        return LinearMapper(W, b=b_mean, feature_mean=a_mean)

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        return combine_cost(normal_equations.cost_signature(n, d, k, num_machines),
                            cpu_weight, mem_weight, network_weight)


class BlockLinearMapper(Transformer):
    """Apply a block-solved model: the block weights stacked vertically and
    the block means joined, so the apply is one GEMM."""

    row_local = True

    def __init__(self, xs: Sequence[torch.Tensor], block_size: int,
                 b: Optional[torch.Tensor] = None,
                 feature_means: Optional[Sequence[torch.Tensor]] = None):
        self.xs = list(xs)
        self.block_size = block_size
        self.b = b
        self.feature_means = None if feature_means is None else list(feature_means)
        self._W = torch.cat(self.xs, dim=0)
        self._mean = None if self.feature_means is None else torch.cat(self.feature_means)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        if self._mean is not None:
            X = X - self._mean
        out = X @ self._W
        if self.b is not None:
            out = out + self.b
        return out

    def apply_blocks(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply to pre-split feature blocks: Σ_j (A_j − m_j) W_j + b."""
        out = None
        for j, (Aj, Wj) in enumerate(zip(blocks, self.xs)):
            if self.feature_means is not None:
                Aj = Aj - self.feature_means[j]
            term = Aj @ Wj
            out = term if out is None else out + term
        if self.b is not None:
            out = out + self.b
        return out


class BlockLeastSquaresEstimator(LabelEstimator, CostModel):
    """Block-coordinate-descent least squares, ``num_iter`` passes over
    column blocks of ``block_size`` with ridge ``lam``."""

    def __init__(self, block_size: int, num_iter: int, lam: float = 0.0,
                 num_features: Optional[int] = None):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.num_features = num_features

    @property
    def weight(self) -> int:
        """Passes over the input, for a cache planner."""
        return 3 * self.num_iter + 1

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        return combine_cost(
            bcd.cost_signature(n, d, k, self.block_size, self.num_iter, num_machines),
            cpu_weight, mem_weight, network_weight)

    def fit(self, data: Any, labels: Dataset) -> BlockLinearMapper:
        """``data`` is a Dataset of (n, d) features, a Dataset whose payload
        is a tuple of column blocks, or a list or tuple of blocks. A whole
        matrix is read as column views of ``block_size`` (the last one may
        be narrower), so the solve never copies it."""
        payload = data if isinstance(data, (list, tuple)) else Dataset.of(data).payload
        if isinstance(payload, (list, tuple)):
            blocks = [Dataset.of(b).to_array().float() for b in payload]
        else:
            X = payload[..., :self.num_features or payload.shape[-1]].float()
            d = X.shape[-1]
            blocks = [X[..., i:min(i + self.block_size, d)]
                      for i in range(0, d, self.block_size)]
        y = Dataset.of(labels).to_array().to(blocks[0].device, torch.float32)
        means, y_mean = _block_means(blocks, y)
        ws = solve_blockwise_l2(blocks, y - y_mean, reg=self.lam,
                                num_iter=self.num_iter, means=means)
        return BlockLinearMapper(ws, self.block_size, b=y_mean, feature_means=means)


class TSQRLeastSquaresEstimator(LabelEstimator, CostModel):
    """Exact least squares by one QR of the augmented, centered design
    matrix ``[A − μ | y − ν ; √λ·I | 0]``: its R factor's blocks satisfy
    R₁₁ᵀR₁₁ = ÃᵀÃ + λI and R₁₁ᵀR₁₂ = Ãᵀỹ, so W = R₁₁⁻¹R₁₂ is one triangular
    solve and no Gram matrix forms (the Gram route squares the condition
    number). About twice the Gram route's flops, as ``cost`` says. Only
    the in-memory fit is ported."""

    def __init__(self, lam: float = 0.0):
        self.lam = lam

    @staticmethod
    def _solve_from_r(R: torch.Tensor, d: int) -> torch.Tensor:
        return torch.linalg.solve_triangular(R[:d, :d], R[:d, d:], upper=True)

    def _reg_rows(self, d: int, k: int, device) -> Optional[torch.Tensor]:
        """The √λ·I rows under the augmented matrix, or None at λ = 0."""
        if not self.lam:
            return None
        rows = torch.zeros((d, d + k), dtype=torch.float32, device=device)
        rows[:, :d] = torch.sqrt(torch.tensor(self.lam, dtype=torch.float32)) * torch.eye(
            d, dtype=torch.float32, device=device)
        return rows

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        A = Dataset.of(data).to_array().float()
        y = Dataset.of(labels).to_array().to(A.device, torch.float32)
        a_mean, y_mean = A.mean(dim=0), y.mean(dim=0)
        d, k = A.shape[1], y.shape[1]
        aug = torch.cat([A - a_mean, y - y_mean], dim=1)
        reg = self._reg_rows(d, k, A.device)
        if reg is not None:
            aug = torch.cat([aug, reg], dim=0)
        W = self._solve_from_r(tsqr.tsqr_r(aug), d)
        return LinearMapper(W, b=y_mean, feature_mean=a_mean)

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        return combine_cost(tsqr.cost_signature(n, d, k, num_machines),
                            cpu_weight, mem_weight, network_weight)


class SparseLinearMapper(Transformer):
    """A dense model applied to sparse rows: x·W (+ b). A SparseRows batch
    applies as a gather of W's rows (``data/sparse.py``), never densified;
    dense rows as one GEMM."""

    row_local = True

    def __init__(self, W: torch.Tensor, b: Optional[torch.Tensor] = None):
        self.W = W
        self.b = b

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        out = X @ self.W
        return out if self.b is None else out + self.b

    def apply_batch(self, data) -> Dataset:
        data = Dataset.of(data)
        if isinstance(data.payload, SparseRows):
            out = data.payload.matmul(self.W)
            return Dataset(out if self.b is None else out + self.b)
        return super().apply_batch(data)

    def apply(self, x: Any) -> Any:
        sr = SparseRows.datum_from_pairs(x, self.W.shape[0])
        if sr is not None:
            x = sr
        if isinstance(x, SparseRows):
            out = x.to(self.W.device).matmul(self.W)
            out = out if self.b is None else out + self.b
            return out[0] if len(x) == 1 else out
        if hasattr(x, "nnz"):  # a scipy sparse vector or matrix
            import numpy as np

            dense = torch.as_tensor(np.asarray(x.todense(), dtype=np.float32), device=self.W.device)
            if dense.dim() == 2 and dense.shape[0] > 1:
                return self.forward(dense)  # an r×d matrix → r×k
            x = dense.reshape(-1)
        return self.forward(torch.as_tensor(x, device=self.W.device)[None])[0]
