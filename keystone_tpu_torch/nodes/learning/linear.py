"""Linear solvers: exact normal equations, block coordinate descent and
the augmented TSQR (port of ``keystone_tpu/nodes/learning/linear.py``).

Features and labels are mean-centered before solving; the label mean
becomes the intercept, and the block estimator centers each feature block
by its own column means. The fitted models apply as one GEMM,
(X − μ)·W + b, which is row-local: a pipeline applies them in row chunks.

Each solver prices itself with ``cost`` (the JAX package's analytic
units), which the cost-model chooser of ``LeastSquaresEstimator`` ranks.

Each of the three fits an out-of-core
:class:`~keystone_tpu_torch.data.chunked.ChunkedDataset` by streaming
(``supports_streaming``): a scan for the column means, then the exact
solve's Gram, the augmented TSQR's R factor, or one scan a BCD block step,
so the design matrix is never whole. ``LinearMapEstimator(snapshot=True)``
fits through :class:`~keystone_tpu_torch.linalg.accumulators.GramSolverState`
(in memory or chunked) and carries the state on its mapper, for
``FittedPipeline.absorb``. Not ported: the checkpointed fits
(``faults/checkpoint.py``) and ``fit_lambda_grid``, which ROADMAP Queue 1
items 11 and 12 leave to later slices; asking for a checkpoint raises.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ...data.dataset import Dataset
from ...data.sparse import SparseRows
from ...linalg import bcd, normal_equations, tsqr
from ...linalg.accumulators import GramSolverState, NotAbsorbable, fold_into
from ...linalg.bcd import (
    _block_means,
    solve_blockwise_l2,
    solve_blockwise_l2_streaming,
    stream_column_means,
)
from ...linalg.normal_equations import solve_centered, solve_least_squares_streaming
from ...workflow.transformer import LabelEstimator, Transformer
from .cost import CostModel, combine_cost


class LinearMapper(Transformer):
    """out = (x − feature_mean) · W + b. ``solver_state`` is the
    snapshot-able :class:`~keystone_tpu_torch.linalg.accumulators.
    GramSolverState` of a snapshot fit (None otherwise): what
    ``FittedPipeline.absorb`` folds appended chunks into; the apply never
    reads it."""

    row_local = True

    def __init__(self, W: torch.Tensor, b: Optional[torch.Tensor] = None,
                 feature_mean: Optional[torch.Tensor] = None, solver_state=None):
        self.W = W
        self.b = b
        self.feature_mean = feature_mean
        self.solver_state = solver_state

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        if self.feature_mean is not None:
            X = X - self.feature_mean
        out = X @ self.W
        if self.b is not None:
            out = out + self.b
        return out


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with faults/checkpoint.py in a later slice "
        "(ROADMAP Queue 1, item 11)")


def _streaming_labels(data, labels: Dataset):
    """The labels of a streaming fit as float32, and the column means and
    row count of ``data``'s chunks (one scan, the chunks copied to the
    labels' device)."""
    y = Dataset.of(labels).to_array().float()
    mean, n = stream_column_means(data.raw_chunks, device=y.device)
    if n != y.shape[0]:
        raise ValueError(f"chunked features have {n} rows, labels {y.shape[0]}")
    return y, mean


def _with_labels(data, y: torch.Tensor, d: int, fn):
    """A chunk source for one scan of ``data``: each chunk, which must be
    ``d`` wide, passed to ``fn(chunk, its rows of y)`` on the scan's
    consumer."""
    offset = [0]

    def step(chunk):
        chunk = chunk.float()
        if chunk.shape[1] != d:
            raise ValueError(f"the chunks are {chunk.shape[1]} columns wide, the fit "
                             f"expects d = {d}")
        o = offset[0]
        offset[0] = o + chunk.shape[0]
        return fn(chunk, y[o:offset[0]])

    return data.raw_chunks().then(step)


class LinearMapEstimator(LabelEstimator, CostModel):
    """Exact ridge regression by normal equations on centered data. A
    chunked input streams: a scan for the column means, then one scan of
    centered (A, y) chunks into the Gram and cross products.

    ``snapshot=True`` fits through the raw accumulators instead
    (:class:`~keystone_tpu_torch.linalg.accumulators.GramSolverState`: ΣAᵀA
    and ΣAᵀy in host float64, centered at the solve), one scan of a chunked
    input, and carries the state on the fitted :class:`LinearMapper`, which
    ``FittedPipeline.absorb`` then folds appended chunks into."""

    supports_streaming = True

    def __init__(self, lam: Optional[float] = None, snapshot: bool = False,
                 checkpoint: Optional[str] = None):
        if checkpoint is not None:
            raise _later_slice("LinearMapEstimator(checkpoint=...)")
        self.lam = lam
        self.snapshot = snapshot

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        if self.snapshot:
            return self._fit_snapshot(data, labels)
        if getattr(data, "is_chunked", False):
            return self._fit_streaming(data, labels)
        A = Dataset.of(data).to_array()
        b = Dataset.of(labels).to_array().to(A.device)
        W, a_mean, b_mean = solve_centered(A, b, reg=self.lam or 0.0)
        return LinearMapper(W, b=b_mean, feature_mean=a_mean)

    def _fit_snapshot(self, data, labels: Dataset) -> LinearMapper:
        """Fold the data (one scan of a chunked input) into a
        GramSolverState, solve at λ on the labels' device, and carry the
        state's snapshot, λ recorded."""
        y = Dataset.of(labels).to_array().float()
        state = fold_into(GramSolverState(lam=float(self.lam or 0.0)), data, y,
                          label="gram_state")
        W, b, mean = state.solve(state.lam, device=y.device)
        return LinearMapper(W, b=b, feature_mean=mean, solver_state=state.snapshot())

    def _fit_streaming(self, data, labels: Dataset) -> LinearMapper:
        y, a_mean = _streaming_labels(data, labels)
        y_mean = y.mean(dim=0)
        centered = _with_labels(data, y, a_mean.shape[0],
                                lambda A, yc: (A - a_mean, yc - y_mean))
        W = solve_least_squares_streaming(centered, reg=self.lam or 0.0, device=y.device)
        return LinearMapper(W, b=y_mean, feature_mean=a_mean)

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
                 feature_means: Optional[Sequence[torch.Tensor]] = None,
                 solver_state=None):
        #: the snapshot-able WeightedSolverState of a per-class weighted
        #: snapshot fit (None otherwise), what ``FittedPipeline.absorb``
        #: folds appended chunks into
        self.solver_state = solver_state
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
    column blocks of ``block_size`` with ridge ``lam``. A chunked input
    streams: one scan for the column means, then one scan a block step
    (``num_iter`` × nblocks + 1 scans in all)."""

    supports_streaming = True

    def __init__(self, block_size: int, num_iter: int, lam: float = 0.0,
                 num_features: Optional[int] = None, snapshot: bool = False):
        if snapshot:
            raise NotAbsorbable(
                "block-coordinate descent has no state to snapshot: its iterates depend "
                "on block visitation order, so appended chunks cannot be folded in after "
                "the fit; fit with LinearMapEstimator(snapshot=True) for an absorbable model")
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
        if getattr(data, "is_chunked", False):
            return self._fit_streaming(data, labels)
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

    def _fit_streaming(self, data, labels: Dataset) -> BlockLinearMapper:
        """The out-of-core fit: the featurized design matrix is never
        whole; each scan recomputes the chunks from the source."""
        if self.num_features is not None:
            d = self.num_features

            def chunk_scan():
                return data.raw_chunks().then(lambda c: c[..., :d])
        else:
            chunk_scan = data.raw_chunks
        y = Dataset.of(labels).to_array().float()
        mean_vec, n = stream_column_means(chunk_scan, device=y.device)
        if n != y.shape[0]:
            raise ValueError(f"chunked features have {n} rows, labels {y.shape[0]}")
        y_mean = y.mean(dim=0)
        ws = solve_blockwise_l2_streaming(chunk_scan, y - y_mean, reg=self.lam,
                                          block_size=self.block_size,
                                          num_iter=self.num_iter, means=mean_vec)
        d = int(mean_vec.shape[0])
        means = [mean_vec[i:min(i + self.block_size, d)] for i in range(0, d, self.block_size)]
        return BlockLinearMapper(ws, self.block_size, b=y_mean, feature_means=means)


class TSQRLeastSquaresEstimator(LabelEstimator, CostModel):
    """Exact least squares by one QR of the augmented, centered design
    matrix ``[A − μ | y − ν ; √λ·I | 0]``: its R factor's blocks satisfy
    R₁₁ᵀR₁₁ = ÃᵀÃ + λI and R₁₁ᵀR₁₂ = Ãᵀỹ, so W = R₁₁⁻¹R₁₂ is one triangular
    solve and no Gram matrix forms (the Gram route squares the condition
    number). About twice the Gram route's flops, as ``cost`` says. A
    chunked input streams: a scan for the column means, then one scan
    folding the centered augmented chunks into R, the √λ·I rows last."""

    supports_streaming = True

    def __init__(self, lam: float = 0.0, checkpoint: Optional[str] = None):
        if checkpoint is not None:
            raise _later_slice("TSQRLeastSquaresEstimator(checkpoint=...)")
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
        if getattr(data, "is_chunked", False):
            return self._fit_streaming(data, labels)
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

    def _fit_streaming(self, data, labels: Dataset) -> LinearMapper:
        y, a_mean = _streaming_labels(data, labels)
        y_mean = y.mean(dim=0)
        d, k = int(a_mean.shape[0]), y.shape[1]

        def augmented():
            return _with_labels(data, y, d,
                                lambda A, yc: torch.cat([A - a_mean, yc - y_mean], dim=1))

        R = tsqr.tsqr_r_streaming(augmented, device=y.device,
                                  tail=self._reg_rows(d, k, y.device))
        return LinearMapper(self._solve_from_r(R, d), b=y_mean, feature_mean=a_mean)

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
