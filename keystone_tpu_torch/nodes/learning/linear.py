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
``FittedPipeline.absorb``. ``checkpoint=dir`` makes the chunked fits of
``LinearMapEstimator`` and ``TSQRLeastSquaresEstimator`` resumable
(``faults/checkpoint.py``): a killed fit run again resumes from its last
saved block, bit for bit. Each of the three has the λ-grid hooks of a
sweep: ``grid_family`` (the key under which members fit as a group) and
``fit_lambda_grid`` (one Gram or one R for every λ; BCD warm-starts each λ
from the one before, or fits each cold with ``warm_start=False``).
"""

from __future__ import annotations

import copy
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ...data.dataset import Dataset
from ...data.sparse import SparseRows
from ...faults import FitCheckpoint
from ...linalg import bcd, normal_equations, tsqr
from ...linalg.accumulators import GramSolverState, NotAbsorbable, fold_into
from ...linalg.bcd import (
    _bcd_scan_model_sharded,
    _block_means,
    solve_blockwise_l2,
    solve_blockwise_l2_scan,
    solve_blockwise_l2_streaming,
    stream_column_means,
)
from ...linalg.normal_equations import solve_centered, solve_least_squares_streaming
from ...parallel.mesh import shard_batch
from ...workflow.transformer import LabelEstimator, Transformer
from .cost import CostModel, combine_cost, label_dim_fitted_out_spec


class LinearMapper(Transformer):
    """out = (x − feature_mean) · W + b. ``solver_state`` is the
    snapshot-able :class:`~keystone_tpu_torch.linalg.accumulators.
    GramSolverState` of a snapshot fit (None otherwise): what
    ``FittedPipeline.absorb`` folds appended chunks into; the apply never
    reads it."""

    row_local = True
    #: fit state the apply never reads: not part of the AOT cache key
    aot_fingerprint_exclude = ("solver_state",)

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
    ``FittedPipeline.absorb`` then folds appended chunks into.

    ``checkpoint=dir`` fits the same way and makes a chunked fit resumable:
    the state, with its chunk and row cursors, is saved to ``dir`` every
    ``checkpoint_every`` chunks (``faults.FitCheckpoint``), a killed fit
    run again with the same arguments resumes from the last saved block
    (the state an uninterrupted fit would fold, bit for bit) without
    producing the chunks before it, and the checkpoint is removed when the
    fit completes."""

    supports_streaming = True

    def __init__(self, lam: Optional[float] = None, snapshot: bool = False,
                 checkpoint: Optional[str] = None, checkpoint_every: int = 1):
        self.lam = lam
        self.snapshot = snapshot
        self.checkpoint = checkpoint
        self.checkpoint_every = checkpoint_every

    def fitted_out_spec(self, fit_in, apply_in):
        return label_dim_fitted_out_spec(fit_in, apply_in)

    def grid_family(self):
        """Members of a sweep whose key matches fit as a group; λ is the
        swept axis, so it is not in the key, and the checkpoint directory
        is (a group's shared scan must keep each member's resume)."""
        return ("gram_ne", bool(self.snapshot), self.checkpoint)

    @staticmethod
    def fit_lambda_grid(estimators: Sequence["LinearMapEstimator"], data, labels,
                        checkpoint: Optional[str] = None,
                        checkpoint_every: int = 1) -> List[LinearMapper]:
        """A λ-only grid from one accumulation: the Gram and cross products
        do not depend on λ, so the grid costs one scan and a solve a member.
        Each mapper carries its own snapshot of the state, its λ recorded,
        so any of them can absorb appended chunks. With ``checkpoint``, a
        chunked fold saves to that directory every ``checkpoint_every``
        chunks and resumes from the last saved block when run again."""
        y = Dataset.of(labels).to_array().float()
        ckpt = None
        if checkpoint is not None and getattr(data, "is_chunked", False):
            lams = [float(e.lam or 0.0) for e in estimators]
            ckpt = FitCheckpoint(checkpoint, f"gram_ne|n={len(data)}"
                                             f"|y={tuple(int(s) for s in y.shape)}|lams={lams}")
        state = fold_into(GramSolverState(), data, y, label="gram_state", checkpoint=ckpt,
                          checkpoint_every=checkpoint_every)
        models = []
        for est in estimators:
            lam = float(est.lam or 0.0)
            W, b, mean = state.solve(lam, device=y.device)
            snap = state.snapshot()
            snap.lam = lam
            models.append(LinearMapper(W, b=b, feature_mean=mean, solver_state=snap))
        return models

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        if self.snapshot or self.checkpoint:
            # the state on disk is the snapshot
            return LinearMapEstimator.fit_lambda_grid(
                [self], data, labels, checkpoint=self.checkpoint,
                checkpoint_every=self.checkpoint_every)[0]
        if getattr(data, "is_chunked", False):
            return self._fit_streaming(data, labels)
        # rows over the data axis of the default mesh
        A = shard_batch(Dataset.of(data).to_array())
        b = shard_batch(Dataset.of(labels).to_array().to(A.device))
        W, a_mean, b_mean = solve_centered(A, b, reg=self.lam or 0.0)
        return LinearMapper(W, b=b_mean, feature_mean=a_mean)

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
    #: fit state the apply never reads, and the stacked forms derived from
    #: ``xs`` and ``feature_means``: not part of the AOT cache key
    aot_fingerprint_exclude = ("solver_state", "_W", "_mean")

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
        #: per-block starting weights for the next fit (a λ grid's warm
        #: start from its neighbour's model), used and cleared by ``fit``
        self.warm_start_ws: Optional[Sequence[torch.Tensor]] = None

    def fitted_out_spec(self, fit_in, apply_in):
        return label_dim_fitted_out_spec(fit_in, apply_in)

    def grid_family(self):
        return ("bcd", self.block_size, self.num_iter, self.num_features)

    @staticmethod
    def fit_lambda_grid(estimators: Sequence["BlockLeastSquaresEstimator"], data,
                        labels, warm_start: bool = True) -> List["BlockLinearMapper"]:
        """A λ grid of BCD members in ascending λ. With ``warm_start`` each
        member starts from the model of the λ before it (BCD is iterative:
        a warm start descends the same objective from elsewhere, so its
        iterates are not a cold fit's); without it each member fits cold,
        as its own fit would. A chunked input fits each member cold.
        ``GridSweep`` passes its own ``warm_start`` (default False)."""
        order = sorted(range(len(estimators)), key=lambda i: estimators[i].lam or 0.0)
        warm = warm_start and not getattr(data, "is_chunked", False)
        models: List[Optional[BlockLinearMapper]] = [None] * len(estimators)
        prev: Optional[BlockLinearMapper] = None
        for i in order:
            est = copy.copy(estimators[i])
            est.warm_start_ws = list(prev.xs) if warm and prev is not None else None
            models[i] = prev = est.fit(data, labels)
        return models

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
        warm, self.warm_start_ws = self.warm_start_ws, None
        if getattr(data, "is_chunked", False):
            return self._fit_streaming(data, labels)
        payload = data if isinstance(data, (list, tuple)) else Dataset.of(data).payload
        X = None
        if isinstance(payload, (list, tuple)):
            blocks = [shard_batch(Dataset.of(b).to_array().float()) for b in payload]
        else:
            # rows over the data axis of the default mesh
            X = shard_batch(payload[..., :self.num_features or payload.shape[-1]].float())
            d = X.shape[-1]
            blocks = [X[..., i:min(i + self.block_size, d)]
                      for i in range(0, d, self.block_size)]
        y = Dataset.of(labels).to_array().to(blocks[0].device, torch.float32)
        means, y_mean = _block_means(blocks, y)
        init = None
        if warm is not None and len(warm) == len(blocks) and all(
                tuple(w.shape) == (b.shape[1], y.shape[1]) for w, b in zip(warm, blocks)):
            init = [w.to(y.device) for w in warm]
        if X is not None and d % self.block_size == 0 and \
                _bcd_scan_model_sharded(X.shape[0], d, self.block_size) is not None:
            # uniform blocks of one matrix on a mesh with a model axis: the
            # scan form, which lays the blocks out over the model slots
            W = solve_blockwise_l2_scan(
                X, shard_batch(y - y_mean), reg=self.lam, block_size=self.block_size,
                num_iter=self.num_iter, means=torch.cat(means),
                init=None if init is None else torch.cat(init))
            ws = [W[i:i + self.block_size] for i in range(0, d, self.block_size)]
        else:
            ws = solve_blockwise_l2(blocks, shard_batch(y - y_mean), reg=self.lam,
                                    num_iter=self.num_iter, means=means, init=init)
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


class _CenteredTsqr:
    """The streaming TSQR fold's state: the column and label means of the
    means scan and the running R of the centered augmented chunks
    [A − μ | y − ν], R = qr([R; chunk]).R, one lane. R stays on the chunks'
    device while folding; a pickle (a checkpoint) holds host arrays, so a
    resumed fit reads no chunk for its means and folds on from the saved
    R bit for bit."""

    def __init__(self, a_mean: torch.Tensor, y_mean: torch.Tensor):
        self.a_mean, self.y_mean = a_mean, y_mean
        self.r: Optional[torch.Tensor] = None

    def update(self, A: torch.Tensor, y: torch.Tensor) -> "_CenteredTsqr":
        if A.shape[1] != self.a_mean.shape[0]:
            raise ValueError(f"the chunks are {A.shape[1]} columns wide, the fit expects "
                             f"d = {self.a_mean.shape[0]}")
        self.a_mean, self.y_mean = self.a_mean.to(A.device), self.y_mean.to(A.device)
        chunk = torch.cat([A.float() - self.a_mean, y.float() - self.y_mean], dim=1)
        self.r = (tsqr._qr_r(chunk) if self.r is None
                  else tsqr._qr_fold(self.r.to(A.device), chunk))
        return self

    def __getstate__(self) -> dict:
        return {k: None if v is None else v.cpu().numpy() for k, v in self.__dict__.items()}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update({k: None if v is None else torch.from_numpy(v)
                              for k, v in state.items()})


class TSQRLeastSquaresEstimator(LabelEstimator, CostModel):
    """Exact least squares by one QR of the augmented, centered design
    matrix ``[A − μ | y − ν ; √λ·I | 0]``: its R factor's blocks satisfy
    R₁₁ᵀR₁₁ = ÃᵀÃ + λI and R₁₁ᵀR₁₂ = Ãᵀỹ, so W = R₁₁⁻¹R₁₂ is one triangular
    solve and no Gram matrix forms (the Gram route squares the condition
    number). About twice the Gram route's flops, as ``cost`` says. A
    chunked input streams: a scan for the column means, then one scan
    folding the centered augmented chunks into R, the √λ·I rows last.

    ``checkpoint=dir`` makes the chunked fit resumable: R is saved with the
    column means and the cursors every ``checkpoint_every`` chunks; the
    first save, before any chunk is folded, carries the means, so a resumed
    fit reads only the chunks after its last save. The √λ·I rows fold after
    the last chunk, never into a saved prefix."""

    supports_streaming = True

    def __init__(self, lam: float = 0.0, checkpoint: Optional[str] = None,
                 checkpoint_every: int = 1):
        self.lam = lam
        self.checkpoint = checkpoint
        self.checkpoint_every = checkpoint_every

    def fitted_out_spec(self, fit_in, apply_in):
        return label_dim_fitted_out_spec(fit_in, apply_in)

    def grid_family(self):
        return ("tsqr", self.checkpoint)

    @staticmethod
    def fit_lambda_grid(estimators: Sequence["TSQRLeastSquaresEstimator"], data,
                        labels) -> List[LinearMapper]:
        """A λ-only grid from one factorization: the R of the unregularized
        centered augmented matrix does not depend on λ, and qr([A; B]).R =
        qr([qr(A).R; B]).R up to row signs, which the triangular solve
        cancels; so each member folds only its √λ·I rows into the shared R."""
        if getattr(data, "is_chunked", False):
            fold = TSQRLeastSquaresEstimator()._fold_r(data, labels)
            R_base, a_mean, y_mean = fold.r, fold.a_mean, fold.y_mean
        else:
            A = Dataset.of(data).to_array().float()
            y = Dataset.of(labels).to_array().to(A.device, torch.float32)
            a_mean, y_mean = A.mean(dim=0), y.mean(dim=0)
            R_base = tsqr.tsqr_r(torch.cat([A - a_mean, y - y_mean], dim=1))
        d = int(a_mean.shape[0])
        k = int(R_base.shape[1]) - d
        models = []
        for est in estimators:
            reg = est._reg_rows(d, k, R_base.device)
            R = R_base if reg is None else tsqr._qr_fold(R_base, reg)
            models.append(LinearMapper(TSQRLeastSquaresEstimator._solve_from_r(R, d), b=y_mean,
                                       feature_mean=a_mean))
        return models

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

    def _fold_r(self, data, labels: Dataset) -> _CenteredTsqr:
        """The means scan, then the centered augmented chunks folded into
        R in one scan; resumable with ``checkpoint``."""
        y = Dataset.of(labels).to_array().float()
        ckpt = None
        if self.checkpoint:
            ckpt = FitCheckpoint(self.checkpoint, f"tsqr|n={len(data)}"
                                                  f"|y={tuple(int(s) for s in y.shape)}"
                                                  f"|lam={float(self.lam or 0.0)}")

        def fresh():
            _, a_mean = _streaming_labels(data, labels)
            state = _CenteredTsqr(a_mean, y.mean(dim=0))
            if ckpt is not None:
                ckpt.save(state, 0, 0)
            return state

        return fold_into(fresh, data, y, label="tsqr", checkpoint=ckpt,
                         checkpoint_every=self.checkpoint_every)

    def _fit_streaming(self, data, labels: Dataset) -> LinearMapper:
        fold = self._fold_r(data, labels)
        d, device = int(fold.a_mean.shape[0]), fold.r.device
        reg = self._reg_rows(d, int(fold.y_mean.shape[0]), device)
        R = fold.r if reg is None else tsqr._qr_fold(fold.r, reg)
        return LinearMapper(self._solve_from_r(R, d), b=fold.y_mean, feature_mean=fold.a_mean)

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
