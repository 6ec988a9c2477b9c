"""Class-weighted block-coordinate least squares, the ImageNet Fisher-vector
solver (port of the in-memory fits of
``keystone_tpu/nodes/learning/weighted.py``; parity:
``BlockWeightedLeastSquares.scala`` and ``PerClassWeightedLeastSquares.scala``).

Objective: per class c, ridge regression under the mixture weighting that
gives the class-c rows total weight ``w`` and the population weight
``1 − w``. The per-class means are one GEMM against the class one-hots;
the per-class normal matrices are solved in batches of classes.

Precision: λ is as small as 6e-5 at ImageNet's settings, below the noise
of a TF32 product, so every GEMM here must run in full float32. The port
switches TF32 off for the whole package (``keystone_tpu_torch/__init__.py``),
the counterpart of the JAX package's "highest" matmul precision for this
family; nothing here switches it back.

Out of core: a ``ChunkedDataset`` input that fits the cache budget is
materialized and solved in memory; a larger one streams
(``train_streaming``, :func:`~keystone_tpu_torch.linalg.weighted.
solve_weighted_streaming`). The per-class estimator's ``snapshot=True``
fits through :class:`~keystone_tpu_torch.linalg.weighted.WeightedSolverState`
and carries it on the fitted mapper for ``FittedPipeline.absorb``; the
iterated families have no such state and raise ``NotAbsorbable``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...data.dataset import Dataset
from ...linalg.row_matrix import solve_spd
from ...linalg.accumulators import NotAbsorbable, fold_into
from ...linalg.weighted import (
    ClassRows,
    WeightedSolverState,
    _batched_solve,
    cost_signature,
    solve_each,
    solve_weighted_streaming,
)
from ...utils.timing import phase
from ...workflow.node_optimization import Optimizable
from ...workflow.transformer import LabelEstimator
from .cost import AutoSolverFrontDoor, CostModel, combine_cost
from .linear import BlockLinearMapper


def _class_stats(A: torch.Tensor, y_idx: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class row counts (k,) and means (k, d)."""
    onehot = F.one_hot(y_idx, k).to(A.dtype)
    counts = onehot.sum(dim=0)
    return counts, (onehot.T @ A) / torch.clamp_min(counts, 1.0)[:, None]


def _chunk_grams(A: torch.Tensor, mask_chunk: torch.Tensor) -> torch.Tensor:
    """The JAX package's masked Grams of a chunk of classes, (C, d, d):
    Σ_i mask[i, c] a_i a_iᵀ over all n rows for every class."""
    return torch.einsum("nd,nc,ne->cde", A, mask_chunk, A)


def _dual_solve_chunk(Q, R, dvec, pm_proj, mu_proj, s3, rhs, lam: float) -> torch.Tensor:
    """Per-class solves in the sample-span basis for a chunk of classes,
    the regime n + 3 < d (few rows a class, wide features) where every
    class covariance has rank ≤ n.

    With Aᵀ = QR (reduced, once per feature block) the class-c normal
    matrix lives in span(Q): jointXTX_c + λI = λI + Q H_c Qᵀ with
    H_c = R diag(d_c) Rᵀ + Σⱼ s3ⱼ (Qᵀpⱼ)(Qᵀpⱼ)ᵀ, d_c[i] = (1−w)/n + w·1[i∈c]/n_c
    and pⱼ ∈ {pm, μ_c, μ_c − pm}. So x = Q (λI + H_c)⁻¹ Qᵀr. The full
    inverse has a further term (r − QQᵀr)/λ, which is zero here (r lies in
    span(Q)) and is not computed: in floating point it is rounding noise,
    and at λ = 6e-5 dividing it by λ gives weights whose held-out
    predictions are noise. QR's column signs (cuSOLVER's may differ from
    LAPACK's) cancel in Q(·)Qᵀ.

    Q (d, n); R (n, n); dvec (C, n); pm_proj (n,) = Qᵀpm; mu_proj (C, n);
    s3 (3,); rhs (C, d) → (C, d)."""
    C, n = dvec.shape
    H = torch.matmul(R * dvec[:, None, :], R.T)
    Pp = torch.stack([pm_proj.expand(C, n), mu_proj, mu_proj - pm_proj], dim=1)  # (C, 3, n)
    H.baddbmm_((Pp * s3[None, :, None]).transpose(1, 2), Pp)
    H.diagonal(dim1=-2, dim2=-1).add_(lam)
    z = solve_each(H, rhs @ Q)
    return z @ Q.T


def _as_blocks(data, block_size: int, num_features: Optional[int]) -> List[torch.Tensor]:
    """A Dataset of (n, d) features, a Dataset whose payload is a tuple of
    column blocks, or a list or tuple of blocks → float32 column blocks (a
    whole matrix is read as column views, not copied)."""
    payload = data if isinstance(data, (list, tuple)) else Dataset.of(data).payload
    if isinstance(payload, (list, tuple)):
        return [Dataset.of(b).to_array().float() for b in payload]
    X = payload.float()
    d = num_features or X.shape[-1]
    return [X[..., i:min(i + block_size, d)] for i in range(0, d, block_size)]


class BlockWeightedLeastSquaresEstimator(LabelEstimator, CostModel):
    """Block-coordinate descent on the class-weighted mixture objective:
    ``num_iter`` sweeps over column blocks of ``block_size``, each block
    solving every class's system in chunks of classes.

    Its phases (``utils.timing``): ``wls.systems`` and ``wls.lu`` (the dense
    path's per-class systems and their solves), ``wls.dual`` (a dual chunk)
    and ``wls.block`` (the residual update).

    A block takes the dual (sample-space) path when λ > 0 and n + 3 < d,
    else the dense path: per-class d × d covariances, formed from each
    class's own rows (:class:`ClassRows`), built ``class_chunk`` classes at
    a time, and one LU solve per class. The fitted mapper carries
    ``fit_info``: the path of each block, the class chunks and the block
    steps (and, streamed, the scans)."""

    supports_streaming = True

    def __init__(self, block_size: int, num_iter: int, lam: float, mixture_weight: float,
                 num_features: Optional[int] = None, class_chunk: int = 8,
                 snapshot: bool = False):
        if snapshot:
            raise NotAbsorbable(
                "the block-weighted solver has no snapshot-able state: its iterates depend "
                "on block visitation order, so appended chunks cannot be folded in after "
                "the fit; fit with PerClassWeightedLeastSquaresEstimator(snapshot=True) for "
                "an absorbable weighted model")
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.mixture_weight = mixture_weight
        self.num_features = num_features
        self.class_chunk = class_chunk

    @property
    def weight(self) -> int:
        """Passes over the input, for a cache planner."""
        return 3 * self.num_iter + 1

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        return combine_cost(
            cost_signature(n, self.num_features or d, k, self.block_size, self.num_iter,
                           num_machines, self.class_chunk),
            cpu_weight, mem_weight, network_weight)

    def fit(self, data, labels: Dataset) -> BlockLinearMapper:
        """A ``ChunkedDataset`` is cached when the whole set fits
        ``KEYSTONE_CHUNK_CACHE_BUDGET`` (one scan) and solved in memory;
        a larger one streams (:meth:`train_streaming`). Either way the
        featurizer upstream ran chunk by chunk."""
        if getattr(data, "is_chunked", False):
            cached = data.cache()
            if cached.is_chunked:
                return self.train_streaming(cached, Dataset.of(labels).to_array())
            data = cached
        blocks = _as_blocks(data, self.block_size, self.num_features)
        Y = Dataset.of(labels).to_array().to(blocks[0].device, torch.float32)
        return self.train_with_l2(blocks, Y)

    def train_streaming(self, data, Y: torch.Tensor) -> BlockLinearMapper:
        """The out-of-core weighted solve over a chunked design matrix that
        is never whole; each scan recomputes the chunks from their source
        (:func:`~keystone_tpu_torch.linalg.weighted.solve_weighted_streaming`:
        num_iter × nblocks × (1 + ⌈k/C⌉) scans, the class-chunked Gram scans
        being the price of never holding the (k, bs, bs) class Grams).
        Chunks are cut to ``num_features`` columns. Every block takes the
        dense per-class systems, even where :meth:`train_with_l2` would take
        the dual path, as the JAX package's streaming solve does."""
        Y = torch.as_tensor(Y).float()
        if len(data) != Y.shape[0]:
            raise ValueError(f"chunked features have {len(data)} rows, labels {Y.shape[0]}")
        if self.num_features is not None:
            d = self.num_features

            def chunk_scan():
                return data.raw_chunks().then(lambda c: c[..., :d])
        else:
            chunk_scan = data.raw_chunks
        info: dict = {}
        Ws, b = solve_weighted_streaming(
            chunk_scan, Y, block_size=self.block_size, num_iter=self.num_iter, lam=self.lam,
            mixture_weight=self.mixture_weight, class_chunk=self.class_chunk, info=info)
        mapper = BlockLinearMapper(Ws, self.block_size, b=b)
        mapper.fit_info = info
        return mapper

    def _chunk_size(self, n: int, k: int, dual: bool) -> int:
        if dual:
            # the dual systems are (n + 3)² a class: batch up to ~256 MB of them
            return max(1, min(k, self.class_chunk * 8, (1 << 26) // max((n + 3) ** 2, 1)))
        return max(1, self.class_chunk)

    def train_with_l2(self, blocks: Sequence[torch.Tensor], Y: torch.Tensor) -> BlockLinearMapper:
        w, lam = self.mixture_weight, self.lam
        n, k = Y.shape
        y_idx = torch.argmax(Y, dim=1)
        onehot = F.one_hot(y_idx, k).float()
        counts = onehot.sum(dim=0)
        safe_counts = torch.clamp_min(counts, 1.0)
        joint_label_mean = 2 * w + 2 * (1 - w) * counts / n - 1.0
        R = Y - joint_label_mean
        Ws = [Y.new_zeros((A.shape[1], k)) for A in blocks]
        stats: List[Optional[tuple]] = [None] * len(blocks)
        class_rows: Optional[ClassRows] = None
        info = {"paths": [], "class_chunks": 0, "block_steps": 0}

        for _ in range(self.num_iter):
            for j, A in enumerate(blocks):
                d = A.shape[1]
                dual = lam > 0 and (n + 3) < d
                if stats[j] is None:
                    pop_mean = A.mean(dim=0)
                    _, class_means = _class_stats(A, y_idx, k)
                    joint_means = w * class_means + (1 - w) * pop_mean
                    if dual:
                        gram = torch.linalg.qr(A.T)  # Q (d, n), R (n, n)
                    else:
                        gram = torch.addr(A.T @ A, pop_mean, pop_mean, beta=1.0 / n, alpha=-1.0)
                        if class_rows is None:
                            class_rows = ClassRows(y_idx, k)
                    stats[j] = (gram, pop_mean, class_means, joint_means)
                    info["paths"].append("dual" if dual else "dense")
                gram_j, pop_mean, class_means, joint_means = stats[j]
                pop_xtr = (A.T @ R) / n
                residual_mean = R.mean(dim=0)
                weighted_R = onehot * R
                class_r_mean = weighted_R.sum(dim=0) / safe_counts
                class_xtr = (A.T @ weighted_R) / safe_counts
                del weighted_R
                if dual:
                    Qb, Rb = gram_j
                    s3 = torch.tensor([-(1 - w), -w, w * (1 - w)], dtype=torch.float32,
                                      device=A.device)
                    pm_proj = pop_mean @ Qb  # once a block, not once a chunk
                C = self._chunk_size(n, k, dual)
                delta = Y.new_empty((k, d))
                for c0 in range(0, k, C):
                    c1 = min(c0 + C, k)
                    mu_c = class_means[c0:c1]
                    mean_mixture = (1 - w) * residual_mean[c0:c1] + w * class_r_mean[c0:c1]
                    rhs = ((1 - w) * pop_xtr[:, c0:c1].T + w * class_xtr[:, c0:c1].T
                           - joint_means[c0:c1] * mean_mixture[:, None]
                           - lam * Ws[j][:, c0:c1].T)
                    if dual:
                        with phase("wls.dual") as out:
                            dvec = (1 - w) / n + w * onehot[:, c0:c1].T / safe_counts[c0:c1, None]
                            delta[c0:c1] = _dual_solve_chunk(Qb, Rb, dvec, pm_proj, mu_c @ Qb,
                                                             s3, rhs, lam)
                            out.append(delta)
                    else:
                        with phase("wls.systems") as out:
                            # jointXTX = (1−w)·pop_cov + w·class_cov + w(1−w)·ΔΔᵀ, in place
                            mean_diff = mu_c - pop_mean
                            G = class_rows.grams(A, c0, c1)
                            G /= safe_counts[c0:c1, None, None]
                            G.baddbmm_(mu_c[:, :, None], mu_c[:, None, :], beta=w, alpha=-w)
                            G.baddbmm_(mean_diff[:, :, None], mean_diff[:, None, :],
                                       alpha=w * (1 - w))
                            G += (1 - w) * gram_j
                            out.append(G)
                        with phase("wls.lu") as out:
                            delta[c0:c1] = _batched_solve(G, rhs, lam)
                            out.append(delta)
                        del G
                    info["class_chunks"] += 1
                Ws[j] += delta.T
                with phase("wls.block") as out:
                    R = torch.addmm(R, A, delta.T, alpha=-1.0)
                    out.append(R)
                info["block_steps"] += 1

        # the intercept: jointLabelMean − Σ_j ⟨joint_means_j[c], W_j[:, c]⟩
        b = joint_label_mean - sum(torch.einsum("cd,dc->c", stats[j][3], Ws[j])
                                   for j in range(len(blocks)))
        mapper = BlockLinearMapper(Ws, self.block_size, b=b)
        mapper.fit_info = info
        return mapper


def _joint_weighted_stats(X: torch.Tensor, Y: torch.Tensor, w: float):
    """The mixture algebra shared by the per-class estimators: (y_idx,
    counts, joint label means (k,), joint feature means (k, d))."""
    n, k = Y.shape
    y_idx = torch.argmax(Y, dim=1)
    counts, class_means = _class_stats(X, y_idx, k)
    joint_label_mean = 2 * w + 2 * (1 - w) * counts / n - 1.0
    joint_means = w * class_means + (1 - w) * X.mean(dim=0)
    return y_idx, counts, joint_label_mean, joint_means


def _class_sample_weights(y_idx: torch.Tensor, counts: torch.Tensor, c: int, w: float,
                          n: int) -> torch.Tensor:
    """diag(B) for class ``c``: (1−w)/n on every row plus w/n_c on the
    class's rows, which appear in both the population and the class
    statistics of the block solver."""
    return (1 - w) / n + torch.where(y_idx == c, w / torch.clamp_min(counts[c], 1.0), 0.0)


def _split(W: torch.Tensor, block_size: int) -> List[torch.Tensor]:
    return [W[i:min(i + block_size, W.shape[0])] for i in range(0, W.shape[0], block_size)]


class PerClassWeightedLeastSquaresEstimator(LabelEstimator, CostModel):
    """The same objective solved exactly, a class at a time, as a dense
    weighted ridge: the reference's agreement oracle for the block solver.
    Exact when the whole feature matrix fits; for tests and small problems.

    ``snapshot=True`` fits through the per-class raw accumulators
    (:class:`~keystone_tpu_torch.linalg.weighted.WeightedSolverState`: k
    class Grams and the label cross terms, associative over row blocks),
    in memory or over a ``ChunkedDataset``, and carries the state on the
    fitted mapper, so that ``FittedPipeline.absorb`` folds appended chunks
    into it. The exact per-class solve does not depend on the order of the
    rows, which is why this family absorbs and the iterated ones do not.
    The state solves in host float64; it is O(k·d²) on the host."""

    def __init__(self, block_size: int, num_iter: int, lam: float, mixture_weight: float,
                 num_features: Optional[int] = None, snapshot: bool = False):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.mixture_weight = mixture_weight
        self.num_features = num_features
        self.snapshot = snapshot

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        # every class pays the full weighted Gram (2·n·d²) and a d³ solve
        d = self.num_features or d
        return combine_cost(
            {"flops": k * (2.0 * n * d * d + d ** 3 / 3.0) / num_machines,
             "bytes": k * (n * d / num_machines + d * d),
             "network": d * (d + k), "passes": k},
            cpu_weight, mem_weight, network_weight)

    def _fit_snapshot(self, data, labels: Dataset) -> BlockLinearMapper:
        """Fold the data, chunked or not, into a WeightedSolverState, solve
        from it and carry its snapshot on the mapper."""
        state = WeightedSolverState(lam=float(self.lam), mixture_weight=float(self.mixture_weight),
                                    block_size=int(self.block_size))
        Y = Dataset.of(labels).to_array().float()
        if self.num_features is not None:
            d = self.num_features
            data = Dataset.of(data).map_batch(lambda X: X[..., :d])
        fold_into(state, data, Y, label="weighted_state")
        W, b = state.solve(device=Y.device)
        return BlockLinearMapper(_split(W, self.block_size), self.block_size, b=b,
                                 solver_state=state.snapshot())

    def fit(self, data, labels: Dataset) -> BlockLinearMapper:
        if self.snapshot:
            return self._fit_snapshot(data, labels)
        X = Dataset.of(data).to_array().float()
        Y = Dataset.of(labels).to_array().to(X.device, torch.float32)
        w = self.mixture_weight
        n, k = Y.shape
        d = X.shape[1]
        y_idx, counts, joint_label_mean, joint_means = _joint_weighted_stats(X, Y, w)
        eye = torch.eye(d, dtype=X.dtype, device=X.device)
        cols = []
        for c in range(k):
            b_i = _class_sample_weights(y_idx, counts, c, w, n)
            Xc = X - joint_means[c]
            yc = Y[:, c] - joint_label_mean[c]
            G = Xc.T @ (Xc * b_i[:, None])
            cols.append(torch.linalg.solve(G + self.lam * eye, Xc.T @ (yc * b_i)))
        W = torch.stack(cols, dim=1)
        b = joint_label_mean - torch.einsum("cd,dc->c", joint_means, W)
        return BlockLinearMapper(_split(W, self.block_size), self.block_size, b=b)


def _weighted_gram(Aj: torch.Tensor, mj: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    Ajc = Aj - mj
    return Ajc.T @ (Ajc * b[:, None])


def _reweighted_block_update(Aj, mj, G, Wj_old, R, y_zm, b, reg: float):
    """One block of the reweighted BCD: take the block's part out of the
    weighted residual R = B∘(XW), solve against Xⱼᵀ((B∘y) − R), put it back."""
    Ajc = Aj - mj
    R_wo = R - (Ajc @ Wj_old) * b[:, None]
    Wj = solve_spd(G, Ajc.T @ (y_zm * b[:, None] - R_wo), reg)
    return Wj, R_wo + (Ajc @ Wj) * b[:, None]


def solve_reweighted_l2(blocks: Sequence, y_zm, sample_weights, reg: float, num_iter: int = 1,
                        means: Optional[Sequence] = None) -> List[torch.Tensor]:
    """Iterative weighted BCD, W = (XᵀBX + λI)⁻¹ Xᵀ(B∘y) solved a feature
    block at a time (parity: ``internal/ReWeightedLeastSquares.scala``).

    ``blocks``: (n, bs_j) feature blocks; ``y_zm`` (n, k) or (n,) zero-mean
    labels; ``sample_weights`` (n,) the diagonal of B; ``means`` optional
    per-block column means, subtracted in each step. Each block's weighted
    Gram is formed once and kept across sweeps."""
    blocks = [torch.as_tensor(a).float() for a in blocks]
    dev = blocks[0].device
    y_zm = torch.as_tensor(y_zm).to(dev, torch.float32)
    b = torch.as_tensor(sample_weights).to(dev, torch.float32)
    if y_zm.ndim == 1:
        y_zm = y_zm[:, None]
    if means is None:
        means = [a.new_zeros((a.shape[1],)) for a in blocks]
    k = y_zm.shape[1]
    Ws = [a.new_zeros((a.shape[1], k)) for a in blocks]
    R = torch.zeros_like(y_zm)
    grams: List[Optional[torch.Tensor]] = [None] * len(blocks)
    for _ in range(num_iter):
        for j, Aj in enumerate(blocks):
            if grams[j] is None:
                grams[j] = _weighted_gram(Aj, means[j], b)
            Ws[j], R = _reweighted_block_update(Aj, means[j], grams[j], Ws[j], R, y_zm, b, reg)
    return Ws


class ReWeightedLeastSquaresEstimator(LabelEstimator, CostModel):
    """The per-class weighted objective solved by the iterative reweighted
    BCD: the third agreement point of the family beside the block solver
    and the exact per-class oracle."""

    def __init__(self, block_size: int, num_iter: int, lam: float, mixture_weight: float,
                 num_features: Optional[int] = None):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.mixture_weight = mixture_weight
        self.num_features = num_features

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        # per class: weighted per-block Grams once (n·d·bs), then num_iter
        # residual and solve sweeps (2·n·d and d·bs²)
        d = self.num_features or d
        bs = min(self.block_size, d)
        return combine_cost(
            {"flops": k * (n * d * bs + self.num_iter * (2.0 * n * d + d * bs * bs))
             / num_machines,
             "bytes": k * self.num_iter * (n * d / num_machines + d),
             "network": d * (bs + k), "passes": k * self.num_iter},
            cpu_weight, mem_weight, network_weight)

    def fit(self, data, labels: Dataset) -> BlockLinearMapper:
        X = Dataset.of(data).to_array().float()
        Y = Dataset.of(labels).to_array().to(X.device, torch.float32)
        w = self.mixture_weight
        n, k = Y.shape
        d = self.num_features or X.shape[1]
        X = X[:, :d]
        y_idx, counts, joint_label_mean, joint_means = _joint_weighted_stats(X, Y, w)
        splits = range(0, d, self.block_size)
        blocks = [X[:, i:min(i + self.block_size, d)] for i in splits]
        cols = []
        for c in range(k):
            mu = joint_means[c]
            ws_c = solve_reweighted_l2(
                blocks, Y[:, c] - joint_label_mean[c],
                _class_sample_weights(y_idx, counts, c, w, n), reg=self.lam,
                num_iter=self.num_iter,
                means=[mu[i:min(i + self.block_size, d)] for i in splits])
            cols.append(torch.cat([wj[:, 0] for wj in ws_c]))
        W = torch.stack(cols, dim=1)
        b = joint_label_mean - torch.einsum("cd,dc->c", joint_means, W)
        return BlockLinearMapper(_split(W, self.block_size), self.block_size, b=b)


class WeightedLeastSquaresEstimator(LabelEstimator, AutoSolverFrontDoor, CostModel, Optimizable):
    """The cost-model front door of the weighted family, as
    ``LeastSquaresEstimator`` is of the least-squares one: the block
    solver, the exact per-class solve and the reweighted BCD optimize the
    same objective, so the choice is one of cost, made by the solver
    chooser (in a graph by ``NodeOptimizationRule``, from sampled items and
    the full size). The number of machines is ``num_machines`` or 1. With a
    profile store configured (``KEYSTONE_PROFILE_DIR``), traced fits earn
    the family learned ``op/`` seconds-per-unit profiles, and later choices
    rank by predicted seconds (``cost/model.py``)."""

    def __init__(self, block_size: int, num_iter: int, lam: float, mixture_weight: float,
                 num_features: Optional[int] = None, num_machines: Optional[int] = None,
                 cpu_weight: Optional[float] = None, mem_weight: Optional[float] = None,
                 network_weight: Optional[float] = None):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.mixture_weight = mixture_weight
        self.num_features = num_features
        self.num_machines = num_machines
        self._init_chooser_weights(cpu_weight, mem_weight, network_weight)
        args = (block_size, num_iter, lam, mixture_weight)
        self.options: Sequence = [
            BlockWeightedLeastSquaresEstimator(*args, num_features=num_features),
            PerClassWeightedLeastSquaresEstimator(*args, num_features=num_features),
            ReWeightedLeastSquaresEstimator(*args, num_features=num_features),
        ]
        self.default = self.options[0]

    def fit(self, data, labels: Dataset) -> BlockLinearMapper:
        if isinstance(data, (list, tuple)):
            # pre-split blocks: only the block solver reads them
            return self.default.fit(data, labels)
        data = Dataset.of(data)
        # a chunked input is planned from its first rows, among the solvers
        # that stream (the block solver)
        sample = data.take(24) if data.is_chunked else data
        solver = self.sample_optimize([sample, Dataset.of(labels)], len(data),
                                      chunked=data.is_chunked)
        return solver.fit(data, labels)
