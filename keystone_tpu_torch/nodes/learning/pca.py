"""The PCA family (port of ``keystone_tpu/nodes/learning/pca.py``): a local
fit (SVD, or the Gram matrix's ``eigh`` for tall samples), the TSQR fit,
the randomized sketch, and the cost-model chooser of the column estimators.

"Column" estimators treat each item, a (d, m) descriptor matrix, as m
separate d-vectors. Every product runs in FP32 with TF32 off, the port's
form of the JAX package's "high" precision. On one device the TSQR fit is
one QR of the centered sample (``linalg/tsqr.py``; one QR a data-axis
slot on a mesh of several), and the chooser prices the default mesh's
machines unless told how many.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...data.dataset import Dataset
from ...linalg.tsqr import tsqr_r
from ...parallel.mesh import mesh_size
from ...workflow.node_optimization import Optimizable
from ...workflow.transformer import Estimator, Transformer
from .cost import (
    DEFAULT_CPU_WEIGHT,
    DEFAULT_MEM_WEIGHT,
    DEFAULT_NETWORK_WEIGHT,
    CostModel,
)


def enforce_matlab_sign_convention(pca: torch.Tensor) -> torch.Tensor:
    """Each column's largest-|coefficient| entry made positive: a column
    whose maximum is not its largest magnitude is negated."""
    col_max = pca.max(dim=0).values
    abs_col_max = pca.abs().max(dim=0).values
    signs = torch.where(col_max == abs_col_max, 1.0, -1.0).to(pca.dtype)
    return pca * signs


class PCATransformer(Transformer):
    """x → pca_matᵀ x for d-vectors; ``pca_mat`` is (d, dims)."""

    row_local = True

    def __init__(self, pca_mat: torch.Tensor):
        self.pca_mat = pca_mat

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X @ self.pca_mat


class BatchPCATransformer(Transformer):
    """Descriptor matrices (n, d, m) → (n, dims, m)."""

    row_local = True

    def __init__(self, pca_mat: torch.Tensor):
        self.pca_mat = pca_mat

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.pca_mat.T, X)

    def row_work_bytes(self, x: torch.Tensor) -> int:
        return self.pca_mat.shape[1] * x.shape[-1] * 4


def _pca_svd(X: torch.Tensor) -> torch.Tensor:
    Xc = X - X.mean(dim=0)
    _, _, vt = torch.linalg.svd(Xc, full_matrices=False)
    return enforce_matlab_sign_convention(vt.T)


def _pca_gram_eigh(X: torch.Tensor) -> torch.Tensor:
    """The directions from the d×d Gram matrix of the centered sample:
    ``eigh`` gives ascending eigenvalues, so the columns are reversed to
    the SVD's descending order before the sign convention."""
    Xc = X - X.mean(dim=0)
    _, vecs = torch.linalg.eigh(Xc.T @ Xc)
    return enforce_matlab_sign_convention(vecs.flip(1))


def _pca_directions(X: torch.Tensor) -> torch.Tensor:
    """SVD for short samples, the Gram ``eigh`` for tall ones (n ≥ 8·d)."""
    n, d = X.shape
    if n >= 8 * d:
        return _pca_gram_eigh(X)
    return _pca_svd(X)


class PCAEstimator(Estimator, CostModel):
    """Local PCA over the sample rows."""

    def __init__(self, dims: int):
        self.dims = dims

    def fit(self, data) -> PCATransformer:
        return PCATransformer(self.compute_pca(Dataset.of(data).to_array().float()))

    def compute_pca(self, X: torch.Tensor) -> torch.Tensor:
        return _pca_directions(X)[:, :self.dims]

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        return max(cpu_weight * n * d * d, mem_weight * n * d) + network_weight * n * d


class DistributedPCAEstimator(Estimator, CostModel):
    """PCA from the R factor of the centered sample's QR, then a d×d SVD
    of R."""

    def __init__(self, dims: int):
        self.dims = dims

    def fit(self, data) -> PCATransformer:
        X = Dataset.of(data).to_array().float()
        R = tsqr_r(X - X.mean(dim=0))
        _, _, vt = torch.linalg.svd(R, full_matrices=False)
        return PCATransformer(enforce_matlab_sign_convention(vt.T)[:, :self.dims])

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        log2m = math.log2(max(num_machines, 2))
        flops = n * d * d / num_machines + d * d * d * log2m
        return max(cpu_weight * flops, mem_weight * n * d) + network_weight * d * d * log2m


class ApproximatePCAEstimator(Estimator):
    """Randomized sketch PCA (Halko, Martinsson and Tropp, algorithms 4.4
    and 5.1). The Gaussian test matrix is drawn by an explicit
    ``torch.Generator`` seeded with ``seed``: another stream than the JAX
    package's ``jax.random``, so the two packages agree on the subspace,
    not on the draws."""

    def __init__(self, dims: int, q: int = 10, p: int = 5, seed: int = 0):
        self.dims = dims
        self.q = q
        self.p = p
        self.seed = seed

    def fit(self, data) -> PCATransformer:
        return PCATransformer(self._approximate_pca(Dataset.of(data).to_array().float()))

    def _approximate_pca(self, A: torch.Tensor) -> torch.Tensor:
        k, p, q = self.dims, self.p, self.q
        d = A.shape[1]
        gen = torch.Generator(device=A.device).manual_seed(self.seed)
        omega = torch.randn((d, k + p), generator=gen, device=A.device, dtype=A.dtype)
        A = A - A.mean(dim=0)
        Q = torch.linalg.qr(A @ omega).Q
        for _ in range(q):
            Qh = torch.linalg.qr(A.T @ Q).Q
            Q = torch.linalg.qr(A @ Qh).Q
        _, _, vt = torch.linalg.svd(Q.T @ A, full_matrices=False)
        return enforce_matlab_sign_convention(vt.T)[:, :k]


def collect_columns(data) -> torch.Tensor:
    """Per-item (d, m) matrices as (items·m, d) sample rows: a stacked
    (n, d, m) batch, or a list of matrices of any m."""
    data = Dataset.of(data)
    if data.is_batched:
        X = data.to_array()
        return X.transpose(1, 2).reshape(-1, X.shape[1]).float()
    return torch.cat([torch.as_tensor(item).T for item in data], dim=0).float()


class LocalColumnPCAEstimator(Estimator, CostModel):
    def __init__(self, dims: int):
        self.dims = dims
        self._est = PCAEstimator(dims)

    def fit(self, data) -> BatchPCATransformer:
        return BatchPCATransformer(self._est.compute_pca(collect_columns(data)))

    def cost(self, *a):
        return self._est.cost(*a)


class DistributedColumnPCAEstimator(Estimator, CostModel):
    def __init__(self, dims: int):
        self.dims = dims
        self._est = DistributedPCAEstimator(dims)

    def fit(self, data) -> BatchPCATransformer:
        return BatchPCATransformer(self._est.fit(Dataset.of(collect_columns(data))).pca_mat)

    def cost(self, *a):
        return self._est.cost(*a)


class ColumnPCAEstimator(Estimator, Optimizable):
    """The cost-model choice between the local and the TSQR column PCA, made
    by ``NodeOptimizationRule`` from a sample of the descriptor matrices
    (``sample_optimize``) or at fit from the data itself. ``num_machines``
    None prices the default mesh's size (one on one card)."""

    def __init__(self, dims: int, num_machines: Optional[int] = None,
                 cpu_weight: float = DEFAULT_CPU_WEIGHT,
                 mem_weight: float = DEFAULT_MEM_WEIGHT,
                 network_weight: float = DEFAULT_NETWORK_WEIGHT):
        self.dims = dims
        self.num_machines = num_machines
        self.cpu_weight = cpu_weight
        self.mem_weight = mem_weight
        self.network_weight = network_weight
        self.local = LocalColumnPCAEstimator(dims)
        self.distributed = DistributedColumnPCAEstimator(dims)

    def sample_optimize(self, samples, num_items: int) -> Estimator:
        return self.optimize(samples[0], total_items=num_items)

    def optimize(self, sample, total_items: Optional[int] = None) -> Estimator:
        """The cheaper estimator for ``sample``'s shape, with its descriptor
        count scaled from the sample's items to ``total_items``."""
        sample = Dataset.of(sample)
        if sample.is_batched:
            items, d, m = sample.to_array().shape
            n = items * m
        else:
            mats = sample.collect()
            items, d = len(mats), mats[0].shape[0]
            n = sum(x.shape[1] for x in mats)
        if total_items is not None and items:
            n = int(n * total_items / items)
        args = (n, d, self.dims, 1.0, self.num_machines or mesh_size(),
                self.cpu_weight, self.mem_weight, self.network_weight)
        if self.local.cost(*args) <= self.distributed.cost(*args):
            return self.local
        return self.distributed

    def fit(self, data) -> BatchPCATransformer:
        return self.optimize(data).fit(data)
