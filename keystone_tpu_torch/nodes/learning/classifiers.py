"""Classifiers and the least-squares solver front door (port of
``keystone_tpu/nodes/learning/classifiers.py``): multinomial naive Bayes,
multinomial logistic regression by L-BFGS, linear discriminant analysis,
and ``LeastSquaresEstimator``, which chooses its solver by the cost model.

Naive Bayes and logistic regression also fit and apply on ``SparseRows``
batches (text features) without densifying: the class sums and the
gradient are scatter-adds, the scores gathers (``data/sparse.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...data.dataset import Dataset
from ...data.sparse import SparseRows
from ...parallel.mesh import mesh_size, shard_batch
from ...workflow.node_optimization import Optimizable
from ...workflow.transformer import LabelEstimator, Transformer
from .cost import AutoSolverFrontDoor, CostModel
from .lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2, minimize_lbfgs
from .linear import (
    BlockLeastSquaresEstimator,
    LinearMapEstimator,
    LinearMapper,
    TSQRLeastSquaresEstimator,
)


def _int_labels(labels, device) -> torch.Tensor:
    return Dataset.of(labels).to_array().to(device).long().reshape(-1)


class NaiveBayesModel(Transformer):
    """x → log priors + log likelihoods · x."""

    row_local = True

    def __init__(self, pi: torch.Tensor, theta: torch.Tensor):
        self.pi = pi  # (k,) log priors
        self.theta = theta  # (k, d) log feature probabilities

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X @ self.theta.T + self.pi

    def apply_batch(self, data) -> Dataset:
        data = Dataset.of(data)
        if isinstance(data.payload, SparseRows):
            return Dataset(data.payload.matmul(self.theta.T.contiguous()) + self.pi)
        return super().apply_batch(data)

    def apply(self, x):
        sr = SparseRows.datum_from_pairs(x, self.theta.shape[1])
        if sr is not None:
            return (sr.to(self.theta.device).matmul(self.theta.T.contiguous()) + self.pi)[0]
        return super().apply(x)


class NaiveBayesEstimator(LabelEstimator):
    """Multinomial naive Bayes with Laplace smoothing ``lam``:
    π_c = log((n_c + λ)/(n + kλ)), θ_cj = log((Σ_c x_j + λ)/(Σ_c Σ_j x + dλ))."""

    def __init__(self, num_classes: int, lam: float = 1.0):
        self.num_classes = num_classes
        self.lam = lam

    def fit(self, data: Dataset, labels: Dataset) -> NaiveBayesModel:
        data = Dataset.of(data)
        k = self.num_classes
        if isinstance(data.payload, SparseRows):
            X = data.payload
            y = _int_labels(labels, X.device)
            # integer labels: one scatter-add of the n·m values
            feat_sums = X.label_sums(y, k)
            class_counts = torch.bincount(y, minlength=k).float()
        else:
            X = data.to_array().float()
            y = _int_labels(labels, X.device)
            onehot = F.one_hot(y, k).float()
            feat_sums = onehot.T @ X  # (k, d)
            class_counts = onehot.sum(dim=0)
        n, d = X.shape
        pi = torch.log(class_counts + self.lam) - math.log(n + k * self.lam)
        theta = torch.log(feat_sums + self.lam) - torch.log(
            feat_sums.sum(dim=1, keepdim=True) + d * self.lam)
        return NaiveBayesModel(pi, theta)


def _logistic_value_and_grad(W, A, y_onehot, lam):
    """Multinomial cross-entropy with an L2 penalty (the binary case is a
    2-column softmax)."""
    n = A.shape[0]
    logits = A @ W
    loss = -torch.sum(y_onehot * torch.log_softmax(logits, dim=-1)) / n \
        + 0.5 * lam * torch.sum(W * W)
    grad = A.T @ (torch.softmax(logits, dim=-1) - y_onehot) / n + lam * W
    return loss, grad


def _sparse_logistic_value_and_grad(W, X: SparseRows, y_onehot, lam):
    """The same objective on sparse rows: the logits a gather, the gradient
    a scatter-add, nothing densified."""
    n = y_onehot.shape[0]
    logits = X.matmul(W)
    loss = -torch.sum(y_onehot * torch.log_softmax(logits, dim=-1)) / n \
        + 0.5 * lam * torch.sum(W * W)
    grad = X.rmatmul(torch.softmax(logits, dim=-1) - y_onehot) / n + lam * W
    return loss, grad


class LogisticRegressionModel(Transformer):
    """The predicted class: argmax of the logits X·W."""

    row_local = True

    def __init__(self, W: torch.Tensor):
        self.W = W

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.argmax(X @ self.W, dim=-1)

    def apply_batch(self, data) -> Dataset:
        data = Dataset.of(data)
        if isinstance(data.payload, SparseRows):
            return Dataset(torch.argmax(data.payload.matmul(self.W), dim=-1))
        return super().apply_batch(data)

    def apply(self, x):
        sr = SparseRows.datum_from_pairs(x, self.W.shape[0])
        if sr is not None:
            return torch.argmax(sr.to(self.W.device).matmul(self.W), dim=-1)[0]
        return super().apply(x)

    def scores(self, X: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(X) @ self.W


class LogisticRegressionEstimator(LabelEstimator):
    """Multinomial logistic regression with an L2 penalty, fit from W = 0
    by :func:`~keystone_tpu_torch.nodes.learning.lbfgs.minimize_lbfgs`."""

    def __init__(self, num_classes: int, reg_param: float = 0.0,
                 num_iters: int = 100, convergence_tol: float = 1e-4):
        self.num_classes = num_classes
        self.reg_param = reg_param
        self.num_iters = num_iters
        self.convergence_tol = convergence_tol

    def fit(self, data: Dataset, labels: Dataset) -> LogisticRegressionModel:
        data = Dataset.of(data)
        if isinstance(data.payload, SparseRows):
            X = data.payload
            vag = _sparse_logistic_value_and_grad
        else:
            X = data.to_array().float()
            vag = _logistic_value_and_grad
        onehot = F.one_hot(_int_labels(labels, X.device), self.num_classes).float()
        if vag is _logistic_value_and_grad:
            # rows over the data axis of the default mesh
            X, onehot = shard_batch(X), shard_batch(onehot)
        W0 = torch.zeros((X.shape[1], self.num_classes), dtype=torch.float32, device=X.device)
        W = minimize_lbfgs(vag, W0, max_iterations=self.num_iters,
                           convergence_tol=self.convergence_tol,
                           vag_args=(X, onehot, self.reg_param))
        return LogisticRegressionModel(W)


class LinearDiscriminantAnalysis(LabelEstimator):
    """Multi-class LDA: the leading eigenvectors of S_W⁻¹S_B, computed in
    float64 numpy on the host as the JAX package does; the projection is a
    float32 :class:`LinearMapper` on the data's device."""

    def __init__(self, num_dimensions: int):
        self.num_dimensions = num_dimensions

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        Xt = Dataset.of(data).to_array()
        X = Xt.detach().cpu().numpy().astype(np.float64)
        y = Dataset.of(labels).to_array().cpu().numpy().ravel().astype(np.int64)
        total_mean = X.mean(axis=0)
        d = X.shape[1]
        sW = np.zeros((d, d))
        sB = np.zeros((d, d))
        for c in np.unique(y):
            Xc = X[y == c]
            mu = Xc.mean(axis=0)
            Z = Xc - mu
            sW += Z.T @ Z
            m = (mu - total_mean)[:, None]
            sB += Xc.shape[0] * (m @ m.T)
        evals, evecs = np.linalg.eig(np.linalg.inv(sW) @ sB)
        order = np.argsort(-np.abs(evals))[: self.num_dimensions]
        W = np.real(evecs[:, order]).astype(np.float32)
        return LinearMapper(torch.from_numpy(W).to(Xt.device))


class LeastSquaresEstimator(LabelEstimator, AutoSolverFrontDoor, CostModel, Optimizable):
    """Least squares that chooses its solver by the cost model, from the
    options (in the JAX package's order) dense L-BFGS, sparse L-BFGS, the
    block solver (1000, 3), exact normal equations and the augmented TSQR.
    In a graph ``NodeOptimizationRule`` makes the choice before anything
    runs, from sampled items and the full dataset size; called directly,
    ``fit`` makes it from the data's shape.

    The cluster weights are the reference's fitted constants. The number
    of machines is ``num_machines`` or the default mesh's size
    (``parallel.mesh.mesh_size``: one on one card). With a
    profile store configured (``KEYSTONE_PROFILE_DIR``), the chooser turns
    units into predicted seconds from the learned per-class throughput of
    traced fits (``cost/model.py``), and a chunked input leaves only the
    solvers with a streaming fit."""

    def __init__(self, lam: float = 0.0, num_machines: Optional[int] = None,
                 cpu_weight: float = 3.8e-4, mem_weight: float = 2.9e-1,
                 network_weight: float = 1.32):
        self.lam = lam
        self.num_machines = num_machines
        self.cpu_weight = cpu_weight
        self.mem_weight = mem_weight
        self.network_weight = network_weight
        self.options: Sequence = [
            DenseLBFGSwithL2(reg_param=lam, num_iterations=20),
            SparseLBFGSwithL2(reg_param=lam, num_iterations=20),
            BlockLeastSquaresEstimator(1000, 3, lam=lam),
            LinearMapEstimator(lam=lam),
            TSQRLeastSquaresEstimator(lam=lam),
        ]
        self.default = self.options[0]

    def shape_from_samples(self, samples, num_items: int, chunked: bool = False):
        """The chooser's shape of (data, labels) ``samples`` from a dataset of
        ``num_items`` rows: d and k from the samples, and their sparsity
        (the density of a SparseRows sample, the mean density of scipy
        sparse items, else 1.0)."""
        from ...cost import ShapeSignature

        sample, sample_labels = Dataset.of(samples[0]), Dataset.of(samples[1])
        if isinstance(sample.payload, SparseRows):
            sparsity, d = sample.payload.density(), sample.payload.num_features
        else:
            first = sample.first()
            if hasattr(first, "nnz"):  # scipy sparse items
                sparsity = float(np.mean([i.nnz / np.prod(i.shape) for i in sample.collect()]))
                d = first.shape[-1]
            else:
                sparsity, d = 1.0, first.shape[-1]
        n = num_items if num_items else len(sample)
        k = sample_labels.first().shape[-1]
        return ShapeSignature(n=int(n), d=int(d), k=int(k), sparsity=float(sparsity),
                              chunked=bool(chunked), machines=int(self.num_machines or mesh_size()))

    def optimize(self, sample: Dataset, sample_labels: Dataset,
                 total_n: Optional[int] = None, chunked: bool = False) -> LabelEstimator:
        """The solver for data of which ``sample`` is a part and ``total_n``
        the size (the sample's own size when None); ``chunked`` data
        arrives as out-of-core chunks, which only a streaming solver takes."""
        n = total_n if total_n is not None else len(Dataset.of(sample))
        return self.sample_optimize([sample, sample_labels], n, chunked=chunked)

    def fit(self, data: Dataset, labels: Dataset):
        """Choose the solver, then fit it. A chunked ``data`` is planned from
        its first 24 rows and handed to the chosen solver's streaming fit."""
        data, labels = Dataset.of(data), Dataset.of(labels)
        chunked = data.is_chunked
        sample = data.take(24) if chunked else data
        solver = self.optimize(sample, labels, total_n=len(data), chunked=chunked)
        return solver.fit(data, labels)
