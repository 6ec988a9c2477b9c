"""Diagonal-covariance Gaussian mixture models (port of
``keystone_tpu/nodes/learning/gmm.py``): the posterior-assignment
transformer and EM with a k-means++ initialisation, thresholded
posteriors, variance floors and a minimum cluster size.

The Mahalanobis term is an expanded quadratic (‖x‖²/σ² − 2xμ/σ² + ‖μ‖²/σ²
as GEMMs) that cancels: its products run in FP32 with TF32 off, the
port's form of the JAX package's "high" precision, so the posteriors do
not depend on how the products are blocked.

EM is the JAX package's one ``lax.while_loop`` as a host loop: each
iteration runs the E and M steps on the device and then reads its cost and
its smallest cluster mass in one host read, for the stop tests. Both stop
tests keep the previous iteration's parameters.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...data.dataset import Dataset
from ...workflow.transformer import Estimator, Transformer
from .kmeans import KMeansPlusPlusEstimator

KMEANS_PLUS_PLUS_INITIALIZATION = "kmeans++"
RANDOM_INITIALIZATION = "random"


def _log_likelihoods(X: torch.Tensor, means: torch.Tensor, variances: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """(..., n, k) log prior − ½ Mahalanobis of rows X (..., n, d) against
    (k, d) means and variances."""
    llh = torch.matmul(X * X, (0.5 / variances).T)
    llh -= torch.matmul(X, (means / variances).T)
    llh += 0.5 * torch.sum(means * means / variances, dim=1)
    d = X.shape[-1]
    log_prior = (-0.5 * d * math.log(2 * math.pi)
                 - 0.5 * torch.sum(torch.log(variances), dim=1) + torch.log(weights))
    return llh.neg_().add_(log_prior)


def _thresholded(llh: torch.Tensor, weight_threshold: float) -> torch.Tensor:
    """Posteriors from log-likelihoods (in place): softmax over the
    components, those at or below ``weight_threshold`` zeroed, then
    renormalized."""
    q = llh.sub_(llh.max(dim=-1, keepdim=True).values).exp_()
    q /= q.sum(dim=-1, keepdim=True)
    q.masked_fill_(~(q > weight_threshold), 0.0)
    q /= q.sum(dim=-1, keepdim=True)
    return q


def posteriors(X: torch.Tensor, means: torch.Tensor, variances: torch.Tensor,
               weights: torch.Tensor, weight_threshold: float) -> torch.Tensor:
    """Thresholded posteriors (..., n, k) of rows X; means and variances
    are (k, d) here."""
    return _thresholded(_log_likelihoods(X, means, variances, weights), weight_threshold)


def e_step(X, means, variances, weights, weight_threshold) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean log-sum-exp likelihood, thresholded posteriors) from one
    Mahalanobis computation."""
    llh = _log_likelihoods(X, means, variances, weights)
    cost = torch.mean(torch.logsumexp(llh, dim=1))
    return cost, _thresholded(llh, weight_threshold)


def m_step(X, q, var_floor):
    """(weights, means, variances, cluster masses) from the posteriors."""
    q_sum = torch.sum(q, dim=0)
    weights = q_sum / X.shape[0]
    means = (q.T @ X) / q_sum[:, None]
    variances = (q.T @ (X * X)) / q_sum[:, None] - means * means
    return weights, means, torch.maximum(variances, var_floor), q_sum


def em_loop(X, means, variances, weights, var_floor, *, max_iterations: int,
            weight_threshold: float, stop_tolerance: float,
            min_cluster_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """EM from (k, d) means and variances and (k,) weights. It stops when
    the cost improves by less than ``stop_tolerance`` of itself or a
    cluster's mass falls under ``min_cluster_size``, keeping the previous
    iteration's parameters in both cases. Returns the parameters and the
    iterations run."""
    prev = None
    it = 0
    while it < max_iterations:
        cost, q = e_step(X, means, variances, weights, weight_threshold)
        new_w, new_m, new_v, q_sum = m_step(X, q, var_floor)
        del q
        cost_h, min_mass = torch.stack([cost, q_sum.min()]).tolist()  # the one host read
        cost_h = np.float32(cost_h)
        it += 1
        # the reference's test in float32: cost − prev ≥ tol·|prev|
        converged = prev is not None and not bool(
            np.float32(cost_h - prev) >= np.float32(stop_tolerance) * np.abs(prev))
        if converged or np.float32(min_mass) < min_cluster_size:
            break
        means, variances, weights = new_m, new_v, new_w
        prev = cost_h
    return means, variances, weights, it


class GaussianMixtureModel(Transformer):
    """Posterior assignments. Stored column-major as in the reference:
    ``means`` and ``variances`` are (d, k), ``weights`` (k,). ``fit_info``,
    when a fit made the model, holds its seconds (``seeding``, ``em``) and
    its EM ``iterations``."""

    row_local = True

    def __init__(self, means: torch.Tensor, variances: torch.Tensor, weights: torch.Tensor,
                 weight_threshold: float = 1e-4):
        self.means = torch.as_tensor(means, dtype=torch.float32)
        self.variances = torch.as_tensor(variances, dtype=torch.float32).to(self.means.device)
        self.weights = torch.as_tensor(weights, dtype=torch.float32).to(self.means.device)
        self.weight_threshold = weight_threshold
        self.k = self.means.shape[1]
        self.dim = self.means.shape[0]
        self.fit_info: Dict[str, float] = {}

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return posteriors(X, self.means.T, self.variances.T, self.weights,
                          self.weight_threshold)

    @staticmethod
    def load(mean_file: str, vars_file: str, weights_file: str,
             device=None) -> "GaussianMixtureModel":
        """The model from CSV files: means and variances (d, k), weights."""
        means = np.loadtxt(mean_file, delimiter=",", ndmin=2)
        variances = np.loadtxt(vars_file, delimiter=",", ndmin=2)
        weights = np.loadtxt(weights_file, delimiter=",").ravel()
        t = [torch.tensor(a, dtype=torch.float32, device=device)
             for a in (means, variances, weights)]
        return GaussianMixtureModel(*t)


class GaussianMixtureModelEstimator(Estimator):
    """EM for diagonal GMMs."""

    def __init__(self, k: int, max_iterations: int = 100, min_cluster_size: int = 40,
                 stop_tolerance: float = 1e-4, weight_threshold: float = 1e-4,
                 small_variance_threshold: float = 1e-2,
                 absolute_variance_threshold: float = 1e-9,
                 initialization_method: str = KMEANS_PLUS_PLUS_INITIALIZATION,
                 seed: int = 0):
        if k <= 0 or max_iterations <= 0 or min_cluster_size <= 0:
            raise ValueError("k, max_iterations, min_cluster_size must be > 0")
        self.k = k
        self.max_iterations = max_iterations
        self.min_cluster_size = min_cluster_size
        self.stop_tolerance = stop_tolerance
        self.weight_threshold = weight_threshold
        self.small_variance_threshold = small_variance_threshold
        self.absolute_variance_threshold = absolute_variance_threshold
        self.initialization_method = initialization_method
        self.seed = seed

    def fit(self, data) -> GaussianMixtureModel:
        return self.fit_matrix(Dataset.of(data).to_array())

    def initial(self, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(means, variances, weights) before EM, (k, d), (k, d), (k,):
        the moments of a one-round k-means++ clustering, or the reference's
        random initialisation (numpy draws).

        The round's Lloyd step can leave a cluster with no point, where the
        JAX package divides by its zero mass and EM runs on NaNs. Such a
        cluster starts here at its k-means center with the variance floor
        and a mass of one point; every other cluster starts as in JAX."""
        n, d = X.shape
        k = self.k
        if self.initialization_method == KMEANS_PLUS_PLUS_INITIALIZATION:
            km = KMeansPlusPlusEstimator(k, 1, seed=self.seed).fit_matrix(X)
            assign = km.forward(X)
            mass = torch.sum(assign, dim=0)
            filled = (mass > 0)[:, None]
            safe = torch.clamp_min(mass, 1.0)
            means = torch.where(filled, (assign.T @ X) / safe[:, None], km.means)
            variances = torch.where(filled, (assign.T @ (X * X)) / safe[:, None] - means * means,
                                    self.var_floor(X))
            return means, variances, safe / n
        rng = np.random.default_rng(self.seed)
        col_min = X.min(dim=0).values
        col_range = X.max(dim=0).values - col_min
        means = torch.from_numpy(rng.random((k, d))).to(X) * col_range + col_min
        variances = 0.1 * torch.ones((k, d), dtype=X.dtype, device=X.device) * col_range * col_range
        return means, variances, torch.full((k,), 1.0 / k, dtype=X.dtype, device=X.device)

    def var_floor(self, X: torch.Tensor) -> torch.Tensor:
        mean_g = X.mean(dim=0)
        var_g = (X * X).mean(dim=0) - mean_g * mean_g
        return torch.clamp_min(self.small_variance_threshold * var_g,
                               self.absolute_variance_threshold)

    def fit_matrix(self, X: torch.Tensor,
                   init: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
                   ) -> GaussianMixtureModel:
        """EM on the rows of X from ``init`` (means, variances, weights as
        (k, d), (k, d), (k,)) or from :meth:`initial`."""
        X = X.float()
        sync = X.is_cuda and torch.cuda.synchronize
        t0 = time.perf_counter()
        if init is None:
            init = self.initial(X)
        floor = self.var_floor(X)
        means, variances, weights = init
        variances = torch.maximum(variances, floor)
        if sync:
            sync(X.device)
        t1 = time.perf_counter()
        means, variances, weights, iterations = em_loop(
            X, means, variances, weights, floor,
            max_iterations=self.max_iterations, weight_threshold=self.weight_threshold,
            stop_tolerance=self.stop_tolerance, min_cluster_size=self.min_cluster_size)
        if sync:
            sync(X.device)
        model = GaussianMixtureModel(means.T, variances.T, weights, self.weight_threshold)
        model.fit_info = {"seeding": t1 - t0, "em": time.perf_counter() - t1,
                          "iterations": iterations}
        return model
