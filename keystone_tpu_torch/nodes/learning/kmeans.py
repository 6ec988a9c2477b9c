"""k-means++ (port of ``keystone_tpu/nodes/learning/kmeans.py``).

One round is the k-means++ seeding; more rounds are Lloyd's iterations.
The seeding is k − 1 D²-weighted draws, each on the device from an
explicit ``torch.Generator`` with no host read: the draw inverts the
cumulative D² weights at a uniform point, and falls back to a uniform
index when every point is covered. The JAX package draws with
``jax.random``, so the two packages seed from different points; Lloyd's
iterations from one initialisation are the same computation. Lloyd's loop
reads its cost on the host once per iteration after the first, for the
stop test.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...data.dataset import Dataset
from ...workflow.transformer import Estimator, Transformer


def _sq_dists(X: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """½‖x‖² − x·μ + ½‖μ‖² per (sample, center)."""
    xsq = 0.5 * torch.sum(X * X, dim=1, keepdim=True)
    msq = 0.5 * torch.sum(means * means, dim=1)
    return xsq - X @ means.T + msq


def _one_hot_assign(X: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    idx = torch.argmin(_sq_dists(X, means), dim=1)
    return F.one_hot(idx, means.shape[0]).to(X.dtype)


def seed_plus_plus(X: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k centers: a uniform first point, then k − 1 points each drawn with
    probability proportional to its squared distance to the nearest center
    so far (uniform when every point is covered)."""
    n = X.shape[0]
    dev = X.device
    xsq_half = 0.5 * torch.sum(X * X, dim=1)
    first = torch.randint(0, n, (1,), device=dev, generator=generator)
    centers = [X.index_select(0, first)]
    cur_sq = torch.full((n,), float("inf"), device=dev, dtype=X.dtype)
    for _ in range(k - 1):
        c = centers[-1][0]
        cur_sq = torch.minimum(cur_sq, xsq_half - X @ c + 0.5 * torch.dot(c, c))
        probs = torch.clamp_min(cur_sq, 0.0).double()
        cdf = torch.cumsum(probs, 0)
        total = cdf[-1:]
        u = torch.rand(1, device=dev, generator=generator, dtype=torch.float64) * total
        weighted = torch.clamp(torch.searchsorted(cdf, u, right=True), max=n - 1)
        uniform = torch.randint(0, n, (1,), device=dev, generator=generator)
        idx = torch.where(total > 0, weighted, uniform)
        centers.append(X.index_select(0, idx))
    return torch.cat(centers, dim=0)


def lloyd(X: torch.Tensor, means: torch.Tensor, max_iterations: int,
          stop_tolerance: float) -> torch.Tensor:
    """Lloyd's iterations from ``means``. When the cost stops improving by
    ``stop_tolerance`` of itself, the current means are kept (no last
    update); an empty cluster keeps its center."""
    k = means.shape[0]
    prev = None
    for i in range(max_iterations):
        dists = _sq_dists(X, means)
        # the cost is read when a stop test uses it: this iteration's, or
        # the next one's as its previous cost
        if prev is not None or i + 1 < max_iterations:
            cost = np.float32(torch.mean(torch.min(dists, dim=1).values).item())
            if prev is not None and not cost_improved(prev, cost, stop_tolerance):
                break
            prev = cost
        assign = F.one_hot(torch.argmin(dists, dim=1), k).to(X.dtype)
        counts = assign.sum(dim=0)
        new_means = (assign.T @ X) / torch.clamp_min(counts, 1.0)[:, None]
        means = torch.where((counts > 0)[:, None], new_means, means)
    return means


def cost_improved(prev: np.float32, cost: np.float32, tol: float) -> bool:
    """The reference's test in float32: prev − cost ≥ tol·|prev|."""
    return bool(np.float32(prev - cost) >= np.float32(tol) * np.abs(prev))


class KMeansModel(Transformer):
    """Each vector → the one-hot of its nearest center."""

    row_local = True

    def __init__(self, means: torch.Tensor):
        self.means = means

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return _one_hot_assign(X, self.means)


class KMeansPlusPlusEstimator(Estimator):
    def __init__(self, num_means: int, max_iterations: int,
                 stop_tolerance: float = 1e-3, seed: int = 0):
        self.num_means = num_means
        self.max_iterations = max_iterations
        self.stop_tolerance = stop_tolerance
        self.seed = seed

    def fit(self, data) -> KMeansModel:
        return self.fit_matrix(Dataset.of(data).to_array())

    def fit_matrix(self, X: torch.Tensor, init: Optional[torch.Tensor] = None) -> KMeansModel:
        """Seed (or start from ``init``), then Lloyd's iterations."""
        X = X.float()
        if init is None:
            gen = torch.Generator(device=X.device).manual_seed(self.seed)
            init = seed_plus_plus(X, self.num_means, gen)
        return KMeansModel(lloyd(X, init, self.max_iterations, self.stop_tolerance))
