"""Fisher vector encoding (port of ``keystone_tpu/nodes/images/fisher_vector.py``;
the formula of Sánchez et al., IJCV 2013).

Items are (d, m) descriptor matrices; each encodes to a (d, 2k) matrix of
the first- and second-order statistics per mixture component. The
reference's second-order line carries a stray transpose on its
(μ² − σ²)·diag(s0) term that type-checks only when d = k; the published
formula scales each column by s0, as the JAX package does and as this does.

A batch is batched products: the posteriors of every descriptor of every
item, then two batched GEMMs for the statistics, in FP32 with TF32 off.
The second-order term subtracts products of these statistics, so TF32
noise there would show.
"""

from __future__ import annotations

import torch

from ...workflow.transformer import Estimator, Transformer
from ..learning.gmm import GaussianMixtureModel, GaussianMixtureModelEstimator, posteriors
from ..learning.pca import collect_columns


def fisher_vector(X: torch.Tensor, means: torch.Tensor, variances: torch.Tensor,
                  weights: torch.Tensor, weight_threshold: float) -> torch.Tensor:
    """X: (n, d, m) descriptor matrices; means and variances (d, k);
    weights (k,). Returns (n, d, 2k)."""
    m = X.shape[-1]
    q = posteriors(X.transpose(1, 2), means.T, variances.T, weights, weight_threshold)
    s0 = torch.mean(q, dim=1)[:, None, :]                  # (n, 1, k)
    s1 = torch.bmm(X, q) / m                                # (n, d, k)
    s2 = torch.bmm(X * X, q) / m
    del q
    fv1 = (s1 - means * s0) / (torch.sqrt(variances) * torch.sqrt(weights))
    fv2 = (s2 - 2.0 * means * s1 + (means * means - variances) * s0) / (
        variances * torch.sqrt(2.0 * weights))
    return torch.cat([fv1, fv2], dim=-1)


class FisherVector(Transformer):
    """The FV encoding of each descriptor matrix under ``gmm``."""

    row_local = True

    def __init__(self, gmm: GaussianMixtureModel):
        self.gmm = gmm

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        g = self.gmm
        return fisher_vector(X.float(), g.means, g.variances, g.weights, g.weight_threshold)

    def row_work_bytes(self, x: torch.Tensor) -> int:
        """The posteriors and the two Mahalanobis products (three m × k
        matrices), X², and the statistics."""
        d, m = x.shape[1], x.shape[2]
        k = self.gmm.k
        return 4 * (3 * m * k + d * m + 6 * d * k)


class GMMFisherVectorEstimator(Estimator):
    """Fit a GMM on the descriptor columns of the items, then encode with
    it."""

    def __init__(self, k: int, **gmm_kwargs):
        self.k = k
        self.gmm_kwargs = gmm_kwargs

    def fit(self, data) -> FisherVector:
        return FisherVector(GaussianMixtureModelEstimator(self.k, **self.gmm_kwargs)
                            .fit_matrix(collect_columns(data)))
