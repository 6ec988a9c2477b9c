"""The plain reference of TimitPipeline, in float64, written from
KeystoneML's description of the application and imports nothing of the
port. From the frames, the labels and the cosine weights it works out again
what the program derives:

1. features: cos(x W_iᵀ + b_i) for every branch i, the branches side by
   side in their order;
2. the column means of the training features, and the mean of the ±1 class
   indicators;
3. block-coordinate descent over column blocks of ``cosine_features``, for
   ``num_epochs`` sweeps from W = 0: with Ã_j the centered block,
   r = y − ν − pred + Ã_j W_j, W_j ← (Ã_jᵀÃ_j + λI)⁻¹ Ã_jᵀ r,
   pred ← pred + Ã_j (W_j(new) − W_j(old));
4. scores of the test set: (features − means) W + ν;
5. the features of the sampled rows ``inputs["feature_rows"]``, every
   branch.

The (n, d) feature matrix is never whole: each step computes its block of
features again from the frames, and each block's Cholesky factor is kept
from the first sweep."""

from __future__ import annotations

import torch

F64 = torch.float64


def _block(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cos(X @ W.T + b)


def reference(cfg: dict, inputs: dict, seed: int, device, wanted: set) -> dict:
    """Every number in ``wanted``: ``means``, ``weights``, ``features``
    (the sampled rows) and ``scores`` (the test set's)."""
    X = inputs["X_train"].to(F64)
    Xt = inputs["X_test"].to(F64)
    cos_W = inputs["cos_W"].to(F64)
    cos_b = inputs["cos_b"].to(F64)
    blocks = cos_W.shape[0]
    lam = cfg["lambda"]
    Y = 2.0 * torch.nn.functional.one_hot(inputs["y_train"], cfg["num_classes"]).to(F64) - 1.0
    nu = Y.mean(dim=0)
    y = Y - nu
    means = [_block(X, cos_W[j], cos_b[j]).mean(dim=0) for j in range(blocks)]
    Ws = [torch.zeros((cos_W.shape[1], y.shape[1]), dtype=F64, device=X.device)
          for _ in range(blocks)]
    factors = [None] * blocks
    pred = torch.zeros_like(y)
    for _ in range(cfg["num_epochs"]):
        for j in range(blocks):
            A = _block(X, cos_W[j], cos_b[j]) - means[j]
            r = y - pred + A @ Ws[j]
            if factors[j] is None:
                G = A.T @ A
                G.diagonal().add_(lam)
                factors[j] = torch.linalg.cholesky(G)
            new = torch.cholesky_solve(A.T @ r, factors[j])
            pred += A @ (new - Ws[j])
            Ws[j] = new
    scores = nu.expand(Xt.shape[0], -1).clone()
    for j in range(blocks):
        scores += (_block(Xt, cos_W[j], cos_b[j]) - means[j]) @ Ws[j]
    rows = X[inputs["feature_rows"].to(X.device)]
    out = {"means": torch.cat(means), "weights": torch.cat(Ws),
           "features": torch.cat([_block(rows, cos_W[j], cos_b[j]) for j in range(blocks)], dim=1),
           "scores": scores}
    return {k: v for k, v in out.items() if k in wanted}
