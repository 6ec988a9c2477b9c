"""Dense solves (port of ``solve_spd`` from
``keystone_tpu/linalg/row_matrix.py``)."""

from __future__ import annotations

import torch


def solve_spd(G: torch.Tensor, rhs: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """Solve (G + reg·I) X = rhs for symmetric positive-definite G by a
    lower Cholesky factorization."""
    G = G + reg * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    L = torch.linalg.cholesky(G)
    return torch.cholesky_solve(rhs, L, upper=False)
