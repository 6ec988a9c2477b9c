"""Dense solver building blocks (port of ``gram``, ``cross`` and
``solve_spd`` from ``keystone_tpu/linalg/row_matrix.py``).

Precision: the JAX package runs every solver GEMM at ``SOLVER_PRECISION =
"high"`` (a 3-pass bf16 product on the TPU's matrix units, close to full
float32). The Hopper form of that choice is plain float32 with TF32 off,
which ``keystone_tpu_torch`` switches off for cuBLAS and cuDNN when it is
imported; every GEMM here then runs in full FP32.
"""

from __future__ import annotations

import torch


def gram(A: torch.Tensor) -> torch.Tensor:
    """AᵀA in float32."""
    A = A.float()
    return A.T @ A


def cross(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """AᵀB in float32."""
    return A.float().T @ B.float()


def solve_spd(G: torch.Tensor, rhs: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """Solve (G + reg·I) X = rhs for symmetric positive-definite G by a
    lower Cholesky factorization.

    Unlike the JAX package, whose ``cho_factor`` returns NaNs for a matrix
    that is not positive definite, ``torch.linalg.cholesky`` raises
    (``torch.linalg.LinAlgError``). The raise is kept: a solve that cannot
    be done fails where it happens instead of spreading NaNs."""
    G = G + reg * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    L = torch.linalg.cholesky(G)
    return torch.cholesky_solve(rhs, L, upper=False)
