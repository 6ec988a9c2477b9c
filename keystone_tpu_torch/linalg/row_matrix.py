"""Dense solver building blocks (port of
``keystone_tpu/linalg/row_matrix.py``: ``gram``, ``cross``, ``solve_spd``
and ``RowShardedMatrix``).

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


class RowShardedMatrix:
    """A tall-skinny matrix laid out by rows over the data axis of a mesh
    (mlmatrix's ``RowPartitionedMatrix.fromArray``, LinearMapper.scala:121),
    for host code that wants the reference's vocabulary. ``data`` is the
    (n, d) tensor, placed by ``parallel.mesh.shard_batch``."""

    def __init__(self, data, mesh=None):
        from ..parallel.mesh import default_mesh, shard_batch

        self.mesh = mesh or default_mesh()
        self.data = shard_batch(torch.as_tensor(data), self.mesh)

    @property
    def shape(self):
        return self.data.shape

    def gram(self) -> torch.Tensor:
        return gram(self.data)

    def t_times(self, other) -> torch.Tensor:
        o = other.data if isinstance(other, RowShardedMatrix) else other
        return cross(self.data, o)

    def qr_r(self) -> torch.Tensor:
        from .tsqr import tsqr_r

        return tsqr_r(self.data, mesh=self.mesh)
