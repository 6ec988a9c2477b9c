"""Class-weighted least squares, the in-memory part (port of
``_batched_solve`` and ``cost_signature`` from
``keystone_tpu/linalg/weighted.py``).

The streaming solver body, its scans and ``WeightedSolverState`` are not
ported: they come with the out-of-core fit.
"""

from __future__ import annotations

import math

import torch


def solve_each(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(C, m, m), (C, m) → (C, m): A_c x_c = b_c by one LU with partial
    pivoting per system. On CUDA a batched ``torch.linalg.solve`` of large
    systems goes to MAGMA's batched LU, which is written for small ones
    (1000 systems of 4096² took 25 s on an H100, against 0.68 s for their
    operations at the FP32 peak); one call per system is cuSOLVER's getrf."""
    return torch.stack([torch.linalg.solve(A[c], b[c]) for c in range(A.shape[0])])


def _batched_solve(jointXTX: torch.Tensor, rhs: torch.Tensor, lam: float) -> torch.Tensor:
    """(C, d, d), (C, d) → (C, d): the ridge systems (jointXTX_c + λI) x_c =
    rhs_c.

    LU with partial pivoting, not Cholesky: a class's covariance is rank
    deficient whenever d exceeds its number of rows (ImageNet's Fisher
    vectors: d = 4096, a few images a class), and a float32 Cholesky fails
    on the near-semidefinite jointXTX that results. The reference solves
    with Breeze's float64 LU."""
    eye = torch.eye(jointXTX.shape[-1], dtype=jointXTX.dtype, device=jointXTX.device)
    return solve_each(jointXTX + lam * eye, rhs)


def cost_signature(n: int, d: int, k: int, block_size: int, num_iter: int,
                   machines: int = 1, class_chunk: int = 8) -> dict:
    """Work terms of the block-weighted mixture solve, as the JAX package
    prices it: per sweep each block pays one cross-term scan (2·n·bs·k),
    ⌈k/C⌉ masked-Gram scans (n·k·bs² in all) and k per-class bs³ solves."""
    bs = min(block_size, d)
    C = max(1, min(k, max(class_chunk, (1 << 26) // max(bs * bs, 1))))
    scans_per_block = 1 + math.ceil(k / C)
    return {
        "flops": num_iter * (2.0 * n * d * k + n * k * d * bs + k * d * bs * bs) / machines,
        "bytes": num_iter * ((d / bs) * scans_per_block * n * d / machines + d * k),
        "network": 2.0 * num_iter * d * (bs + k) * math.log2(max(machines, 2)),
        "passes": num_iter * (d / max(bs, 1)) * scans_per_block,
    }
