"""Least squares by normal equations (port of the in-memory solves of
``keystone_tpu/linalg/normal_equations.py``; the streaming accumulator is
not ported). The Gram and cross products run in FP32 (``row_matrix``)."""

from __future__ import annotations

from typing import Tuple

import torch

from .row_matrix import cross, gram, solve_spd


def cost_signature(n: int, d: int, k: int, machines: int = 1) -> dict:
    """Work terms for pricing an exact normal-equations solve: one pass
    over the data, the Gram and cross GEMMs dominate."""
    return {
        "flops": n * d * (d + k) / machines,
        "bytes": n * d / machines + d * d,
        "network": d * (d + k),
        "passes": 1,
    }


def solve_least_squares(A: torch.Tensor, b: torch.Tensor,
                        reg: float = 0.0) -> torch.Tensor:
    """argmin_X ‖AX − b‖² + reg·‖X‖² via (AᵀA + reg·I) X = Aᵀb; A is
    (n, d), b is (n, k), the result (d, k)."""
    return solve_spd(gram(A), cross(A, b), reg)


def solve_centered(
    A: torch.Tensor, b: torch.Tensor, reg: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Least squares on column-centered data: returns (weights, feature
    means, label means), so that (x − feature means)·W + label means fits."""
    A, b = A.float(), b.float()
    a_mean, b_mean = A.mean(dim=0), b.mean(dim=0)
    return solve_least_squares(A - a_mean, b - b_mean, reg), a_mean, b_mean


def solve_least_squares_with_intercept(
    A: torch.Tensor, b: torch.Tensor, reg: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-centered least squares: returns (weights, intercept)."""
    W, a_mean, b_mean = solve_centered(A, b, reg)
    return W, b_mean - a_mean @ W
