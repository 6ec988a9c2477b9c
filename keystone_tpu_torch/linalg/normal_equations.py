"""Least squares by normal equations (port of
``keystone_tpu/linalg/normal_equations.py``). The Gram and cross products
run in FP32 (``row_matrix``); the streaming solve accumulates them over
row chunks, so only the (d, d) Gram and one chunk are on the card."""

from __future__ import annotations

from typing import Tuple

import torch

from ..data.pipeline_scan import scan_pipeline
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


def gram_accumulate(G: torch.Tensor, C: torch.Tensor, A_chunk: torch.Tensor,
                    y_chunk: torch.Tensor) -> None:
    """One streaming update, in place: G += AᵀA, C += Aᵀy."""
    G.addmm_(A_chunk.T, A_chunk)
    C.addmm_(A_chunk.T, y_chunk)


def solve_least_squares_streaming(chunks, reg: float = 0.0, device=None) -> torch.Tensor:
    """The exact ridge solve over an iterable of (A_chunk, y_chunk) row
    chunks, through the pipelined scan (chunks produced elsewhere are
    copied to ``device``); returns the (d, k) solution."""
    G = C = None
    for A_chunk, y_chunk in scan_pipeline(chunks, label="normal_eq", device=device):
        A_chunk, y_chunk = A_chunk.float(), y_chunk.float()
        if A_chunk.dim() != 2 or y_chunk.dim() != 2:
            raise ValueError(f"chunks must be 2-D (A: {tuple(A_chunk.shape)}, "
                             f"y: {tuple(y_chunk.shape)})")
        if G is None:
            d, k = A_chunk.shape[1], y_chunk.shape[1]
            G = torch.zeros((d, d), dtype=torch.float32, device=A_chunk.device)
            C = torch.zeros((d, k), dtype=torch.float32, device=A_chunk.device)
        elif A_chunk.shape[1] != G.shape[0]:
            raise ValueError(f"a chunk is {A_chunk.shape[1]} columns wide, the first "
                             f"was {G.shape[0]}")
        gram_accumulate(G, C, A_chunk, y_chunk)
    if G is None:
        raise ValueError("no chunks")
    return solve_spd(G, C, reg)
