"""Block-coordinate-descent least squares (port of the in-memory solvers
of ``keystone_tpu/linalg/bcd.py``).

Objective: min_W  ‖Σ_j Ã_j W_j − y‖² + λ Σ_j ‖W_j‖²  with one W_j per
feature block and Ã_j = A_j − m_j the block centered by its column means.
A host loop walks the blocks; each block step is a residual GEMM, the
block's Gram and cross products, a Cholesky solve and an in-place update
of the prediction buffer (the JAX package donates that buffer to its
step program). ``num_iter = 1`` is the one-pass variant that MNIST, CIFAR,
VOC and ImageNet fit with; TIMIT sweeps five times. Each sweep computes
every block's Gram anew, as the JAX package's scan does, so that the two
compute the same thing (keeping the factors across sweeps is later work).

The streaming variants and the model-sharded scan of the JAX package are
not ported.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from .row_matrix import cross, gram, solve_spd


def _block_update_impl(
    Aj: torch.Tensor,
    mj: Optional[torch.Tensor],
    Wj_old: torch.Tensor,
    pred: torch.Tensor,
    y: torch.Tensor,
    reg: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One BCD block step on a raw (uncentered) block ``Aj``, which may be
    a column view of the whole design matrix. Returns (Wj_new, pred);
    ``pred`` is the caller's buffer, updated in place.

        r_j = y − pred + Ã_j W_j_old
        W_j ← (Ã_jᵀÃ_j + λI)⁻¹ Ã_jᵀ r_j ;  pred ← pred + Ã_j (W_j − W_j_old)

    The centered block Ã_j = A_j − m_j is the step's only copy of block
    data: XLA fuses the subtract into the GEMM reads, eager PyTorch cannot.
    Every step adds one to ``_block_update_impl.steps``."""
    Ajc = Aj if mj is None else Aj - mj
    r = y - pred + Ajc @ Wj_old
    Wj = solve_spd(gram(Ajc), cross(Ajc, r), reg)
    pred.add_(Ajc @ (Wj - Wj_old))
    _block_update_impl.steps += 1
    return Wj, pred


_block_update_impl.steps = 0


def cost_signature(n: int, d: int, k: int, block_size: int, num_iter: int,
                   machines: int = 1) -> dict:
    """Work terms for pricing a BCD solve: ``num_iter`` sweeps, each reading
    the data once per block and touching one (block, k) slab of the model.
    Every term carries ``num_iter``, so that ``combine_cost``'s max
    distributes like the reference's ``num_iter · (max(...) + net)``."""
    return {
        "flops": num_iter * n * d * (block_size + k) / machines,
        "bytes": num_iter * (n * d / machines + d * k),
        "network": 2.0 * num_iter * d * (block_size + k) * math.log2(max(machines, 2)),
        "passes": 3 * num_iter + 1,
    }


def _block_means(blocks: Sequence[torch.Tensor],
                 y: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Column means of every block, and of the labels."""
    return [b.mean(dim=0) for b in blocks], y.mean(dim=0)


def solve_blockwise_l2(
    blocks: Sequence[torch.Tensor],
    y: torch.Tensor,
    reg: float,
    num_iter: int = 1,
    means: Optional[Sequence[torch.Tensor]] = None,
    init: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """L2-regularised least squares over a list of (n, b_j) feature blocks
    (the VectorSplitter output; they may differ in width). ``means``, the
    per-block column means, are subtracted inside each step. ``init``, the
    per-block starting weights, warm-starts the descent with the prediction
    buffer made consistent (pred = Σ Ã_j W_j⁰). Returns the per-block
    (b_j, k) weights."""
    y = y.float()
    k = y.shape[1]
    blocks = [b.float() for b in blocks]
    if means is None:
        means = [None] * len(blocks)
    pred = torch.zeros_like(y)
    if init is None:
        Ws = [torch.zeros((b.shape[1], k), dtype=torch.float32, device=y.device)
              for b in blocks]
    else:
        if len(init) != len(blocks):
            raise ValueError(f"init has {len(init)} blocks, expected {len(blocks)}")
        Ws = [w.float() for w in init]
        for Aj, mj, Wj in zip(blocks, means, Ws):
            pred.add_((Aj if mj is None else Aj - mj) @ Wj)
    for _ in range(num_iter):
        for j, Aj in enumerate(blocks):
            Ws[j], pred = _block_update_impl(Aj, means[j], Ws[j], pred, y, reg)
    return Ws


def solve_blockwise_l2_scan(
    A: torch.Tensor,
    y: torch.Tensor,
    reg: float,
    block_size: int,
    num_iter: int = 1,
    means: Optional[torch.Tensor] = None,
    init: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """BCD over uniform column blocks of one (n, d) matrix, d divisible by
    ``block_size``: the list form on the column views ``A[:, j·bs:(j+1)·bs]``,
    so no second copy of A is ever made (at full width A is the memory
    budget); the centered block of each step is the only per-block copy.
    ``means`` is the (d,) column-mean vector, ``init`` the (d, k) starting
    weights. Returns the (d, k) weights. (The JAX package compiles the pass
    as one scan; eager PyTorch has no reason to.)"""
    A = A.float()
    n, d = A.shape
    if d % block_size != 0:
        raise ValueError(f"d={d} not divisible by block_size={block_size}")
    spans = [slice(j, j + block_size) for j in range(0, d, block_size)]
    if means is not None:
        means = means.float().reshape(d)
    if init is not None:
        init = init.float().reshape(d, -1)
    return torch.cat(solve_blockwise_l2(
        [A[:, sl] for sl in spans], y, reg, num_iter,
        means=None if means is None else [means[sl] for sl in spans],
        init=None if init is None else [init[sl] for sl in spans]))
