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

:func:`solve_blockwise_l2_streaming` solves over a design matrix that is
never whole: each block step is one scan of a chunk source, and only the
labels, the prediction buffer, one chunk and the per-block Grams stay on
the card. The JAX package's model-sharded scan and its laned streaming
body (one staging lane per mesh device) are not ported: a scan here runs
on one card.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..data.pipeline_scan import scan_pipeline
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


def _check_width(width: int, d: int, what: str) -> None:
    """Raise unless a chunk is ``d`` wide. The JAX package reads d from the
    caller's means and slices whatever width the chunks have, so a chunk
    narrower than d gives wrong weights without an error; the port
    refuses."""
    if width != d:
        raise ValueError(f"{what}: the chunks are {width} columns wide, the solve expects "
                         f"d = {d}")


def stream_column_means(chunk_scan, device=None, d: Optional[int] = None):
    """One scan of ``chunk_scan()`` (a re-iterable chunk source): the column
    means of the chunked design matrix and its row count. Every chunk must
    be as wide as the first (and ``d`` wide when ``d`` is given). Chunks
    are copied to ``device`` when they are produced elsewhere."""
    total, n, width = None, 0, d
    for chunk in scan_pipeline(chunk_scan(), label="column_means", device=device):
        chunk = chunk.float()
        if width is None:
            width = int(chunk.shape[1])
        _check_width(int(chunk.shape[1]), width, "stream_column_means")
        s = chunk.sum(dim=0)
        total = s if total is None else total + s
        n += int(chunk.shape[0])
    if total is None:
        raise ValueError("empty chunk source")
    return total / n, n


def _stream_chunk_update(A_chunk, pred, G, c, W_cur, delta_prev, means, y_zm, row0: int,
                         jprev: int, jcur: int, cur_size: int, prev_size: int,
                         do_gram: bool) -> None:
    """One chunk of one streaming block step, in place on ``pred``, ``G``
    and ``c``: first the previous block's delayed prediction update (so a
    block step costs one scan, not two), then this block's Gram and cross
    products against the updated prediction. The centered column block of
    the chunk is its one temporary (the JAX package's program fuses the
    subtraction into the GEMM reads)."""
    rows = A_chunk.shape[0]
    pred_c = pred[row0:row0 + rows]
    if delta_prev is not None:
        Ap = A_chunk[:, jprev:jprev + prev_size] - means[jprev:jprev + prev_size]
        pred_c += Ap @ delta_prev
        del Ap
    Ac = A_chunk[:, jcur:jcur + cur_size] - means[jcur:jcur + cur_size]
    r = y_zm[row0:row0 + rows] - pred_c + Ac @ W_cur
    if do_gram:
        G.addmm_(Ac.T, Ac)
    c.addmm_(Ac.T, r)


def solve_blockwise_l2_streaming(
    chunk_scan,
    y_zm: torch.Tensor,
    reg: float,
    block_size: int,
    num_iter: int = 1,
    means: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    """BCD least squares over a design matrix that is never whole.

    ``chunk_scan()`` returns a fresh iterator of (rows, d) chunks, the same
    chunks on every scan (the lineage contract of ``data/chunked.py``);
    chunks produced off the labels' device are copied there. ``y_zm`` is
    the (n, k) centered labels, ``means`` the (d,) column means
    (:func:`stream_column_means`) or None for no centering. Returns the
    per-block weights; the last block may be narrower.

    Scans: num_iter × nblocks, one per block step, each also applying the
    previous block's prediction update; every scan's first chunk must be
    d wide. Each block's Gram is formed in the first sweep and kept (nblocks
    × block_size², 268 MB at d 16,384 in blocks of 4096). Every block step
    adds one to ``solve_blockwise_l2_streaming.block_steps``."""
    y_zm = y_zm.float()
    n, k = y_zm.shape
    dev = y_zm.device
    if means is not None:
        means = means.float().reshape(-1).to(dev)
        d = int(means.shape[0])
    else:
        it = chunk_scan()
        try:
            first = next(iter(it), None)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        if first is None:
            raise ValueError("empty chunk source")
        d = int(first.shape[1])
        del first
        means = torch.zeros(d, dtype=torch.float32, device=dev)
    starts = list(range(0, d, block_size))
    sizes = [min(block_size, d - j) for j in starts]
    nblocks = len(starts)
    Ws = [torch.zeros((sz, k), dtype=torch.float32, device=dev) for sz in sizes]
    grams: List[Optional[torch.Tensor]] = [None] * nblocks
    pred = torch.zeros_like(y_zm)
    delta_prev = None
    jprev, prev_size = 0, sizes[0]
    for _ in range(num_iter):
        for b in range(nblocks):
            do_gram = grams[b] is None
            G = (torch.zeros((sizes[b], sizes[b]), dtype=torch.float32, device=dev)
                 if do_gram else grams[b])
            c = torch.zeros((sizes[b], k), dtype=torch.float32, device=dev)
            row0 = 0
            for chunk in scan_pipeline(chunk_scan(), label="bcd.stream", device=dev):
                chunk = chunk.float()
                rows = int(chunk.shape[0])
                if row0 == 0:
                    _check_width(int(chunk.shape[1]), d, "solve_blockwise_l2_streaming")
                if row0 + rows > n:
                    raise ValueError(f"the chunk source produced more than the labels' {n} rows")
                _stream_chunk_update(chunk, pred, G, c, Ws[b], delta_prev, means, y_zm, row0,
                                     jprev, starts[b], sizes[b], prev_size, do_gram)
                row0 += rows
                del chunk
            if row0 != n:
                raise ValueError(f"chunk source produced {row0} rows, labels have {n}")
            grams[b] = G
            W_new = solve_spd(G, c, reg)
            delta_prev = W_new - Ws[b]
            Ws[b] = W_new
            jprev, prev_size = starts[b], sizes[b]
            solve_blockwise_l2_streaming.block_steps += 1
    return Ws


solve_blockwise_l2_streaming.block_steps = 0
