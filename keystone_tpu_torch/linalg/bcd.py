"""Block-coordinate-descent least squares (port of the in-memory solvers
of ``keystone_tpu/linalg/bcd.py``).

Objective: min_W  ‖Σ_j Ã_j W_j − y‖² + λ Σ_j ‖W_j‖²  with one W_j per
feature block and Ã_j = A_j − m_j the block centered by its column means.
A host loop walks the blocks; each block step is a residual GEMM, the
block's Gram and cross products, a Cholesky solve and an in-place update
of the prediction buffer (the JAX package donates that buffer to its
step program). ``num_iter = 1`` is the one-pass variant that MNIST, CIFAR,
VOC and ImageNet fit with; TIMIT sweeps five times.

Ã_j and λ do not change between sweeps, so neither does the lower Cholesky
factor L_j of Ã_jᵀÃ_j + λI. Every body solves through
:func:`_block_solve`: a block's first step forms its Gram and factors it;
where a later sweep reads the factor (``num_iter > 1`` and the block no
wider than the rows, :func:`_keeps_factor`) the solve keeps L_j on the
block's device and its later steps solve from it, with no Gram, no
factorization and no host read of the factorization's status. The kept
factors cost Σ b_j² floats, at most the design matrix's n·d since b_j ≤ n
(3.4 GB for TIMIT's 50 blocks of 4096), and live only as long as one solve
call: nothing is kept across fits or λ values. The JAX package's scan forms
every Gram anew each sweep; the factor is the one it recomputes.

:func:`solve_blockwise_l2_streaming` solves over a design matrix that is
never whole: each block step is one scan of a chunk source, and only the
labels, the prediction buffer, one chunk and the kept factors stay on
the card. Its laned body (:func:`_solve_blockwise_l2_streaming_lanes`)
deals the chunks over the data-axis slots of the mesh, one partial Gram
and cross term a lane, reduced once a block step.

On a mesh with a model axis wider than one, :func:`solve_blockwise_l2_scan`
places A's column blocks, the means and W over the model-axis slots
(:func:`_bcd_scan_model_sharded`), as the JAX package does. The block loop
stays sequential. On one card the slots share the card, so the layout
buys structure, not memory: every block is still on that card.
"""

from __future__ import annotations

import math
from contextvars import ContextVar
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from ..data.pipeline_scan import scan_pipeline
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, NamedSharding, _placed, mesh_or_none
from .row_matrix import cross, gram


def _keeps_factor(num_iter: int, rows: int, width: int) -> bool:
    """Whether a solve keeps a block's Cholesky factor: only where a later
    sweep reads it, and only for a block no wider than the rows, so that
    the factors cost at most what the design matrix costs."""
    return num_iter > 1 and width <= rows


def _block_solve(factors: Dict[Hashable, Optional[torch.Tensor]], key: Hashable,
                 gram_of: Callable[[], torch.Tensor], rhs: torch.Tensor,
                 reg: float) -> torch.Tensor:
    """Solve (G + λI) W = rhs for one block, G the block's Gram.

    With no factor kept under ``key`` in ``factors`` the Gram is formed
    (``gram_of()``) and factored as ``row_matrix.solve_spd`` does, raising
    ``torch.linalg.LinAlgError`` where it is not positive definite; the
    lower factor is kept where ``factors`` holds ``key`` (a solve that keeps
    the block's factor puts the key there, holding None, before its first
    step). Otherwise the kept factor solves alone. Adds one to
    ``_block_solve.factors_formed`` or ``_block_solve.factors_reused``."""
    L = factors.get(key)
    if L is None:
        G = gram_of()
        L = torch.linalg.cholesky(G + reg * torch.eye(G.shape[0], dtype=G.dtype, device=G.device))
        del G
        if key in factors:
            factors[key] = L
        _block_solve.factors_formed += 1
    else:
        _block_solve.factors_reused += 1
    return torch.cholesky_solve(rhs, L, upper=False)


_block_solve.factors_formed = 0
_block_solve.factors_reused = 0

# The factors kept by the in-memory solve running in this context, by
# (block, means) identity. The block step reads them here rather than from
# a seventh argument, so that it keeps the six arguments its callers and
# the wrappers put in its place rely on.
_KEPT_FACTORS: ContextVar[Optional[Dict[Hashable, Optional[torch.Tensor]]]] = ContextVar(
    "bcd_kept_factors", default=None)


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
    Inside :func:`solve_blockwise_l2` the solve's kept factor of this block
    replaces the Gram and its factorization (:func:`_block_solve`); called
    alone, the step forms and factors and keeps nothing. Every step adds
    one to ``_block_update_impl.steps``."""
    Ajc = Aj if mj is None else Aj - mj
    r = y - pred + Ajc @ Wj_old
    Wj = _block_solve(_KEPT_FACTORS.get() or {}, (id(Aj), id(mj)), lambda: gram(Ajc),
                      cross(Ajc, r), reg)
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
    buffer made consistent (pred = Σ Ã_j W_j⁰). Each block's Cholesky
    factor is kept from its first step to the call's end where
    :func:`_keeps_factor` says so. Returns the per-block (b_j, k)
    weights."""
    y = y.float()
    k = y.shape[1]
    blocks = [b.float() for b in blocks]
    if means is None:
        means = [None] * len(blocks)
    pred = torch.zeros_like(y)
    if init is None:
        Ws = [torch.zeros((b.shape[1], k), dtype=torch.float32, device=b.device)
              for b in blocks]
    else:
        if len(init) != len(blocks):
            raise ValueError(f"init has {len(init)} blocks, expected {len(blocks)}")
        Ws = [w.float() for w in init]
        for Aj, mj, Wj in zip(blocks, means, Ws):
            pred.add_((Aj if mj is None else Aj - mj) @ Wj)
    kept = _KEPT_FACTORS.set({(id(Aj), id(mj)): None for Aj, mj in zip(blocks, means)
                              if _keeps_factor(num_iter, *Aj.shape)})
    try:
        for _ in range(num_iter):
            for j, Aj in enumerate(blocks):
                # a block on another device (a model slot) takes the buffer there
                Ws[j], pred = _block_update_impl(Aj, means[j], Ws[j], pred.to(Aj.device),
                                                 y.to(Aj.device), reg)
    finally:
        _KEPT_FACTORS.reset(kept)
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
    as one scan; eager PyTorch has no reason to.) On a mesh with a model
    axis (:func:`_bcd_scan_model_sharded`) a cold start places each view on
    its block's model slot and W carries the ``P(model)`` layout."""
    A = A.float()
    n, d = A.shape
    if d % block_size != 0:
        raise ValueError(f"d={d} not divisible by block_size={block_size}")
    spans = [slice(j, j + block_size) for j in range(0, d, block_size)]
    if means is not None:
        means = means.float().reshape(d)
    if init is not None:
        init = init.float().reshape(d, -1)
    # a warm start keeps the unsharded form, as in the JAX package
    placed = None if init is not None else _bcd_scan_model_sharded(n, d, block_size)
    devs = placed or [A.device] * len(spans)
    W = torch.cat([w.to(y.device) for w in solve_blockwise_l2(
        [A[:, sl].to(dv) for sl, dv in zip(spans, devs)], y, reg, num_iter,
        means=None if means is None else [means[sl].to(dv) for sl, dv in zip(spans, devs)],
        init=None if init is None else [init[sl] for sl in spans])])
    return W if placed is None else _placed(W, NamedSharding(mesh_or_none(), (MODEL_AXIS,)))


def _bcd_scan_model_sharded(n: int, d: int, block_size: int) -> Optional[List[torch.device]]:
    """The device of each column block's model slot on the default mesh,
    or None where the JAX package's model-sharded scan does not apply: no
    mesh or a model axis of one, d not splitting into whole blocks a slot,
    or n not dividing the data axis.

    The reference spreads d across its cluster (VectorSplitter and
    BlockLinearMapper.scala:199-257), and the JAX package shards A's
    columns, the means and W over its model axis so that a d too large for
    one device's memory spreads over several. Each model slot holds whole
    blocks: block j is on slot ``j // (d / n_model / block_size)`` of the
    model axis (at data index 0), and its step runs on that slot's device.
    The loop over blocks stays sequential, as in the reference. On one card
    every slot is the card, so this buys the JAX package's structure, not
    memory."""
    m = mesh_or_none()
    if m is None:
        return None
    n_model = m.shape[MODEL_AXIS]
    if n_model <= 1 or d % n_model != 0 or (d // n_model) % block_size != 0:
        return None
    if n % m.shape[DATA_AXIS] != 0:
        return None
    slots = list(m.devices[0, :].flat)
    return [slots[j // (d // n_model)].device for j in range(0, d, block_size)]


def _check_width(width: int, d: int, what: str) -> None:
    """Raise unless a chunk is ``d`` wide. The JAX package reads d from the
    caller's means and slices whatever width the chunks have, so a chunk
    narrower than d gives wrong weights without an error; the port
    refuses."""
    if width != d:
        raise ValueError(f"{what}: the chunks are {width} columns wide, the solve expects "
                         f"d = {d}")


def stream_column_means(chunk_scan, device=None, d: Optional[int] = None,
                        lanes: Optional[int] = None):
    """One scan of ``chunk_scan()`` (a re-iterable chunk source): the column
    means of the chunked design matrix and its row count. Every chunk must
    be as wide as the first (and ``d`` wide when ``d`` is given). Chunks
    are copied to ``device`` when they are produced elsewhere. ``lanes``
    (default ``parallel.lanes.scan_lanes()``): one partial sum a lane,
    reduced once at the end."""
    from ..parallel.lanes import reduce_lane_partials, scan_lanes

    if lanes is None:
        lanes = scan_lanes()
    pipe = scan_pipeline(chunk_scan(), label="column_means", device=device, lanes=lanes)
    lanes = getattr(pipe, "lanes", lanes)
    sums: list = [None] * lanes
    n, width = 0, d
    for i, chunk in enumerate(pipe):
        chunk = chunk.float()
        if width is None:
            width = int(chunk.shape[1])
        _check_width(int(chunk.shape[1]), width, "stream_column_means")
        s = chunk.sum(dim=0)
        lane = i % lanes
        sums[lane] = s if sums[lane] is None else sums[lane] + s
        n += int(chunk.shape[0])
    total = reduce_lane_partials(sums, scan=pipe, devices=getattr(pipe, "lane_devices", None))
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
    lanes: Optional[int] = None,
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
    d wide. Each block's Gram is accumulated over the first sweep's scan and
    factored (:func:`_block_solve`); with ``num_iter > 1`` the lower factor
    is kept for the later sweeps, which accumulate the cross term alone and
    solve from it (nblocks × block_size² floats, 268 MB at d 16,384 in
    blocks of 4096; a block wider than the rows keeps nothing and forms its
    Gram each sweep). Every block step adds one to
    ``solve_blockwise_l2_streaming.block_steps``.

    ``lanes`` (default ``parallel.lanes.scan_lanes()``, which is 1 on one
    card without a mesh of several slots): with more than one, the laned
    body :func:`_solve_blockwise_l2_streaming_lanes` runs."""
    from ..parallel.lanes import scan_lanes

    if lanes is None:
        lanes = scan_lanes()
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
    if lanes > 1:
        return _solve_blockwise_l2_streaming_lanes(chunk_scan, y_zm, reg, starts, sizes,
                                                   num_iter, means, lanes)
    nblocks = len(starts)
    Ws = [torch.zeros((sz, k), dtype=torch.float32, device=dev) for sz in sizes]
    factors = {b: None for b in range(nblocks) if _keeps_factor(num_iter, n, sizes[b])}
    pred = torch.zeros_like(y_zm)
    delta_prev = None
    jprev, prev_size = 0, sizes[0]
    for _ in range(num_iter):
        for b in range(nblocks):
            do_gram = factors.get(b) is None
            G = (torch.zeros((sizes[b], sizes[b]), dtype=torch.float32, device=dev)
                 if do_gram else None)
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
            W_new = _block_solve(factors, b, lambda: G, c, reg)
            del G
            delta_prev = W_new - Ws[b]
            Ws[b] = W_new
            jprev, prev_size = starts[b], sizes[b]
            solve_blockwise_l2_streaming.block_steps += 1
    return Ws


solve_blockwise_l2_streaming.block_steps = 0


def _solve_blockwise_l2_streaming_lanes(chunk_scan, y_zm: torch.Tensor, reg: float,
                                        starts: List[int], sizes: List[int], num_iter: int,
                                        means: torch.Tensor, lanes: int) -> List[torch.Tensor]:
    """The laned body of :func:`solve_blockwise_l2_streaming`.

    Chunk ``i`` goes to lane ``i % lanes``; its prediction slab and label
    slice are placed on the lane's slot at the first scan and stay there, so
    each chunk's update is local to its lane. Each block step broadcasts
    the block's W (and the previous block's delta) to the lanes once, each
    lane folds its own Gram and cross partials over its chunks, and the
    partials are summed once, in lane order; the solve runs on the sums on
    the labels' device. Collectives a scan: at most 2·lanes broadcasts and
    2·(lanes − 1) reduction hops, however many chunks stream. A scan must
    produce the chunk boundaries of the first (a lane's slabs are those
    chunks' rows)."""
    from ..parallel.lanes import lane_devices, record_scan_collectives, reduce_lane_partials

    n, k = y_zm.shape
    dev = y_zm.device
    d = int(means.shape[0])
    devs = lane_devices(lanes)
    means_lane = [means.to(s.device) for s in devs]
    pred_chunks: List[torch.Tensor] = []
    y_chunks: List[torch.Tensor] = []
    chunk_rows: List[int] = []
    Ws = [torch.zeros((sz, k), dtype=torch.float32, device=dev) for sz in sizes]
    factors = {b: None for b in range(len(starts)) if _keeps_factor(num_iter, n, sizes[b])}
    delta_prev = None
    jprev, prev_size = 0, sizes[0]
    first_scan = True
    for _ in range(num_iter):
        for b in range(len(starts)):
            do_prev = delta_prev is not None
            do_gram = factors.get(b) is None
            G_l: List[Optional[torch.Tensor]] = [None] * lanes
            c_l: List[Optional[torch.Tensor]] = [None] * lanes
            # the block's model read by every lane: counted as broadcasts
            W_lane = [Ws[b].to(s.device) for s in devs]
            delta_lane = [delta_prev.to(s.device) if do_prev else None for s in devs]
            pipe = scan_pipeline(chunk_scan(), label="bcd.stream", lanes=lanes, devices=devs)
            record_scan_collectives(pipe, (2 if do_prev else 1) * lanes)
            row0 = 0
            for i, chunk in enumerate(pipe):
                lane = i % lanes
                # a source that hands over a scan of its own bypassed the
                # lanes' staging: the chunk joins its lane's slabs
                chunk = chunk.float().to(devs[lane].device)
                rows = int(chunk.shape[0])
                if row0 == 0:
                    _check_width(int(chunk.shape[1]), d, "solve_blockwise_l2_streaming")
                if first_scan:
                    if row0 + rows > n:
                        raise ValueError(
                            f"the chunk source produced more than the labels' {n} rows")
                    chunk_rows.append(rows)
                    y_chunks.append(y_zm[row0:row0 + rows].to(devs[lane].device))
                    pred_chunks.append(torch.zeros((rows, k), dtype=torch.float32,
                                                   device=devs[lane].device))
                elif i >= len(chunk_rows) or chunk_rows[i] != rows:
                    raise ValueError("chunk source changed boundaries between scans "
                                     f"(chunk {i}: {rows} rows)")
                if do_gram and G_l[lane] is None:
                    G_l[lane] = chunk.new_zeros((sizes[b], sizes[b]))
                if c_l[lane] is None:
                    c_l[lane] = chunk.new_zeros((sizes[b], k))
                _stream_chunk_update(chunk, pred_chunks[i], G_l[lane], c_l[lane], W_lane[lane],
                                     delta_lane[lane], means_lane[lane], y_chunks[i], 0, jprev,
                                     starts[b], sizes[b], prev_size, do_gram)
                row0 += rows
                del chunk
            if row0 != n:
                raise ValueError(f"chunk source produced {row0} rows, labels have {n}")
            first_scan = False
            G = reduce_lane_partials(G_l, scan=pipe, devices=devs).to(dev) if do_gram else None
            c = reduce_lane_partials(c_l, scan=pipe, devices=devs)
            if c is None:
                raise ValueError("empty chunk source")
            W_new = _block_solve(factors, b, lambda: G, c.to(dev), reg)
            del G
            delta_prev = W_new - Ws[b]
            Ws[b] = W_new
            jprev, prev_size = starts[b], sizes[b]
            solve_blockwise_l2_streaming.block_steps += 1
    return Ws
