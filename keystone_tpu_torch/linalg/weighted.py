"""Class-weighted least squares at the linalg layer (port of
``keystone_tpu/linalg/weighted.py``): the per-class batched solve, the
cost terms, the out-of-core solve over a chunk source
(:func:`solve_weighted_streaming`) and the snapshot-able per-class state
(:class:`WeightedSolverState`).

The streaming solve keeps the (n, k) labels and residual, the per-block
joint statistics, one accumulator of class Grams and one chunk on the
card; the design matrix is never whole. Each block step is one cross
scan, which also applies the previous block's delayed residual update,
then one scan for each chunk of C classes forming those classes' Grams.
A class's Gram is formed from its own rows (:class:`ClassRows`), not from
the JAX package's masked product over every row of the chunk: the same
sums in another order, at 1/C of the work. The JAX package's laned body
(one staging lane per mesh device) is not ported: a scan runs on one card.

Precision: λ is as small as 6e-5 at ImageNet's settings, so every product
here runs in full float32 (TF32 stays off, as the package sets it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.pipeline_scan import scan_pipeline
from ..utils.timing import phase
from .accumulators import MomentsState, as_chunk


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


def class_chunk_size(k: int, bs: int, class_chunk: int) -> int:
    """Classes a Gram scan accumulates: at least ``class_chunk``, grown
    until the (C, bs, bs) accumulator reaches 256 MB of float32."""
    return max(1, min(k, max(class_chunk, (1 << 26) // max(bs * bs, 1))))


def cost_signature(n: int, d: int, k: int, block_size: int, num_iter: int,
                   machines: int = 1, class_chunk: int = 8) -> dict:
    """Work terms of the block-weighted mixture solve, as the JAX package
    prices it: per sweep each block pays one cross-term scan (2·n·bs·k),
    ⌈k/C⌉ masked-Gram scans (n·k·bs² in all) and k per-class bs³ solves."""
    bs = min(block_size, d)
    C = class_chunk_size(k, bs, class_chunk)
    scans_per_block = 1 + math.ceil(k / C)
    return {
        "flops": num_iter * (2.0 * n * d * k + n * k * d * bs + k * d * bs * bs) / machines,
        "bytes": num_iter * ((d / bs) * scans_per_block * n * d / machines + d * k),
        "network": 2.0 * num_iter * d * (bs + k) * math.log2(max(machines, 2)),
        "passes": num_iter * (d / max(bs, 1)) * scans_per_block,
    }


class ClassRows:
    """The rows of each class, for Grams formed from a class's own rows:
    a stable sort of the rows by class and each class's first position in
    it. The counts are read to the host once."""

    def __init__(self, y_idx: torch.Tensor, k: int):
        self.order = torch.argsort(y_idx, stable=True)
        self.counts = np.bincount(y_idx.cpu().numpy(), minlength=k)
        self.starts = np.concatenate([[0], np.cumsum(self.counts)[:-1]])

    def grams(self, A: torch.Tensor, c0: int, c1: int,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Σ_{i∈c} a_i a_iᵀ for the classes c0 ≤ c < c1, (C, d, d), added
        into ``out`` when it is given: each class's rows gathered and padded
        with zero rows to the chunk's largest class, then one batched GEMM.
        The same sums as the JAX package's masked Grams over all rows, in
        another order, with n/C times less work."""
        counts = self.counts[c0:c1]
        m = int(counts.max()) if len(counts) else 0
        if m == 0:
            if out is not None:
                return out
            return A.new_zeros((c1 - c0, A.shape[1], A.shape[1]))
        pos = np.arange(m)
        idx = np.minimum(self.starts[c0:c1, None] + pos, len(self.order) - 1)
        keep = torch.from_numpy(pos < counts[:, None]).to(A.device, A.dtype)
        rows = A.index_select(0, self.order[torch.from_numpy(idx.reshape(-1)).to(A.device)])
        rows = rows.reshape(c1 - c0, m, A.shape[1]) * keep[..., None]
        if out is None:
            return torch.bmm(rows.transpose(1, 2), rows)
        return out.baddbmm_(rows.transpose(1, 2), rows)


# -- the streaming solve ------------------------------------------------------


def _block_layout(chunk_scan, block_size: int) -> Tuple[List[int], List[int]]:
    """d read from one chunk; the blocks' (starts, sizes)."""
    d = None
    it = chunk_scan()
    try:
        for chunk in it:
            d = int(chunk.shape[-1])
            break
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    if d is None:
        raise ValueError("empty chunk source")
    starts = list(range(0, d, block_size))
    return starts, [min(block_size, d - j0) for j0 in starts]


class _ChunkLayout:
    """The row span and :class:`ClassRows` of each chunk, recorded on the
    first scan; every later scan must produce the same boundaries (the
    lineage contract: a scan that saw other chunks would mix data)."""

    def __init__(self, y_idx: torch.Tensor, k: int):
        self.y_idx, self.k = y_idx, k
        self.spans: List[Tuple[int, int]] = []
        self.rows: List[ClassRows] = []

    def see(self, i: int, row0: int, rows: int) -> None:
        if i == len(self.spans):
            self.spans.append((row0, rows))
            self.rows.append(ClassRows(self.y_idx[row0:row0 + rows], self.k))
        elif i > len(self.spans) or self.spans[i] != (row0, rows):
            raise ValueError(f"chunk source changed boundaries between scans (chunk {i}: "
                             f"{rows} rows at row {row0})")


def _wls_stream_scan1(A_chunk, R, delta_prev, y_idx, xtR, xtRc, cr_sum, G, class_sums, pop_sum,
                      row0: int, jprev: int, jcur: int, bs: int, prev_bs: int, k: int,
                      do_stats: bool) -> None:
    """One chunk of a streaming weighted block step, in place: the previous
    block's delayed residual update on the chunk's rows, then this block's
    raw cross terms and the class sums of the residual (and, on the first
    sweep, its Gram, class sums and column sums)."""
    rows = A_chunk.shape[0]
    Ac = A_chunk[:, jcur:jcur + bs]
    Rc = R[row0:row0 + rows]
    if delta_prev is not None:
        Rc.addmm_(A_chunk[:, jprev:jprev + prev_bs], delta_prev, alpha=-1.0)
    oh = F.one_hot(y_idx[row0:row0 + rows], k).to(A_chunk.dtype)
    ohR = oh * Rc
    xtR.addmm_(Ac.T, Rc)
    xtRc.addmm_(Ac.T, ohR)
    cr_sum += ohR.sum(dim=0)
    if do_stats:
        G.addmm_(Ac.T, Ac)
        class_sums.addmm_(oh.T, Ac)
        pop_sum += Ac.sum(dim=0)


def _wls_class_delta(grams, counts, class_means, pop_mean, joint_means, pop_xtr, class_xtr,
                     residual_mean, class_r_mean, pop_cov, W_cur, w: float, lam: float, c0: int,
                     Ccur: int) -> torch.Tensor:
    """The mixture algebra of a chunk of classes and its ridge solves,
    (Ccur, bs); ``grams`` (the classes' raw Grams) is overwritten with the
    systems: jointXTX = (1−w)·pop_cov + w·class_cov + w(1−w)·ΔΔᵀ."""
    cs = slice(c0, c0 + Ccur)
    mu_c = class_means[cs]
    mean_diff = mu_c - pop_mean
    mean_mixture = (1 - w) * residual_mean[cs] + w * class_r_mean[cs]
    rhs = ((1 - w) * pop_xtr[:, cs].T + w * class_xtr[:, cs].T
           - joint_means[cs] * mean_mixture[:, None] - lam * W_cur[:, cs].T)
    G = grams
    G /= torch.clamp_min(counts[cs], 1.0)[:, None, None]
    G.baddbmm_(mu_c[:, :, None], mu_c[:, None, :], beta=w, alpha=-w)
    G.baddbmm_(mean_diff[:, :, None], mean_diff[:, None, :], alpha=w * (1 - w))
    G += (1 - w) * pop_cov
    with phase("wls.lu") as out:
        delta = _batched_solve(G, rhs, lam)
        out.append(delta)
    return delta


def solve_weighted_streaming(chunk_scan, Y: torch.Tensor, *, block_size: int, num_iter: int,
                             lam: float, mixture_weight: float, class_chunk: int = 8,
                             info: Optional[dict] = None,
                             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The class-weighted block solve over a chunk source, out of core.

    ``chunk_scan()`` returns a fresh iterator of (rows, d) feature chunks,
    the same chunks on every scan (the lineage contract of
    ``data/chunked.py``); chunks produced off the labels' device are copied
    there. ``Y`` is the (n, k) ±1 label matrix, resident. The objective and
    the iteration are the block-weighted solver's. Returns (per-block
    weights, intercept).

    Scans: num_iter × nblocks × (1 + ⌈k/C⌉), C from
    :func:`class_chunk_size`. Each block's statistics (population Gram and
    means, class means) come from its first cross scan and are kept, as
    the JAX package keeps them. Every block always solves the dense per-class
    systems, even where the in-memory solver would take its dual path, as
    the JAX package's streaming solve does. ``info``, when given, receives
    the ``scans``, ``class_chunks``, ``block_steps`` and ``paths``. One
    card is one lane: the JAX package's laned body waits for the port of
    ``parallel/``."""
    w = float(mixture_weight)
    Y = Y.float()
    n, k = Y.shape
    dev = Y.device
    y_idx = torch.argmax(Y, dim=1)
    counts = torch.bincount(y_idx, minlength=k).to(torch.float32)
    safe_counts = torch.clamp_min(counts, 1.0)
    joint_label_mean = 2 * w + 2 * (1 - w) * counts / n - 1.0
    R = Y - joint_label_mean

    starts, sizes = _block_layout(chunk_scan, block_size)
    d = starts[-1] + sizes[-1]
    Ws = [torch.zeros((bs, k), dtype=torch.float32, device=dev) for bs in sizes]
    stats: List[Optional[tuple]] = [None] * len(starts)
    layout = _ChunkLayout(y_idx, k)
    delta_prev: Optional[torch.Tensor] = None
    jprev, prev_bs = 0, sizes[0]
    info = info if info is not None else {}
    info.update(scans=0, class_chunks=0, block_steps=0, paths=[])

    def scan(label: str):
        row0 = 0
        for i, chunk in enumerate(scan_pipeline(chunk_scan(), label="wls.stream", device=dev)):
            chunk = chunk.float()
            rows = int(chunk.shape[0])
            if int(chunk.shape[1]) != d:
                raise ValueError(f"{label}: the chunks are {chunk.shape[1]} columns wide, the "
                                 f"first was {d}")
            if row0 + rows > n:
                raise ValueError(f"the chunk source produced more than the labels' {n} rows")
            layout.see(i, row0, rows)
            yield i, row0, chunk
            row0 += rows
        if row0 != n:
            raise ValueError(f"chunk source produced {row0} rows, labels {n}")
        info["scans"] += 1

    for _ in range(num_iter):
        for bidx, (j0, bs) in enumerate(zip(starts, sizes)):
            do_stats = stats[bidx] is None
            z = dict(dtype=torch.float32, device=dev)
            xtR, xtRc = torch.zeros((bs, k), **z), torch.zeros((bs, k), **z)
            cr_sum = torch.zeros((k,), **z)
            G = torch.zeros((bs, bs), **z) if do_stats else None
            class_sums = torch.zeros((k, bs), **z) if do_stats else None
            pop_sum = torch.zeros((bs,), **z) if do_stats else None
            with phase("wls.stream_cross") as out:
                for _, row0, chunk in scan("wls.stream_cross"):
                    _wls_stream_scan1(chunk, R, delta_prev, y_idx, xtR, xtRc, cr_sum, G,
                                      class_sums, pop_sum, row0, jprev, j0, bs, prev_bs, k,
                                      do_stats)
                    del chunk
                out.append(xtR)
            if do_stats:
                pop_mean = pop_sum / n
                class_means = class_sums / safe_counts[:, None]
                joint_means = w * class_means + (1 - w) * pop_mean
                pop_cov = torch.addr(G / n, pop_mean, pop_mean, alpha=-1.0)
                stats[bidx] = (pop_cov, pop_mean, joint_means, class_means)
                info["paths"].append("dense")
                del G, class_sums, pop_sum
            pop_cov, pop_mean, joint_means, class_means = stats[bidx]
            pop_xtr = xtR / n
            class_xtr = xtRc / safe_counts[None, :]
            residual_mean = R.mean(dim=0)
            class_r_mean = cr_sum / safe_counts
            C = class_chunk_size(k, bs, class_chunk)
            delta = torch.empty((k, bs), **z)
            for c0 in range(0, k, C):
                Ccur = min(C, k - c0)
                grams = torch.zeros((Ccur, bs, bs), **z)
                with phase("wls.stream_grams") as out:
                    for i, _, chunk in scan("wls.stream_grams"):
                        layout.rows[i].grams(chunk[:, j0:j0 + bs], c0, c0 + Ccur, out=grams)
                        del chunk
                    out.append(grams)
                delta[c0:c0 + Ccur] = _wls_class_delta(
                    grams, counts, class_means, pop_mean, joint_means, pop_xtr, class_xtr,
                    residual_mean, class_r_mean, pop_cov, Ws[bidx], w, lam, c0, Ccur)
                del grams
                info["class_chunks"] += 1
            Ws[bidx] += delta.T
            delta_prev, jprev, prev_bs = delta.T, j0, bs
            info["block_steps"] += 1

    b = joint_label_mean - sum(torch.einsum("cd,dc->c", stats[j][2], Ws[j])
                               for j in range(len(starts)))
    return Ws, b


# -- the snapshot-able per-class state (incremental refit) --------------------


def _weighted_chunk_stats(Xs: torch.Tensor, Y: torch.Tensor):
    """One chunk's per-class raw statistics, its shift already subtracted:
    the Gram, the class Grams (from each class's own rows), the label cross
    terms, the class cross terms, the column and class sums, the label sums
    and the counts; float32 on the chunk's device."""
    k = Y.shape[1]
    y_idx = torch.argmax(Y, dim=1)
    oh = F.one_hot(y_idx, k).to(Xs.dtype)
    ohy = oh * Y
    return (Xs.T @ Xs, ClassRows(y_idx, k).grams(Xs, 0, k), Xs.T @ Y, ohy.T @ Xs,
            Xs.sum(dim=0), oh.T @ Xs, Y.sum(dim=0), ohy.sum(dim=0), oh.sum(dim=0))


@dataclass
class WeightedSolverState:
    """Per-class sufficient statistics of the exact class-weighted mixture
    ridge: the weighted family's snapshot-able accumulator.

    For every class c the per-class solve is
    ``(Σᵢ bᵢ(xᵢ−μ_c)(xᵢ−μ_c)ᵀ + λI) W_c = Σᵢ bᵢ(xᵢ−μ_c)(y_ic − m_c)`` with
    sample weights ``bᵢ = (1−w)/n + w·1[i∈c]/n_c``, joint mean ``μ_c`` and
    joint label mean ``m_c``. Every term is a linear or bilinear function
    of the rows, so the solve follows from raw per-class sums, associative
    over row blocks: the population Gram, one (k, d, d) stack of class
    Grams, the label cross terms and the per-class counts and sums.
    Appended chunks fold in at their own cost; the k solves are O(k·d³)
    with no data pass. The iterated block families have no such statistic
    and raise :class:`~.accumulators.NotAbsorbable`.

    As :class:`~.accumulators.GramSolverState`: host float64 totals,
    float32 products per chunk on its device against a provisional shift
    (the first chunk's column means). The state is O(k·d²) on the host."""

    #: the mixture and ridge the owning model was solved with, at which
    #: ``FittedPipeline.absorb`` solves again
    lam: float = 0.0
    mixture_weight: float = 0.5
    #: the block split of the rebuilt ``BlockLinearMapper`` (0: one block)
    block_size: int = 0
    n: int = 0
    counts: Optional[np.ndarray] = None          # (k,)
    shift: Optional[np.ndarray] = None           # (d,) float32, provisional
    sum_dx: Optional[np.ndarray] = None          # (d,)   Σ (x−s)
    class_sum_dx: Optional[np.ndarray] = None    # (k, d) Σ_{i∈c} (x−s)
    sum_y: Optional[np.ndarray] = None           # (k,)   Σ y
    class_sum_y: Optional[np.ndarray] = None     # (k,)   Σ_{i∈c} y_ic
    gram_s: Optional[np.ndarray] = None          # (d, d)
    class_gram_s: Optional[np.ndarray] = None    # (k, d, d)
    cross_s: Optional[np.ndarray] = None         # (d, k) Σ (x−s) yᵀ
    class_cross_s: Optional[np.ndarray] = None   # (k, d) Σ_{i∈c} (x−s) y_ic
    #: rows folded since construction or the last ``snapshot()``
    rows_folded: int = field(default=0, compare=False)

    @property
    def d(self) -> int:
        return 0 if self.gram_s is None else int(self.gram_s.shape[0])

    @property
    def k(self) -> int:
        return 0 if self.cross_s is None else int(self.cross_s.shape[1])

    def update(self, A_chunk, y_chunk) -> "WeightedSolverState":
        """Fold one (rows, d) feature chunk and its (rows, k) class
        indicators (a row's class is its argmax, as in the whole family)."""
        A = as_chunk(A_chunk)
        Y = as_chunk(y_chunk, A.device)
        if A.dim() != 2 or Y.dim() != 2:
            raise ValueError(f"chunks must be 2-D (A: {tuple(A.shape)}, y: {tuple(Y.shape)})")
        if A.shape[0] != Y.shape[0]:
            raise ValueError(f"feature chunk has {A.shape[0]} rows, labels {Y.shape[0]}")
        rows, d, k = int(A.shape[0]), int(A.shape[1]), int(Y.shape[1])
        if self.gram_s is None:
            self.counts = np.zeros((k,), np.float64)
            self.sum_dx = np.zeros((d,), np.float64)
            self.class_sum_dx = np.zeros((k, d), np.float64)
            self.sum_y = np.zeros((k,), np.float64)
            self.class_sum_y = np.zeros((k,), np.float64)
            self.gram_s = np.zeros((d, d), np.float64)
            self.class_gram_s = np.zeros((k, d, d), np.float64)
            self.cross_s = np.zeros((d, k), np.float64)
            self.class_cross_s = np.zeros((k, d), np.float64)
            self.shift = A.mean(dim=0).cpu().numpy()
        elif d != self.d or k != self.k:
            raise ValueError(f"chunk shape ({d}, {k}) does not match accumulated "
                             f"({self.d}, {self.k})")
        parts = _weighted_chunk_stats(A - torch.from_numpy(self.shift).to(A.device), Y)
        totals = (self.gram_s, self.class_gram_s, self.cross_s, self.class_cross_s,
                  self.sum_dx, self.class_sum_dx, self.sum_y, self.class_sum_y, self.counts)
        for total, part in zip(totals, parts):
            total += part.cpu().numpy()
        self.n += rows
        self.rows_folded += rows
        return self

    def solve(self, lam: Optional[float] = None, device=None):
        """``(W (d, k), b (k,))`` of the exact per-class mixture ridge from
        the state as it stands: O(k·d³), no data pass, in float64 on the
        host, returned as float32 on ``device`` (the CPU when None). With
        δ_c = μ_c − s, ``G_c = (1−w)/n·Σ(x−s)(x−s)ᵀ + w/n_c·Σ_{i∈c}(x−s)(x−s)ᵀ
        − δ_cδ_cᵀ`` and ``rhs_c = (1−w)/n·Σ(x−s)y_c + w/n_c·Σ_{i∈c}(x−s)y_ic
        − m_c·δ_c`` (from Σᵢbᵢ = 1 and Σᵢbᵢ(x−s) = δ_c)."""
        if self.gram_s is None or self.n == 0:
            raise ValueError("solve of an empty WeightedSolverState")
        lam = self.lam if lam is None else float(lam)
        w, n = float(self.mixture_weight), float(self.n)
        s = self.shift.astype(np.float64)
        safe = np.maximum(self.counts, 1.0)
        pop_mean = s + self.sum_dx / n
        class_means = s[None, :] + self.class_sum_dx / safe[:, None]
        joint_means = w * class_means + (1 - w) * pop_mean[None, :]
        jlm = (1 - w) * self.sum_y / n + w * self.class_sum_y / safe
        eye = np.eye(self.d)
        cols = []
        for c in range(self.k):
            delta = joint_means[c] - s
            G = ((1 - w) / n * self.gram_s + w / safe[c] * self.class_gram_s[c]
                 - np.outer(delta, delta))
            rhs = ((1 - w) / n * self.cross_s[:, c] + w / safe[c] * self.class_cross_s[c]
                   - jlm[c] * delta)
            cols.append(np.linalg.solve(G + lam * eye, rhs))
        W = np.stack(cols, axis=1)
        b = jlm - np.einsum("cd,dc->c", joint_means, W)

        def f32(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

        return f32(W), f32(b)

    def rebuild_mapper(self, mapper):
        """Solve again and rebuild the fitted ``BlockLinearMapper`` at the
        recorded block split, on the mapper's device: the absorb hook."""
        W, b = self.solve(device=mapper._W.device)
        d = int(W.shape[0])
        bs = self.block_size or d
        return type(mapper)([W[i:min(i + bs, d)] for i in range(0, d, bs)], bs, b=b,
                            solver_state=self.snapshot())

    def moments(self) -> MomentsState:
        """The column moments of every row folded so far (as
        ``GramSolverState.moments``)."""
        if self.gram_s is None or self.n == 0:
            raise ValueError("moments of an empty WeightedSolverState")
        dmu = self.sum_dx / float(self.n)
        mu = self.shift.astype(np.float64) + dmu
        m2 = np.maximum(np.diag(self.gram_s) - self.n * dmu * dmu, 0.0)
        return MomentsState(n=self.n, mean=mu, m2=m2)

    def snapshot(self) -> "WeightedSolverState":
        """An independent copy with ``rows_folded`` zeroed."""

        def cp(a):
            return None if a is None else a.copy()

        return WeightedSolverState(
            lam=self.lam, mixture_weight=self.mixture_weight, block_size=self.block_size,
            n=self.n, counts=cp(self.counts), shift=cp(self.shift), sum_dx=cp(self.sum_dx),
            class_sum_dx=cp(self.class_sum_dx), sum_y=cp(self.sum_y),
            class_sum_y=cp(self.class_sum_y), gram_s=cp(self.gram_s),
            class_gram_s=cp(self.class_gram_s), cross_s=cp(self.cross_s),
            class_cross_s=cp(self.class_cross_s), rows_folded=0)
