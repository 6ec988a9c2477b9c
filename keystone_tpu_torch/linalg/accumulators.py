"""Snapshot-able streaming accumulators, the state behind incremental refit
(port of ``keystone_tpu/linalg/accumulators.py``).

The streaming solvers fold row chunks into small sufficient statistics (a
Gram matrix, a TSQR R factor, Chan/Welford moment triples) and solve once.
The statistics are associative over row blocks, so a saved state folds
appended chunks (``update``) and solves again (``solve``) at the cost of
the new chunks only: ``FittedPipeline.absorb``.

Centering is algebraic: the Gram state keeps raw sums against a shift and
derives the centered Gram and cross products at solve time
(Σ(a−μ)(a−μ)ᵀ = Σ(a−s)(a−s)ᵀ − n(μ−s)(μ−s)ᵀ for any s), so the column
means may move as chunks arrive. The totals are float64 numpy on the host:
the raw sums grow with n·μ² while the centered Gram is n·σ², and the
subtraction at solve time would cancel in float32 for large-n data with an
offset mean. The per-chunk products run on the chunk's device in float32
(TF32 off, as the package sets it) against a provisional shift, the first
chunk's column means, which takes the μ² mass out of the products before
they round; only each chunk's own result is copied to the host. The Gram
state times its two halves as ``utils.timing`` phases:
``gram_state.products`` (the chunk's products on its device) and
``gram_state.fold`` (the copy to the host and the float64 adds).
"""

from __future__ import annotations

import contextlib
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..utils.timing import phase

logger = logging.getLogger(__name__)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor, in its own dtype: a float32 product crosses
    to the host as float32 and is widened as numpy adds it into a float64
    total, so no float64 copy of it is made on the device."""
    return t.detach().cpu().numpy()


def as_chunk(x, device=None) -> torch.Tensor:
    """A float32 tensor of a chunk (numpy arrays and tensors alike), on
    ``device`` when one is given."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    return t.to(device=device, dtype=torch.float32)


def fold_into(state, data, y: torch.Tensor, *, label: str, on_chunk=None, checkpoint=None,
              checkpoint_every: int = 1):
    """Fold ``data`` and its labels ``y`` into ``state`` (any state with an
    ``update(A, y)``, or a function of no arguments that makes one): a
    ``ChunkedDataset`` in one scan, its chunks copied to the labels' device,
    each with its slice of ``y``; anything else in one update.
    ``on_chunk(index, chunk)`` runs before each chunk is folded. Raises when
    the rows and the labels disagree. Returns the folded state.

    With ``checkpoint`` (a ``faults.FitCheckpoint``) a chunked fold is
    resumable: the checkpoint is read once, and a saved ``(state, chunk,
    row)`` takes the place of ``state`` (a function is then not called) and
    the scan starts at that chunk without producing the ones before it; the
    state is saved every ``checkpoint_every`` chunks, except after the
    labels' last row, and the checkpoint removed when the fold completes.
    The resumed fold keeps the saved state's shift, so it equals an
    uninterrupted one bit for bit."""
    from ..data.dataset import Dataset
    from ..data.pipeline_scan import scan_pipeline

    chunked = getattr(data, "is_chunked", False)
    loaded = checkpoint.load() if checkpoint is not None and chunked else None
    if loaded is not None:
        state, start, offset = loaded
        logger.info("fit checkpoint: resuming %s at chunk %d (row %d) from %s", label,
                    start, offset, checkpoint.path)
    else:
        start = offset = 0
        if not hasattr(state, "update"):
            state = state()
    if not chunked:
        if on_chunk is not None:
            on_chunk(0, data)
        return state.update(Dataset.of(data).to_array(), y)
    every = max(1, int(checkpoint_every))
    i = start
    with contextlib.closing(scan_pipeline(data.raw_chunks(skip=start), label=label,
                                          device=y.device)) as chunks:
        for chunk in chunks:
            if on_chunk is not None:
                on_chunk(i, chunk)
            rows = int(chunk.shape[0])
            if offset + rows > y.shape[0]:
                raise ValueError(f"the chunks hold more than the labels' {y.shape[0]} rows")
            state.update(chunk, y[offset:offset + rows])
            offset += rows
            i += 1
            # a save after the last row would be removed unread
            if checkpoint is not None and i % every == 0 and offset < y.shape[0]:
                checkpoint.save(state, i, offset)
    if offset != y.shape[0]:
        raise ValueError(f"chunked features have {offset} rows, labels {y.shape[0]}")
    if checkpoint is not None:
        checkpoint.complete()
    return state


class NotAbsorbable(ValueError):
    """This model family has no associative sufficient statistic, so
    appended chunks cannot be folded into the fitted state: a typed refusal
    where an incremental answer would be wrong. Raised by the iterated
    block families (their iterates depend on the order they visit the
    blocks in) and by ``FittedPipeline.absorb`` on a model fitted without a
    snapshot-able solver state."""


@dataclass
class GramSolverState:
    """Raw normal-equations statistics, restartable: the exact solve's
    accumulator. Every array is host float64 (see the module docstring)."""

    n: int = 0
    sum_x: Optional[np.ndarray] = None  # (d,)   Σ a
    sum_y: Optional[np.ndarray] = None  # (k,)   Σ y
    gram: Optional[np.ndarray] = None   # (d, d) Σ (a−s)ᵀ(a−s)
    cross: Optional[np.ndarray] = None  # (d, k) Σ (a−s)ᵀ(y−s_y)
    #: the provisional shifts (the first chunk's float32 column means) the
    #: products are taken against; the exact means enter at solve time
    shift: Optional[np.ndarray] = None    # (d,)
    shift_y: Optional[np.ndarray] = None  # (k,)
    #: the ridge parameter the owning model was solved with, at which
    #: ``FittedPipeline.absorb`` solves again
    lam: float = 0.0
    #: rows folded since construction or the last ``snapshot()``
    rows_folded: int = field(default=0, compare=False)

    @property
    def d(self) -> int:
        return 0 if self.gram is None else int(self.gram.shape[0])

    @property
    def k(self) -> int:
        return 0 if self.cross is None else int(self.cross.shape[1])

    def update(self, A_chunk, y_chunk) -> "GramSolverState":
        """Fold one (rows, d) feature chunk and its (rows, k) labels: the
        chunk's shifted Gram and cross products in float32 on its device,
        added into the host float64 totals."""
        A = as_chunk(A_chunk)
        y = as_chunk(y_chunk, A.device)
        if A.dim() != 2 or y.dim() != 2:
            raise ValueError(f"chunks must be 2-D (A: {tuple(A.shape)}, y: {tuple(y.shape)})")
        if A.shape[0] != y.shape[0]:
            raise ValueError(f"feature chunk has {A.shape[0]} rows, labels {y.shape[0]}")
        rows, d, k = int(A.shape[0]), int(A.shape[1]), int(y.shape[1])
        if self.gram is None:
            self.sum_x = np.zeros((d,), np.float64)
            self.sum_y = np.zeros((k,), np.float64)
            self.gram = np.zeros((d, d), np.float64)
            self.cross = np.zeros((d, k), np.float64)
            self.shift = A.mean(dim=0).cpu().numpy()
            self.shift_y = y.mean(dim=0).cpu().numpy()
        elif d != self.d or k != self.k:
            raise ValueError(f"chunk shape ({d}, {k}) does not match accumulated "
                             f"({self.d}, {self.k})")
        with phase("gram_state.products") as out:
            As = A - torch.from_numpy(self.shift).to(A.device)
            ys = y - torch.from_numpy(self.shift_y).to(A.device)
            parts = (As.T @ As, As.T @ ys, A.sum(dim=0), y.sum(dim=0))
            del As, ys
            out.append(parts[0])
        with phase("gram_state.fold"):
            for total, part in zip((self.gram, self.cross, self.sum_x, self.sum_y), parts):
                total += _host(part)
        self.n += rows
        self.rows_folded += rows
        return self

    def update_chunks(self, pairs: Iterable[Tuple]) -> "GramSolverState":
        for A_chunk, y_chunk in pairs:
            self.update(A_chunk, y_chunk)
        return self

    def solve(self, lam: float = 0.0, device=None):
        """(W, intercept, feature means) at ridge parameter ``lam`` from the
        state as it stands, with no data pass: centered in float64 (Gc =
        Σ(a−s)(a−s)ᵀ − n(μ−s)(μ−s)ᵀ, likewise the cross products), then
        solved in float32 on ``device`` (the CPU when None)."""
        return self.solve_lambdas([lam], device)[0]

    def solve_lambdas(self, lams: Iterable[float], device=None) -> list:
        """:meth:`solve` at each λ of ``lams``, the state centered and
        copied to ``device`` once: a λ grid's solves."""
        from .row_matrix import solve_spd

        if self.gram is None or self.n == 0:
            raise ValueError("solve of an empty GramSolverState")
        n = float(self.n)
        mu, nu = self.sum_x / n, self.sum_y / n
        dmu = mu - self.shift.astype(np.float64)
        dnu = nu - self.shift_y.astype(np.float64)
        Gc = self.gram - n * np.outer(dmu, dmu)
        Cc = self.cross - n * np.outer(dmu, dnu)

        def f32(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

        G, C, b, mean = f32(Gc), f32(Cc), f32(nu), f32(mu)
        del Gc, Cc
        return [(solve_spd(G, C, float(lam)), b, mean) for lam in lams]

    def rebuild_mapper(self, mapper):
        """Solve at the recorded λ and rebuild ``mapper``'s class with the
        new parameters on its device: the state's hook that
        ``FittedPipeline.absorb`` calls after folding appended chunks."""
        W, b, mean = self.solve(self.lam, device=mapper.W.device)
        return type(mapper)(W, b=b, feature_mean=mean, solver_state=self.snapshot())

    def moments(self) -> "MomentsState":
        """The column moments of every row folded so far, from the raw sums
        (mean Σa/n; M2 = diag(Σ(a−s)(a−s)ᵀ) − n(μ−s)²), with no second
        statistics pass."""
        if self.gram is None or self.n == 0:
            raise ValueError("moments of an empty GramSolverState")
        mu = self.sum_x / float(self.n)
        dmu = mu - self.shift.astype(np.float64)
        m2 = np.maximum(np.diag(self.gram) - self.n * dmu * dmu, 0.0)
        return MomentsState(n=self.n, mean=mu, m2=m2)

    def snapshot(self) -> "GramSolverState":
        """An independent copy with ``rows_folded`` zeroed: what a fitted
        model carries, so that a later ``absorb`` leaves the original be."""

        def cp(a):
            return None if a is None else a.copy()

        return GramSolverState(n=self.n, sum_x=cp(self.sum_x), sum_y=cp(self.sum_y),
                               gram=cp(self.gram), cross=cp(self.cross), shift=cp(self.shift),
                               shift_y=cp(self.shift_y), lam=self.lam, rows_folded=0)

    def merge(self, other: "GramSolverState") -> "GramSolverState":
        """Associative combine, in place. The two states' products may be
        against different shifts; ``other``'s are translated to this one's
        exactly in float64: with δ = s₁ − s₂ (other's shift minus this
        one's), Σ(a−s₂)(a−s₂)ᵀ = Σ(a−s₁)(a−s₁)ᵀ + Σ(a−s₁)δᵀ + δΣ(a−s₁)ᵀ
        + nδδᵀ, and Σ(a−s₁) = Σa − n·s₁."""
        if other.gram is None:
            return self
        if self.gram is None:
            # adopt other's sums and shift, and count its rows as folded here
            self.n = other.n
            self.rows_folded += other.n
            self.sum_x, self.sum_y = other.sum_x.copy(), other.sum_y.copy()
            self.gram, self.cross = other.gram.copy(), other.cross.copy()
            self.shift, self.shift_y = other.shift.copy(), other.shift_y.copy()
            return self
        if (self.d, self.k) != (other.d, other.k):
            raise ValueError("merging mismatched GramSolverStates")
        on = float(other.n)
        s1 = other.shift.astype(np.float64)
        sy1 = other.shift_y.astype(np.float64)
        delta = s1 - self.shift.astype(np.float64)
        delta_y = sy1 - self.shift_y.astype(np.float64)
        cx = other.sum_x - on * s1
        cy = other.sum_y - on * sy1
        gram2 = other.gram + np.outer(cx, delta) + np.outer(delta, cx) + on * np.outer(delta,
                                                                                       delta)
        cross2 = (other.cross + np.outer(cx, delta_y) + np.outer(delta, cy)
                  + on * np.outer(delta, delta_y))
        self.n += other.n
        self.rows_folded += other.n
        self.sum_x = self.sum_x + other.sum_x
        self.sum_y = self.sum_y + other.sum_y
        self.gram = self.gram + gram2
        self.cross = self.cross + cross2
        return self


@dataclass
class TsqrRState:
    """The streaming TSQR fold (R of qr([R; chunk])) as a snapshot:
    resuming from a saved R is the sequential recurrence resumed, so an
    appended chunk costs one small QR. R is kept on the host."""

    r: Optional[np.ndarray] = None  # (w, w) upper triangular
    n: int = 0

    def update(self, chunk) -> "TsqrRState":
        from .tsqr import _qr_fold, _qr_r

        chunk = as_chunk(chunk)
        if chunk.dim() != 2:
            raise ValueError(f"chunks must be 2-D, got {tuple(chunk.shape)}")
        if self.r is None:
            self.r = _qr_r(chunk).cpu().numpy()
        else:
            if int(chunk.shape[1]) != int(self.r.shape[1]):
                raise ValueError(f"chunk width {chunk.shape[1]} does not match accumulated "
                                 f"width {self.r.shape[1]}")
            self.r = _qr_fold(torch.from_numpy(self.r).to(chunk.device), chunk).cpu().numpy()
        self.n += int(chunk.shape[0])
        return self

    def finalize(self) -> torch.Tensor:
        """The sign-fixed R factor of everything folded so far."""
        from .tsqr import _fix_sign

        if self.r is None:
            raise ValueError("finalize of an empty TsqrRState")
        return _fix_sign(torch.from_numpy(self.r))

    def snapshot(self) -> "TsqrRState":
        return TsqrRState(r=None if self.r is None else self.r.copy(), n=self.n)


#: rows of a chunk taken to float64 at a time by ``MomentsState.update``
_MOMENT_ROWS = 64
#: threads that each take a contiguous range of a chunk's rows
_MOMENT_THREADS = min(4, os.cpu_count() or 1)


def _block_moments(x, start: int, stop: int) -> "MomentsState":
    """The moments of rows ``[start, stop)`` of ``x`` (a host array or a
    tensor on any device): :data:`_MOMENT_ROWS` rows at a time are copied
    into one float64 buffer (a card tensor's through one pinned buffer),
    their two passes run there, and the blocks merge in order."""
    state = MomentsState()
    width = int(x.shape[1])
    buf = np.empty((min(_MOMENT_ROWS, stop - start), width), np.float64)
    staging = None
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        staging = torch.empty((buf.shape[0], width), dtype=x.dtype, pin_memory=True)
    for i in range(start, stop, _MOMENT_ROWS):
        part = x[i:min(i + _MOMENT_ROWS, stop)]
        rows = int(part.shape[0])
        if staging is not None:
            staging[:rows].copy_(part)
            part = staging[:rows]
        if isinstance(part, torch.Tensor):
            part = part.numpy()
        b = buf[:rows]
        np.copyto(b, part)
        mean = b.mean(axis=0)
        np.subtract(b, mean, out=b)
        np.square(b, out=b)
        state.merge(MomentsState(n=rows, mean=mean, m2=b.sum(axis=0)))
    return state


@dataclass
class MomentsState:
    """Chan/Welford column moments (count, mean, M2) in host float64: the
    StandardScaler's streaming statistic, snapshot-able, with the pairwise
    merge.

    A chunk's moments are the JAX package's two host float64 passes (the
    mean, then Σ (a − mean)²), taken over blocks of :data:`_MOMENT_ROWS`
    rows held in one float64 buffer and merged in order, on up to
    :data:`_MOMENT_THREADS` threads of contiguous row ranges. A wide chunk
    (65,536 × 16,384 features is 4.3 GB in float32) is never copied whole,
    the passes stay in cache, and numpy's single-threaded kernels do not
    contend with other threads for cores. A chunk of at most
    :data:`_MOMENT_ROWS` rows gives the JAX package's bits; a longer one
    agrees to rounding (1e-14 relative)."""

    n: int = 0
    mean: Optional[np.ndarray] = None  # (d,)
    m2: Optional[np.ndarray] = None    # (d,) Σ (a − mean)²

    def update(self, chunk) -> "MomentsState":
        x = chunk.detach() if isinstance(chunk, torch.Tensor) else np.asarray(chunk)
        if x.ndim != 2:
            raise ValueError(f"chunks must be 2-D, got {tuple(x.shape)}")
        rows = int(x.shape[0])
        if rows == 0:
            return self
        if isinstance(x, torch.Tensor) and x.is_cuda:
            # the threads copy on their own streams: the chunk must be written
            torch.cuda.current_stream(x.device).synchronize()
        per = -(-rows // (_MOMENT_ROWS * _MOMENT_THREADS)) * _MOMENT_ROWS
        bounds = [(s, min(s + per, rows)) for s in range(0, rows, per)]
        if len(bounds) == 1:
            parts = [_block_moments(x, *bounds[0])]
        else:
            with ThreadPoolExecutor(len(bounds)) as pool:
                parts = list(pool.map(lambda b: _block_moments(x, *b), bounds))
        for part in parts:
            self.merge(part)
        return self

    def merge(self, other: "MomentsState") -> "MomentsState":
        if other.mean is None:
            return self
        if self.mean is None:
            self.n, self.mean, self.m2 = other.n, other.mean.copy(), other.m2.copy()
            return self
        delta = other.mean - self.mean
        total = self.n + other.n
        self.mean = self.mean + delta * (other.n / total)
        self.m2 = self.m2 + other.m2 + delta * delta * (self.n * other.n / total)
        self.n = total
        return self

    def std(self, ddof: int = 0) -> np.ndarray:
        if self.mean is None:
            raise ValueError("std of an empty MomentsState")
        return np.sqrt(self.m2 / max(self.n - ddof, 1))

    def snapshot(self) -> "MomentsState":
        return MomentsState(n=self.n, mean=None if self.mean is None else self.mean.copy(),
                            m2=None if self.m2 is None else self.m2.copy())
