"""Padded sparse-row batches on torch tensors (port of
``keystone_tpu/data/sparse.py``): the reference's ``SparseVector`` rows.

A batch of n rows over d features is stored as a padded COO pair,
``indices (n, m) int64`` and ``values (n, m) float32``, with a row
capacity m (the most entries of a row, rounded up to a multiple of 8).
Padding slots carry value 0 at index 0, which no consumer can tell from
nothing:

* :meth:`SparseRows.matmul` — X·W as a gather of W's rows by index,
  weighted by the values;
* :meth:`SparseRows.rmatmul`, :meth:`class_sums`, :meth:`label_sums` —
  Xᵀ·R and the per-class feature sums as one ``index_add_`` each into a
  flat accumulator (the JAX package scatters (n, m, k) contributions; the
  sums are the same in another order);
* :meth:`SparseRows.to_dense` — one ``scatter_add_`` per row.

The JAX package keeps int32 indices. torch's gathers and scatters take
int64 indices, so they are converted once, when the batch is made or
moved, and never per call: 8 bytes a slot, twice the reference's.

On CUDA the scatter-adds are atomic adds, so their float sums change at
rounding from run to run; sums of integers below 2²⁴ (naive Bayes on
term counts) stay exact.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def _round_up(x: int, multiple: int = 8) -> int:
    return max(multiple, ((x + multiple - 1) // multiple) * multiple)


class SparseRows:
    """A batch of n sparse rows over a d-dimensional feature space."""

    def __init__(self, indices, values, num_features: int):
        values = torch.as_tensor(values)
        # int64 once, here, on the values' device: every gather and scatter
        # below takes these indices as they are
        self.indices = torch.as_tensor(indices, device=values.device).long()
        self.values = values
        self.num_features = int(num_features)

    # -- shape and placement ---------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        return (int(self.indices.shape[0]), self.num_features)

    @property
    def row_capacity(self) -> int:
        return int(self.indices.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.values))

    def __len__(self) -> int:
        return int(self.indices.shape[0])

    def to(self, device: Union[str, torch.device, None]) -> "SparseRows":
        """The batch on ``device`` (itself when it is there already)."""
        if device is None or torch.device(device) == self.device:
            return self
        return SparseRows(self.indices.to(device), self.values.to(device), self.num_features)

    # -- constructors ----------------------------------------------------

    @staticmethod
    def from_pairs(rows: Iterable[Sequence[Tuple[int, float]]], num_features: int,
                   row_capacity: Optional[int] = None) -> "SparseRows":
        """From per-row (feature index, value) pair lists, on the CPU. Rows
        longer than the capacity keep their largest-|value| entries."""
        rows = [list(r) for r in rows]
        max_nnz = max((len(r) for r in rows), default=1)
        m = row_capacity or _round_up(max_nnz)
        idx = np.zeros((len(rows), m), dtype=np.int64)
        val = np.zeros((len(rows), m), dtype=np.float32)
        for i, r in enumerate(rows):
            if len(r) > m:
                r = sorted(r, key=lambda p: -abs(p[1]))[:m]
            for j, (f, v) in enumerate(r):
                idx[i, j] = f
                val[i, j] = v
        return SparseRows(torch.from_numpy(idx), torch.from_numpy(val), num_features)

    @staticmethod
    def from_scipy(mat) -> "SparseRows":
        import scipy.sparse as sp

        csr = sp.csr_matrix(mat)
        rows = [
            list(zip(csr.indices[s:e], csr.data[s:e]))
            for s, e in zip(csr.indptr[:-1], csr.indptr[1:])
        ]
        return SparseRows.from_pairs(rows, csr.shape[1])

    # -- consumers -------------------------------------------------------

    def to_dense(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The (n, d) dense rows; ``dtype`` bounds the target's memory."""
        dtype = dtype or self.values.dtype
        out = torch.zeros((len(self), self.num_features), dtype=dtype, device=self.device)
        return out.scatter_add_(1, self.indices, self.values.to(dtype))

    def row_slice(self, start: int, stop: int) -> "SparseRows":
        """Rows ``start:stop``, sharing this batch's storage."""
        return SparseRows(self.indices[start:stop], self.values[start:stop], self.num_features)

    def matmul(self, W: torch.Tensor) -> torch.Tensor:
        """X·W without densifying: W's rows gathered by feature index and
        weighted by the values. W (d, k) → (n, k)."""
        gathered = W[self.indices]  # (n, m, k)
        return torch.bmm(self.values.unsqueeze(1).to(W.dtype), gathered).squeeze(1)

    def rmatmul(self, R: torch.Tensor) -> torch.Tensor:
        """Xᵀ·R without densifying: each row's contributions added into a
        (d, k) accumulator. R (n, k) → (d, k); the gradient side (Aᵀ·r) of
        the sparse solvers."""
        k = R.shape[1]
        contrib = self.values.unsqueeze(2) * R.unsqueeze(1)  # (n, m, k)
        out = torch.zeros((self.num_features, k), dtype=contrib.dtype, device=R.device)
        return out.index_add_(0, self.indices.reshape(-1), contrib.reshape(-1, k))

    def class_sums(self, onehot: torch.Tensor) -> torch.Tensor:
        """onehotᵀ·X without densifying: (n, k) memberships → (k, d) sums.
        For hard integer labels :meth:`label_sums` adds n·m elements where
        this adds n·m·k."""
        return self.rmatmul(onehot).T.contiguous()

    def label_sums(self, y: torch.Tensor, k: int) -> torch.Tensor:
        """Per-class feature sums for integer labels: (k, d) by one
        ``index_add_`` of the n·m values into a flat (k·d) accumulator."""
        d = self.num_features
        flat = (y.to(self.device).long().unsqueeze(1) * d + self.indices).reshape(-1)
        out = torch.zeros(k * d, dtype=self.values.dtype, device=self.device)
        return out.index_add_(0, flat, self.values.reshape(-1)).view(k, d)

    def density(self) -> float:
        n, d = self.shape
        return self.nnz / float(max(n * d, 1))

    @staticmethod
    def datum_from_pairs(x, num_features: int) -> Optional["SparseRows"]:
        """A per-item value as a one-row batch when it is a sparse (index,
        value) pair list, as SparseFeatureVectorizer and HashingTF emit one
        item; None when it is not pair-shaped."""
        if isinstance(x, SparseRows):
            return x
        if isinstance(x, (list, tuple)) and (
            len(x) == 0
            or (
                isinstance(x[0], (tuple, list))
                and len(x[0]) == 2
                and isinstance(x[0][0], (int, np.integer))
            )
        ):
            return SparseRows.from_pairs([x], num_features)
        return None

    def __getitem__(self, i) -> "SparseRows":
        idx, val = self.indices[i], self.values[i]
        if idx.dim() == 1:  # one row: keep the batch form
            idx, val = idx.unsqueeze(0), val.unsqueeze(0)
        return SparseRows(idx, val, self.num_features)
