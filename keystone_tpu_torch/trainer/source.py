"""The trainer's append-only chunk source (port of
``keystone_tpu/trainer/source.py``).

A :class:`ChunkLog` is the minimal durable-feed stand-in the daemon tails:
producers ``append`` (data, labels) chunks from any thread, the daemon
reads strictly forward with :meth:`~ChunkLog.tail`, and a contiguous index
range becomes a :class:`~keystone_tpu_torch.data.chunked.ChunkedDataset`
for the absorb pass through :meth:`~ChunkLog.as_chunked`. That dataset is
indexable (``from_chunk_fn``), so a checkpointed absorb that resumes
mid-batch skips the folded prefix without producing it, and every
production is counted (:attr:`~ChunkLog.production_counts`: a chunk whose
batch resolved is never produced again).

The log keeps its chunks in host memory as numpy arrays, as the JAX
package's does: it models the interface of an append-only feed, not its
storage. A chunk reaches the card only through the scan that produces it
(or the daemon's monitor, which copies it there once). Shape and dtype
are checked at append against the first chunk, so a malformed producer
fails at the door, not mid-absorb.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _host(a: Any) -> np.ndarray:
    """``a`` as a host numpy array (a tensor is copied off its device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass(frozen=True)
class AppendedChunk:
    """One appended (data, labels) pair; ``labels`` may be None: an
    unlabeled append still feeds the moment drift monitor, but gives no
    residual evidence and cannot be absorbed."""

    index: int
    data: Any
    labels: Optional[Any]

    @property
    def rows(self) -> int:
        return int(self.data.shape[0])


class ChunkLog:
    """Thread-safe append-only log of training chunks."""

    def __init__(self, label: str = "append-log"):
        self._lock = threading.Lock()
        self._chunks: List[AppendedChunk] = []
        self._label = label
        self._item_shape: Optional[tuple] = None
        self._dtype = None
        #: times each chunk index has been produced through
        #: :meth:`as_chunked`: the absorb's work evidence
        self.production_counts: dict = {}

    def append(self, data: Any, labels: Optional[Any] = None) -> int:
        """Append one chunk and return its log index. Raises ``ValueError``
        on a shape or dtype that differs from the first appended chunk's."""
        data = _host(data)
        if data.ndim < 2:
            raise ValueError(f"appended chunks must be batched (2-D+), got {data.shape}")
        if labels is not None:
            labels = _host(labels)
            if int(labels.shape[0]) != int(data.shape[0]):
                raise ValueError(f"chunk has {data.shape[0]} rows, labels {labels.shape[0]}")
        with self._lock:
            if self._item_shape is None:
                self._item_shape = tuple(int(d) for d in data.shape[1:])
                self._dtype = data.dtype
            else:
                if tuple(int(d) for d in data.shape[1:]) != self._item_shape:
                    raise ValueError(f"appended chunk item shape {data.shape[1:]} does not "
                                     f"match the log's {self._item_shape}")
                if data.dtype != self._dtype:
                    raise ValueError(f"appended chunk dtype {data.dtype} does not match the "
                                     f"log's {self._dtype}")
            index = len(self._chunks)
            self._chunks.append(AppendedChunk(index, data, labels))
            return index

    def __len__(self) -> int:
        with self._lock:
            return len(self._chunks)

    @property
    def total_rows(self) -> int:
        with self._lock:
            return sum(c.rows for c in self._chunks)

    def tail(self, cursor: int) -> List[AppendedChunk]:
        """Every chunk appended at or after ``cursor``, in order: the
        daemon's strictly-forward read. Never blocks."""
        with self._lock:
            return list(self._chunks[cursor:])

    def get(self, index: int) -> AppendedChunk:
        with self._lock:
            return self._chunks[index]

    def as_chunked(self, start: int, stop: int) -> Tuple[Any, np.ndarray]:
        """``(ChunkedDataset, stacked labels)`` over log indices ``[start,
        stop)``: the absorb batch. Index-addressable, so a checkpoint resume
        skips folded chunks without producing them; each production bumps
        :attr:`production_counts`. Raises ``ValueError`` when a chunk of the
        range is unlabeled (absorb needs labels)."""
        from ..data.chunked import ChunkedDataset

        with self._lock:
            if not (0 <= start < stop <= len(self._chunks)):
                raise ValueError(f"as_chunked range [{start}, {stop}) outside the log's "
                                 f"{len(self._chunks)} chunk(s)")
            batch = list(self._chunks[start:stop])
        unlabeled = [c.index for c in batch if c.labels is None]
        if unlabeled:
            raise ValueError(f"absorb batch contains unlabeled chunk(s) {unlabeled}")
        rows = sum(c.rows for c in batch)
        counts = self.production_counts

        def chunk_fn(i: int):
            c = batch[i]
            with self._lock:
                counts[c.index] = counts.get(c.index, 0) + 1
            return c.data

        ds = ChunkedDataset.from_chunk_fn(chunk_fn, len(batch), rows,
                                          label=f"{self._label}[{start}:{stop}]")
        labels = np.concatenate([np.asarray(c.labels) for c in batch])
        return ds, labels
