"""The logical collection type (port of ``keystone_tpu/data/dataset.py``).

A ``Dataset`` holds N items in one of two forms:

* batched: one tensor whose leading dimension is the item index, or a
  tuple of such payloads (nested tuples allowed) that share their number
  of rows (the output of ``Pipeline.gather``: one ``(n, d_i)`` tensor per
  branch, or the column blocks of ``VectorSplitter``). Every numeric node
  works on this form. A :class:`~keystone_tpu_torch.data.sparse.SparseRows`
  batch (text features) is a batched payload too: it indexes, slices and
  iterates by row, and the nodes that take sparse rows read it whole.
* items: a Python list of arbitrary objects (ragged tensors, strings)
  for data with no rectangular layout.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch

from .sparse import SparseRows

Payload = Union[torch.Tensor, SparseRows, Tuple[Any, ...]]


def first_leaf(payload: Payload) -> torch.Tensor:
    """The first tensor of a (possibly nested) tuple payload."""
    while isinstance(payload, tuple):
        payload = payload[0]
    return payload


def map_leaves(fn: Callable[[torch.Tensor], Any], payload: Payload) -> Any:
    """``fn`` applied to every tensor of a payload, keeping its tuples."""
    if isinstance(payload, tuple):
        return tuple(map_leaves(fn, p) for p in payload)
    return fn(payload)


def _leaves(payload: Payload) -> List[torch.Tensor]:
    if isinstance(payload, tuple):
        return [t for p in payload for t in _leaves(p)]
    return [payload]


def _is_batch(data: Any) -> bool:
    if isinstance(data, tuple):
        return bool(data) and all(_is_batch(p) for p in data)
    return isinstance(data, (torch.Tensor, SparseRows))


class Dataset:
    """A logical collection of N items, batched (stacked tensors) or listed."""

    def __init__(self, payload: Any, *, batched: bool = True):
        if batched:
            if isinstance(payload, tuple) and not payload:
                raise ValueError("a tuple payload needs at least one tensor")
            leaves = _leaves(payload)
            n = leaves[0].shape[0]
            if any(t.shape[0] != n for t in leaves):
                raise ValueError("the tensors of a tuple payload differ in rows")
        self._payload = payload
        self._batched = batched

    # ---- constructors ---------------------------------------------------

    @staticmethod
    def of(data: Any) -> "Dataset":
        """Wrap ``data``: a Dataset as is; a tensor, a tuple of tensors, a
        SparseRows batch or a numpy array (as a CPU tensor sharing its
        memory) batched; any other iterable as an item list."""
        if isinstance(data, Dataset):
            return data
        if _is_batch(data):
            return Dataset(data)
        if isinstance(data, np.ndarray):
            return Dataset(torch.from_numpy(data))
        return Dataset(list(data), batched=False)

    @staticmethod
    def from_array(arr: Any) -> "Dataset":
        return Dataset(torch.as_tensor(arr))

    @staticmethod
    def from_items(items: Iterable[Any]) -> "Dataset":
        return Dataset(list(items), batched=False)

    # ---- shape / access -------------------------------------------------

    @property
    def is_batched(self) -> bool:
        return self._batched

    @property
    def is_chunked(self) -> bool:
        """True for an out-of-core :class:`~keystone_tpu_torch.data.chunked.ChunkedDataset`."""
        return False

    @property
    def payload(self) -> Any:
        return self._payload

    def __len__(self) -> int:
        if self._batched:
            return int(first_leaf(self._payload).shape[0])
        return len(self._payload)

    def __iter__(self) -> Iterator[Any]:
        if self._batched:
            for i in range(len(self)):
                yield map_leaves(lambda t, i=i: t[i], self._payload)
        else:
            yield from self._payload

    def first(self) -> Any:
        if self._batched:
            return map_leaves(lambda t: t[0], self._payload)
        return self._payload[0]

    def take(self, n: int) -> "Dataset":
        """The first ``n`` items: views of a batched payload, a slice of a
        list."""
        if n < 0:
            raise ValueError("take of a negative count")
        if self._batched:
            return Dataset(map_leaves(lambda t: t[:n], self._payload))
        return Dataset(self._payload[:n], batched=False)

    def collect(self) -> List[Any]:
        """The items as a list."""
        return list(self)

    def to_array(self) -> Payload:
        """The stacked payload (a tensor, or the tuple of tensors); list
        items are stacked."""
        if self._batched:
            return self._payload
        return torch.stack([torch.as_tensor(x) for x in self._payload])

    # ---- functional ops -------------------------------------------------

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        """Per-item map; the result is batched again when the items are
        tensors of one shape."""
        return _rebatch([fn(x) for x in self])

    def map_batch(self, fn: Callable[[Payload], Payload]) -> "Dataset":
        """Apply ``fn`` to the whole stacked payload at once."""
        return Dataset(fn(self.to_array()))

    def zip(self, *others: "Dataset") -> "Dataset":
        cols = [self, *others]
        n = len(self)
        if any(len(o) != n for o in others):
            raise ValueError("zip of datasets with different lengths")
        return Dataset.from_items(list(zip(*[c.collect() for c in cols])))

    def cache(self) -> "Dataset":
        """A materialized copy of the collection's structure; tensors are
        shared."""
        if self._batched:
            return Dataset(self._payload)
        return Dataset(list(self._payload), batched=False)


def _rebatch(items: Sequence[Any]) -> Dataset:
    """Stack per-item results into a batched dataset when they are tensors
    (or numpy arrays) of one shape; otherwise keep the list."""
    if items and all(isinstance(x, (torch.Tensor, np.ndarray)) for x in items):
        shape = tuple(items[0].shape)
        if all(tuple(x.shape) == shape for x in items):
            return Dataset(torch.stack([torch.as_tensor(x) for x in items]))
    return Dataset(list(items), batched=False)
