"""The batched-tensor subset of ``keystone_tpu/data/dataset.py``.

A ``Dataset`` here holds either one tensor whose leading dimension is the
item index, or a tuple of such tensors with the same number of rows (the
output of ``Pipeline.gather``: one ``(n, d_i)`` tensor per branch, or the
column blocks of ``VectorSplitter``). The item-list form of the JAX
package is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple, Union

import numpy as np
import torch

Payload = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class Dataset:
    """A logical collection of N items stored as one stacked tensor, or as
    a tuple of stacked tensors that share their leading dimension."""

    def __init__(self, payload: Payload):
        if isinstance(payload, tuple):
            if not payload:
                raise ValueError("a tuple payload needs at least one tensor")
            n = payload[0].shape[0]
            if any(p.shape[0] != n for p in payload):
                raise ValueError("the tensors of a tuple payload differ in rows")
        self._payload = payload

    @staticmethod
    def of(data: Any) -> "Dataset":
        """Wrap ``data``: a Dataset as is, a tensor, a tuple of tensors, or a
        numpy array (as a CPU tensor sharing its memory)."""
        if isinstance(data, Dataset):
            return data
        if isinstance(data, torch.Tensor):
            return Dataset(data)
        if isinstance(data, tuple) and all(isinstance(p, torch.Tensor) for p in data):
            return Dataset(data)
        if isinstance(data, np.ndarray):
            return Dataset(torch.from_numpy(data))
        raise TypeError(f"cannot make a Dataset of {type(data).__name__}")

    @property
    def payload(self) -> Payload:
        return self._payload

    def __len__(self) -> int:
        first = self._payload[0] if isinstance(self._payload, tuple) else self._payload
        return int(first.shape[0])

    def take(self, n: int) -> "Dataset":
        """The first ``n`` items, as a view."""
        if n < 0:
            raise ValueError("take of a negative count")
        if isinstance(self._payload, tuple):
            return Dataset(tuple(p[:n] for p in self._payload))
        return Dataset(self._payload[:n])

    def to_array(self) -> Payload:
        """The stacked payload: a tensor, or the tuple of tensors."""
        return self._payload

    def map_batch(self, fn: Callable[[Payload], Payload]) -> "Dataset":
        """Apply ``fn`` to the whole stacked payload at once."""
        return Dataset(fn(self._payload))
