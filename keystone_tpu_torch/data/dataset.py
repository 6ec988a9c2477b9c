"""The batched-tensor subset of ``keystone_tpu/data/dataset.py``.

A ``Dataset`` here always holds one tensor whose leading dimension is the
item index; the item-list form of the JAX package is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


class Dataset:
    """A logical collection of N items stored as one stacked tensor."""

    def __init__(self, payload: torch.Tensor):
        self._payload = payload

    @staticmethod
    def of(data: Any) -> "Dataset":
        """Wrap ``data``: a Dataset as is, a tensor, or a numpy array (as a
        CPU tensor sharing its memory)."""
        if isinstance(data, Dataset):
            return data
        if isinstance(data, torch.Tensor):
            return Dataset(data)
        if isinstance(data, np.ndarray):
            return Dataset(torch.from_numpy(data))
        raise TypeError(f"cannot make a Dataset of {type(data).__name__}")

    @property
    def payload(self) -> torch.Tensor:
        return self._payload

    def __len__(self) -> int:
        return int(self._payload.shape[0])

    def take(self, n: int) -> "Dataset":
        """The first ``n`` items, as a view."""
        if n < 0:
            raise ValueError("take of a negative count")
        return Dataset(self._payload[:n])

    def to_array(self) -> torch.Tensor:
        return self._payload

    def map_batch(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Dataset":
        """Apply ``fn`` to the whole stacked payload at once."""
        return Dataset(fn(self._payload))
