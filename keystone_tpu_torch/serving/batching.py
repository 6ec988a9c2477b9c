"""Shape bucketing: a small static set of batch shapes for the compiled
chain (port of ``keystone_tpu/serving/batching.py``).

A CUDA graph is captured for one input shape, so a serving loop that
stacked whatever requests were queued would present a new batch size, and
pay a new capture, almost every batch. The policy rounds every micro-batch
up to the next of a few bucket sizes by padding rows, so the chain is
captured once per bucket and steady traffic runs with zero captures.
``warmup_inputs`` lets the engine pay every capture before admitting
traffic.

Padding repeats the batch's first row (as ``FittedPipeline.apply_chunked``
does): padded rows stay in distribution for a row-wise chain and are
sliced off before results are returned.
"""

from __future__ import annotations

import threading
from typing import Any, Iterator, Optional, Sequence, Tuple

import numpy as np

from .errors import InvalidRequest


class BucketPolicy:
    """Pads micro-batches to static bucket sizes; validates request data.

    ``datum_shape`` (per-item shape, no batch dim) may be given up front —
    enabling warm-up before any traffic — or left None, in which case it
    locks to the first valid datum seen and warm-up is skipped.
    """

    def __init__(
        self,
        batch_sizes: Sequence[int] = (1, 8, 32, 64),
        datum_shape: Optional[Sequence[int]] = None,
        dtype: Any = np.float32,
    ):
        sizes = sorted(set(int(b) for b in batch_sizes))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"bucket sizes must be positive ints, got {batch_sizes!r}")
        self.batch_sizes: Tuple[int, ...] = tuple(sizes)
        self.datum_shape: Optional[Tuple[int, ...]] = (
            tuple(int(d) for d in datum_shape) if datum_shape is not None else None
        )
        self.dtype = np.dtype(dtype)
        # guards the lazy shape lock-in: N fleet replica workers may
        # validate first requests concurrently, and exactly ONE shape may
        # win — the losers' requests must fail typed, not flip the contract
        self._shape_lock = threading.Lock()

    @property
    def max_size(self) -> int:
        return self.batch_sizes[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding ``n`` rows. The engine never gathers
        more than ``max_size`` requests per batch, so ``n`` always fits."""
        if n < 1:
            raise ValueError("empty batch has no bucket")
        for b in self.batch_sizes:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} exceeds the largest bucket ({self.max_size}); "
            "the engine must split it"
        )

    # -- validation -----------------------------------------------------

    def validate(self, datum: Any) -> np.ndarray:
        """Convert one request datum to the service's array contract, or
        raise :class:`InvalidRequest`. Locks ``datum_shape`` on first use
        when it was not configured."""
        try:
            arr = np.asarray(datum, dtype=self.dtype)
        except (TypeError, ValueError) as e:
            raise InvalidRequest(f"datum not castable to {self.dtype}: {e}") from e
        if self.datum_shape is None:
            with self._shape_lock:
                if self.datum_shape is None:
                    self.datum_shape = tuple(arr.shape)
        if tuple(arr.shape) != self.datum_shape:
            raise InvalidRequest(
                f"datum shape {tuple(arr.shape)} != service shape {self.datum_shape}"
            )
        return arr

    # -- padding / warm-up ----------------------------------------------

    def pad(self, stacked: np.ndarray, bucket: int) -> np.ndarray:
        """Pad ``stacked`` (n ≤ bucket rows) up to ``bucket`` rows by
        repeating its first row."""
        n = int(stacked.shape[0])
        if n == bucket:
            return stacked
        if n > bucket:
            raise ValueError(f"{n} rows do not fit bucket {bucket}")
        return np.concatenate(
            [stacked, np.repeat(stacked[:1], bucket - n, axis=0)], axis=0
        )

    def warmup_inputs(self) -> Iterator[np.ndarray]:
        """One zero batch per bucket, in the exact shape+dtype live
        traffic will present — running these through the compiled fn
        pre-pays every compile the policy allows."""
        if self.datum_shape is None:
            raise ValueError(
                "warm-up needs datum_shape; configure it or serve a first "
                "request to lock the shape"
            )
        for b in self.batch_sizes:
            yield np.zeros((b, *self.datum_shape), dtype=self.dtype)
