"""The span record: one timed region of pipeline execution (port of
``keystone_tpu/obs/span.py``).

A :class:`Span` is what the :class:`~keystone_tpu_torch.obs.tracer.Tracer`
collects: name, DAG node identity, operator type, wall-clock interval,
device-sync time, materialized output bytes, cache hit or miss, and the
count of compiles across the region. The JAX package counts XLA backend
compiles there; the port counts CUDA-graph captures
(``workflow/cuda_graph.py``), its counterpart of a compiled program, and
keeps the field's name so that both packages export one schema. Spans
form a tree per thread (``parent_id`` and ``depth`` come from the
tracer's thread-local stack).

The helpers here size and synchronize values without side effects:
sizing never forces a lazy or chunked dataset, and syncing waits only for
the work queued on the current CUDA stream before a tensor of the value
(an event recorded there, never a device-wide ``synchronize``, which
would charge a worker-pool branch with its siblings' work). Nothing is
synchronized while the current stream is capturing a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch


@dataclass
class Span:
    """One traced region. ``start`` and ``end`` are ``time.perf_counter``
    readings; the exporter rebases them onto the tracer's epoch."""

    name: str
    start: float
    end: float = 0.0
    span_id: int = 0
    parent_id: Optional[int] = None
    depth: int = 0
    tid: int = 0
    thread_name: str = ""
    #: DAG node identity (the NodeId's number as a string), None otherwise
    node_id: Optional[str] = None
    #: operator class name (Cacher, FusedTransformerOperator, ...)
    op_type: Optional[str] = None
    #: "hit" (memoized result returned), "miss" (computed) or None
    cache: Optional[str] = None
    #: seconds spent waiting for the card at span exit
    sync_seconds: float = 0.0
    #: materialized result size, when cheaply knowable (see cheap_nbytes)
    output_bytes: Optional[int] = None
    #: CUDA-graph captures made inside this span
    compiles: int = 0
    instant: bool = False
    #: free-form attributes; the concurrent executor adds
    #: ``queue_wait_seconds`` (ready-to-started latency) and ``worker``
    #: (the pool thread's name) to the node spans it forced
    attrs: Dict[str, Any] = field(default_factory=dict)
    #: value waited for at span exit (cleared once synced); not exported
    sync_target: Any = field(default=None, repr=False)

    @property
    def seconds(self) -> float:
        return max(self.end - self.start, 0.0)

    def sync_on(self, value: Any) -> None:
        """Wait for ``value`` when this span closes, so device work queued
        inside it is charged here and not to a later span."""
        self.sync_target = value


def _cuda_tensor(value: Any) -> Optional[torch.Tensor]:
    """The first tensor of ``value`` (a tensor, a batched Dataset, a
    SparseRows batch, or a tuple or list of those, by its first entry)
    when it lives on a CUDA device, else None. Item-list and chunked
    datasets answer None: waiting for them would force them."""
    from ..data.dataset import Dataset
    from ..data.sparse import SparseRows

    if isinstance(value, Dataset):
        if value.is_chunked or not value.is_batched:
            return None
        value = value.payload
    while isinstance(value, (tuple, list)) and value:
        value = value[0]
    if isinstance(value, SparseRows):
        value = value.values
    return value if isinstance(value, torch.Tensor) and value.is_cuda else None


def sync_value(value: Any) -> bool:
    """Wait until the work queued on the current stream of the device of
    ``value``'s first CUDA tensor is done. Returns True when it waited:
    False for host values, item lists, chunked datasets, and while the
    current stream is capturing a CUDA graph."""
    t = _cuda_tensor(value)
    if t is None:
        return False
    with torch.cuda.device(t.device):
        if torch.cuda.is_current_stream_capturing():
            return False
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
    event.synchronize()
    return True


def cheap_nbytes(value: Any) -> Optional[int]:
    """Materialized size of ``value`` in bytes, without forcing computation,
    a copy to the host or a chunk. None when that is not cheaply known."""
    from ..data.dataset import Dataset
    from ..data.sparse import SparseRows

    if isinstance(value, Dataset):
        if value.is_chunked or not value.is_batched:
            return None  # sizing would produce chunks or collect items
        return cheap_nbytes(value.payload)
    if isinstance(value, torch.Tensor):
        return int(value.nbytes)
    if isinstance(value, SparseRows):
        return int(value.indices.nbytes + value.values.nbytes)
    if isinstance(value, tuple) and value:
        sizes = [cheap_nbytes(v) for v in value]
        return None if any(s is None for s in sizes) else int(sum(sizes))
    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    return None
