"""Pipelined out-of-core scans: host production and staging copies overlap
the card's compute (port of ``keystone_tpu/data/pipeline_scan.py``).

A :class:`~keystone_tpu_torch.data.chunked.ChunkedDataset` scan is a
bounded producer/consumer pipeline:

* a **producer** thread runs the chunk source (host reads and per-item
  host maps, or draws on the card by chunk index) into a bounded queue of
  ``KEYSTONE_SCAN_DEPTH`` chunks (default 2). A host chunk bound for the
  card is copied there by the producer on a copy stream of the scan and
  handed over with an event recorded after the copy. The copy is made
  from the chunk's own (pageable) memory and blocks the producer only:
  staging through pinned memory took twice as long for 4 MB chunks on an
  H100 (PERF.md §6);
* the **consumer** (a streaming solver, a materializer) makes its stream
  wait on that event, marks each copied tensor as used by its stream
  (``record_stream``: the caching allocator then keeps the block until
  the consumer's work on it has run), and applies the scan's per-chunk
  steps (:class:`Chunks`): transformers, fused groups and their CUDA
  graphs run on the consumer's thread and stream, so a graph is only ever
  captured there.

Card work that the producer's source issues itself (a draw by chunk
index) goes to the consumer's stream as it stood when the scan was made:
the queue orders it before the consumer's use of the chunk, and the
allocator's stream order covers the blocks the two threads share.

Contract: chunk order is kept; an exception of the producer surfaces in
the consumer with its original traceback; an early exit of the consumer
(``close()``, garbage collection of an abandoned iterator, ``GeneratorExit``
in a wrapping generator) drains the queue and joins the producer. No
failure falls back to another path: it raises. A producer's exception
includes a ``BaseException`` (an injected ``ReplicaKilled``): it too ends
the scan in the consumer after the chunks queued before it. Each staging
copy fires the ``scan.stage`` fault point first and retries transient
failures from the scan's one budget (``faults/retry.py``). With a tracer
installed, a pipelined scan records its counters as one ``scan.pipeline``
span when it shuts down (``obs/scan.py``).

Knobs: ``KEYSTONE_SCAN_PIPELINE=0`` is the kill switch (a serial scan in
the calling thread, with the same copies and steps); ``KEYSTONE_SCAN_DEPTH``
the queue's depth; ``KEYSTONE_CHUNK_BUCKETS=0`` turns off the row buckets
of ragged chunks (:class:`ChunkPadder`); ``KEYSTONE_MAP_WORKERS`` sizes
the item pool of ``ChunkedDataset.map``.

Laned scans (``lanes > 1``, ``parallel/lanes.py``): consumers that keep one
partial accumulator per lane (the streaming solvers, column means, the
streaming StandardScaler) ask for one staging lane per data-axis slot of
the mesh. Chunk ``i`` goes to lane ``i % lanes`` and is staged to that
lane's slot's device; the queue holds ``depth`` chunks a lane, so up to
``depth × lanes`` are in flight. The deal is fixed, so a consumer knows a
chunk's lane from its position. The stats count the chunks and the staged
bytes of each lane (a host chunk counts as staged to its lane, whichever
device the lane's slot is on), and the consumer's crossings between slots
(``record_collectives``) land on the scan's span, also after it was
recorded. With ``KEYSTONE_SCAN_PIPELINE=0`` the serial scan keeps the lane
placement. On one card the lanes' slots share
the card: the chunks are staged to it as in a one-lane scan.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from queue import Empty, Full, Queue
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..faults import SCAN_STAGE, RetryBudget, retry_call
from ..utils import env_flag, env_int

logger = logging.getLogger(__name__)

DEFAULT_DEPTH = 2
_JOIN_TIMEOUT = 5.0


def pipeline_enabled() -> bool:
    """The ``KEYSTONE_SCAN_PIPELINE`` kill switch (default on), read per scan."""
    return env_flag("KEYSTONE_SCAN_PIPELINE", True)


def bucketing_enabled() -> bool:
    """The ``KEYSTONE_CHUNK_BUCKETS`` switch of :class:`ChunkPadder` (default on)."""
    return env_flag("KEYSTONE_CHUNK_BUCKETS", True)


def pipeline_depth() -> int:
    return env_int("KEYSTONE_SCAN_DEPTH", DEFAULT_DEPTH)


def map_workers() -> int:
    """Item pool of ``ChunkedDataset.map``: ``KEYSTONE_MAP_WORKERS``,
    default min(4, cores); 1 runs the items in the calling thread."""
    return env_int("KEYSTONE_MAP_WORKERS", min(4, os.cpu_count() or 1))


# -- payloads: a tensor or array, or a (nested) tuple of them ---------------


def payload_leaves(payload: Any) -> List[Any]:
    if isinstance(payload, (tuple, list)):
        return [leaf for p in payload for leaf in payload_leaves(p)]
    return [payload]


def map_payload(fn: Callable[[Any], Any], payload: Any) -> Any:
    if isinstance(payload, tuple):
        return tuple(map_payload(fn, p) for p in payload)
    return fn(payload)


def payload_rows(payload: Any) -> int:
    return int(payload_leaves(payload)[0].shape[0])


def payload_nbytes(payload: Any) -> int:
    """Bytes of a chunk payload. A leaf without a dtype (a Python scalar)
    is measured through numpy's view of it."""
    total = 0
    for leaf in payload_leaves(payload):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            arr = np.asarray(leaf)
            total += arr.size * arr.itemsize
    return total


def _to_device(leaf: Any, device: Optional[torch.device],
               count_host: bool = False) -> Tuple[Any, int]:
    """``leaf`` as a tensor on ``device`` (a numpy array becomes a CPU
    tensor sharing its memory when ``device`` is None); the bytes copied,
    or with ``count_host`` the bytes of a host array staged without a copy
    too."""
    host = isinstance(leaf, np.ndarray)
    if host:
        leaf = torch.from_numpy(leaf)
    if not isinstance(leaf, torch.Tensor) or device is None or leaf.device == device:
        return leaf, leaf.numel() * leaf.element_size() if host and count_host else 0
    return leaf.to(device), leaf.numel() * leaf.element_size()


def _stage_chunk(chunk: Any, device: Optional[torch.device],
                 copy_stream=None, count_host: bool = False) -> Tuple[Any, int, Any]:
    """Copy the host leaves of ``chunk`` to ``device``: (the staged chunk,
    bytes staged, the event after the copies or None). With a
    ``copy_stream`` the copies are made there."""
    copied = [0]

    def one(leaf):
        out, nbytes = _to_device(leaf, device, count_host)
        copied[0] += nbytes
        return out

    if copy_stream is None:
        return map_payload(one, chunk), copied[0], None
    with torch.cuda.stream(copy_stream):
        out = map_payload(one, chunk)
        event = copy_stream.record_event() if copied[0] and device is not None else None
    return out, copied[0], event


@dataclass
class ScanStats:
    """Counters of one pipelined scan (host seconds)."""

    label: str = "scan"
    depth: int = DEFAULT_DEPTH
    chunks: int = 0
    #: production and staging inside the producer thread
    producer_seconds: float = 0.0
    #: producer blocked on a full queue (the consumer is the slower side)
    producer_stall_seconds: float = 0.0
    #: consumer blocked on an empty queue (the producer is the slower side)
    consumer_stall_seconds: float = 0.0
    staged_bytes: int = 0
    occupancy_max: int = 0
    start: float = 0.0
    end: float = 0.0
    #: transient failures retried from the scan's budget
    retries: int = 0
    #: producer shards feeding the scan (``data/shards.py``) and their chunks
    shards: int = 1
    shard_chunks: List[int] = field(default_factory=list)
    #: staging lanes (1: a one-lane scan, no lane counts); chunks and staged
    #: bytes of each lane, whose skew shows a straggling lane
    lanes: int = 1
    lane_chunks: List[int] = field(default_factory=list)
    lane_bytes: List[int] = field(default_factory=list)
    #: str of each lane's slot
    lane_devices: List[str] = field(default_factory=list)
    #: crossings between slots that the consumer counted on this scan
    #: (partial reductions, per-block model broadcasts)
    collectives: int = 0

    def as_dict(self) -> dict:
        return asdict(self)


class Chunks:
    """One scan's chunk stream in two parts: ``source`` produces chunks
    (in a pipelined scan, on the producer thread) and ``steps`` transform
    each produced chunk in order (on the consumer). Iterated directly it
    runs both in the calling thread, numpy chunks made CPU tensors first."""

    def __init__(self, source: Any, steps: Sequence[Callable[[Any], Any]] = ()):
        self.source = iter(source)
        self.steps = tuple(steps)

    def then(self, fn: Callable[[Any], Any]) -> "Chunks":
        """The same scan with ``fn`` applied to each chunk after the steps."""
        return Chunks(self.source, self.steps + (fn,))

    def __iter__(self) -> "Chunks":
        return self

    def __next__(self) -> Any:
        return _apply(self.steps, _stage_chunk(next(self.source), None)[0])

    def close(self) -> None:
        close = getattr(self.source, "close", None)
        if close is not None:
            close()


def _apply(steps: Sequence[Callable[[Any], Any]], chunk: Any) -> Any:
    for step in steps:
        chunk = step(chunk)
    return chunk


_CHUNK, _ERROR, _DONE = 0, 1, 2


def _producer_put(q: Queue, stop: threading.Event, stats: ScanStats, item) -> bool:
    t0 = time.perf_counter()
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
        except Full:
            continue
        if item[0] == _CHUNK:
            stats.producer_stall_seconds += time.perf_counter() - t0
            stats.occupancy_max = max(stats.occupancy_max, q.qsize())
        return True
    return False


def _producer_loop(source: Iterator[Any], q: Queue, stop: threading.Event,
                   stats: ScanStats, stage: Callable, stream) -> None:
    """The producer thread's body. A module-level function on purpose: the
    thread must hold no reference to its ScanPipeline, or an abandoned
    iterator could never be garbage-collected and reaped."""
    try:
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    chunk = next(source)
                except StopIteration:
                    break
                chunk, nbytes, event = stage(chunk)
                stats.staged_bytes += nbytes
                stats.producer_seconds += time.perf_counter() - t0
                if not _producer_put(q, stop, stats, (_CHUNK, (chunk, event))):
                    return
                del chunk  # hold no chunk while the next one is produced
    except BaseException as e:  # noqa: BLE001 — surfaces in the consumer
        _producer_put(q, stop, stats, (_ERROR, e))
        return
    finally:
        close = getattr(source, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                logger.warning("scan[%s]: closing the chunk source failed",
                               stats.label, exc_info=True)
    _producer_put(q, stop, stats, (_DONE, None))


def _consumer_stream(device: Optional[torch.device]):
    """The stream the consumer works on, or None off CUDA."""
    if device is not None and device.type == "cuda":
        return torch.cuda.current_stream(device)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.current_stream()
    return None


class ScanPipeline:
    """One pipelined scan: an order-keeping iterator of chunks behind a
    producer thread and a bounded queue. See the module docstring; built
    by :func:`scan_pipeline`."""

    def __init__(self, source: Any, *, depth: Optional[int] = None, label: str = "scan",
                 device: Any = None, steps: Sequence[Callable[[Any], Any]] = (),
                 lanes: int = 1, devices: Optional[Sequence[Any]] = None):
        self._depth = depth or pipeline_depth()
        self._device = None if device is None else torch.device(device)
        self._steps = tuple(steps)
        self._lanes, self._devices = _lane_slots(lanes, devices)
        self._q: Queue = Queue(maxsize=self._depth * self._lanes)
        self._stop = threading.Event()
        self._closed = False
        self._recorded = False
        self._span = None
        self.stats = ScanStats(label=label, depth=self._depth, start=time.perf_counter())
        # one budget a scan: a source behind the scan.chunk seam brings its
        # own, which the staging copies then share
        self._retry = getattr(source, "retry_budget", None) or RetryBudget(label=f"scan[{label}]")
        # a sharded producer reports its split when the scan ends
        self._shard_source = source if getattr(source, "shards", 1) > 1 else None
        targets = ([self._device] if self._devices is None
                   else [s.device for s in self._devices])
        stream = _consumer_stream(targets[0])
        copy_streams = {d: torch.cuda.Stream(d) for d in set(targets)
                        if d is not None and d.type == "cuda"}
        # the producer must hold no reference to self (see _producer_loop)
        budget, stats, seq, n_lanes = self._retry, self.stats, [0], self._lanes
        laned = self._devices is not None
        if laned:
            stats.lanes = self._lanes
            stats.lane_chunks = [0] * self._lanes
            stats.lane_bytes = [0] * self._lanes
            stats.lane_devices = [str(s) for s in self._devices]

        def stage_fn(chunk):
            lane = seq[0] % n_lanes
            seq[0] += 1
            target = targets[lane]
            # a copy is idempotent, so a transient failure retries in place
            out = retry_call(lambda: _stage_chunk(chunk, target, copy_streams.get(target),
                                                  count_host=laned),
                             budget, SCAN_STAGE, label=label)
            if laned:
                stats.lane_chunks[lane] += 1
                stats.lane_bytes[lane] += out[1]
            return out

        self._thread = threading.Thread(
            target=_producer_loop,
            args=(iter(source), self._q, self._stop, self.stats, stage_fn, stream),
            name=f"ks-scan[{label}]", daemon=True)
        self._thread.start()

    @property
    def lanes(self) -> int:
        """The staging lanes; chunk ``i`` is lane ``i % lanes``'s."""
        return self._lanes

    @property
    def lane_devices(self) -> Optional[List[Any]]:
        """The slot of each lane (None on a one-lane scan)."""
        return self._devices

    def record_collectives(self, n: int) -> None:
        """Count ``n`` crossings between slots on this scan, before or after
        it ended (a reduction at the end lands on the recorded span)."""
        self.stats.collectives += int(n)
        if self._span is not None:
            self._span.attrs["collectives"] = self.stats.collectives

    def __iter__(self) -> "ScanPipeline":
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise StopIteration
        t0 = time.perf_counter()
        kind, payload = self._get_blocking()
        self.stats.consumer_stall_seconds += time.perf_counter() - t0
        if kind == _DONE:
            self._shutdown()
            raise StopIteration
        if kind == _ERROR:
            self._shutdown()
            raise payload
        chunk, event = payload
        if event is not None:
            leaves = [leaf for leaf in payload_leaves(chunk)
                      if isinstance(leaf, torch.Tensor) and leaf.is_cuda]
            stream = torch.cuda.current_stream(leaves[0].device)
            stream.wait_event(event)
            for leaf in leaves:
                leaf.record_stream(stream)
        try:
            chunk = _apply(self._steps, chunk)
        except BaseException:
            self.close()
            raise
        self.stats.chunks += 1
        return chunk

    def _get_blocking(self) -> Tuple[int, Any]:
        while True:
            try:
                return self._q.get(timeout=0.1)
            except Empty:
                if not self._thread.is_alive():
                    try:
                        return self._q.get_nowait()
                    except Empty:
                        raise RuntimeError(
                            "scan pipeline producer thread died without finishing the scan"
                        ) from None

    def close(self) -> None:
        """Early exit: stop the producer, drain the queue so that a blocked
        put returns, and join the thread."""
        if self._closed:
            return
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except Empty:
                break
        self._shutdown()

    def _shutdown(self) -> None:
        self._closed = True
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=_JOIN_TIMEOUT)
        if self._recorded:
            return
        self._recorded = True
        self.stats.end = time.perf_counter()
        self.stats.retries = self._retry.attempts
        if self._shard_source is not None:
            self.stats.shards = int(self._shard_source.shards)
            self.stats.shard_chunks = list(self._shard_source.shard_chunks)
        from ..obs.scan import record_scan_span

        # kept: a reduction after the last chunk stamps its count on the span
        self._span = record_scan_span(self.stats)

    def __del__(self):
        try:
            if not self._closed:
                self.close()
        except Exception:  # interpreter teardown: the thread is a daemon
            pass

    def __enter__(self) -> "ScanPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _lane_slots(lanes: int, devices: Optional[Sequence[Any]]):
    """(lane count, the lanes' slots or None): no slots for a one-lane
    scan; the slots default to ``lane_devices(lanes)``."""
    lanes = max(1, int(lanes))
    if lanes == 1:
        return 1, None
    from ..parallel.lanes import lane_devices
    from ..parallel.mesh import as_slot

    if devices is None:
        devices = lane_devices(lanes)
    return lanes, [as_slot(d, i) for i, d in enumerate(devices)]


def serial_staged(chunks: Any, depth: int = DEFAULT_DEPTH, device: Any = None,
                  steps: Sequence[Callable[[Any], Any]] = (), lanes: int = 1,
                  devices: Optional[Sequence[Any]] = None):
    """The scan without a thread (``KEYSTONE_SCAN_PIPELINE=0``): up to
    ``depth`` chunks a lane produced and copied ahead of the consumer (to
    ``device``, or on a laned scan to chunk ``i``'s lane's slot), then
    ``steps`` applied to each, in order."""
    device = None if device is None else torch.device(device)
    lanes, slots = _lane_slots(lanes, devices)
    it = iter(chunks)
    q: deque = deque()
    seq = 0
    try:
        while True:
            while it is not None and len(q) < depth * lanes:
                try:
                    chunk = next(it)
                except StopIteration:
                    it = None
                    break
                target = device if slots is None else slots[seq % lanes].device
                seq += 1
                q.append(_stage_chunk(chunk, target)[0])
            if not q:
                return
            yield _apply(steps, q.popleft())
    finally:
        close = getattr(chunks, "close", None)
        if close is not None:
            close()


def scan_pipeline(chunks: Any, *, depth: Optional[int] = None, label: str = "scan",
                  device: Any = None, lanes: int = 1,
                  devices: Optional[Sequence[Any]] = None):
    """The streaming-scan entry point: any chunk iterable through the
    pipelined runtime. A :class:`Chunks` stream runs its source on the
    producer and its steps on the consumer; any other iterable runs whole
    on the producer. Idempotent: a ScanPipeline passes through with its
    own lanes (read the count off ``.lanes``), so a solver may wrap what
    it is given. Host chunks are copied to ``device``; with None, numpy
    chunks become CPU tensors (no copy) and tensors stay where they are.
    ``lanes > 1`` deals the chunks over the lanes' slots ``devices``
    (default ``lane_devices(lanes)``), for consumers with one partial a
    lane."""
    if isinstance(chunks, ScanPipeline):
        return chunks
    steps: Tuple = ()
    if isinstance(chunks, Chunks):
        chunks, steps = chunks.source, chunks.steps
    if not pipeline_enabled():
        return serial_staged(chunks, depth or pipeline_depth(), device, steps, lanes, devices)
    return ScanPipeline(chunks, depth=depth, label=label, device=device, steps=steps,
                        lanes=lanes, devices=devices)


# -- chunk-shape bucketing ---------------------------------------------------


def bucket_ladder(lead_rows: int, levels: int = 4, multiple: int = 1) -> Tuple[int, ...]:
    """Row buckets for a scan whose lead chunk has ``lead_rows``:
    {ceil(lead / 2^i) for i < levels}, ascending, each rounded up to a
    multiple of ``multiple``. A ragged tail pads to the next bucket up, so
    a fused group sees at most ``levels`` row counts a scan."""
    vals = {max(1, (lead_rows + (1 << i) - 1) >> i) for i in range(max(1, levels))}
    if multiple > 1:
        vals = {((v + multiple - 1) // multiple) * multiple for v in vals}
    return tuple(sorted(vals))


def _pad_rows(a: Any, rows: int, target: int) -> Any:
    if isinstance(a, np.ndarray):
        return np.concatenate([a, np.broadcast_to(a[:1], (target - rows,) + a.shape[1:])])
    return torch.cat([a, a[:1].expand((target - rows,) + tuple(a.shape[1:]))])


class ChunkPadder:
    """A per-chunk function whose ragged (tail) chunks are padded up to a
    small ladder of row buckets fixed by the first chunk seen, so a fused
    group captures one CUDA graph per bucket instead of one per chunk
    shape. The padding repeats the chunk's first row and is cut off the
    result, so the output is exact; ``fn`` must be row-wise in its leading
    axis (batch-coupled steps are refused before one gets here). The
    ladder is kept across scans, so a scan run again reuses the graphs.
    ``KEYSTONE_CHUNK_BUCKETS=0`` passes chunks through as they are.

    Every bucket is rounded up to a multiple of the scan's lane count
    (``parallel.lanes.scan_lanes()``), so a padded chunk divides evenly
    over the data axis; with one lane the ladder is unchanged."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn
        self._buckets: Optional[Tuple[int, ...]] = None
        self._lock = threading.Lock()

    def __call__(self, chunk: Any) -> Any:
        if not bucketing_enabled():
            return self.fn(chunk)
        rows = payload_rows(chunk)
        if self._buckets is None:
            with self._lock:
                if self._buckets is None:
                    from ..parallel.lanes import scan_lanes

                    self._buckets = bucket_ladder(rows, multiple=scan_lanes())
        target = next((b for b in self._buckets if b >= rows), None)
        if target is None or target == rows:
            # at or above the lead shape: unpadded
            return self.fn(chunk)
        out = self.fn(map_payload(lambda a: _pad_rows(a, rows, target), chunk))
        return map_payload(lambda a: a[:rows], out)
