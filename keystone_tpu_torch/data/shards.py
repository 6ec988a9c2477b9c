"""Sharded chunk production: N producer threads split the chunk indices of
one out-of-core scan (port of ``keystone_tpu/data/shards.py``).

Shard ``s`` of ``N`` produces chunks ``s, s+N, s+2N, …`` through the
dataset's stride factory (each shard runs the whole source for its
indices), and the merge pops the shards' queues round-robin in index
order, so the merged stream is the single producer's: the same chunks, in
the same order, with the same values. A shard failure surfaces at the
index where it happened, after every chunk before it; ``close()`` (or
garbage collection) stops the shards, drains their queues and joins
them.

``KEYSTONE_SCAN_SHARDS`` (default 1, one producer) sets the shard count; a
source without a stride factory is produced by one thread, with a log
line, never an error.
"""

from __future__ import annotations

import logging
import threading
import time
from queue import Empty, Full, Queue
from typing import Any, Callable, Iterator, List, Optional

from ..utils import env_int

logger = logging.getLogger(__name__)

#: how far one shard may run ahead of the merge
DEFAULT_SHARD_DEPTH = 2
_JOIN_TIMEOUT = 5.0

_CHUNK, _ERROR, _DONE = 0, 1, 2


def scan_shards() -> int:
    """Producer shards a scan: ``KEYSTONE_SCAN_SHARDS``, default 1."""
    return env_int("KEYSTONE_SCAN_SHARDS", 1)


def _shard_loop(it: Iterator[Any], q: Queue, stop: threading.Event,
                counts: List[int], shard: int) -> None:
    """One shard's thread body. Module-level, so that the thread holds no
    reference to the producer object that owns it."""

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except Full:
                continue
        return False

    try:
        while not stop.is_set():
            try:
                chunk = next(it)
            except StopIteration:
                break
            if not put((_CHUNK, chunk)):
                return
            counts[shard] += 1
    except BaseException as e:  # noqa: BLE001 — surfaces in the consumer
        put((_ERROR, e))
        return
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                logger.warning("sharded scan: closing shard %d's source failed", shard,
                               exc_info=True)
    put((_DONE, None))


class ShardedChunkProducer:
    """Order-keeping merge of N shard producers over one stride factory
    (``fn(start, step)`` iterates chunks ``start, start+step, …``)."""

    def __init__(self, stride_factory: Callable[[int, int], Iterator[Any]], shards: int, *,
                 start: int = 0, depth: int = DEFAULT_SHARD_DEPTH, label: str = "scan"):
        if shards < 2:
            raise ValueError(f"ShardedChunkProducer needs >= 2 shards, got {shards}")
        self.shards = int(shards)
        self.label = label
        #: chunks produced by each shard
        self.shard_chunks: List[int] = [0] * self.shards
        self._queues: List[Queue] = [Queue(maxsize=max(1, depth)) for _ in range(self.shards)]
        self._stop = threading.Event()
        self._next = 0  # the merged cursor: the next chunk is shard _next % shards's
        self._closed = False
        self._threads: List[threading.Thread] = []
        for s in range(self.shards):
            t = threading.Thread(
                target=_shard_loop,
                args=(iter(stride_factory(start + s, self.shards)), self._queues[s],
                      self._stop, self.shard_chunks, s),
                name=f"ks-shard[{label}]{s}", daemon=True)
            self._threads.append(t)
            t.start()

    def __iter__(self) -> "ShardedChunkProducer":
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise StopIteration
        kind, payload = self._get(self._next % self.shards)
        if kind == _CHUNK:
            self._next += 1
            return payload
        # chunk indices are dense: when the shard that owns the next index
        # has none, the scan is over
        self.close()
        if kind == _ERROR:
            raise payload
        raise StopIteration

    def _get(self, s: int):
        q, t = self._queues[s], self._threads[s]
        while True:
            try:
                return q.get(timeout=0.1)
            except Empty:
                if not t.is_alive():
                    try:
                        return q.get_nowait()
                    except Empty:
                        raise RuntimeError(
                            f"sharded scan[{self.label}]: shard {s} died without "
                            "finishing its indices") from None

    def close(self) -> None:
        """Stop every shard, drain the queues and join the threads."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        for q in self._queues:
            while True:
                try:
                    q.get_nowait()
                except Empty:
                    break
        deadline = time.monotonic() + _JOIN_TIMEOUT
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                logger.warning("sharded scan[%s]: shard thread %s did not exit within "
                               "%.1f s", self.label, t.name, _JOIN_TIMEOUT)

    def __del__(self):
        try:
            if not self._closed:
                self.close()
        except Exception:  # interpreter teardown: the threads are daemons
            pass


def maybe_shard(stride_factory: Optional[Callable[[int, int], Iterator[Any]]],
                fallback: Callable[[], Iterator[Any]], *, shards: Optional[int] = None,
                start: int = 0, label: str = "scan") -> Iterator[Any]:
    """A sharded producer when ``shards`` (default ``KEYSTONE_SCAN_SHARDS``)
    asks for more than one and the source can stride, else ``fallback()``."""
    n = scan_shards() if shards is None else int(shards)
    if n <= 1:
        return fallback()
    if stride_factory is None:
        logger.info("scan[%s]: %d shards asked for, but the chunk source is not "
                    "index-addressable; one producer", label, n)
        return fallback()
    return ShardedChunkProducer(stride_factory, n, start=start, label=label)
