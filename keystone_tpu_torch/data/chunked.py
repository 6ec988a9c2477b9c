"""Out-of-core datasets: a re-iterable row-chunk form of :class:`Dataset`
(port of ``keystone_tpu/data/chunked.py``).

The reference's training sets are Spark RDDs, recomputed from their
lineage on every scan. A :class:`ChunkedDataset` is the counterpart: its
payload is a *factory* that produces an iterator of batched row chunks,
so

* transformer chains compose lazily per chunk (``map_batch`` returns a new
  chunked dataset; nothing runs until a scan);
* every scan recomputes the chain from the source (lineage), unless
  :meth:`ChunkedDataset.cache` finds that the whole set fits a byte budget;
* estimators that stream (the least-squares solvers, StandardScaler)
  accumulate per-chunk statistics instead of calling ``to_array()``, so a
  featurized training set larger than the card's memory is never whole.

A chunked dataset keeps its chain in two parts (see
``pipeline_scan.Chunks``): the source (``from_array`` slices,
``from_chunk_fn`` draws, per-item host maps) runs on a pipelined scan's
producer thread; the per-chunk steps that ``map_batch`` adds (transformers,
fused groups) run on the consumer. Chunks share a leading batch dimension
and are tensors, numpy arrays or tuples of them (the gather zips branch
chunks into tuples).

While a fault plan is active (``faults/plan.py``), every scan's source is
wrapped in the ``scan.chunk`` seam, which fires before each pull inside
the iterator, so a transient fault retries without advancing the source.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..faults import SCAN_CHUNK, RetryBudget, active_plan, retry_call
from ..utils import env_int
from .dataset import Dataset, _rebatch
from .pipeline_scan import (
    Chunks,
    _apply,
    map_payload,
    map_workers,
    payload_nbytes,
    payload_rows,
    scan_pipeline,
    serial_staged,
)
from .shards import maybe_shard


def default_cache_budget_bytes() -> int:
    """Bytes under which :meth:`ChunkedDataset.cache` materializes:
    ``KEYSTONE_CHUNK_CACHE_BUDGET``, default 2 GiB."""
    return env_int("KEYSTONE_CHUNK_CACHE_BUDGET", 2 << 30, minimum=0)


def prefetch_to_device(chunks: Any, depth: int = 2, device: Any = None):
    """Iterate ``chunks`` copied to ``device`` up to ``depth`` ahead, in
    order (the serial form of a scan)."""
    return serial_staged(chunks, depth, device)


class _InjectedChunks:
    """The ``scan.chunk`` seam: fires the fault point before each pull,
    inside this iterator, so a transient fault retries (with backoff)
    without advancing the source, and the last one of a spent budget
    propagates. A scan made over it adopts its ``retry_budget``: one budget
    a scan for chunk production and staging."""

    def __init__(self, it: Iterator[Any], label: str):
        self._it = it
        self._label = label
        self.retry_budget = RetryBudget(label=f"scan[{label}]")

    def __iter__(self) -> "_InjectedChunks":
        return self

    def __next__(self) -> Any:
        retry_call(lambda: None, self.retry_budget, SCAN_CHUNK, label=self._label)
        return next(self._it)

    def close(self) -> None:
        close = getattr(self._it, "close", None)
        if close is not None:
            close()

    @property
    def shards(self) -> int:
        """Producer shards behind the seam."""
        return getattr(self._it, "shards", 1)

    @property
    def shard_chunks(self):
        return getattr(self._it, "shard_chunks", None)


def _maybe_inject(it: Iterator[Any], label: str) -> Iterator[Any]:
    """``it`` behind the ``scan.chunk`` seam while a fault plan is active;
    ``it`` itself otherwise."""
    if active_plan() is None:
        return it
    return _InjectedChunks(it, label)


def _as_tensor(leaf: Any) -> Any:
    return torch.from_numpy(leaf) if isinstance(leaf, np.ndarray) else leaf


def concat_chunks(parts: Sequence[Any]) -> Any:
    """Chunk payloads joined along rows (tuples leaf by leaf)."""
    if isinstance(parts[0], tuple):
        return tuple(concat_chunks([p[i] for p in parts]) for i in range(len(parts[0])))
    if len(parts) == 1:
        return _as_tensor(parts[0])
    return torch.cat([_as_tensor(p) for p in parts], dim=0)


def _zip_steps(step_lists: Sequence[tuple]) -> tuple:
    """One consumer step running each branch's steps on its element of a
    zipped chunk, or none when no branch has any."""
    if not any(step_lists):
        return ()
    return (lambda t: tuple(_apply(s, c) for s, c in zip(step_lists, t)),)


def rechunk_batched(dataset: Dataset, sizes: Sequence[int]) -> "ChunkedDataset":
    """A chunked view of a materialized batched dataset, cut at ``sizes``."""
    payload = dataset.payload

    def factory():
        i = 0
        for sz in sizes:
            lo = i
            yield map_payload(lambda a: a[lo:lo + sz], payload)
            i += sz

    return ChunkedDataset(factory, sum(sizes), label="rechunk")


def align_and_zip(datasets: Sequence[Dataset]) -> "ChunkedDataset":
    """Zip chunked and materialized branches into one chunked dataset of
    tuples, without a probing scan: the first chunked branch sets the
    boundaries as the scan runs, materialized branches are sliced at a row
    cursor, and other chunked branches are pulled in lockstep (they derive
    from one source, so their boundaries agree; checked per chunk)."""
    chunked_idx = [i for i, ds in enumerate(datasets) if isinstance(ds, ChunkedDataset)]
    if not chunked_idx:
        raise ValueError("align_and_zip needs at least one chunked branch")
    n = len(datasets[0])
    if any(len(ds) != n for ds in datasets[1:]):
        raise ValueError("align_and_zip of datasets with different lengths")
    lead = chunked_idx[0]
    sources = {i: datasets[i]._payload for i in chunked_idx}
    payloads = {i: ds.payload for i, ds in enumerate(datasets) if i not in sources}

    def factory():
        iters = {i: iter(p()) for i, p in sources.items()}
        cursor = 0
        for lead_chunk in iters[lead]:
            rows = payload_rows(lead_chunk)
            out: List[Any] = []
            for i in range(len(datasets)):
                if i == lead:
                    out.append(lead_chunk)
                elif i in iters:
                    c = next(iters[i], None)
                    if c is None or payload_rows(c) != rows:
                        raise ValueError("align_and_zip: misaligned chunk boundaries")
                    out.append(c)
                else:
                    lo = cursor
                    out.append(map_payload(lambda a: a[lo:lo + rows], payloads[i]))
            cursor += rows
            yield tuple(out)
        if cursor != n:
            raise ValueError(f"align_and_zip: chunked branch produced {cursor} rows, "
                             f"expected {n}")
        for i in chunked_idx[1:]:
            if next(iters[i], None) is not None:
                raise ValueError("align_and_zip: branch chunk counts differ")

    steps = [datasets[i]._steps if i in sources else () for i in range(len(datasets))]
    return ChunkedDataset(factory, n, label="zip", steps=_zip_steps(steps))


class ChunkedDataset(Dataset):
    """N rows produced in batched chunks by a re-iterable factory, with the
    per-chunk ``steps`` that ``map_batch`` added."""

    def __init__(self, chunk_factory: Callable[[], Iterator[Any]], num_rows: int, *,
                 label: Optional[str] = None, steps: Sequence[Callable[[Any], Any]] = ()):
        # the payload is the factory: a data leaf keyed by it is "the same
        # logical data" for a collection recomputed from its lineage
        self._payload = chunk_factory
        self._batched = True
        self._num_rows = int(num_rows)
        self._label = label or "chunked"
        self._steps = tuple(steps)
        #: ``fn(start, step=1)`` iterating source chunks start, start+step, …
        #: without producing the others, for the indexable sources: the
        #: resume hook (step 1) and the sharded producer's (step N)
        self._skip_factory: Optional[Callable[..., Iterator[Any]]] = None
        #: the per-item ``(shape, dtype)`` of the source's chunks when a
        #: constructor can see it (``from_array``), read by the static
        #: checker without producing a chunk; None after ``map_batch``
        self._item_spec: Optional[tuple] = None

    # ---- constructors ---------------------------------------------------

    @staticmethod
    def from_array(arr: Any, chunk_rows: int) -> "ChunkedDataset":
        """A chunked view of an in-memory array or tensor: each chunk is a
        slice, so a tensor on the card is chunked without a copy."""
        n = int(arr.shape[0])
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")

        def from_chunk(start: int, step: int = 1):
            for i in range(start * chunk_rows, n, chunk_rows * step):
                yield arr[i:i + chunk_rows]

        ds = ChunkedDataset(lambda: from_chunk(0), n, label=f"array[{n}]")
        ds._skip_factory = from_chunk
        dtype = getattr(arr, "dtype", None)
        if dtype is not None:
            dtype = str(dtype).replace("torch.", "")
            ds._item_spec = (tuple(int(d) for d in arr.shape[1:]), dtype)
        return ds

    @staticmethod
    def from_chunk_fn(chunk_fn: Callable[[int], Any], num_chunks: int, num_rows: int, *,
                      label: Optional[str] = None) -> "ChunkedDataset":
        """Chunks generated by index: ``chunk_fn(i)`` must return the same
        payload for the same ``i`` on every scan (a chunk drawn on the card
        takes a generator seeded by its index, never the global one). A
        transient failure of ``chunk_fn`` (``faults.TransientError``)
        regenerates the chunk while the ``KEYSTONE_SCAN_RETRIES`` budget
        lasts. (The fault plan's ``scan.chunk`` faults fire at the scan's
        seam, not here, so a chunk counts once.)"""

        def from_chunk(start: int, step: int = 1):
            budget = RetryBudget(label=f"chunk_fn[{label or 'chunked'}]")
            for i in range(start, num_chunks, step):
                yield retry_call(lambda i=i: chunk_fn(i), budget, SCAN_CHUNK, inject=False)

        ds = ChunkedDataset(lambda: from_chunk(0), num_rows, label=label)
        ds._skip_factory = from_chunk
        return ds

    # ---- shape / access -------------------------------------------------

    @property
    def is_chunked(self) -> bool:
        return True

    @property
    def item_spec(self) -> Optional[tuple]:
        """The per-item ``(shape, dtype)`` known without producing a chunk,
        or None."""
        return getattr(self, "_item_spec", None)

    def __len__(self) -> int:
        return self._num_rows

    def chunks(self, device: Any = None) -> Iterator[Any]:
        """One scan through the pipelined runtime: the source on a producer
        thread (split over ``KEYSTONE_SCAN_SHARDS`` producers), host chunks
        copied to ``device`` (None: numpy chunks become CPU tensors, tensors
        stay where they are), the steps on the caller's thread."""
        return scan_pipeline(Chunks(self._production(), self._steps), label=self._label,
                             device=device)

    def _production(self) -> Iterator[Any]:
        """The produced chunks, split over producer shards when asked; the
        fault seam wraps the merged stream, so a plan's indices follow the
        chunk order."""
        return _maybe_inject(maybe_shard(self._skip_factory, lambda: iter(self._payload()),
                                         label=self._label), self._label)

    def raw_chunks(self, skip: int = 0) -> Chunks:
        """One scan without the pipelined runtime, for composition sites
        that feed another scan (the streaming solvers wrap it in their own
        ``scan_pipeline``, which then runs its source on the producer and
        its steps on the consumer). ``skip`` starts at chunk ``skip``: an
        indexable source skips without producing the prefix, another one
        produces and drops it."""
        if skip <= 0:
            return Chunks(self._production(), self._steps)
        if self._skip_factory is not None:
            source = maybe_shard(self._skip_factory, lambda: iter(self._skip_factory(skip)),
                                 start=skip, label=self._label)
            return Chunks(_maybe_inject(source, self._label), self._steps)
        it = iter(self._payload())
        for _ in range(skip):
            if next(it, None) is None:
                break
        return Chunks(_maybe_inject(it, self._label), self._steps)

    def __iter__(self) -> Iterator[Any]:
        # per-row consumers: the chunks on the device the chain made them on
        for chunk in scan_pipeline(Chunks(self._payload(), self._steps),
                                   label=f"{self._label}|iter"):
            for i in range(payload_rows(chunk)):
                yield map_payload(lambda a: a[i], chunk)

    def take(self, n: int) -> Dataset:
        """The first ``n`` rows, from a raw scan that stops at the chunk
        that completes them: a 24-row sample of a million-row set pays for
        one chunk."""
        if n < 0:
            raise ValueError("take of a negative count")
        parts: List[Any] = []
        rows = 0
        it = self.raw_chunks()
        try:
            while rows < n:
                chunk = next(it, None)
                if chunk is None:
                    break
                got = payload_rows(chunk)
                if got > n - rows:
                    need = n - rows
                    chunk = map_payload(lambda a: a[:need], chunk)
                    got = need
                parts.append(chunk)
                rows += got
            if not parts and n == 0:
                chunk = next(it, None)
                if chunk is not None:
                    parts.append(map_payload(lambda a: a[:0], chunk))
        finally:
            it.close()
        if not parts:
            return Dataset([], batched=False)
        return Dataset(concat_chunks(parts))

    def first(self) -> Any:
        head = self.take(1)
        if len(head) == 0:
            raise IndexError("first() of an empty chunked dataset")
        return head.first()

    def to_array(self) -> Any:
        """Every chunk joined (for small results: samples, predictions;
        estimators stream instead)."""
        parts = list(self.chunks())
        if not parts:
            raise ValueError("empty chunked dataset")
        return concat_chunks(parts)

    # ---- functional ops (lazy) ------------------------------------------

    def _derived(self, steps: tuple, label: str) -> "ChunkedDataset":
        ds = ChunkedDataset(self._payload, self._num_rows, label=f"{self._label}|{label}",
                            steps=steps)
        ds._skip_factory = self._skip_factory
        return ds

    def map_batch(self, fn: Callable[[Any], Any]) -> "ChunkedDataset":
        """``fn`` applied to every chunk, lazily, on the consumer of each
        scan (lineage: a scan recomputes it)."""
        return self._derived(self._steps + (fn,), "map_batch")

    def map(self, fn: Callable[[Any], Any]) -> "ChunkedDataset":
        """A per-item function within each chunk, the results stacked again.
        The items of a chunk run on a pool of ``KEYSTONE_MAP_WORKERS``
        threads (1 runs them in order in one thread), so ``fn`` must hold
        no shared mutable state. On a source without steps the map is part
        of the source (the producer thread runs it); after a step it is a
        step itself."""

        def one(chunk, i):
            return torch.as_tensor(fn(map_payload(lambda a: a[i], chunk)))

        def map_chunk(chunk, pool):
            rows = payload_rows(chunk)
            if pool is None or rows <= 1:
                items = [one(chunk, i) for i in range(rows)]
            else:
                items = list(pool.map(one, [chunk] * rows, range(rows)))
            return _rebatch(items).payload

        def run(chunks):
            workers = map_workers()
            pool = ThreadPoolExecutor(workers) if workers > 1 else None
            try:
                for chunk in chunks:
                    yield map_chunk(chunk, pool)
            finally:
                if pool is not None:
                    pool.shutdown(wait=True)

        if self._steps:
            def step(chunk):
                workers = map_workers()
                if workers <= 1:
                    return map_chunk(chunk, None)
                with ThreadPoolExecutor(workers) as pool:
                    return map_chunk(chunk, pool)

            return self._derived(self._steps + (step,), "map")
        parent, parent_skip = self._payload, self._skip_factory
        ds = ChunkedDataset(lambda: run(parent()), self._num_rows, label=f"{self._label}|map")
        if parent_skip is not None:
            ds._skip_factory = lambda start, step=1: run(parent_skip(start, step))
        return ds

    def cache(self, budget_bytes: Optional[int] = None) -> Dataset:
        """Materialized when the whole set fits ``budget_bytes``; else
        ``self`` (recomputed per scan). The estimate costs one chunk, which
        a set that does fit reuses."""
        budget = default_cache_budget_bytes() if budget_bytes is None else budget_bytes
        it = self.chunks()
        try:
            head = next(it, None)
            if head is None:
                raise ValueError("empty chunked dataset")
            total = payload_nbytes(head)
            if total * (self._num_rows / max(payload_rows(head), 1)) > budget:
                return self
            parts = [head]
            for chunk in it:
                total += payload_nbytes(chunk)
                if total > budget:  # ragged chunks made the estimate low
                    return self
                parts.append(chunk)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        return Dataset(concat_chunks(parts))

    # ---- combination ----------------------------------------------------

    @staticmethod
    def zip_chunks(datasets: Sequence["ChunkedDataset"]) -> "ChunkedDataset":
        """N chunked datasets with equal chunk boundaries zipped into one
        whose chunks are tuples (the gather's chunked form)."""
        if not datasets:
            raise ValueError("zip_chunks of zero datasets")
        n = len(datasets[0])
        if any(len(ds) != n for ds in datasets[1:]):
            raise ValueError("zip_chunks of datasets with different lengths")
        sources = [ds._payload for ds in datasets]

        def factory():
            iters = [iter(p()) for p in sources]
            total = 0
            for chunks in zip(*iters):
                rows = {payload_rows(c) for c in chunks}
                if len(rows) != 1:
                    raise ValueError(f"zip_chunks: misaligned chunk boundaries {rows}")
                total += rows.pop()
                yield tuple(chunks)
            for it in iters:  # every branch must end together
                if next(it, None) is not None:
                    raise ValueError("zip_chunks: branch chunk counts differ")
            # zip() consumes and drops the extra chunk of an earlier branch
            # that has one more than a later one; the row count sees it
            if total != n:
                raise ValueError(f"zip_chunks: the zipped chunks hold {total} rows, the "
                                 f"branches {n}")

        return ChunkedDataset(factory, n, label="zip",
                              steps=_zip_steps([ds._steps for ds in datasets]))
