"""Segment dispatch: run a planned traceable segment as one program, through
the AOT export, cache and manifest (port of ``keystone_tpu/compile/segment.py``).

``check/segments.py`` cuts the optimized DAG into maximal traceable
segments between materialization barriers. Here :func:`lower_segment`
composes the members' ``forward`` bodies in topological order into one
function from the segment's pinned ``inputs`` to its ``outputs``, and
:class:`SegmentDispatcher` resolves one callable per input-signature tuple
as :class:`~keystone_tpu_torch.compile.aot.AotDispatcher` does for serving
buckets: a cache hit loads the saved ``torch.export`` program (zero
traces); a miss exports once, saves the program, records its signature in
the segment manifest and runs that same program. On the card the row
chunks of a run and the chunks of a scan run as one CUDA graph per chunk
signature, captured at the first chunk and replayed by the next (a CUDA
graph cannot be saved, so a warm process captures the loaded program
again); a whole batch, and everything on the CPU, runs eagerly. Without a
cache the callable is the lowered function itself, the counterpart of the
JAX package's structural ``jax.jit``, and the segment's digest is not
computed: dispatchers are shared by the member operators' identity. A
gather join's tuple payload has no flat signature and is never exported.

:class:`SegmentBinding` is the executor's handle, with three paths:

* **compiled**: dense batched inputs. A segment whose members are all
  row-local runs per row chunk, at the rows its leading members would
  chunk into under node dispatch, so its intermediates never exist for the
  whole batch; with a cache, a ragged last chunk pads up the ``ChunkPadder``
  ladder, so a scan of any length exports a few programs; a batch of one
  chunk or less runs whole. Any other
  segment runs whole, as node dispatch runs a node that is not row-local
  (inside it, a fused group and a row-local node keep their own row
  chunks); one with a batch-coupled member only when the values it holds
  at once, reckoned on fake tensors, fit :data:`WHOLE_BYTES`, and by node
  dispatch otherwise;
* **chunked**: a single-output segment over an out-of-core
  ``ChunkedDataset`` runs the compiled path per scan chunk, the ragged
  chunks padded through ``ChunkPadder``;

without a cache, a segment that is one fused group runs through the
group's own CUDA graphs (one per row-chunk signature), the programs node
dispatch replays too;
* **fallback**: exact node semantics (the same operators' ``execute``, in
  the same order) for item lists, sparse rows, batch-coupled members over
  chunks, multi-output chunked segments, an over-budget segment, and a
  segment demoted by a Python-level failure.

A kernel's build or launch failure and a fault of the card
(``ops.DEVICE_FAULTS``) are never demoted: they propagate and end the run,
as the node path would let them (the JAX package demotes every failure).

Adaptive boundaries close the loop through ``cost/segments.py``: each
export and each run is recorded under the profile store's
``plan/segment/`` namespace, and a segment whose compile cost exceeds its
dispatch savings is demoted to node dispatch at the next plan.
``KEYSTONE_SEGMENT_COMPILE=0`` turns the layer off (read per pull by the
executor, not here).
"""

from __future__ import annotations

import io
import logging
import threading
import time
from collections import Counter, OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ..data.dataset import Dataset, first_leaf, map_leaves
from ..obs.ledger import CompileLedger
from ..obs.tracer import current as _trace_current
from ..ops import is_device_fault
from ..parallel.mesh import physical
from ..workflow.cuda_graph import GraphCache, leaves, signature
from .aot import Signature, _load_program, _place_program, _without_example_inputs, signature_of
from .cache import ExecutableCache
from .fingerprint import (
    FingerprintError,
    environment_key,
    segment_entry_key,
    segment_fingerprint,
)

logger = logging.getLogger(__name__)

#: lowered step: (operator, input slots into the segment's value vector)
Step = Tuple[Any, Tuple[int, ...]]

#: the most bytes a segment with a batch-coupled member may hold at once
#: (its inputs and the member outputs alive together) to run whole; a
#: captured graph keeps its memory pool for as long as the graph lives
WHOLE_BYTES = 4 << 30


def _call(op: Any, args: List[Any]) -> Any:
    """One member on batched payloads, chunked as node dispatch chunks it: a
    row-local transformer through ``_forward_rows``, a fused group through
    its own ``forward``; a gather zips its inputs into a tuple."""
    from ..workflow.operators import GatherTransformerOperator

    if isinstance(op, GatherTransformerOperator):
        return tuple(args)
    rows_fn = getattr(op, "_forward_rows", None)
    if rows_fn is not None and len(args) == 1 and not is_fake(first_leaf(args[0])):
        return rows_fn(args[0])
    return op.forward(*args)


def lower_segment(graph: Any, segment: Any) -> Tuple[Callable, List[Step], Tuple[int, ...]]:
    """Compose ``segment``'s member ``forward`` bodies into one function
    ``fn(*inputs) -> outputs tuple``, each value dropped after its last
    reader.

    The index space is positional over ``segment.inputs`` followed by
    ``segment.nodes``, the space :func:`segment_fingerprint` hashes, so two
    processes that agree on the digest agree on the signature. Returns
    ``(fn, steps, out_slots)``; ``steps`` and ``out_slots`` also drive the
    node-semantics fallback."""
    inputs = list(segment.inputs)
    members = list(segment.nodes)
    pos: Dict[Any, int] = {d: i for i, d in enumerate(inputs)}
    for j, n in enumerate(members):
        pos[n] = len(inputs) + j
    steps: List[Step] = [
        (graph.get_operator(n), tuple(pos[d] for d in graph.get_dependencies(n)))
        for n in members
    ]
    out_slots = tuple(pos[o] for o in segment.outputs)
    last_use: Dict[int, int] = {}
    for k, (_, slots) in enumerate(steps):
        for s in slots:
            last_use[s] = k
    keep = set(out_slots)

    def fn(*xs):
        values = list(xs)
        for k, (op, slots) in enumerate(steps):
            args = [values[s] for s in slots]
            values.append(_call(op, args))
            del args
            for s in slots:
                if last_use[s] == k and s not in keep:
                    values[s] = None
        return tuple(values[s] for s in out_slots)

    return fn, steps, out_slots


class _SegmentModule(torch.nn.Module):
    """The lowered function as the module ``torch.export`` takes; the
    members' tensors are reached through its closure and become lifted
    constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *xs):
        return self.fn(*xs)


class _Program:
    """A callable run eagerly, or, for a chunk on the card (``capture``), as
    one CUDA graph per chunk signature, captured at its first chunk and
    replayed by the next, as a fused group's graphs are. A whole batch runs
    eagerly: a capture pays a warm-up run and a graph's memory pool that
    one apply at a shape never earns back."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._graphs: Optional[GraphCache] = None

    def __call__(self, xs: Tuple[Any, ...], take: Callable[[Any, bool], Any],
                 capture: bool = False) -> Any:
        """``take(outputs, static)`` of the outputs; ``static`` says they are
        a graph's buffers, which the next replay overwrites."""
        if capture and leaves(xs)[0].is_cuda:
            if self._graphs is None:
                self._graphs = GraphCache(self.fn)
            with self._graphs.lock:
                return take(self._graphs(*xs), True)
        return take(self.fn(*xs), False)


def _owned(out: Any, static: bool) -> Any:
    return map_leaves(torch.clone, out) if static else out


class SegmentDispatcher:
    """One callable per input-signature tuple, cache first: the segment
    sibling of :class:`~keystone_tpu_torch.compile.aot.AotDispatcher`.

    Without a cache every signature runs the lowered function (its chunks
    captured on the card). An input with no flat signature (a gather
    join's tuple payload) does too, with a cache as well: it is not
    exported, which is logged once."""

    def __init__(self, fn: Callable, digest: Optional[str], cache: Optional[ExecutableCache], *,
                 label: str = "", n_nodes: int = 1):
        self._fn = fn
        self._digest = digest
        self._cache = cache
        self._label = label
        self._n_nodes = n_nodes
        self._by_sig: Dict[Tuple[Signature, ...], _Program] = {}
        self._structural: Optional[_Program] = None
        self._envs: Dict[str, Dict[str, str]] = {}
        #: held from a call until its outputs are read
        self.lock = threading.RLock()
        self._loaded = 0
        self._traced = 0
        self._refusal_logged = False
        self._unsigned_logged = False
        self._ledger = CompileLedger.for_cache_root(cache.root) if cache is not None else None

    def device_copy(self, copy: Callable) -> "SegmentDispatcher":
        """A fresh dispatcher over the copied function, for a scan lane on
        another device (``parallel.placement.copy_to_device``): its programs
        loaded or exported there and its chunks captured there, sharing the
        cache; the programs and CUDA graphs resolved here stay here."""
        return SegmentDispatcher(copy(self._fn), self._digest, self._cache, label=self._label,
                                 n_nodes=self._n_nodes)

    @property
    def digest(self) -> Optional[str]:
        """The segment's digest; None for a dispatcher without a cache that
        was keyed by its members' identity."""
        return self._digest

    @property
    def has_cache(self) -> bool:
        return self._cache is not None

    @property
    def loaded_count(self) -> int:
        """Signature tuples resolved from the cache (zero traces paid)."""
        return self._loaded

    @property
    def traced_count(self) -> int:
        """Signature tuples that paid a live export trace."""
        return self._traced

    def __call__(self, *xs, take: Callable[[Any, bool], Any] = _owned,
                 capture: bool = False) -> Any:
        """The segment's outputs (a tuple) on ``xs``, through ``take``: by
        default the caller's own (a graph's buffers are copied out).
        ``capture``: ``xs`` is a chunk, run as a CUDA graph on the card."""
        with self.lock:
            return self._program(xs)(xs, take, capture)

    def _program(self, xs: Tuple[Any, ...]) -> _Program:
        try:
            sigs = tuple(signature_of(x) for x in xs)
        except (AttributeError, TypeError):
            # a tuple payload: only an export needs flat tensor inputs
            if self._cache is not None and not self._unsigned_logged:
                self._unsigned_logged = True
                logger.info("segment: %s has a tuple input — run, not exported",
                            self._label or self._digest[:16])
            return self._structural_program()
        prog = self._by_sig.get(sigs)
        if prog is None:
            if self._cache is None:
                prog = self._structural_program()
            else:
                env = self._env(xs)
                prog = (self._load(sigs, env, leaves(xs)[0].device)
                        or self._trace_and_export(sigs, env, xs))
            self._by_sig[sigs] = prog
        return prog

    def _structural_program(self) -> _Program:
        if self._structural is None:
            self._structural = _Program(self._fn)
        return self._structural

    def _env(self, xs: Tuple[Any, ...]) -> Dict[str, str]:
        device = leaves(xs)[0].device
        env = self._envs.get(str(device))
        if env is None:
            env = self._envs[str(device)] = environment_key(device)
        return env

    def _load(self, sigs: Tuple[Signature, ...], env: Dict[str, str],
              device: torch.device) -> Optional[_Program]:
        key = segment_entry_key(self._digest, sigs, env)
        t0 = time.perf_counter()
        entry = self._cache.load(key, expect_env=env)
        if entry is None:
            return None
        try:
            call = _place_program(_load_program(entry.payload), physical(device))
        except Exception as e:
            if is_device_fault(e):
                raise
            logger.warning("segment: unloadable entry for %s — exporting again",
                           self._label or key, exc_info=True)
            self._cache._discard(entry.path, "unloadable")
            return None
        self._loaded += 1
        load_seconds = time.perf_counter() - t0
        self._ledger.record("load", key=key, label=self._label, kind="segment",
                            inputs=len(sigs), nbytes=entry.nbytes, seconds=load_seconds,
                            saved_s=entry.header.get("trace_seconds"))
        tracer = _trace_current()
        if tracer is not None:
            tracer.instant("aot.load", op_type="SegmentDispatcher", key=key, label=self._label,
                           inputs=len(sigs), bytes=entry.nbytes,
                           load_seconds=round(load_seconds, 4),
                           seconds_saved=entry.header.get("trace_seconds"))
        logger.info("segment: loaded %s from cache (%d bytes, saved ~%ss of tracing)",
                    self._label or key, entry.nbytes, entry.header.get("trace_seconds", "?"))
        return _Program(call)

    def _refused(self, sigs: Tuple[Signature, ...], key: str, seconds: float) -> _Program:
        """The export failed: run the lowered function, counted as the one
        trace this signature pays."""
        from ..cost import segments as seg_cost

        if not self._refusal_logged:
            self._refusal_logged = True
            logger.warning("segment: export failed for %s %s — running the lowered "
                           "function (no cross-process caching for it)",
                           self._label or key, sigs, exc_info=True)
        else:
            logger.info("segment: export failed for %s %s", self._label or key, sigs)
        self._traced += 1
        seg_cost.record_compile(self._digest, seconds, exported=False, n_nodes=self._n_nodes)
        return self._structural_program()

    def _trace_and_export(self, sigs: Tuple[Signature, ...], env: Dict[str, str],
                          xs: Tuple[Any, ...]) -> _Program:
        from ..cost import segments as seg_cost
        from . import manifest as _manifest

        tracer = _trace_current()
        key = segment_entry_key(self._digest, sigs, env)
        if tracer is not None:
            tracer.instant("aot.miss", op_type="SegmentDispatcher", key=key, label=self._label,
                           inputs=len(sigs))
        t0 = time.perf_counter()
        try:
            exported = torch.export.export(_SegmentModule(self._fn), tuple(xs), strict=False)
            call = exported.module()
        except Exception as e:
            if is_device_fault(e):
                raise
            return self._refused(sigs, key, time.perf_counter() - t0)
        trace_seconds = time.perf_counter() - t0
        self._traced += 1
        self._ledger.record("trace", key=key, label=self._label, kind="segment",
                            inputs=len(sigs), seconds=trace_seconds)
        t1 = time.perf_counter()
        payload = b""
        try:
            buf = io.BytesIO()
            torch.export.save(_without_example_inputs(exported), buf)
            payload = buf.getvalue()
            self._cache.store(key, payload, {
                "env": env,
                "segment": self._digest,
                "inputs": [[list(s), d] for s, d in sigs],
                "label": self._label,
                "trace_seconds": round(trace_seconds, 4),
                "created_unix": time.time(),
            })
            _manifest.record_segment(self._cache, self._digest, sigs)
        except Exception as e:
            if is_device_fault(e):
                raise
            logger.warning("segment: could not persist %s — the program still runs live",
                           self._label or key, exc_info=True)
            payload = b""
        save_seconds = time.perf_counter() - t1
        if payload:
            self._ledger.record("export", key=key, label=self._label, kind="segment",
                                inputs=len(sigs), nbytes=len(payload), seconds=trace_seconds,
                                save_seconds=save_seconds)
        if tracer is not None:
            tracer.instant("aot.export", op_type="SegmentDispatcher", key=key, label=self._label,
                           inputs=len(sigs), bytes=len(payload),
                           trace_seconds=round(trace_seconds, 4),
                           save_seconds=round(save_seconds, 4))
        seg_cost.record_compile(self._digest, trace_seconds, exported=bool(payload),
                                n_nodes=self._n_nodes)
        return _Program(call)


# ---------------------------------------------------------------------------
# The process's dispatchers: one per (digest, cache root), so two executors
# pulling the same fitted graph share their programs instead of tracing
# again. A bounded LRU: digests churn across pipelines in a long process.
# ---------------------------------------------------------------------------

_DISPATCHERS: "OrderedDict[Tuple[str, Optional[str]], SegmentDispatcher]" = OrderedDict()
_MAX_DISPATCHERS = 128
_dispatchers_lock = threading.Lock()


def dispatcher_for(digest: Any, fn_factory: Callable[[], Callable], *, label: str = "",
                   n_nodes: int = 1, identity: Optional[tuple] = None) -> SegmentDispatcher:
    """The shared dispatcher of a segment against the cache configured now.
    ``digest`` is the segment's digest or a function that computes it.
    Without a cache, an ``identity`` (a binding's member operators and
    wiring) keys the dispatcher instead and the digest is never computed:
    bindings over the same operator objects share their programs. The cache
    is read at each call (it may be configured after a binding was made), so
    a binding must not keep the dispatcher it gets."""
    from . import get_cache

    cache = get_cache()
    if cache is None and identity is not None:
        name, key = None, (identity, None)
    else:
        name = digest() if callable(digest) else digest
        key = (name, cache.root if cache is not None else None)
    with _dispatchers_lock:
        disp = _DISPATCHERS.get(key)
        if disp is not None:
            _DISPATCHERS.move_to_end(key)
            return disp
        disp = SegmentDispatcher(fn_factory(), name, cache, label=label, n_nodes=n_nodes)
        _DISPATCHERS[key] = disp
        while len(_DISPATCHERS) > _MAX_DISPATCHERS:
            _DISPATCHERS.popitem(last=False)
        return disp


def reset_dispatchers() -> None:
    """Drop every dispatcher, with the programs, CUDA graphs and memory
    pools they hold."""
    with _dispatchers_lock:
        _DISPATCHERS.clear()


#: segment runs of this process by the path that served them
_PATH_RUNS: Counter = Counter()
_path_lock = threading.Lock()


def path_counts() -> Dict[str, int]:
    """How many segment runs each path (``compiled``, ``chunked``,
    ``fallback``) served since :func:`reset_path_counts`: the paths of a run
    read without a tracer."""
    with _path_lock:
        return dict(_PATH_RUNS)


def reset_path_counts() -> None:
    with _path_lock:
        _PATH_RUNS.clear()


# ---------------------------------------------------------------------------
# SegmentBinding: the executor's handle
# ---------------------------------------------------------------------------


def _dense(payload: Any) -> bool:
    """A tensor or a tuple of tensors (not sparse rows)."""
    if isinstance(payload, tuple):
        return bool(payload) and all(_dense(p) for p in payload)
    return isinstance(payload, torch.Tensor)


def _fake_nbytes(values: List[Any]) -> int:
    seen, total = set(), 0
    for t in leaves([v for v in values if v is not None]):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


class _Members:
    """What :func:`segment_fingerprint` reads of a graph and of a segment,
    kept by a binding: the members' operators and wiring and the segment's
    pinned ids, with no data leaf (a plan cached across applies must not
    hold the first apply's input)."""

    def __init__(self, graph: Any, segment: Any):
        self.inputs = list(segment.inputs)
        self.nodes = list(segment.nodes)
        self.outputs = list(segment.outputs)
        self._ops = {n: graph.get_operator(n) for n in self.nodes}
        self._deps = {n: list(graph.get_dependencies(n)) for n in self.nodes}

    def get_operator(self, n: Any) -> Any:
        return self._ops[n]

    def get_dependencies(self, n: Any) -> List[Any]:
        return self._deps[n]


class SegmentBinding:
    """One plannable segment, lowered and ready to dispatch.

    ``run(datasets)`` takes the materialized input datasets (positionally
    over the segment's pinned ``inputs``) and returns ``(outputs, path)``:
    one Dataset per segment output and the path that served them
    (``compiled``, ``chunked`` or ``fallback``). A Python-level failure
    demotes the binding for this process and runs the node semantics
    instead; a kernel or device fault propagates."""

    def __init__(self, *, index: int, members: _Members, input_ops: List[Any], fn: Callable,
                 steps: List[Step], out_slots: Tuple[int, ...], digest: Optional[str],
                 label: str, batch_coupled: bool, row_local: bool):
        self.index = index
        self.inputs = list(members.inputs)
        self.outputs = list(members.outputs)
        #: the member nodes, topologically ordered
        self.nodes = list(members.nodes)
        self._members = members
        #: each input's operator, None for a data leaf (a new one each apply)
        self._input_ops = input_ops
        self.fn = fn
        self.steps = steps
        self.out_slots = out_slots
        self._digest = digest
        #: the dispatcher key without a cache: the members' operators by
        #: identity and their wiring (the dispatcher's function holds them)
        self._identity = (tuple((id(op), slots) for op, slots in steps), out_slots,
                          len(self.inputs))
        self.label = label
        self.node_ids = [str(n.id) for n in self.nodes]
        self.batch_coupled = batch_coupled
        self.row_local = row_local
        self._demoted = False
        #: bytes a whole run holds at once (None: not reckonable), by signature
        self._whole_bytes: Dict[tuple, Optional[int]] = {}

    def __len__(self) -> int:
        return len(self.steps)

    @property
    def digest(self) -> str:
        """The segment's content digest (:func:`segment_fingerprint`),
        computed at its first use: a cache key or a cost record. It reads
        every member tensor back to the host, which a run with neither a
        cache nor a profile store never pays. Raises
        :class:`FingerprintError` when a member has no content-stable
        form."""
        if self._digest is None:
            self._digest = segment_fingerprint(self._members, self._members)
        return self._digest

    @digest.setter
    def digest(self, value: str) -> None:
        self._digest = value

    @property
    def known_digest(self) -> Optional[str]:
        """The digest if it was computed, else None (nothing is computed)."""
        return self._digest

    def holds_for(self, graph: Any) -> bool:
        """Whether this binding fits ``graph``, as a plan cached across
        applies must: the same member operators wired the same way, and each
        input the same operator, or a data leaf where this one had a data
        leaf."""
        from ..workflow.operators import DatasetOperator, DatumOperator

        ops = graph.operators
        for n in self.nodes:
            if ops.get(n) is not self._members.get_operator(n) or (
                    list(graph.get_dependencies(n)) != self._members.get_dependencies(n)):
                return False
        for d, op in zip(self.inputs, self._input_ops):
            cur = ops.get(d)
            if not (cur is op if op is not None
                    else isinstance(cur, (DatasetOperator, DatumOperator))):
                return False
        return True

    def _dispatcher(self) -> SegmentDispatcher:
        return dispatcher_for(lambda: self.digest, lambda: self.fn, label=self.label,
                              n_nodes=len(self.steps), identity=self._identity)

    def run(self, datasets: List[Any]) -> Tuple[Tuple[Any, ...], str]:
        if self._demoted:
            outs, path = self._fallback(datasets), "fallback"
        else:
            try:
                outs, path = self._run(datasets)
            except Exception as e:
                if is_device_fault(e):
                    raise
                self._demote(f"runtime failure: {e!r}")
                outs, path = self._fallback(datasets), "fallback"
        with _path_lock:
            _PATH_RUNS[path] += 1
        return outs, path

    def _run(self, datasets: List[Any]) -> Tuple[Tuple[Any, ...], str]:
        from ..data.chunked import align_and_zip
        from ..data.pipeline_scan import ChunkPadder

        if any(ds.is_chunked for ds in datasets):
            if self.batch_coupled or len(self.out_slots) != 1:
                # a batch-coupled member must see whole batches, and a
                # multi-output chunked segment would scan its source once an
                # output: node semantics handle both exactly
                return self._fallback(datasets), "fallback"
            disp = self._dispatcher()

            def per_chunk(*xs):
                # the next chunk replays what this one captures
                outs = self._on_arrays(disp, list(xs), chunk=True)
                if outs is None:
                    return self._fallback([Dataset(x) for x in xs])[0].to_array()
                return outs[0]

            if len(datasets) == 1:
                out = datasets[0].map_batch(ChunkPadder(per_chunk))
            else:
                out = align_and_zip(list(datasets)).map_batch(
                    ChunkPadder(lambda t: per_chunk(*t)))
            return (out,), "chunked"
        if datasets and all(ds.is_batched and _dense(ds.payload) for ds in datasets):
            from ..cost import get_store
            from ..cost import segments as seg_cost

            t0 = time.perf_counter()
            outs = self._on_arrays(self._dispatcher(), [ds.payload for ds in datasets])
            if outs is None:
                return self._fallback(datasets), "fallback"
            if get_store() is not None:
                seg_cost.record_run(self.digest, time.perf_counter() - t0,
                                    n_nodes=len(self.steps))
            return tuple(Dataset(o) for o in outs), "compiled"
        # item lists and sparse rows: per-node dispatch is the exact semantics
        return self._fallback(datasets), "fallback"

    def _on_arrays(self, disp: SegmentDispatcher, xs: List[Any], *,
                   chunk: bool = False) -> Optional[Tuple[Any, ...]]:
        """The segment on dense batched payloads, the caller's own outputs;
        None when it must take node dispatch (a whole run over budget).
        ``chunk``: ``xs`` is a scan's chunk, captured as its row chunks are."""
        from ..data.pipeline_scan import ChunkPadder
        from ..workflow.fusion import FusedTransformerOperator, forward_in_row_chunks

        counts = {int(first_leaf(x).shape[0]) for x in xs}
        n = counts.pop() if len(counts) == 1 else None
        if n == 0:
            return None
        if not disp.has_cache and len(self.steps) == 1 and isinstance(
                self.steps[0][0], FusedTransformerOperator):
            # a fused group alone: its own graphs, one per row-chunk
            # signature, are this segment's lowered function captured per
            # chunk signature, and node dispatch shares them
            op, slots = self.steps[0]
            return (op._transform_arrays([xs[s] for s in slots]),)
        rows = self._lead_chunk_rows(xs)
        if self.row_local and n is not None:
            if n > rows:
                def raw(*c):
                    return disp(*c, take=lambda out, static: out, capture=True)

                step = raw
                if disp.has_cache:
                    # a ragged tail pads up the bucket ladder: a bounded
                    # number of exported programs for any batch length
                    padder = ChunkPadder(lambda t: raw(*t))

                    def step(*c):
                        return padder(tuple(c))
                with disp.lock:
                    # each chunk's outputs are copied out before the next
                    # replay overwrites them
                    return forward_in_row_chunks(step, xs, n, rows)
        elif self.batch_coupled:
            whole = self._whole_bytes_of(xs)
            if whole is None or whole > WHOLE_BYTES:
                logger.info("segment %s (%s): %s bytes at once — node dispatch", self.index,
                            self.label, whole)
                return None
        return disp(*xs, capture=chunk)

    def _lead_chunk_rows(self, xs: List[Any]) -> int:
        """Rows a chunk of this segment: the fewest that a member reading
        only segment inputs would chunk those inputs into on its own (a
        fused group's measured rows, a row-local node's ``_forward_rows``
        rows), so the leading members chunk as under node dispatch, at most
        ``ROW_CHUNK``. Measuring a fused group here also lets an export,
        which traces on fake tensors where nothing is measured, keep the
        group's row chunks. No member's ``forward`` runs."""
        from ..workflow.fusion import (
            ROW_CHUNK,
            FusedTransformerOperator,
            chunk_rows,
            payload_bytes,
        )

        rows = ROW_CHUNK
        n_in = len(xs)
        for op, slots in self.steps:
            if not all(s < n_in for s in slots):
                continue
            args = [xs[s] for s in slots]
            if isinstance(op, FusedTransformerOperator):
                with torch.no_grad():
                    rows = min(rows, op.chunk_rows(args))
            elif getattr(op, "row_local", False) and len(args) == 1:
                one = map_leaves(lambda t: t[0:1], args[0])
                work = getattr(op, "row_work_bytes", None)
                rows = min(rows, chunk_rows(payload_bytes([one]) + (work(one) if work else 0)))
        return max(1, rows)

    def _whole_bytes_of(self, xs: List[Any]) -> Optional[int]:
        """The most bytes a whole run holds at once (the inputs and the
        member outputs alive together), reckoned on fake tensors: nothing
        runs and nothing is allocated. None when a member needs concrete
        values."""
        from ..check.abstract import _abstract_only, _concretization_errors, _fake_mode

        sig = signature(tuple(xs))
        if sig in self._whole_bytes:
            return self._whole_bytes[sig]
        last_use: Dict[int, int] = {}
        for k, (_, slots) in enumerate(self.steps):
            for s in slots:
                last_use[s] = k
        fm = _fake_mode()
        try:
            with fm, _abstract_only(fm), torch.no_grad():
                values: List[Any] = [map_leaves(fm.from_tensor, x) for x in xs]
                peak = _fake_nbytes(values)
                for k, (op, slots) in enumerate(self.steps):
                    values.append(_call(op, [values[s] for s in slots]))
                    peak = max(peak, _fake_nbytes(values))
                    for s in slots:
                        if last_use[s] == k and s not in self.out_slots:
                            values[s] = None
        except _concretization_errors():
            peak = None
        self._whole_bytes[sig] = peak
        return peak

    def _fallback(self, datasets: List[Any]) -> Tuple[Any, ...]:
        """Exact node semantics: the same operators in the same topological
        order, through the ``execute`` the node executor would have run."""
        from ..workflow.expressions import DatasetExpression

        values: List[Any] = list(datasets)
        for op, slots in self.steps:
            deps = [DatasetExpression.now(values[s]) for s in slots]
            values.append(op.execute(deps).get())
        return tuple(values[s] for s in self.out_slots)

    def _demote(self, why: str) -> None:
        if self._demoted:
            return
        self._demoted = True
        logger.warning("segment %s (%s): %s — demoted to node dispatch", self.index,
                       self.label, why, exc_info=True)
        from ..cost import get_store
        from ..cost import segments as seg_cost

        if get_store() is not None and self._digest is not None:
            seg_cost.record_failure(self._digest, why="runtime")


def bind_segment(graph: Any, segment: Any, *,
                 annotations: Optional[Dict[Any, str]] = None) -> Optional[SegmentBinding]:
    """Lower ``segment`` into a dispatchable binding, or None when it is not
    worth or not safe to dispatch as one:

    * empty, or a single node that is not a fused group (one plain node
      gains nothing over its node thunk; a single fused group is eligible,
      which is how a fit graph's featurizer gets exported whole);
    * a member annotated for the pipeline environment whose value would
      not leave the segment (an annotated interior must materialize);
    * a member with no ``forward`` (the planner's lattice has barriered
      these already);
    * an input that depends on one of the members through a barrier (the
      group is not convex: not one compilation unit);
    * with a cache or a profile store configured, the segment's fingerprint
      cannot be computed (operator state with no content-stable form), or
      the cost model demoted its digest (compile cost above the observed
      dispatch savings). With neither, the digest is left to the first
      use that needs it (:attr:`SegmentBinding.digest`)."""
    from . import get_cache
    from ..cost import get_store
    from ..cost import segments as seg_cost
    from ..workflow.fusion import FusedTransformerOperator
    from ..workflow.graph import NodeId
    from ..workflow.operators import TransformerOperator

    members = list(segment.nodes)
    if not members:
        return None
    ops = []
    for n in members:
        op = graph.get_operator(n)
        if not isinstance(op, TransformerOperator) or not callable(getattr(op, "forward", None)):
            return None
        ops.append(op)
    if len(members) == 1 and not isinstance(ops[0], FusedTransformerOperator):
        return None
    out_set = set(segment.outputs)
    if annotations:
        for n in members:
            if n in annotations and n not in out_set:
                return None
    if not all(isinstance(d, NodeId) for d in segment.inputs):
        return None
    mset = set(members)
    stack: List[Any] = []
    for d in segment.inputs:
        stack.extend(graph.get_dependencies(d))
    seen = set()
    while stack:
        a = stack.pop()
        if a in seen:
            continue
        seen.add(a)
        if a in mset:
            return None
        if isinstance(a, NodeId) and a in graph.operators:
            stack.extend(graph.get_dependencies(a))
    view = _Members(graph, segment)
    digest = None
    if get_cache() is not None or get_store() is not None:
        try:
            digest = segment_fingerprint(view, view)
        except FingerprintError:
            logger.debug("segment %s: unfingerprintable — node dispatch", segment.index,
                         exc_info=True)
            return None
        if not seg_cost.should_compile(digest, len(members)):
            logger.info("segment %s: demoted by the cost model — node dispatch", segment.index)
            return None
    from ..workflow.operators import DatasetOperator, DatumOperator

    input_ops = [None if isinstance(op, (DatasetOperator, DatumOperator)) else op
                 for op in (graph.get_operator(d) for d in segment.inputs)]
    fn, steps, out_slots = lower_segment(graph, segment)
    label = "+".join(op.label for op in ops)
    if len(label) > 96:
        label = label[:93] + "..."
    return SegmentBinding(
        index=segment.index, members=view, input_ops=input_ops, fn=fn, steps=steps,
        out_slots=out_slots, digest=digest, label=label,
        batch_coupled=any(bool(getattr(op, "batch_coupled", False)) for op in ops),
        row_local=all(bool(getattr(op, "row_local", False)) for op in ops),
    )


# ---------------------------------------------------------------------------
# Warm boot: load and run once every segment program the manifest indexes
# ---------------------------------------------------------------------------


def prewarm_segment_artifacts(cache: ExecutableCache, *, limit: int = 64,
                              max_elements: int = 1 << 22, device: Any = None) -> int:
    """Load and run once, on zeros, every segment program the manifest
    indexes (its kernels built, its libraries' plans made), so a fit after
    a warm boot finds them ready. Returns the number warmed. A signature
    whose inputs hold more than ``max_elements`` elements is skipped with a
    log line, as are a missing, evicted or foreign entry and a program that
    fails in Python; a device fault propagates. ``device`` is where the
    programs run: the card when there is one."""
    from . import manifest as _manifest

    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    env = environment_key(device)
    warmed = 0
    for digest in _manifest.segment_digests(cache):
        for sigs in _manifest.segment_signatures(cache, digest):
            if warmed >= limit:
                break
            elements = sum(int(torch.Size(shape).numel()) for shape, _ in sigs)
            if elements > max_elements:
                logger.info("segment prewarm: skipping %s (%d elements over the budget of %d)",
                            digest[:16], elements, max_elements)
                continue
            try:
                entry = cache.load(segment_entry_key(digest, sigs, env), expect_env=env)
                if entry is None:
                    continue
                call = _load_program(entry.payload)
                with torch.no_grad():
                    call(*[torch.zeros(shape, dtype=getattr(torch, dtype), device=device)
                           for shape, dtype in sigs])
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
                warmed += 1
            except Exception as e:
                if is_device_fault(e):
                    raise
                logger.warning("segment prewarm: could not warm %s — skipped", digest[:16],
                               exc_info=True)
    if warmed:
        logger.info("segment prewarm: %d program(s) warmed", warmed)
    return warmed
