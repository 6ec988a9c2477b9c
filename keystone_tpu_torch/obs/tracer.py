"""The tracer: thread-safe span collection with a process-global switch
(port of ``keystone_tpu/obs/tracer.py``).

Every DAG node pull, auto-cache decision and cost-model choice lands in
one span registry, exportable as Chrome-trace JSON (``obs/export.py``) and
audited against the cache planner's estimates (``obs/audit.py``).

Overhead: tracing is off unless a tracer is installed. :func:`current`
returns None and every instrumentation site is one ``is None`` check with
no span allocated. Installed, a span costs one dataclass and two clock
reads, plus a wait for the card at exit where the span asks for one (that
is the point: device time charged to the span that queued it).

Compiles: the JAX package counts XLA backend compiles through
``jax.monitoring``. The port's counterpart is a CUDA-graph capture
(``workflow/cuda_graph.py`` calls :func:`count_compile`), counted into
``Span.compiles`` under the JAX field's name.

Wiring: ``utils/obs.configure`` installs the global tracer from
``KEYSTONE_TRACE=path`` (or the CLI's ``--trace PATH``) and registers an
export at exit; library code only calls :func:`current`.

``torch.profiler``: while the profiler records, every span and instant
is also a ``record_function`` range of its name on the calling thread,
so it lands in the profiler's Chrome trace as a ``user_annotation`` on
the kernels' clock. :func:`layer` marks an application's layer
boundaries (the checker, a fit's phases, filter learning, scoring) for
both: a span under a tracer, a profiler range while the profiler
records, and nothing (two flag reads, no ``record_function``, no
``Span``) when neither is on; ``benchmark/spans.py`` reads its ranges
in a traced window. Entering a ``record_function`` costs microseconds
even with no profiler running, so each site reads the profiler's flag
first.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import logging
import threading
import time
from typing import ContextManager, Dict, Iterator, List, Optional

from torch.autograd import profiler as _profiler

from .span import Span, cheap_nbytes, sync_value

logger = logging.getLogger(__name__)

# -- compile (CUDA-graph capture) counting ----------------------------------

_compiles_lock = threading.Lock()
_compiles_seen = 0


def count_compile(n: int = 1) -> None:
    """Record ``n`` compiles (CUDA-graph captures) in the process."""
    global _compiles_seen
    with _compiles_lock:
        _compiles_seen += n


def _compile_count() -> int:
    return _compiles_seen


# -- torch.profiler mirror ---------------------------------------------------

_OFF = contextlib.nullcontext()


def _profiler_range(name: str) -> ContextManager:
    """A ``record_function`` range named ``name`` while ``torch.profiler``
    records, else a shared no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


# -- the tracer -------------------------------------------------------------


class Tracer:
    """Collects a span tree per thread; safe for concurrent writers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()
        #: node_id -> estimate row recorded by a planner (obs/audit.py)
        self._estimates: Dict[str, dict] = {}
        #: bumped at each optimizer pass: NodeIds are small per-graph ints,
        #: so a long-lived tracer must not merge a new pass's estimate for
        #: id "3" into an earlier pipeline's row
        self._plan_epoch = 0
        #: spans discarded below ``_spans[0]`` (:meth:`discard_through`):
        #: cursors of :meth:`spans_since` stay global indices across it
        self._span_offset = 0

    # -- span recording -------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_span(self) -> Optional[Span]:
        """This thread's innermost open span, or None. The concurrent
        executor hands it to its workers as their parent."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def adopt(self, parent: Optional[Span]) -> Iterator[None]:
        """Make ``parent``, a span opened on another thread, the current
        parent on this thread, so that a scheduler worker's node spans
        nest under the pull that armed it. ``parent`` is pushed, never
        recorded here: its opener owns its exit."""
        if parent is None:
            yield
            return
        stack = self._stack()
        stack.append(parent)
        try:
            yield
        finally:
            stack.pop()

    @contextlib.contextmanager
    def span(self, name: str, *, node_id: Optional[str] = None,
             op_type: Optional[str] = None, cache: Optional[str] = None,
             **attrs) -> Iterator[Span]:
        """Open a span; the yielded handle takes extra attrs and an
        optional ``sync_on(value)`` target waited for at exit."""
        stack = self._stack()
        thread = threading.current_thread()
        sp = Span(
            name=name,
            start=time.perf_counter(),
            span_id=next(self._ids),
            parent_id=stack[-1].span_id if stack else None,
            depth=len(stack),
            tid=thread.ident or 0,
            thread_name=thread.name,
            node_id=node_id,
            op_type=op_type,
            cache=cache,
            attrs=dict(attrs),
        )
        compiles_at_start = _compile_count()
        with _profiler_range(name):
            stack.append(sp)
            try:
                yield sp
            finally:
                stack.pop()
                target = sp.sync_target
                if target is not None:
                    sp.sync_target = None
                    t0 = time.perf_counter()
                    if sync_value(target):
                        sp.sync_seconds = time.perf_counter() - t0
                    if sp.output_bytes is None:
                        sp.output_bytes = cheap_nbytes(target)
                sp.end = time.perf_counter()
                sp.compiles = _compile_count() - compiles_at_start
                with self._lock:
                    self._spans.append(sp)

    def instant(self, name: str, *, node_id: Optional[str] = None,
                op_type: Optional[str] = None, cache: Optional[str] = None,
                **attrs) -> Span:
        """A zero-duration event (a memoized result returned)."""
        stack = self._stack()
        thread = threading.current_thread()
        now = time.perf_counter()
        sp = Span(
            name=name,
            start=now,
            end=now,
            span_id=next(self._ids),
            parent_id=stack[-1].span_id if stack else None,
            depth=len(stack),
            tid=thread.ident or 0,
            thread_name=thread.name,
            node_id=node_id,
            op_type=op_type,
            cache=cache,
            instant=True,
            attrs=dict(attrs),
        )
        with _profiler_range(name):
            pass
        with self._lock:
            self._spans.append(sp)
        return sp

    def record_complete(self, sp: Span) -> None:
        """Append a finished span built elsewhere (an eager leaf, a scan).
        Its identity and tree position come from the calling thread's open
        span, if any."""
        stack = self._stack()
        thread = threading.current_thread()
        sp.span_id = next(self._ids)
        if sp.parent_id is None and stack:
            sp.parent_id = stack[-1].span_id
            sp.depth = len(stack)
        sp.tid = thread.ident or 0
        sp.thread_name = thread.name
        with self._lock:
            self._spans.append(sp)

    # -- reads ----------------------------------------------------------

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def spans_since(self, cursor: int):
        """``(spans[cursor:], new_cursor)``: the incremental read a cluster
        worker ships each span back to the router with, exactly once.
        Cursors are global indices, valid across :meth:`discard_through`."""
        with self._lock:
            n = self._span_offset + len(self._spans)
            start = max(cursor - self._span_offset, 0)
            return self._spans[start:], n

    def discard_through(self, cursor: int) -> int:
        """Drop the spans below global index ``cursor`` (shipped to another
        process, which owns them now), so an always-on traced worker stays
        bounded. Returns the count dropped; local reads see only what is
        left."""
        with self._lock:
            k = min(max(cursor - self._span_offset, 0), len(self._spans))
            if k:
                del self._spans[:k]
                self._span_offset += k
            return k

    def span_summary(self, prefix: Optional[str] = None) -> Dict[str, Dict[str, object]]:
        """``{name: {"seconds", "calls", ...}}``, the shape of
        ``utils.timing.snapshot``; ``prefix`` keeps one subsystem's spans."""
        agg: Dict[str, dict] = {}
        for sp in self.spans():
            if prefix is not None and not sp.name.startswith(prefix):
                continue
            row = agg.setdefault(sp.name, {
                "seconds": 0.0, "calls": 0, "sync_seconds": 0.0, "bytes": 0,
                "compiles": 0, "cache_hits": 0, "cache_misses": 0,
            })
            row["calls"] += 1
            if sp.cache == "hit":
                row["cache_hits"] += 1
                continue
            if sp.cache == "miss":
                row["cache_misses"] += 1
            row["seconds"] += sp.seconds
            row["sync_seconds"] += sp.sync_seconds
            row["compiles"] += sp.compiles
            if sp.output_bytes:
                row["bytes"] = max(row["bytes"], sp.output_bytes)
        for row in agg.values():
            row["seconds"] = round(row["seconds"], 4)
            row["sync_seconds"] = round(row["sync_seconds"], 4)
        return dict(sorted(agg.items()))

    # -- planner estimates (obs/audit.py) -------------------------------

    def record_node_estimate(self, node_id: str, label: str,
                             est_seconds: Optional[float] = None,
                             est_bytes: Optional[float] = None,
                             cacher: bool = False, **extras) -> None:
        """Record one planner estimate for a DAG node. ``extras`` (the
        solver chooser's ``kind="solver"``, its choice, pricing ``source``
        and ``alternatives``) reach the audit rows as given. Within one
        planning pass a later record of the same node overwrites the named
        fields and keeps the others; a row from an earlier pass is
        replaced whole."""
        with self._lock:
            row = self._estimates.get(str(node_id), {})
            if row.get("_epoch") != self._plan_epoch:
                row = {}
            row.update({
                "label": label, "est_seconds": est_seconds, "est_bytes": est_bytes,
                "cacher": bool(cacher), "_epoch": self._plan_epoch, **extras,
            })
            self._estimates[str(node_id)] = row

    def begin_plan_epoch(self) -> None:
        """Mark the start of an optimizer pass (see record_node_estimate)."""
        with self._lock:
            self._plan_epoch += 1

    @property
    def estimates(self) -> Dict[str, dict]:
        with self._lock:
            return {k: {kk: vv for kk, vv in row.items() if kk != "_epoch"}
                    for k, row in self._estimates.items()}


# -- process-global wiring --------------------------------------------------

_current: Optional[Tracer] = None
_export_path: Optional[str] = None
_atexit_registered = False
#: spans already written by an explicit export: the exit backstop skips
#: the rewrite when nothing new was recorded since
_exported_span_count: Optional[int] = None
_suspend = threading.local()
_install_lock = threading.Lock()


def current() -> Optional[Tracer]:
    """The installed tracer, or None (tracing off: the fast path). None on
    this thread inside a :func:`suspended` block."""
    if getattr(_suspend, "depth", 0):
        return None
    return _current


def layer(name: str, **attrs) -> ContextManager:
    """A layer boundary around a block, on the calling thread: a span named
    ``name`` with ``attrs`` under the installed tracer (never waited for at
    exit: the sites sit on their layer's own synchronization points), a
    ``torch.profiler`` range while the profiler records, both when both
    are on, and a shared no-op when neither is. What the block is handed
    is not part of the contract."""
    # ``_current`` first: ``current()``'s suspension lookup costs about a
    # microsecond on a thread that never suspended tracing
    tracer = current() if _current is not None else None
    if tracer is not None:
        return tracer.span(name, **attrs)
    return _profiler_range(name)


def install(tracer: Tracer) -> Tracer:
    global _current
    _current = tracer
    return tracer


def install_if_absent(tracer: Tracer) -> Optional[Tracer]:
    """Install ``tracer`` only if none is installed; returns it if it was
    installed, None if another tracer holds the slot. Concurrent fits that
    each want a fit-local tracer race here, and exactly one wins."""
    global _current
    with _install_lock:
        if _current is not None:
            return None
        _current = tracer
        return tracer


def uninstall(tracer: Tracer) -> bool:
    """Remove ``tracer`` only if it is still the installed one; returns
    whether it was removed (never tears down a later tracer)."""
    global _current
    with _install_lock:
        if _current is not tracer:
            return False
        _current = None
        return True


def start(path: Optional[str] = None) -> Tracer:
    """Install a process tracer, keeping one already installed. ``path``
    arms the Chrome-trace export at exit."""
    global _current, _export_path, _atexit_registered
    if _current is None:
        _current = Tracer()
    if path:
        _export_path = path
        if not _atexit_registered:
            _atexit_registered = True
            atexit.register(_atexit_export)
    return _current


def stop() -> Optional[Tracer]:
    """Uninstall and return the tracer (its spans stay readable)."""
    global _current
    tracer, _current = _current, None
    return tracer


def reset() -> None:
    """Drop the installed tracer and the export path."""
    global _current, _export_path, _exported_span_count
    _current = None
    _export_path = None
    _exported_span_count = None


@contextlib.contextmanager
def suspended() -> Iterator[None]:
    """Turn tracing off on this thread for the block: the auto-cache
    profiler's sampled pulls run a truncated graph whose node ids collide
    with the real one's, and must not reach its trace."""
    _suspend.depth = getattr(_suspend, "depth", 0) + 1
    try:
        yield
    finally:
        _suspend.depth -= 1


def _atexit_export() -> None:
    if _current is None:
        return
    if _exported_span_count == len(_current.spans()):
        return
    export()


def export(path: Optional[str] = None) -> Optional[str]:
    """Write the installed tracer's Chrome trace to ``path`` (or the path
    :func:`start` armed), and log the top spans and the cache audit.
    Returns the path, or None when tracing is off or no path is set. An
    IO failure logs a warning."""
    global _exported_span_count
    tracer = _current
    path = path or _export_path
    if tracer is None or path is None:
        return None
    _exported_span_count = len(tracer.spans())
    from .audit import log_cache_audit
    from .export import format_top_spans, write_chrome_trace

    try:
        write_chrome_trace(tracer, path)
    except OSError:
        logger.warning("trace export to %s failed", path, exc_info=True)
        return None
    logger.info("trace: %d spans -> %s\n%s", len(tracer.spans()), path,
                format_top_spans(tracer))
    log_cache_audit(tracer)
    return path
