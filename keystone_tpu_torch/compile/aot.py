"""AOT compilation of fitted pipelines: load a saved program, or export once
and save it for every later process (port of ``keystone_tpu/compile/aot.py``).

:class:`AotDispatcher` is the per-shape compile engine that
``FittedPipeline.compile`` and the serving engine's private chain use when
an executable cache is configured. For each distinct input signature
``(shape, dtype)`` it resolves a callable exactly once:

* **hit** — the cache holds a ``torch.export`` program for (pipeline
  fingerprint, signature, environment): ``torch.export.load`` it and run
  its ``.module()``. ZERO calls of the pipeline's trace function in this
  process. The program's graph names every operator it runs, K1 as the
  ``keystone.gaussian_kernel_block`` custom op, and carries the chain's
  tensors as lifted constants. Those load onto the device they were saved
  from; the dispatcher moves them, and the device the graph names, onto
  its own device, so one entry (two equal cards have one environment key)
  serves a replica on either card.
* **miss** — ``torch.export.export`` the trace function ONCE (the
  trace-count hook fires here), save the program into the cache, and run
  the very same exported program. Cold and warm boots therefore run one
  graph on equal constants, so their answers are bit-equal by
  construction.
* **export refused** (data-dependent code, an operator with no fake
  implementation, a save failure) — serve the plain trace function; the
  first refusal is logged with its traceback.

On CUDA the caller captures one CUDA graph per signature over the callable
this returns (a CUDA graph cannot be serialized, so a warm boot loads each
program and captures it again).

Tracer instants (when a tracer is installed): ``aot.load`` (bytes,
seconds_saved = the producer's measured export cost), ``aot.miss`` and
``aot.export`` (bytes, trace_seconds): a trace of a warm boot shows loads
and no exports; a cold boot shows the misses it paid.
"""

from __future__ import annotations

import io
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..obs.ledger import CompileLedger
from ..obs.tracer import current as _trace_current
from ..parallel.mesh import physical
from ..workflow.cuda_graph import dtype_name
from .cache import ExecutableCache
from .fingerprint import entry_key, environment_key

logger = logging.getLogger(__name__)

#: input signature: (shape tuple, numpy's dtype name, ``'float32'``)
Signature = Tuple[Tuple[int, ...], str]


def signature_of(x: Any) -> Signature:
    return (tuple(int(d) for d in x.shape), dtype_name(x.dtype))


class _Program(torch.nn.Module):
    """The trace function as the module ``torch.export`` takes; the chain's
    tensors are reached through its closures and become lifted constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _load_program(payload: bytes) -> Callable:
    """A saved program's callable. The port's custom operators are
    registered first, so that a fresh process can resolve them."""
    from .. import ops  # noqa: F401  (registers keystone::gaussian_kernel_block)

    return torch.export.load(io.BytesIO(payload)).module()


def _place_program(module: torch.nn.Module, device: Optional[torch.device]) -> torch.nn.Module:
    """A loaded program's constants (and the tensors its graph makes on
    their device) on ``device``. A program saved on one card loads its
    constants onto that card; a replica on another card of the same kind
    shares the entry and runs it on its own."""
    if device is None:
        return module
    held = [(mod, name, t) for mod in module.modules()
            for name, t in list(vars(mod).items()) + list(mod._buffers.items())
            if isinstance(t, torch.Tensor)]
    saved = {t.device for _, _, t in held} - {device}
    if not saved:
        return module
    moved: Dict[int, torch.Tensor] = {}
    for mod, name, t in held:
        if t.device == device:
            continue
        if id(t) not in moved:
            moved[id(t)] = t.to(device)
        if name in mod._buffers:
            mod._buffers[name] = moved[id(t)]
        else:
            setattr(mod, name, moved[id(t)])
    for mod in module.modules():
        graph = getattr(mod, "graph", None)
        if not isinstance(graph, torch.fx.Graph):
            continue
        changed = False
        for node in graph.nodes:
            if node.kwargs.get("device") in saved:
                node.kwargs = {**node.kwargs, "device": device}
                changed = True
        if changed:
            mod.recompile()
    return module


def _without_example_inputs(exported: Any) -> Any:
    """``exported`` with no example inputs to save: a row chunk is a view,
    and saving it would write its whole base tensor into the entry."""
    try:
        exported.example_inputs = None
    except (AttributeError, TypeError, ValueError):
        logger.debug("aot: example inputs kept in the saved program", exc_info=True)
    return exported


class AotDispatcher:
    """Resolves one callable per input signature, cache-first.

    ``fn`` is the pure stacked-tensor pipeline function
    (``FittedPipeline._build_trace_fn()``). ``on_trace(sig)`` fires once per
    export actually paid (the compile-accounting hook); ``on_load(sig)``
    fires once per program loaded instead. ``device`` is where the chain's
    parameters live, which keys the environment and is where a loaded
    program's constants are placed. Thread-safe: the serving
    engine's caller thread warms buckets while the worker thread may
    resolve a late signature.
    """

    def __init__(
        self,
        fn: Callable,
        fingerprint_digest: str,
        cache: ExecutableCache,
        *,
        on_trace: Optional[Callable[[Signature], None]] = None,
        on_load: Optional[Callable[[Signature], None]] = None,
        label: str = "",
        expected_exportable: Optional[bool] = None,
        device: Any = None,
    ):
        self._fn = fn
        self._digest = fingerprint_digest
        self._cache = cache
        self._on_trace = on_trace
        self._on_load = on_load
        self._label = label
        #: the static checker's export verdict, when the caller ran one:
        #: the dynamic path is held against it
        self._expected_exportable = expected_exportable
        self._env = environment_key(device)
        self._device = None if device is None else physical(device)
        self._by_sig: Dict[Signature, Callable] = {}
        self._lock = threading.Lock()
        self._loaded = 0
        self._traced = 0
        self._refusal_logged = False
        self._ledger = CompileLedger.for_cache_root(cache.root)

    # -- introspection --------------------------------------------------

    @property
    def digest(self) -> str:
        """The pipeline's content fingerprint: the model identity the
        serving fleet publishes with each version."""
        return self._digest

    @property
    def loaded_count(self) -> int:
        """Signatures resolved from the cache (zero traces paid)."""
        return self._loaded

    @property
    def traced_count(self) -> int:
        """Signatures that paid a live trace of the pipeline function."""
        return self._traced

    # -- the hot path ---------------------------------------------------

    def __call__(self, x):
        sig = signature_of(x)
        call = self._by_sig.get(sig)
        if call is None:
            call = self._resolve(sig, x)
        return call(x)

    # -- resolution -----------------------------------------------------

    def _resolve(self, sig: Signature, x) -> Callable:
        with self._lock:
            call = self._by_sig.get(sig)
            if call is not None:
                return call
            call = self._load(sig)
            if call is None:
                call = self._trace_and_export(sig, x)
            self._by_sig[sig] = call
            return call

    def _load(self, sig: Signature) -> Optional[Callable]:
        key = entry_key(self._digest, sig[0], sig[1], self._env)
        t0 = time.perf_counter()
        entry = self._cache.load(key, expect_env=self._env)
        if entry is None:
            return None
        try:
            call = _place_program(_load_program(entry.payload), self._device)
        except Exception:
            logger.warning(
                "aot: unloadable entry for %s %s — falling back to a live "
                "export", self._label or key, sig, exc_info=True,
            )
            self._cache._discard(entry.path, "unloadable")
            return None
        self._loaded += 1
        load_seconds = time.perf_counter() - t0
        self._ledger.record(
            "load",
            key=key,
            label=self._label,
            shape=list(sig[0]),
            dtype=sig[1],
            nbytes=entry.nbytes,
            seconds=load_seconds,
            saved_s=entry.header.get("trace_seconds"),
        )
        tracer = _trace_current()
        if tracer is not None:
            tracer.instant(
                "aot.load",
                op_type="AotDispatcher",
                key=key,
                label=self._label,
                shape=list(sig[0]),
                dtype=sig[1],
                bytes=entry.nbytes,
                load_seconds=round(load_seconds, 4),
                seconds_saved=entry.header.get("trace_seconds"),
            )
        logger.info(
            "aot: loaded %s %s from cache (%d bytes, saved ~%ss of tracing)",
            self._label or key, sig, entry.nbytes,
            entry.header.get("trace_seconds", "?"),
        )
        if self._on_load is not None:
            self._on_load(sig)
        return call

    def _refused(self, sig: Signature, key: str, fired: list) -> Callable:
        """Export failed: serve the plain trace function, counted as the
        one trace this signature pays."""
        if not self._refusal_logged:
            self._refusal_logged = True
            logger.warning(
                "aot: export failed for %s %s — serving the plain trace "
                "function (no cross-process caching for this pipeline)",
                self._label or key, sig, exc_info=True,
            )
        else:
            logger.info("aot: export failed for %s %s", self._label or key, sig)
        if self._expected_exportable:
            # the checker's lattice said this chain exports: a verdict bug,
            # made loud so the classifier gets fixed, not papered over
            logger.error(
                "aot: STATIC CHECK DISAGREEMENT — the traceability lattice "
                "classified %s as exportable but torch.export refused it; "
                "report this pipeline's node set", self._label or key,
            )
        self._traced += 1
        if not fired and self._on_trace is not None:
            self._on_trace(sig)
        return self._fn

    def _trace_and_export(self, sig: Signature, x) -> Callable:
        tracer = _trace_current()
        key = entry_key(self._digest, sig[0], sig[1], self._env)
        if tracer is not None:
            tracer.instant(
                "aot.miss", op_type="AotDispatcher", key=key,
                label=self._label, shape=list(sig[0]), dtype=sig[1],
            )
        fired = []

        def traced(v):
            # runs only under torch.export's trace: once per export paid
            fired.append(sig)
            if self._on_trace is not None and len(fired) == 1:
                self._on_trace(sig)
            return self._fn(v)

        t0 = time.perf_counter()
        try:
            exported = torch.export.export(_Program(traced), (x,), strict=False)
            call = exported.module()
        except Exception:
            return self._refused(sig, key, fired)
        trace_seconds = time.perf_counter() - t0
        self._traced += 1
        self._ledger.record(
            "trace",
            key=key,
            label=self._label,
            shape=list(sig[0]),
            dtype=sig[1],
            seconds=trace_seconds,
        )
        t1 = time.perf_counter()
        payload = b""
        try:
            buf = io.BytesIO()
            torch.export.save(_without_example_inputs(exported), buf)
            payload = buf.getvalue()
            self._cache.store(
                key,
                payload,
                {
                    "env": self._env,
                    "pipeline": self._digest,
                    "shape": list(sig[0]),
                    "dtype": sig[1],
                    "label": self._label,
                    "trace_seconds": round(trace_seconds, 4),
                    "created_unix": time.time(),
                },
            )
            # index the export in the bucket-signature manifest, so a fresh
            # replica can learn every signature this pipeline serves
            from . import manifest as _manifest

            _manifest.record_export(self._cache, self._digest, sig[0], sig[1])
        except Exception:
            logger.warning(
                "aot: could not persist %s %s — the program still serves "
                "live", self._label or key, sig, exc_info=True,
            )
            payload = b""
        save_seconds = time.perf_counter() - t1
        if payload:
            self._ledger.record(
                "export",
                key=key,
                label=self._label,
                shape=list(sig[0]),
                dtype=sig[1],
                nbytes=len(payload),
                seconds=trace_seconds,
                save_seconds=save_seconds,
            )
        if tracer is not None:
            tracer.instant(
                "aot.export",
                op_type="AotDispatcher",
                key=key,
                label=self._label,
                shape=list(sig[0]),
                dtype=sig[1],
                bytes=len(payload),
                trace_seconds=round(trace_seconds, 4),
                save_seconds=round(save_seconds, 4),
            )
        return call
