"""Canonical, process-stable fingerprinting of fitted pipelines (port of
``keystone_tpu/compile/fingerprint.py``).

The AOT executable cache (``compile/cache.py``) keys entries by *what the
compiled program computes*, and a wrong key is silent model corruption:
two different fitted pipelines colliding would serve one model's
executable for the other. So the fingerprint here is a content digest of
everything that determines the traced program:

* **graph topology** — nodes relabeled to their topological-linearization
  index (so the digest is invariant to the arbitrary integer ids graph
  splicing assigns) plus each node's dependency edges and the sink edge;
* **operator identities** — fully-qualified class names;
* **fitted parameters** — every attribute of every operator, canonicalized
  by content: scalars/strings verbatim, numpy arrays and torch tensors as
  shape+dtype+sha256-of-bytes (a tensor's bytes are those of its host
  copy, wherever it lives), ``torch.device`` and ``torch.dtype`` by their
  names, containers recursively, nested operators (the optimizer's
  ``FusedTransformerOperator`` holds its steps as state) recursively,
  plain Python functions as code+constants+closure digests.

Anything whose content cannot be proven stable across processes (bound
native objects, a ``torch.Generator``, lazy datasets) raises
:class:`FingerprintError` — the caller falls back to a live compile
rather than risking a bogus cache key. Derived/memo state a class
declares in ``aot_fingerprint_exclude`` (e.g. the CUDA graphs of
``FusedTransformerOperator._graphs``) is skipped: a warm operator must
fingerprint identically to a fresh one.

The digest is pure content — no ``hash()`` (PYTHONHASHSEED), no ``id()``,
no ``repr`` of objects — so it is stable across processes and machines,
which is what lets a serving replica boot from executables another
process exported. Environment compatibility (torch and CUDA versions,
backend, device name and capability) is deliberately NOT part of the
pipeline fingerprint; :func:`environment_key` captures it separately so the cache
can report "same pipeline, stale toolchain" distinctly from a plain miss.
"""

from __future__ import annotations

import hashlib
import types
from typing import Any, Dict, Optional, Tuple

import torch

FORMAT_VERSION = 1


class FingerprintError(ValueError):
    """The pipeline holds state with no content-stable canonical form and
    therefore cannot be cache-keyed. Carries the offending path so logs
    name the blocking attribute."""


# ---------------------------------------------------------------------------
# content feeding
# ---------------------------------------------------------------------------


def _feed_bytes(h, tag: bytes, payload: bytes) -> None:
    # length-prefixed so adjacent fields can never alias across a boundary
    h.update(tag)
    h.update(b"%d:" % len(payload))
    h.update(payload)


def _feed(h, value: Any, path: str) -> None:
    """Feed one value's canonical content into the hash. ``path`` is a
    human-readable attribute trail for error messages only."""
    import numpy as np

    if value is None:
        h.update(b"N;")
    elif isinstance(value, bool):
        h.update(b"B1;" if value else b"B0;")
    elif isinstance(value, int):
        _feed_bytes(h, b"I", str(value).encode())
    elif isinstance(value, float):
        # repr() is the shortest round-trip form: bit-stable across processes
        _feed_bytes(h, b"F", repr(value).encode())
    elif isinstance(value, complex):
        _feed_bytes(h, b"C", repr(value).encode())
    elif isinstance(value, str):
        _feed_bytes(h, b"S", value.encode())
    elif isinstance(value, bytes):
        _feed_bytes(h, b"Y", value)
    elif isinstance(value, np.generic):
        _feed_bytes(h, b"G", str(value.dtype).encode())
        _feed(h, value.item(), path)
    elif isinstance(value, np.ndarray):
        _feed_bytes(h, b"A", str(value.shape).encode())
        _feed_bytes(h, b"a", str(value.dtype).encode())
        if value.dtype.hasobject:
            # tobytes() on an object array serializes PyObject POINTERS —
            # process-unstable garbage; recurse into the elements instead
            # (raises FingerprintError if they have no stable form)
            _feed(h, value.tolist(), path)
        else:
            _feed_bytes(
                h, b"d",
                hashlib.sha256(np.ascontiguousarray(value).tobytes()).digest(),
            )
    elif isinstance(value, (list, tuple)):
        h.update(b"L(" if isinstance(value, list) else b"T(")
        for i, item in enumerate(value):
            _feed(h, item, f"{path}[{i}]")
        h.update(b");")
    elif isinstance(value, dict):
        h.update(b"D(")
        try:
            keys = sorted(value)
        except TypeError as e:
            raise FingerprintError(f"{path}: unsortable dict keys ({e})") from e
        for k in keys:
            _feed(h, k, path)
            _feed(h, value[k], f"{path}[{k!r}]")
        h.update(b");")
    elif isinstance(value, (set, frozenset)):
        # order-canonical by each element's own content digest — sorting by
        # str(x) would embed memory addresses for object reprs, breaking
        # cross-process stability
        h.update(b"Z(")
        digests = []
        for item in value:
            sub = hashlib.sha256()
            _feed(sub, item, path)
            digests.append(sub.digest())
        for d in sorted(digests):
            _feed_bytes(h, b"z", d)
        h.update(b");")
    elif isinstance(value, np.dtype):
        _feed_bytes(h, b"t", str(value).encode())
    elif isinstance(value, types.FunctionType):
        _feed_function(h, value, path)
    elif isinstance(value, types.MethodType):
        h.update(b"M(")
        _feed_function(h, value.__func__, path)
        _feed(h, value.__self__, f"{path}.__self__")
        h.update(b");")
    else:
        _feed_object(h, value, path)


def _feed_code(h, code: types.CodeType, path: str) -> None:
    """Bytecode + constants, recursing into nested code objects (inner
    lambdas/defs live in co_consts — skipping them would let two functions
    differing only in an inner function's body collide)."""
    _feed_bytes(h, b"c", code.co_code)
    _feed(
        h,
        tuple(c for c in code.co_consts if not isinstance(c, types.CodeType)),
        f"{path}.co_consts",
    )
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _feed_code(h, const, f"{path}.{const.co_name}")
    _feed(h, code.co_names, f"{path}.co_names")


def _global_names(code: types.CodeType) -> set:
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _global_names(const)
    return names


def _feed_function(h, fn: types.FunctionType, path: str) -> None:
    """A plain function/lambda canonicalizes as its compiled code plus the
    content of everything it feeds on: closure cells, defaults, AND the
    values of module globals it references — ``def f(X): return X * SCALE``
    must digest differently when ``SCALE`` changes, or a stale executable
    would load for the edited model. Referenced modules digest by name
    (their contents are the environment key's business), classes by
    qualified name, functions recursively; a referenced global with no
    content-stable form raises (→ live compile) rather than keying on it
    blindly."""
    _feed_bytes(h, b"f", f"{fn.__module__}.{fn.__qualname__}".encode())
    _feed_code(h, fn.__code__, path)
    if fn.__defaults__:
        _feed(h, fn.__defaults__, f"{path}.__defaults__")
    if fn.__kwdefaults__:
        _feed(h, fn.__kwdefaults__, f"{path}.__kwdefaults__")
    if fn.__closure__:
        for i, cell in enumerate(fn.__closure__):
            _feed(h, cell.cell_contents, f"{path}.closure[{i}]")
    fn_globals = fn.__globals__
    for name in sorted(_global_names(fn.__code__)):
        # co_names also lists attribute/builtin names; only names actually
        # bound in the module feed content (extra matches are harmless —
        # they add sensitivity, never instability)
        if name not in fn_globals:
            continue
        value = fn_globals[name]
        _feed_bytes(h, b"g", name.encode())
        if isinstance(value, types.ModuleType):
            _feed_bytes(h, b"m", value.__name__.encode())
        elif isinstance(value, type):
            _feed_bytes(
                h, b"k", f"{value.__module__}.{value.__qualname__}".encode()
            )
        else:
            _feed(h, value, f"{path}.globals[{name}]")


def _feed_object(h, value: Any, path: str) -> None:
    """Non-primitive objects: operators recurse by state; tensors and
    batched datasets digest by content; anything else is unprovable."""
    from ..workflow.operators import Operator

    if isinstance(value, Operator):
        _feed_operator_state(h, value, path)
        return
    if isinstance(value, types.ModuleType):
        # same rule as module GLOBALS: digest by name (a module's
        # contents are the environment key's business). Function-local
        # imports are idiomatic here, and they land in closure cells.
        _feed_bytes(h, b"m", value.__name__.encode())
        return
    import numpy as np

    if isinstance(value, torch.Tensor):
        _feed_tensor(h, value)
        return
    if isinstance(value, (torch.device, torch.dtype)):
        _feed_bytes(h, b"t", str(value).encode())
        return
    if isinstance(value, np.ufunc):
        _feed_bytes(h, b"u", value.__name__.encode())
        return
    if isinstance(value, (types.BuiltinFunctionType, types.BuiltinMethodType)):
        # library-provided callables digest by identity; their behavior
        # moves with library versions, which is the environment key's job
        _feed_bytes(
            h, b"u",
            f"{getattr(value, '__module__', '')}.{value.__qualname__}".encode(),
        )
        return
    from ..data.dataset import Dataset

    if isinstance(value, Dataset):
        payload = value.payload if value.is_batched else None
        if payload is not None and hasattr(payload, "shape"):
            h.update(b"DS(")
            _feed(h, payload, path)
            h.update(b");")
            return
        raise FingerprintError(
            f"{path}: unmaterialized dataset has no content-stable form"
        )
    raise FingerprintError(
        f"{path}: {type(value).__qualname__} has no content-stable canonical form"
    )


def _feed_tensor(h, t: Any) -> None:
    """Shape, dtype and the sha256 of the bytes of the tensor's host copy
    (viewed as bytes, so every dtype, bfloat16 included, has one form)."""
    _feed_bytes(h, b"A", str(tuple(t.shape)).encode())
    _feed_bytes(h, b"a", str(t.dtype).encode())
    raw = t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy()
    _feed_bytes(h, b"d", hashlib.sha256(raw).digest())


def _feed_operator_state(h, op: Any, path: str) -> None:
    cls = type(op)
    _feed_bytes(h, b"O", f"{cls.__module__}.{cls.__qualname__}".encode())
    exclude = frozenset(getattr(cls, "aot_fingerprint_exclude", ()))
    state: Dict[str, Any] = vars(op)
    for key in sorted(state):
        if key in exclude:
            continue
        _feed(h, key, path)
        _feed(h, state[key], f"{path}.{key}")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def pipeline_fingerprint(fitted) -> str:
    """Hex sha256 of a :class:`~keystone_tpu_torch.workflow.pipeline.FittedPipeline`'s
    content — topology + operator identities + fitted-parameter digests.
    Raises :class:`FingerprintError` when any operator state has no
    content-stable form (the caller should fall back to a live compile)."""
    from ..workflow import analysis
    from ..workflow.graph import NodeId

    graph = fitted.graph
    h = hashlib.sha256()
    _feed_bytes(h, b"V", str(FORMAT_VERSION).encode())
    order = analysis.linearize(graph)
    index = {gid: i for i, gid in enumerate(order)}
    for gid in order:
        if not isinstance(gid, NodeId) or gid not in graph.operators:
            _feed_bytes(h, b"s", str(index[gid]).encode())  # source slot
            continue
        op = graph.get_operator(gid)
        _feed_bytes(h, b"n", str(index[gid]).encode())
        _feed_operator_state(h, op, op.label)
        _feed(
            h,
            tuple(index[d] for d in graph.get_dependencies(gid)),
            f"{op.label}.deps",
        )
    sink_dep = graph.get_sink_dependency(fitted._sink)
    _feed_bytes(h, b"K", str(index[sink_dep]).encode())
    return h.hexdigest()


def segment_fingerprint(graph, segment) -> str:
    """Hex sha256 of one :class:`~keystone_tpu_torch.check.segments.Segment`'s
    content: member operator states + the segment-local dependency wiring
    + the output slots. The index space is positional over
    ``segment.inputs`` followed by ``segment.nodes`` (both pinned to
    topological order by the planner), so the digest is invariant to the
    arbitrary integer ids graph splicing assigns — two processes planning
    the same fitted pipeline produce the same segment digests, which is
    what lets a warm fit load another process's exported segment
    executables. Raises :class:`FingerprintError` when any member state
    has no content-stable form (the caller falls back to node dispatch)."""
    h = hashlib.sha256()
    _feed_bytes(h, b"V", f"seg{FORMAT_VERSION}".encode())
    pos: Dict[Any, int] = {d: i for i, d in enumerate(segment.inputs)}
    for j, n in enumerate(segment.nodes):
        pos[n] = len(segment.inputs) + j
    for n in segment.nodes:
        op = graph.get_operator(n)
        _feed_bytes(h, b"n", str(pos[n]).encode())
        _feed_operator_state(h, op, op.label)
        _feed(
            h,
            tuple(pos[d] for d in graph.get_dependencies(n)),
            f"{op.label}.deps",
        )
    _feed(h, tuple(pos[o] for o in segment.outputs), "outputs")
    return h.hexdigest()


def environment_key(device: Optional[Any] = None) -> Dict[str, str]:
    """What must match for a cached program to be loadable here: the
    format version, torch's and CUDA's versions, the backend (``cuda`` or
    ``cpu``), and the device's name and compute capability. ``device`` is
    where the program runs: the card when it is None and there is one,
    else the CPU."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        name = torch.cuda.get_device_name(index)
        major, minor = torch.cuda.get_device_capability(index)
        capability = f"{major}.{minor}"
    else:
        name, capability = "cpu", "none"
    return {
        "format": str(FORMAT_VERSION),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "backend": device.type,
        "device_name": name,
        "capability": capability,
    }


def entry_key(
    pipeline_digest: str, shape: Tuple[int, ...], dtype: str, env: Dict[str, str]
) -> str:
    """Cache-entry key for one (pipeline, input signature, environment):
    ``<pipeline digest prefix>-<signature+env digest>``. The pipeline
    prefix keeps one pipeline's bucket entries adjacent on disk (and
    greppable); the second component separates shapes, dtypes, and
    toolchains."""
    h = hashlib.sha256()
    _feed_bytes(h, b"P", pipeline_digest.encode())
    _feed(h, tuple(int(d) for d in shape), "shape")
    _feed_bytes(h, b"y", str(dtype).encode())
    _feed(h, {str(k): str(v) for k, v in env.items()}, "env")
    return f"{pipeline_digest[:32]}-{h.hexdigest()[:24]}"


def segment_entry_key(
    segment_digest: str,
    signatures: Tuple[Tuple[Tuple[int, ...], str], ...],
    env: Dict[str, str],
) -> str:
    """Cache-entry key for one (segment, input-signature tuple,
    environment). The multi-input analogue of :func:`entry_key`: a
    segment function takes one array per segment input, so the key feeds
    every ``(shape, dtype)`` positionally."""
    h = hashlib.sha256()
    _feed_bytes(h, b"G", segment_digest.encode())
    for shape, dtype in signatures:
        _feed(h, tuple(int(d) for d in shape), "shape")
        _feed_bytes(h, b"y", str(dtype).encode())
    _feed(h, {str(k): str(v) for k, v in env.items()}, "env")
    return f"{segment_digest[:32]}-{h.hexdigest()[:24]}"
