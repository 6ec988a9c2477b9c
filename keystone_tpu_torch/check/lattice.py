"""The traceability lattice: a static verdict per operator (port of
``keystone_tpu/check/lattice.py``).

"Traceable" here means that the node's ``forward`` can run inside one
captured CUDA graph: a function of the stacked batch with no host
synchronisation. The verdict comes from static evidence: the operator
class registry, the ``forward`` attribute, and the code objects reachable
from ``forward`` (nested functions, closure cells, and functions of this
package it calls by name), searched for host syncs and for writes to
``self``. Verdicts, worst first::

    opaque         no ``forward``: host per-item work. Blocks whole-chain
                   compilation.
    stateful       ``forward`` assigns attributes of ``self``, or the class
                   says so (``check_verdict = "stateful"`` or
                   :func:`register_verdict`): a replayed graph would freeze
                   that state. Blocks whole-chain compilation.
    host_callback  ``forward`` reaches a host sync (``.item()``,
                   ``.tolist()``, ``.cpu()``, ``.numpy()``,
                   ``torch.cuda.synchronize``). A sync cannot be captured
                   into a CUDA graph, so in the port this verdict blocks
                   whole-chain compilation; in the JAX package a host
                   callback jits and blocks only export.
    batch_coupled  ``forward`` couples rows (``batch_coupled = True``):
                   compiles, but must never be served through a
                   pad-and-slice path.
    traceable      a pure function of the stacked batch.

The inspection is conservative where it matters: a marker that cannot be
ruled out (its name anywhere in the code graph) downgrades the verdict,
and a class can pin its verdict when inspection cannot see the truth.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Any, Dict, Iterable, Set

logger = logging.getLogger(__name__)

TRACEABLE = "traceable"
BATCH_COUPLED = "batch_coupled"
HOST_CALLBACK = "host_callback"
STATEFUL = "stateful"
OPAQUE = "opaque"

#: worst-first severity order (index = badness rank)
SEVERITY = (OPAQUE, STATEFUL, HOST_CALLBACK, BATCH_COUPLED, TRACEABLE)

VERDICTS = frozenset(SEVERITY)


def worst(verdicts: Iterable[str]) -> str:
    """The worst verdict present (traceable if none)."""
    best = len(SEVERITY) - 1
    for v in verdicts:
        best = min(best, SEVERITY.index(v))
    return SEVERITY[best]


def blocks_jit(verdict: str) -> bool:
    """Does this verdict block building the whole-chain function (the
    ``NotTraceableError`` criterion)? A host sync does here: it cannot be
    captured into a CUDA graph."""
    return verdict in (OPAQUE, STATEFUL, HOST_CALLBACK)


def blocks_export(verdict: str) -> bool:
    """Does this verdict block exporting the whole chain as one artifact?"""
    return verdict in (OPAQUE, STATEFUL, HOST_CALLBACK)


_VERDICT_OVERRIDES: Dict[type, str] = {}


def register_verdict(op_class: type, verdict: str) -> None:
    """Pin the verdict of every node of ``op_class``: the escape hatch for
    operators whose code inspection cannot see the truth."""
    if verdict not in VERDICTS:
        raise ValueError(f"unknown verdict {verdict!r}")
    _VERDICT_OVERRIDES[op_class] = verdict


# -- code inspection --------------------------------------------------------

#: names whose presence anywhere in a ``forward``'s code graph mark a host
#: synchronisation: the attribute calls ``.item()``, ``.tolist()``,
#: ``.cpu()``, ``.numpy()`` and ``torch.cuda.synchronize``
_HOST_SYNC_MARKERS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})


def _iter_code_graph(fn: Any, max_depth: int = 6):
    """Yield the code objects reachable from ``fn``: its own code, nested
    code constants (comprehensions, local defs), closure-cell functions,
    and the functions of this package it names as globals. The global
    chase stops at the package boundary, so it never walks into torch or
    numpy."""
    seen: Set[int] = set()
    stack = [(fn, 0)]
    while stack:
        obj, depth = stack.pop()
        code = getattr(obj, "__code__", None)
        if code is None or id(code) in seen or depth > max_depth:
            continue
        seen.add(id(code))
        yield code
        for const in code.co_consts:
            if hasattr(const, "co_names"):
                stack.append((_CodeHolder(const), depth + 1))
        for cell in getattr(obj, "__closure__", None) or ():
            try:
                cv = cell.cell_contents
            except ValueError:  # an empty cell
                continue
            if callable(cv):
                stack.append((cv, depth + 1))
        g = getattr(obj, "__globals__", None)
        if g is not None:
            for name in code.co_names:
                target = g.get(name)
                if (callable(target)
                        and getattr(target, "__module__", "").startswith("keystone_tpu_torch")
                        and hasattr(target, "__code__")):
                    stack.append((target, depth + 1))


class _CodeHolder:
    """A bare code object with the function surface ``_iter_code_graph``
    walks."""

    __slots__ = ("__code__",)

    def __init__(self, code):
        self.__code__ = code


def _mentions_host_sync(fn: Any) -> bool:
    return any(_HOST_SYNC_MARKERS & set(code.co_names) for code in _iter_code_graph(fn))


def _mutates_self(fn: Any) -> bool:
    """Does ``fn``'s own code assign attributes of its first positional
    argument (``self.x = ...``)? Read from the source's AST; without
    source there is no evidence, so not stateful."""
    import ast
    import inspect
    import textwrap

    raw = getattr(fn, "__func__", fn)
    code = getattr(raw, "__code__", None)
    if code is None or not code.co_varnames:
        return False
    self_name = code.co_varnames[0]
    if self_name not in ("self", "cls"):
        return False
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(raw)))
    except (OSError, SyntaxError, TypeError):
        return False
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == self_name):
                return True
    return False


# -- classification ---------------------------------------------------------

#: bounded memo keyed on (op class, forward's code object, coupling): the
#: code object itself, not its id, so a collected function's recycled id
#: never serves a stale verdict
_CLASS_MEMO: "OrderedDict[tuple, str]" = OrderedDict()
_CLASS_MEMO_MAX = 256


def classify(op: Any) -> str:
    """The static verdict of one operator instance."""
    from ..workflow.fusion import FusedTransformerOperator
    from ..workflow.operators import GatherTransformerOperator

    cls = type(op)
    if cls in _VERDICT_OVERRIDES:
        return _VERDICT_OVERRIDES[cls]
    declared = getattr(op, "check_verdict", None)
    if declared is not None:
        if declared not in VERDICTS:
            raise ValueError(
                f"{cls.__name__}.check_verdict={declared!r} is not a "
                f"lattice verdict {sorted(VERDICTS)}"
            )
        return declared
    if isinstance(op, FusedTransformerOperator):
        # a fused chain is as good as its worst step
        return worst(classify(s) for s, _ in op.steps)
    if isinstance(op, GatherTransformerOperator):
        return TRACEABLE  # a structural zip
    fn = getattr(op, "forward", None)
    if fn is None:
        return OPAQUE

    # only closure-free functions are memoized: two functions of one code
    # object closing over different helpers can have different verdicts
    if getattr(fn, "__closure__", None):
        memo_key = cached = None
    else:
        memo_key = (cls, getattr(fn, "__code__", None), bool(getattr(op, "batch_coupled", False)))
        try:
            cached = _CLASS_MEMO.get(memo_key)
        except TypeError:  # an unhashable callable
            memo_key = cached = None
    if cached is not None:
        _CLASS_MEMO.move_to_end(memo_key)
        return cached

    if _mutates_self(fn):
        verdict = STATEFUL
    elif _mentions_host_sync(fn):
        verdict = HOST_CALLBACK
    elif getattr(op, "batch_coupled", False):
        verdict = BATCH_COUPLED
    else:
        verdict = TRACEABLE
    if memo_key is not None:
        _CLASS_MEMO[memo_key] = verdict
        while len(_CLASS_MEMO) > _CLASS_MEMO_MAX:
            _CLASS_MEMO.popitem(last=False)
    return verdict
