"""Per-segment compile-against-run evidence: the adaptive-boundary half of
segment dispatch (port of ``keystone_tpu/cost/segments.py``).

Every segment export and every compiled dispatch lands here under the
profile store's ``plan/segment/<digest>`` namespace. The question the
evidence answers: has this segment's compile cost exceeded the dispatch
savings its runs have earned? Savings a run are modelled as
``(n_nodes - 1) * KEYSTONE_SEGMENT_DISPATCH_COST``, the Python thunk and
span cost one segment dispatch saves for each node it subsumes (200 µs by
default).

Demotion fires only for a segment that has not exported, after
``MIN_RUNS_FOR_DEMOTION`` runs of evidence: an exported segment's compile
is paid once for every later process (warm boots load it), so charging it
to this process's runs would demote exactly the segments the cache makes
cheap. A runtime failure demotes at once.

Without a profile store (``KEYSTONE_PROFILE_DIR`` unset) every function
does nothing and :func:`should_compile` says yes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..utils import env_float

#: runs of evidence required before compile against savings can demote
MIN_RUNS_FOR_DEMOTION = 8


def dispatch_overhead_s() -> float:
    """The modelled per-node dispatch cost a segment dispatch saves
    (seconds); ``KEYSTONE_SEGMENT_DISPATCH_COST`` overrides."""
    return env_float("KEYSTONE_SEGMENT_DISPATCH_COST", 2e-4)


def _key(digest: str) -> str:
    return "plan/segment/" + digest[:32]


def should_compile(digest: str, n_nodes: int) -> bool:
    """False iff the evidence demoted this segment to node dispatch. No
    store or no record: compile."""
    from . import get_store

    store = get_store()
    if store is None:
        return True
    rec = store.load(_key(digest))
    if rec is None:
        return True
    return not bool(rec.get("demoted"))


def record_compile(digest: str, seconds: float, *, exported: bool, n_nodes: int) -> None:
    """One trace (and export, when it landed) was paid for ``digest``."""
    from . import get_store

    store = get_store()
    if store is None:
        return

    def merge(rec: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        rec = dict(rec or {})
        rec["compiles"] = int(rec.get("compiles", 0)) + 1
        rec["compile_s"] = float(rec.get("compile_s", 0.0)) + float(seconds)
        rec["exported"] = bool(rec.get("exported")) or bool(exported)
        rec["nodes"] = int(n_nodes)
        return _evaluate(rec)

    store.update(_key(digest), merge)


def record_run(digest: str, seconds: float, *, n_nodes: int) -> None:
    """One compiled whole-segment dispatch ran for ``digest``."""
    from . import get_store

    store = get_store()
    if store is None:
        return

    def merge(rec: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        rec = dict(rec or {})
        rec["runs"] = int(rec.get("runs", 0)) + 1
        rec["run_s"] = float(rec.get("run_s", 0.0)) + float(seconds)
        rec["nodes"] = int(rec.get("nodes", n_nodes))
        return _evaluate(rec)

    store.update(_key(digest), merge)


def record_failure(digest: str, *, why: str = "runtime") -> None:
    """A compiled dispatch failed at the Python level: demote at once (the
    node-semantics fallback has already served the answer)."""
    from . import get_store

    store = get_store()
    if store is None:
        return

    def merge(rec: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        rec = dict(rec or {})
        rec["demoted"] = True
        rec["why"] = why
        return rec

    store.update(_key(digest), merge)


def _evaluate(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The split rule, applied on every evidence update."""
    if rec.get("demoted") or rec.get("exported"):
        # an export amortizes over every later process: never demoted on
        # this process's runs
        return rec
    runs = int(rec.get("runs", 0))
    if runs < MIN_RUNS_FOR_DEMOTION:
        return rec
    nodes = int(rec.get("nodes", 1))
    savings = runs * max(nodes - 1, 0) * dispatch_overhead_s()
    if float(rec.get("compile_s", 0.0)) > savings:
        rec["demoted"] = True
        rec["why"] = "compile_exceeds_savings"
    return rec
