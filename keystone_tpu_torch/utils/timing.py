"""Per-phase wall-clock instrumentation for the hot solvers (port of
``keystone_tpu/utils/timing.py``).

A process-global registry accumulates named phase durations: solvers wrap
their phases in :func:`phase`, a caller reads :func:`snapshot`. Profiling
is off by default (``KEYSTONE_PROFILE`` unset): a phase exit then reads
the host clock only, and CUDA work queued in the phase may still be
running. With profiling on (``KEYSTONE_PROFILE=1`` or :func:`enable`), a
phase exit synchronizes the CUDA device of the value handed to it (or
appended to the holder it yields), so the device time lands in its own
phase, and logs the phase at INFO. A device error raised by that
synchronization propagates.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch

from ..data.dataset import first_leaf

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_profiling = bool(os.environ.get("KEYSTONE_PROFILE"))


def enable(on: bool = True) -> None:
    global _profiling
    _profiling = on


def _sync(target: Any) -> None:
    """Wait for the CUDA device that ``target`` (a tensor, or a tuple or
    list whose first leaf is one) lives on; anything else needs no wait."""
    if isinstance(target, (tuple, list)):
        if not target:
            return
        target = first_leaf(tuple(target))
    if isinstance(target, torch.Tensor) and target.is_cuda:
        torch.cuda.synchronize(target.device)


@contextlib.contextmanager
def phase(name: str, sync: Optional[Any] = None):
    """Time a named phase. Under profiling, ``sync`` (or the first value
    appended to the yielded holder) is synchronized at exit."""
    t0 = time.perf_counter()
    holder: list = []
    try:
        yield holder
    finally:
        if _profiling:
            _sync(holder[0] if holder else sync)
        dt = time.perf_counter() - t0
        with _lock:
            _totals[name] += dt
            _counts[name] += 1
        if _profiling:
            logger.info("phase %-28s %8.4f s", name, dt)


def record(name: str, seconds: float) -> None:
    with _lock:
        _totals[name] += seconds
        _counts[name] += 1


def reset() -> None:
    """Clear the phase totals and the periodic-log rate limits
    (``utils/obs.every``): a fresh measurement epoch."""
    with _lock:
        _totals.clear()
        _counts.clear()
    from . import obs

    obs.reset_rate_limits()


def snapshot(prefix: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """``{phase: {"seconds": total, "calls": n}}``, optionally only the
    phases whose names start with ``prefix``."""
    with _lock:
        return {
            k: {"seconds": round(_totals[k], 4), "calls": _counts[k]}
            for k in sorted(_totals)
            if prefix is None or k.startswith(prefix)
        }
