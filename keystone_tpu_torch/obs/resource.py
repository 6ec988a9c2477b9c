"""Resource accounting: the batch cost split and the device-memory
watermark (port of ``keystone_tpu/obs/resource.py``).

:func:`split_batch_cost` is the arithmetic of per-tenant cost tables: one
batch's measured device seconds split equally across its coalesced
members (every member's answer came out of one program run, so the equal
split is the charge whose sums give back the replica's busy time), with
queue seconds and payload bytes charged per member. The serving replica
charges each batch to its requests' (tenant, priority) identities.

:class:`MemoryWatermark` samples live device bytes at the seams where
allocations peak (a scan's end, a served batch) through
:func:`device_memory_bytes`: the caching allocator's bytes in use on the
card in use and the card's capacity, or on the CPU the process's resident
bytes. :func:`install_memory_gauges` registers the
readings as gauges with their merge modes: live bytes add across worker
processes, the peak is a maximum, the fraction a mean.

``KEYSTONE_ACCOUNTING`` (default on) gates the whole plane.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..utils import env_flag

logger = logging.getLogger(__name__)

_enabled: Optional[bool] = None
_enabled_lock = threading.Lock()


def accounting_enabled() -> bool:
    """``KEYSTONE_ACCOUNTING`` (default on), read once a process."""
    global _enabled
    if _enabled is None:
        with _enabled_lock:
            if _enabled is None:
                _enabled = env_flag("KEYSTONE_ACCOUNTING", True)
    return _enabled


def reset() -> None:
    """Read the switch again and forget the watermark."""
    global _enabled, _watermark
    with _enabled_lock:
        _enabled = None
    with _watermark_lock:
        _watermark = None


def payload_nbytes(datum: object) -> int:
    """The byte size of one request payload, 0 when it has none."""
    n = getattr(datum, "nbytes", None)
    if isinstance(n, (int, float)):
        return int(n)
    if isinstance(datum, (bytes, bytearray, memoryview)):
        return len(datum)
    return 0


def split_batch_cost(requests: Sequence[object], device_seconds: float, now: float,
                     payloads: Optional[Sequence[object]] = None
                     ) -> Dict[Tuple[str, str], Dict[str, object]]:
    """One batch's cost split across its members, keyed by (tenant,
    priority).

    ``device_seconds`` splits equally a member; ``queue_s`` is each
    member's wait from ``enqueued`` to ``now`` (the dispatch time, on the
    same clock), never negative; ``payload_bytes`` comes from
    ``payloads[i]`` when given (the validated rows), else from the
    request's ``datum``."""
    if not requests:
        return {}
    per = float(device_seconds) / len(requests)
    out: Dict[Tuple[str, str], Dict[str, object]] = {}
    for i, req in enumerate(requests):
        key = (str(getattr(req, "tenant", None) or "default"),
               str(getattr(req, "priority", None) or "normal"))
        row = out.setdefault(key, {"device_s": 0.0, "queue_s": 0.0, "payload_bytes": 0,
                                   "items": 0})
        row["device_s"] += per
        enq = getattr(req, "enqueued", None)
        if isinstance(enq, (int, float)):
            row["queue_s"] += max(0.0, float(now) - float(enq))
        payload = (payloads[i] if payloads is not None and i < len(payloads)
                   else getattr(req, "datum", None))
        row["payload_bytes"] += payload_nbytes(payload)
        row["items"] += 1
    return out


# -- device memory ------------------------------------------------------------


def _resident_bytes() -> int:
    """The process's resident bytes (``/proc/self/statm``), 0 where the
    system has no such file: the CPU's counterpart of the JAX package's
    ``jax.live_arrays()`` sum, coarse but growing and shrinking with the
    real footprint, and one small read a sample."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, ValueError, IndexError):
        return 0
    return pages * os.sysconf("SC_PAGE_SIZE")


def device_memory_bytes() -> Tuple[int, int]:
    """``(live_bytes, limit_bytes)`` of the card in use: the caching
    allocator's bytes in use (``torch.cuda.memory_stats``) and the card's
    capacity (``torch.cuda.mem_get_info``). Where this process has not
    initialized CUDA, its resident bytes and no limit. Never raises."""
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            index = torch.cuda.current_device()
            stats = torch.cuda.memory_stats(index)
            _, capacity = torch.cuda.mem_get_info(index)
            return int(stats.get("allocated_bytes.all.current", 0)), int(capacity)
        return _resident_bytes(), 0
    except Exception:
        logger.debug("device memory read failed", exc_info=True)
        return 0, 0


class MemoryWatermark:
    """A throttled live and peak byte tracker for one process."""

    def __init__(self):
        self._lock = threading.Lock()
        self.live = 0
        self.peak = 0
        self.limit = 0
        self._last = 0.0

    def sample(self, min_interval_s: float = 0.0) -> int:
        """Read again unless a reading landed within ``min_interval_s`` (hot
        seams throttle; gauges read fresh). Returns the live bytes either
        way."""
        now = time.monotonic()
        with self._lock:
            if min_interval_s > 0 and now - self._last < min_interval_s:
                return self.live
            self._last = now
        live, limit = device_memory_bytes()
        with self._lock:
            self.live = live
            self.limit = limit
            if live > self.peak:
                self.peak = live
            return self.live

    def fraction(self) -> Optional[float]:
        with self._lock:
            if self.limit <= 0:
                return None
            return self.live / self.limit


_watermark: Optional[MemoryWatermark] = None
_watermark_lock = threading.Lock()


def watermark() -> MemoryWatermark:
    global _watermark
    if _watermark is None:
        with _watermark_lock:
            if _watermark is None:
                _watermark = MemoryWatermark()
    return _watermark


def sample_memory(min_interval_s: float = 0.25) -> int:
    """The seam hook: refresh the process's watermark (throttled); 0 and
    nothing read when accounting is off."""
    if not accounting_enabled():
        return 0
    return watermark().sample(min_interval_s)


def install_memory_gauges(metrics) -> None:
    """Register the device-memory gauges on a ``MetricsRegistry`` with
    their merge modes: ``device_mem_bytes`` adds across workers,
    ``device_mem_peak_bytes`` is a maximum, ``device_mem_fraction`` a mean
    (None until a limit is known)."""
    if not accounting_enabled():
        return
    wm = watermark()
    metrics.set_gauge("device_mem_bytes", lambda: wm.sample(0.05), merge="sum")
    metrics.set_gauge("device_mem_peak_bytes", lambda: wm.peak, merge="max")
    metrics.set_gauge("device_mem_fraction", wm.fraction, merge="mean")


__all__ = [
    "MemoryWatermark",
    "accounting_enabled",
    "device_memory_bytes",
    "install_memory_gauges",
    "payload_nbytes",
    "reset",
    "sample_memory",
    "split_batch_cost",
    "watermark",
]
