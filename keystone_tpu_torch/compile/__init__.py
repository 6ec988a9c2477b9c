"""AOT pipeline compilation with a persistent executable cache, and
segment dispatch (port of ``keystone_tpu/compile/``).

A :class:`~keystone_tpu_torch.workflow.pipeline.FittedPipeline` boots like
an offline artifact: the first process to compile a (pipeline, input
signature) pair exports the chain with ``torch.export`` into an on-disk
cache, and every later process (a restarted service, a new serving
replica) loads the saved program instead of tracing the chain again. On
CUDA each loaded program is then captured as one CUDA graph per bucket, as
a cold boot's is: a CUDA graph cannot be serialized.

Layout of a cache directory::

    <dir>/entries/<pipeline-digest>-<signature-digest>.aot   # a saved program
    <dir>/manifest/<pipeline-digest>/<signature>.json        # what it exported
    <dir>/manifest-segments/<segment-digest>/<signatures>.json  # a segment's exports
    <dir>/compile-ledger.ndjson                              # every trace/load

A segment entry (``compile/segment.py``) is keyed by the segment's content
digest and its input-signature tuple, under the same ``entries/`` and
LRU bound: the executor's segment dispatch exports each segment program it
runs, so a warm fit or apply loads them and traces nothing.

There is no XLA compilation-cache layer under it (the JAX package layers
``<dir>/xla``): the saved program is the whole warm-boot state.

Knobs: ``KEYSTONE_AOT_CACHE=<dir>`` (or ``--aot-cache`` on the CLI, or
``utils.obs.configure(aot_cache=...)``), ``KEYSTONE_AOT_CACHE_BYTES`` for
the LRU size bound (1 GiB by default).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from .aot import AotDispatcher, signature_of
from .cache import CacheEntry, ExecutableCache
from .fingerprint import (
    FingerprintError,
    entry_key,
    environment_key,
    pipeline_fingerprint,
)
from .manifest import (
    exported_signatures,
    record_export,
    record_segment,
    segment_digests,
    segment_signatures,
)
from .segment import (
    SegmentBinding,
    SegmentDispatcher,
    bind_segment,
    dispatcher_for,
    lower_segment,
    prewarm_segment_artifacts,
    reset_dispatchers,
)

__all__ = [
    "AotDispatcher",
    "CacheEntry",
    "ExecutableCache",
    "FingerprintError",
    "configure",
    "entry_key",
    "environment_key",
    "exported_signatures",
    "get_cache",
    "pipeline_fingerprint",
    "record_export",
    "record_segment",
    "reset",
    "reset_dispatchers",
    "segment_digests",
    "segment_signatures",
    "signature_of",
    "SegmentBinding",
    "SegmentDispatcher",
    "bind_segment",
    "dispatcher_for",
    "lower_segment",
    "prewarm_segment_artifacts",
]

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_cache: Optional[ExecutableCache] = None
_initialized = False  # False: the next get_cache() reads KEYSTONE_AOT_CACHE


def configure(
    path: Optional[str] = None, max_bytes: Optional[int] = None
) -> Optional[ExecutableCache]:
    """Install the process-wide executable cache.

    ``path=None`` follows ``KEYSTONE_AOT_CACHE`` (unset or empty: AOT
    caching off). A directory that cannot be used turns AOT caching off
    with a warning: a service that boots without the cache must not fail
    because it was asked for one."""
    global _cache, _initialized
    with _lock:
        _initialized = True
        if path is None:
            from ..utils import env_str

            path = env_str("KEYSTONE_AOT_CACHE")
        if not path:
            _cache = None
            return None
        try:
            _cache = ExecutableCache(path, max_bytes=max_bytes)
        except Exception:
            logger.warning(
                "aot: cache dir %r unusable — AOT caching disabled", path,
                exc_info=True,
            )
            _cache = None
        return _cache


def get_cache() -> Optional[ExecutableCache]:
    """The installed cache, or None (AOT caching off). Honors
    ``KEYSTONE_AOT_CACHE`` lazily, so a library caller that never calls
    :func:`configure` still gets the cache the environment asks for."""
    if not _initialized:
        return configure()
    return _cache


def reset() -> None:
    """Forget the installed cache and the environment memo."""
    global _cache, _initialized
    with _lock:
        _cache = None
        _initialized = False
