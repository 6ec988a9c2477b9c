"""Observability configuration: one switch for logs, phase profiling, the
tracer, the profile store and the AOT executable cache (port of
``keystone_tpu/utils/obs.py``).

* ``configure(level)``: process-wide stdlib logging with a timestamped
  one-line format; every module logs through ``logging.getLogger``.
* phase profiling (``utils/timing.py``): under profiling each phase exit
  waits for the card, and phases log at INFO.
* ``trace``: install the pipeline tracer (``obs/``) and write its
  Chrome-trace JSON at exit, or with :func:`export_trace`.
* ``profiles``: install the persistent operator-profile store (``cost/``):
  traced fits learn per-operator throughput, and the second fit of a
  pipeline plans its solver choice and cache plan from evidence, with zero
  sampling executions.
* ``aot_cache``: install the AOT executable cache (``compile/``): a fitted
  chain's compiled programs load from it instead of being traced again.

Environment switches, read by ``configure(None)`` and the CLI:
``KEYSTONE_LOG=debug|info|warning|error``, ``KEYSTONE_PROFILE=1``,
``KEYSTONE_TRACE=/path/trace.json``, ``KEYSTONE_PROFILE_DIR=/path/dir``,
``KEYSTONE_AOT_CACHE=/path/dir``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional

_FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"

_configured = False

_every_lock = threading.Lock()
_every_last: Dict[str, float] = {}


def every(key: str, seconds: float) -> bool:
    """A process-wide rate limit for periodic logs: True at most once per
    ``seconds`` for ``key`` (the first call is True)."""
    now = time.monotonic()
    with _every_lock:
        last = _every_last.get(key)
        if last is not None and now - last < seconds:
            return False
        _every_last[key] = now
        return True


def reset_rate_limits() -> None:
    """Forget every :func:`every` key (``timing.reset`` calls this: a new
    measurement epoch logs its first periodic summary at once)."""
    with _every_lock:
        _every_last.clear()


def configure(level: Optional[str] = None, profile: Optional[bool] = None,
              trace: Optional[str] = None, profiles: Optional[str] = None,
              device=None, aot_cache: Optional[str] = None) -> None:
    """Configure logging, phase profiling, tracing, the profile store and
    the AOT executable cache.

    ``level=None`` reads ``KEYSTONE_LOG`` (default warning; an unknown
    value there is warned about and ignored, an unknown ``level`` raises).
    ``profile`` turns phase profiling on or off; None follows
    ``KEYSTONE_PROFILE``. ``trace`` is a Chrome-trace path that installs
    the tracer; None follows ``KEYSTONE_TRACE``. ``profiles`` is the
    profile store's directory (``""`` turns it off); None follows
    ``KEYSTONE_PROFILE_DIR`` and keeps a store already installed.
    ``device`` is where the fits run, which keys the environment of a
    store named here (one from the environment variable keys the default
    device's). ``aot_cache`` is the AOT executable cache's directory
    (``""`` turns it off); None follows ``KEYSTONE_AOT_CACHE`` and keeps a
    cache already installed.
    Idempotent: later calls re-level the root handler, and an installed
    tracer keeps its spans."""
    global _configured
    from_env = level is None
    if from_env:
        level = os.environ.get("KEYSTONE_LOG", "warning")
    lvl = getattr(logging, str(level).upper(), None)
    if not isinstance(lvl, int):
        if not from_env:
            raise ValueError(f"unknown log level: {level!r}")
        logging.getLogger(__name__).warning(
            "ignoring unknown KEYSTONE_LOG=%r (use debug|info|warning|error)", level)
        lvl = logging.WARNING
    root = logging.getLogger()
    if not _configured:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
        root.addHandler(handler)
        _configured = True
    root.setLevel(lvl)

    if profile is None:
        raw = os.environ.get("KEYSTONE_PROFILE", "")
        profile = raw.strip().lower() not in ("", "0", "false", "no", "off")
    from . import timing

    timing.enable(bool(profile))
    if profile and lvl > logging.INFO:
        root.setLevel(logging.INFO)  # phase logs are INFO

    if trace is None:
        trace = os.environ.get("KEYSTONE_TRACE") or None
    if trace:
        from ..obs import tracer as obs_tracer

        obs_tracer.start(path=trace)

    from .. import cost as cost_mod

    if profiles is not None:
        cost_mod.configure(profiles, device=device)
    else:
        cost_mod.get_store()

    from .. import compile as compile_mod

    if aot_cache is not None:
        compile_mod.configure(aot_cache)
    else:
        compile_mod.get_cache()


def export_trace(path: Optional[str] = None) -> Optional[str]:
    """Write the configured trace now (Chrome-trace JSON, the top spans and
    the cache audit in the log). Returns the path, or None when tracing
    was never configured, so the CLI calls it unconditionally."""
    from ..obs import tracer as obs_tracer

    return obs_tracer.export(path)
