"""Append-only NDJSON ledgers: durable resource-accounting evidence (port
of ``keystone_tpu/obs/ledger.py``, host-only file work).

Two consumers share one primitive here. :class:`NdjsonSink` is a locked,
append-only JSON-lines file that NEVER raises into its caller — ledger
writes ride hot paths (AOT load, batch completion, SLO breach emission)
and evidence collection must not be able to fail a request. On top of it:

* :class:`CompileLedger` — the persistent compile ledger living next to
  the AOT executable cache (``<cache root>/compile-ledger.ndjson``).
  Every trace, export, load, cache hit/store/evict lands as one line
  with duration, signature, and byte size: the residency-budget evidence
  an evict-and-reload budget reads, and the proof that a warm boot paid
  loads instead of traces.
* the process **events sink** — ``KEYSTONE_EVENTS=/path/events.ndjson``
  turns structured instants into an NDJSON event stream an external
  collector can tail (:func:`emit_event`; the flight recorder that feeds
  it in the JAX package comes with the serving half of ``obs/``).

Both file formats are one JSON object per line, each carrying ``ts``
(unix seconds), ``pid``, and an ``event`` discriminator; readers use
:func:`read_ndjson`, which skips torn/partial trailing lines so a tail
mid-append still parses.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from ..utils import env_str

logger = logging.getLogger(__name__)

#: filename of the compile ledger inside an AOT cache root
COMPILE_LEDGER_NAME = "compile-ledger.ndjson"


class NdjsonSink:
    """Locked append-only JSON-lines writer that never raises.

    One line per :meth:`append` call, written with a single ``write`` on
    an ``O_APPEND`` stream so concurrent processes sharing the path
    interleave whole lines, not bytes. The first failed append logs a
    WARNING and disables the sink (subsequent appends are no-ops) — a
    full disk must not turn into a per-batch log storm."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._dead = False

    def append(self, record: Dict[str, object]) -> bool:
        """Serialize ``record`` as one NDJSON line; True when written."""
        try:
            line = json.dumps(record, default=str, separators=(",", ":"))
        except Exception:
            logger.warning(
                "ndjson sink %s: unserializable record dropped", self.path,
                exc_info=True,
            )
            return False
        with self._lock:
            if self._dead:
                return False
            try:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
                return True
            except OSError:
                self._dead = True
                logger.warning(
                    "ndjson sink %s: append failed; sink disabled",
                    self.path, exc_info=True,
                )
                return False


def read_ndjson(path: str) -> List[Dict[str, object]]:
    """Parse an NDJSON file into dict rows, skipping torn lines (a
    reader may race an in-flight append). Missing file reads as []."""
    rows: List[Dict[str, object]] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict):
                    rows.append(row)
    except OSError:
        return []
    return rows


# one sink per path process-wide, so the AOT dispatcher and the cache
# layer appending to the same ledger share one lock (and one dead-flag)
_sinks: Dict[str, NdjsonSink] = {}
_sinks_lock = threading.Lock()


def sink_for(path: str) -> NdjsonSink:
    path = os.path.abspath(str(path))
    with _sinks_lock:
        sink = _sinks.get(path)
        if sink is None:
            sink = _sinks[path] = NdjsonSink(path)
        return sink


class CompileLedger:
    """The compile/load ledger next to one AOT executable cache.

    Events (the ``event`` field): ``trace`` (a cold pipeline trace, with
    ``seconds`` of tracing/lowering time), ``export`` (the serialized
    artifact stored, with ``nbytes``), ``load`` (a warm-boot
    deserialization, with ``seconds`` paid and ``saved_s`` — the trace
    time the hit avoided), ``hit``/``store``/``evict`` (cache-layer
    movements with entry sizes). Each line also carries ``key`` (cache
    entry key) and ``label``/``shape``/``dtype`` when the caller knows
    the signature."""

    def __init__(self, path: str):
        self._sink = sink_for(path)

    @property
    def path(self) -> str:
        return self._sink.path

    @classmethod
    def for_cache_root(cls, root: str) -> "CompileLedger":
        return cls(os.path.join(str(root), COMPILE_LEDGER_NAME))

    def record(self, event: str, **fields: object) -> bool:
        rec: Dict[str, object] = {
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "event": str(event),
        }
        for k, v in fields.items():
            if v is None:
                continue
            if isinstance(v, float):
                v = round(v, 6)
            rec[k] = v
        return self._sink.append(rec)

    def entries(
        self, event: Optional[str] = None
    ) -> List[Dict[str, object]]:
        rows = read_ndjson(self.path)
        if event is None:
            return rows
        return [r for r in rows if r.get("event") == event]


# -- the process events sink (KEYSTONE_EVENTS) --------------------------

_events_sink: Optional[NdjsonSink] = None
_events_resolved = False
_events_lock = threading.Lock()


def events_sink() -> Optional[NdjsonSink]:
    """The ``KEYSTONE_EVENTS`` sink, or None when the env is unset.
    Resolved once per process; :func:`reset_events` re-reads (tests)."""
    global _events_sink, _events_resolved
    if _events_resolved:
        return _events_sink
    with _events_lock:
        if not _events_resolved:
            path = env_str("KEYSTONE_EVENTS")
            _events_sink = sink_for(path) if path else None
            _events_resolved = True
    return _events_sink


def reset_events() -> None:
    global _events_sink, _events_resolved
    with _events_lock:
        _events_sink = None
        _events_resolved = False


def emit_event(kind: str, name: str, /, **attrs: object) -> bool:
    """Append one structured event (``{ts, pid, event: kind, name,
    attrs: {...}}``) to the ``KEYSTONE_EVENTS`` sink; False when no sink
    is configured or the write failed. Attrs nest under their own key so
    an instant's attributes can never shadow the envelope fields. Never
    raises."""
    sink = events_sink()
    if sink is None:
        return False
    rec: Dict[str, object] = {
        "ts": round(time.time(), 6),
        "pid": os.getpid(),
        "event": str(kind),
        "name": str(name),
    }
    clean = {k: v for k, v in attrs.items() if v is not None}
    if clean:
        rec["attrs"] = clean
    return sink.append(rec)


__all__ = [
    "COMPILE_LEDGER_NAME",
    "CompileLedger",
    "NdjsonSink",
    "emit_event",
    "events_sink",
    "read_ndjson",
    "reset_events",
    "sink_for",
]
