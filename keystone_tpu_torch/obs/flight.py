"""The always-on flight recorder: a bounded ring of recent evidence (port
of ``keystone_tpu/obs/flight.py``).

The tracer (``obs/tracer.py``) is opt-in and unbounded, made for a
profiling run and of no use for the failure that happens with tracing off.
The :class:`FlightRecorder` is its complement: always on (no switch gates
recording), a fixed-size ring of recent span summaries and instants whose
cost a record is one small dict and one deque append under a lock, and an
atomic JSON dump when something goes wrong, so that a fault leaves a
post-mortem file holding the last N things the process did before it.

What lands in the ring:

* **span summaries**: one dict per unit of work the hot paths already
  account for, such as a serving replica's batch (``serve.replica``):
  name, seconds and the few attributes a post-mortem needs, no tree;
* **instants**: fault injections (``fault.inject``) and the recovery
  instants of the fault sites (``aot.read_degraded``, ``retry.attempt``).

Dumps are atomic (a temporary file and ``os.replace``) into
``KEYSTONE_FLIGHT_DIR`` (default: the system's temporary directory), keep
the newest ``KEYSTONE_FLIGHT_KEEP`` auto-named files (32), and never raise
into the path that asked for them. :func:`install_sigquit_dump` dumps on
SIGQUIT. The serving fleet dumps on a replica's quarantine, on a replica
down for good, on a canary rollback and on a device fault; the JAX
package's other triggers (worker death, trainer park) come with the process
tier.

``SITE_INSTANTS`` is the observability contract: every fault site of
``faults/plan.py`` maps to the recovery instant its handling path records
(``tests/test_torch_flight.py`` holds the port to it).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from collections import deque
from typing import List, Optional

from ..utils import env_int, env_str

logger = logging.getLogger(__name__)

#: fault site (a ``faults/plan.py`` constant) -> the recovery instant its
#: handling path records. Sites may share one: the scan's retry discipline
#: covers both scan seams.
SITE_INSTANTS = {
    "scan.chunk": "retry.attempt",
    "scan.stage": "retry.attempt",
    "replica.batch": "fault.replica_down",
    "aot.read": "aot.read_degraded",
    "worker.spawn": "fault.worker_restart",
    "trainer.ingest": "trainer.ingest_fault",
    "trainer.absorb": "trainer.park",
    "trainer.canary": "trainer.rollback",
    # both scale seams recover alike: the half-born or half-drained slot is
    # reaped and the abort recorded
    "scale.spawn": "scale.abort",
    "scale.drain": "scale.abort",
}

#: ring capacity by default; ``KEYSTONE_FLIGHT_RING`` overrides
_DEFAULT_RING = 512


def _ring_size() -> int:
    return env_int("KEYSTONE_FLIGHT_RING", _DEFAULT_RING)


def _dump_dir() -> str:
    return env_str("KEYSTONE_FLIGHT_DIR") or tempfile.gettempdir()


def _dump_keep() -> int:
    return env_int("KEYSTONE_FLIGHT_KEEP", 32)


def _prune_dumps(dump_dir: str, keep: int) -> int:
    """Keep the newest ``keep`` auto-named dumps (``keystone-flight-*.json``)
    of ``dump_dir``, deleting the oldest by mtime first; returns how many
    went. A file another process already removed is skipped."""
    try:
        names = [n for n in os.listdir(dump_dir)
                 if n.startswith("keystone-flight-") and n.endswith(".json")]
    except OSError:
        logger.debug("flight retention: cannot list %s", dump_dir, exc_info=True)
        return 0
    if len(names) <= keep:
        return 0
    stamped = []
    for n in names:
        full = os.path.join(dump_dir, n)
        try:
            stamped.append((os.path.getmtime(full), full))
        except OSError:
            continue  # another pruner took it
    stamped.sort()
    deleted = 0
    for _, full in stamped[:max(0, len(stamped) - keep)]:
        try:
            os.unlink(full)
            deleted += 1
        except OSError:
            logger.debug("flight retention: unlink %s failed", full, exc_info=True)
    return deleted


class FlightRecorder:
    """A bounded ring of span summaries and instants, cheap to write."""

    def __init__(self, ring: Optional[int] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=ring or _ring_size())
        self._dumps = 0
        self._dropped = 0  # records pushed out by the bound

    # -- writes -----------------------------------------------------------

    def _append(self, entry: dict) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(entry)

    def record_span(self, name: str, seconds: float, **attrs) -> None:
        """One finished unit of work. ``attrs`` should be JSON scalars (a
        dump writes anything else as its ``str``)."""
        entry = {"t": time.time(), "kind": "span", "name": name,
                 "seconds": round(float(seconds), 6)}
        if attrs:
            entry["attrs"] = attrs
        self._append(entry)

    def record_instant(self, name: str, **attrs) -> None:
        entry = {"t": time.time(), "kind": "instant", "name": name}
        if attrs:
            entry["attrs"] = attrs
        self._append(entry)

    # -- reads ------------------------------------------------------------

    def entries(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- the dump ---------------------------------------------------------

    def dump(self, trigger: str, path: Optional[str] = None) -> Optional[str]:
        """Write the ring atomically as JSON; returns the path, or None on a
        failure (logged: a post-mortem write must never take down the path
        that asked for it).

        The lock is taken with a timeout: the SIGQUIT handler may interrupt
        the main thread inside a ``record_*`` call that holds it, and
        blocking there would hang the process the dump exists to explain.
        Without the lock the copy of the deque is best effort."""
        locked = self._lock.acquire(timeout=1.0)
        try:
            try:
                entries = list(self._ring)
            except RuntimeError:  # a writer changed the deque mid-copy
                entries = []
            self._dumps += 1
            seq = self._dumps
            dropped = self._dropped
        finally:
            if locked:
                self._lock.release()
        doc = {
            "producer": "keystone_tpu_torch.obs.flight",
            "trigger": trigger,
            "pid": os.getpid(),
            "host_unix": time.time(),
            "ring_capacity": self._ring.maxlen,
            "dropped_before_window": dropped,
            "entries": entries,
        }
        auto_named = path is None
        if path is None:
            path = os.path.join(_dump_dir(), f"keystone-flight-{os.getpid()}-{trigger}-{seq}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)  # readers never see a torn file
        except OSError:
            logger.warning("flight recorder: dump to %s failed", path, exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass  # the temporary file may never have been created
            return None
        logger.warning("flight recorder: %d entries -> %s (trigger: %s)",
                       len(entries), path, trigger)
        if auto_named:
            # retention manages the auto-named files only: an explicit path
            # is the caller's file
            _prune_dumps(os.path.dirname(path), _dump_keep())
        return path


# -- the process's recorder ---------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()
_sigquit_installed = False


def recorder() -> FlightRecorder:
    """The process's flight recorder, created at first use (recording is
    always on: there is nothing to install)."""
    global _recorder
    rec = _recorder
    if rec is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
            rec = _recorder
    return rec


def reset() -> None:
    """Drop the process's recorder: the next record starts a fresh ring."""
    global _recorder
    with _recorder_lock:
        _recorder = None


def record_span(name: str, seconds: float, **attrs) -> None:
    recorder().record_span(name, seconds, **attrs)


def record_instant(name: str, **attrs) -> None:
    recorder().record_instant(name, **attrs)
    # every flight instant is also a structured event for an outside
    # collector; nothing is written unless KEYSTONE_EVENTS names a path
    from . import ledger

    ledger.emit_event("instant", name, **attrs)


def dump(trigger: str, path: Optional[str] = None) -> Optional[str]:
    return recorder().dump(trigger, path=path)


def install_sigquit_dump() -> bool:
    """SIGQUIT dumps the ring, then runs the previous handler (the default
    terminates, as before). False outside the main thread (only it may
    register a handler) or when already installed."""
    import signal

    global _sigquit_installed
    if _sigquit_installed:
        return False
    prev = None

    def _on_quit(signum, frame):
        dump("sigquit")
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # SIG_DFL is not callable: restore it and raise the signal again,
            # so the operator's kill still terminates
            signal.signal(signal.SIGQUIT, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGQUIT)

    try:
        prev = signal.signal(signal.SIGQUIT, _on_quit)
    except ValueError:
        return False  # not the main thread
    _sigquit_installed = True
    return True
