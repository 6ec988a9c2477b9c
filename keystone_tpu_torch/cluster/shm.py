"""Same-host zero-copy payload transport: a shared-memory slot ring per
wire direction (port of ``keystone_tpu/cluster/shm.py``).

The binary codec (:mod:`.codec`) took serialization off the hot path; what
is left for a large array is the move through a kernel socket buffer and
back. Peers on one host can skip it: ``multiprocessing.shared_memory``
maps the same pages into both processes. The discipline:

* **One ring per direction, one writer.** The router creates both
  segments of a worker slot (it owns their lifetime: created before the
  spawn, unlinked on death, retirement and shutdown) and names them in the
  worker's spec; the worker attaches and says so in its ``ready`` report.
  A worker that cannot attach answers ``shm: false`` and the router
  unlinks and stays inline. The router writes only the router→worker ring,
  the worker only worker→router.
* **Slot states in the segment.** The first ``slots`` bytes are the state
  table (0 free, 1 busy), then ``slots`` fixed-size payload regions. The
  writer flips free→busy under its local lock (it is the only allocator);
  the reader flips busy→free once the member the slot carried is answered,
  so reply receipt is the reclamation signal and no ack exists. The slot
  index travels in the length-framed socket frame.
* **Degradation, counted.** A full ring, or a payload larger than a slot,
  goes inline (``shm.fallback``). A worker's death unlinks both segments;
  a respawn gets fresh segments under a new generation name, so slots a
  dead peer held never leak into its successor.

Readers get zero-copy memoryviews; a caller that keeps data past the
slot's free (the router's reply path) copies first, as :mod:`.codec` does.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_FREE = 0
_BUSY = 1


def _unregister_tracker(name: str) -> None:
    """Detach this process's resource_tracker claim on an ATTACHED
    segment: before 3.13 the tracker registers attaches too, and would
    unlink the router-owned segment when the worker exits — exactly the
    double-unlink this guards."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(f"/{name}", "shared_memory")
    except Exception:
        logger.debug(
            "resource_tracker unregister for %s failed (harmless on "
            "newer Pythons)", name, exc_info=True,
        )


class ShmRing:
    """One direction's slot ring over a ``SharedMemory`` segment.

    ``create=True`` (the router) allocates and later :meth:`unlink`\\ s;
    ``create=False`` (the worker) attaches to the named segment. The
    writer side calls :meth:`alloc` + :meth:`write`; the reader side
    :meth:`view` + :meth:`free`."""

    def __init__(
        self,
        name: str,
        slots: int,
        slot_bytes: int,
        create: bool = False,
    ):
        from multiprocessing import shared_memory

        if slots < 1 or slot_bytes < 1:
            raise ValueError(
                f"need at least one slot of at least one byte, got "
                f"{slots}x{slot_bytes}"
            )
        self.name = name
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self._created = bool(create)
        size = self.slots + self.slots * self.slot_bytes
        self._shm = shared_memory.SharedMemory(
            name=name, create=create, size=size
        )
        if create:
            self._shm.buf[: self.slots] = bytes(self.slots)
        else:
            _unregister_tracker(self._shm.name)
        #: serializes this PROCESS's concurrent allocators; cross-process
        #: safety needs no lock — each state byte has exactly one writer
        #: per transition direction (writer FREE→BUSY, reader BUSY→FREE)
        self._lock = threading.Lock()
        self._closed = False

    def _data_off(self, slot: int) -> int:
        return self.slots + slot * self.slot_bytes

    # -- writer side -----------------------------------------------------

    def alloc(self, nbytes: int) -> Optional[int]:
        """A FREE slot marked BUSY for ``nbytes`` of payload, or None
        (payload too large for any slot, ring exhausted, ring closed) —
        the caller degrades to inline bytes."""
        if nbytes > self.slot_bytes:
            return None
        with self._lock:
            if self._closed:
                return None
            buf = self._shm.buf
            for slot in range(self.slots):
                if buf[slot] == _FREE:
                    buf[slot] = _BUSY
                    return slot
        return None

    def write(self, slot: int, data) -> None:
        """Payload bytes into an :meth:`alloc`'d slot (the one memcpy
        this transport pays — into shared pages instead of the kernel)."""
        off = self._data_off(slot)
        n = len(data) if not isinstance(data, memoryview) else data.nbytes
        self._shm.buf[off: off + n] = data

    # -- reader side -----------------------------------------------------

    def view(self, slot: int, nbytes: int) -> memoryview:
        """Zero-copy read view of a slot's payload. The slot stays BUSY
        until :meth:`free` — callers keeping the data longer copy it."""
        if not (0 <= slot < self.slots) or nbytes > self.slot_bytes:
            from .codec import CodecError

            raise CodecError(
                f"shm descriptor out of range: slot {slot} ({nbytes} "
                f"byte(s)) in a {self.slots}x{self.slot_bytes} ring"
            )
        off = self._data_off(slot)
        return self._shm.buf[off: off + nbytes]

    def free(self, slot: int) -> None:
        """Reclaim a slot (reader side, after its member is answered)."""
        if 0 <= slot < self.slots and not self._closed:
            self._shm.buf[slot] = _FREE

    @property
    def in_use(self) -> int:
        return sum(
            1 for s in range(self.slots) if self._shm.buf[s] == _BUSY
        )

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        """Drop this process's mapping (both sides, idempotent)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._shm.close()
        except BufferError:
            # a decoded view still aliases the buffer (e.g. an in-flight
            # request's datum) — the mapping lives until the view dies;
            # unlink below still removes the name
            logger.debug(
                "shm ring %s close deferred: exported views still alive",
                self.name,
            )
        except OSError:
            logger.debug(
                "shm ring %s close failed", self.name, exc_info=True
            )

    def unlink(self) -> None:
        """Remove the segment name (creator side — after this, only
        existing mappings keep the pages alive). Idempotent."""
        if not self._created:
            return
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
        except OSError:
            logger.debug(
                "shm ring %s unlink failed", self.name, exc_info=True
            )


def make_ring_pair(base: str, slots: int, slot_bytes: int):
    """The router's creation helper: ``(c2w, w2c)`` rings under
    ``<base>c`` / ``<base>r``, or ``(None, None)`` when the platform
    refuses shared memory (the negotiation then settles on inline)."""
    try:
        c2w = ShmRing(base + "c", slots, slot_bytes, create=True)
    except Exception:
        logger.warning(
            "shared-memory ring %sc unavailable — wire payloads stay "
            "inline", base, exc_info=True,
        )
        return None, None
    try:
        w2c = ShmRing(base + "r", slots, slot_bytes, create=True)
    except Exception:
        logger.warning(
            "shared-memory ring %sr unavailable — wire payloads stay "
            "inline", base, exc_info=True,
        )
        c2w.close()
        c2w.unlink()
        return None, None
    return c2w, w2c
