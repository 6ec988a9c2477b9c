"""The persistent executable cache: content-keyed blobs on disk (port of
``keystone_tpu/compile/cache.py``).

One entry = one file = one serialized AOT executable for one
(pipeline fingerprint, input signature, environment) key. The file is
self-validating so every failure mode degrades to a cache miss, never a
crash or a wrong program:

* **atomic writes** — entries are written to a same-directory temp file
  and ``os.replace``d into place, so a concurrent reader sees either the
  old entry, the new entry, or a miss; never a torn file.
* **corruption tolerance** — magic, length framing, a sha256 payload
  checksum, and a JSON header are all validated on load; any mismatch
  (truncation, bit rot, a foreign file) logs, best-effort deletes the
  entry, and reports a miss so the caller live-compiles.
* **version invalidation** — the header records the producing
  environment (torch and CUDA versions, backend, device name and compute
  capability). Entry keys
  already include the environment digest, so a toolchain upgrade simply
  misses; header validation is the belt-and-braces for hand-copied or
  doctored files.
* **LRU size bound** — loads bump the entry's mtime; stores evict
  oldest-mtime entries beyond ``max_bytes`` (``KEYSTONE_AOT_CACHE_BYTES``,
  default 1 GiB), never the entry just written. Deletion races with
  concurrent processes are benign (``FileNotFoundError`` ignored; POSIX
  keeps an open file readable after unlink).

This module stores and validates bytes. What the bytes *are* (saved
``torch.export`` programs) and how they become callables is
``compile/aot.py``'s business. The frame is the JAX package's, byte for
byte; an entry that package wrote carries its own environment, so here it
is an environment miss and stays on disk.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_MAGIC = b"KSAOT001"
_LEN = struct.Struct("<Q")
_SUFFIX = ".aot"

DEFAULT_MAX_BYTES = 1 << 30  # 1 GiB


@dataclass
class CacheEntry:
    """A successfully loaded + validated entry."""

    key: str
    header: Dict[str, object]
    payload: bytes
    path: str

    @property
    def nbytes(self) -> int:
        return len(self.payload)


class ExecutableCache:
    """Size-bounded, multi-process-safe blob cache rooted at one directory."""

    def __init__(self, root: str, max_bytes: Optional[int] = None):
        self.root = os.path.abspath(os.path.expanduser(root))
        if max_bytes is None:
            from ..utils import env_int

            max_bytes = env_int(
                "KEYSTONE_AOT_CACHE_BYTES", DEFAULT_MAX_BYTES, minimum=0
            )
        self.max_bytes = int(max_bytes)
        os.makedirs(self.entries_dir, exist_ok=True)
        # the compile ledger shares the cache root: cache-layer movements
        # (hit/store/evict) interleave with the dispatcher's
        # trace/export/load events in one accounting stream
        from ..obs.ledger import CompileLedger

        self._ledger = CompileLedger.for_cache_root(self.root)

    @property
    def ledger(self):
        """The :class:`~keystone_tpu_torch.obs.ledger.CompileLedger` riding
        this cache root (``compile-ledger.ndjson``)."""
        return self._ledger

    @property
    def entries_dir(self) -> str:
        return os.path.join(self.root, "entries")

    def entry_path(self, key: str) -> str:
        if os.sep in key or not key:
            raise ValueError(f"invalid cache key {key!r}")
        return os.path.join(self.entries_dir, key + _SUFFIX)

    # -- store ----------------------------------------------------------

    def store(self, key: str, payload: bytes, header: Dict[str, object]) -> str:
        """Atomically persist one entry; evicts beyond the size bound.
        Returns the entry path. IO failures propagate — callers treat a
        failed store as non-fatal (the executable still runs live)."""
        path = self.entry_path(key)
        header = dict(header)
        header["key"] = key
        header["payload_bytes"] = len(payload)
        header_bytes = json.dumps(header, sort_keys=True).encode()
        fd, tmp = tempfile.mkstemp(
            dir=self.entries_dir, prefix=".tmp-" + key[:16] + "-"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(_MAGIC)
                f.write(_LEN.pack(len(header_bytes)))
                f.write(header_bytes)
                f.write(_LEN.pack(len(payload)))
                f.write(payload)
                f.write(hashlib.sha256(payload).digest())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic on POSIX: readers see old XOR new
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._ledger.record("store", key=key, nbytes=len(payload))
        self._evict(keep=key)
        return path

    # -- load -----------------------------------------------------------

    def load(
        self, key: str, expect_env: Optional[Dict[str, str]] = None
    ) -> Optional[CacheEntry]:
        """Load + validate one entry. Returns None on miss, corruption,
        or environment mismatch — never raises for on-disk problems. A
        hit bumps the entry's mtime (the LRU recency signal)."""
        from ..faults import AOT_READ, fault_point, is_transient

        try:
            # the chaos seam for cache reads: a transient fault here is
            # exactly a flaky filesystem, and the recovery is the one the
            # cache already has — degrade to a miss (the caller traces
            # live and re-exports), never fail the serving boot
            fault_point(AOT_READ, key=key)
        except Exception as e:
            if is_transient(e):
                logger.warning(
                    "aot cache: transient read fault for %s — degrading "
                    "to a miss", key,
                )
                # the recovery instant of the aot.read fault site, in the
                # flight ring always and in a trace when tracing: the
                # degrade-to-miss verdict is not only in the log stream
                from ..obs import flight
                from ..obs.tracer import current as _trace_current

                flight.record_instant("aot.read_degraded", key=key)
                tracer = _trace_current()
                if tracer is not None:
                    tracer.instant(
                        "aot.read_degraded", op_type="AotCache", key=key
                    )
                return None
            raise
        path = self.entry_path(key)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None
        except OSError:
            logger.warning("aot cache: unreadable entry %s", path, exc_info=True)
            return None
        entry = self._parse(key, data, path)
        if entry is None:
            self._discard(path, "corrupt")
            return None
        if expect_env is not None:
            got = entry.header.get("env")
            if got != dict(expect_env):
                # a different toolchain's artifact — stale, not corrupt
                logger.info(
                    "aot cache: environment mismatch for %s (entry %s, want %s)",
                    key, got, dict(expect_env),
                )
                return None
        try:
            os.utime(path)  # LRU recency; racing an eviction is benign
        except OSError:
            pass
        self._ledger.record("hit", key=key, nbytes=entry.nbytes)
        return entry

    def _parse(self, key: str, data: bytes, path: str) -> Optional[CacheEntry]:
        try:
            if data[: len(_MAGIC)] != _MAGIC:
                return None
            off = len(_MAGIC)
            (hlen,) = _LEN.unpack_from(data, off)
            off += _LEN.size
            header = json.loads(data[off : off + hlen].decode())
            off += hlen
            (plen,) = _LEN.unpack_from(data, off)
            off += _LEN.size
            payload = data[off : off + plen]
            digest = data[off + plen : off + plen + 32]
            if len(payload) != plen or len(digest) != 32:
                return None  # truncated
            if hashlib.sha256(payload).digest() != digest:
                return None  # bit rot / torn copy
            if header.get("key") != key:
                return None  # renamed / foreign file
            return CacheEntry(key=key, header=header, payload=payload, path=path)
        except Exception:
            # unreadable/corrupt entry degrades to a miss by contract
            logger.debug("aot cache: unreadable entry %s", path,
                         exc_info=True)
            return None

    def _discard(self, path: str, why: str) -> None:
        logger.warning("aot cache: discarding %s entry %s", why, path)
        try:
            os.unlink(path)
        except OSError:
            pass

    # -- maintenance ----------------------------------------------------

    def entries(self) -> List[Tuple[str, int, float]]:
        """``(key, bytes, mtime)`` for every present entry, oldest first."""
        rows = []
        try:
            names = os.listdir(self.entries_dir)
        except OSError:
            return []
        for name in names:
            if not name.endswith(_SUFFIX):
                continue
            try:
                st = os.stat(os.path.join(self.entries_dir, name))
            except OSError:
                continue  # evicted by a concurrent process mid-listing
            rows.append((name[: -len(_SUFFIX)], st.st_size, st.st_mtime))
        rows.sort(key=lambda r: r[2])
        return rows

    def total_bytes(self) -> int:
        return sum(size for _, size, _ in self.entries())

    def _evict(self, keep: Optional[str] = None) -> int:
        """Drop oldest-mtime entries until under ``max_bytes``; never the
        ``keep`` key (the entry just written). Returns entries removed."""
        rows = self.entries()
        total = sum(size for _, size, _ in rows)
        removed = 0
        for key, size, _ in rows:
            if total <= self.max_bytes:
                break
            if key == keep:
                continue
            try:
                os.unlink(self.entry_path(key))
            except OSError:
                continue
            self._ledger.record("evict", key=key, nbytes=size)
            total -= size
            removed += 1
        if removed:
            logger.info(
                "aot cache: evicted %d entr%s (size bound %d bytes)",
                removed, "y" if removed == 1 else "ies", self.max_bytes,
            )
        return removed
