"""The persistent operator-profile store: learned cost evidence on disk
(port of ``keystone_tpu/cost/store.py``, in its file format).

One record is one JSON file: one profile key for one environment.

* **Atomic writes.** A record is written to a temporary file in the same
  directory and ``os.replace``d into place, so a concurrent reader sees
  the old record, the new one, or a miss, never a torn file.
* **Corruption tolerance.** A magic marker, the embedded key and a sha256
  of the canonical record JSON are checked on load. A mismatch (a
  truncated file, bit rot, a foreign file) is logged, the file deleted,
  and the load reports a miss, so the caller samples instead.
* **Environment isolation.** The file name carries a digest of the
  environment that wrote it and the payload carries the environment, so a
  profile taken on the CPU is never read as evidence on the card, and the
  other way round. The port's environment (:func:`profile_environment`)
  is its own key: the backend (``cuda`` or ``cpu``), the device's name,
  and the torch and CUDA versions. A record the JAX package wrote into the
  same directory carries another environment and so another file name: it
  is a miss here and stays on disk.

Key namespaces (``cost/__init__.py`` has the layout): ``op/<Class>``
(class-level throughput), ``solver/<graph-fp>`` (the shape and choice of
one pipeline's auto-solver node), ``plan/<graph-fp>`` (one pipeline's
per-node observed costs).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import tempfile
from typing import Callable, Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

_MAGIC = "KSPROF1"
_SUFFIX = ".json"
_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def fit_device(device=None) -> torch.device:
    """Where the fits run: ``device`` when given, else CUDA when it is
    available, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def profile_environment(device=None) -> Dict[str, str]:
    """What must match for a profile to count as evidence: the backend, the
    device's name, and the torch and CUDA versions. ``device`` is where
    the fits run, as :func:`fit_device` says."""
    device = fit_device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    else:
        kind = device.type
    return {
        "backend": device.type,
        "device_kind": kind,
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
    }


def _canonical(record: Dict) -> str:
    return json.dumps(record, sort_keys=True, separators=(",", ":"))


class ProfileStore:
    """A directory of profile records, safe across processes."""

    def __init__(self, root: str, env: Optional[Dict[str, str]] = None, device=None):
        self.root = os.path.abspath(os.path.expanduser(root))
        self._env = dict(env) if env is not None else None
        self._device = device
        self._digest: Optional[str] = None
        os.makedirs(self.root, exist_ok=True)

    @property
    def device(self) -> torch.device:
        """Where the fits this store keys run (:func:`fit_device`)."""
        return fit_device(self._device)

    @property
    def env(self) -> Dict[str, str]:
        if self._env is None:
            self._env = profile_environment(self._device)
        return self._env

    @property
    def _env_digest(self) -> str:
        if self._digest is None:
            self._digest = hashlib.sha256(_canonical(self.env).encode()).hexdigest()[:8]
        return self._digest

    def path(self, key: str) -> str:
        if not key:
            raise ValueError(f"invalid profile key {key!r}")
        safe = _SAFE.sub("_", key.replace("/", "."))
        digest = hashlib.sha256(key.encode()).hexdigest()[:12]
        return os.path.join(self.root, f"{safe}-{digest}-{self._env_digest}{_SUFFIX}")

    def store(self, key: str, record: Dict) -> str:
        """Persist one record atomically. An IO failure raises; callers
        treat a failed store as a fit that stays sampled."""
        doc = {
            "magic": _MAGIC,
            "key": key,
            "env": self.env,
            "record": record,
            "sha256": hashlib.sha256(_canonical(record).encode()).hexdigest(),
        }
        path = self.path(key)
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp-prof-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, sort_keys=True, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def update(self, key: str, fn: Callable[[Optional[Dict]], Dict]) -> Optional[Dict]:
        """Read, modify and write one record: ``fn`` gets the current record
        (None on a miss) and returns its replacement. A failure is logged
        and gives None: evidence must never fail a fit."""
        try:
            record = fn(self.load(key))
            self.store(key, record)
            return record
        except Exception:
            logger.warning("profile store: update of %s failed", key, exc_info=True)
            return None

    def load(self, key: str) -> Optional[Dict]:
        """One record, checked; None on a miss, a corrupt record (which is
        deleted) or another environment's record (which is kept)."""
        path = self.path(key)
        try:
            with open(path, "r") as f:
                doc = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            self._discard(path, "unreadable/corrupt")
            return None
        record = self._validate(key, doc)
        if record is None:
            self._discard(path, "corrupt")
            return None
        if doc.get("env") != self.env:
            # another environment's evidence, stale rather than corrupt:
            # unreachable through path(), but a file may be copied by hand
            logger.info("profile store: environment mismatch for %s (%s, want %s)",
                        key, doc.get("env"), self.env)
            return None
        return record

    @staticmethod
    def _validate(key: str, doc) -> Optional[Dict]:
        if not isinstance(doc, dict) or doc.get("magic") != _MAGIC:
            return None
        if doc.get("key") != key:
            return None  # renamed or foreign file
        record = doc.get("record")
        if not isinstance(record, dict):
            return None
        if doc.get("sha256") != hashlib.sha256(_canonical(record).encode()).hexdigest():
            return None  # bit rot or a torn copy
        return record

    def _discard(self, path: str, why: str) -> None:
        logger.warning("profile store: discarding %s record %s", why, path)
        try:
            os.unlink(path)
        except OSError:
            pass

    def update(self, key: str, fn: Callable[[Optional[Dict]], Dict]) -> Optional[Dict]:
        """Read, modify, write one record: ``fn`` gets the current record
        (None on a miss) and returns its replacement. Concurrent writers
        are safe (the last writer wins a file). A failure is logged and
        returns None: a profile update never fails a fit."""
        try:
            record = fn(self.load(key))
            self.store(key, record)
            return record
        except Exception:
            logger.warning("profile store: update of %s failed", key, exc_info=True)
            return None

    def keys(self) -> List[str]:
        """The keys of every valid record of this environment."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            if not name.endswith(_SUFFIX) or name.startswith("."):
                continue
            try:
                with open(os.path.join(self.root, name), "r") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            key = doc.get("key") if isinstance(doc, dict) else None
            if isinstance(key, str) and self._validate(key, doc) is not None \
                    and doc.get("env") == self.env:
                out.append(key)
        return sorted(out)
