"""Resumable-fit checkpoints: an accumulator state on disk (port of
``keystone_tpu/faults/checkpoint.py``).

A long out-of-core fit folds chunks into small sufficient statistics
(``linalg/accumulators.py``: a Gram and cross pair, a TSQR R factor,
column moments). They are exact host arrays, so a fit can save
``(state, chunk cursor, row cursor)`` at block boundaries, and a killed fit
run again resumes from the last completed block instead of scanning from
chunk zero.

The file format is the JAX package's: one file a fit key, the magic line,
the sha256 of the payload, then the payload (pickle protocol 4), written to
a temporary file and renamed over the old one, so a reader sees the old
checkpoint or the new one, never a torn write. Loads degrade: a missing
file is a fresh fit; a corrupt one is deleted with a warning and the fit
starts over; one written under another key is left alone and ignored.

Loading unpickles through a restricted unpickler that admits only the
globals a state needs: the accumulator classes of this package and what
numpy pickles an array or a scalar with. A file that names anything else
(a checkpoint of the JAX package in the same directory, whose states are
``keystone_tpu`` classes) is another fit's: a miss, left on disk, and
nothing it names is imported or called.

Pickled float64 arrays round-trip bit for bit: a killed and resumed fit
folds the state an uninterrupted fit would have.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import pickle
import tempfile
from typing import Any, Optional, Tuple

logger = logging.getLogger(__name__)

_MAGIC = b"KSFITCKPT1\n"

class _ForeignPayload(Exception):
    """The payload names a class outside what a checkpoint of this package
    holds."""


#: every global a saved state names (dicts, lists, numbers and strings
#: need none): numpy's array and scalar reconstruction under its 1.x and
#: 2.x module names, and the states a fold saves
_ALLOWED = frozenset({
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "scalar"),
    ("keystone_tpu_torch.linalg.accumulators", "GramSolverState"),
    ("keystone_tpu_torch.linalg.accumulators", "TsqrRState"),
    ("keystone_tpu_torch.linalg.accumulators", "MomentsState"),
    ("keystone_tpu_torch.linalg.weighted", "WeightedSolverState"),
    ("keystone_tpu_torch.nodes.learning.linear", "_CenteredTsqr"),
})


class _StateUnpickler(pickle.Unpickler):
    """Imports only the globals of ``_ALLOWED``."""

    def find_class(self, module: str, name: str):
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        raise _ForeignPayload(f"{module}.{name}")


class FitCheckpoint:
    """One fit's resumable state under ``root``, keyed by ``key``: the fit's
    identity (solver family, λ grid, data length and label shape), anything
    that would make a resume wrong if it differed."""

    def __init__(self, root: str, key: str):
        self.root = str(root)
        self.key = str(key)
        os.makedirs(self.root, exist_ok=True)
        digest = hashlib.sha256(self.key.encode()).hexdigest()[:16]
        self.path = os.path.join(self.root, f"fitckpt-{digest}.pkl")

    def save(self, state: Any, chunk_cursor: int, row_cursor: int) -> None:
        """Save one completed block atomically: ``state`` (any picklable
        accumulator, or a dict of them), the chunks folded so far and the
        rows they held."""
        doc = {"key": self.key, "chunk": int(chunk_cursor), "rows": int(row_cursor),
               "state": state}
        payload = pickle.dumps(doc, protocol=4)
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp-ckpt-")
        try:
            with os.fdopen(fd, "wb") as f:
                # the JAX package's bytes, written in three parts: no joined
                # copy of a payload that is gigabytes at d 16,384
                f.write(_MAGIC)
                f.write(hashlib.sha256(payload).digest())
                f.write(payload)
            os.replace(tmp, self.path)  # the old file or the new, never torn
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load(self) -> Optional[Tuple[Any, int, int]]:
        """``(state, chunk cursor, row cursor)`` of the last completed
        block, or None (missing, corrupt, foreign). Never raises for what
        is on disk."""
        try:
            with open(self.path, "rb") as f:
                # the payload read apart, so that no copy of it is sliced out
                head, payload = f.read(len(_MAGIC) + 32), f.read()
        except FileNotFoundError:
            return None
        except OSError:
            logger.warning("fit checkpoint: unreadable %s, starting fresh", self.path,
                           exc_info=True)
            return None
        try:
            doc = self._parse(head, payload)
        except _ForeignPayload as e:
            logger.warning("fit checkpoint: %s names %s, not a state of this package: "
                           "ignoring it and starting fresh", self.path, e)
            return None
        if doc is None:
            self._discard("corrupt")
            return None
        if doc.get("key") != self.key:
            # a prefix collision, or two fits pointed at one directory
            logger.warning("fit checkpoint: %s belongs to another fit key, ignoring it and "
                           "starting fresh", self.path)
            return None
        return doc["state"], int(doc["chunk"]), int(doc["rows"])

    def _parse(self, head: bytes, payload: bytes) -> Optional[dict]:
        if len(head) < len(_MAGIC) + 32 or not head.startswith(_MAGIC):
            return None
        if hashlib.sha256(payload).digest() != head[len(_MAGIC):]:
            return None
        try:
            doc = _StateUnpickler(io.BytesIO(payload)).load()
        except _ForeignPayload:
            raise
        except Exception:
            logger.debug("fit checkpoint: undecodable payload", exc_info=True)
            return None
        if not isinstance(doc, dict) or "state" not in doc:
            return None
        return doc

    def _discard(self, why: str) -> None:
        logger.warning("fit checkpoint: %s entry at %s, deleting it and starting fresh", why,
                       self.path)
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def complete(self) -> None:
        """The fit finished: remove the checkpoint, so the next fit under
        this key starts fresh."""
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        except OSError:
            logger.warning("fit checkpoint: could not remove %s", self.path, exc_info=True)

    def exists(self) -> bool:
        return os.path.exists(self.path)
