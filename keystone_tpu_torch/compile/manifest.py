"""The bucket-signature manifest: which input signatures a pipeline has
ever exported to the AOT cache (port of ``keystone_tpu/compile/manifest.py``,
host-only file work).

The executable cache itself is keyed — a process must already know the
exact ``(pipeline, shape, dtype, environment)`` to look an entry up. That
is fine for the engine's own buckets, but a fresh serving replica booting
against a shared cache directory wants the inverse query: *"what
signatures does this pipeline serve?"* — so it can pre-compile every one
of them BEFORE admitting traffic, instead of discovering bucket shapes
one cold first-request at a time. The manifest is that index: one tiny
JSON file per (pipeline digest, signature), written whenever an export
lands, listed by :func:`exported_signatures` at deploy time (the JAX
package's ``ServingFleet.start()`` pre-warms every entry, and so does the
port's).

One file per signature — not one mutable list per pipeline — so
concurrent exporters (N replicas, N processes) never read-modify-write
each other's entries: writes are create-if-absent with the same atomic
tmp-then-rename discipline as the cache proper, and a corrupt or foreign
file degrades to "signature unknown", never a crash. Entries are advisory
(a manifest signature whose cache entry was evicted simply warms via a
live trace), so no invalidation protocol is needed.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import time
from typing import List, Tuple

from .cache import ExecutableCache

logger = logging.getLogger(__name__)

Signature = Tuple[Tuple[int, ...], str]


def _manifest_dir(cache: ExecutableCache, digest: str) -> str:
    return os.path.join(cache.root, "manifest", digest)


def _sig_name(shape: Tuple[int, ...], dtype: str) -> str:
    raw = json.dumps([list(shape), dtype]).encode()
    return hashlib.sha256(raw).hexdigest()[:24] + ".json"


def record_export(
    cache: ExecutableCache, digest: str, shape, dtype: str
) -> None:
    """Note that ``digest`` exported an executable for ``(shape, dtype)``.
    Best-effort: a manifest that cannot be written must never fail the
    export that still serves live."""
    try:
        d = _manifest_dir(cache, digest)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, _sig_name(tuple(shape), dtype))
        if os.path.exists(path):  # signature already recorded
            return
        payload = json.dumps(
            {
                "shape": [int(x) for x in shape],
                "dtype": str(dtype),
                "created_unix": time.time(),
            },
            sort_keys=True,
        ).encode()
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except Exception:
        logger.warning(
            "aot manifest: could not record %s %s", digest, shape,
            exc_info=True,
        )


# ---------------------------------------------------------------------------
# Segment-artifact manifest: which input-signature TUPLES each compiled
# segment has exported. Same one-file-per-record create-if-absent
# discipline as the bucket manifest above, in a sibling namespace
# (``manifest-segments/<segment digest>/``) so a booting fleet can
# pre-warm segment executables (the warm-FIT artifacts) alongside its
# serving buckets; segment dispatch (``compile/segment.py``) writes them.
# ---------------------------------------------------------------------------

#: one compiled segment's input signatures: one (shape, dtype) per input
SegmentSignature = Tuple[Signature, ...]


def _segment_manifest_root(cache: ExecutableCache) -> str:
    return os.path.join(cache.root, "manifest-segments")


def _segment_dir(cache: ExecutableCache, digest: str) -> str:
    return os.path.join(_segment_manifest_root(cache), digest)


def _segment_sig_name(sigs: SegmentSignature) -> str:
    raw = json.dumps([[list(s), d] for s, d in sigs]).encode()
    return hashlib.sha256(raw).hexdigest()[:24] + ".json"


def record_segment(
    cache: ExecutableCache, digest: str, signatures: SegmentSignature
) -> None:
    """Note that segment ``digest`` exported an executable for the input
    signature tuple ``signatures``. Best-effort, like
    :func:`record_export`: a manifest that cannot be written must never
    fail the export that still serves live."""
    try:
        sigs = tuple((tuple(int(x) for x in s), str(d)) for s, d in signatures)
        d = _segment_dir(cache, digest)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, _segment_sig_name(sigs))
        if os.path.exists(path):  # signature tuple already recorded
            return
        payload = json.dumps(
            {
                "inputs": [[list(s), dt] for s, dt in sigs],
                "created_unix": time.time(),
            },
            sort_keys=True,
        ).encode()
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except Exception:
        logger.warning(
            "aot manifest: could not record segment %s %s", digest,
            signatures, exc_info=True,
        )


def segment_signatures(
    cache: ExecutableCache, digest: str
) -> List[SegmentSignature]:
    """Every input-signature tuple the segment ``digest`` has ever
    exported, deterministic order (sorted). Corrupt files are skipped."""
    d = _segment_dir(cache, digest)
    try:
        names = os.listdir(d)
    except OSError:
        return []
    sigs = set()
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name), "rb") as f:
                rec = json.loads(f.read().decode())
            parsed = tuple(
                (tuple(int(x) for x in shape), str(dtype))
                for shape, dtype in rec["inputs"]
            )
        except Exception:
            logger.warning(
                "aot manifest: skipping unreadable segment entry %s/%s",
                d, name,
            )
            continue
        sigs.add(parsed)
    return sorted(sigs)


def segment_digests(cache: ExecutableCache) -> List[str]:
    """Every segment digest with at least one manifest record (sorted) —
    the iteration root for fleet warm boot pre-warming."""
    try:
        names = os.listdir(_segment_manifest_root(cache))
    except OSError:
        return []
    return sorted(n for n in names if not n.startswith("."))


def exported_signatures(
    cache: ExecutableCache, digest: str
) -> List[Signature]:
    """Every ``(shape, dtype)`` the pipeline ``digest`` has ever exported,
    deterministic order (sorted). Corrupt or foreign files are skipped."""
    d = _manifest_dir(cache, digest)
    try:
        names = os.listdir(d)
    except OSError:
        return []
    sigs = set()
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name), "rb") as f:
                rec = json.loads(f.read().decode())
            shape = tuple(int(x) for x in rec["shape"])
            dtype = str(rec["dtype"])
        except Exception:
            logger.warning(
                "aot manifest: skipping unreadable entry %s/%s", d, name
            )
            continue
        sigs.add((shape, dtype))
    return sorted(sigs)
