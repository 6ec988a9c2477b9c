"""The host text frontend in C++ (port of ``keystone_tpu/native``), loaded
with ctypes.

Text featurization is host work by nature: per-character hashing,
tokenizing and n-gram counting over Python strings. ``hashing.cpp`` (a copy
of the JAX package's source) does those loops over flat arrays:

* built with ``g++ -O3 -shared -fPIC`` at first use into
  ``keystone_tpu_torch/_build/``, under a name that carries a hash of the
  source; no build system, plain ``extern "C"`` and ctypes;
* bit-exact with the pure-Python implementations, which stay the spec
  (``tests/test_torch_text.py`` holds the two equal);
* every caller falls back to pure Python when the library cannot be built
  or loaded, or ``KEYSTONE_NO_NATIVE=1`` is set. :func:`require_lib` raises
  instead, for a caller that must know the library ran, and :data:`CALLS`
  counts each wrapper's runs of the library.

Unlike the JAX package's ``text_frontend_batch``, which returns one empty
document for an empty corpus, the copy here returns no document.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..utils import env_flag

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "hashing.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

#: runs of the library by wrapper name (a wrapper that falls back to Python
#: does not count)
CALLS: Counter = Counter()

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: why the build or the load failed; None until it has
_ERROR: Optional[str] = None


def _build_and_load() -> ctypes.CDLL:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    so_path = BUILD_DIR / f"libkshash-{digest}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = f"{so_path}.tmp{os.getpid()}"
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed: {proc.stderr[-500:]}")
        os.replace(tmp, so_path)  # atomic: concurrent builds race safely
    lib = ctypes.CDLL(str(so_path))
    lib.ks_java_string_hash_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.ks_java_string_hash_batch.restype = None
    lib.ks_ngram_hash_features_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ks_ngram_hash_features_batch.restype = ctypes.c_int64
    lib.ks_text_frontend.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ks_text_frontend.restype = ctypes.c_int64
    lib.ks_packed_grams_unique.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ks_packed_grams_unique.restype = ctypes.c_int64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None (``KEYSTONE_NO_NATIVE`` set, or the
    build or load failed: the reason is logged once)."""
    global _LIB, _ERROR
    if env_flag("KEYSTONE_NO_NATIVE", False):
        return None
    if _LIB is not None or _ERROR is not None:
        return _LIB
    with _LOCK:
        if _LIB is None and _ERROR is None:
            try:
                _LIB = _build_and_load()
            except (OSError, RuntimeError) as e:  # no g++, a failed build or load
                _ERROR = str(e)
                logger.warning("native text frontend unavailable, using Python: %s", e)
    return _LIB


def require_lib() -> ctypes.CDLL:
    """The loaded library; raises where :func:`get_lib` would fall back."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native text frontend is unavailable: "
                           f"{_ERROR or 'KEYSTONE_NO_NATIVE is set'}")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def java_string_hash_batch(tokens: Sequence[str]) -> Optional[np.ndarray]:
    """(n,) int32 Java hashCodes of ``tokens``, or None when the library is
    unavailable or a token cannot be encoded as UTF-32 (a lone surrogate:
    the Python path's ord() loop takes it)."""
    lib = get_lib()
    if lib is None:
        return None
    lens = np.fromiter((len(t) for t in tokens), dtype=np.int64, count=len(tokens))
    offsets = np.zeros(len(tokens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    try:
        encoded = "".join(tokens).encode("utf-32-le")
    except UnicodeEncodeError:
        return None
    cps = np.frombuffer(encoded, dtype=np.uint32)
    out = np.empty(len(tokens), dtype=np.int32)
    lib.ks_java_string_hash_batch(_ptr(cps), _ptr(offsets), len(tokens), _ptr(out))
    CALLS["java_string_hash_batch"] += 1
    return out


def text_frontend_batch(docs: Sequence[str], vocab_tokens: Sequence[str], grow: bool,
                        trim: bool = True, lower: bool = True):
    """Trim → lowercase → tokenize → token ids over a corpus of raw strings,
    in one pass (the spec: Trim, LowerCase and Tokenizer of
    ``nodes/nlp/text.py``, then ``packed_features._token_ids``).

    Returns ``(ids int64, tok_doc_offsets int64, new_tokens)``: document
    i's ids are ``ids[off[i]:off[i+1]]``; with ``grow`` the unseen tokens
    get ids from ``len(vocab_tokens)`` in first-seen order and are listed in
    ``new_tokens``, without it they get −1. None when the library is
    unavailable or the corpus or vocabulary is not pure ASCII (the Python
    path's unicode ``\\w`` then applies). An empty corpus returns at once,
    with no document."""
    lib = get_lib()
    if lib is None:
        return None
    if not docs:
        return np.empty(0, dtype=np.int64), np.zeros(1, dtype=np.int64), []
    try:
        blob = "".join(docs).encode("ascii")
        vblob = "".join(vocab_tokens).encode("ascii")
    except UnicodeEncodeError:
        return None
    n_docs = len(docs)
    doc_off = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(d) for d in docs), dtype=np.int64, count=n_docs),
              out=doc_off[1:])
    v_off = np.zeros(len(vocab_tokens) + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(t) for t in vocab_tokens), dtype=np.int64,
                          count=len(vocab_tokens)), out=v_off[1:])
    text_len = int(doc_off[-1])
    cap = text_len + n_docs + 1
    ids = np.empty(cap, dtype=np.int64)
    tok_off = np.zeros(n_docs + 1, dtype=np.int64)
    new_bytes = np.empty(max(text_len, 1), dtype=np.uint8)
    new_off = np.zeros(cap, dtype=np.int64)
    new_count = np.zeros(1, dtype=np.int64)
    tbuf = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, np.uint8)
    vbuf = np.frombuffer(vblob, dtype=np.uint8) if vblob else np.zeros(1, np.uint8)
    ntok = lib.ks_text_frontend(
        _ptr(tbuf), _ptr(doc_off), n_docs,
        int(trim), int(lower),
        _ptr(vbuf), _ptr(v_off), len(vocab_tokens),
        int(grow),
        _ptr(ids), _ptr(tok_off),
        _ptr(new_bytes), _ptr(new_off), _ptr(new_count),
    )
    if ntok < 0:
        raise RuntimeError(f"ks_text_frontend failed ({ntok})")
    CALLS["text_frontend_batch"] += 1
    nc = int(new_count[0])
    nb = new_bytes[: int(new_off[nc])].tobytes().decode("ascii")
    new_tokens = [nb[int(new_off[i]): int(new_off[i + 1])] for i in range(nc)]
    return ids[:ntok], tok_off, new_tokens


def packed_grams_unique(ids_list: Sequence[np.ndarray], orders: Sequence[int]):
    """Per (document, gram) counts over bit-packed n-grams: the native form
    of ``packed_features._corpus_grams`` + ``_per_doc_unique``, with sorts
    per document in place of one over the corpus. Returns ``(d_u, g_u,
    counts)`` in the same document-major, first-emission order, or None
    when the library is unavailable or an order is outside {1, 2, 3}."""
    lib = get_lib()
    if lib is None:
        return None
    n_docs = len(ids_list)
    lens = np.fromiter((len(a) for a in ids_list), dtype=np.int64, count=n_docs)
    tok_off = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(lens, out=tok_off[1:])
    flat = (np.ascontiguousarray(np.concatenate(ids_list), dtype=np.int64)
            if int(tok_off[-1]) else np.zeros(1, dtype=np.int64))
    orders_arr = np.asarray(orders, dtype=np.int32)
    cap = max(sum(int(np.maximum(lens - o + 1, 0).sum()) for o in orders), 1)
    d_u = np.empty(cap, dtype=np.int64)
    g_u = np.empty(cap, dtype=np.int64)
    counts = np.empty(cap, dtype=np.int64)
    m = lib.ks_packed_grams_unique(
        _ptr(flat), _ptr(tok_off), n_docs,
        _ptr(orders_arr), len(orders_arr),
        _ptr(d_u), _ptr(g_u), _ptr(counts),
    )
    if m < 0:  # an unsupported order: the numpy path raises its error
        return None
    CALLS["packed_grams_unique"] += 1
    return d_u[:m], g_u[:m], counts[:m]


def ngram_hash_features_batch(token_hashes: np.ndarray, doc_offsets: np.ndarray,
                              min_order: int, max_order: int, num_features: int,
                              seq_seed: int):
    """NGramsHashingTF's rolling n-gram feature indices as ``(flat features
    int32, out_offsets int64)``, document i's at ``out_offsets[i]:[i+1]``;
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    token_hashes = np.ascontiguousarray(token_hashes, dtype=np.int32)
    doc_offsets = np.ascontiguousarray(doc_offsets, dtype=np.int64)
    n_docs = len(doc_offsets) - 1
    doc_lens = np.diff(doc_offsets)
    # features a document emits: the starts that reach each order, summed
    counts = np.zeros(n_docs, dtype=np.int64)
    for order in range(min_order, max_order + 1):
        counts += np.maximum(doc_lens - order + 1, 0)
    out_offsets = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(counts, out=out_offsets[1:])
    out = np.empty(int(out_offsets[-1]), dtype=np.int32)
    written = lib.ks_ngram_hash_features_batch(
        _ptr(token_hashes), _ptr(doc_offsets), n_docs,
        min_order, max_order, num_features,
        ctypes.c_uint32(seq_seed & 0xFFFFFFFF), _ptr(out_offsets), _ptr(out),
    )
    if written != len(out):
        raise RuntimeError(f"native n-gram feature count {written} != expected {len(out)}")
    CALLS["ngram_hash_features_batch"] += 1
    return out, out_offsets


def doc_slices(ids: np.ndarray, offsets: np.ndarray) -> List[np.ndarray]:
    """Document i's slice ``ids[offsets[i]:offsets[i+1]]`` for each of the
    ``len(offsets) - 1`` documents (none for an empty corpus)."""
    return [ids[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]
