"""Feature hashing with the reference's hashes, bit for bit (port of
``keystone_tpu/nodes/nlp/hashing.py``; parity: ``HashingTF.scala:15-32``,
``NGramsHashingTF.scala:25-146``).

Terms hash as Scala's ``.##``: Java's ``String.hashCode`` for strings and
MurmurHash3's seq hash for n-grams, in 32-bit two's complement. Python
ints do not wrap, so every step masks to 32 bits explicitly, as the JAX
package does. The rolling NGramsHashingTF equals NGramsFeaturizer →
HashingTF exactly, which makes one a test oracle for the other. Batches
hash in the native library (``keystone_tpu_torch/native``) when it is
there; the loops here are the spec.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ... import native
from ...data.dataset import Dataset
from ...data.sparse import SparseRows
from ...workflow.transformer import Transformer

_M32 = 0xFFFFFFFF


def _signed32(x: int) -> int:
    x &= _M32
    return x - (1 << 32) if x >= (1 << 31) else x


def _rotl32(x: int, n: int) -> int:
    x &= _M32
    return ((x << n) | (x >> (32 - n))) & _M32


def java_string_hash(s: str) -> int:
    """``java.lang.String.hashCode`` (Scala's ``"x".##``)."""
    h = 0
    for c in s:
        h = (31 * h + ord(c)) & _M32
    return _signed32(h)


def _mix_last(hash_: int, data: int) -> int:
    k = (data & _M32) * 0xCC9E2D51 & _M32
    k = _rotl32(k, 15)
    k = k * 0x1B873593 & _M32
    return (hash_ ^ k) & _M32


def _mix(hash_: int, data: int) -> int:
    h = _rotl32(_mix_last(hash_, data), 13)
    return (h * 5 + 0xE6546B64) & _M32


def _avalanche(h: int) -> int:
    h &= _M32
    h ^= h >> 16
    h = h * 0x85EBCA6B & _M32
    h ^= h >> 13
    h = h * 0xC2B2AE35 & _M32
    h ^= h >> 16
    return h


def _finalize(hash_: int, length: int) -> int:
    return _signed32(_avalanche(hash_ ^ length))


SEQ_SEED = java_string_hash("Seq")  # scala.util.hashing.MurmurHash3.seqSeed


def murmur3_seq_hash(element_hashes: Sequence[int]) -> int:
    """Scala's MurmurHash3 ``seqHash`` over hashed elements (the ``.##`` of
    an n-gram of strings)."""
    h = SEQ_SEED & _M32
    for eh in element_hashes:
        h = _mix(h, eh)
    return _finalize(h, len(element_hashes))


def scala_hash(term) -> int:
    """Scala's ``.##`` for the terms the reference hashes: strings, ints,
    and sequences of them (n-grams)."""
    if isinstance(term, str):
        return java_string_hash(term)
    if isinstance(term, bool):
        return 1231 if term else 1237
    if isinstance(term, int):
        return _signed32(term)
    if isinstance(term, (tuple, list)):
        return murmur3_seq_hash([scala_hash(t) for t in term])
    return _signed32(hash(term))


def _non_negative_mod(x: int, mod: int) -> int:
    # Python's % of a positive modulus is already non-negative
    return int(_signed32(x)) % mod


def _flat_string_hashes(docs):
    """(hashes int32, doc_offsets int64) of all-string documents by the
    native hasher, else None (other terms take scala_hash's dispatch)."""
    if native.get_lib() is None:
        return None
    flat: List[str] = []
    lens: List[int] = []
    for doc in docs:
        for t in doc:
            if type(t) is not str:
                return None
        flat.extend(doc)
        lens.append(len(doc))
    hashes = native.java_string_hash_batch(flat)
    if hashes is None:
        return None
    doc_offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(np.asarray(lens, dtype=np.int64), out=doc_offsets[1:])
    return hashes, doc_offsets


def _tf_sparse_from_features(feats, doc_offsets, n_docs, num_features) -> SparseRows:
    """Flat per-position feature indices → padded SparseRows: one unique
    over (document, feature) keys counts every document's terms, and rows
    come out sorted by feature index, as the per-item path's
    ``sorted(tf.items())``."""
    from .packed_features import _to_sparse_rows

    doc_ids = np.repeat(np.arange(n_docs, dtype=np.int64), np.diff(doc_offsets))
    u, c = np.unique(doc_ids * num_features + feats.astype(np.int64), return_counts=True)
    return _to_sparse_rows(u // num_features, (u % num_features).astype(np.int64),
                           c.astype(np.float32), n_docs, num_features)


def _native_string_tf_sparse(docs, num_features: int):
    hashed = _flat_string_hashes(docs)
    if hashed is None:
        return None
    hashes, doc_offsets = hashed
    feats = hashes.astype(np.int64) % num_features  # Python's sign rule, as _non_negative_mod
    return _tf_sparse_from_features(feats, doc_offsets, len(docs), num_features)


def _native_ngram_tf_sparse(docs, min_order: int, max_order: int, num_features: int):
    hashed = _flat_string_hashes(docs)
    if hashed is None:
        return None
    hashes, doc_offsets = hashed
    res = native.ngram_hash_features_batch(hashes, doc_offsets, min_order, max_order,
                                           num_features, SEQ_SEED)
    if res is None:
        return None
    flat_feats, out_offsets = res
    return _tf_sparse_from_features(flat_feats, out_offsets, len(docs), num_features)


class HashingTF(Transformer):
    """Term sequence → sparse term-frequency row by the hashing trick."""

    def __init__(self, num_features: int):
        self.num_features = num_features

    def apply(self, document) -> List[Tuple[int, float]]:
        tf = {}
        for term in document:
            i = _non_negative_mod(scala_hash(term), self.num_features)
            tf[i] = tf.get(i, 0.0) + 1.0
        return sorted(tf.items())

    def apply_batch(self, data) -> Dataset:
        docs = [list(doc) for doc in Dataset.of(data)]
        sr = _native_string_tf_sparse(docs, self.num_features)
        if sr is None:
            sr = SparseRows.from_pairs([self.apply(doc) for doc in docs], self.num_features)
        return Dataset(sr)


class NGramsHashingTF(Transformer):
    """Rolling-hash n-gram HashingTF: the output of NGramsFeaturizer(orders)
    → HashingTF, without building the n-grams."""

    def __init__(self, orders: Sequence[int], num_features: int):
        from .ngrams import validate_orders

        orders = validate_orders(orders)
        self.orders = orders
        self.min_order = orders[0]
        self.max_order = orders[-1]
        self.num_features = num_features

    def apply(self, line: Sequence[str]) -> List[Tuple[int, float]]:
        hashes = [java_string_hash(w) for w in line]
        n = len(hashes)
        tf = {}
        for i in range(n - self.min_order + 1):
            h = SEQ_SEED & _M32
            for j in range(i, i + self.min_order):
                h = _mix(h, hashes[j])
            feat = _non_negative_mod(_finalize(h, self.min_order), self.num_features)
            tf[feat] = tf.get(feat, 0.0) + 1.0
            order = self.min_order + 1
            while order <= self.max_order and i + order <= n:
                h = _mix(h, hashes[i + order - 1])
                feat = _non_negative_mod(_finalize(h, order), self.num_features)
                tf[feat] = tf.get(feat, 0.0) + 1.0
                order += 1
        return sorted(tf.items())

    def apply_batch(self, data) -> Dataset:
        docs = [list(doc) for doc in Dataset.of(data)]
        sr = _native_ngram_tf_sparse(docs, self.min_order, self.max_order, self.num_features)
        if sr is None:
            sr = SparseRows.from_pairs([self.apply(doc) for doc in docs], self.num_features)
        return Dataset(sr)
