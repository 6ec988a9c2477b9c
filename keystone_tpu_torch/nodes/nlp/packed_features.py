"""Fused, vectorized text featurization over packed int64 n-grams (port of
``keystone_tpu/nodes/nlp/packed_features.py``).

``PackedTextFeatures(orders, num_features, tf)`` computes what the chain

    NGramsFeaturizer(orders) → TermFrequency(tf) → CommonSparseFeatures(num_features)

computes, as corpus-level numpy programs: token ids pack into one int64 an
n-gram (NaiveBitPackIndexer's 20-bit layout), a document's grams are
counted by one sort over the corpus (or one per document in the native
library), and features rank by (document frequency desc, first appearance
asc), the reference's order, bit for bit. Raw strings also fuse the Trim →
LowerCase → Tokenizer frontend into the native library's one pass.

The whole host chain runs once a corpus: raw strings in, one padded
SparseRows batch out, moved to the vectorizer's ``device`` once.

Limits: orders within {1, 2, 3} (the bit-pack layout) and fewer than 2²⁰
distinct tokens; outside them use the composed chain.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ... import native
from ...data.dataset import Dataset
from ...data.sparse import SparseRows, _round_up
from ...workflow.transformer import Estimator, Transformer
from .indexers import NaiveBitPackIndexer
from .ngrams import validate_orders

_WORD_BITS = 20
_MAX_VOCAB = 1 << _WORD_BITS

#: beyond this token width the fixed-width string lookup costs more memory
#: than it saves (see _token_ids); the dict loop takes over
_MAX_VECTORIZED_TOKEN_LEN = 256


def _vocab_error(size: int) -> ValueError:
    return ValueError(f"vocabulary {size} exceeds the 2^{_WORD_BITS} packed-id limit; "
                      "use the composed NGramsFeaturizer chain")


def _py_tokenize_raw(docs: Sequence[str], trim: bool, lower: bool):
    """Trim → LowerCase → Tokenizer per document in Python: the spec the
    native frontend is held to, and its fallback."""
    from .text import Tokenizer

    tok = Tokenizer()
    out = []
    for d in docs:
        if trim:
            d = d.strip()
        if lower:
            d = d.lower()
        out.append(tok.apply(d))
    return out


def _frontend_ids(docs: Sequence[str], vocab: Dict[str, int], grow: bool, trim: bool,
                  lower: bool, vocab_by_id: List[str]):
    """Raw strings → per-document int64 id arrays by the native frontend, or
    None (the caller takes the Python chain). Grows ``vocab`` with
    ``grow``; ``vocab_by_id`` is ``vocab``'s tokens in id order."""
    res = native.text_frontend_batch(docs, vocab_by_id, grow, trim=trim, lower=lower)
    if res is None:
        return None
    ids_flat, tok_off, new_tokens = res
    if grow:
        base = len(vocab)
        for j, t in enumerate(new_tokens):
            vocab[t] = base + j
        if len(vocab) > _MAX_VOCAB:
            raise _vocab_error(len(vocab))
    return native.doc_slices(ids_flat, tok_off)


def _token_ids_dict(docs: Sequence[Sequence[str]], vocab: Dict[str, int],
                    grow: bool) -> List[np.ndarray]:
    """A dict lookup per token: the path for pathologically wide tokens."""
    out = []
    get = vocab.get
    if grow:
        for doc in docs:
            arr = np.empty(len(doc), dtype=np.int64)
            for i, t in enumerate(doc):
                j = get(t)
                if j is None:
                    j = len(vocab)
                    vocab[t] = j
                arr[i] = j
            out.append(arr)
    else:
        for doc in docs:
            out.append(np.fromiter((get(t, -1) for t in doc), dtype=np.int64, count=len(doc)))
    if len(vocab) > _MAX_VOCAB:
        raise _vocab_error(len(vocab))
    return out


def _sorted_vocab(vocab: Dict[str, int]):
    """(sorted keys, their ids) for the vectorized lookup, or None when a
    key is wider than the fixed-width limit (the lookup would take
    V × max_len × 4 bytes)."""
    if any(len(k) > _MAX_VECTORIZED_TOKEN_LEN for k in vocab):
        return None
    keys = np.asarray(list(vocab.keys()), dtype=str)
    vals = np.asarray(list(vocab.values()), dtype=np.int64)
    sort = np.argsort(keys)
    return keys[sort], vals[sort]


def _token_ids(docs: Sequence[Sequence[str]], vocab: Dict[str, int], grow: bool,
               sorted_vocab=None) -> List[np.ndarray]:
    """Token-list documents → int64 id arrays. ``grow`` extends the
    vocabulary (fit), in first-seen order over the concatenated stream;
    otherwise unknown tokens get −1 (apply). One unique or searchsorted
    over the corpus, equal to the dict loop (feature ties break on id
    order, so the order must not change). ``sorted_vocab``: None builds
    the lookup here, False means the caller found it unsafe."""
    lengths = [len(doc) for doc in docs]
    total = sum(lengths)
    if total == 0:
        return [np.empty(0, dtype=np.int64) for _ in docs]
    # fixed-width '<U' arrays are as wide as the longest token: one huge
    # token would inflate the corpus array, so the dict loop takes over
    if max((len(t) for doc in docs for t in doc), default=0) > _MAX_VECTORIZED_TOKEN_LEN:
        return _token_ids_dict(docs, vocab, grow)
    flat = np.concatenate([np.asarray(doc, dtype=object) for doc in docs]).astype(str)
    if grow:
        base = len(vocab)
        uniq, first_idx, inv = np.unique(flat, return_index=True, return_inverse=True)
        known = (np.fromiter((vocab.get(t, -1) for t in uniq), dtype=np.int64, count=len(uniq))
                 if base else np.full(len(uniq), -1, dtype=np.int64))
        # new tokens get ids by first appearance in the stream
        new_mask = known < 0
        order = np.argsort(first_idx[new_mask], kind="stable")
        lut = known.copy()
        new_ids = np.empty(int(new_mask.sum()), dtype=np.int64)
        new_ids[order] = base + np.arange(len(new_ids))
        lut[new_mask] = new_ids
        for t, j in zip(uniq[new_mask], lut[new_mask]):
            vocab[str(t)] = int(j)
        ids_flat = lut[inv]
    elif not vocab:
        ids_flat = np.full(total, -1, dtype=np.int64)
    else:
        sv = _sorted_vocab(vocab) if sorted_vocab is None else (sorted_vocab or None)
        if sv is None:
            return _token_ids_dict(docs, vocab, grow)
        keys, vals = sv
        pos = np.clip(np.searchsorted(keys, flat), 0, len(keys) - 1)
        ids_flat = np.where(keys[pos] == flat, vals[pos], -1)
    if len(vocab) > _MAX_VOCAB:
        raise _vocab_error(len(vocab))
    return np.split(ids_flat, np.cumsum(lengths)[:-1])


def _corpus_grams(ids_list: List[np.ndarray], orders: Sequence[int]) -> tuple:
    """Every n-gram of every document as flat arrays ``(doc_ids, grams,
    emit_keys)``: one pass per order over the concatenated token stream,
    grams that cross a document boundary masked out. ``emit_keys`` is
    NGramsFeaturizer's emission order (start position, then order), on
    which first-appearance ties rank. A gram holding an OOV id (−1) drops."""
    n_docs = len(ids_list)
    total = sum(len(a) for a in ids_list)
    e = np.empty(0, np.int64)
    if total == 0:
        return e, e, e
    flat = np.concatenate(ids_list)
    lengths = np.fromiter((len(a) for a in ids_list), dtype=np.int64, count=n_docs)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)
    n_orders = len(orders)
    parts_d, parts_g, parts_k = [], [], []
    for oi, order in enumerate(orders):
        if total < order:
            continue
        end = total - order + 1
        windows = np.stack([flat[j: end + j] for j in range(order)], axis=1)
        valid = (windows >= 0).all(axis=1) & (doc_of[:end] == doc_of[order - 1:])
        packed = NaiveBitPackIndexer.pack_batch(windows, order)
        idx = np.flatnonzero(valid)
        parts_d.append(doc_of[idx])
        parts_g.append(packed[idx])
        parts_k.append(idx * n_orders + oi)
    if not parts_d:
        return e, e, e
    return np.concatenate(parts_d), np.concatenate(parts_g), np.concatenate(parts_k)


def _per_doc_unique(doc_ids, flat, emit_keys) -> tuple:
    """(doc_id, gram, count) for each distinct (document, gram) pair,
    document-major, within a document in first-emission order: the
    composed chain's pair stream."""
    order = np.lexsort((flat, doc_ids))
    d_s, g_s, p_s = doc_ids[order], flat[order], emit_keys[order]
    if len(g_s):
        new_group = np.empty(len(g_s), dtype=bool)
        new_group[0] = True
        new_group[1:] = (d_s[1:] != d_s[:-1]) | (g_s[1:] != g_s[:-1])
        starts = np.flatnonzero(new_group)
        counts = np.diff(np.append(starts, len(g_s)))
        first_pos = np.minimum.reduceat(p_s, starts)
        d_u, g_u = d_s[starts], g_s[starts]
    else:
        counts = np.zeros(0, dtype=np.int64)
        first_pos = d_u = g_u = np.zeros(0, dtype=np.int64)
    uid_order = np.lexsort((first_pos, d_u))
    return d_u[uid_order], g_u[uid_order], counts[uid_order]


def _grams_unique(ids_list: List[np.ndarray], orders: Sequence[int]):
    """(d_u, g_u, counts) per distinct (document, gram) pair: the native
    library's pass when it is there, the numpy corpus sort otherwise (the
    two are equal; ``tests/test_torch_text.py``)."""
    res = native.packed_grams_unique(ids_list, orders)
    if res is not None:
        return res
    return _per_doc_unique(*_corpus_grams(ids_list, orders))


def _apply_tf(counts: np.ndarray, fun: Optional[Callable]) -> np.ndarray:
    if fun is None:
        return counts.astype(np.float32)
    distinct = np.unique(counts)
    lut = np.asarray([float(fun(int(c))) for c in distinct], np.float32)
    return lut[np.searchsorted(distinct, counts)]


def _to_sparse_rows(doc_ids: np.ndarray, cols: np.ndarray, values: np.ndarray, n_docs: int,
                    num_features: int) -> SparseRows:
    """Padded SparseRows on the CPU from flat (document, column, value)
    triples, each row sorted by column as SparseFeatureVectorizer sorts."""
    order = np.lexsort((cols, doc_ids))
    d, c, v = doc_ids[order], cols[order], values[order]
    nnz = np.bincount(d, minlength=n_docs).astype(np.int64)
    m = _round_up(int(nnz.max()) if len(nnz) and nnz.max() > 0 else 1)
    indices = np.zeros((n_docs, m), dtype=np.int64)
    vals = np.zeros((n_docs, m), dtype=np.float32)
    offsets = np.concatenate([[0], np.cumsum(nnz)[:-1]]).astype(np.int64)
    slot = np.arange(len(d)) - offsets[d]
    indices[d, slot] = c
    vals[d, slot] = v
    return SparseRows(torch.from_numpy(indices), torch.from_numpy(vals), num_features)


class PackedTextVectorizer(Transformer):
    """The fitted vectorizer: documents (raw strings or token lists) → one
    SparseRows batch over the selected n-grams, on ``device`` (the CPU when
    None)."""

    def __init__(self, vocab: Dict[str, int], selected: np.ndarray, columns: np.ndarray,
                 orders: Sequence[int], tf_fun: Optional[Callable], trim: bool = True,
                 lower: bool = True, device: Optional[str] = None):
        self.vocab = vocab
        self.selected = selected  # sorted packed grams
        self.columns = columns  # each selected gram's column
        self.orders = list(orders)
        self.tf_fun = tf_fun
        # the raw-string frontend's settings (documents given as strings)
        self.trim = trim
        self.lower = lower
        self.device = device
        # the vocabulary in id order, for the native frontend, built lazily
        self._vocab_by_id = None
        # (payload, fingerprint, gram stream) that fit hands over, so the
        # training set's apply skips tokenizing again. The payload is held
        # strongly and compared with ``is`` (an id() could be reused after
        # collection); used once, dropped when pickled
        self._train_cache = None
        # (sorted keys, ids) for the vectorized lookup, built lazily
        self._sorted_vocab = None

    @property
    def num_features(self) -> int:
        return len(self.selected)

    def _ids(self, docs) -> List[np.ndarray]:
        if docs and isinstance(docs[0], str):
            if self._vocab_by_id is None:
                vb: List[str] = [None] * len(self.vocab)
                for t, i in self.vocab.items():
                    vb[i] = t
                self._vocab_by_id = vb
            ids = _frontend_ids(docs, self.vocab, grow=False, trim=self.trim, lower=self.lower,
                                vocab_by_id=self._vocab_by_id)
            if ids is not None:
                return ids
            docs = _py_tokenize_raw(docs, self.trim, self.lower)
        if self._sorted_vocab is None and self.vocab:
            # False: built and unsafe (wide keys), so later calls skip the scan
            self._sorted_vocab = _sorted_vocab(self.vocab) or False
        return _token_ids(docs, self.vocab, grow=False, sorted_vocab=self._sorted_vocab)

    def _match(self, docs, precomputed=None) -> tuple:
        """Flat (doc_ids, columns, tf values) of every selected gram in
        ``docs``, document-major."""
        if precomputed is not None:
            d_u, g_u, counts = precomputed
        else:
            d_u, g_u, counts = _grams_unique(self._ids(docs), self.orders)
        pos = np.clip(np.searchsorted(self.selected, g_u), 0, max(len(self.selected) - 1, 0))
        keep = (self.selected[pos] == g_u) if len(self.selected) else np.zeros(len(g_u), bool)
        return d_u[keep], self.columns[pos[keep]], _apply_tf(counts[keep], self.tf_fun)

    def _vectorize(self, docs, precomputed=None) -> SparseRows:
        d, c, v = self._match(docs, precomputed=precomputed)
        return _to_sparse_rows(d, c, v, len(docs), self.num_features).to(self.device)

    def apply(self, tokens):
        # a pair list keeps zero tf values, which a padded row cannot hold,
        # as SparseFeatureVectorizer.apply of the composed chain does
        one = [tokens] if isinstance(tokens, str) else [list(tokens)]
        _, cols, vals = self._match(one)
        order = np.argsort(cols)
        return [(int(c), float(v)) for c, v in zip(cols[order], vals[order])]

    def apply_batch(self, data) -> Dataset:
        data = Dataset.of(data)
        if self._train_cache is not None:
            payload, fingerprint, (d_u, g_u, counts, n_docs) = self._train_cache
            if payload is data.payload:
                # the one intended hit (fit, then apply to the training
                # set). The fingerprint (documents, total length) catches an
                # in-place change of size since fit; documents without a
                # length (generators, consumed by fit) cannot be featurized
                # again, so the cached grams are the only answer for them
                self._train_cache = None
                n_now, tok_now, sized = 0, 0, True
                for doc in data:
                    if not hasattr(doc, "__len__"):
                        sized = False
                        break
                    n_now += 1
                    tok_now += len(doc)
                if not sized or (n_now, tok_now) == fingerprint:
                    return Dataset(self._vectorize([None] * n_docs,
                                                   precomputed=(d_u, g_u, counts)))
        items = list(data)
        docs = items if items and isinstance(items[0], str) else [list(doc) for doc in items]
        return Dataset(self._vectorize(docs))

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_train_cache"] = None
        state["_sorted_vocab"] = None
        state["_vocab_by_id"] = None
        return state


class PackedTextFeatures(Estimator):
    """NGramsFeaturizer(orders) → TermFrequency(tf) →
    CommonSparseFeatures(num_features), vectorized over the whole corpus.

    Takes token-list documents or raw strings; strings also run Trim →
    LowerCase → Tokenizer, in the native library's one pass when it is
    there. The fitted vectorizer puts its rows on ``device`` (the CPU when
    None)."""

    def __init__(self, orders: Sequence[int], num_features: int,
                 tf_fun: Optional[Callable] = None, trim: bool = True, lower: bool = True,
                 device=None):
        orders = validate_orders(orders)
        if max(orders) > 3:
            raise ValueError("packed path supports orders <= 3; use the composed chain")
        self.orders = orders
        self.num_features = num_features
        self.tf_fun = tf_fun
        self.trim = trim
        self.lower = lower
        self.device = None if device is None else str(device)

    def fit(self, data: Dataset) -> PackedTextVectorizer:
        data = Dataset.of(data)
        items = list(data)
        vocab: Dict[str, int] = {}
        if items and isinstance(items[0], str):
            ids = _frontend_ids(items, vocab, grow=True, trim=self.trim, lower=self.lower,
                                vocab_by_id=[])
            if ids is None:
                ids = _token_ids(_py_tokenize_raw(items, self.trim, self.lower), vocab,
                                 grow=True)
        else:
            items = [list(doc) for doc in items]
            ids = _token_ids(items, vocab, grow=True)
        # over the normalized items (characters of strings, tokens of
        # lists), as the apply's check walks them
        fingerprint = (len(items), sum(len(doc) for doc in items))
        d_u, g_u, counts = _grams_unique(ids, self.orders)
        # document frequency and first-seen uid over the uid-ordered stream
        sel, first_seen, df = np.unique(g_u, return_index=True, return_counts=True)
        chosen = sel[np.lexsort((first_seen, -df))[: self.num_features]]
        sort_order = np.argsort(chosen)
        v = PackedTextVectorizer(vocab, chosen[sort_order],
                                 np.arange(len(chosen), dtype=np.int64)[sort_order],
                                 self.orders, self.tf_fun, trim=self.trim, lower=self.lower,
                                 device=self.device)
        # a pipeline applies the vectorizer to the same training set next:
        # hand the gram stream over, keyed by payload identity
        v._train_cache = (data.payload, fingerprint, (d_u, g_u, counts, len(items)))
        return v
