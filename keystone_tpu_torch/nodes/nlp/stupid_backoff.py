"""Stupid Backoff n-gram language model (port of
``keystone_tpu/nodes/nlp/stupid_backoff.py``; Brants et al., 2007;
parity: ``nodes/nlp/StupidBackoff.scala:25-200``). Scores are relative
frequencies with an α-discounted backoff:

    S(w_i | context) = freq(ngram)/freq(context)        if freq(ngram) > 0
                     = α · S(w_i | shorter context)      otherwise
    S(w_i)           = freq(w_i) / numTokens

The model is host numpy, as in the JAX package: its tables are the size of
the corpus, not of a model, and it has no device version. Two forms:

* :class:`StupidBackoffModel`, a dict keyed by tuples (NGramIndexerImpl),
  scored per query in Python;
* :class:`PackedStupidBackoffModel`, every n-gram of order ≤ 3 one int64
  (NaiveBitPackIndexer) in sorted flat arrays, scored by at most three
  vectorized backoff sweeps (a ``searchsorted`` a level). It scores as the
  dict form does, query for query.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ...data.dataset import Dataset
from ...workflow.transformer import Estimator, Transformer
from .indexers import NaiveBitPackIndexer, NGramIndexerImpl


def score_stupid_backoff(
    ngram: tuple,
    ngram_counts: Dict[tuple, int],
    unigram_counts: Dict, num_tokens: int,
    alpha: float = 0.4,
    accum: float = 1.0,
) -> float:
    """(parity: StupidBackoff.scoreLocally, StupidBackoff.scala:63-95)."""
    indexer = NGramIndexerImpl
    freq = ngram_counts.get(ngram, 0)
    # Unigram queries: the fitted table usually holds orders >= 2 (the
    # pipeline counts 2..n-grams), so fall back to the unigram table.
    if freq == 0 and indexer.ngram_order(ngram) == 1:
        freq = unigram_counts.get(ngram[0], 0)
    while True:
        order = indexer.ngram_order(ngram)
        if order == 1:
            return accum * freq / num_tokens
        if freq != 0:
            context = indexer.remove_current_word(ngram)
            if order != 2:
                context_freq = ngram_counts.get(context, 0)
            else:
                context_freq = unigram_counts.get(context[0], 0)
            return accum * freq / context_freq
        # out-of-corpus ngram: back off
        ngram = indexer.remove_farthest_word(ngram)
        order = indexer.ngram_order(ngram)
        if order != 1:
            freq = ngram_counts.get(ngram, 0)
        else:
            freq = unigram_counts.get(ngram[0], 0)
        accum *= alpha


class StupidBackoffModel(Transformer):
    """Query with ``score(ngram)`` / ``score_batch(ngrams)``
    (parity: StupidBackoffModel, StupidBackoff.scala:100-135; like the
    reference, it is not meant to be chained)."""

    def __init__(self, scores: Dict[tuple, float],
                 ngram_counts: Dict[tuple, int],
                 unigram_counts: Dict, num_tokens: int,
                 alpha: float = 0.4):
        self.scores = scores
        self.ngram_counts = ngram_counts
        self.unigram_counts = unigram_counts
        self.num_tokens = num_tokens
        self.alpha = alpha

    def score(self, ngram: Sequence) -> float:
        return score_stupid_backoff(
            tuple(ngram), self.ngram_counts, self.unigram_counts,
            self.num_tokens, self.alpha,
        )

    def score_batch(self, ngrams: Sequence[Sequence]) -> List[float]:
        return [self.score(g) for g in ngrams]

    def apply(self, x):
        raise TypeError(
            "Doesn't make sense to chain this node; use score(ngram)."
        )


class StupidBackoffEstimator(Estimator):
    """Fit the score table from corpus (ngram, count) pairs
    (parity: StupidBackoffEstimator, StupidBackoff.scala:155-200).

    ``unigram_counts`` maps word → count (the pre-computed unigrams the
    reference also takes as a constructor argument)."""

    def __init__(self, unigram_counts: Dict, alpha: float = 0.4):
        self.unigram_counts = dict(unigram_counts)
        self.alpha = alpha

    def fit(self, data: Dataset) -> StupidBackoffModel:
        data = Dataset.of(data)
        ngram_counts: Dict[tuple, int] = {}
        for ngram, count in data:
            key = tuple(ngram)
            ngram_counts[key] = ngram_counts.get(key, 0) + int(count)
        num_tokens = sum(self.unigram_counts.values())
        scores = {}
        for ngram, freq in ngram_counts.items():
            s = score_stupid_backoff(
                ngram, ngram_counts, self.unigram_counts,
                num_tokens, self.alpha,
            )
            if not (0.0 <= s <= 1.0):
                raise AssertionError(
                    f"score = {s:.4f} not in [0,1], ngram = {ngram}"
                )
            scores[ngram] = s
        return StupidBackoffModel(
            scores, ngram_counts, self.unigram_counts, num_tokens, self.alpha
        )


class PackedStupidBackoffModel(Transformer):
    """Stupid Backoff over NaiveBitPackIndexer-packed int64 arrays.

    Same recursion as :func:`score_stupid_backoff` (parity:
    StupidBackoff.scala:63-95), executed as at most ``max_order`` masked
    vectorized sweeps over the whole query batch: each sweep settles
    unigram queries (freq/numTokens), settles hits (freq/contextFreq via
    one context ``searchsorted``), and backs off the rest (strip the
    farthest word, multiply α in). Agreement with the dict path is exact
    (same operation order per query) — asserted in
    tests/test_torch_text.py.
    """

    def __init__(self, keys: np.ndarray, counts: np.ndarray,
                 uni_ids: np.ndarray, uni_counts: np.ndarray,
                 num_tokens: int, alpha: float = 0.4):
        order = np.argsort(keys, kind="stable")
        self.keys = np.asarray(keys, dtype=np.int64)[order]
        self.counts = np.asarray(counts, dtype=np.int64)[order]
        order = np.argsort(uni_ids, kind="stable")
        self.uni_ids = np.asarray(uni_ids, dtype=np.int64)[order]
        self.uni_counts = np.asarray(uni_counts, dtype=np.int64)[order]
        self.num_tokens = int(num_tokens)
        self.alpha = float(alpha)

    @classmethod
    def from_model(cls, model: StupidBackoffModel) -> "PackedStupidBackoffModel":
        """Build the packed tables from a fitted dict-form model. Orders
        above 3 don't fit the 64-bit packing — the dict form remains the
        only representation there (stated ceiling, module docstring)."""
        if any(len(g) > 3 for g in model.ngram_counts):
            raise ValueError(
                "packed form covers orders <= 3 (NaiveBitPackIndexer); "
                "use the dict-form StupidBackoffModel for higher orders"
            )
        for g in model.ngram_counts:
            if not all(isinstance(w, (int, np.integer)) for w in g):
                raise ValueError(
                    f"packed form needs integer word ids in [0, 2^20) "
                    f"(got {g!r}); encode words first, e.g. via "
                    f"WordFrequencyEncoder"
                )
            break  # one key suffices for the type check — homogeneous
        # Negative ids (e.g. WordFrequencyEncoder's -1 OOV sentinel) would
        # sign-extend into the control bits and corrupt the packed order —
        # reject them here; pack() rejects ids >= 2^20.
        if any(w < 0 for g in model.ngram_counts for w in g):
            raise ValueError(
                "packed form needs non-negative word ids; filter or remap "
                "the -1 unknown-token sentinel before packing"
            )
        items = list(model.ngram_counts.items())
        if items:
            keys = np.fromiter(
                (NaiveBitPackIndexer.pack(g) for g, _ in items),
                dtype=np.int64, count=len(items),
            )
            counts = np.fromiter(
                (c for _, c in items), dtype=np.int64, count=len(items)
            )
        else:  # pragma: no cover - empty corpus
            keys = counts = np.zeros(0, dtype=np.int64)
        uni = list(model.unigram_counts.items())
        uni_ids = np.asarray([w for w, _ in uni], dtype=np.int64)
        uni_counts = np.asarray([c for _, c in uni], dtype=np.int64)
        return cls(keys, counts, uni_ids, uni_counts, model.num_tokens,
                   model.alpha)

    @staticmethod
    def _sorted_probe(keys: np.ndarray, vals: np.ndarray,
                      q: np.ndarray) -> np.ndarray:
        """count-or-0 lookup of q in the sorted (keys, vals) table."""
        if not len(keys):
            return np.zeros(q.shape, dtype=np.int64)
        pos = np.searchsorted(keys, q)
        pos = np.minimum(pos, len(keys) - 1)
        return np.where(keys[pos] == q, vals[pos], 0)

    def _lookup_table(self, q: np.ndarray) -> np.ndarray:
        return self._sorted_probe(self.keys, self.counts, q)

    def _lookup_uni(self, word_ids: np.ndarray) -> np.ndarray:
        return self._sorted_probe(self.uni_ids, self.uni_counts, word_ids)

    def _freq_initial(self, q: np.ndarray, orders: np.ndarray) -> np.ndarray:
        """freq for the ORIGINAL query: the n-gram table first, with the
        dict path's unigram fallback for order-1 queries that miss
        (score_stupid_backoff's pre-loop lookup)."""
        freq = self._lookup_table(q)
        uni = orders == 1
        if uni.any():
            fallback = self._lookup_uni(NaiveBitPackIndexer.farthest_word_batch(q))
            freq = np.where(uni & (freq == 0), fallback, freq)
        return freq

    def _freq_backoff(self, q: np.ndarray, orders: np.ndarray) -> np.ndarray:
        """freq after a backoff step: order-1 results read ONLY the
        unigram table (the dict path's in-loop lookup never consults the
        n-gram table for backed-off unigrams)."""
        uni = orders == 1
        freq = self._lookup_table(q)
        if uni.any():
            freq = np.where(
                uni, self._lookup_uni(NaiveBitPackIndexer.farthest_word_batch(q)), freq
            )
        return freq

    def score_packed(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.int64).copy()
        # Keys holding the -1 OOV sentinel (pack_batch deliberately skips
        # validation) sign-extend to control bits 0xF; order_batch would
        # read order 16 and remove_farthest_word_batch would then alias a
        # REAL bigram key — a wrong score or a spurious "count table
        # inconsistent" error, not a miss. Reject them here; the dict-form
        # model handles such queries via legitimate backoff.
        bad = (q < 0) | (((q >> 60) & 0xF) > 2)
        if bad.any():
            raise ValueError(
                "score_packed: invalid packed key(s) (negative word id / "
                "corrupt control bits — e.g. a -1 OOV sentinel packed by "
                "pack_batch); score such queries via the dict-form model "
                "or filter OOV ids before packing"
            )
        n = len(q)
        accum = np.ones(n, dtype=np.float64)
        score = np.zeros(n, dtype=np.float64)
        done = np.zeros(n, dtype=bool)
        orders = NaiveBitPackIndexer.order_batch(q)
        freq = self._freq_initial(q, orders)
        for _ in range(NaiveBitPackIndexer.max_ngram_order):
            # unigrams: S(w) = freq(w)/numTokens
            m = (orders == 1) & ~done
            score[m] = accum[m] * freq[m] / self.num_tokens
            done |= m
            # hits: S = freq(ngram)/freq(context)
            hit = ~done & (freq != 0)
            if hit.any():
                ctx = NaiveBitPackIndexer.remove_current_word_batch(
                    q[hit], orders[hit]
                )
                cfreq = np.where(
                    orders[hit] == 2,
                    self._lookup_uni(NaiveBitPackIndexer.farthest_word_batch(ctx)),
                    self._lookup_table(ctx),
                )
                if np.any(cfreq == 0):  # fail fast like the dict path
                    raise ZeroDivisionError(
                        "context frequency 0 for a fitted n-gram — the "
                        "count table is inconsistent (missing context)"
                    )
                score[hit] = accum[hit] * freq[hit] / cfreq
                done |= hit
            if done.all():
                break
            # misses: back off to the shorter context, α-discounted
            rest = ~done
            q[rest] = NaiveBitPackIndexer.remove_farthest_word_batch(
                q[rest], orders[rest]
            )
            orders[rest] -= 1
            freq[rest] = self._freq_backoff(q[rest], orders[rest])
            accum[rest] *= self.alpha
        return score

    def score(self, ngram: Sequence) -> float:
        return float(
            self.score_packed(
                np.asarray([NaiveBitPackIndexer.pack(tuple(ngram))])
            )[0]
        )

    def score_batch(self, ngrams: Sequence[Sequence]) -> np.ndarray:
        packed = np.fromiter(
            (NaiveBitPackIndexer.pack(tuple(g)) for g in ngrams),
            dtype=np.int64, count=len(ngrams),
        )
        return self.score_packed(packed)

    def apply(self, x):
        raise TypeError(
            "Doesn't make sense to chain this node; use score(ngram)."
        )
