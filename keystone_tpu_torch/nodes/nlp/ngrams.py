"""N-gram featurization, counting and frequency encoding (port of
``keystone_tpu/nodes/nlp/ngrams.py``; parity: ``nodes/nlp/ngrams.scala``
and ``WordFrequencyEncoder.scala``). N-grams are Python tuples; counting
and the vocabulary are host reductions over the corpus."""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

from ...data.dataset import Dataset
from ...workflow.transformer import Estimator, Transformer


def validate_orders(orders: Sequence[int]) -> list:
    """The n-gram orders as a list of consecutive positive ints (shared by
    NGramsFeaturizer and NGramsHashingTF, whose outputs must agree)."""
    orders = list(orders)
    if min(orders) < 1:
        raise ValueError(f"minimum order is not >= 1, found {min(orders)}")
    for a, b in zip(orders, orders[1:]):
        if b != a + 1:
            raise ValueError(f"orders are not consecutive; contains {a} and {b}")
    return orders


class NGramsFeaturizer(Transformer):
    """Token sequence → every n-gram of the consecutive ``orders``, by start
    position, then order."""

    def __init__(self, orders: Sequence[int]):
        orders = validate_orders(orders)
        self.orders = orders
        self.min_order = orders[0]
        self.max_order = orders[-1]

    def apply(self, tokens: Sequence) -> List[tuple]:
        tokens = list(tokens)
        out: List[tuple] = []
        n = len(tokens)
        for i in range(n - self.min_order + 1):
            for order in range(self.min_order, self.max_order + 1):
                if i + order > n:
                    break
                out.append(tuple(tokens[i: i + order]))
        return out


class NGramsCounts(Transformer):
    """Corpus n-gram counts, most frequent first: a dataset of per-document
    n-gram lists in, a dataset of (ngram, count) pairs out. ``mode="noadd"``
    skips the sort."""

    def __init__(self, mode: str = "default"):
        mode = mode.lower()
        if mode not in ("default", "noadd"):
            raise ValueError("`mode` must be `default` or `noAdd`")
        self.mode = mode

    def apply(self, ngram_list: Sequence[tuple]) -> List[Tuple[tuple, int]]:
        return list(Counter(tuple(g) for g in ngram_list).items())

    def apply_batch(self, data) -> Dataset:
        counts: Counter = Counter()
        for doc in Dataset.of(data):
            counts.update(tuple(g) for g in doc)
        items = list(counts.items())
        if self.mode == "default":
            items.sort(key=lambda kv: -kv[1])
        return Dataset.from_items(items)


class WordFrequencyTransformer(Transformer):
    """Token → its frequency rank; out-of-vocabulary → −1."""

    OOV_INDEX = -1

    def __init__(self, word_index: Dict[str, int], unigram_counts: Dict[int, int]):
        self.word_index = dict(word_index)
        self.unigram_counts = dict(unigram_counts)

    def apply(self, words: Sequence[str]) -> List[int]:
        idx = self.word_index
        return [idx.get(w, self.OOV_INDEX) for w in words]


class WordFrequencyEncoder(Estimator):
    """The vocabulary ranked by descending frequency."""

    def fit(self, data: Dataset) -> WordFrequencyTransformer:
        unigrams = NGramsCounts().apply_batch(Dataset.from_items(
            [NGramsFeaturizer([1]).apply(doc) for doc in Dataset.of(data)])).collect()
        word_index = {gram[0]: i for i, (gram, _) in enumerate(unigrams)}
        unigram_counts = {word_index[gram[0]]: cnt for gram, cnt in unigrams}
        return WordFrequencyTransformer(word_index, unigram_counts)
