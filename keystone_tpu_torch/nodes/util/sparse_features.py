"""Sparse feature selection and vectorization (port of
``keystone_tpu/nodes/util/sparse_features.py``; parity:
``CommonSparseFeatures.scala:19-67``, ``AllSparseFeatures.scala:15-28``,
``SparseFeatureVectorizer.scala:7-21``).

The vectorizer emits one padded SparseRows batch (``data/sparse.py``).
CommonSparseFeatures ranks features by (count desc, first appearance asc),
the reference's (frequency, uniqueId) order; AllSparseFeatures keeps them
in first-appearance order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ...data.dataset import Dataset
from ...data.sparse import SparseRows
from ...workflow.transformer import Estimator, Transformer


class SparseFeatureVectorizer(Transformer):
    """(feature, value) pair lists → pairs over the fitted feature space,
    sorted by column; a batch becomes one SparseRows on the CPU."""

    def __init__(self, feature_space: Dict):
        self.feature_space = dict(feature_space)

    @property
    def num_features(self) -> int:
        return len(self.feature_space)

    def apply(self, pairs: Sequence[Tuple]) -> List[Tuple[int, float]]:
        fs = self.feature_space
        return sorted((fs[f], float(v)) for f, v in pairs if f in fs)

    def apply_batch(self, data) -> Dataset:
        rows = [self.apply(doc) for doc in Dataset.of(data)]
        return Dataset(SparseRows.from_pairs(rows, self.num_features))


class CommonSparseFeatures(Estimator):
    """Keep the ``num_features`` most often observed features."""

    def __init__(self, num_features: int):
        self.num_features = num_features

    def fit(self, data: Dataset) -> SparseFeatureVectorizer:
        counts: Dict = {}
        first_seen: Dict = {}
        uid = 0
        for doc in Dataset.of(data):
            for feature, _value in doc:
                counts[feature] = counts.get(feature, 0) + 1
                if feature not in first_seen:
                    first_seen[feature] = uid
                uid += 1
        ranked = sorted(counts, key=lambda f: (-counts[f], first_seen[f]))[: self.num_features]
        return SparseFeatureVectorizer({f: i for i, f in enumerate(ranked)})


class AllSparseFeatures(Estimator):
    """Keep every observed feature, in first-appearance order."""

    def fit(self, data: Dataset) -> SparseFeatureVectorizer:
        feature_space: Dict = {}
        for doc in Dataset.of(data):
            for feature, _value in doc:
                if feature not in feature_space:
                    feature_space[feature] = len(feature_space)
        return SparseFeatureVectorizer(feature_space)
