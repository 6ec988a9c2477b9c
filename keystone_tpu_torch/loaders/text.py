"""The TIMIT feature loader (port of the TIMIT part of
``keystone_tpu/loaders/text.py``): pre-featurized frames in a CSV and their
labels in a sparse "row label" file, both 1-indexed. The other text
loaders come with the text pipelines."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .csv_loader import LabeledData, load_csv

TIMIT_DIMENSION = 440  # features per frame
TIMIT_NUM_CLASSES = 147  # phone classes


class TimitFeaturesData:
    """The train and test sets of one TIMIT load."""

    def __init__(self, train: LabeledData, test: LabeledData):
        self.train = train
        self.test = test


def _parse_sparse_labels(path: str) -> Dict[int, int]:
    """Lines "row label", rows 1-indexed; returns {0-based row: label}."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[int(parts[0]) - 1] = int(parts[1])
    return out


def load_timit_features(train_data: str, train_labels: str, test_data: str,
                        test_labels: Optional[str] = None) -> TimitFeaturesData:
    """The TIMIT CSVs and label files; labels are shifted to 0-based
    classes. Without ``test_labels`` the test rows take the train labels
    file, as the JAX package does."""

    def one(data_path, labels_path):
        X = load_csv(data_path).to_array().numpy()
        lmap = _parse_sparse_labels(labels_path)
        y = np.asarray([lmap[i] - 1 for i in range(X.shape[0])], dtype=np.int32)
        return LabeledData(y, X)

    return TimitFeaturesData(one(train_data, train_labels),
                             one(test_data, test_labels or train_labels))
