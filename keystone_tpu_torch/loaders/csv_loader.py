"""CSV loading and the (labels, data) pair of
``keystone_tpu/loaders/csv_loader.py``, in numpy: rows split on commas or
whitespace; in a labeled file column 0 is the class label."""

from __future__ import annotations

import numpy as np

from ..data.dataset import Dataset


def load_csv(path: str, dtype=np.float32) -> Dataset:
    """Load a numeric CSV (comma or whitespace separated) as a Dataset of
    rows, on the host."""
    try:
        arr = np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=2)
    except ValueError:
        arr = np.loadtxt(path, dtype=dtype, ndmin=2)
    return Dataset.of(arr)


def load_labeled_csv(path: str, label_offset: int = 0,
                     dtype=np.float32) -> "LabeledData":
    """Column 0 = class label (minus ``label_offset``), the rest features."""
    arr = load_csv(path, dtype=dtype).to_array().numpy()
    labels = arr[:, 0].astype(np.int32) - label_offset
    return LabeledData(labels, np.ascontiguousarray(arr[:, 1:]))


class LabeledData:
    """A labeled dataset: ``.data`` and ``.labels``."""

    def __init__(self, labels, data):
        self.labels = Dataset.of(labels)
        self.data = Dataset.of(data)

    def __len__(self) -> int:
        return len(self.data)
