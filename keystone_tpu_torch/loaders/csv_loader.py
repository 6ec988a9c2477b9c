"""The (labels, data) pair of ``keystone_tpu/loaders/csv_loader.py``."""

from __future__ import annotations

from ..data.dataset import Dataset


class LabeledData:
    """A labeled dataset: ``.data`` and ``.labels``."""

    def __init__(self, labels, data):
        self.labels = Dataset.of(labels)
        self.data = Dataset.of(data)

    def __len__(self) -> int:
        return len(self.data)
