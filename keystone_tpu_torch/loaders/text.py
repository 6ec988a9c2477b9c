"""Text and speech-feature loaders (port of ``keystone_tpu/loaders/text.py``):
20 Newsgroups as one directory of plain-text documents a class, Amazon
reviews as JSON lines labeled by a rating threshold, and TIMIT's
pre-featurized frames in a CSV with their labels in a sparse "row label"
file, both 1-indexed. All host file work; the documents stay strings."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ..data.dataset import Dataset
from .csv_loader import LabeledData, load_csv

# the 20 Newsgroups classes, which are also the directory names
NEWSGROUPS_CLASSES = (
    "comp.graphics",
    "comp.os.ms-windows.misc",
    "comp.sys.ibm.pc.hardware",
    "comp.sys.mac.hardware",
    "comp.windows.x",
    "rec.autos",
    "rec.motorcycles",
    "rec.sport.baseball",
    "rec.sport.hockey",
    "sci.crypt",
    "sci.electronics",
    "sci.med",
    "sci.space",
    "misc.forsale",
    "talk.politics.misc",
    "talk.politics.guns",
    "talk.politics.mideast",
    "talk.religion.misc",
    "alt.atheism",
    "soc.religion.christian",
)


def load_newsgroups(data_dir: str) -> LabeledData:
    """``data_dir/<class name>/<document files>`` → (class index labels,
    document strings), classes in :data:`NEWSGROUPS_CLASSES` order and
    files sorted by name; a class with no directory is skipped."""
    labels, docs = [], []
    for index, class_name in enumerate(NEWSGROUPS_CLASSES):
        class_dir = os.path.join(data_dir, class_name)
        if not os.path.isdir(class_dir):
            continue
        for fname in sorted(os.listdir(class_dir)):
            fpath = os.path.join(class_dir, fname)
            if not os.path.isfile(fpath):
                continue
            with open(fpath, "r", encoding="utf-8", errors="replace") as f:
                docs.append(f.read())
            labels.append(index)
    return LabeledData(np.asarray(labels, dtype=np.int32), Dataset.from_items(docs))


def load_amazon_reviews(path: str, threshold: float = 3.5) -> LabeledData:
    """JSON-lines reviews with an "overall" rating and a "reviewText" →
    binary labels (1 where the rating is at least ``threshold``) and the
    review strings."""
    labels, docs = [], []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            labels.append(1 if float(rec["overall"]) >= threshold else 0)
            docs.append(rec.get("reviewText", ""))
    return LabeledData(np.asarray(labels, dtype=np.int32), Dataset.from_items(docs))

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
