"""VOC-style mean average precision with 11-point interpolation (port of
``keystone_tpu/evaluation/mean_average_precision.py``): one stable sort per
class on the host; the score matrix is (n_images, n_classes)."""

from __future__ import annotations

from typing import Any

import numpy as np

from .base import Evaluator, resolve


class MeanAveragePrecisionEvaluator(Evaluator):
    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate(self, predictions: Any, actuals: Any) -> np.ndarray:
        """predictions: (n, num_classes) scores; actuals: per-item label sets.
        Returns per-class AP vector (mean of it = MAP)."""
        scores = np.asarray(resolve(predictions), dtype=np.float64)
        actual_sets = [np.atleast_1d(np.asarray(a)) for a in actuals]
        n = scores.shape[0]
        if len(actual_sets) != n:
            raise ValueError("predictions and actuals differ in length")

        gt = np.zeros((n, self.num_classes))
        for i, labels in enumerate(actual_sets):
            gt[i, labels.astype(np.int64)] = 1.0

        aps = np.zeros(self.num_classes)
        for cl in range(self.num_classes):
            order = np.argsort(-scores[:, cl], kind="stable")
            g = gt[order, cl]
            tps = np.cumsum(g)
            fps = np.cumsum(1.0 - g)
            total = g.sum()
            if total == 0:
                aps[cl] = 0.0
                continue
            recalls = tps / total
            precisions = tps / (tps + fps)
            # 11-point interpolated AP at exact x/10 levels: np.arange drifts
            # (0.30000000000000004) and misses exact recalls
            ap = 0.0
            for x in range(11):
                t = x / 10.0
                mask = recalls >= t
                ap += (precisions[mask].max() if mask.any() else 0.0) / 11.0
            aps[cl] = ap
        return aps
