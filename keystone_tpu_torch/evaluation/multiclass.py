"""Multiclass classification metrics (port of
``keystone_tpu/evaluation/multiclass.py``): a confusion matrix and the
per-class, micro and macro statistics derived from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np

from .base import Evaluator, resolve


@dataclass
class BinaryMetrics:
    """Per-class one-vs-rest counts."""

    tp: float
    fp: float
    tn: float
    fn: float

    @property
    def accuracy(self) -> float:
        tot = self.tp + self.fp + self.tn + self.fn
        return (self.tp + self.tn) / tot if tot else 0.0

    @property
    def error(self) -> float:
        return 1.0 - self.accuracy

    @property
    def precision(self) -> float:
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    @property
    def recall(self) -> float:
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def f_score(self, beta: float = 1.0) -> float:
        p, r = self.precision, self.recall
        b2 = beta * beta
        denom = b2 * p + r
        return (1 + b2) * p * r / denom if denom else 0.0

    def merge(self, other: "BinaryMetrics") -> "BinaryMetrics":
        return BinaryMetrics(
            self.tp + other.tp, self.fp + other.fp,
            self.tn + other.tn, self.fn + other.fn,
        )


class MulticlassMetrics:
    """Derived statistics over an (actual, predicted) confusion matrix;
    ``confusion_matrix[actual, predicted]`` counts."""

    def __init__(self, confusion_matrix):
        self.confusion_matrix = np.asarray(confusion_matrix, dtype=np.float64)
        cm = self.confusion_matrix
        self.num_classes = cm.shape[0]
        total = cm.sum()
        actual_sums = cm.sum(axis=1)
        predicted_sums = cm.sum(axis=0)
        self.class_metrics: List[BinaryMetrics] = []
        for c in range(self.num_classes):
            tp = cm[c, c]
            fp = predicted_sums[c] - tp
            tn = total - actual_sums[c] - fp
            fn = total - tp - fp - tn
            self.class_metrics.append(BinaryMetrics(tp, fp, tn, fn))

    def _class_avg(self, f) -> float:
        return sum(f(m) for m in self.class_metrics) / self.num_classes

    def _micro(self, f) -> float:
        merged = self.class_metrics[0]
        for m in self.class_metrics[1:]:
            merged = merged.merge(m)
        return f(merged)

    @property
    def avg_accuracy(self) -> float:
        return self._class_avg(lambda m: m.accuracy)

    @property
    def macro_precision(self) -> float:
        return self._class_avg(lambda m: m.precision)

    @property
    def macro_recall(self) -> float:
        return self._class_avg(lambda m: m.recall)

    def macro_f_score(self, beta: float = 1.0) -> float:
        return self._class_avg(lambda m: m.f_score(beta))

    @property
    def total_accuracy(self) -> float:
        return self._micro(lambda m: m.precision)

    @property
    def total_error(self) -> float:
        return self._micro(
            lambda m: m.fn / (m.fn + m.tp) if (m.fn + m.tp) else 0.0
        )

    @property
    def micro_precision(self) -> float:
        return self._micro(lambda m: m.precision)

    @property
    def micro_recall(self) -> float:
        return self._micro(lambda m: m.recall)

    def micro_f_score(self, beta: float = 1.0) -> float:
        return self._micro(lambda m: m.f_score(beta))

    def summary(self, class_names=None) -> str:
        """Aggregate metrics; with ``class_names``, adds the per-class
        accuracy table."""
        lines = [
            f"total accuracy: {self.total_accuracy:.3f}",
            f"total error: {self.total_error:.3f}",
            f"macro precision: {self.macro_precision:.3f}",
            f"macro recall: {self.macro_recall:.3f}",
            f"macro f1: {self.macro_f_score():.3f}",
        ]
        if class_names is not None:
            for i, name in enumerate(class_names):
                if i >= len(self.class_metrics):
                    break
                m = self.class_metrics[i]
                lines.append(
                    f"  {name}: accuracy {m.accuracy:.3f} "
                    f"precision {m.precision:.3f} recall {m.recall:.3f}"
                )
        return "\n".join(lines)


class MulticlassClassifierEvaluator(Evaluator):
    """Build MulticlassMetrics from predicted and actual int labels."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate(self, predictions: Any, actuals: Any) -> MulticlassMetrics:
        preds = resolve(predictions).astype(np.int64).ravel()
        acts = resolve(actuals).astype(np.int64).ravel()
        if preds.shape[0] != acts.shape[0]:
            raise ValueError("predictions and actuals differ in length")
        k = self.num_classes
        cm = np.bincount(acts * k + preds, minlength=k * k).reshape(k, k)
        return MulticlassMetrics(cm)
