"""Binary classifier evaluation (port of ``keystone_tpu/evaluation/binary.py``;
parity: ``evaluation/BinaryClassifierEvaluator.scala``): the contingency
table of boolean predictions against boolean truths, as four counts."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .base import Evaluator, resolve


@dataclass
class BinaryClassificationMetrics:
    tp: float
    fp: float
    tn: float
    fn: float

    def merge(self, other: "BinaryClassificationMetrics") -> "BinaryClassificationMetrics":
        return BinaryClassificationMetrics(self.tp + other.tp, self.fp + other.fp,
                                           self.tn + other.tn, self.fn + other.fn)

    @property
    def total(self) -> float:
        return self.tp + self.fp + self.tn + self.fn

    @property
    def accuracy(self) -> float:
        return (self.tp + self.tn) / self.total

    @property
    def error(self) -> float:
        return (self.fp + self.fn) / self.total

    @property
    def recall(self) -> float:
        return self.tp / (self.tp + self.fn) if (self.tp + self.fn) else 0.0

    @property
    def precision(self) -> float:
        return self.tp / (self.tp + self.fp) if (self.tp + self.fp) else 0.0

    @property
    def specificity(self) -> float:
        return self.tn / (self.fp + self.tn) if (self.fp + self.tn) else 0.0

    def f_score(self, beta: float = 1.0) -> float:
        num = (1.0 + beta * beta) * self.tp
        denom = num + beta * beta * self.fn + self.fp
        return num / denom if denom else 0.0

    def summary(self) -> str:
        return (f"Accuracy:\t{self.accuracy:2.3f}\n"
                f"Precision:\t{self.precision:2.3f}\n"
                f"Recall:\t{self.recall:2.3f}\n"
                f"Specificity:\t{self.specificity:2.3f}\n"
                f"F1:\t{self.f_score():2.3f}")


class BinaryClassifierEvaluator(Evaluator):
    """The contingency table of boolean predictions against actuals."""

    def evaluate(self, predictions, actuals) -> BinaryClassificationMetrics:
        pred = resolve(predictions).astype(bool).ravel()
        act = resolve(actuals).astype(bool).ravel()
        if pred.shape != act.shape:
            raise ValueError("predictions and actuals must align")
        return BinaryClassificationMetrics(
            tp=float(np.sum(pred & act)), fp=float(np.sum(pred & ~act)),
            tn=float(np.sum(~pred & ~act)), fn=float(np.sum(~pred & act)))
