"""Vote-merging evaluation over augmented examples (port of
``keystone_tpu/evaluation/augmented.py``): the crops and flips of one
source image are scored separately, then their scores are merged per
source (``average`` or ``borda``), argmaxed and scored with the multiclass
metrics. Host numpy, as in the JAX package."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from .base import Evaluator, resolve
from .multiclass import MulticlassClassifierEvaluator, MulticlassMetrics


class AugmentedExamplesEvaluator(Evaluator):
    """``names[i]`` identifies the source example of prediction row i."""

    def __init__(self, names: Sequence, num_classes: int,
                 policy: str = "average"):
        if policy not in ("average", "borda"):
            raise ValueError("policy must be 'average' or 'borda'")
        self.names = list(names)
        self.num_classes = num_classes
        self.policy = policy

    @staticmethod
    def _average(preds: np.ndarray) -> np.ndarray:
        return preds.mean(axis=0)

    @staticmethod
    def _borda(preds: np.ndarray) -> np.ndarray:
        # rank positions per augmented copy, summed
        order = np.argsort(preds, axis=1)
        ranks = np.empty_like(order)
        ncols = preds.shape[1]
        np.put_along_axis(
            ranks, order, np.broadcast_to(np.arange(ncols), preds.shape), axis=1
        )
        return ranks.sum(axis=0).astype(np.float64)

    def evaluate(self, predictions: Any, actuals: Any) -> MulticlassMetrics:
        preds = np.asarray(resolve(predictions), dtype=np.float64)
        acts = np.asarray(resolve(actuals)).ravel().astype(np.int64)
        if len(self.names) != preds.shape[0]:
            raise ValueError("names must align with predictions")
        agg = self._borda if self.policy == "borda" else self._average

        groups: dict = {}
        for i, name in enumerate(self.names):
            groups.setdefault(name, []).append(i)
        final_preds, final_actuals = [], []
        for name, idxs in groups.items():
            rows = preds[idxs]
            labels = acts[idxs]
            if len(set(labels.tolist())) != 1:
                raise AssertionError(
                    f"augmented copies of {name!r} have inconsistent labels"
                )
            final_preds.append(agg(rows))
            final_actuals.append(labels[0])
        final = np.argmax(np.stack(final_preds), axis=1)
        return MulticlassClassifierEvaluator(self.num_classes).evaluate(
            final, np.asarray(final_actuals)
        )
