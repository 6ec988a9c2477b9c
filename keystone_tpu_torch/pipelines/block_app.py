"""What MnistRandomFFT and TimitPipeline share: a gathered random-feature
featurizer, a block least-squares fit and MaxClassifier, scored with the
multiclass evaluator on the train and test sets."""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.csv_loader import LabeledData
from ..nodes.learning.linear import BlockLeastSquaresEstimator, BlockLinearMapper
from ..nodes.util import ClassLabelIndicators, MaxClassifier
from ..obs.tracer import layer
from ..workflow.pipeline import FittedPipeline, Pipeline, clock


def fit_and_score(featurizer: Callable[[], Pipeline], estimator: BlockLeastSquaresEstimator,
                  train: LabeledData, test: LabeledData, num_classes: int,
                  device: torch.device, timings: Optional[Dict[str, float]] = None):
    """Move the data to ``device``, build the featurizer (``featurizer()``),
    fit ``estimator`` on its output and score both sets. Returns (scorer,
    train_err, test_err, seconds): ``scorer`` ends at the linear model's
    scores and is fitted once (``scorer.fit()`` and the classifier
    ``scorer.and_then(MaxClassifier())`` reuse its fit). ``timings``, when
    given, receives the seconds of each phase: data (to the device),
    optimize (the rule stack of the fit), featurize (fit data), solve (the
    block fit), executor (the fit's graph bookkeeping) and apply (train and
    test). Scoring each set is an ``app.score`` layer span (``obs.layer``).

    A chunked ``train.data`` (a ``ChunkedDataset`` whose chunks are made on
    ``device``) goes to the fit as it is: the estimator streams it, so the
    featurized training set is never whole, featurizing happens inside
    the solve's scans, and the train error is one more scan."""
    start = time.perf_counter()
    X_train = train.data
    if not X_train.is_chunked:
        X_train = X_train.to_array().to(device, torch.float32)
    X_test = test.data.to_array().to(device, torch.float32)
    labels = ClassLabelIndicators(num_classes).forward(train.labels.to_array().to(device))
    t_data = clock()
    scorer = featurizer().and_then(estimator, X_train, labels)
    fitted = scorer.and_then(MaxClassifier()).fit()
    t_fit = clock()
    ev = MulticlassClassifierEvaluator(num_classes)
    with layer("app.score", set="train"):
        train_err = ev.evaluate(fitted.apply(X_train).to_array(), train.labels).total_error
    with layer("app.score", set="test"):
        test_err = ev.evaluate(fitted.apply(X_test).to_array(), test.labels).total_error
    t_apply = clock()
    if timings is not None:
        timings.update(
            data=t_data - start,
            optimize=fitted.seconds["optimize"],
            featurize=fitted.seconds.get("featurize", 0.0),
            solve=fitted.seconds.get(type(estimator).__name__, 0.0),
            executor=fitted.seconds["executor"],
            apply=t_apply - t_fit,
        )
    return scorer, train_err, test_err, time.perf_counter() - start


def fitted_block_model(featurizer: Pipeline, params: Dict[str, np.ndarray],
                       device: torch.device, classify: bool = True) -> FittedPipeline:
    """``featurizer`` fitted, then the block model of another fit's ``W``
    (d, k), ``b`` (k,) and ``feature_means`` (d,) and, with ``classify``,
    MaxClassifier: the graph ``fit`` leaves."""

    def t(name):
        return torch.tensor(np.asarray(params[name], np.float32), device=device)

    W = t("W")
    mapper = BlockLinearMapper([W], W.shape[0], b=t("b"), feature_means=[t("feature_means")])
    head = featurizer.fit().and_then(mapper)
    if classify:
        head = head.and_then(MaxClassifier())
    return FittedPipeline(head.graph, head.source, head.sink)


def print_errors(out: dict) -> None:
    print(f"TRAIN Error is {100 * out['train_error']}%")
    print(f"TEST Error is {100 * out['test_error']}%")
    print(f"Pipeline took {out['seconds']} s")
