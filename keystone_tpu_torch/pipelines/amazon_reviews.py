"""AmazonReviewsPipeline (port of
``keystone_tpu/pipelines/amazon_reviews.py``): binary sentiment of product
reviews on n-gram term-frequency features,

    Trim → LowerCase → Tokenizer → NGramsFeaturizer(1..nGrams) →
    TermFrequency(x → 1) → CommonSparseFeatures(commonFeatures) →
    LogisticRegressionEstimator(2, numIters),

scored with the binary evaluator. As in NewsgroupsPipeline the string
stages run fused on the host as PackedTextFeatures and emit one SparseRows
batch a corpus, moved to the card once; the logistic regression's L-BFGS
evaluates its gradient there (a gather forward, a scatter-add back).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .. import device as pick_device
from ..data.dataset import Dataset
from ..evaluation.binary import BinaryClassifierEvaluator
from ..loaders.csv_loader import LabeledData
from ..loaders.text import load_amazon_reviews
from ..nodes.learning.classifiers import LogisticRegressionEstimator
from ..nodes.nlp.packed_features import PackedTextFeatures
from ..workflow.pipeline import Pipeline, clock
from .newsgroups import _term_present


@dataclass
class AmazonReviewsConfig:
    train_location: str = ""
    test_location: str = ""
    threshold: float = 3.5
    n_grams: int = 2
    common_features: int = 100_000
    num_iters: int = 20


def build_predictor(train_docs, train_labels, conf: AmazonReviewsConfig,
                    device=None) -> Pipeline:
    """The unfitted pipeline (raw strings → predicted class), fit on
    ``train_docs`` and ``train_labels`` when first applied or fitted;
    features on ``device``."""
    dev = pick_device(device)
    return (
        PackedTextFeatures(list(range(1, conf.n_grams + 1)), conf.common_features,
                           _term_present, device=dev)
        .with_data(train_docs)
        .and_then(LogisticRegressionEstimator(2, num_iters=conf.num_iters),
                  train_docs, train_labels)
    )


def run(train: LabeledData, test: LabeledData, conf: AmazonReviewsConfig, device=None,
        timings: Optional[Dict[str, float]] = None):
    """Fit on ``train`` and classify ``test``; returns (predictor, binary
    metrics, seconds) and fills ``timings`` as the Newsgroups ``run``
    does."""
    dev = device if device is not None else pick_device()
    start = clock()
    predictor = build_predictor(train.data, train.labels, conf, dev)
    fitted = predictor.fit()
    fit_end = clock()
    preds = fitted.apply(test.data).to_array()
    apply_end = clock()
    actual = test.labels.to_array()
    evaluation = BinaryClassifierEvaluator().evaluate(preds > 0, actual > 0)
    end = clock()
    if timings is not None:
        timings.update(fitted.seconds)
        timings["apply"] = apply_end - fit_end
        timings["evaluate"] = end - apply_end
    return predictor, evaluation, end - start


def synthetic_reviews(n: int, seed: int = 0) -> LabeledData:
    """The JAX package's synthetic reviews, the same numpy draws: positive
    or negative keywords among filler words."""
    rng = np.random.default_rng(seed)
    pos = ["great", "excellent", "love", "perfect", "wonderful", "best"]
    neg = ["terrible", "awful", "hate", "broken", "worst", "refund"]
    filler = [f"item{j}" for j in range(40)]
    docs, labels = [], []
    for _ in range(n):
        y = int(rng.integers(0, 2))
        kw = pos if y else neg
        words = [kw[rng.integers(0, len(kw))] for _ in range(rng.integers(2, 6))]
        words += [filler[rng.integers(0, len(filler))] for _ in range(rng.integers(8, 20))]
        rng.shuffle(words)
        docs.append(" ".join(words))
        labels.append(y)
    return LabeledData(np.asarray(labels, dtype=np.int32), Dataset.from_items(docs))


# ---- CLI -----------------------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("AmazonReviewsPipeline")
    p.add_argument("app", choices=["AmazonReviewsPipeline"])
    p.add_argument("--device", default=None, help="torch device; CUDA unless 'cpu' is named")
    p.add_argument("--trainLocation", default=None)
    p.add_argument("--testLocation", default=None)
    p.add_argument("--threshold", type=float, default=3.5)
    p.add_argument("--nGrams", type=int, default=2)
    p.add_argument("--commonFeatures", type=int, default=100_000)
    p.add_argument("--numIters", type=int, default=20)
    p.add_argument("--nTrain", type=int, default=512)
    p.add_argument("--nTest", type=int, default=128)
    return p.parse_args(argv)


def run_app(argv=None) -> dict:
    """Parse the command line and run the application; without data files
    on ``synthetic_reviews`` (seeds 1 and 2), as the JAX CLI does. Returns
    the metrics, the accuracy, the seconds, the per-phase seconds
    (``draw`` included) and the fitted-once predictor."""
    args = parse_args(argv)
    dev = pick_device(args.device)
    conf = AmazonReviewsConfig(train_location=args.trainLocation or "",
                               test_location=args.testLocation or "",
                               threshold=args.threshold, n_grams=args.nGrams,
                               common_features=args.commonFeatures, num_iters=args.numIters)
    t0 = clock()
    if args.trainLocation:
        train = load_amazon_reviews(args.trainLocation, conf.threshold)
        test = load_amazon_reviews(args.testLocation, conf.threshold)
    else:
        train, test = synthetic_reviews(args.nTrain, seed=1), synthetic_reviews(args.nTest, seed=2)
    phases: Dict[str, float] = {"draw": clock() - t0}
    predictor, evaluation, seconds = run(train, test, conf, dev, phases)
    return {"evaluation": evaluation, "accuracy": evaluation.accuracy, "seconds": seconds,
            "phases": phases, "predictor": predictor}


def main(argv=None) -> int:
    out = run_app(argv)
    print(out["evaluation"].summary())
    print(f"Pipeline took {out['seconds']} s")
    return 0
