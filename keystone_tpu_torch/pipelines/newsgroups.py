"""NewsgroupsPipeline (port of ``keystone_tpu/pipelines/newsgroups.py``):
20-class text classification on n-gram term-frequency features,

    Trim → LowerCase → Tokenizer → NGramsFeaturizer(1..nGrams) →
    TermFrequency(x → 1) → CommonSparseFeatures(commonFeatures) →
    NaiveBayesEstimator(numClasses) → MaxClassifier,

scored with the multiclass evaluator. The string stages up to the feature
selection run fused as PackedTextFeatures, on the host (the native
frontend, then corpus-level numpy); its vectorizer emits one SparseRows
batch a corpus, moved to the card once, where naive Bayes fits by one
scatter-add of the class sums and applies by a gather.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .. import device as pick_device
from ..data.dataset import Dataset
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.csv_loader import LabeledData
from ..loaders.text import NEWSGROUPS_CLASSES, load_newsgroups
from ..nodes.learning.classifiers import NaiveBayesEstimator
from ..nodes.nlp.packed_features import PackedTextFeatures
from ..nodes.util import MaxClassifier
from ..workflow.pipeline import Pipeline, clock

NUM_CLASSES = len(NEWSGROUPS_CLASSES)


@dataclass
class NewsgroupsConfig:
    train_location: str = ""
    test_location: str = ""
    n_grams: int = 2
    common_features: int = 100_000
    num_classes: int = NUM_CLASSES


def _term_present(count: int) -> int:
    """TermFrequency's x → 1: a term counts once however often it occurs."""
    return 1


def build_predictor(train_docs, train_labels, conf: NewsgroupsConfig, device=None) -> Pipeline:
    """The unfitted pipeline, fit on ``train_docs`` (raw strings) and
    ``train_labels`` when it is first applied or fitted; features on
    ``device``."""
    dev = pick_device(device)
    return (
        PackedTextFeatures(list(range(1, conf.n_grams + 1)), conf.common_features,
                           _term_present, device=dev)
        .with_data(train_docs)
        .and_then(NaiveBayesEstimator(conf.num_classes), train_docs, train_labels)
        .and_then(MaxClassifier())
    )


def run(train: LabeledData, test: LabeledData, conf: NewsgroupsConfig, device=None,
        timings: Optional[Dict[str, float]] = None):
    """Fit on ``train`` and classify ``test``; returns (predictor,
    evaluation, seconds). ``timings`` gets the fit's seconds
    (``FittedPipeline.seconds``: optimize, featurize, PackedTextFeatures,
    NaiveBayesEstimator, executor), then ``apply`` and ``evaluate``."""
    dev = device if device is not None else pick_device()
    start = clock()
    predictor = build_predictor(train.data, train.labels, conf, dev)
    fitted = predictor.fit()
    fit_end = clock()
    preds = fitted.apply(test.data).to_array()
    apply_end = clock()
    evaluation = MulticlassClassifierEvaluator(conf.num_classes).evaluate(preds, test.labels)
    end = clock()
    if timings is not None:
        timings.update(fitted.seconds)
        timings["apply"] = apply_end - fit_end
        timings["evaluate"] = end - apply_end
    return predictor, evaluation, end - start


def synthetic_newsgroups(n: int, num_classes: int = NUM_CLASSES, seed: int = 0) -> LabeledData:
    """The JAX package's synthetic corpus, the same numpy draws: a class's
    keyword vocabulary mixed with shared filler words."""
    rng = np.random.default_rng(seed)
    shared = [f"word{j}" for j in range(50)]
    docs, labels = [], []
    for _ in range(n):
        c = int(rng.integers(0, num_classes))
        words = [f"class{c}kw{rng.integers(0, 8)}" for _ in range(rng.integers(5, 15))]
        words += [shared[rng.integers(0, 50)] for _ in range(rng.integers(10, 30))]
        rng.shuffle(words)
        docs.append(" ".join(words))
        labels.append(c)
    return LabeledData(np.asarray(labels, dtype=np.int32), Dataset.from_items(docs))


# ---- CLI -----------------------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("NewsgroupsPipeline")
    p.add_argument("app", choices=["NewsgroupsPipeline"])
    p.add_argument("--device", default=None, help="torch device; CUDA unless 'cpu' is named")
    p.add_argument("--trainLocation", default=None)
    p.add_argument("--testLocation", default=None)
    p.add_argument("--nGrams", type=int, default=2)
    p.add_argument("--commonFeatures", type=int, default=100_000)
    p.add_argument("--nTrain", type=int, default=512)
    p.add_argument("--nTest", type=int, default=128)
    return p.parse_args(argv)


def run_app(argv=None) -> dict:
    """Parse the command line and run the application. Without data
    directories it runs on ``synthetic_newsgroups`` (seeds 1 and 2), as the
    JAX CLI does. Returns the evaluation, the test error, the seconds, the
    per-phase seconds (``draw`` included) and the fitted-once predictor."""
    args = parse_args(argv)
    dev = pick_device(args.device)
    conf = NewsgroupsConfig(train_location=args.trainLocation or "",
                            test_location=args.testLocation or "",
                            n_grams=args.nGrams, common_features=args.commonFeatures)
    t0 = clock()
    if args.trainLocation:
        train, test = load_newsgroups(args.trainLocation), load_newsgroups(args.testLocation)
    else:
        train = synthetic_newsgroups(args.nTrain, seed=1)
        test = synthetic_newsgroups(args.nTest, seed=2)
    phases: Dict[str, float] = {"draw": clock() - t0}
    predictor, evaluation, seconds = run(train, test, conf, dev, phases)
    return {"evaluation": evaluation, "test_error": evaluation.total_error,
            "seconds": seconds, "phases": phases, "predictor": predictor}


def main(argv=None) -> int:
    out = run_app(argv)
    print(out["evaluation"].summary(NEWSGROUPS_CLASSES))
    print(f"Pipeline took {out['seconds']} s")
    return 0
