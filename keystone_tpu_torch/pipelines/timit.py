"""TimitPipeline (port of ``keystone_tpu/pipelines/timit.py``): phone
classification of pre-featurized TIMIT frames,
gather(numCosines × CosineRandomFeatures(440 → 4096, γ, Gaussian or
Cauchy)) → VectorCombiner → BlockLeastSquaresEstimator(4096, numEpochs,
λ) → MaxClassifier, scored with the multiclass evaluator over 147 classes.

Every step is a GEMM or elementwise. The optimizer fuses the branches, the
gather and the combiner into one row-local operator that writes each row
chunk of the (n, numCosines · 4096) feature matrix into one preallocated
output, so no branch output is ever whole; at the CLI's width (50
branches, d = 204,800) the 50000-row training matrix is 40.96 GB, held
once. The block solve sweeps its 50 column blocks ``numEpochs`` times.
A chunked training set is fitted out of core instead (:func:`run`).
"""

from __future__ import annotations

import argparse
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as pick_device
from ..loaders.csv_loader import LabeledData
from ..loaders.text import TIMIT_DIMENSION, TIMIT_NUM_CLASSES, load_timit_features
from ..nodes.learning.linear import BlockLeastSquaresEstimator
from ..nodes.stats import CosineRandomFeatures
from ..nodes.util import VectorCombiner
from ..workflow.pipeline import FittedPipeline, Pipeline
from .block_app import fit_and_score, fitted_block_model, print_errors

NUM_COSINE_FEATURES = 4096  # features per cosine branch


@dataclass
class TimitConfig:
    train_data: str = ""
    train_labels: str = ""
    test_data: str = ""
    test_labels: str = ""
    num_cosines: int = 50
    gamma: float = 0.05555
    rf_type: str = "gaussian"  # or "cauchy"
    lam: float = 0.0
    num_epochs: int = 5
    num_classes: int = TIMIT_NUM_CLASSES
    input_dim: int = TIMIT_DIMENSION
    cosine_features: int = NUM_COSINE_FEATURES
    seed: int = 123


def _cosine_branch(conf: TimitConfig, i: int, device) -> CosineRandomFeatures:
    """Branch i, drawn with numpy ``default_rng(conf.seed + i)``. Cauchy
    draws (γ·Cauchy W, uniform b) give the Laplacian kernel's features."""
    if conf.rf_type == "cauchy":
        rng = np.random.default_rng(conf.seed + i)
        W = conf.gamma * rng.standard_cauchy((conf.cosine_features, conf.input_dim))
        b = rng.uniform(0.0, 2 * math.pi, conf.cosine_features)
        return CosineRandomFeatures.from_reference(W, b, device)
    return CosineRandomFeatures.create(conf.input_dim, conf.cosine_features, conf.gamma,
                                       seed=conf.seed + i, device=device)


def build_featurizer(conf: TimitConfig, device=None,
                     params: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None) -> Pipeline:
    """The gathered cosine branches and the combiner, on ``device``.
    ``params``, when given, is one (W, b) pair of arrays per branch (such
    as the JAX package's nodes'), used instead of drawing."""
    dev = pick_device(device)
    if params is None:
        branches = [_cosine_branch(conf, i, dev) for i in range(conf.num_cosines)]
    else:
        branches = [CosineRandomFeatures.from_reference(W, b, dev) for W, b in params]
    return Pipeline.gather(branches).and_then(VectorCombiner())


def run(train: LabeledData, test: LabeledData, conf: TimitConfig,
        device: Optional[torch.device] = None,
        timings: Optional[Dict[str, float]] = None,
        params: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None):
    """Fit on ``train`` and score both sets; returns (scorer, train_err,
    test_err, seconds) and fills ``timings`` as
    :func:`~keystone_tpu_torch.pipelines.block_app.fit_and_score` says.
    ``params`` as for :func:`build_featurizer`. ``train.data`` may be a
    ``ChunkedDataset`` (the JAX ``run`` takes one too): the block solve
    then streams it, one scan a block step, and the (n, numCosines · 4096)
    features are never whole."""
    dev = device if device is not None else pick_device()
    return fit_and_score(
        lambda: build_featurizer(conf, dev, params),
        BlockLeastSquaresEstimator(conf.cosine_features, conf.num_epochs, conf.lam),
        train, test, conf.num_classes, dev, timings)


def fitted_from_arrays(params: Dict[str, np.ndarray],
                       device: Optional[torch.device] = None,
                       classify: bool = True) -> FittedPipeline:
    """The fitted TimitPipeline from another fit's parameters, as numpy
    arrays: ``cosine_W`` (numCosines, features, 440), ``cosine_b``
    (numCosines, features), ``W`` (d, k), ``b`` (k,) and ``feature_means``
    (d,). Its graph is the one ``fit`` leaves: the fused featurizer, the
    linear model and, with ``classify``, MaxClassifier."""
    dev = device if device is not None else pick_device()
    branches = list(zip(params["cosine_W"], params["cosine_b"]))
    return fitted_block_model(build_featurizer(TimitConfig(), dev, branches), params, dev,
                              classify)


def synthetic_timit(n: int, num_classes: int, dim: int = TIMIT_DIMENSION,
                    seed: int = 0) -> LabeledData:
    """The JAX package's synthetic task, the same numpy draws: Gaussian
    class prototypes in the 440-dim frame space from a constant seed (so
    train and test share them) plus noise of σ 1.5 drawn from ``seed``."""
    protos = np.random.default_rng(1234).standard_normal((num_classes, dim)).astype(np.float32)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    X = protos[y] + 1.5 * rng.standard_normal((n, dim)).astype(np.float32)
    return LabeledData(y, X)


# ---- CLI -----------------------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("TimitPipeline")
    p.add_argument("app", choices=["TimitPipeline"])
    p.add_argument("--device", default=None,
                   help="torch device; CUDA unless 'cpu' is named")
    p.add_argument("--trainDataLocation", default=None)
    p.add_argument("--trainLabelsLocation", default=None)
    p.add_argument("--testDataLocation", default=None)
    p.add_argument("--testLabelsLocation", default=None)
    p.add_argument("--numCosines", type=int, default=50)
    p.add_argument("--gamma", type=float, default=0.05555)
    p.add_argument("--rfType", default="gaussian", choices=["gaussian", "cauchy"])
    p.add_argument("--lambda", dest="lam", type=float, default=0.0)
    p.add_argument("--numEpochs", type=int, default=5)
    p.add_argument("--numClasses", type=int, default=TIMIT_NUM_CLASSES)
    p.add_argument("--nTrain", type=int, default=2048)
    p.add_argument("--nTest", type=int, default=512)
    return p.parse_args(argv)


def run_app(argv=None) -> dict:
    """Parse the command line and run the application. Returns the train
    and test errors, the total seconds, the per-phase seconds and the
    fitted-once scorer pipeline. Without data files it runs on the
    synthetic task (``synthetic_timit``, seeds 1 and 2), as the JAX CLI
    does."""
    args = parse_args(argv)
    dev = pick_device(args.device)
    conf = TimitConfig(
        train_data=args.trainDataLocation or "",
        train_labels=args.trainLabelsLocation or "",
        test_data=args.testDataLocation or "",
        test_labels=args.testLabelsLocation or "",
        num_cosines=args.numCosines, gamma=args.gamma, rf_type=args.rfType,
        lam=args.lam, num_epochs=args.numEpochs, num_classes=args.numClasses,
    )
    if args.trainDataLocation:
        data = load_timit_features(args.trainDataLocation, args.trainLabelsLocation,
                                   args.testDataLocation, args.testLabelsLocation)
        train, test = data.train, data.test
    else:
        train = synthetic_timit(args.nTrain, conf.num_classes, seed=1)
        test = synthetic_timit(args.nTest, conf.num_classes, seed=2)
    phases: Dict[str, float] = {}
    scorer, tr, te, secs = run(train, test, conf, dev, phases)
    return {"train_error": tr, "test_error": te, "seconds": secs,
            "phases": phases, "scorer": scorer}


def main(argv=None) -> int:
    print_errors(run_app(argv))
    return 0
