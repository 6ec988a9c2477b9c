"""RandomPatchCifarKernel (port of the kernel application of
``keystone_tpu/pipelines/cifar_extras.py``): whitened random-patch
convolutional features → StandardScaler → Gauss-Seidel kernel ridge
regression → MaxClassifier.

Data arrives on the host (numpy) and is moved to ``device`` once; every
stage after that runs there. The pipeline is a graph: the optimizer merges
the two estimators' copies of the featurizer, so the fit data is
featurized once, and fuses the four featurizer nodes into one row-local
operator that runs in row chunks. The kernel ridge regression's kernel
blocks go through the K1 CUDA kernel on a CUDA device.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .. import device as pick_device
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.cifar import NCHAN, NROW, load_cifar, synthetic_cifar
from ..loaders.csv_loader import LabeledData
from ..nodes.images.core import (
    Convolver,
    ImageVectorizer,
    Pooler,
    SymmetricRectifier,
)
from ..nodes.learning.kernel import KernelBlockLinearMapper, KernelRidgeRegression
from ..nodes.learning.zca import ZCAWhitener
from ..nodes.stats import StandardScaler, StandardScalerModel
from ..nodes.util import ClassLabelIndicators, MaxClassifier
from ..workflow.pipeline import FittedPipeline, Pipeline, clock
from .random_patch_cifar import RandomCifarConfig, learn_filters

NUM_CLASSES = 10


@dataclass
class KernelCifarConfig(RandomCifarConfig):
    gamma: float = 2e-4
    cache_kernel: bool = True
    block_size: int = 5000
    num_epochs: int = 1
    checkpoint_dir: Optional[str] = None


def _featurizer(filters, whitener, conf: RandomCifarConfig) -> Pipeline:
    return (
        Convolver(filters, NROW, NROW, NCHAN, whitener=whitener,
                  normalize_patches=True)
        .and_then(SymmetricRectifier(alpha=conf.alpha))
        .and_then(Pooler(conf.pool_stride, conf.pool_size, None, "sum"))
        .and_then(ImageVectorizer())
    )


def run_random_patch_cifar_kernel(
    train: LabeledData, test: LabeledData, conf: KernelCifarConfig,
    device: Optional[torch.device] = None,
    timings: Optional[Dict[str, float]] = None,
):
    """Fit on ``train`` and score both sets. Returns (scorer, train_err,
    test_err, seconds): ``scorer`` is the pipeline that ends at the kernel
    model's scores, fitted once (``scorer.fit()`` and the classifier
    ``scorer.and_then(MaxClassifier())`` reuse its fits). ``timings``, when
    given, receives the seconds of each phase: filters, optimize (the rule
    stack of the fit), featurize (fit data), fit (scaler and KRR, with the
    fit's graph bookkeeping) and apply (train and test)."""
    dev = device if device is not None else pick_device()
    start = time.perf_counter()
    X_train = train.data.to_array().to(dev)
    X_test = test.data.to_array().to(dev)
    labels = ClassLabelIndicators(NUM_CLASSES).forward(
        train.labels.to_array().to(dev))
    filters, whitener = learn_filters(X_train, conf)
    t_filters = clock()
    scorer = _featurizer(filters, whitener, conf).and_then(
        StandardScaler(), X_train
    ).and_then(
        KernelRidgeRegression(
            conf.gamma,
            conf.lam or 0.0,
            conf.block_size,
            conf.num_epochs,
            block_permuter=conf.seed,
            cache_kernel=conf.cache_kernel,
            checkpoint_dir=conf.checkpoint_dir,
        ),
        X_train,
        labels,
    )
    pipeline = scorer.and_then(MaxClassifier())
    fitted = pipeline.fit()
    t_fit = clock()
    ev = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_err = ev.evaluate(
        pipeline(X_train).get().to_array(), train.labels
    ).total_error
    test_err = ev.evaluate(
        pipeline(X_test).get().to_array(), test.labels
    ).total_error
    t_apply = clock()
    if timings is not None:
        optimize = fitted.seconds["optimize"]
        featurize = fitted.seconds.get("featurize", 0.0)
        timings.update(
            filters=t_filters - start,
            optimize=optimize,
            featurize=featurize,
            fit=t_fit - t_filters - optimize - featurize,
            apply=t_apply - t_fit,
        )
    return scorer, train_err, test_err, time.perf_counter() - start


def fitted_from_arrays(params: Dict[str, np.ndarray], conf: RandomCifarConfig,
                       device: Optional[torch.device] = None,
                       classify: bool = True) -> FittedPipeline:
    """The fitted RandomPatchCifarKernel pipeline from another fit's
    parameters, as numpy arrays: ``filters``, ``whitener`` and ``means``
    (ZCA), ``scaler_mean`` and ``scaler_std``, ``train_X`` and ``W``
    (KRR), ``gamma`` and ``block_size``. ``conf`` gives the rectifier's
    alpha and the pooling. Its graph is the one ``fit`` leaves: the fused
    featurizer, the scaler, the kernel model and, with ``classify``,
    MaxClassifier; without it the pipeline ends at the scores."""
    dev = device if device is not None else pick_device()

    def t(name):
        return torch.tensor(np.asarray(params[name], np.float32), device=dev)

    whitener = ZCAWhitener(t("whitener"), t("means"))
    head = _featurizer(t("filters"), whitener, conf).fit().and_then(
        StandardScalerModel(t("scaler_mean"), t("scaler_std"))
    ).and_then(
        KernelBlockLinearMapper(t("train_X"), t("W"), float(params["gamma"]),
                                int(params["block_size"]))
    )
    if classify:
        head = head.and_then(MaxClassifier())
    return FittedPipeline(head.graph, head.source, head.sink)


# ---- CLI -----------------------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("CifarExtras")
    p.add_argument("app", choices=["RandomPatchCifarKernel"])
    p.add_argument("--device", default=None,
                   help="torch device; CUDA unless 'cpu' is named")
    p.add_argument("--trainLocation", default=None)
    p.add_argument("--testLocation", default=None)
    p.add_argument("--numFilters", type=int, default=100)
    p.add_argument("--whiteningEpsilon", type=float, default=0.1)
    p.add_argument("--patchSize", type=int, default=6)
    p.add_argument("--poolSize", type=int, default=14)
    p.add_argument("--poolStride", type=int, default=13)
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--gamma", type=float, default=2e-4)
    p.add_argument("--lambda", dest="lam", type=float, default=None)
    p.add_argument("--blockSize", type=int, default=5000)
    p.add_argument("--numEpochs", type=int, default=1)
    p.add_argument("--cacheKernel", type=lambda s: s.lower() == "true",
                   default=True)
    p.add_argument("--checkpointDir", default=None)
    p.add_argument("--nTrain", type=int, default=1024)
    p.add_argument("--nTest", type=int, default=256)
    return p.parse_args(argv)


def run_app(argv=None) -> dict:
    """Parse the command line and run the application. Returns the train
    and test errors, the total seconds, the per-phase seconds and the
    fitted-once scorer pipeline."""
    args = parse_args(argv)
    dev = pick_device(args.device)
    if args.trainLocation:
        train = load_cifar(args.trainLocation)
        test = load_cifar(args.testLocation)
    else:
        train = synthetic_cifar(args.nTrain, seed=1)
        test = synthetic_cifar(args.nTest, seed=2)
    conf = KernelCifarConfig(
        num_filters=args.numFilters,
        whitening_epsilon=args.whiteningEpsilon,
        patch_size=args.patchSize, pool_size=args.poolSize,
        pool_stride=args.poolStride, alpha=args.alpha,
        gamma=args.gamma, lam=args.lam, block_size=args.blockSize,
        num_epochs=args.numEpochs, cache_kernel=args.cacheKernel,
        checkpoint_dir=args.checkpointDir,
    )
    phases: Dict[str, float] = {}
    scorer, tr, te, secs = run_random_patch_cifar_kernel(train, test, conf, dev, phases)
    return {"train_error": tr, "test_error": te, "seconds": secs,
            "phases": phases, "scorer": scorer}


def main(argv=None) -> int:
    out = run_app(argv)
    print(f"Training error is: {out['train_error']}\n"
          f"Test error is: {out['test_error']}")
    print(f"Pipeline took {out['seconds']} s")
    return 0
