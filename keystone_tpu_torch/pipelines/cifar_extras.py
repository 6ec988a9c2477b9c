"""The other CIFAR applications (port of
``keystone_tpu/pipelines/cifar_extras.py``). Each shares the loaders and
the convolutional featurizer of RandomPatchCifar; what differs is the
featurizer's filters and the model after it:

* LinearPixels: GrayScaler → ImageVectorizer → exact linear map.
* RandomCifar: random Gaussian filters, no whitening → the conv stack →
  StandardScaler → exact linear map.
* RandomPatchCifarAugmented: whitened patch filters on 24×24 crops; it
  trains on random crops with random flips and tests on the center and
  corner crops and their flips, whose scores are merged per source image
  (AugmentedExamplesEvaluator).
* RandomPatchCifarKernel: whitened patch features → StandardScaler →
  Gauss-Seidel kernel ridge regression, whose kernel blocks go through the
  K1 CUDA kernel on a CUDA device.

Data arrives on the host (numpy) and is moved to ``device`` once; every
stage after that runs there. Each pipeline is a graph: the optimizer
merges the estimators' copies of the featurizer, so the fit data is
featurized once, and fuses the featurizer nodes into one row-local
operator that runs in row chunks.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .. import device as pick_device
from ..evaluation.augmented import AugmentedExamplesEvaluator
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.cifar import NCHAN
from ..loaders.csv_loader import LabeledData
from ..nodes.images.core import (
    CenterCornerPatcher,
    GrayScaler,
    ImageVectorizer,
    RandomImageTransformer,
    RandomPatcher,
)
from ..nodes.learning.kernel import KernelBlockLinearMapper, KernelRidgeRegression
from ..nodes.learning.linear import BlockLeastSquaresEstimator, LinearMapEstimator
from ..nodes.learning.zca import ZCAWhitener
from ..nodes.stats import StandardScaler, StandardScalerModel
from ..nodes.util import ClassLabelIndicators, MaxClassifier
from ..obs.tracer import layer
from ..workflow.pipeline import FittedPipeline, Pipeline, clock
from .random_patch_cifar import (
    RandomCifarConfig,
    conv_featurizer,
    device_data,
    learn_filters,
    load_or_synthesize,
)

NUM_CLASSES = 10


def _fit_and_score(pipeline: Pipeline, X_train, X_test, train: LabeledData,
                   test: LabeledData, start: float, timings: Optional[Dict[str, float]]):
    """Fit a classifier pipeline and score both sets; (train_err, test_err)
    and the fit and apply seconds into ``timings``."""
    t0 = clock()
    fitted = pipeline.fit()
    t_fit = clock()
    ev = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_err = ev.evaluate(fitted.apply(X_train).to_array(), train.labels).total_error
    test_err = ev.evaluate(fitted.apply(X_test).to_array(), test.labels).total_error
    if timings is not None:
        featurize = fitted.seconds.get("featurize", 0.0)
        timings.update(data=t0 - start, optimize=fitted.seconds["optimize"],
                       featurize=featurize,
                       solve=t_fit - t0 - fitted.seconds["optimize"] - featurize,
                       apply=clock() - t_fit)
    return train_err, test_err


# ---- LinearPixels --------------------------------------------------------

def run_linear_pixels(train: LabeledData, test: LabeledData, lam: Optional[float] = None,
                      device: Optional[torch.device] = None,
                      timings: Optional[Dict[str, float]] = None):
    """Grayscale pixels into an exact linear map. Returns (pipeline,
    train_err, test_err, seconds)."""
    dev = device if device is not None else pick_device()
    start = time.perf_counter()
    X_train, labels = device_data(train, dev)
    X_test = test.data.to_array().to(dev, torch.float32)
    pipeline = (
        GrayScaler()
        .and_then(ImageVectorizer())
        .and_then(LinearMapEstimator(lam), X_train, labels)
        .and_then(MaxClassifier())
    )
    tr, te = _fit_and_score(pipeline, X_train, X_test, train, test, start, timings)
    return pipeline, tr, te, time.perf_counter() - start


# ---- RandomCifar ---------------------------------------------------------

def random_filters(conf: RandomCifarConfig) -> np.ndarray:
    """The random Gaussian filter bank, numpy ``default_rng(conf.seed)``:
    (num_filters, patch_size² · 3) float32, the JAX package's draw."""
    rng = np.random.default_rng(conf.seed)
    return rng.standard_normal(
        (conf.num_filters, conf.patch_size * conf.patch_size * NCHAN)).astype(np.float32)


def run_random_cifar(train: LabeledData, test: LabeledData, conf: RandomCifarConfig,
                     device: Optional[torch.device] = None,
                     timings: Optional[Dict[str, float]] = None):
    """Random Gaussian filters, no whitening, into StandardScaler and an
    exact linear map. Returns (pipeline, train_err, test_err, seconds)."""
    dev = device if device is not None else pick_device()
    start = time.perf_counter()
    X_train, labels = device_data(train, dev)
    X_test = test.data.to_array().to(dev, torch.float32)
    filters = torch.from_numpy(random_filters(conf)).to(dev)
    pipeline = (
        conv_featurizer(filters, None, conf)
        .and_then(StandardScaler(), X_train)
        .and_then(LinearMapEstimator(conf.lam), X_train, labels)
        .and_then(MaxClassifier())
    )
    tr, te = _fit_and_score(pipeline, X_train, X_test, train, test, start, timings)
    return pipeline, tr, te, time.perf_counter() - start


# ---- RandomPatchCifarAugmented ------------------------------------------

@dataclass
class AugmentedCifarConfig(RandomCifarConfig):
    num_random_images_augment: int = 4
    augment_img_size: int = 24
    flip_chance: float = 0.5


#: test crops per image: the four corners and the center, and their flips
TEST_CROPS = 10


def augment_train(X: torch.Tensor, y: np.ndarray, conf: AugmentedCifarConfig):
    """``num_random_images_augment`` random crops of each image, each
    flipped at random (numpy draws of ``conf.seed`` and ``conf.seed + 1``),
    and the labels repeated per crop: (crops, their labels)."""
    patcher = RandomPatcher(conf.num_random_images_augment, conf.augment_img_size,
                            conf.augment_img_size, seed=conf.seed)
    flipper = RandomImageTransformer(conf.flip_chance, seed=conf.seed + 1)
    crops = flipper.apply_batch(patcher.apply_batch(X)).to_array()
    return crops, np.repeat(np.asarray(y), conf.num_random_images_augment)


def run_random_patch_cifar_augmented(train: LabeledData, test: LabeledData,
                                     conf: AugmentedCifarConfig,
                                     device: Optional[torch.device] = None,
                                     timings: Optional[Dict[str, float]] = None):
    """Train on random crops and flips, test on the center and corner crops
    and their flips with the scores merged per source image. Returns
    (scorer, evaluation, seconds): ``scorer`` ends at the block model's
    scores; ``evaluation`` is the merged multiclass metrics."""
    dev = device if device is not None else pick_device()
    start = time.perf_counter()
    X_train = train.data.to_array().to(dev, torch.float32)
    X_test = test.data.to_array().to(dev, torch.float32)
    t0 = clock()
    filters, whitener = learn_filters(X_train, conf)
    train_aug, y_aug = augment_train(X_train, train.labels.to_array().numpy(), conf)
    labels = ClassLabelIndicators(NUM_CLASSES).forward(torch.from_numpy(y_aug).to(dev))
    t_filters = clock()
    sz = conf.augment_img_size
    scorer = conv_featurizer(filters, whitener, conf, size=sz).and_then(
        StandardScaler(), train_aug
    ).and_then(
        BlockLeastSquaresEstimator(4096, 1, conf.lam or 0.0), train_aug, labels,
    )
    fitted = scorer.fit()
    t_fit = clock()
    test_aug = CenterCornerPatcher(sz, sz, horizontal_flips=True).forward(X_test)
    scores = fitted.apply(test_aug).to_array()
    names = np.repeat(np.arange(len(test)), TEST_CROPS)
    evaluation = AugmentedExamplesEvaluator(names.tolist(), NUM_CLASSES, "average").evaluate(
        scores, np.repeat(test.labels.to_array().numpy(), TEST_CROPS))
    if timings is not None:
        featurize = fitted.seconds.get("featurize", 0.0)
        timings.update(data=t0 - start, filters=t_filters - t0,
                       optimize=fitted.seconds["optimize"], featurize=featurize,
                       solve=t_fit - t_filters - fitted.seconds["optimize"] - featurize,
                       apply=clock() - t_fit)
    return scorer, evaluation, time.perf_counter() - start


@dataclass
class KernelCifarConfig(RandomCifarConfig):
    gamma: float = 2e-4
    cache_kernel: bool = True
    block_size: int = 5000
    num_epochs: int = 1
    checkpoint_dir: Optional[str] = None


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
    fit's graph bookkeeping) and apply (train and test). Scoring each set
    is an ``app.score`` layer span (``obs.layer``)."""
    dev = device if device is not None else pick_device()
    start = time.perf_counter()
    X_train = train.data.to_array().to(dev)
    X_test = test.data.to_array().to(dev)
    labels = ClassLabelIndicators(NUM_CLASSES).forward(
        train.labels.to_array().to(dev))
    filters, whitener = learn_filters(X_train, conf)
    t_filters = clock()
    scorer = conv_featurizer(filters, whitener, conf).and_then(
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
    with layer("app.score", set="train"):
        train_err = ev.evaluate(
            pipeline(X_train).get().to_array(), train.labels
        ).total_error
    with layer("app.score", set="test"):
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
    head = conv_featurizer(t("filters"), whitener, conf).fit().and_then(
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
    p.add_argument("app", choices=["LinearPixels", "RandomCifar", "RandomPatchCifarAugmented",
                                   "RandomPatchCifarKernel"])
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
    """Parse the command line and run the application named first. Returns
    the test error, the total seconds and the per-phase seconds; the train
    error and the pipeline (``scorer``, ``pipeline``) where the application
    has them."""
    args = parse_args(argv)
    dev = pick_device(args.device)
    train, test = load_or_synthesize(args.trainLocation, args.testLocation,
                                     args.nTrain, args.nTest)
    phases: Dict[str, float] = {}
    if args.app == "LinearPixels":
        pipe, tr, te, secs = run_linear_pixels(train, test, args.lam, dev, phases)
        return {"train_error": tr, "test_error": te, "seconds": secs, "phases": phases,
                "pipeline": pipe}
    if args.app == "RandomCifar":
        conf = RandomCifarConfig(
            num_filters=args.numFilters, patch_size=args.patchSize,
            pool_size=args.poolSize, pool_stride=args.poolStride,
            alpha=args.alpha, lam=args.lam,
        )
        pipe, tr, te, secs = run_random_cifar(train, test, conf, dev, phases)
        return {"train_error": tr, "test_error": te, "seconds": secs, "phases": phases,
                "pipeline": pipe}
    if args.app == "RandomPatchCifarAugmented":
        conf = AugmentedCifarConfig(
            num_filters=args.numFilters, whitening_epsilon=args.whiteningEpsilon,
            patch_size=args.patchSize, pool_size=args.poolSize,
            pool_stride=args.poolStride, alpha=args.alpha, lam=args.lam,
        )
        scorer, evaluation, secs = run_random_patch_cifar_augmented(train, test, conf, dev,
                                                                    phases)
        return {"test_error": evaluation.total_error, "seconds": secs, "phases": phases,
                "scorer": scorer, "evaluation": evaluation}
    conf = KernelCifarConfig(
        num_filters=args.numFilters,
        whitening_epsilon=args.whiteningEpsilon,
        patch_size=args.patchSize, pool_size=args.poolSize,
        pool_stride=args.poolStride, alpha=args.alpha,
        gamma=args.gamma, lam=args.lam, block_size=args.blockSize,
        num_epochs=args.numEpochs, cache_kernel=args.cacheKernel,
        checkpoint_dir=args.checkpointDir,
    )
    scorer, tr, te, secs = run_random_patch_cifar_kernel(train, test, conf, dev, phases)
    return {"train_error": tr, "test_error": te, "seconds": secs,
            "phases": phases, "scorer": scorer}


def main(argv=None) -> int:
    out = run_app(argv)
    if "train_error" in out:
        print(f"Training error is: {out['train_error']}")
    print(f"Test error is: {out['test_error']}")
    print(f"Pipeline took {out['seconds']} s")
    return 0
