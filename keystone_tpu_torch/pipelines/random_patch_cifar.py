"""RandomPatchCifar (port of ``keystone_tpu/pipelines/random_patch_cifar.py``):
CIFAR-10 with random-patch convolutional features. Sampled patches are
normalized and ZCA-whitened, random whitened patches become the filter
bank, and Convolver → SymmetricRectifier → sum Pooler → ImageVectorizer →
StandardScaler → BlockLeastSquaresEstimator(4096, 1, λ) → MaxClassifier
classify; both sets are scored through the compiled chain
(``apply_compiled``), as the JAX package scores them.

The configuration and ``learn_filters`` here are shared with the other
CIFAR applications (``cifar_extras.py``).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import device as pick_device
from ..data.dataset import Dataset
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.cifar import NCHAN, NROW, load_cifar, synthetic_cifar
from ..loaders.csv_loader import LabeledData
from ..nodes.images.core import (
    Convolver,
    ImageVectorizer,
    Pooler,
    SymmetricRectifier,
    Windower,
    vectorize_images,
)
from ..nodes.learning.linear import BlockLeastSquaresEstimator
from ..nodes.learning.zca import ZCAWhitener, ZCAWhitenerEstimator
from ..nodes.stats import Sampler, StandardScaler
from ..nodes.util import ClassLabelIndicators, MaxClassifier
from ..obs.tracer import layer
from ..utils.stats import normalize_rows
from ..workflow.pipeline import Pipeline, clock

NUM_CLASSES = 10


@dataclass
class RandomCifarConfig:
    train_location: str = ""
    test_location: str = ""
    num_filters: int = 100
    whitening_epsilon: float = 0.1
    patch_size: int = 6
    patch_steps: int = 1
    pool_size: int = 14
    pool_stride: int = 13
    alpha: float = 0.25
    lam: Optional[float] = None
    sample_frac: Optional[float] = None
    whitener_size: int = 100000
    seed: int = 0


def learn_filters(train_images, conf: RandomCifarConfig
                  ) -> Tuple[torch.Tensor, ZCAWhitener]:
    """Sample patches, whiten, pick and scale random filters. Returns
    (filters, whitener).

    The JAX package windows every image and then samples; at CIFAR's size
    that is 36.45M patches (15.7 GB). Here the sampled windows are
    gathered directly: the same numpy draw over the same emission order
    picks the same rows. The whole function is the ``app.filters`` layer
    span (``obs.layer``)."""
    with layer("app.filters"):
        X = Dataset.of(train_images).to_array()
        windower = Windower(conf.patch_steps, conf.patch_size)
        nx, ny = windower.grid(X.shape[1], X.shape[2])
        idx = Sampler(conf.whitener_size, seed=conf.seed).indices(X.shape[0] * nx * ny)
        base = vectorize_images(windower.gather(X, torch.from_numpy(idx)))
        base_mat = normalize_rows(base.float(), 10.0)
        whitener = ZCAWhitenerEstimator(conf.whitening_epsilon).fit_single(base_mat)

        rng = np.random.default_rng(conf.seed)
        pick = rng.choice(
            base_mat.shape[0], size=min(conf.num_filters, base_mat.shape[0]),
            replace=False,
        )
        sample = base_mat[torch.from_numpy(np.sort(pick)).to(base_mat.device)]
        unnorm = whitener.transform(sample)
        norms = torch.sqrt(torch.sum(unnorm * unnorm, dim=1))
        filters = (unnorm / (norms + 1e-10)[:, None]) @ whitener.whitener.T
        return filters, whitener


def conv_featurizer(filters: torch.Tensor, whitener: Optional[ZCAWhitener],
                    conf: RandomCifarConfig, size: int = NROW) -> Pipeline:
    """Convolver (patch-normalized, whitened when a whitener is given) →
    SymmetricRectifier(α) → sum Pooler → ImageVectorizer on size × size
    images: the featurizer every CIFAR application shares."""
    return (
        Convolver(filters, size, size, NCHAN, whitener=whitener, normalize_patches=True)
        .and_then(SymmetricRectifier(alpha=conf.alpha))
        .and_then(Pooler(conf.pool_stride, conf.pool_size, None, "sum"))
        .and_then(ImageVectorizer())
    )


def device_data(data: LabeledData, device: torch.device,
                num_classes: int = NUM_CLASSES) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images, ±1 label indicators) of ``data`` on ``device``."""
    X = data.data.to_array().to(device, torch.float32)
    labels = ClassLabelIndicators(num_classes).forward(data.labels.to_array().to(device))
    return X, labels


def build_pipeline(X_train: torch.Tensor, labels: torch.Tensor,
                   conf: RandomCifarConfig) -> Pipeline:
    """The classifier, fitted lazily on ``X_train`` and ``labels``."""
    filters, whitener = learn_filters(X_train, conf)
    return conv_featurizer(filters, whitener, conf).and_then(
        StandardScaler(), X_train
    ).and_then(
        BlockLeastSquaresEstimator(4096, 1, conf.lam or 0.0), X_train, labels,
    ).and_then(MaxClassifier())


def run(train: LabeledData, test: LabeledData, conf: RandomCifarConfig,
        device: Optional[torch.device] = None,
        timings: Optional[Dict[str, float]] = None):
    """Fit on ``train`` and score both sets through the compiled chain.
    Returns (pipeline, train_err, test_err, seconds). ``timings``, when
    given, receives the seconds of each phase: filters, optimize,
    featurize (fit data), solve (scaler and block fit, with the fit's graph
    bookkeeping) and apply (train and test)."""
    dev = device if device is not None else pick_device()
    start = time.perf_counter()
    if conf.sample_frac is not None:
        rng = np.random.default_rng(conf.seed)
        n = len(train)
        keep = np.sort(rng.choice(n, size=max(1, int(n * conf.sample_frac)), replace=False))
        train = LabeledData(np.asarray(train.labels.to_array())[keep],
                            np.asarray(train.data.to_array())[keep])
    X_train, labels = device_data(train, dev)
    X_test = test.data.to_array().to(dev, torch.float32)
    t0 = clock()
    pipeline = build_pipeline(X_train, labels, conf)
    t_filters = clock()
    fitted = pipeline.fit()
    t_fit = clock()
    ev = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_err = ev.evaluate(fitted.apply_compiled(X_train), train.labels).total_error
    test_err = ev.evaluate(fitted.apply_compiled(X_test), test.labels).total_error
    t_apply = clock()
    if timings is not None:
        featurize = fitted.seconds.get("featurize", 0.0)
        timings.update(data=t0 - start, filters=t_filters - t0,
                       optimize=fitted.seconds["optimize"], featurize=featurize,
                       solve=t_fit - t_filters - fitted.seconds["optimize"] - featurize,
                       apply=t_apply - t_fit)
    return pipeline, train_err, test_err, time.perf_counter() - start


# ---- CLI -----------------------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("RandomPatchCifar")
    p.add_argument("app", choices=["RandomPatchCifar"])
    p.add_argument("--device", default=None,
                   help="torch device; CUDA unless 'cpu' is named")
    p.add_argument("--trainLocation", default=None)
    p.add_argument("--testLocation", default=None)
    p.add_argument("--numFilters", type=int, default=100)
    p.add_argument("--whiteningEpsilon", type=float, default=0.1)
    p.add_argument("--patchSize", type=int, default=6)
    p.add_argument("--patchSteps", type=int, default=1)
    p.add_argument("--poolSize", type=int, default=14)
    p.add_argument("--poolStride", type=int, default=13)
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--lambda", dest="lam", type=float, default=None)
    p.add_argument("--nTrain", type=int, default=4096)
    p.add_argument("--nTest", type=int, default=1024)
    return p.parse_args(argv)


def load_or_synthesize(p_train: Optional[str], p_test: Optional[str], n_train: int,
                       n_test: int) -> Tuple[LabeledData, LabeledData]:
    """CIFAR binaries when a train location is given, else the synthetic
    task (``synthetic_cifar``, seeds 1 and 2), as the JAX CLI does."""
    if p_train:
        if not p_test:
            raise SystemExit("--testLocation is required with --trainLocation")
        return load_cifar(p_train), load_cifar(p_test)
    return synthetic_cifar(n_train, seed=1), synthetic_cifar(n_test, seed=2)


def run_app(argv=None) -> dict:
    """Parse the command line and run the application. Returns the train
    and test errors, the total seconds, the per-phase seconds and the
    pipeline."""
    args = parse_args(argv)
    dev = pick_device(args.device)
    train, test = load_or_synthesize(args.trainLocation, args.testLocation,
                                     args.nTrain, args.nTest)
    conf = RandomCifarConfig(
        num_filters=args.numFilters, whitening_epsilon=args.whiteningEpsilon,
        patch_size=args.patchSize, patch_steps=args.patchSteps,
        pool_size=args.poolSize, pool_stride=args.poolStride, alpha=args.alpha,
        lam=args.lam,
    )
    phases: Dict[str, float] = {}
    pipeline, tr, te, secs = run(train, test, conf, dev, phases)
    return {"train_error": tr, "test_error": te, "seconds": secs,
            "phases": phases, "pipeline": pipeline}


def main(argv=None) -> int:
    out = run_app(argv)
    print(f"Training error is: {out['train_error']}")
    print(f"Test error is: {out['test_error']}")
    print(f"Pipeline took {out['seconds']} s")
    return 0
