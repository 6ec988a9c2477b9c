"""VOCSIFTFisher (port of ``keystone_tpu/pipelines/voc_sift_fisher.py``):
multi-label VOC classification with dense SIFT and Fisher vectors.

PixelScaler → GrayScaler → SIFTExtractor → [ColumnSampler → ColumnPCA] →
BatchPCATransformer → [ColumnSampler → GMM] → FisherVector →
MatrixVectorizer → NormalizeRows → SignedHellinger → NormalizeRows →
BlockLeastSquaresEstimator(4096, 1, λ), scored per class by mean average
precision. The PCA matrix and the GMM load from CSV files instead of
being fitted when ``pca_file`` and the ``gmm_*_file`` names are given.

Data arrives on the host and is moved to the device once. The PCA is
fitted on sampled columns of the training descriptors and chosen by the
cost model (``ColumnPCAEstimator``); the GMM is seeded by k-means++ and
refined by EM on sampled columns of the projected descriptors. The fused
SIFT group runs in row chunks cut to its bytes (a 256² image gives 23,599
descriptors, 12 MB), so no stage but the cached descriptor stacks is ever
whole.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import device as pick_device
from ..data.dataset import Dataset
from ..evaluation.mean_average_precision import MeanAveragePrecisionEvaluator
from ..nodes.images.core import GrayScaler, PixelScaler
from ..nodes.images.fisher_vector import FisherVector, GMMFisherVectorEstimator
from ..nodes.images.sift import SIFTExtractor
from ..nodes.learning.gmm import GaussianMixtureModel
from ..nodes.learning.linear import BlockLeastSquaresEstimator
from ..nodes.learning.pca import BatchPCATransformer, ColumnPCAEstimator
from ..nodes.stats import ColumnSampler, NormalizeRows, SignedHellingerMapper
from ..nodes.util import Cacher, MatrixVectorizer, MultiClassLabelIndicators
from ..workflow.pipeline import FittedPipeline, Pipeline, clock
from .block_app import fitted_block_model

NUM_CLASSES = 20


@dataclass
class SIFTFisherConfig:
    num_pca_samples: int = 1_000_000
    num_gmm_samples: int = 1_000_000
    vocab_size: int = 16
    desc_dim: int = 24
    lam: float = 0.5
    scale_step: int = 0
    pca_file: Optional[str] = None
    gmm_mean_file: Optional[str] = None
    gmm_var_file: Optional[str] = None
    gmm_wts_file: Optional[str] = None
    seed: int = 0


def sift_featurizer(conf: SIFTFisherConfig) -> Pipeline:
    return (PixelScaler().and_then(GrayScaler()).and_then(Cacher())
            .and_then(SIFTExtractor(scale_step=conf.scale_step)))


def fisher_tail(fisher: Pipeline) -> Pipeline:
    """The Fisher vectors flattened column-major and normalized."""
    return (fisher.and_then(MatrixVectorizer()).and_then(NormalizeRows())
            .and_then(SignedHellingerMapper()).and_then(NormalizeRows()).and_then(Cacher()))


def _op(fitted: FittedPipeline, cls):
    return next(op for op in fitted.graph.operators.values() if isinstance(op, cls))


def run(train_images, train_label_sets, test_images, test_label_sets,
        conf: SIFTFisherConfig, device: Optional[torch.device] = None,
        details: Optional[dict] = None):
    """Fit on the training images (an (n, X, Y, C) batch, uint8 or float in
    [0, 255]) and their label sets, and score the test images. Returns the
    per-class AP vector and the seconds. ``details``, when given, receives
    ``phases`` (seconds of: sift, pca_fit, gmm_samples, seeding, em,
    optimize, featurize, solve, apply, evaluate, and data), the counts
    ``descriptors`` (per image), ``fv_width`` and ``em_iterations``, the
    PCA estimator the cost model chose (``pca_choice``), the fitted
    pipeline (``fitted``), the test scores (``scores``) and, on CUDA, the
    peak device bytes so far at the end of each phase (``peak_bytes``)."""
    dev = device if device is not None else pick_device()
    start = time.perf_counter()
    X_train = torch.as_tensor(np.asarray(train_images)).to(dev)
    X_test = torch.as_tensor(np.asarray(test_images)).to(dev)
    n_train = X_train.shape[0]
    labels = MultiClassLabelIndicators(NUM_CLASSES).apply_batch(
        Dataset.from_items(list(train_label_sets))).to_array().to(dev)
    phases: Dict[str, float] = {}
    peaks: Dict[str, int] = {}
    info: dict = {"phases": phases, "peak_bytes": peaks}

    def done(name: str, since: float) -> float:
        """End phase ``name`` begun at ``since``: its seconds and the peak
        device bytes so far."""
        now = clock()
        phases[name] = now - since
        if X_train.is_cuda:
            peaks[name] = torch.cuda.max_memory_allocated(X_train.device)
        return now

    sift = sift_featurizer(conf)
    mark = done("data", start)

    if conf.pca_file:
        pca_mat = np.loadtxt(conf.pca_file, delimiter=",", ndmin=2).T
        pca_featurizer = sift.and_then(
            BatchPCATransformer(torch.tensor(pca_mat, dtype=torch.float32, device=dev)))
    else:
        descs = sift(X_train).get()
        info["descriptors"] = int(descs.to_array().shape[2])
        mark = done("sift", mark)
        per_img = max(1, conf.num_pca_samples // n_train)
        samples = ColumnSampler(per_img, seed=conf.seed).to_pipeline()(descs).get()
        del descs
        column_pca = ColumnPCAEstimator(conf.desc_dim)
        # the estimator NodeOptimizationRule puts in its place: the sample's
        # shape scaled to every item prices as the whole does
        info["pca_choice"] = type(column_pca.optimize(samples)).__name__
        pca = column_pca.with_data(samples)
        mark = clock()
        pca.fit()
        mark = done("pca_fit", mark)
        pca_featurizer = sift.and_then(pca)
    pca_featurizer = pca_featurizer.and_then(Cacher())

    if conf.gmm_mean_file:
        gmm = GaussianMixtureModel.load(conf.gmm_mean_file, conf.gmm_var_file,
                                        conf.gmm_wts_file, device=dev)
        fisher = pca_featurizer.and_then(FisherVector(gmm))
        # a loaded codebook sets the FV width
        vocab_size = int(gmm.k)
    else:
        feats = pca_featurizer(X_train).get()
        mark = done("gmm_samples", mark)
        per_img = max(1, conf.num_gmm_samples // n_train)
        samples = ColumnSampler(per_img, seed=conf.seed + 1).to_pipeline()(feats).get()
        del feats
        fv = GMMFisherVectorEstimator(conf.vocab_size, max_iterations=20,
                                      min_cluster_size=1).with_data(samples)
        fit_info = _op(fv.fit(), FisherVector).gmm.fit_info
        mark = done("gmm_fit", mark)
        phases.update(seeding=fit_info["seeding"], em=fit_info["em"])
        info["em_iterations"] = fit_info["iterations"]
        fisher = pca_featurizer.and_then(fv)
        vocab_size = conf.vocab_size

    info["fv_width"] = 2 * conf.desc_dim * vocab_size
    predictor = fisher_tail(fisher).and_then(
        BlockLeastSquaresEstimator(4096, 1, conf.lam, num_features=info["fv_width"]),
        X_train, labels)
    mark = clock()
    fitted = predictor.fit()
    mark = done("fit", mark)
    scores = fitted.apply(X_test).to_array()
    mark = done("apply", mark)
    aps = MeanAveragePrecisionEvaluator(NUM_CLASSES).evaluate(scores, list(test_label_sets))
    phases.update(optimize=fitted.seconds["optimize"],
                  featurize=fitted.seconds.get("featurize", 0.0),
                  solve=fitted.seconds.get("BlockLeastSquaresEstimator", 0.0),
                  executor=fitted.seconds["executor"],
                  evaluate=time.perf_counter() - mark)
    info.update(fitted=fitted, scores=scores)
    if details is not None:
        details.update(info)
    return aps, time.perf_counter() - start


def fitted_from_arrays(params: Dict[str, np.ndarray], conf: SIFTFisherConfig,
                       device: Optional[torch.device] = None,
                       classify: bool = False) -> FittedPipeline:
    """The fitted VOCSIFTFisher pipeline from another fit's parameters, as
    numpy arrays: ``pca_mat`` (128, descDim), ``gmm_means`` and
    ``gmm_variances`` (descDim, vocabSize), ``gmm_weights`` (vocabSize,),
    and the block model's ``W`` (d, 20), ``b`` (20,) and ``feature_means``
    (d,). Its graph is the one ``fit`` leaves, ending at the scores (or,
    with ``classify``, at MaxClassifier)."""
    dev = device if device is not None else pick_device()

    def t(name):
        return torch.tensor(np.asarray(params[name], np.float32), device=dev)

    gmm = GaussianMixtureModel(t("gmm_means"), t("gmm_variances"), t("gmm_weights"))
    featurizer = fisher_tail(sift_featurizer(conf).and_then(BatchPCATransformer(t("pca_mat")))
                             .and_then(Cacher()).and_then(FisherVector(gmm)))
    return fitted_block_model(featurizer, params, dev, classify)


def synthetic_voc(n: int, size: int = 64, seed: int = 0):
    """The JAX package's synthetic task, the same numpy draws: each image
    overlays 1–3 class-specific oriented gratings on random quarter-size
    regions of a noisy gray field, so the class signal is in local
    gradients. Returns ((n, size, size, 3) float32 images, label sets)."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    images = np.zeros((n, size, size, 3), dtype=np.float32)
    label_sets: List[np.ndarray] = []
    for i in range(n):
        k = int(rng.integers(1, 4))
        labels = rng.choice(NUM_CLASSES, size=k, replace=False)
        img = 64.0 + 8.0 * rng.standard_normal((size, size))
        for cl in labels:
            freq = 0.12 + 0.035 * (cl % 10)
            theta = np.pi * cl / NUM_CLASSES
            wave = 96.0 * np.sin(
                2 * np.pi * freq * (np.cos(theta) * xx + np.sin(theta) * yy)
                + rng.uniform(0, 2 * np.pi)
            )
            x0, y0 = rng.integers(0, size // 2, 2)
            mask = np.zeros((size, size))
            mask[x0:x0 + size // 2, y0:y0 + size // 2] = 1.0
            img = img + wave * mask
        images[i] = np.clip(img, 0, 255)[..., None].repeat(3, axis=-1)
        label_sets.append(np.sort(labels))
    return images, label_sets


# ---- CLI -----------------------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("VOCSIFTFisher")
    p.add_argument("app", choices=["VOCSIFTFisher"])
    p.add_argument("--device", default=None,
                   help="torch device; CUDA unless 'cpu' is named")
    p.add_argument("--trainLocation", default=None, help="VOC image tar (or dir of tars)")
    p.add_argument("--testLocation", default=None)
    p.add_argument("--labelPath", default=None, help="VOC labels CSV")
    p.add_argument("--testLabelPath", default=None)
    p.add_argument("--namePrefix", default="VOCdevkit/VOC2007/JPEGImages/")
    p.add_argument("--imageSize", type=int, default=256)
    p.add_argument("--vocabSize", type=int, default=16)
    p.add_argument("--descDim", type=int, default=24)
    p.add_argument("--lambda", dest="lam", type=float, default=0.5)
    p.add_argument("--numPcaSamples", type=int, default=100_000)
    p.add_argument("--numGmmSamples", type=int, default=100_000)
    p.add_argument("--scaleStep", type=int, default=0)
    p.add_argument("--pcaFile", default=None)
    p.add_argument("--gmmMeanFile", default=None)
    p.add_argument("--gmmVarFile", default=None)
    p.add_argument("--gmmWtsFile", default=None)
    p.add_argument("--nTrain", type=int, default=256)
    p.add_argument("--nTest", type=int, default=64)
    return p.parse_args(argv)


def run_app(argv=None) -> dict:
    """Parse the command line and run the application. Without a train
    location it runs on ``synthetic_voc`` (seeds 1 and 2) at 64 px
    whatever ``--imageSize`` says, as the JAX CLI does. Returns the APs,
    their mean (``map``), the seconds and the ``details`` of :func:`run`."""
    args = parse_args(argv)
    dev = pick_device(args.device)
    conf = SIFTFisherConfig(
        num_pca_samples=args.numPcaSamples, num_gmm_samples=args.numGmmSamples,
        vocab_size=args.vocabSize, desc_dim=args.descDim, lam=args.lam,
        scale_step=args.scaleStep, pca_file=args.pcaFile, gmm_mean_file=args.gmmMeanFile,
        gmm_var_file=args.gmmVarFile, gmm_wts_file=args.gmmWtsFile,
    )
    if args.trainLocation:
        from ..loaders.images import load_voc

        size = (args.imageSize, args.imageSize)
        train = load_voc(args.trainLocation, args.labelPath, name_prefix=args.namePrefix,
                         size=size)
        test = load_voc(args.testLocation or args.trainLocation,
                        args.testLabelPath or args.labelPath,
                        name_prefix=args.namePrefix, size=size)
        tr_imgs, tr_labels = train.data.to_array().numpy(), train.labels
        te_imgs, te_labels = test.data.to_array().numpy(), test.labels
    else:
        tr_imgs, tr_labels = synthetic_voc(args.nTrain, seed=1)
        te_imgs, te_labels = synthetic_voc(args.nTest, seed=2)
    details: dict = {}
    aps, seconds = run(tr_imgs, tr_labels, te_imgs, te_labels, conf, dev, details)
    return {"aps": aps, "map": float(aps.mean()), "seconds": seconds,
            "phases": details["phases"], "details": details}


def main(argv=None) -> int:
    out = run_app(argv)
    aps = out["aps"]
    for i, ap in enumerate(aps):
        print(f"Class {i} avg precision: {ap}")
    print(f"TEST APs are: {aps}")
    print(f"Mean Average Precision: {out['map']}")
    print(f"Pipeline took {out['seconds']} s")
    return 0
