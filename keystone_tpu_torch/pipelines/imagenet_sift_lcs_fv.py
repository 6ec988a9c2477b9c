"""ImageNetSiftLcsFV (port of ``keystone_tpu/pipelines/imagenet_sift_lcs_fv.py``;
parity: ``ImageNetSiftLcsFV.scala``): two gathered Fisher-vector branches,
SIFT and LCS, into the class-weighted block solver, scored by top-5 error.

    SIFT branch:  PixelScaler → GrayScaler → SIFTExtractor(scaleStep) →
                  SignedHellinger → [ColumnSampler → ColumnPCA] →
                  BatchPCATransformer → [ColumnSampler → GMM] → FisherVector →
                  MatrixVectorizer → NormalizeRows → SignedHellinger →
                  NormalizeRows
    LCS branch:   LCSExtractor(stride, border, patch) → (the same tail)
    join:         gather → VectorCombiner →
                  BlockWeightedLeastSquaresEstimator(4096, 1, λ, w) →
                  TopKClassifier(5)

Each branch's PCA and GMM are fitted before the predictor is built (or
loaded from CSV files): its descriptors of the training images are made
once, both samples are drawn from them (the PCA sample with ``seed``, the
GMM sample with ``seed + 1``), the PCA is fitted on the first and the GMM
on the projection of the second. The descriptor stacks are then freed,
and the predictor's branches are transformers only: the fit runs pixels
to Fisher vectors as one fused group in row chunks cut to its bytes.

Out of core, the training images are a ``ChunkedDataset`` (such as
:func:`synthetic_imagenet_device`'s, drawn on the card chunk by chunk):
each branch draws both its samples in one featurize scan, each chunk's
columns keyed by (seed, chunk index), so the descriptor stacks of the
training set are never whole; the fit then zips the branches' Fisher
vectors per chunk, and the weighted solver caches them when they fit the
budget (one more scan) or streams them.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import device as pick_device
from ..data.chunked import ChunkedDataset
from ..data.dataset import Dataset
from ..nodes.images.core import GrayScaler, PixelScaler
from ..nodes.images.fisher_vector import FisherVector, GMMFisherVectorEstimator
from ..nodes.images.lcs import LCSExtractor
from ..nodes.images.sift import SIFTExtractor
from ..nodes.learning.gmm import GaussianMixtureModel
from ..nodes.learning.linear import BlockLinearMapper
from ..nodes.learning.pca import BatchPCATransformer, ColumnPCAEstimator
from ..nodes.learning.weighted import BlockWeightedLeastSquaresEstimator
from ..nodes.stats import ColumnSampler, NormalizeRows, SignedHellingerMapper
from ..nodes.util import (
    Cacher,
    ClassLabelIndicators,
    MatrixVectorizer,
    TopKClassifier,
    VectorCombiner,
)
from ..utils.timing import phase
from ..workflow.pipeline import FittedPipeline, Pipeline, clock

NUM_CLASSES = 1000
BLOCK_SIZE = 4096
TOP_K = 5


@dataclass
class ImageNetSiftLcsFVConfig:
    """The reference's settings (``ImageNetSiftLcsFV.scala:146-167``)."""

    lam: float = 6e-5
    mixture_weight: float = 0.25
    desc_dim: int = 64
    vocab_size: int = 16
    sift_scale_step: int = 1
    lcs_stride: int = 4
    lcs_border: int = 16
    lcs_patch: int = 6
    num_pca_samples: int = 10_000_000
    num_gmm_samples: int = 10_000_000
    num_classes: int = NUM_CLASSES
    sift_pca_file: Optional[str] = None
    sift_gmm_mean_file: Optional[str] = None
    sift_gmm_var_file: Optional[str] = None
    sift_gmm_wts_file: Optional[str] = None
    lcs_pca_file: Optional[str] = None
    lcs_gmm_mean_file: Optional[str] = None
    lcs_gmm_var_file: Optional[str] = None
    lcs_gmm_wts_file: Optional[str] = None
    seed: int = 0


def sift_prefix(conf: ImageNetSiftLcsFVConfig) -> Pipeline:
    return (PixelScaler().and_then(GrayScaler())
            .and_then(SIFTExtractor(scale_step=conf.sift_scale_step))
            .and_then(SignedHellingerMapper()).and_then(Cacher()))


def lcs_prefix(conf: ImageNetSiftLcsFVConfig) -> Pipeline:
    return LCSExtractor(conf.lcs_stride, conf.lcs_border, conf.lcs_patch).to_pipeline().and_then(
        Cacher())


def fisher_tail(fisher: Pipeline) -> Pipeline:
    """The Fisher vectors flattened column-major and normalized."""
    return (fisher.and_then(MatrixVectorizer()).and_then(NormalizeRows())
            .and_then(SignedHellingerMapper()).and_then(NormalizeRows()))


def codebook_tail(pca_mat: torch.Tensor, gmm: GaussianMixtureModel) -> Pipeline:
    """A branch after its descriptor prefix: the PCA projection, the Fisher
    vectors under ``gmm`` and :func:`fisher_tail`."""
    return fisher_tail(BatchPCATransformer(pca_mat).to_pipeline().and_then(FisherVector(gmm)))


class _Phases:
    """Seconds of the named phases of a run, summed over the branches, and
    on CUDA the peak device bytes so far at each phase's end."""

    def __init__(self, device: torch.device, start: Optional[float] = None):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self.peaks: Dict[str, int] = {}
        self.mark = clock() if start is None else start

    def done(self, name: str) -> None:
        now = clock()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.mark
        if self.device.type == "cuda":
            self.peaks[name] = torch.cuda.max_memory_allocated(self.device)
        self.mark = now


def _images(images, device: torch.device):
    """Training or test images as the pipeline takes them: a chunked
    dataset as it is, anything else a tensor on ``device``."""
    if getattr(images, "is_chunked", False):
        return images
    return torch.as_tensor(images).to(device)


def compute_pca_fisher_branch(prefix: Pipeline, train_images, *,
                              num_col_samples_per_image: int,
                              gmm_samples_per_image: Optional[int] = None,
                              desc_dim: int, vocab_size: int,
                              pca_file: Optional[str] = None,
                              gmm_mean_file: Optional[str] = None,
                              gmm_var_file: Optional[str] = None,
                              gmm_wts_file: Optional[str] = None,
                              seed: int = 0, name: str = "descriptors",
                              phases: Optional[_Phases] = None,
                              info: Optional[dict] = None) -> Tuple[Pipeline, int]:
    """A branch's PCA and Fisher-vector tail over the descriptor prefix
    ``prefix``: (the branch, its width 2·descDim·vocabSize). ``phases``
    receives the seconds of ``name`` (the descriptors), ``samples``,
    ``pca_fit`` and ``gmm``; ``info`` the descriptors per image, the PCA
    estimator chosen, the EM iterations and the ``codebooks`` (the PCA
    matrix and the GMM), keyed by ``name``.

    ``train_images`` is an (n, X, Y, C) tensor or a ``ChunkedDataset`` of
    such chunks. A chunked set draws both samples in one scan of its
    descriptors, each chunk sampled by ``ColumnSampler.sample_chunk`` (the
    PCA sample with ``seed``, the GMM sample with ``seed + 1``); the
    descriptors of a chunk are freed before the next is made, so the
    phases ``name`` and ``samples`` are one."""
    if not getattr(train_images, "is_chunked", False):
        dev = train_images.device
    else:
        dev = phases.device if phases is not None else pick_device()
    phases = phases if phases is not None else _Phases(dev)
    info = info if info is not None else {}
    pca_sample = desc_sample = None
    if not pca_file or not gmm_mean_file:
        gmm_per_img = gmm_samples_per_image or num_col_samples_per_image
        with phase("imagenet.descriptors+samples") as out:
            descs = prefix(train_images).get()
            if descs.is_chunked:
                s_pca = ColumnSampler(num_col_samples_per_image, seed=seed)
                s_gmm = ColumnSampler(gmm_per_img, seed=seed + 1)
                pca_parts, gmm_parts = [], []
                for i, chunk in enumerate(descs.chunks()):
                    info.setdefault("descriptors", {})[name] = int(chunk.shape[2])
                    if not pca_file:
                        pca_parts.append(s_pca.sample_chunk(chunk, i))
                    if not gmm_mean_file:
                        gmm_parts.append(s_gmm.sample_chunk(chunk, i))
                    del chunk
                pca_sample = Dataset(torch.cat(pca_parts)) if pca_parts else None
                desc_sample = Dataset(torch.cat(gmm_parts)) if gmm_parts else None
                phases.done(name)
            else:
                info.setdefault("descriptors", {})[name] = int(descs.to_array().shape[2])
                phases.done(name)
                if not pca_file:
                    pca_sample = ColumnSampler(num_col_samples_per_image,
                                               seed=seed).apply_batch(descs)
                if not gmm_mean_file:
                    desc_sample = ColumnSampler(gmm_per_img, seed=seed + 1).apply_batch(descs)
            del descs
            out.append((pca_sample if pca_sample is not None else desc_sample).to_array())
            phases.done("samples")

    if pca_file:
        pca_mat = np.loadtxt(pca_file, delimiter=",", ndmin=2).T
        desc_dim = int(pca_mat.shape[1])  # a loaded PCA sets the branch's width
        pca = BatchPCATransformer(torch.tensor(pca_mat, dtype=torch.float32, device=dev))
    else:
        column_pca = ColumnPCAEstimator(desc_dim)
        chosen = column_pca.optimize(pca_sample)
        info.setdefault("pca_choice", {})[name] = type(chosen).__name__
        with phase("imagenet.pca_fit+gmm_project"):
            pca = chosen.fit(pca_sample)
            phases.done("pca_fit")
        del pca_sample

    if gmm_mean_file:
        fv = FisherVector(GaussianMixtureModel.load(gmm_mean_file, gmm_var_file, gmm_wts_file,
                                                    device=dev))
        vocab_size = int(fv.gmm.k)  # a loaded codebook sets the branch's width
    else:
        with phase("imagenet.pca_fit+gmm_project") as out:
            gmm_sample = pca.apply_batch(desc_sample)
            out.append(gmm_sample.to_array())
        del desc_sample
        fv = GMMFisherVectorEstimator(vocab_size, max_iterations=20,
                                      min_cluster_size=1).fit(gmm_sample)
        info.setdefault("em_iterations", {})[name] = fv.gmm.fit_info["iterations"]
        del gmm_sample
        phases.done("gmm")
    info.setdefault("codebooks", {})[name] = {"pca_mat": pca.pca_mat, "gmm": fv.gmm}
    return prefix.and_then(codebook_tail(pca.pca_mat, fv.gmm)), 2 * desc_dim * vocab_size


def build_predictor(train_images, train_int_labels, conf: ImageNetSiftLcsFVConfig,
                    device: Optional[torch.device] = None, classify: bool = True,
                    phases: Optional[_Phases] = None, info: Optional[dict] = None) -> Pipeline:
    """The two-branch predictor, its weighted solver not yet fitted (its
    PCAs and GMMs are: see :func:`compute_pca_fisher_branch`). It ends at
    ``TopKClassifier(5)``, or with ``classify`` False at the scores. The
    training images may be a ``ChunkedDataset`` (out of core)."""
    dev = device if device is not None else pick_device()
    X = _images(train_images, dev)
    n_train = len(X)
    per_img = max(1, conf.num_pca_samples // max(n_train, 1))
    per_img_gmm = max(1, conf.num_gmm_samples // max(n_train, 1))
    labels = ClassLabelIndicators(conf.num_classes).forward(
        torch.as_tensor(np.asarray(train_int_labels)).to(dev))
    common = dict(num_col_samples_per_image=per_img, gmm_samples_per_image=per_img_gmm,
                  desc_dim=conf.desc_dim, vocab_size=conf.vocab_size, phases=phases, info=info)
    sift_branch, sift_width = compute_pca_fisher_branch(
        sift_prefix(conf), X, pca_file=conf.sift_pca_file,
        gmm_mean_file=conf.sift_gmm_mean_file, gmm_var_file=conf.sift_gmm_var_file,
        gmm_wts_file=conf.sift_gmm_wts_file, seed=conf.seed, name="sift", **common)
    lcs_branch, lcs_width = compute_pca_fisher_branch(
        lcs_prefix(conf), X, pca_file=conf.lcs_pca_file,
        gmm_mean_file=conf.lcs_gmm_mean_file, gmm_var_file=conf.lcs_gmm_var_file,
        gmm_wts_file=conf.lcs_gmm_wts_file, seed=conf.seed + 17, name="lcs", **common)
    if info is not None:
        info["fv_width"] = sift_width + lcs_width
    predictor = (Pipeline.gather([sift_branch, lcs_branch]).and_then(VectorCombiner())
                 .and_then(Cacher()).and_then(
                     BlockWeightedLeastSquaresEstimator(BLOCK_SIZE, 1, conf.lam,
                                                        conf.mixture_weight,
                                                        num_features=sift_width + lcs_width),
                     X, labels))
    return predictor.and_then(TopKClassifier(TOP_K)) if classify else predictor


def top_k_err_percent(predicted_topk, actual) -> float:
    """Percent of items whose true label is not among the predicted top k
    (parity: ``Stats.getErrPercent``)."""
    predicted_topk = np.asarray(predicted_topk)
    actual = np.asarray(actual).reshape(-1)
    return 100.0 * float(1.0 - (predicted_topk == actual[:, None]).any(axis=1).mean())


def _op(fitted: FittedPipeline, cls):
    return next(op for op in fitted.graph.operators.values() if isinstance(op, cls))


def run(train_images, train_labels, test_images, test_labels,
        conf: ImageNetSiftLcsFVConfig, device: Optional[torch.device] = None,
        details: Optional[dict] = None):
    """Fit on the training images (an (n, X, Y, C) batch, uint8 or float in
    [0, 255], or a ``ChunkedDataset`` of such chunks) and their int labels,
    and score the test images. Returns (the fitted predictor, the top-5
    test error in percent, the seconds).

    ``details``, when given, receives ``phases`` (seconds of data, sift,
    lcs, samples, pca_fit, gmm, optimize, featurize, solve, executor,
    apply and evaluate; ``fit_seconds`` is the whole fit), on CUDA
    ``peak_bytes`` (the peak device bytes so far at the end of each phase
    and of the ``fit``), ``descriptors`` per image of each branch,
    ``fv_width``, the weighted solver's ``solver_path`` ("dense" or
    "dual"), its ``class_chunks`` and ``block_steps``, its ``solver_route``
    ("in_memory", or "streamed" for chunked features over the cache budget)
    and ``solver_scans`` (0 in memory), ``pca_choice`` and
    ``em_iterations`` of each fitted branch, each branch's ``codebooks``,
    the ``fitted`` predictor, the test ``scores`` and their ``top5``."""
    dev = device if device is not None else pick_device()
    start = time.perf_counter()
    X_train = _images(train_images, dev)
    X_test = _images(test_images, dev)
    phases = _Phases(dev, start)
    phases.done("data")
    info: dict = {}
    scorer = build_predictor(X_train, train_labels, conf, dev, classify=False, phases=phases,
                             info=info)
    phases.mark = clock()
    fitted_scorer = scorer.fit()
    phases.done("fit")
    scores = fitted_scorer.apply(X_test).to_array()
    top5 = TopKClassifier(TOP_K).forward(scores)
    phases.done("apply")
    err = top_k_err_percent(top5.cpu().numpy(), test_labels)
    phases.done("evaluate")
    fit_seconds = phases.seconds.pop("fit")
    seconds = fitted_scorer.seconds
    phases.seconds.update(optimize=seconds["optimize"], featurize=seconds.get("featurize", 0.0),
                          solve=seconds.get("BlockWeightedLeastSquaresEstimator", 0.0),
                          executor=seconds["executor"])
    head = fitted_scorer.and_then(TopKClassifier(TOP_K))
    fitted = FittedPipeline(head.graph, head.source, head.sink, seconds)
    fit_info = _op(fitted, BlockLinearMapper).fit_info
    info.update(phases=phases.seconds, peak_bytes=phases.peaks, fit_seconds=fit_seconds,
                solver_path="+".join(sorted(set(fit_info["paths"]))),
                class_chunks=fit_info["class_chunks"], block_steps=fit_info["block_steps"],
                solver_route="streamed" if "scans" in fit_info else "in_memory",
                solver_scans=fit_info.get("scans", 0), fitted=fitted, scores=scores, top5=top5)
    if details is not None:
        details.update(info)
    return fitted, err, time.perf_counter() - start


def write_codebooks(codebooks: Dict[str, dict], folder: str) -> Dict[str, str]:
    """Write each branch's PCA matrix and GMM (``details["codebooks"]`` of
    :func:`run`) as the CSV files the load path reads; returns the
    configuration's file fields (``sift_pca_file`` …) by name."""
    files = {}
    for name, book in codebooks.items():
        gmm = book["gmm"]
        for key, arr in (("pca", book["pca_mat"].T), ("gmm_mean", gmm.means),
                         ("gmm_var", gmm.variances), ("gmm_wts", gmm.weights)):
            files[f"{name}_{key}_file"] = f"{folder}/{name}_{key}.csv"
            np.savetxt(files[f"{name}_{key}_file"], arr.cpu().double().numpy(), delimiter=",",
                       fmt="%.9e")
    return files


def featurizer_of(fitted: FittedPipeline) -> FittedPipeline:
    """The fitted predictor cut at the weighted model's input: pixels to
    the gathered, normalized Fisher vectors."""
    graph = fitted.graph
    node = next(n for n in graph.nodes if isinstance(graph.get_operator(n), BlockLinearMapper))
    graph, sink = graph.add_sink(graph.get_dependencies(node)[0])
    return FittedPipeline(graph, fitted._source, sink)


def fitted_from_arrays(params: Dict[str, np.ndarray], conf: ImageNetSiftLcsFVConfig,
                       device: Optional[torch.device] = None,
                       classify: bool = True) -> FittedPipeline:
    """The fitted predictor from another fit's parameters, as numpy arrays:
    per branch (``sift_`` and ``lcs_``) ``pca_mat`` (128 or 96, descDim),
    ``gmm_means`` and ``gmm_variances`` (descDim, vocabSize) and
    ``gmm_weights`` (vocabSize,); the weighted model's ``W`` (d, k) or its
    blocks (a sequence), and ``b`` (k,). Its graph is the one ``fit``
    leaves, ending at TopKClassifier(5), or with ``classify`` False at the
    scores."""
    dev = device if device is not None else pick_device()

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    branches = []
    for name, prefix in (("sift", sift_prefix(conf)), ("lcs", lcs_prefix(conf))):
        gmm = GaussianMixtureModel(t(params[f"{name}_gmm_means"]),
                                   t(params[f"{name}_gmm_variances"]),
                                   t(params[f"{name}_gmm_weights"]))
        branches.append(prefix.and_then(codebook_tail(t(params[f"{name}_pca_mat"]), gmm)))
    W = params["W"]
    blocks = [t(w) for w in W] if isinstance(W, (list, tuple)) else [t(W)]
    mapper = BlockLinearMapper(blocks, BLOCK_SIZE, b=t(params["b"]))
    head = (Pipeline.gather(branches).and_then(VectorCombiner()).and_then(Cacher())
            .fit().and_then(mapper))
    if classify:
        head = head.and_then(TopKClassifier(TOP_K))
    return FittedPipeline(head.graph, head.source, head.sink)


def synthetic_gradient_imagenet(n: int, num_classes: int, size: int = 64,
                                theta_sigma: float = 0.06, logf_sigma: float = 0.05,
                                seed: int = 0, n_theta: Optional[int] = None,
                                f_range: Optional[tuple] = None):
    """The JAX package's calibrated task, the same numpy draws: each class
    is a point of an (orientation × log-frequency) grid, each image a
    grating at the class's point plus Gaussian noise (``theta_sigma``
    radians, ``logf_sigma`` nats) with a random phase, a random lighting
    plane and pixel noise. The random phase gives every class a zero mean
    image, so raw pixels cannot decode the class and the gradient
    statistics can. Returns (uint8 images, labels, the analytic top-1
    Bayes error in percent, 1 − (1 − e_θ)(1 − e_f) with e = 2·Q(Δ/(2σ)))."""
    from math import ceil, erfc, sqrt

    rng = np.random.default_rng(seed)
    if n_theta is None:
        n_theta = min(10, max(1, int(np.ceil(np.sqrt(num_classes)))))
    n_freq = max(1, ceil(num_classes / n_theta))
    d_theta = np.pi / n_theta
    if f_range is None:
        log_step = 0.35
        f0 = 0.06
    else:
        f0, f_hi = f_range
        log_step = np.log(f_hi / f0) / max(n_freq - 1, 1) if n_freq > 1 else 0.35

    def tail(delta, sigma):
        return erfc(delta / (2.0 * sigma) / sqrt(2.0))

    e_theta = tail(d_theta, theta_sigma) if n_theta > 1 else 0.0
    e_freq = tail(log_step, logf_sigma) if n_freq > 1 else 0.0
    bayes = 100.0 * (1.0 - (1.0 - e_theta) * (1.0 - e_freq))

    xx, yy = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    images = np.zeros((n, size, size, 3), dtype=np.float32)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    for i in range(n):
        c = int(labels[i])
        theta = d_theta * (c % n_theta) + theta_sigma * rng.standard_normal()
        logf = np.log(f0) + log_step * (c // n_theta) + logf_sigma * rng.standard_normal()
        f = np.exp(logf)
        wave = 60.0 * np.sin(2 * np.pi * f * (np.cos(theta) * xx + np.sin(theta) * yy)
                             + rng.uniform(0, 2 * np.pi))
        gx, gy = rng.uniform(-0.3, 0.3, 2)
        lighting = gx * (xx - size / 2) + gy * (yy - size / 2)
        img = np.clip(110.0 + wave + lighting + 6.0 * rng.standard_normal((size, size)), 0, 255)
        images[i] = img[..., None].repeat(3, axis=-1)
    return images.astype(np.uint8), labels, bayes


def synthetic_imagenet(n: int, num_classes: int, size: int = 64, seed: int = 0):
    """The JAX package's synthetic task, the same numpy draws: each class an
    oriented grating on a (frequency × orientation) grid over a noisy gray
    field, with a class-independent contrast region for the LCS branch.
    Returns (uint8 images, int32 labels)."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    images = np.zeros((n, size, size, 3), dtype=np.float32)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    n_freq = min(10, max(1, int(np.ceil(np.sqrt(num_classes)))))
    n_theta = max(1, -(-num_classes // n_freq))
    for i in range(n):
        cl = int(labels[i])
        freq = 0.08 + 0.035 * (cl % n_freq)
        theta = np.pi * (cl // n_freq) / n_theta
        wave = 80.0 * np.sin(2 * np.pi * freq * (np.cos(theta) * xx + np.sin(theta) * yy)
                             + rng.uniform(0, 2 * np.pi))
        base = 64.0 + 8.0 * rng.standard_normal((size, size))
        x0, y0 = rng.integers(0, size // 3, 2)
        mask = np.zeros((size, size))
        mask[x0:x0 + size // 2, y0:y0 + size // 2] = 1.0
        img = np.clip(base + wave * (0.5 + 0.5 * mask), 0, 255)
        images[i] = img[..., None].repeat(3, axis=-1)
    return images.astype(np.uint8), labels


def _chunk_generator(device: torch.device, seed: int, chunk: int, stream: int) -> torch.Generator:
    """A new generator for one (seed, chunk index, stream) on ``device``:
    one shared across chunks, or made once a dataset, would advance between
    scans, and a later scan would see other images."""
    return torch.Generator(device).manual_seed((seed * 1_000_003 + chunk) * 2 + stream)


def synthetic_imagenet_device(n: int, num_classes: int, size: int = 256, chunk_rows: int = 64,
                              seed: int = 0, device=None):
    """The out-of-core form of :func:`synthetic_imagenet`, drawn on
    ``device`` (the card unless the CPU is named) chunk by chunk: returns (a
    ``ChunkedDataset`` of uint8 (rows, size, size, 3) chunks, the int32
    labels). Chunk i is drawn from generators seeded by (seed, i) and made
    anew on every scan, so each scan sees the same images (the lineage
    contract); the labels are drawn once, from the same per-chunk seeds.

    The images follow the JAX package's device generator: an oriented
    grating on a (frequency × orientation) class grid with a random phase,
    over a gray field with pixel noise, its contrast raised inside a random
    square. ``torch.Generator`` cannot draw ``jax.random``'s values, so the
    two agree in distribution, not bit for bit."""
    dev = pick_device(device)
    n_freq = min(10, max(1, int(np.ceil(np.sqrt(num_classes)))))
    n_theta = max(1, -(-num_classes // n_freq))
    n_chunks = -(-n // chunk_rows)

    def chunk_labels(i: int) -> torch.Tensor:
        rows = min(chunk_rows, n - i * chunk_rows)
        return torch.randint(0, num_classes, (rows,), device=dev,
                             generator=_chunk_generator(dev, seed, i, 0))

    coords = torch.arange(size, dtype=torch.float32)

    def chunk_fn(i: int) -> torch.Tensor:
        labels = chunk_labels(i)
        rows = labels.shape[0]
        gen = _chunk_generator(dev, seed, i, 1)
        xx, yy = coords.to(dev)[:, None], coords.to(dev)[None, :]
        freq = (0.08 + 0.035 * (labels % n_freq).float())[:, None, None]
        theta = (np.pi * (labels // n_freq).float() / n_theta)[:, None, None]
        phase_ = torch.rand((rows, 1, 1), device=dev, generator=gen) * (2 * np.pi)
        wave = 80.0 * torch.sin(2 * np.pi * freq * (torch.cos(theta) * xx + torch.sin(theta) * yy)
                                + phase_)
        base = 64.0 + 8.0 * torch.randn((rows, size, size), device=dev, generator=gen)
        x0 = torch.randint(0, size // 3, (rows, 1, 1), device=dev, generator=gen)
        y0 = torch.randint(0, size // 3, (rows, 1, 1), device=dev, generator=gen)
        mask = ((xx >= x0) & (xx < x0 + size // 2) & (yy >= y0) & (yy < y0 + size // 2)).float()
        img = torch.clamp(base + wave * (0.5 + 0.5 * mask), 0, 255)
        return img.to(torch.uint8)[..., None].expand(rows, size, size, 3).contiguous()

    labels = torch.cat([chunk_labels(i) for i in range(n_chunks)]).cpu().numpy().astype(np.int32)
    ds = ChunkedDataset.from_chunk_fn(chunk_fn, n_chunks, n,
                                      label=f"imagenet_device[{n}x{size}px]")
    return ds, labels


# ---- CLI -----------------------------------------------------------------

_FILES = ("siftPcaFile", "siftGmmMeanFile", "siftGmmVarFile", "siftGmmWtsFile", "lcsPcaFile",
          "lcsGmmMeanFile", "lcsGmmVarFile", "lcsGmmWtsFile")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("ImageNetSiftLcsFV")
    p.add_argument("app", choices=["ImageNetSiftLcsFV"])
    p.add_argument("--device", default=None, help="torch device; CUDA unless 'cpu' is named")
    p.add_argument("--trainLocation", default=None,
                   help="tar file or dir of tars of class-dir images")
    p.add_argument("--testLocation", default=None)
    p.add_argument("--labelsFile", default=None, help="'<classdir> <int>' lines")
    p.add_argument("--imageSize", type=int, default=256)
    p.add_argument("--lambda", dest="lam", type=float, default=6e-5)
    p.add_argument("--mixtureWeight", type=float, default=0.25)
    p.add_argument("--descDim", type=int, default=64)
    p.add_argument("--vocabSize", type=int, default=16)
    p.add_argument("--siftScaleStep", type=int, default=1)
    p.add_argument("--lcsStride", type=int, default=4)
    p.add_argument("--lcsBorder", type=int, default=16)
    p.add_argument("--lcsPatch", type=int, default=6)
    p.add_argument("--numPcaSamples", type=int, default=100_000)
    p.add_argument("--numGmmSamples", type=int, default=100_000)
    p.add_argument("--numClasses", type=int, default=16)
    p.add_argument("--nTrain", type=int, default=256)
    p.add_argument("--nTest", type=int, default=64)
    for f in _FILES:
        p.add_argument(f"--{f}", default=None)
    return p.parse_args(argv)


def _snake(flag: str) -> str:
    return "".join("_" + c.lower() if c.isupper() else c for c in flag)


def run_app(argv=None) -> dict:
    """Parse the command line and run the application. Without a train
    location it runs on ``synthetic_imagenet`` (seeds 1 and 2) at 64 px
    whatever ``--imageSize`` says, as the JAX CLI does. Returns the top-5
    error (``top5_error``, percent), the seconds, the phases and the
    ``details`` of :func:`run`."""
    args = parse_args(argv)
    dev = pick_device(args.device)
    conf = ImageNetSiftLcsFVConfig(
        lam=args.lam, mixture_weight=args.mixtureWeight, desc_dim=args.descDim,
        vocab_size=args.vocabSize, sift_scale_step=args.siftScaleStep,
        lcs_stride=args.lcsStride, lcs_border=args.lcsBorder, lcs_patch=args.lcsPatch,
        num_pca_samples=args.numPcaSamples, num_gmm_samples=args.numGmmSamples,
        num_classes=args.numClasses, **{_snake(f): getattr(args, f) for f in _FILES})
    if args.trainLocation:
        from ..loaders.images import load_imagenet, read_labels_map

        # a label the indicators cannot hold would give an all −1 row:
        # size the label space from the labels file
        conf.num_classes = max(conf.num_classes,
                               max(read_labels_map(args.labelsFile).values()) + 1)
        size = (args.imageSize, args.imageSize)
        train = load_imagenet(args.trainLocation, args.labelsFile, size=size)
        test = load_imagenet(args.testLocation or args.trainLocation, args.labelsFile, size=size)
        tr_i, tr_l = train.data.to_array().numpy(), train.labels
        te_i, te_l = test.data.to_array().numpy(), test.labels
    else:
        tr_i, tr_l = synthetic_imagenet(args.nTrain, conf.num_classes, seed=1)
        te_i, te_l = synthetic_imagenet(args.nTest, conf.num_classes, seed=2)
    details: dict = {}
    _, err, seconds = run(tr_i, tr_l, te_i, te_l, conf, dev, details)
    return {"top5_error": err, "seconds": seconds, "phases": details["phases"],
            "details": details}


def main(argv=None) -> int:
    out = run_app(argv)
    print(f"TEST Error is {out['top5_error']}%")
    print(f"Pipeline took {out['seconds']} s")
    return 0
