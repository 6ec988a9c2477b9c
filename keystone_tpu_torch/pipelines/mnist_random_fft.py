"""MnistRandomFFT (port of ``keystone_tpu/pipelines/mnist_random_fft.py``):
gather(numFFTs × [RandomSignNode → PaddedFFT → LinearRectifier(0)]) →
VectorCombiner → one-pass BlockLeastSquaresEstimator(blockSize, 1, λ) →
MaxClassifier, scored with the multiclass evaluator.

Data arrives on the host (numpy) and is moved to ``device`` once; or it
is drawn on the card (:func:`synthetic_mnist_device`, and the linear task
of the solver-sharpness gate, :func:`linear_task_device`), and only the
labels come to the host. The
pipeline is a graph: the optimizer fuses the 200 × 3 branch nodes, the
gather and the combiner into one operator, which is row-local and so runs
in row chunks; at the CLI's default width (200 branches, d = 102,400) no
branch output is ever whole, only the feature matrix itself.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as pick_device
from ..loaders.csv_loader import LabeledData, load_labeled_csv
from ..nodes.learning.linear import BlockLeastSquaresEstimator
from ..nodes.stats import LinearRectifier, PaddedFFT, RandomSignNode
from ..nodes.util import VectorCombiner
from ..workflow.pipeline import FittedPipeline, Pipeline
from .block_app import fit_and_score, fitted_block_model, print_errors

MNIST_IMAGE_SIZE = 784
NUM_CLASSES = 10
#: the seed of the synthetic task the CLI draws (the JAX CLI's default)
DATA_SEED = 42

#: The synthetic task of the JAX package: the class signal lives in an
#: antipodal low-dimensional latent,
#:     u = s·μ_c + σ_l·ε  (s = ±1 uniform),   x = U·u + σ_amb·η,
#: with μ_c on a PROTO_RADIUS sphere in R^LATENT_DIM and U orthonormal.
#: E[x|c] = 0, so no linear function of raw pixels separates the classes;
#: the relu(FFT·D·x) features read the latent magnitudes. Its Bayes error
#: is about 4 % (:func:`bayes_error_mc`).
LATENT_DIM = 8
PROTO_RADIUS = 5.0
LATENT_SIGMA = 1.0
AMBIENT_SIGMA = 0.05

#: The JAX package's first task, kept for the solver-sharpness gate: class
#: prototypes PROTO_SCALE·N(0, I) in raw pixels plus NOISE_SIGMA·N(0, I)
#: noise. Its Bayes rule is linear, so an exact ridge on raw pixels lands
#: near the Bayes error and a Gram that lost precision lands far from it.
PROTO_SCALE = 0.25
NOISE_SIGMA = 2.0
#: rows of each task's Monte-Carlo Bayes estimate (the JAX package's)
BAYES_MC_ROWS = 262144


@dataclass
class MnistRandomFFTConfig:
    train_location: str = ""
    test_location: str = ""
    num_ffts: int = 200
    block_size: int = 2048
    lam: Optional[float] = None
    seed: int = 0


def _featurizer(signs: Sequence[torch.Tensor]) -> Pipeline:
    return Pipeline.gather([
        RandomSignNode(s).and_then(PaddedFFT()).and_then(LinearRectifier(0.0))
        for s in signs
    ]).and_then(VectorCombiner())


def build_featurizer(conf: MnistRandomFFTConfig, device=None,
                     signs: Optional[np.ndarray] = None) -> Pipeline:
    """The gathered featurizer on ``device``. Branch i's signs are drawn
    from seed ``conf.seed + i``, or taken from row i of ``signs``
    ((num_ffts, 784), e.g. another fit's)."""
    dev = pick_device(device)
    if signs is None:
        return _featurizer([
            RandomSignNode.create(MNIST_IMAGE_SIZE, seed=conf.seed + i, device=dev).signs
            for i in range(conf.num_ffts)
        ])
    return _featurizer(torch.tensor(np.asarray(signs, np.float32), device=dev).unbind(0))


def run(train: LabeledData, test: LabeledData, conf: MnistRandomFFTConfig,
        device: Optional[torch.device] = None,
        timings: Optional[Dict[str, float]] = None,
        signs: Optional[np.ndarray] = None):
    """Fit on ``train`` and score both sets; returns (scorer, train_err,
    test_err, seconds) and fills ``timings`` as
    :func:`~keystone_tpu_torch.pipelines.block_app.fit_and_score` says.
    ``signs`` as for :func:`build_featurizer`."""
    dev = device if device is not None else pick_device()
    return fit_and_score(lambda: build_featurizer(conf, dev, signs),
                         BlockLeastSquaresEstimator(conf.block_size, 1, conf.lam or 0.0),
                         train, test, NUM_CLASSES, dev, timings)


def fitted_from_arrays(params: Dict[str, np.ndarray],
                       device: Optional[torch.device] = None,
                       classify: bool = True) -> FittedPipeline:
    """The fitted MnistRandomFFT pipeline from another fit's parameters, as
    numpy arrays: ``signs`` (numFFTs, 784), ``W`` (d, 10), ``b`` (10,) and
    ``feature_means`` (d,). Its graph is the one ``fit`` leaves: the fused
    featurizer, the linear model and, with ``classify``, MaxClassifier;
    without it the pipeline ends at the scores."""
    dev = device if device is not None else pick_device()
    return fitted_block_model(build_featurizer(MnistRandomFFTConfig(), dev, params["signs"]),
                              params, dev, classify)


# ---- the synthetic task ------------------------------------------------

def _streams(seed: int) -> Tuple[np.random.SeedSequence, ...]:
    """Independent streams of one task seed: (task, train, test, Monte
    Carlo), as the JAX package splits its key."""
    return tuple(np.random.SeedSequence(seed).spawn(4))


def _latent_task_params(stream) -> Tuple[np.ndarray, np.ndarray]:
    """(μ (C, LATENT_DIM) on the PROTO_RADIUS sphere, U (784, LATENT_DIM)
    orthonormal by QR): the task instance, shared by the generator and the
    Bayes estimate so the yardstick measures the data's own instance."""
    rng = np.random.default_rng(stream)
    mu = rng.standard_normal((NUM_CLASSES, LATENT_DIM))
    mu = PROTO_RADIUS * mu / np.linalg.norm(mu, axis=1, keepdims=True)
    U, _ = np.linalg.qr(rng.standard_normal((MNIST_IMAGE_SIZE, LATENT_DIM)))
    return mu.astype(np.float32), U.astype(np.float32)


def _draw(stream, mu: np.ndarray, U: np.ndarray, n: int) -> LabeledData:
    rng = np.random.default_rng(stream)
    y = rng.integers(0, NUM_CLASSES, size=n)
    s = (2 * rng.integers(0, 2, size=n) - 1).astype(np.float32)
    u = s[:, None] * mu[y] + LATENT_SIGMA * rng.standard_normal(
        (n, LATENT_DIM), dtype=np.float32)
    X = u @ U.T + AMBIENT_SIGMA * rng.standard_normal(
        (n, MNIST_IMAGE_SIZE), dtype=np.float32)
    return LabeledData(y.astype(np.int32), X)


def synthetic_mnist(n_train: int = 8192, n_test: int = 2048,
                    seed: int = DATA_SEED) -> Tuple[LabeledData, LabeledData]:
    """(train, test) of the JAX package's synthetic task, drawn with numpy
    from ``seed``: the same task, another instance than JAX's."""
    task, tr, te, _ = _streams(seed)
    mu, U = _latent_task_params(task)
    return _draw(tr, mu, U, n_train), _draw(te, mu, U, n_test)


def bayes_error_mc(seed: int = DATA_SEED, n: int = 262144) -> float:
    """Monte-Carlo Bayes error of the task drawn with ``seed``: the sign
    and class are decided together by the nearest of {±μ_c} on the latent
    sufficient statistic Uᵀx (whose noise is isotropic, σ_eff² = σ_l² +
    σ_amb²), and the class is that choice folded mod C."""
    task, _, _, mc = _streams(seed)
    mu, _ = _latent_task_params(task)
    rng = np.random.default_rng(mc)
    y = rng.integers(0, NUM_CLASSES, size=n)
    s = 2 * rng.integers(0, 2, size=n) - 1
    sig_eff = (LATENT_SIGMA ** 2 + AMBIENT_SIGMA ** 2) ** 0.5
    u = s[:, None] * mu[y] + sig_eff * rng.standard_normal((n, LATENT_DIM))
    P2 = np.concatenate([mu, -mu]).astype(np.float64)
    scores = u @ P2.T - 0.5 * np.sum(P2 * P2, axis=1)
    pred = np.argmax(scores, axis=1) % NUM_CLASSES
    return float(np.mean(pred != y))


# ---- the tasks drawn on the card --------------------------------------

def _device_generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A new generator for one (seed, stream) on ``device``; streams: 0 the
    task, 1 train, 2 test, 3 the Monte-Carlo draw."""
    return torch.Generator(device).manual_seed(seed * 4 + stream)


def _latent_task_params_device(seed: int, device: torch.device):
    """The latent task's (μ (C, LATENT_DIM), U (784, LATENT_DIM)) drawn on
    ``device`` from ``seed``: the generator and the Bayes estimate share
    them, so the yardstick measures the data's own instance."""
    gen = _device_generator(device, seed, 0)
    mu = torch.randn(NUM_CLASSES, LATENT_DIM, device=device, generator=gen)
    mu = PROTO_RADIUS * mu / torch.linalg.norm(mu, dim=1, keepdim=True)
    U, _ = torch.linalg.qr(torch.randn(MNIST_IMAGE_SIZE, LATENT_DIM, device=device,
                                       generator=gen))
    return mu, U


def _latent_draw(mu: torch.Tensor, gen: torch.Generator, n: int, sigma: float):
    """(labels, latents s·μ_y + σ·ε) of ``n`` rows, s = ±1."""
    dev = mu.device
    y = torch.randint(0, NUM_CLASSES, (n,), device=dev, generator=gen)
    s = torch.randint(0, 2, (n,), device=dev, generator=gen).float() * 2.0 - 1.0
    u = s[:, None] * mu[y] + sigma * torch.randn(n, LATENT_DIM, device=dev, generator=gen)
    return y, u


def _labeled(y: torch.Tensor, X: torch.Tensor) -> LabeledData:
    """The rows stay on their device; only the labels come to the host."""
    return LabeledData(y.cpu().numpy().astype(np.int32), X)


def synthetic_mnist_device(n_train: int = 8192, n_test: int = 2048, seed: int = DATA_SEED,
                           device=None) -> Tuple[LabeledData, LabeledData]:
    """(train, test) of the synthetic task drawn on ``device`` (the card
    unless the CPU is named) from ``torch.Generator``s seeded by ``seed``:
    no feature crosses from the host. The same task as
    :func:`synthetic_mnist`; ``torch.Generator`` cannot draw ``jax.random``'s
    values, so it is another instance than JAX's (and a CPU draw another
    than a card draw)."""
    dev = pick_device(device)
    mu, U = _latent_task_params_device(seed, dev)

    def make(stream, n):
        gen = _device_generator(dev, seed, stream)
        y, u = _latent_draw(mu, gen, n, LATENT_SIGMA)
        X = u @ U.T + AMBIENT_SIGMA * torch.randn(n, MNIST_IMAGE_SIZE, device=dev,
                                                  generator=gen)
        return _labeled(y, X)

    return make(1, n_train), make(2, n_test)


def _bayes_mc_draws(seed: int, n: int, device: torch.device):
    """The Monte-Carlo draw of the latent task's Bayes estimate: (μ, labels,
    latents with σ_eff² = σ_l² + σ_amb², the within-span noise of Uᵀx)."""
    mu, _ = _latent_task_params_device(seed, device)
    sig_eff = (LATENT_SIGMA ** 2 + AMBIENT_SIGMA ** 2) ** 0.5
    y, u = _latent_draw(mu, _device_generator(device, seed, 3), n, sig_eff)
    return mu, y, u


def bayes_error_mc_device(seed: int = DATA_SEED, n: int = BAYES_MC_ROWS, device=None) -> float:
    """Monte-Carlo Bayes error of the task :func:`synthetic_mnist_device`
    draws on ``device`` from ``seed``: the nearest of {±μ_c} on the latent,
    folded mod C, as :func:`bayes_error_mc`, computed on the device."""
    mu, y, u = _bayes_mc_draws(seed, n, pick_device(device))
    P2 = torch.cat([mu, -mu])
    pred = (u @ P2.T - 0.5 * (P2 * P2).sum(dim=1)).argmax(dim=1) % NUM_CLASSES
    return float((pred != y).float().mean())


def _linear_task_draw(protos: torch.Tensor, gen: torch.Generator, n: int):
    y = torch.randint(0, NUM_CLASSES, (n,), device=protos.device, generator=gen)
    X = protos[y] + NOISE_SIGMA * torch.randn(n, MNIST_IMAGE_SIZE, device=protos.device,
                                              generator=gen)
    return y, X


def _linear_task_protos(seed: int, device: torch.device) -> torch.Tensor:
    return PROTO_SCALE * torch.randn(NUM_CLASSES, MNIST_IMAGE_SIZE, device=device,
                                     generator=_device_generator(device, seed, 0))


def linear_task_device(n_train: int, n_test: int, seed: int = DATA_SEED, device=None,
                       mc_rows: int = BAYES_MC_ROWS):
    """The JAX package's linear task drawn on ``device``: (train, test, its
    Monte-Carlo Bayes error on ``mc_rows`` rows). The Bayes rule is the
    nearest prototype, linear in the pixels, so an exact ridge on raw
    pixels must land near it (bench.py's solver-sharpness gate)."""
    dev = pick_device(device)
    protos = _linear_task_protos(seed, dev)
    y_mc, X_mc = _linear_task_draw(protos, _device_generator(dev, seed, 3), mc_rows)
    scores = X_mc @ protos.T - 0.5 * (protos * protos).sum(dim=1)
    bayes = float((scores.argmax(dim=1) != y_mc).float().mean())
    del X_mc, scores
    train = _labeled(*_linear_task_draw(protos, _device_generator(dev, seed, 1), n_train))
    test = _labeled(*_linear_task_draw(protos, _device_generator(dev, seed, 2), n_test))
    return train, test, bayes


# ---- CLI -----------------------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("MnistRandomFFT")
    p.add_argument("app", choices=["MnistRandomFFT"])
    p.add_argument("--device", default=None,
                   help="torch device; CUDA unless 'cpu' is named")
    p.add_argument("--trainLocation", default=None)
    p.add_argument("--testLocation", default=None)
    p.add_argument("--numFFTs", type=int, default=200)
    p.add_argument("--blockSize", type=int, default=2048)
    p.add_argument("--lambda", dest="lam", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nTrain", type=int, default=8192)
    p.add_argument("--nTest", type=int, default=2048)
    return p.parse_args(argv)


def run_app(argv=None) -> dict:
    """Parse the command line and run the application. Returns the train
    and test errors, the total seconds, the per-phase seconds and the
    fitted-once scorer pipeline."""
    args = parse_args(argv)
    dev = pick_device(args.device)
    conf = MnistRandomFFTConfig(
        train_location=args.trainLocation or "",
        test_location=args.testLocation or "",
        num_ffts=args.numFFTs, block_size=args.blockSize, lam=args.lam,
        seed=args.seed,
    )
    if args.trainLocation:
        # the reference's format: a 1-indexed label in column 0
        train = load_labeled_csv(args.trainLocation, label_offset=1)
        test = load_labeled_csv(args.testLocation, label_offset=1)
    else:
        train, test = synthetic_mnist(args.nTrain, args.nTest)
    phases: Dict[str, float] = {}
    scorer, tr, te, secs = run(train, test, conf, dev, phases)
    return {"train_error": tr, "test_error": te, "seconds": secs,
            "phases": phases, "scorer": scorer}


def main(argv=None) -> int:
    print_errors(run_app(argv))
    return 0
