"""ImageNetSiftLcsFV's device work on a CUDA card against the same port on
the CPU or in float64: TopKClassifier's tie order, the LCS, DAISY and HOG
extractors, the class-weighted solver's dense and dual paths, and a small
ImageNet run through the load path.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_imagenet.py

Tolerances: descriptors 1e-4 × their largest magnitude (HOG's scatters
add in no fixed order on the card); the weighted solves' scores 1e-3 of
their largest magnitude against the float64 per-class solve on the
training rows and argmax agreement ≥ 0.95 on held-out rows; the small
run's quantized SIFT entries within one step, at most 1e-3 of them off,
its Fisher vectors 1e-3 relative (the SIFT branch's on the CPU's
descriptors), its scores 1e-3 relative and its top-5 equal on every row
whose 5th and 6th scores are more than 1e-4 (relative) apart.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.images.core import GrayScaler, PixelScaler
from keystone_tpu_torch.nodes.images.sift import SIFTExtractor
from keystone_tpu_torch.nodes.learning.gmm import GaussianMixtureModel
from keystone_tpu_torch.nodes.stats import SignedHellingerMapper
from keystone_tpu_torch.nodes.images.daisy import DaisyExtractor
from keystone_tpu_torch.nodes.images.hog import HogExtractor
from keystone_tpu_torch.nodes.images.lcs import LCSExtractor
from keystone_tpu_torch.nodes.learning import weighted
from keystone_tpu_torch.nodes.util import TopKClassifier
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as imagenet
from keystone_tpu_torch.workflow.env import PipelineEnv

CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def port_env():
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _images(n=4, size=64, seed=3):
    return torch.from_numpy(imagenet.synthetic_imagenet(n, 16, size=size, seed=seed)[0])


@pytest.mark.cuda
def test_top_k_ties_on_the_card_go_to_the_lower_index(cuda):
    X = torch.randint(0, 3, (4096, 40), generator=torch.Generator().manual_seed(0)).float()
    got = TopKClassifier(5).forward(X.to(cuda)).cpu()
    want = torch.from_numpy(np.argsort(-X.numpy(), axis=1, kind="stable")[:, :5])
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("node", [LCSExtractor(4, 16, 6), DaisyExtractor(), HogExtractor(8)],
                         ids=["lcs", "daisy", "hog"])
@pytest.mark.parametrize("size", [64, 256])
def test_descriptors_on_the_card_match_the_cpu(cuda, node, size):
    X = _images(3, size).float()
    if isinstance(node, DaisyExtractor):
        X = X[..., :1] / 255.0
    want = node.forward(X)
    got = node.forward(X.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item())


def _exact_f64(X, Y, lam, w):
    """The per-class weighted ridge in float64 on X's device."""
    X, Y = X.double(), Y.double()
    n, k = Y.shape
    y_idx, counts, label_mean, means = weighted._joint_weighted_stats(X, Y, w)
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    cols = []
    for c in range(k):
        b = weighted._class_sample_weights(y_idx, counts, c, w, n)
        Xc = X - means[c]
        cols.append(torch.linalg.solve(Xc.T @ (Xc * b[:, None]) + lam * eye,
                                       Xc.T @ ((Y[:, c] - label_mean[c]) * b)))
    W = torch.stack(cols, dim=1)
    return W, label_mean - torch.einsum("cd,dc->c", means, W)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,path", [(600, 256, "dense"), (96, 512, "dual")])
def test_weighted_solver_on_the_card_matches_float64(cuda, n, d, path):
    gen = torch.Generator(device=cuda).manual_seed(1)
    k = 24
    y = torch.randint(0, k, (n,), device=cuda, generator=gen)
    centers = torch.randn(k, d, device=cuda, generator=gen)
    X = torch.randn(n, d, device=cuda, generator=gen) + 0.5 * centers[y]
    X = X / torch.linalg.vector_norm(X, dim=1, keepdim=True)
    Y = 2.0 * torch.nn.functional.one_hot(y, k).float() - 1.0
    model = weighted.BlockWeightedLeastSquaresEstimator(d, 1, 6e-5, 0.25).fit(
        Dataset.of(X), Dataset.of(Y))
    assert model.fit_info["paths"] == [path]
    W, b = _exact_f64(X, Y, 6e-5, 0.25)
    want = X.double() @ W + b
    got = model.forward(X).double()
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-3
    X_test = torch.randn(512, d, device=cuda, generator=gen) + 0.5 * centers[
        torch.randint(0, k, (512,), device=cuda, generator=gen)]
    X_test = X_test / torch.linalg.vector_norm(X_test, dim=1, keepdim=True)
    agree = (model.forward(X_test).argmax(1) == (X_test.double() @ W + b).argmax(1))
    assert agree.float().mean().item() >= 0.95


@pytest.mark.cuda
def test_class_row_grams_on_the_card_match_the_masked_grams(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    y = torch.randint(0, 20, (700,), device=cuda, generator=gen)
    A = torch.randn(700, 300, device=cuda, generator=gen)
    rows = weighted.ClassRows(y, 20)
    mask = torch.nn.functional.one_hot(y, 20).float()
    got = rows.grams(A, 4, 12)
    want = weighted._chunk_grams(A, mask[:, 4:12])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_small_imagenet_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The CPU fits each branch's PCA and GMM once; both devices load them
    through the CLI's CSV files and fit the weighted solver themselves."""
    tr_i, tr_l = imagenet.synthetic_imagenet(96, 16, size=48, seed=1)
    te_i, te_l = imagenet.synthetic_imagenet(48, 16, size=48, seed=2)
    small = dict(desc_dim=16, vocab_size=4, num_classes=16, lam=1e-4)
    fit = {}
    imagenet.run(tr_i, tr_l, te_i, te_l, imagenet.ImageNetSiftLcsFVConfig(
        num_pca_samples=20_000, num_gmm_samples=20_000, **small), CPU, fit)
    files = imagenet.write_codebooks(fit["codebooks"], str(tmp_path))
    out = {}
    for name, dev in (("cuda", cuda), ("cpu", CPU)):
        PipelineEnv.get_or_create().reset()
        details = {}
        imagenet.run(tr_i, tr_l, te_i, te_l, imagenet.ImageNetSiftLcsFVConfig(**small, **files),
                     dev, details)
        out[name] = details
    X = torch.from_numpy(te_i)
    # SIFT quantizes: the card may put an entry one step from the CPU's,
    # which moves that image's Fisher vector; the SIFT branch is held on the
    # CPU's descriptors, the LCS half of the whole vectors as they are
    sift = PixelScaler().and_then(GrayScaler()).and_then(SIFTExtractor(scale_step=1)).fit()
    q_cpu = sift.apply(X).to_array()
    steps = (sift.apply(X.to(cuda)).to_array().cpu() - q_cpu).abs()
    assert steps.max() <= 1 and (steps > 0).double().mean() <= 1e-3
    book = out["cpu"]["codebooks"]["sift"]
    descs = SignedHellingerMapper().forward(q_cpu)
    tails = [imagenet.codebook_tail(book["pca_mat"].to(dev), GaussianMixtureModel(
        book["gmm"].means.to(dev), book["gmm"].variances.to(dev), book["gmm"].weights.to(dev)))
        .fit().apply(descs.to(dev)).to_array().cpu() for dev in (cuda, CPU)]
    torch.testing.assert_close(tails[0], tails[1], rtol=0,
                               atol=1e-3 * tails[1].abs().max().item())
    f_cpu = imagenet.featurizer_of(out["cpu"]["fitted"]).apply(X).to_array()
    f_gpu = imagenet.featurizer_of(out["cuda"]["fitted"]).apply(X.to(cuda)).to_array().cpu()
    half = f_cpu.shape[1] // 2
    torch.testing.assert_close(f_gpu[:, half:], f_cpu[:, half:], rtol=0,
                               atol=1e-3 * f_cpu[:, half:].abs().max().item())
    s_gpu, s_cpu = out["cuda"]["scores"].cpu(), out["cpu"]["scores"]
    torch.testing.assert_close(s_gpu, s_cpu, rtol=0, atol=1e-3 * s_cpu.abs().max().item())
    s = torch.sort(s_cpu, dim=1, descending=True).values
    rows = (s[:, 4] - s[:, 5]) > 1e-4 * s_cpu.abs().max()
    assert torch.equal(out["cuda"]["top5"].cpu()[rows], out["cpu"]["top5"][rows])
