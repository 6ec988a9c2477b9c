"""The port's LCS, DAISY and HOG extractors and ``_sep_conv_same`` against
the JAX package's on the CPU: the same numpy-seeded images through both,
outputs within 1e-5 × the output's largest magnitude (square and
non-square images, 48 and 64 px). HOG's histograms are scatters, whose
float32 sums are not ordered, so it too is held to that tolerance and not
to bit equality. LCS at the ImageNet application's parameters (4, 16, 6)
gives 3,136 descriptors of 96 values for a 256² image."""

import numpy as np
import pytest
import torch

from keystone_tpu.nodes.images.daisy import DaisyExtractor as JDaisy
from keystone_tpu.nodes.images.daisy import _sep_conv_same as j_sep_conv_same
from keystone_tpu.nodes.images.hog import HogExtractor as JHog
from keystone_tpu.nodes.images.lcs import LCSExtractor as JLCS
from keystone_tpu_torch.nodes.images.daisy import DaisyExtractor, _sep_conv_same
from keystone_tpu_torch.nodes.images.hog import HogExtractor
from keystone_tpu_torch.nodes.images.lcs import LCSExtractor
from keystone_tpu_torch.workflow import fusion

SHAPES = [(48, 48), (64, 64), (64, 52)]


def _images(shape, channels, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n,) + shape + (channels,)) * 255).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("filters", [((1.0, 0.0, -1.0), (1.0, 2.0, 1.0)),
                                     ((1 / 6,) * 6, (1 / 6,) * 6),
                                     ((0.25, 0.5, 0.25), (1 / 4,) * 4)])
def test_sep_conv_same_matches_jax(filters):
    xf, yf = filters
    X = _images((48, 40), 1)[..., 0]
    _close(_sep_conv_same(torch.from_numpy(X), xf, yf),
           j_sep_conv_same(X, np.asarray(xf), np.asarray(yf)))


@pytest.mark.parametrize("shape", SHAPES)
def test_lcs_matches_jax(shape):
    X = _images(shape, 3, seed=1)
    ext = LCSExtractor(4, 16, 6)
    _close(ext.forward(torch.from_numpy(X)), JLCS(4, 16, 6).trace_batch(X))


@pytest.mark.parametrize("shape", SHAPES)
def test_daisy_matches_jax(shape):
    X = _images(shape, 1, seed=2)
    _close(DaisyExtractor().forward(torch.from_numpy(X)), JDaisy().trace_batch(X))


@pytest.mark.parametrize("shape", SHAPES)
def test_hog_matches_jax(shape):
    X = _images(shape, 3, seed=3)
    _close(HogExtractor(8).forward(torch.from_numpy(X)), JHog(8).trace_batch(X))


def test_hog_pads_when_rounding_widens_the_image():
    X = _images((45, 38), 2, seed=4)  # 5.6 and 4.75 cells round up
    _close(HogExtractor(8).forward(torch.from_numpy(X)), JHog(8).trace_batch(X))


def test_lcs_at_full_parameters_on_one_256_image():
    X = _images((256, 256), 3, n=1, seed=5)
    ext = LCSExtractor(4, 16, 6)
    got = ext.forward(torch.from_numpy(X))
    assert tuple(got.shape) == (1, 96, 3136)
    assert ext.num_descriptors(256, 256) == 3136
    _close(got, JLCS(4, 16, 6).trace_batch(X))


@pytest.mark.parametrize("node", [LCSExtractor(4, 16, 6), DaisyExtractor(), HogExtractor(8)],
                         ids=["lcs", "daisy", "hog"])
def test_descriptors_declare_their_rows_and_run_in_byte_chunks(node, monkeypatch):
    """Each extractor declares at least its output's bytes for a row, so a
    group of them is cut into chunks that hold; chunked output equals the
    whole batch's."""
    X = torch.from_numpy(_images((64, 64), 3, n=5, seed=6))
    if isinstance(node, DaisyExtractor):
        X = X[..., :1]
    whole = node.forward(X)
    per_row = node.row_work_bytes(X[:1])
    assert per_row >= 4 * whole[0].numel()
    monkeypatch.setattr(fusion, "CHUNK_BYTES", 2 * per_row)
    chunked = node.apply_batch(X).to_array()
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-5 * whole.abs().max().item())
