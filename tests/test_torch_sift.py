"""Dense SIFT against the JAX package on the CPU, per scale and whole, on
32- and 64-px images of the VOC synthetic task (and on noise).

Tolerances, stated twice because quantization turns a last-bit
difference into a step of 1: before quantization, the smoothed images,
the normalized descriptors and their norms agree within 1e-5 (float32
convolutions, arctangents and norms of two libraries); after it, the
descriptors are equal except for a share of at most 1e-3 of entries that
differ by exactly 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.images import sift as jsift
from keystone_tpu.pipelines.voc_sift_fisher import synthetic_voc as j_synthetic_voc
from keystone_tpu_torch.nodes.images import sift as tsift
from keystone_tpu_torch.pipelines.voc_sift_fisher import synthetic_voc
from keystone_tpu_torch.workflow import fusion
from keystone_tpu_torch.workflow.env import PipelineEnv


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _gray(size, seed=3, n=4, kind="voc"):
    if kind == "voc":
        imgs, _ = j_synthetic_voc(n, size=size, seed=seed)
        return (imgs[..., :1] / 255.0).astype(np.float32)
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 1)).astype(np.float32)


def _quantized_parity(got, want):
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 1e-3, f"{(diff > 0).mean()} of the entries differ"


def test_synthetic_voc_is_the_jax_copy_bit_for_bit():
    a, la = synthetic_voc(5, size=32, seed=4)
    b, lb = j_synthetic_voc(5, size=32, seed=4)
    np.testing.assert_array_equal(a, b)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("scale", [0, 1, 2, 3])
def test_each_scale_matches_jax_before_quantization(size, scale):
    g = _gray(size)[..., 0]
    bin_size = 4 + 2 * scale
    sigma = bin_size / 6.0
    smooth_j = np.asarray(jsift._smooth(jnp.asarray(g), sigma))
    smooth_t = tsift._smooth(torch.from_numpy(g), sigma).numpy()
    np.testing.assert_allclose(smooth_t, smooth_j, atol=1e-5)
    # both from the same smoothed image, so only the descriptor stage differs
    dj, nj = jsift._sift_one_scale(jnp.asarray(smooth_j), bin_size, 3)
    dt, nt = tsift._scale_descriptors(torch.from_numpy(smooth_j.copy()), bin_size, 3)
    dj = np.swapaxes(np.asarray(dj), 1, 2)
    assert dt.shape == dj.shape
    np.testing.assert_allclose(dt.numpy(), dj, atol=1e-5)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,kind", [(32, "voc"), (64, "voc"), (64, "noise"), (40, "noise")])
def test_whole_extractor_matches_jax_after_quantization(size, kind):
    g = _gray(size, kind=kind)
    got = tsift.SIFTExtractor().forward(torch.from_numpy(g)).numpy()
    want = np.asarray(jsift.SIFTExtractor().trace_batch(jnp.asarray(g)))
    assert got.shape[1] == 128
    assert got.shape[2] == tsift.num_descriptors(size, size)
    _quantized_parity(got, want)
    assert got.min() >= 0 and got.max() <= 255


def test_scale_step_and_single_scale_match_jax():
    g = _gray(64)
    for kw in (dict(scale_step=1), dict(num_scales=1, step=5, bin_size=6)):
        got = tsift.SIFTExtractor(**kw).forward(torch.from_numpy(g)).numpy()
        want = np.asarray(jsift.SIFTExtractor(**kw).trace_batch(jnp.asarray(g)))
        _quantized_parity(got, want)


def test_descriptor_count_at_the_cli_image_size():
    # steps of 3 and bins 4/6/8/10 on 256 × 256: 81² + 78² + 75² + 73²
    assert tsift.num_descriptors(256, 256) == 6561 + 6084 + 5625 + 5329 == 23599


def test_low_contrast_descriptors_are_zero():
    flat = np.full((2, 32, 32, 1), 0.5, np.float32)
    assert not tsift.SIFTExtractor().forward(torch.from_numpy(flat)).any()


def test_row_chunks_of_the_extractor_are_cut_by_bytes(monkeypatch):
    """A 256² image's descriptors are 12 MB: the extractor declares them,
    so a batch runs in chunks that fit the budget, with the same output."""
    node = tsift.SIFTExtractor()
    one = torch.zeros(1, 256, 256, 1)
    assert node.row_work_bytes(one) > 4 * 128 * 23599
    g = torch.from_numpy(_gray(48, n=6, kind="noise"))
    whole = node.forward(g)
    calls = []
    forward = tsift.SIFTExtractor.forward
    monkeypatch.setattr(tsift.SIFTExtractor, "forward",
                        lambda self, X: calls.append(X.shape[0]) or forward(self, X))
    per_row = fusion.payload_bytes([g[:1]]) + node.row_work_bytes(g[:1])
    monkeypatch.setattr(fusion, "CHUNK_BYTES", 2 * per_row)
    got = node.apply_batch(g).to_array()
    assert calls == [2, 2, 2]
    torch.testing.assert_close(got, whole, rtol=0, atol=0)
