"""Image and statistics nodes of the port against the JAX package's nodes,
on the same numpy inputs. Each tolerance is stated with its reason."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.images import core as J
from keystone_tpu.nodes.learning.zca import ZCAWhitener as JZCA
from keystone_tpu.nodes.learning.zca import ZCAWhitenerEstimator as JZCAEst
from keystone_tpu.nodes.stats import Sampler as JSampler
from keystone_tpu.nodes.stats import StandardScaler as JScaler
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.utils.stats import normalize_rows as j_normalize_rows
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.images import core as T
from keystone_tpu_torch.nodes.learning.zca import ZCAWhitener, ZCAWhitenerEstimator
from keystone_tpu_torch.nodes.stats import Sampler, StandardScaler
from keystone_tpu_torch.utils.stats import normalize_rows


def _images(n=4, x=11, y=10, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, size=(n, x, y, c)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
def test_convolver_matches_jax(whiten, normalize):
    rng = np.random.default_rng(1)
    S, C, K = 3, 3, 5
    X = _images()
    filters = rng.standard_normal((K, S * S * C)).astype(np.float32)
    W = rng.standard_normal((S * S * C, S * S * C)).astype(np.float32)
    # whitener means of row-normalized patches, as learn_filters fits them
    means = rng.standard_normal(S * S * C).astype(np.float32)
    jw = JZCA(W, means) if whiten else None
    tw = ZCAWhitener(_t(W), _t(means)) if whiten else None
    want = J.Convolver(filters, 11, 10, C, whitener=jw,
                       normalize_patches=normalize).trace_batch(jnp.asarray(X))
    got = T.Convolver(_t(filters), 11, 10, C, whitener=tw,
                      normalize_patches=normalize).forward(_t(X))
    assert got.shape == want.shape
    # atol 1e-4: 27-term float32 dot products and window moments summed
    # in another order; rtol 1e-5 for the unnormalized conv of pixels up
    # to 255, whose values reach 1e3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("pool_fn", ["sum", "max", "mean"])
@pytest.mark.parametrize("stride,size,x,y", [(13, 14, 27, 27), (3, 5, 11, 10), (2, 3, 7, 9), (4, 4, 6, 6)])
def test_pooler_matches_jax(pool_fn, stride, size, x, y):
    X = np.random.default_rng(2).standard_normal((3, x, y, 4)).astype(np.float32)
    want = J.Pooler(stride, size, None, pool_fn).trace_batch(jnp.asarray(X))
    got = T.Pooler(stride, size, None, pool_fn).forward(_t(X))
    assert got.shape == want.shape
    # atol 1e-4: a window sum of up to 196 N(0,1) values in float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_symmetric_rectifier_and_vectorizer_match_jax():
    X = np.random.default_rng(3).standard_normal((2, 5, 4, 3)).astype(np.float32)
    want = J.SymmetricRectifier(alpha=0.25).trace_batch(jnp.asarray(X))
    got = T.SymmetricRectifier(alpha=0.25).forward(_t(X))
    # exact: one subtraction and a max each
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        T.ImageVectorizer().forward(got).numpy(),
        np.asarray(J.ImageVectorizer().trace_batch(want)),
    )


@pytest.mark.parametrize("stride,window", [(1, 6), (2, 3), (3, 4)])
def test_windower_order_and_gather_match_jax(stride, window):
    X = _images(n=3, x=12, y=10, seed=4)
    want = np.asarray(J.Windower(stride, window).trace_batch(jnp.asarray(X)))
    w = T.Windower(stride, window)
    got = w.forward(_t(X))
    # exact: both only move values
    np.testing.assert_array_equal(got.numpy(), want)
    idx = np.sort(np.random.default_rng(5).choice(want.shape[0], size=17, replace=False))
    np.testing.assert_array_equal(w.gather(_t(X), _t(idx)).numpy(), want[idx])


def test_sampler_picks_the_jax_rows():
    X = np.arange(200 * 3, dtype=np.float32).reshape(200, 3)
    want = np.asarray(JSampler(37, seed=9).apply_batch(JDataset.of(X)).to_array())
    got = Sampler(37, seed=9).forward(_t(X))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("form", ["chunked", "items"])
def test_sampler_samples_the_whole_dataset(form):
    """A chunked dataset or an item list is sampled as one dataset, as the
    JAX package's apply_batch does: rows 3, 4, 6 and 9 of ten, not every
    row of every 3-row chunk or one-row item."""
    from keystone_tpu.data.chunked import ChunkedDataset as JChunked
    from keystone_tpu_torch.data.chunked import ChunkedDataset

    X = np.arange(20, dtype=np.float32).reshape(10, 2)
    if form == "chunked":
        j_in, t_in = JChunked.from_array(X, 3), ChunkedDataset.from_array(_t(X), 3)
    else:
        j_in = JDataset.from_items(list(X))
        t_in = Dataset.from_items([_t(r) for r in X])
    want = np.stack([np.asarray(r) for r in JSampler(4, seed=1).apply_batch(j_in)])
    got = Sampler(4, seed=1).apply_batch(t_in)
    got = np.stack([np.asarray(r) for r in got])
    np.testing.assert_array_equal(want[:, 0], [6, 8, 12, 18])
    np.testing.assert_array_equal(got, want)


def test_zca_matches_jax():
    rng = np.random.default_rng(6)
    X = (rng.standard_normal((300, 12)) @ rng.standard_normal((12, 12))).astype(np.float32)
    want = JZCAEst(0.1).fit_single(X)
    got = ZCAWhitenerEstimator(0.1).fit_single(_t(X))
    # atol 1e-4: float32 SVDs by two LAPACK bindings; W is sign-free
    np.testing.assert_allclose(got.whitener.numpy(), np.asarray(want.whitener), atol=1e-4)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), atol=1e-5)
    np.testing.assert_allclose(got.transform(_t(X)).numpy(),
                               np.asarray(want.transform(X)), atol=1e-4)


def test_standard_scaler_matches_jax():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((50, 6)).astype(np.float32) * 3 + 1
    X[:, 2] = 4.0  # degenerate column: std 0 becomes 1
    want = JScaler().fit(JDataset.of(X))
    got = StandardScaler().fit(Dataset.of(X))
    # atol 1e-5: column means and ddof=1 variances of 50 float32 values
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=1e-5)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std), atol=1e-5)
    assert got.std[2].item() == 1.0
    np.testing.assert_allclose(got.forward(_t(X)).numpy(),
                               np.asarray(want.trace_batch(jnp.asarray(X))), atol=1e-5)


@pytest.mark.parametrize("alpha", [1.0, 10.0])
def test_normalize_rows_matches_jax(alpha):
    X = np.random.default_rng(8).uniform(0, 255, size=(20, 108)).astype(np.float32)
    # atol 1e-5 on outputs of order 1
    np.testing.assert_allclose(normalize_rows(_t(X), alpha).numpy(),
                               np.asarray(j_normalize_rows(X, alpha)), atol=1e-5)
