"""The port's laned streaming fits against the JAX package's laned fits on
the suite's 8-device virtual mesh (the counterparts of
``tests/linalg/test_sharded_streaming.py``, at its shapes and chunk
boundaries, ragged tails included): normal equations, the streamed BCD
(centered, ragged, at ``num_iter`` 1 and 2), ``stream_column_means``,
``StandardScaler``, the weighted streaming solve, ``tsqr_r_streaming``
against ``tsqr_r(mesh=)``, and the block and weighted estimators with
``KEYSTONE_SCAN_LANES`` set. Each runs the same chunks in both packages at
lanes 2 and 8 and is held against JAX's laned result and the port's own
one lane at 1e-6 absolute (the values are O(1/√n) to O(1); StandardScaler
at the JAX test's 1e-5 on means of 50). The collective counts per scan
equal JAX's and do not grow when the chunks are halved; the streamed BCD
refuses a change of chunk boundaries between scans as JAX's does.

The port's 8 virtual devices are 8 slots of the CPU; the autouse fixture
restores its slots and default mesh afterwards."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu import linalg as jla
from keystone_tpu.data import ChunkedDataset as JChunked
from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.obs import tracer as jtrace
from keystone_tpu_torch import linalg as tla
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.obs import SCAN_SPAN
from keystone_tpu_torch.obs import tracer as ttrace
from keystone_tpu_torch.parallel import mesh, virtual
from keystone_tpu_torch.workflow.env import PipelineEnv

TOL = 1e-6


@pytest.fixture(autouse=True)
def port_mesh():
    saved = (mesh._default_mesh, virtual._slots)
    PipelineEnv.get_or_create().reset()
    virtual.provision_virtual_devices(8)
    yield
    mesh._default_mesh, virtual._slots = saved
    PipelineEnv.get_or_create().reset()


def _problem(n=208, d=24, k=3, seed=0, scale=None):
    rng = np.random.default_rng(seed)
    s = scale if scale is not None else 1.0 / np.sqrt(n)
    A = (rng.standard_normal((n, d)) * s).astype(np.float32)
    y = (rng.standard_normal((n, k)) * s).astype(np.float32)
    return A, y


def _maxdiff(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max())


def _scan(A, rows):
    return lambda: iter([A[i:i + rows] for i in range(0, len(A), rows)])


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- normal equations ---------------------------------------------------------


@pytest.mark.parametrize("lanes", [2, 8])
def test_normal_equations_lanes_equal_jax_with_a_ragged_tail(lanes):
    A, y = _problem()

    def pairs():
        # 6 chunks of 32 rows and a ragged 16: more chunks than lanes
        return iter([(A[i:i + 32], y[i:i + 32]) for i in range(0, len(A), 32)])

    Wj = jla.solve_least_squares_streaming(pairs(), reg=0.1, lanes=lanes)
    W1 = tla.solve_least_squares_streaming(pairs(), reg=0.1, lanes=1)
    WN = tla.solve_least_squares_streaming(pairs(), reg=0.1, lanes=lanes)
    assert _maxdiff(WN, Wj) <= TOL
    assert _maxdiff(WN, W1) <= TOL


# -- BCD ----------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [2, 8])
@pytest.mark.parametrize("num_iter", [1, 2])
def test_streamed_bcd_lanes_equal_jax_centered_ragged(lanes, num_iter):
    A, y = _problem(n=204, d=16)
    means = A.mean(axis=0)
    scan = _scan(A, 36)  # 204 = 5·36 + 24
    kw = dict(reg=0.1, block_size=4, num_iter=num_iter)
    wj = jla.solve_blockwise_l2_streaming(scan, jnp.asarray(y), lanes=lanes,
                                          means=jnp.asarray(means), **kw)
    w1 = tla.solve_blockwise_l2_streaming(scan, _t(y), lanes=1, means=_t(means), **kw)
    wn = tla.solve_blockwise_l2_streaming(scan, _t(y), lanes=lanes, means=_t(means), **kw)
    assert len(wn) == len(wj) == 4
    for a, b, c in zip(wn, wj, w1):
        assert _maxdiff(a, b) <= TOL
        assert _maxdiff(a, c) <= TOL


def test_laned_streamed_bcd_keeps_each_blocks_factor_across_sweeps():
    """The laned body: each block's factor is formed from the first sweep's
    reduced Gram and solves the second sweep, as JAX's laned result."""
    from keystone_tpu_torch.linalg import bcd

    A, y = _problem(n=204, d=16)
    means = A.mean(axis=0)
    kw = dict(reg=0.1, block_size=4, num_iter=2)
    formed, reused = bcd._block_solve.factors_formed, bcd._block_solve.factors_reused
    wn = tla.solve_blockwise_l2_streaming(_scan(A, 36), _t(y), lanes=4, means=_t(means), **kw)
    assert (bcd._block_solve.factors_formed - formed, bcd._block_solve.factors_reused - reused) \
        == (4, 4)
    wj = jla.solve_blockwise_l2_streaming(_scan(A, 36), jnp.asarray(y), lanes=4,
                                          means=jnp.asarray(means), **kw)
    for a, b in zip(wn, wj):
        assert _maxdiff(a, b) <= TOL


def test_streamed_bcd_takes_a_source_that_hands_over_its_own_scan():
    from keystone_tpu_torch.data.pipeline_scan import scan_pipeline

    A, y = _problem(n=96, d=8)
    kw = dict(reg=0.1, block_size=4, num_iter=1, means=_t(A.mean(axis=0)))
    ref = tla.solve_blockwise_l2_streaming(_scan(A, 24), _t(y), lanes=1, **kw)
    got = tla.solve_blockwise_l2_streaming(lambda: scan_pipeline(_scan(A, 24)(), label="pre"),
                                           _t(y), lanes=4, **kw)
    for a, b in zip(ref, got):
        assert _maxdiff(a, b) <= TOL


def test_streamed_bcd_refuses_a_change_of_boundaries_as_jax():
    A, y = _problem(n=96, d=8)

    def source(boundaries):
        def scan():
            cuts = boundaries.pop(0)
            return iter([A[a:b] for a, b in zip(cuts, cuts[1:])])
        return scan

    kw = dict(reg=0.1, block_size=4, num_iter=1, lanes=4)
    with pytest.raises(ValueError, match="changed boundaries|produced"):
        jla.solve_blockwise_l2_streaming(source([[0, 48, 96], [0, 32, 64, 96]]), jnp.asarray(y),
                                         means=jnp.asarray(A.mean(axis=0)), **kw)
    with pytest.raises(ValueError, match="changed boundaries"):
        tla.solve_blockwise_l2_streaming(source([[0, 48, 96], [0, 32, 64, 96]]), _t(y),
                                         means=_t(A.mean(axis=0)), **kw)


@pytest.mark.parametrize("lanes", [2, 8])
def test_stream_column_means_lanes_equal_jax(lanes):
    A, _ = _problem(n=208, d=24, scale=1.0)
    mj, nj = jla.stream_column_means(_scan(A, 32), lanes=lanes)
    m1, n1 = tla.stream_column_means(_scan(A, 32), lanes=1)
    mn, nn = tla.stream_column_means(_scan(A, 32), lanes=lanes)
    assert nn == n1 == nj == len(A)
    assert _maxdiff(mn, mj) <= TOL and _maxdiff(mn, m1) <= TOL


@pytest.mark.parametrize("lanes", ["2", "8"])
def test_standard_scaler_lanes_equal_jax(monkeypatch, lanes):
    from keystone_tpu.nodes.stats import StandardScaler as JScaler
    from keystone_tpu_torch.nodes.stats import StandardScaler

    X = (np.random.default_rng(17).standard_normal((208, 6)) * 3.0 + 50.0).astype(np.float32)
    monkeypatch.setenv("KEYSTONE_SCAN_LANES", "1")
    m1 = StandardScaler().fit(ChunkedDataset.from_array(X, 36))
    monkeypatch.setenv("KEYSTONE_SCAN_LANES", lanes)
    mj = JScaler().fit(JChunked.from_array(X, 36))
    mn = StandardScaler().fit(ChunkedDataset.from_array(X, 36))
    for a, b, c in ((mn.mean, mj.mean, m1.mean), (mn.std, mj.std, m1.std)):
        assert _maxdiff(a, b) <= 1e-5 and _maxdiff(a, c) <= 1e-5


def test_block_estimator_with_scan_lanes_set_equals_jax(monkeypatch):
    """Column means, the centered streamed BCD and the label-mean intercept
    through BlockLeastSquaresEstimator at 8 lanes, against JAX's 8-lane fit
    and the port's one lane."""
    from keystone_tpu.nodes.learning import BlockLeastSquaresEstimator as JBlock
    from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator

    A, y = _problem(n=208, d=16, k=2, seed=3)
    A = A + 0.5
    x = A[:16]

    def fit(lanes, est, chunked, ds):
        monkeypatch.setenv("KEYSTONE_SCAN_LANES", str(lanes))
        return est(block_size=4, num_iter=1, lam=0.1).fit(chunked.from_array(A, 36), ds.of(y))

    mj = fit(8, JBlock, JChunked, JDataset)
    m1 = fit(1, BlockLeastSquaresEstimator, ChunkedDataset, Dataset)
    m8 = fit(8, BlockLeastSquaresEstimator, ChunkedDataset, Dataset)
    pj = np.asarray(mj.trace_batch(jnp.asarray(x)))
    assert _maxdiff(m8.forward(_t(x)), pj) <= TOL
    assert _maxdiff(m8.forward(_t(x)), m1.forward(_t(x))) <= TOL


# -- class-weighted least squares ---------------------------------------------


def _weighted_problem(n=204, d=16, k=4, seed=3):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) / np.sqrt(n)).astype(np.float32)
    labels = rng.integers(0, k, size=n)
    Y = -np.ones((n, k), dtype=np.float32)
    Y[np.arange(n), labels] = 1.0
    return X, Y


@pytest.mark.parametrize("lanes", [2, 8])
@pytest.mark.parametrize("num_iter", [1, 2])
def test_weighted_streaming_lanes_equal_jax_ragged(lanes, num_iter):
    X, Y = _weighted_problem()
    kw = dict(block_size=4, num_iter=num_iter, lam=1e-2, mixture_weight=0.25, class_chunk=2)
    wj, bj = jla.solve_weighted_streaming(_scan(X, 36), jnp.asarray(Y), lanes=lanes, **kw)
    w1, b1 = tla.solve_weighted_streaming(_scan(X, 36), _t(Y), lanes=1, **kw)
    info = {}
    wn, bn = tla.solve_weighted_streaming(_scan(X, 36), _t(Y), lanes=lanes, info=info, **kw)
    for a, b, c in zip(wn, wj, w1):
        assert _maxdiff(a, b) <= TOL and _maxdiff(a, c) <= TOL
    assert _maxdiff(bn, bj) <= TOL and _maxdiff(bn, b1) <= TOL
    # one cross scan and one Gram scan a block (the 4 classes fit one class chunk)
    assert info["block_steps"] == 4 * num_iter and info["scans"] == 4 * num_iter * 2


def test_weighted_estimator_with_scan_lanes_set_equals_jax(monkeypatch):
    from keystone_tpu.nodes.learning.weighted import (
        BlockWeightedLeastSquaresEstimator as JWeighted,
    )
    from keystone_tpu_torch.nodes.learning.weighted import BlockWeightedLeastSquaresEstimator

    X, Y = _weighted_problem(n=208)
    monkeypatch.setenv("KEYSTONE_CHUNK_CACHE_BUDGET", "1")
    kw = dict(block_size=4, num_iter=1, lam=1e-2, mixture_weight=0.25, class_chunk=2)

    def fit(lanes, est, chunked, ds):
        monkeypatch.setenv("KEYSTONE_SCAN_LANES", str(lanes))
        return est(**kw).fit(chunked.from_array(X, 36), ds.of(Y))

    mj = fit(8, JWeighted, JChunked, JDataset)
    m1 = fit(1, BlockWeightedLeastSquaresEstimator, ChunkedDataset, Dataset)
    m8 = fit(8, BlockWeightedLeastSquaresEstimator, ChunkedDataset, Dataset)
    x = X[:16]
    pj = np.asarray(mj.trace_batch(jnp.asarray(x)))
    assert _maxdiff(m8.forward(_t(x)), pj) <= TOL
    assert _maxdiff(m8.forward(_t(x)), m1.forward(_t(x))) <= TOL


# -- TSQR ---------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [1, 8])
def test_tsqr_streaming_equals_the_mesh_tsqr_and_jax(lanes):
    A, _ = _problem(n=192, d=8, scale=1.0)
    R_mesh_j = np.asarray(jla.tsqr_r(jnp.asarray(A)))
    R_mesh = tla.tsqr_r(_t(A))
    R_j = np.asarray(jla.tsqr_r_streaming(_scan(A, 36), lanes=lanes))
    R_t = tla.tsqr_r_streaming(_scan(A, 36), lanes=lanes)
    assert tuple(R_t.shape) == (8, 8)
    assert _maxdiff(R_mesh, R_mesh_j) <= 5e-5
    assert _maxdiff(R_t, R_mesh) <= 5e-5  # float32 QR, the JAX test's tolerance
    # the same folds in the same order as JAX: equal to rounding of O(10)
    assert _maxdiff(R_t, R_j) <= 1e-5


# -- collectives --------------------------------------------------------------


def _collectives(run, label):
    from keystone_tpu.obs import Tracer as JTracer
    from keystone_tpu.obs import install as jinstall
    from keystone_tpu_torch.obs import Tracer, install

    jt, tt = jinstall(JTracer()), install(Tracer())
    try:
        run()
        return ([sp.attrs.get("collectives", 0) for sp in jt.spans()
                 if sp.name == "scan.pipeline" and sp.attrs["label"] == label],
                [sp.attrs.get("collectives", 0) for sp in tt.spans()
                 if sp.name == SCAN_SPAN and sp.attrs["label"] == label])
    finally:
        jtrace.reset()
        ttrace.reset()


@pytest.mark.parametrize("lanes", [1, 4])
def test_bcd_collectives_are_per_block_not_per_chunk_as_in_jax(lanes):
    A, y = _problem(n=192, d=16)
    means = A.mean(axis=0)
    counts = {}
    for rows in (48, 24):
        def run():
            kw = dict(reg=0.1, block_size=4, num_iter=1, lanes=lanes)
            jla.solve_blockwise_l2_streaming(_scan(A, rows), jnp.asarray(y),
                                             means=jnp.asarray(means), **kw)
            tla.solve_blockwise_l2_streaming(_scan(A, rows), _t(y), means=_t(means), **kw)
        counts[rows] = _collectives(run, "bcd.stream")
    (j48, t48), (j24, t24) = counts[48], counts[24]
    assert t48 == j48 and t24 == j24 and t48 == t24
    assert len(t48) == 4
    if lanes == 1:
        assert all(c == 0 for c in t48)
    else:
        assert all(0 < c <= 2 * lanes + 2 * (lanes - 1) for c in t48)


def test_weighted_collectives_are_per_block_not_per_chunk_as_in_jax():
    X, Y = _weighted_problem(n=192)
    counts = {}
    for rows in (48, 24):
        def run():
            kw = dict(block_size=8, num_iter=1, lam=1e-2, mixture_weight=0.25, class_chunk=2,
                      lanes=4)
            jla.solve_weighted_streaming(_scan(X, rows), jnp.asarray(Y), **kw)
            tla.solve_weighted_streaming(_scan(X, rows), _t(Y), **kw)
        counts[rows] = _collectives(run, "wls.stream")
    (j48, t48), (j24, t24) = counts[48], counts[24]
    assert t48 == j48 and t24 == j24 and t48 == t24 and len(t48) > 0


def test_normal_equations_and_tsqr_reduce_once_a_scan_as_in_jax():
    A, y = _problem(n=192, d=8)

    def run():
        pairs = lambda: iter([(A[i:i + 24], y[i:i + 24]) for i in range(0, 192, 24)])  # noqa: E731
        jla.solve_least_squares_streaming(pairs(), reg=0.1, lanes=8)
        tla.solve_least_squares_streaming(pairs(), reg=0.1, lanes=8)

    j, t = _collectives(run, "normal_eq")
    assert t == j == [14]  # G and C: 7 hops each

    def run_tsqr():
        jla.tsqr_r_streaming(_scan(A, 24), lanes=8)
        tla.tsqr_r_streaming(_scan(A, 24), lanes=8)

    j, t = _collectives(run_tsqr, "tsqr")
    assert t == j == [7]
