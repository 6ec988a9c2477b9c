"""The port's linear solvers against the JAX package on the CPU: the Gram
and cross products, the normal-equations solves, the block-coordinate-
descent solvers in both forms (a list of blocks and column views of one
matrix) with means and warm starts, and the linear estimators and mappers.

Tolerances: weights at rtol 1e-4 / atol 1e-5, the float32 sums of two
bindings in another order. On the test mesh of 8 virtual CPU devices the
JAX ``solve_blockwise_l2_scan`` may take its model-sharded compile, the
same algebra with the block sums split across devices: another order
again, inside the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.linalg import bcd as jbcd
from keystone_tpu.linalg import normal_equations as jne
from keystone_tpu.linalg import row_matrix as jrm
from keystone_tpu.nodes.learning import linear as jlinear
from keystone_tpu.nodes.util import VectorSplitter as JSplitter
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.linalg import bcd, normal_equations, row_matrix
from keystone_tpu_torch.nodes.learning.linear import (
    BlockLeastSquaresEstimator,
    BlockLinearMapper,
    LinearMapEstimator,
    LinearMapper,
)
from keystone_tpu_torch.nodes.util import VectorSplitter
from keystone_tpu_torch.workflow import fusion
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import Identity

W_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return np.asarray(a)


def _problem(n=256, d=24, k=3, seed=0, offset=0.5):
    """Features with nonzero column means, labels linear in them plus noise."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) + offset).astype(np.float32)
    W = rng.standard_normal((d, k)).astype(np.float32)
    Y = (X @ W + 0.1 * rng.standard_normal((n, k))).astype(np.float32)
    return X, Y


def test_gram_and_cross_match_jax():
    X, Y = _problem()
    # rtol 1e-5: 256-term float32 sums in another order
    np.testing.assert_allclose(row_matrix.gram(_t(X)).numpy(), _np(jrm.gram(jnp.asarray(X))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(row_matrix.cross(_t(X), _t(Y)).numpy(),
                               _np(jrm.cross(jnp.asarray(X), jnp.asarray(Y))),
                               rtol=1e-5, atol=1e-4)


def test_solve_spd_raises_where_jax_gives_nans():
    G = np.diag([1.0, -1.0, 2.0]).astype(np.float32)
    rhs = np.ones((3, 1), np.float32)
    assert np.isnan(_np(jrm.solve_spd(jnp.asarray(G), jnp.asarray(rhs)))).any()
    with pytest.raises(torch.linalg.LinAlgError):
        row_matrix.solve_spd(_t(G), _t(rhs))


@pytest.mark.parametrize("reg", [0.0, 3.0])
def test_normal_equations_match_jax(reg):
    X, Y = _problem(seed=1)
    got = normal_equations.solve_least_squares(_t(X), _t(Y), reg).numpy()
    want = _np(jne.solve_least_squares(jnp.asarray(X), jnp.asarray(Y), reg))
    np.testing.assert_allclose(got, want, **W_TOL)
    W, b = normal_equations.solve_least_squares_with_intercept(_t(X), _t(Y), reg)
    jW, jb = jne.solve_least_squares_with_intercept(jnp.asarray(X), jnp.asarray(Y), reg)
    np.testing.assert_allclose(W.numpy(), _np(jW), **W_TOL)
    assert b.shape == (3,)
    np.testing.assert_allclose(b.numpy(), _np(jb), rtol=1e-4, atol=1e-4)


def test_block_update_step_matches_jax():
    X, Y = _problem(seed=2)
    Aj, mj = X[:, 8:16], X[:, 8:16].mean(0)
    rng = np.random.default_rng(3)
    W_old = rng.standard_normal((8, 3)).astype(np.float32)
    pred = rng.standard_normal((256, 3)).astype(np.float32)
    jW, jpred = jbcd._block_update_impl(jnp.asarray(Aj), jnp.asarray(mj), jnp.asarray(W_old),
                                        jnp.asarray(pred), jnp.asarray(Y), 2.0)
    buf = _t(pred.copy())
    before = bcd._block_update_impl.steps
    W, out = bcd._block_update_impl(_t(X)[:, 8:16], _t(mj), _t(W_old), buf, _t(Y), 2.0)
    assert bcd._block_update_impl.steps == before + 1
    assert out is buf  # the prediction buffer is updated in place
    np.testing.assert_allclose(W.numpy(), _np(jW), **W_TOL)
    np.testing.assert_allclose(out.numpy(), _np(jpred), rtol=1e-4, atol=1e-4)


def test_block_means_match_jax():
    X, Y = _problem(seed=4)
    blocks = [X[:, :10], X[:, 10:24]]
    means, ym = bcd._block_means([_t(b) for b in blocks], _t(Y))
    jmeans, jym = jbcd._block_means([jnp.asarray(b) for b in blocks], jnp.asarray(Y))
    for m, jm in zip(means, jmeans):
        np.testing.assert_allclose(m.numpy(), _np(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ym.numpy(), _np(jym), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_iter", [1, 3])
@pytest.mark.parametrize("centered", [False, True])
def test_solve_blockwise_l2_matches_jax(num_iter, centered):
    X, Y = _problem(seed=5)
    widths = [(0, 10), (10, 16), (16, 24)]  # ragged blocks
    blocks = [X[:, a:b] for a, b in widths]
    means = [b.mean(0) for b in blocks] if centered else None
    Yc = Y - Y.mean(0) if centered else Y
    got = bcd.solve_blockwise_l2([_t(b) for b in blocks], _t(Yc), 1.5, num_iter,
                                 means=None if means is None else [_t(m) for m in means])
    want = jbcd.solve_blockwise_l2(
        [jnp.asarray(b) for b in blocks], jnp.asarray(Yc), 1.5, num_iter,
        means=None if means is None else [jnp.asarray(m) for m in means])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **W_TOL)


def test_solve_blockwise_l2_warm_start_matches_jax():
    X, Y = _problem(seed=6)
    blocks = [X[:, :12], X[:, 12:]]
    means = [b.mean(0) for b in blocks]
    rng = np.random.default_rng(7)
    init = [rng.standard_normal((b.shape[1], 3)).astype(np.float32) for b in blocks]
    got = bcd.solve_blockwise_l2([_t(b) for b in blocks], _t(Y), 0.5, 2,
                                 means=[_t(m) for m in means], init=[_t(w) for w in init])
    want = jbcd.solve_blockwise_l2([jnp.asarray(b) for b in blocks], jnp.asarray(Y), 0.5, 2,
                                   means=[jnp.asarray(m) for m in means],
                                   init=[jnp.asarray(w) for w in init])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **W_TOL)
    with pytest.raises(ValueError, match="init has 1 blocks"):
        bcd.solve_blockwise_l2([_t(b) for b in blocks], _t(Y), 0.5, init=[_t(init[0])])


@pytest.mark.parametrize("num_iter", [1, 2])
@pytest.mark.parametrize("centered", [False, True])
def test_solve_blockwise_l2_scan_matches_jax(num_iter, centered):
    X, Y = _problem(n=320, d=32, seed=8)
    means = X.mean(0) if centered else None
    got = bcd.solve_blockwise_l2_scan(_t(X), _t(Y), 2.0, 8, num_iter,
                                      means=None if means is None else _t(means))
    want = jbcd.solve_blockwise_l2_scan(jnp.asarray(X), jnp.asarray(Y), 2.0, 8, num_iter,
                                        means=None if means is None else jnp.asarray(means))
    assert got.shape == (32, 3)
    np.testing.assert_allclose(got.numpy(), _np(want), **W_TOL)


def test_solve_blockwise_l2_scan_warm_start_matches_jax():
    X, Y = _problem(n=320, d=32, seed=9)
    means = X.mean(0)
    init = np.random.default_rng(10).standard_normal((32, 3)).astype(np.float32)
    got = bcd.solve_blockwise_l2_scan(_t(X), _t(Y), 1.0, 16, 2, means=_t(means), init=_t(init))
    want = jbcd.solve_blockwise_l2_scan(jnp.asarray(X), jnp.asarray(Y), 1.0, 16, 2,
                                        means=jnp.asarray(means), init=jnp.asarray(init))
    np.testing.assert_allclose(got.numpy(), _np(want), **W_TOL)


def test_scan_reads_blocks_in_place_and_equals_the_list_form():
    X, Y = _problem(n=200, d=30, seed=11)
    A = _t(X)
    snapshot = A.clone()
    means = A.mean(0)
    before = bcd._block_update_impl.steps
    W = bcd.solve_blockwise_l2_scan(A, _t(Y), 0.7, 10, 2, means=means)
    assert bcd._block_update_impl.steps == before + 6  # 3 blocks × 2 passes
    assert torch.equal(A, snapshot)  # the design matrix is never written
    ws = bcd.solve_blockwise_l2([A[:, i:i + 10] for i in range(0, 30, 10)], _t(Y), 0.7, 2,
                                means=[means[i:i + 10] for i in range(0, 30, 10)])
    # the same steps on the same views: equal to float32 rounding
    np.testing.assert_allclose(W.numpy(), torch.cat(ws).numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        bcd.solve_blockwise_l2_scan(A, _t(Y), 0.7, 7)


def _factor_counts():
    return (bcd._block_update_impl.steps, bcd._block_solve.factors_formed,
            bcd._block_solve.factors_reused)


@pytest.mark.parametrize("rows", [256, 6], ids=["tall", "wider_than_rows"])
@pytest.mark.parametrize("form", ["list", "scan", "scan_on_a_model_axis"])
@pytest.mark.parametrize("num_iter", [1, 3])
def test_block_factors_are_kept_across_sweeps_and_match_jax(num_iter, form, rows):
    """Three blocks of 8: each block's Cholesky factor is formed on its first
    step and solves the later sweeps' steps, unless the block is wider than
    the rows; the weights stay those of the JAX scan, which forms every Gram
    anew. The model axis places each block (and its factor) on its slot."""
    from keystone_tpu_torch.parallel import mesh, virtual

    X, Y = _problem(n=rows, d=24, seed=21)
    means = X.mean(0)
    before = _factor_counts()
    if form == "list":
        got = torch.cat(bcd.solve_blockwise_l2(
            [_t(X)[:, i:i + 8] for i in range(0, 24, 8)], _t(Y), 1.5, num_iter,
            means=[_t(means)[i:i + 8] for i in range(0, 24, 8)]))
    elif form == "scan":
        got = bcd.solve_blockwise_l2_scan(_t(X), _t(Y), 1.5, 8, num_iter, means=_t(means))
    else:
        saved = (mesh._default_mesh, virtual._slots)
        virtual.provision_virtual_devices(8)
        try:
            with mesh.use_mesh(mesh.make_mesh(n_data=2, n_model=3)):
                assert bcd._bcd_scan_model_sharded(rows, 24, 8) is not None
                got = bcd.solve_blockwise_l2_scan(_t(X), _t(Y), 1.5, 8, num_iter,
                                                  means=_t(means))
        finally:
            mesh._default_mesh, virtual._slots = saved
    want = jbcd._bcd_scan(jnp.asarray(X), jnp.asarray(Y), jnp.float32(1.5), jnp.asarray(means),
                          block_size=8, num_iter=num_iter)
    np.testing.assert_allclose(got.numpy(), _np(want), **W_TOL)
    steps, formed, reused = (a - b for a, b in zip(_factor_counts(), before))
    assert steps == 3 * num_iter
    if rows >= 8:
        assert (formed, reused) == (3, 3 * (num_iter - 1))
    else:  # kept factors would outweigh the design matrix: every step factors
        assert (formed, reused) == (3 * num_iter, 0)
    assert bcd._KEPT_FACTORS.get() is None  # nothing outlives the solve


def test_a_singular_block_raises_in_the_first_sweep_at_that_block():
    """At λ = 0 a block with a zero column has no Cholesky factor: the solve
    raises at that block's first step, and the step count names the block
    (the count of steps done, modulo the blocks)."""
    X, Y = _problem(n=64, d=24, seed=22)
    X[:, 11] = 0.0  # block 1 of three
    blocks = [_t(X)[:, i:i + 8] for i in range(0, 24, 8)]
    before = _factor_counts()
    with pytest.raises(torch.linalg.LinAlgError):
        bcd.solve_blockwise_l2(blocks, _t(Y), 0.0, 3)
    steps, formed, reused = (a - b for a, b in zip(_factor_counts(), before))
    assert (steps, formed, reused) == (1, 1, 0)
    assert steps % len(blocks) == 1
    assert bcd._KEPT_FACTORS.get() is None


def test_linear_map_estimator_and_mapper_match_jax():
    X, Y = _problem(seed=12)
    model = LinearMapEstimator(lam=0.5).fit(Dataset.of(X), Dataset.of(Y))
    jmodel = jlinear.LinearMapEstimator(lam=0.5).fit(JDataset.of(X), JDataset.of(Y))
    np.testing.assert_allclose(model.W.numpy(), _np(jmodel.W), **W_TOL)
    np.testing.assert_allclose(model.b.numpy(), _np(jmodel.b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model.feature_mean.numpy(), _np(jmodel.feature_mean),
                               rtol=1e-6, atol=1e-6)
    got = model.forward(_t(X)).numpy()
    want = _np(jmodel.apply_batch(JDataset.of(X)).to_array())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    bare = LinearMapper(_t(np.eye(24, 3, dtype=np.float32)))
    np.testing.assert_array_equal(bare.forward(_t(X)).numpy(), X[:, :3])


def _fit_both(data_t, data_j, Y, **kw):
    model = BlockLeastSquaresEstimator(**kw).fit(data_t, Dataset.of(Y))
    jmodel = jlinear.BlockLeastSquaresEstimator(**kw).fit(data_j, JDataset.of(Y))
    return model, jmodel


def _assert_models_match(model, jmodel):
    assert len(model.xs) == len(jmodel.xs)
    for w, jw in zip(model.xs, jmodel.xs):
        np.testing.assert_allclose(w.numpy(), _np(jw), **W_TOL)
    for m, jm in zip(model.feature_means, jmodel.feature_means):
        np.testing.assert_allclose(m.numpy(), _np(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(model.b.numpy(), _np(jmodel.b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("block_size,num_iter", [(8, 1), (8, 3), (24, 1), (10, 2)])
def test_block_least_squares_matches_jax(block_size, num_iter):
    # 24 % 8 == 0 and 24 % 24 == 0 split evenly; block 10 leaves a ragged tail
    X, Y = _problem(seed=13)
    model, jmodel = _fit_both(Dataset.of(X), JDataset.of(X), Y,
                              block_size=block_size, num_iter=num_iter, lam=0.3)
    _assert_models_match(model, jmodel)
    got = model.forward(_t(X)).numpy()
    want = _np(jmodel.apply_batch(JDataset.of(X)).to_array())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_block_least_squares_on_presplit_blocks_matches_jax():
    X, Y = _problem(seed=14)
    blocks = [X[:, :9], X[:, 9:20], X[:, 20:]]
    tup = Dataset.of(tuple(_t(b) for b in blocks))
    jtup = JDataset(tuple(jnp.asarray(b) for b in blocks), batched=True)
    model, jmodel = _fit_both(tup, jtup, Y, block_size=11, num_iter=2, lam=0.3)
    _assert_models_match(model, jmodel)
    as_list = BlockLeastSquaresEstimator(11, 2, lam=0.3).fit(blocks, Dataset.of(Y))
    for w, w2 in zip(model.xs, as_list.xs):
        np.testing.assert_array_equal(w.numpy(), w2.numpy())


def test_block_solver_multiblock_agrees_with_exact():
    """Several blocks and passes ≈ the exact solve, at 1e-2 as in the JAX
    package's own test: BCD converges to the ridge solution, not onto it."""
    rng = np.random.default_rng(0)
    n, d, k = 256, 32, 3
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((d, k)).astype(np.float32)
    Y = X @ W + 0.01 * rng.standard_normal((n, k)).astype(np.float32)
    exact = LinearMapEstimator(lam=0.01).fit(Dataset.of(X), Dataset.of(Y))
    block = BlockLeastSquaresEstimator(8, 20, lam=0.01).fit(Dataset.of(X), Dataset.of(Y))
    np.testing.assert_allclose(block.forward(_t(X)).numpy(), exact.forward(_t(X)).numpy(),
                               rtol=1e-2, atol=1e-2)


def test_block_solver_apply_blocks_matches_fused():
    rng = np.random.default_rng(1)
    n, d, k = 64, 12, 2
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = rng.standard_normal((n, k)).astype(np.float32)
    model = BlockLeastSquaresEstimator(4, 2, lam=0.1).fit(Dataset.of(X), Dataset.of(Y))
    fused = model.forward(_t(X)).numpy()
    via_blocks = model.apply_blocks([_t(X[:, i:i + 4]) for i in range(0, d, 4)]).numpy()
    # 1e-4: three 4-term GEMMs summed against one 12-term GEMM
    np.testing.assert_allclose(via_blocks, fused, rtol=1e-4, atol=1e-4)


def test_vector_splitter_matches_jax():
    X = np.arange(5 * 11, dtype=np.float32).reshape(5, 11)
    got = VectorSplitter(4).forward(_t(X))
    want = JSplitter(4).split_batch(jnp.asarray(X))
    assert [g.shape for g in got] == [w.shape for w in want] == [(5, 4), (5, 4), (5, 3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert [g.shape[1] for g in VectorSplitter(4, num_features=6).forward(_t(X))] == [4, 2]


def test_block_mapper_applies_in_row_chunks(monkeypatch):
    """The fitted mapper is row-local: in a fused group, chunked, the
    pipeline's apply gives the whole-batch scores (to 1e-6: a GEMM of fewer
    rows may block its sums differently)."""
    X, Y = _problem(n=100, seed=15)
    model = BlockLeastSquaresEstimator(8, 1, lam=0.3).fit(Dataset.of(X), Dataset.of(Y))
    fitted = Identity().and_then(model).fit()
    (op,) = fitted.graph.operators.values()
    assert isinstance(op, fusion.FusedTransformerOperator) and op.row_local
    whole = fitted.apply(_t(X)).to_array()
    monkeypatch.setattr(fusion, "ROW_CHUNK", 7)
    chunked = fitted.apply(_t(X)).to_array()
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(whole, model.forward(_t(X)), rtol=0, atol=0)
    assert isinstance(model, BlockLinearMapper) and model.row_local
