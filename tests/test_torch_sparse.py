"""The port's sparse rows and the solvers that read them, against the JAX
package on the CPU, on the same numpy-seeded pairs:

* every ``SparseRows`` operation: ``from_pairs`` and ``from_scipy`` (equal
  indices and values), ``to_dense``, ``row_slice``, ``__getitem__``,
  ``density``, ``nnz``, ``datum_from_pairs`` exactly; ``matmul``,
  ``rmatmul``, ``class_sums`` and ``label_sums`` within rtol 1e-5 / atol
  1e-6 (float32 sums in another order: the JAX package scatters (n, m, k)
  contributions, the port adds into a flat accumulator);
* the ``Dataset`` payload: batched, indexed and iterated by row, never an
  item list;
* naive Bayes: π and θ within rtol 1e-6 / atol 1e-6 of JAX's (integer class
  sums, then the same logs), scores within 1e-5, sparse equal to dense;
* logistic regression on sparse rows: W within rtol 1e-3 / atol 1e-4 after
  40 L-BFGS steps (the same tolerance as the dense fit's), predictions
  equal;
* ``SparseLBFGSwithL2``'s Gram and gather/scatter strategies, each against
  the JAX package's same strategy (rtol 1e-3 / atol 1e-4), and against each
  other at the JAX suite's own agreement tolerance (rtol 2e-2 / atol 2e-3,
  ``tests/nodes/test_solvers.py:329``); the streamed Gram's row blocks;
* ``SparseLinearMapper`` on batches, pair lists and scipy items (1e-5);
* the cost model's sparsity read from a SparseRows sample and from scipy
  items, and the choice it leads to, at ``num_machines=1`` in both
  packages, the Amazon L-BFGS shape (n 262,144, d 16,384, 85 entries a
  row) included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import keystone_tpu.cost as jcost
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.data.sparse import SparseRows as JSparseRows
from keystone_tpu.nodes.learning import classifiers as jcls
from keystone_tpu.nodes.learning import lbfgs as jlbfgs
from keystone_tpu.nodes.learning import linear as jlinear
from keystone_tpu_torch import cost
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.data.sparse import SparseRows
from keystone_tpu_torch.nodes.learning import lbfgs
from keystone_tpu_torch.nodes.learning.classifiers import (
    LeastSquaresEstimator,
    LogisticRegressionEstimator,
    NaiveBayesEstimator,
)
from keystone_tpu_torch.nodes.learning.lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
from keystone_tpu_torch.nodes.learning.linear import SparseLinearMapper
from keystone_tpu_torch.nodes.util import Densify, Sparsify
from keystone_tpu_torch.workflow.env import PipelineEnv

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def port_env():
    env = PipelineEnv.get_or_create()
    env.reset()
    cost.reset_sampling()
    yield env
    env.reset()
    cost.reset_sampling()


def _pairs(seed=0, n=12, d=37, lo=0, hi=9, positive=False):
    """Per-row (index, value) pairs and the dense matrix they make; rows of
    ``lo`` entries and more (0 gives empty rows)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, d), dtype=np.float32)
    rows = []
    for i in range(n):
        nnz = int(rng.integers(lo, hi))
        idx = rng.choice(d, size=nnz, replace=False)
        vals = (rng.uniform(0.5, 2.0, nnz) if positive else rng.standard_normal(nnz))
        vals = vals.astype(np.float32)
        dense[i, idx] = vals
        rows.append(list(zip(idx.tolist(), vals.tolist())))
    return rows, dense


def _both(rows, d):
    return SparseRows.from_pairs(rows, d), JSparseRows.from_pairs(rows, d)


# ---- SparseRows --------------------------------------------------------------

def test_from_pairs_matches_jax_layout():
    rows, dense = _pairs()
    got, want = _both(rows, 37)
    assert got.shape == want.shape == (12, 37)
    assert got.row_capacity == want.row_capacity
    assert got.indices.dtype == torch.int64 and got.values.dtype == torch.float32
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.nnz == want.nnz
    assert got.density() == want.density()
    assert len(got) == 12


def test_from_pairs_keeps_the_largest_entries_past_the_capacity():
    rows = [[(0, 1.0), (3, -5.0), (7, 2.0), (9, 0.5)]]
    got = SparseRows.from_pairs(rows, 10, row_capacity=2)
    want = JSparseRows.from_pairs(rows, 10, row_capacity=2)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))


def test_from_scipy_and_to_dense_match_jax():
    mat = sp.random(20, 50, density=0.1, random_state=2, format="csr", dtype=np.float32)
    got, want = SparseRows.from_scipy(mat), JSparseRows.from_scipy(mat)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.to_dense().numpy(), np.asarray(want.to_dense()))
    np.testing.assert_array_equal(got.to_dense().numpy(), mat.toarray())
    assert got.to_dense(torch.float64).dtype == torch.float64


@pytest.mark.parametrize("lo", [0, 2], ids=["empty-rows", "full-rows"])
def test_products_match_jax(lo):
    rows, dense = _pairs(seed=lo, lo=lo)
    got, want = _both(rows, 37)
    rng = np.random.default_rng(7)
    W = rng.standard_normal((37, 5)).astype(np.float32)
    R = rng.standard_normal((12, 5)).astype(np.float32)
    y = rng.integers(0, 4, size=12)
    onehot = np.eye(4, dtype=np.float32)[y]
    np.testing.assert_array_equal(got.to_dense().numpy(), dense)
    np.testing.assert_allclose(got.matmul(torch.from_numpy(W)).numpy(),
                               np.asarray(want.matmul(W)), **SUM_TOL)
    np.testing.assert_allclose(got.rmatmul(torch.from_numpy(R)).numpy(),
                               np.asarray(want.rmatmul(R)), **SUM_TOL)
    np.testing.assert_allclose(got.class_sums(torch.from_numpy(onehot)).numpy(),
                               np.asarray(want.class_sums(onehot)), **SUM_TOL)
    np.testing.assert_allclose(got.label_sums(torch.from_numpy(y), 4).numpy(),
                               np.asarray(want.label_sums(y, 4)), **SUM_TOL)
    # and the dense oracle of the JAX suite
    np.testing.assert_allclose(got.rmatmul(torch.from_numpy(R)).numpy(), dense.T @ R,
                               rtol=1e-4, atol=1e-5)


def test_an_all_padding_batch_is_inert():
    got = SparseRows(torch.zeros((3, 8), dtype=torch.int64), torch.zeros((3, 8)), 5)
    assert got.nnz == 0 and got.density() == 0.0
    assert torch.equal(got.to_dense(), torch.zeros(3, 5))
    assert torch.equal(got.matmul(torch.ones(5, 2)), torch.zeros(3, 2))
    assert torch.equal(got.rmatmul(torch.ones(3, 2)), torch.zeros(5, 2))
    assert torch.equal(got.label_sums(torch.tensor([0, 1, 1]), 2), torch.zeros(2, 5))


def test_int32_indices_become_int64_once():
    idx = np.asarray([[1, 0], [2, 3]], dtype=np.int32)
    got = SparseRows(idx, np.ones((2, 2), np.float32), 4)
    assert got.indices.dtype == torch.int64
    moved = got.to("cpu")
    assert moved is got
    assert moved.to(torch.device("cpu")) is got


def test_slices_and_items_match_jax():
    rows, _ = _pairs(seed=3)
    got, want = _both(rows, 37)
    for a, b in ((got.row_slice(2, 7), want.row_slice(2, 7)), (got[4], want[4]),
                 (got[3:9], want[3:9])):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.to_dense().numpy(), np.asarray(b.to_dense()))


@pytest.mark.parametrize("x,is_pairs", [
    ([(1, 2.0), (4, -1.0)], True),
    ([], True),
    ([[3, 1.0]], True),
    ([1.0, 2.0], False),
    ("text", False),
])
def test_datum_from_pairs_matches_jax(x, is_pairs):
    got = SparseRows.datum_from_pairs(x, 6)
    want = JSparseRows.datum_from_pairs(x, 6)
    assert (got is not None) == (want is not None) == is_pairs
    if is_pairs:
        np.testing.assert_array_equal(got.to_dense().numpy(), np.asarray(want.to_dense()))


def test_dataset_takes_sparse_rows_as_a_batch():
    rows, dense = _pairs(seed=4)
    sr = SparseRows.from_pairs(rows, 37)
    ds = Dataset.of(sr)
    assert ds.is_batched and ds.payload is sr
    assert len(ds) == 12 and ds.to_array() is sr
    assert isinstance(ds.first(), SparseRows) and ds.first().shape == (1, 37)
    assert len(ds.take(5)) == 5 and isinstance(ds.take(5).payload, SparseRows)
    items = list(ds)
    assert len(items) == 12 and all(isinstance(r, SparseRows) and len(r) == 1 for r in items)
    np.testing.assert_array_equal(items[7].to_dense().numpy()[0], dense[7])
    assert Dataset(sr).is_batched and len(Dataset(sr).cache()) == 12


def test_densify_and_sparsify_match_jax():
    from keystone_tpu.nodes.util.core import Densify as JDensify, Sparsify as JSparsify

    _, dense = _pairs(seed=5)
    csr = Sparsify().apply(torch.from_numpy(dense[2]))
    assert sp.issparse(csr)
    assert (csr != JSparsify().apply(dense[2])).nnz == 0
    np.testing.assert_array_equal(Densify().apply(csr).numpy(), dense[2])
    np.testing.assert_array_equal(Densify().apply(csr).numpy(), np.asarray(JDensify().apply(csr)))
    np.testing.assert_array_equal(Densify().apply(dense[3]).numpy(), dense[3])


# ---- naive Bayes and logistic regression -------------------------------------

def _labeled_problem(seed=0, n=64, d=40, k=3):
    rows, dense = _pairs(seed=seed, n=n, d=d, lo=2, hi=10, positive=True)
    y = np.random.default_rng(seed + 100).integers(0, k, size=n).astype(np.int32)
    return rows, dense, y


def test_naive_bayes_on_sparse_rows_matches_jax():
    rows, dense, y = _labeled_problem()
    got_x, want_x = _both(rows, 40)
    got = NaiveBayesEstimator(3).fit(Dataset(got_x), Dataset.of(y))
    want = jcls.NaiveBayesEstimator(3).fit(JDataset(want_x, batched=True), JDataset.of(y))
    np.testing.assert_allclose(got.pi.numpy(), np.asarray(want.pi), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), rtol=1e-6, atol=1e-6)
    scores = got.apply_batch(Dataset(got_x)).to_array().numpy()
    np.testing.assert_allclose(
        scores, np.asarray(want.apply_batch(JDataset(want_x, batched=True)).to_array()),
        rtol=1e-5, atol=1e-5)
    # sparse equals dense
    dense_model = NaiveBayesEstimator(3).fit(Dataset.of(dense), Dataset.of(y))
    np.testing.assert_allclose(got.theta.numpy(), dense_model.theta.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(scores, dense_model.forward(torch.from_numpy(dense)).numpy(),
                               rtol=1e-4, atol=1e-4)
    # one item as a pair list
    np.testing.assert_allclose(got.apply(rows[3]).numpy(), np.asarray(want.apply(rows[3])),
                               rtol=1e-5, atol=1e-5)


def test_logistic_regression_on_sparse_rows_matches_jax():
    rng = np.random.default_rng(5)
    n, d = 200, 30
    y = rng.integers(0, 2, size=n)
    rows = [[(int(y[i]) * 3, 3.0), (int(rng.integers(6, d)), 1.0)] for i in range(n)]
    got_x, want_x = _both(rows, d)
    got = LogisticRegressionEstimator(2, num_iters=40).fit(Dataset(got_x), Dataset.of(y))
    want = jcls.LogisticRegressionEstimator(2, num_iters=40).fit(
        JDataset(want_x, batched=True), JDataset.of(y))
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), **FIT_TOL)
    pred = got.apply_batch(Dataset(got_x)).to_array().numpy()
    np.testing.assert_array_equal(
        pred, np.asarray(want.apply_batch(JDataset(want_x, batched=True)).to_array()))
    assert (pred == y).mean() > 0.95  # the JAX suite's bound
    assert int(got.apply(rows[0])) == int(np.asarray(want.apply(rows[0])))


def test_sparse_logistic_objective_matches_the_dense_one():
    rows, dense, y = _labeled_problem(seed=2)
    X = SparseRows.from_pairs(rows, 40)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(y).long(), 3).float()
    W = torch.from_numpy(np.random.default_rng(3).standard_normal((40, 3)).astype(np.float32))
    from keystone_tpu_torch.nodes.learning import classifiers

    fs, gs = classifiers._sparse_logistic_value_and_grad(W, X, onehot, 0.1)
    fd, gd = classifiers._logistic_value_and_grad(W, torch.from_numpy(dense), onehot, 0.1)
    np.testing.assert_allclose(fs.item(), fd.item(), rtol=1e-5)
    np.testing.assert_allclose(gs.numpy(), gd.numpy(), rtol=1e-4, atol=1e-6)


# ---- SparseLBFGSwithL2 and SparseLinearMapper --------------------------------

def _lbfgs_problem(seed=21, n=256, d=96, k=2):
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n, d)) < 0.1) * rng.standard_normal((n, d))).astype(np.float32)
    Y = np.sign(rng.standard_normal((n, k))).astype(np.float32)
    return sp.csr_matrix(dense), dense, Y


@pytest.mark.parametrize("budget", [1e9, 0], ids=["gram", "gather_scatter"])
def test_sparse_lbfgs_strategy_matches_jax(budget):
    mat, _, Y = _lbfgs_problem()
    kw = dict(reg_param=1e-2, num_iterations=30, gram_budget_bytes=budget)
    got = SparseLBFGSwithL2(**kw).fit(Dataset(SparseRows.from_scipy(mat)), Dataset.of(Y))
    want = jlbfgs.SparseLBFGSwithL2(**kw).fit(
        JDataset(JSparseRows.from_scipy(mat), batched=True), JDataset.of(Y))
    assert isinstance(got, SparseLinearMapper) and got.W.shape == (96, 2)
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), **FIT_TOL)


def test_sparse_lbfgs_one_label_column_keeps_w_two_dimensional():
    mat, _, Y = _lbfgs_problem(k=1)
    for budget in (1e9, 0):
        kw = dict(reg_param=1e-2, num_iterations=30, gram_budget_bytes=budget)
        got = SparseLBFGSwithL2(**kw).fit(Dataset(SparseRows.from_scipy(mat)), Dataset.of(Y))
        want = jlbfgs.SparseLBFGSwithL2(**kw).fit(
            JDataset(JSparseRows.from_scipy(mat), batched=True), JDataset.of(Y))
        assert got.W.shape == tuple(np.asarray(want.W).shape) == (96, 1)
        np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), **FIT_TOL)


def test_sparse_lbfgs_strategies_agree():
    """The JAX suite's strategy-agreement test on the port."""
    mat, _, Y = _lbfgs_problem()
    X = SparseRows.from_scipy(mat)

    def fit(budget):
        est = SparseLBFGSwithL2(reg_param=1e-3, num_iterations=200, convergence_tol=1e-9,
                                gram_budget_bytes=budget)
        return est.fit(Dataset(X), Dataset.of(Y)).W.numpy()

    np.testing.assert_allclose(fit(0), fit(1e9), rtol=2e-2, atol=2e-3)


def test_streamed_gram_over_many_blocks_equals_one_block(monkeypatch):
    # the JAX package's bound on a block at the Amazon shape: 4096 rows
    assert lbfgs.gram_row_chunk(16384, 85) == 4096
    mat, dense, Y = _lbfgs_problem(n=300)
    X = SparseRows.from_scipy(mat)
    monkeypatch.setattr(lbfgs, "GRAM_BLOCK_BYTES", 4 * 96 * 64)  # 64 rows a block
    assert lbfgs.gram_row_chunk(96, X.row_capacity) == 64
    G, c = lbfgs.streamed_gram(X, torch.from_numpy(Y))
    np.testing.assert_allclose(G.numpy(), dense.T @ dense, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), dense.T @ Y, rtol=1e-5, atol=1e-5)


def test_sparse_lbfgs_matches_dense_lbfgs():
    rows, dense, y = _labeled_problem(seed=3)
    B = np.eye(3, dtype=np.float32)[y] * 2 - 1
    m_sparse = SparseLBFGSwithL2(reg_param=0.1, num_iterations=60).fit(
        Dataset(SparseRows.from_pairs(rows, 40)), Dataset.of(B))
    m_dense = DenseLBFGSwithL2(reg_param=0.1, num_iterations=60).fit(Dataset.of(dense),
                                                                      Dataset.of(B))
    np.testing.assert_allclose(m_sparse.W.numpy(), m_dense.W.numpy(), rtol=5e-2, atol=5e-3)
    out = m_sparse.apply_batch(Dataset(SparseRows.from_pairs(rows, 40))).to_array().numpy()
    np.testing.assert_allclose(out, dense @ m_sparse.W.numpy(), rtol=1e-4, atol=1e-4)


def test_sparse_lbfgs_accepts_scipy_items():
    rng = np.random.default_rng(3)
    n, d = 80, 20
    dense = (rng.random((n, d)) < 0.2) * rng.standard_normal((n, d))
    items = [sp.csr_matrix(dense[i: i + 1]) for i in range(n)]
    W = rng.standard_normal((d, 2)).astype(np.float32)
    Y = dense.astype(np.float32) @ W
    got = SparseLBFGSwithL2(reg_param=0.0, num_iterations=100).fit(Dataset.from_items(items),
                                                                   Dataset.of(Y))
    np.testing.assert_allclose(got.W.numpy(), W, rtol=5e-2, atol=5e-2)
    want = jlbfgs.SparseLBFGSwithL2(reg_param=0.0, num_iterations=100).fit(
        JDataset.from_items(items), JDataset.of(Y))
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("with_b", [False, True])
def test_sparse_linear_mapper_matches_jax(with_b):
    rows, dense = _pairs(seed=8)
    rng = np.random.default_rng(9)
    W = rng.standard_normal((37, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32) if with_b else None
    got = SparseLinearMapper(torch.from_numpy(W), None if b is None else torch.from_numpy(b))
    want = jlinear.SparseLinearMapper(W, b)
    got_x, want_x = _both(rows, 37)
    np.testing.assert_allclose(got.apply_batch(Dataset(got_x)).to_array().numpy(),
                               np.asarray(want.apply_batch(JDataset(want_x, batched=True))
                                          .to_array()), **SUM_TOL)
    np.testing.assert_allclose(got.apply(rows[2]).numpy(), np.asarray(want.apply(rows[2])),
                               **SUM_TOL)
    item = sp.csr_matrix(dense[5:6])
    np.testing.assert_allclose(got.apply(item).numpy(), np.asarray(want.apply(item)), **SUM_TOL)
    block = sp.csr_matrix(dense[:3])
    np.testing.assert_allclose(got.apply(block).numpy(), np.asarray(want.apply(block)),
                               **SUM_TOL)
    np.testing.assert_allclose(got.apply_batch(Dataset.of(dense)).to_array().numpy(),
                               np.asarray(want.apply_batch(JDataset.of(dense)).to_array()),
                               **SUM_TOL)


# ---- the cost model reads sparsity ------------------------------------------

def _amazon_sample(rows=24, n=262144, d=16384, nnz=85):
    """The first rows of ``bench.py``'s Amazon L-BFGS problem (seed 17)."""
    rng = np.random.default_rng(17)
    idx = rng.integers(0, d, size=(n, nnz), dtype=np.int64)[:rows].astype(np.int32)
    val = rng.standard_normal((rows, nnz)).astype(np.float32)
    return idx, val


def _choices(sample_t, sample_j, labels, n):
    got_shape = LeastSquaresEstimator(lam=1e-7, num_machines=1).shape_from_samples(
        [sample_t, Dataset.of(labels)], n)
    want_shape = jcls.LeastSquaresEstimator(lam=1e-7, num_machines=1).shape_from_samples(
        [sample_j, JDataset.of(labels)], n)
    got = LeastSquaresEstimator(lam=1e-7, num_machines=1).choose_solver(got_shape)
    want = jcls.LeastSquaresEstimator(lam=1e-7, num_machines=1).choose_solver(want_shape)
    return got_shape, want_shape, got, want


@pytest.mark.parametrize("form", ["sparse_rows", "scipy_items", "amazon_lbfgs"])
def test_the_chooser_reads_sparsity_as_jax_does(form):
    if form == "amazon_lbfgs":
        idx, val = _amazon_sample()
        sample_t = Dataset(SparseRows(idx, val, 16384))
        sample_j = JDataset(JSparseRows(jnp.asarray(idx), jnp.asarray(val), 16384), batched=True)
        labels, n = np.ones((24, 1), np.float32), 262144
    elif form == "sparse_rows":
        rows, _ = _pairs(seed=6, n=24, d=4096, lo=1, hi=40)
        sample_t, sample_j = (Dataset(s) if i == 0 else JDataset(s, batched=True)
                              for i, s in enumerate(_both(rows, 4096)))
        labels, n = np.ones((24, 2), np.float32), 50000
    else:
        items = [sp.csr_matrix(np.eye(1, 10000, k=i % 100)) for i in range(50)]
        sample_t, sample_j = Dataset.from_items(items), JDataset.from_items(items)
        labels, n = np.ones((50, 2), np.float32), 50
    got_shape, want_shape, got, want = _choices(sample_t, sample_j, labels, n)
    assert (got_shape.n, got_shape.d, got_shape.k, got_shape.machines) == (
        want_shape.n, want_shape.d, want_shape.k, want_shape.machines)
    assert got_shape.sparsity == pytest.approx(want_shape.sparsity, rel=1e-12)
    assert got_shape.sparsity < 0.02
    assert got.label == want.label
    for name, row in got.costs.items():
        assert row["units"] == pytest.approx(want.costs[name]["units"], rel=1e-12)
    if form != "amazon_lbfgs":
        assert got.label == "SparseLBFGSwithL2"


def test_the_chooser_prices_dense_samples_at_sparsity_one():
    X = np.random.default_rng(0).standard_normal((24, 30)).astype(np.float32)
    shape = LeastSquaresEstimator(num_machines=1).shape_from_samples(
        [Dataset.of(X), Dataset.of(np.ones((24, 3), np.float32))], 1000)
    assert (shape.n, shape.d, shape.k, shape.sparsity) == (1000, 30, 3, 1.0)
    want = jcls.LeastSquaresEstimator(num_machines=1).shape_from_samples(
        [JDataset.of(X), JDataset.of(np.ones((24, 3), np.float32))], 1000)
    assert isinstance(want, jcost.ShapeSignature) and want.sparsity == 1.0
