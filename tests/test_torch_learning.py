"""The port's learning nodes of slice 5 against the JAX package on the CPU,
float32 throughout:

* ``minimize_lbfgs``: the iterates after 1, 2, … steps (the JAX loop is
  deterministic, so its first k steps are ``max_iterations=k``), on a
  least-squares problem and on an ill-scaled quadratic that backtracks —
  rtol 1e-4 / atol 1e-5, float32 vdots summed in another order;
* Dense and Sparse L-BFGS on dense data, LocalLeastSquares (rtol 1e-3 /
  atol 1e-4 after 20 steps or one n×n solve);
* TSQR: ``tsqr_r`` with the sign fix (atol 1e-4 of the largest |R|), the
  estimator against the JAX one and the exact solve (rtol 1e-4 / atol
  1e-4), ``cost_signature``;
* ``LeastSquaresEstimator``: the cold choice and every option's units
  (rel 1e-12, the same float64 arithmetic), with ``num_machines=1`` in both
  packages (the JAX tests run on 8 virtual devices, whose mesh size would
  otherwise price another cluster); the plan ``NodeOptimizationRule``
  makes and the fit it leads to;
* naive Bayes (rtol 1e-5), logistic regression (rtol 1e-3 / atol 1e-4,
  predictions equal) and LDA (atol 1e-5 after the eigenvectors' signs are
  normalised).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keystone_tpu.cost as jcost
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.linalg import tsqr as jtsqr
from keystone_tpu.nodes.learning import classifiers as jcls
from keystone_tpu.nodes.learning import lbfgs as jlbfgs
from keystone_tpu.nodes.learning import linear as jlinear
from keystone_tpu.nodes.stats import CosineRandomFeatures as JCosine
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu_torch import cost
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.linalg import tsqr
from keystone_tpu_torch.nodes.learning import lbfgs
from keystone_tpu_torch.nodes.learning.classifiers import (
    LeastSquaresEstimator,
    LinearDiscriminantAnalysis,
    LogisticRegressionEstimator,
    LogisticRegressionModel,
    NaiveBayesEstimator,
    NaiveBayesModel,
)
from keystone_tpu_torch.nodes.learning.lbfgs import (
    DenseLBFGSwithL2,
    LocalLeastSquaresEstimator,
    SparseLBFGSwithL2,
)
from keystone_tpu_torch.nodes.learning.linear import (
    BlockLeastSquaresEstimator,
    LinearMapEstimator,
    LinearMapper,
    TSQRLeastSquaresEstimator,
)
from keystone_tpu_torch.nodes.stats import CosineRandomFeatures
from keystone_tpu_torch.workflow.env import PipelineEnv

ITER_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state and sampling counts, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    cost.reset_sampling()
    yield env
    env.reset()
    cost.reset_sampling()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ls_problem(n=160, d=30, k=3, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) * np.linspace(0.3, 3.0, d)).astype(np.float32)
    Y = (X @ rng.standard_normal((d, k)) + 0.2 * rng.standard_normal((n, k))).astype(np.float32)
    return X, Y


# ---- L-BFGS ------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 2, 3, 5, 8, 12])
def test_lbfgs_iterates_match_jax_on_least_squares(steps):
    X, Y = _ls_problem()
    W0 = np.zeros((30, 3), np.float32)
    got = lbfgs.minimize_lbfgs(lbfgs._ls_value_and_grad, _t(W0), max_iterations=steps,
                               convergence_tol=1e-9, vag_args=(_t(X), _t(Y), 0.1))
    want = jlbfgs.minimize_lbfgs(jlbfgs._ls_value_and_grad, W0, max_iterations=steps,
                                 convergence_tol=1e-9,
                                 vag_args=(jnp.asarray(X), jnp.asarray(Y), jnp.float32(0.1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ITER_TOL)


@pytest.mark.parametrize("steps", [1, 2, 3, 4, 6])
def test_lbfgs_iterates_match_jax_when_backtracking(steps):
    """An ill-scaled quadratic from far off: step 1 overshoots, so the line
    search halves, and the memory's γ scaling matters."""
    scales = np.logspace(0, 2, 16).astype(np.float32)
    w0 = np.full(16, 50.0, np.float32)
    got = lbfgs.minimize_lbfgs(lambda w, s: (0.5 * torch.sum(s * w * w), s * w), _t(w0),
                               max_iterations=steps, convergence_tol=1e-12,
                               vag_args=(_t(scales),))
    want = jlbfgs.minimize_lbfgs(lambda w, s: (0.5 * jnp.sum(s * w * w), s * w), w0,
                                 max_iterations=steps, convergence_tol=1e-12,
                                 vag_args=(jnp.asarray(scales),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ITER_TOL)


def test_lbfgs_memory_holds_at_most_the_corrections():
    """With 2 corrections the run differs from 10 and still matches JAX's."""
    X, Y = _ls_problem(seed=1)
    W0 = np.zeros((30, 3), np.float32)
    args_t, args_j = (_t(X), _t(Y), 0.0), (jnp.asarray(X), jnp.asarray(Y), jnp.float32(0.0))
    got = lbfgs.minimize_lbfgs(lbfgs._ls_value_and_grad, _t(W0), max_iterations=6,
                               num_corrections=2, convergence_tol=1e-9, vag_args=args_t)
    want = jlbfgs.minimize_lbfgs(jlbfgs._ls_value_and_grad, W0, max_iterations=6,
                                 num_corrections=2, convergence_tol=1e-9, vag_args=args_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ITER_TOL)
    ten = lbfgs.minimize_lbfgs(lbfgs._ls_value_and_grad, _t(W0), max_iterations=6,
                               convergence_tol=1e-9, vag_args=args_t)
    assert not torch.allclose(got, ten)


def test_lbfgs_reaches_the_optimum_and_stops_on_a_flat_objective():
    rng = np.random.default_rng(5)
    M = rng.standard_normal((24, 24)).astype(np.float32)
    H = M @ M.T + 0.5 * np.eye(24, dtype=np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    w = lbfgs.minimize_lbfgs(lambda w, H, b: (0.5 * torch.dot(w, H @ w) - torch.dot(b, w),
                                              H @ w - b),
                             torch.zeros(24), max_iterations=100, convergence_tol=1e-12,
                             vag_args=(_t(H), _t(b)))
    w_jax = jlbfgs.minimize_lbfgs(lambda w, H, b: (0.5 * jnp.dot(w, H @ w) - jnp.dot(b, w),
                                                   H @ w - b),
                                  jnp.zeros(24), max_iterations=100, convergence_tol=1e-12,
                                  vag_args=(jnp.asarray(H), jnp.asarray(b)))
    # What a float32 L-BFGS can promise is an objective gap, not w to 1e-3.
    # Near the optimum its f is a float32 sum of terms whose magnitudes add
    # up to Σ|terms| = ½|w*|ᵀ|H||w*| + |b|ᵀ|w*| (159 here, against |f*| =
    # 1.96), so one evaluation rounds by about u·Σ|terms| (u = 2⁻²⁴; 9.5e-6)
    # and the line search cannot tell apart points closer than that. The
    # gap, in float64, is held to 4 such roundings; since the gap is
    # ½(w − w*)ᵀH(w − w*), w is then within sqrt(2·gap / λ_min) of w*; and
    # the port's gap is within 8 × the JAX run's plus one rounding. (The
    # bound on w restates the gap bound in w's terms; it adds no check.)
    H64, b64 = H.astype(np.float64), b.astype(np.float64)
    w_star = np.linalg.solve(H64, b64)
    lam_min = np.linalg.eigvalsh(H64)[0]  # 0.565; the largest is 86.8

    def gap(v):
        v = np.asarray(v, np.float64)
        return 0.5 * (v - w_star) @ H64 @ (v - w_star)

    rounding = 2.0 ** -24 * (0.5 * np.abs(w_star) @ np.abs(H64) @ np.abs(w_star)
                             + np.abs(b64) @ np.abs(w_star))
    gap_limit = 4 * rounding
    assert gap(w.numpy()) <= gap_limit, (gap(w.numpy()), gap_limit)
    assert np.linalg.norm(w.numpy() - w_star) <= np.sqrt(2 * gap_limit / lam_min)
    assert gap(w.numpy()) <= 8 * gap(w_jax) + rounding, (gap(w.numpy()), gap(w_jax))
    # a constant objective: zero gradient, the line search accepts step 1
    # (a zero move) and the run converges at the start point
    w0 = torch.ones(4)
    flat = lbfgs.minimize_lbfgs(lambda w: (torch.tensor(1.0), torch.zeros_like(w)), w0,
                                max_iterations=30)
    np.testing.assert_array_equal(flat.numpy(), w0.numpy())


@pytest.mark.parametrize("cls", [DenseLBFGSwithL2, SparseLBFGSwithL2])
@pytest.mark.parametrize("reg", [0.0, 0.5])
def test_lbfgs_estimators_on_dense_data_match_jax(cls, reg):
    # unscaled columns: a well-conditioned problem that converges in a few
    # steps (on the ill-scaled one the two float32 runs drift apart by 1e-3
    # after a dozen steps at λ = 0, as rounding grows with the condition)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((200, 12)).astype(np.float32)
    Y = (X @ rng.standard_normal((12, 3)) + 0.2 * rng.standard_normal((200, 3))).astype(
        np.float32)
    kw = dict(reg_param=reg, num_iterations=20)
    got = cls(**kw).fit(Dataset.of(X), Dataset.of(Y))
    want = getattr(jlbfgs, cls.__name__)(**kw).fit(JDataset.of(X), JDataset.of(Y))
    assert isinstance(got, LinearMapper) and got.b is None and got.feature_mean is None
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=1e-3, atol=1e-4)


def test_sparse_lbfgs_refuses_sparse_rows_for_now():
    """Sparse rows are ported now: scipy items fit as one SparseRows
    batch into a SparseLinearMapper whose W matches the JAX fit's."""
    sp = pytest.importorskip("scipy.sparse")
    from keystone_tpu_torch.nodes.learning.linear import SparseLinearMapper

    items = [sp.csr_matrix(np.eye(1, 8, k=i)) for i in range(4)]
    Y = np.ones((4, 1), np.float32)
    got = SparseLBFGSwithL2().fit(Dataset.from_items(items), Dataset.of(Y))
    want = jlbfgs.SparseLBFGSwithL2().fit(JDataset.from_items(items), JDataset.of(Y))
    assert isinstance(got, SparseLinearMapper) and got.W.shape == (8, 1)
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=1e-3, atol=1e-4)


def test_local_least_squares_matches_jax():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((30, 100)).astype(np.float32)
    Y = rng.standard_normal((30, 2)).astype(np.float32)
    got = LocalLeastSquaresEstimator(1.0).fit(Dataset.of(X), Dataset.of(Y))
    want = jlbfgs.LocalLeastSquaresEstimator(1.0).fit(JDataset.of(X), JDataset.of(Y))
    for name in ("W", "b", "feature_mean"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-3, atol=1e-4)


# ---- TSQR ----------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(200, 12), (64, 64), (1000, 37)])
def test_tsqr_r_matches_jax(n, d):
    A = np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)
    got = tsqr.tsqr_r(_t(A)).numpy()
    want = np.asarray(jtsqr.tsqr_r(jnp.asarray(A)))
    assert got.shape == want.shape == (d, d)
    assert np.all(np.diag(got) >= 0) and np.allclose(np.tril(got, -1), 0.0)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got.T @ got, A.T @ A, rtol=1e-4, atol=1e-3 * n)


def test_fix_sign_matches_jax():
    R = np.array([[-2.0, 1.0, 3.0], [0.0, 0.0, 4.0], [0.0, 0.0, -5.0]], np.float32)
    np.testing.assert_array_equal(tsqr._fix_sign(_t(R)).numpy(),
                                  np.asarray(jtsqr._fix_sign(jnp.asarray(R))))


@pytest.mark.parametrize("shape", [(50000, 440, 147), (2000, 4096, 0), (7, 3, 2)])
@pytest.mark.parametrize("machines", [1, 8])
def test_tsqr_cost_signature_matches_jax(shape, machines):
    assert tsqr.cost_signature(*shape, machines) == jtsqr.cost_signature(*shape, machines)


@pytest.mark.parametrize("lam", [0.0, 2.5])
def test_tsqr_estimator_matches_jax_and_the_exact_solve(lam):
    rng = np.random.default_rng(6)
    X = (rng.standard_normal((300, 20)) + 0.7).astype(np.float32)
    Y = (X @ rng.standard_normal((20, 4)) + 0.1 * rng.standard_normal((300, 4))).astype(
        np.float32)
    got = TSQRLeastSquaresEstimator(lam).fit(Dataset.of(X), Dataset.of(Y))
    want = jlinear.TSQRLeastSquaresEstimator(lam).fit(JDataset.of(X), JDataset.of(Y))
    exact = LinearMapEstimator(lam).fit(Dataset.of(X), Dataset.of(Y))
    for name in ("W", "b", "feature_mean"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.W.numpy(), exact.W.numpy(), rtol=1e-4, atol=1e-4)


# ---- costs and the solver choice ----------------------------------------------------

SOLVERS = {
    "DenseLBFGSwithL2": (DenseLBFGSwithL2(reg_param=0.5, num_iterations=20),
                         jlbfgs.DenseLBFGSwithL2(reg_param=0.5, num_iterations=20)),
    "SparseLBFGSwithL2": (SparseLBFGSwithL2(num_iterations=20),
                          jlbfgs.SparseLBFGSwithL2(num_iterations=20)),
    "BlockLeastSquaresEstimator": (BlockLeastSquaresEstimator(1000, 3),
                                   jlinear.BlockLeastSquaresEstimator(1000, 3)),
    "LinearMapEstimator": (LinearMapEstimator(0.1), jlinear.LinearMapEstimator(0.1)),
    "TSQRLeastSquaresEstimator": (TSQRLeastSquaresEstimator(0.1),
                                  jlinear.TSQRLeastSquaresEstimator(0.1)),
}
WEIGHTS = (3.8e-4, 2.9e-1, 1.32)


@pytest.mark.parametrize("name", sorted(SOLVERS))
@pytest.mark.parametrize("shape", [(50000, 440, 147, 1.0, 1), (1000000, 4096, 2, 0.01, 1),
                                   (2000, 204800, 10, 1.0, 8)])
def test_solver_costs_match_jax(name, shape):
    got, want = SOLVERS[name]
    assert got.cost(*shape, *WEIGHTS) == pytest.approx(want.cost(*shape, *WEIGHTS), rel=1e-12)


def test_solver_weights_match_jax():
    for got, want in ((DenseLBFGSwithL2(num_iterations=20), jlbfgs.DenseLBFGSwithL2(
            num_iterations=20)), (BlockLeastSquaresEstimator(1000, 3),
                                  jlinear.BlockLeastSquaresEstimator(1000, 3))):
        assert got.weight == want.weight
    assert DenseLBFGSwithL2(num_iterations=20).weight == 21
    assert BlockLeastSquaresEstimator(1000, 5).weight == 16


CHOICES = [
    ((50000, 440, 147), "LinearMapEstimator"),
    ((1000000, 440, 147), "LinearMapEstimator"),
    ((2000, 4096, 147), "LinearMapEstimator"),
    ((50000, 4096, 147), "BlockLeastSquaresEstimator"),
    ((200000, 4096, 147), "BlockLeastSquaresEstimator"),
    ((50000, 16384, 147), "BlockLeastSquaresEstimator"),
    ((50000, 204800, 147), "BlockLeastSquaresEstimator"),
    ((50000, 4096, 2, 0.01), "SparseLBFGSwithL2"),
]


@pytest.mark.parametrize("shape,label", CHOICES, ids=[str(s) for s, _ in CHOICES])
def test_least_squares_cold_choice_matches_jax(shape, label):
    n, d, k, *sparsity = shape
    kw = dict(n=n, d=d, k=k, sparsity=sparsity[0] if sparsity else 1.0, machines=1)
    got = LeastSquaresEstimator(lam=0.0, num_machines=1).choose_solver(cost.ShapeSignature(**kw))
    want = jcls.LeastSquaresEstimator(lam=0.0, num_machines=1).choose_solver(
        jcost.ShapeSignature(**kw))
    assert got.label == want.label == label
    assert list(got.costs) == list(want.costs)
    for name, row in got.costs.items():
        assert row["units"] == pytest.approx(want.costs[name]["units"], rel=1e-12)
    if label == "BlockLeastSquaresEstimator":
        assert (got.chosen.block_size, got.chosen.num_iter) == (1000, 3)


def test_least_squares_options_are_the_jax_options():
    got, want = LeastSquaresEstimator(lam=2.0), jcls.LeastSquaresEstimator(lam=2.0)
    assert [type(o).__name__ for o in got.options] == [type(o).__name__ for o in want.options]
    assert got.default is got.options[0]
    assert (got.cpu_weight, got.mem_weight, got.network_weight) == (
        want.cpu_weight, want.mem_weight, want.network_weight)
    assert all(getattr(o, "lam", getattr(o, "reg_param", None)) == 2.0 for o in got.options)


def _chosen(graph, classes):
    return [op for op in graph.operators.values() if type(op).__name__ in classes]


SOLVER_NAMES = set(SOLVERS) | {"LeastSquaresEstimator"}


@pytest.mark.parametrize("featurized,label", [(False, "LinearMapEstimator"),
                                              (True, "BlockLeastSquaresEstimator")])
def test_node_optimization_plan_at_timit_scale_matches_jax(featurized, label):
    """TIMIT's 50000 rows, planned from 24 sampled items: the raw 440-wide
    frames take the exact solve, one 4096-wide cosine branch the block
    solver (1000, 3). Only the plan is made here; nothing is fit."""
    X = np.zeros((50000, 440), np.float32)
    Y = np.zeros((50000, 147), np.float32)
    if featurized:
        ref = JCosine.create(440, 4096, 0.05555, seed=0)
        j_pipe = ref.and_then(jcls.LeastSquaresEstimator(num_machines=1), JDataset.of(X),
                              JDataset.of(Y))
        t_pipe = CosineRandomFeatures.from_reference(np.asarray(ref.W), np.asarray(ref.b),
                                                     "cpu").and_then(
            LeastSquaresEstimator(num_machines=1), _t(X), _t(Y))
    else:
        j_pipe = jcls.LeastSquaresEstimator(num_machines=1).with_data(JDataset.of(X),
                                                                      JDataset.of(Y))
        t_pipe = LeastSquaresEstimator(num_machines=1).with_data(_t(X), _t(Y))
    jg, _ = JPipelineEnv.get_or_create().optimizer.execute(j_pipe.graph)
    tg, _ = PipelineEnv.get_or_create().optimizer.execute(t_pipe.graph)
    (j_op,), (t_op,) = _chosen(jg, SOLVER_NAMES), _chosen(tg, SOLVER_NAMES)
    assert type(t_op).__name__ == type(j_op).__name__ == label
    if featurized:
        assert (t_op.block_size, t_op.num_iter) == (j_op.block_size, j_op.num_iter) == (1000, 3)
    assert cost.sampling_executions() == {"node_optimization": 2, "total": 2}


def test_least_squares_in_a_graph_fits_the_chosen_solver_as_jax():
    X, Y = _ls_problem(n=256, d=24, seed=8)
    j_pipe = jcls.LeastSquaresEstimator(lam=0.5, num_machines=1).with_data(JDataset.of(X),
                                                                           JDataset.of(Y))
    t_pipe = LeastSquaresEstimator(lam=0.5, num_machines=1).with_data(_t(X), _t(Y))
    j_fitted, t_fitted = j_pipe.fit(), t_pipe.fit()
    (t_model,) = [op for op in t_fitted.graph.operators.values() if isinstance(op, LinearMapper)]
    assert t_model.feature_mean is not None  # the exact solve's centered model
    Xq = X[:16]
    np.testing.assert_allclose(t_fitted.apply(_t(Xq)).to_array().numpy(),
                               np.asarray(j_fitted.apply(jnp.asarray(Xq)).to_array()),
                               rtol=1e-4, atol=1e-4)
    direct = LeastSquaresEstimator(lam=0.5, num_machines=1).fit(Dataset.of(X), Dataset.of(Y))
    np.testing.assert_allclose(direct.W.numpy(), t_model.W.numpy(), rtol=1e-6, atol=1e-7)


def test_least_squares_shape_from_samples_uses_the_full_size():
    X, Y = _ls_problem(n=40, d=7, k=2)
    shape = LeastSquaresEstimator().shape_from_samples([Dataset.of(X), Dataset.of(Y)], 90000)
    assert shape == cost.ShapeSignature(n=90000, d=7, k=2, sparsity=1.0, machines=1)
    chosen = LeastSquaresEstimator().optimize(Dataset.of(X), Dataset.of(Y))
    assert isinstance(chosen, LinearMapEstimator)


# ---- classifiers -------------------------------------------------------------------

def _classes(n=150, d=4, k=3, seed=9, shift=2.5):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=n).astype(np.int32)
    centers = shift * rng.standard_normal((k, d))
    return (centers[y] + rng.standard_normal((n, d))).astype(np.float32), y


def test_naive_bayes_matches_jax():
    rng = np.random.default_rng(7)
    y = rng.integers(0, 3, size=120).astype(np.int32)
    rates = np.array([[6, 1, 1, 2], [1, 6, 1, 2], [1, 1, 6, 2]])
    X = rng.poisson(rates[y]).astype(np.float32)
    got = NaiveBayesEstimator(3, lam=0.5).fit(Dataset.of(X), Dataset.of(y))
    want = jcls.NaiveBayesEstimator(3, lam=0.5).fit(JDataset.of(X), JDataset.of(y))
    assert isinstance(got, NaiveBayesModel) and got.row_local
    np.testing.assert_allclose(got.pi.numpy(), np.asarray(want.pi), rtol=1e-5)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), rtol=1e-5)
    scores = got.forward(_t(X)).numpy()
    np.testing.assert_allclose(scores, np.asarray(want.trace_batch(jnp.asarray(X))), rtol=1e-5)
    assert np.mean(scores.argmax(1) == y) > 0.9


@pytest.mark.parametrize("k,reg", [(2, 0.01), (3, 0.0), (4, 0.1)])
def test_logistic_regression_matches_jax(k, reg):
    X, y = _classes(k=k, seed=k)
    kw = dict(reg_param=reg, num_iters=30)
    got = LogisticRegressionEstimator(k, **kw).fit(Dataset.of(X), Dataset.of(y))
    want = jcls.LogisticRegressionEstimator(k, **kw).fit(JDataset.of(X), JDataset.of(y))
    assert isinstance(got, LogisticRegressionModel)
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=1e-3, atol=1e-4)
    preds = got.forward(_t(X)).numpy()
    np.testing.assert_array_equal(preds, np.asarray(want.trace_batch(jnp.asarray(X))))
    np.testing.assert_allclose(got.scores(_t(X)).numpy(), np.asarray(want.scores(X)),
                               rtol=1e-3, atol=1e-3)
    assert np.mean(preds == y) > 0.8


def _sign_normalized(W):
    """Each column scaled so that its largest-magnitude entry is positive."""
    idx = np.argmax(np.abs(W), axis=0)
    return W * np.sign(W[idx, np.arange(W.shape[1])])


@pytest.mark.parametrize("dims", [1, 2])
def test_lda_matches_jax(dims):
    X, y = _classes(n=180, d=5, k=3, seed=12)
    got = LinearDiscriminantAnalysis(dims).fit(Dataset.of(X), Dataset.of(y))
    want = jcls.LinearDiscriminantAnalysis(dims).fit(JDataset.of(X), JDataset.of(y))
    assert isinstance(got, LinearMapper) and got.W.dtype == torch.float32
    assert got.W.shape == (5, dims)
    np.testing.assert_allclose(_sign_normalized(got.W.numpy()),
                               _sign_normalized(np.asarray(want.W)), atol=1e-5)
