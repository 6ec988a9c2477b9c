"""The port's kernel ridge regression family and its cost-model solver
choice against the JAX package's on the CPU:

* ``BlockKernelMatrix`` blocks (atol 1e-6) and caching, as in
  ``tests/pipelines/test_timit_cifar_extras.py``;
* ``ExactKernelRidge`` W at rtol 1e-4 / atol 1e-5 (float32 Cholesky
  solves in two LAPACK call paths, as ``test_torch_krr.py``), and Exact
  against Gauss-Seidel, as in ``tests/cost/test_chooser.py``;
* the chooser's cold label and units (rtol 1e-12: the same float64
  arithmetic) for the KRR family at n ∈ {2000, 8000, 50000};
* the plan ``NodeOptimizationRule`` makes for a pipeline holding a
  ``KernelRidgeEstimator``, the fit it leads to, and the sampled-scale
  executions it paid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keystone_tpu.cost as jcost
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes.learning.kernel import (
    BlockKernelMatrix as JBlockKernelMatrix,
    ExactKernelRidge as JExact,
    GaussianKernelGenerator as JGenerator,
    KernelRidgeEstimator as JKRREstimator,
    KernelRidgeRegression as JKRR,
)
from keystone_tpu.workflow import transformer as jtransformer
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu_torch import cost
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.kernel import (
    BlockKernelMatrix,
    ExactKernelRidge,
    GaussianKernelGenerator,
    KernelBlockLinearMapper,
    KernelRidgeEstimator,
    KernelRidgeRegression,
)
from keystone_tpu_torch.nodes.util import ClassLabelIndicators
from keystone_tpu_torch.workflow import transformer as ttransformer
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.node_optimization import (
    NodeOptimizationRule,
    _sampled_graph,
    _total_items,
)


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state and sampling counts, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    cost.reset_sampling()
    yield env
    env.reset()
    cost.reset_sampling()


def _krr_problem(n=180, d=10, k=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.integers(0, k, size=n)
    Y = ClassLabelIndicators(k).forward(torch.from_numpy(y)).numpy()
    return X, Y


def test_block_kernel_matrix_matches_jax_and_caches():
    X, _ = _krr_problem()
    idxs = np.arange(0, 48)
    got = BlockKernelMatrix(X, 0.1).block(idxs)
    want = JBlockKernelMatrix(X, 0.1).block(idxs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(BlockKernelMatrix(X, 0.1).diag_block(idxs).numpy(),
                               np.asarray(JBlockKernelMatrix(X, 0.1).diag_block(idxs)),
                               atol=1e-6)
    kernel = BlockKernelMatrix(X, 0.1, cache_blocks=False)
    kernel.block(idxs)
    assert kernel._cache == {}
    cached = BlockKernelMatrix(X, 0.1, cache_blocks=True)
    first = cached.block(idxs)
    assert len(cached._cache) == 1 and cached.block(idxs) is first
    cached.unpersist(idxs)
    assert cached._cache == {}


def test_gaussian_kernel_generator_makes_the_kernel_matrix():
    X, _ = _krr_problem(n=40)
    got = GaussianKernelGenerator(0.2).kernel_matrix(Dataset.of(X), cache=False)
    want = JGenerator(0.2).kernel_matrix(JDataset.of(X), cache=False)
    assert not got.cache_blocks and got.gamma == want.gamma
    np.testing.assert_allclose(got.block(np.arange(5, 17)).numpy(),
                               np.asarray(want.block(np.arange(5, 17))), atol=1e-6)


@pytest.mark.parametrize("block_size", [48, 180, 256])
def test_exact_krr_matches_jax(block_size):
    X, Y = _krr_problem()
    kw = dict(gamma=0.1, lam=1.0, block_size=block_size)
    got = ExactKernelRidge(**kw).fit(Dataset.of(X), Dataset.of(Y))
    want = JExact(**kw).fit(JDataset.of(X), JDataset.of(Y))
    assert isinstance(got, KernelBlockLinearMapper) and got.block_size == block_size
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=1e-4, atol=1e-5)
    # (K + λI) W = Y, the closed form
    diff = X[:, None, :] - X[None, :, :]
    K = np.exp(-0.1 * (diff ** 2).sum(-1))
    np.testing.assert_allclose(got.W.numpy(), np.linalg.solve(K + np.eye(len(X)), Y),
                               rtol=1e-3, atol=1e-4)


def test_exact_and_gauss_seidel_agree_in_one_block():
    """At n ≤ block one Gauss-Seidel step is the exact solve."""
    X, Y = _krr_problem(n=96)
    kw = dict(gamma=0.05, lam=0.5, block_size=128)
    exact = ExactKernelRidge(**kw).fit(Dataset.of(X), Dataset.of(Y))
    gs = KernelRidgeRegression(num_epochs=1, **kw).fit(Dataset.of(X), Dataset.of(Y))
    np.testing.assert_allclose(exact.W.numpy(), gs.W.numpy(), rtol=1e-5, atol=1e-6)


def test_exact_and_gauss_seidel_predict_alike():
    """As ``tests/cost/test_chooser.py``: on a small well-conditioned
    problem the two solvers' models predict alike (the iterative one to its
    convergence, atol 1e-2)."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((96, 6)).astype(np.float32)
    W = rng.standard_normal((6, 2)).astype(np.float32)
    Y = (X @ W + 0.01 * rng.standard_normal((96, 2))).astype(np.float32)
    args = dict(gamma=0.05, lam=0.5, block_size=32)
    exact = ExactKernelRidge(**args).fit(Dataset.of(X), Dataset.of(Y))
    gs = KernelRidgeRegression(num_epochs=60, **args).fit(Dataset.of(X), Dataset.of(Y))
    x = torch.from_numpy(X[:16])
    np.testing.assert_allclose(exact.apply_batch(Dataset.of(x)).to_array().numpy(),
                               gs.apply_batch(Dataset.of(x)).to_array().numpy(), atol=1e-2)


KRR_FAMILY = dict(gamma=2e-4, lam=5.0, block_size=5000, num_epochs=1, num_machines=1)


@pytest.mark.parametrize("n,label", [(2000, "ExactKernelRidge"), (8000, "ExactKernelRidge"),
                                     (50000, "KernelRidgeRegression")])
def test_cold_choice_matches_jax(n, label):
    got = KernelRidgeEstimator(**KRR_FAMILY).choose_solver(cost.ShapeSignature(n, 800, 10))
    want = JKRREstimator(**KRR_FAMILY).choose_solver(jcost.ShapeSignature(n=n, d=800, k=10))
    assert got.label == want.label == label
    assert got.source == want.source == "cold"
    assert set(got.costs) == set(want.costs)
    for name, row in got.costs.items():
        assert row["units"] == pytest.approx(want.costs[name]["units"], rel=1e-12)
        assert row["seconds"] is None and not row["learned"]
    assert isinstance(got.chosen, {"ExactKernelRidge": ExactKernelRidge,
                                   "KernelRidgeRegression": KernelRidgeRegression}[label])


def test_chunked_input_prices_out_solvers_that_cannot_stream():
    est = KernelRidgeEstimator(**KRR_FAMILY)
    choice = est.choose_solver(cost.ShapeSignature(8000, 800, 10, chunked=True))
    want = JKRREstimator(**KRR_FAMILY).choose_solver(
        jcost.ShapeSignature(n=8000, d=800, k=10, chunked=True))
    assert all(row["units"] == float("inf") for row in choice.costs.values())
    assert choice.label == want.label == "KernelRidgeRegression"  # the first option
    assert cost.op_key(est) == jcost.op_key(JKRREstimator) == "op/KernelRidgeEstimator"


class JScale(jtransformer.Transformer):
    label = "Scale"

    def trace_batch(self, X):
        return X * 0.5


class TScale(ttransformer.Transformer):
    label = "Scale"
    row_local = True

    def forward(self, X):
        return X * 0.5


def _krr_pipelines(block_size):
    """``Scale → KernelRidgeEstimator`` in both packages on one problem,
    with flops alone pricing (a memory weight this small leaves the
    operation counts to decide, so each block size below takes another
    solver)."""
    X, Y = _krr_problem(n=64, d=5)
    kw = dict(gamma=0.1, lam=1.0, block_size=block_size, num_epochs=1, num_machines=1,
              mem_weight=1e-18, network_weight=0.0)
    j_pipe = JScale().and_then(JKRREstimator(**kw), JDataset.of(X), JDataset.of(Y))
    t_pipe = TScale().and_then(KernelRidgeEstimator(**kw), torch.from_numpy(X),
                               torch.from_numpy(Y))
    return X, j_pipe, t_pipe


def _estimators(graph):
    return sorted(type(op).__name__ for op in graph.operators.values()
                  if type(op).__name__ in ("KernelRidgeRegression", "ExactKernelRidge",
                                           "KernelRidgeEstimator"))


@pytest.mark.parametrize("block_size,label", [(16, "KernelRidgeRegression"),
                                              (64, "ExactKernelRidge")])
def test_node_optimization_plan_matches_jax(block_size, label):
    X, j_pipe, t_pipe = _krr_pipelines(block_size)
    assert _estimators(t_pipe.graph) == ["KernelRidgeEstimator"]
    jg, _ = JPipelineEnv.get_or_create().optimizer.execute(j_pipe.graph)
    tg, _ = PipelineEnv.get_or_create().optimizer.execute(t_pipe.graph)
    assert _estimators(tg) == _estimators(jg) == [label]
    # one sampled pull per dependency of the estimator: data and labels
    assert cost.sampling_executions() == jcost.sampling_executions() \
        == {"node_optimization": 2, "total": 2}
    # the fit runs the chosen solver: the same model as JAX's
    j_fitted, t_fitted = j_pipe.fit(), t_pipe.fit()
    (j_model,) = [o for o in j_fitted.graph.operators.values() if hasattr(o, "W")]
    (t_model,) = [o for o in t_fitted.graph.operators.values() if hasattr(o, "W")]
    np.testing.assert_allclose(t_model.W.numpy(), np.asarray(j_model.W), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_fitted.apply(torch.from_numpy(X[:8])).to_array().numpy(),
                               np.asarray(j_fitted.apply(jnp.asarray(X[:8])).to_array()),
                               rtol=1e-4, atol=1e-5)


def test_estimator_fit_chooses_from_a_sample_as_jax():
    X, Y = _krr_problem(n=64, d=5)
    kw = dict(gamma=0.1, lam=1.0, block_size=64, num_epochs=1, num_machines=1)
    got = KernelRidgeEstimator(**kw).fit(Dataset.of(X), Dataset.of(Y))
    want = JKRREstimator(**kw).fit(JDataset.of(X), JDataset.of(Y))
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=1e-4, atol=1e-5)


def test_sampled_graph_and_total_items():
    X, _, t_pipe = _krr_pipelines(16)
    graph = t_pipe.graph
    (est,) = [n for n in graph.nodes if isinstance(graph.get_operator(n), KernelRidgeEstimator)]
    assert _total_items(graph, est) == 64
    sampled = _sampled_graph(graph, 24)
    assert _total_items(sampled, est) == 24
    # a graph with no Optimizable node is returned as it is
    plain = TScale().to_pipeline().graph
    assert NodeOptimizationRule().apply(plain, {}) == (plain, {})
    assert cost.sampling_executions() == {"total": 0}
