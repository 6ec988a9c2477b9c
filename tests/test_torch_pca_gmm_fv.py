"""PCA, k-means++, GMM EM and Fisher vectors against the JAX package on the
CPU.

Tolerances: PCA subspaces agree at atol 0.05 (the JAX test's
``_subspace_agrees``) and, where both packages run the same factorization,
the direction matrices agree within 1e-4 after the sign convention;
Lloyd's iterations from a copied initialisation agree within 1e-5 with
equal assignments; EM from copied parameters gives means, variances and
weights within 1e-4 relative after the same iterations; Fisher vectors
agree with ``_fisher_vector`` within 1e-4 relative. The k-means++ seeding
draws from another RNG than ``jax.random``, so the fits that seed are held
by the JAX tests' statistics instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes.images.fisher_vector import _fisher_vector
from keystone_tpu.nodes.learning import gmm as jgmm
from keystone_tpu.nodes.learning import kmeans as jkm
from keystone_tpu.nodes.learning import pca as jpca
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.images.fisher_vector import (
    FisherVector,
    GMMFisherVectorEstimator,
    fisher_vector,
)
from keystone_tpu_torch.nodes.learning import gmm as tgmm
from keystone_tpu_torch.nodes.learning import kmeans as tkm
from keystone_tpu_torch.nodes.learning import pca as tpca
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.node_optimization import NodeOptimizationRule


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _low_rank_data(rng, n=300, d=10, rank=3, noise=0.01):
    U = rng.standard_normal((n, rank))
    V = rng.standard_normal((rank, d))
    return (U @ V + noise * rng.standard_normal((n, d))).astype(np.float32)


def _subspace_agrees(P1, P2, atol=0.05):
    return np.allclose(P1 @ P1.T, P2 @ P2.T, atol=atol)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


# ---- PCA -----------------------------------------------------------------

def test_sign_convention_matches_jax():
    P = np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)
    np.testing.assert_array_equal(tpca.enforce_matlab_sign_convention(_t(P)).numpy(),
                                  np.asarray(jpca.enforce_matlab_sign_convention(jnp.asarray(P))))


@pytest.mark.parametrize("n", [60, 400], ids=["svd", "gram_eigh"])
def test_local_pca_directions_match_jax(n):
    """n < 8d takes the SVD, n ≥ 8d the Gram eigh in both packages."""
    X = _low_rank_data(np.random.default_rng(1), n=n, d=12, rank=12, noise=1.0)
    want = np.asarray(jpca.PCAEstimator(5).fit(JDataset.of(X)).pca_mat)
    got = tpca.PCAEstimator(5).fit(_t(X)).pca_mat.numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    Xc = X - X.mean(axis=0)
    assert _subspace_agrees(got, np.linalg.svd(Xc, full_matrices=False)[2][:5].T)


def test_distributed_pca_matches_jax_and_local():
    X = _low_rank_data(np.random.default_rng(2), n=512, d=10, rank=10, noise=1.0)
    want = np.asarray(jpca.DistributedPCAEstimator(3).fit(JDataset.of(X)).pca_mat)
    got = tpca.DistributedPCAEstimator(3).fit(_t(X)).pca_mat.numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    local = tpca.PCAEstimator(3).fit(_t(X)).pca_mat.numpy()
    assert _subspace_agrees(got, local)


def test_approximate_pca_agrees_with_local_and_jax():
    X = _low_rank_data(np.random.default_rng(2), n=400, d=12, rank=4)
    local = tpca.PCAEstimator(4).fit(_t(X)).pca_mat.numpy()
    approx = tpca.ApproximatePCAEstimator(4, q=5).fit(_t(X)).pca_mat.numpy()
    jax_approx = np.asarray(jpca.ApproximatePCAEstimator(4, q=5).fit(JDataset.of(X)).pca_mat)
    assert _subspace_agrees(local, approx, atol=0.1)
    assert _subspace_agrees(approx, jax_approx, atol=0.1)


def test_column_pca_estimators_match_jax():
    items = np.random.default_rng(3).standard_normal((6, 8, 50)).astype(np.float32)
    for jcls, tcls in ((jpca.LocalColumnPCAEstimator, tpca.LocalColumnPCAEstimator),
                       (jpca.DistributedColumnPCAEstimator, tpca.DistributedColumnPCAEstimator)):
        jt = jcls(4).fit(JDataset.of(items))
        tt = tcls(4).fit(_t(items))
        assert isinstance(tt, tpca.BatchPCATransformer)
        np.testing.assert_allclose(tt.pca_mat.numpy(), np.asarray(jt.pca_mat), atol=1e-4)
        out = tt.apply_batch(_t(items)).to_array().numpy()
        assert out.shape == (6, 4, 50)
        np.testing.assert_allclose(out, np.asarray(jt.apply_batch(JDataset.of(items)).to_array()),
                                   atol=1e-4)
    # an item list of ragged matrices gives the stacked columns
    ragged = [_t(items[0][:, :20]), _t(items[1])]
    rows = tpca.collect_columns(Dataset.from_items(ragged))
    assert tuple(rows.shape) == (70, 8)


@pytest.mark.parametrize("shape,total", [((24, 128, 500), 2000), ((24, 128, 20), 48),
                                         ((6, 8, 50), 6), ((24, 16, 4000), 24)])
def test_column_pca_cost_choice_matches_jax_at_one_machine(shape, total):
    sample = np.zeros(shape, np.float32)
    want = jpca.ColumnPCAEstimator(4, num_machines=1).optimize(JDataset.of(sample),
                                                               total_items=total)
    got = tpca.ColumnPCAEstimator(4, num_machines=1).optimize(_t(sample), total_items=total)
    assert type(got).__name__ == type(want).__name__
    # no num_machines: the port prices its one device
    assert type(tpca.ColumnPCAEstimator(4).optimize(_t(sample), total_items=total)) is type(got)


def test_column_pca_is_planned_by_node_optimization():
    items = np.random.default_rng(4).standard_normal((30, 8, 40)).astype(np.float32)
    est = tpca.ColumnPCAEstimator(3)
    pipe = est.with_data(_t(items))
    graph, _ = NodeOptimizationRule().apply(pipe.graph, {})
    chosen = [op for op in graph.operators.values()
              if isinstance(op, (tpca.LocalColumnPCAEstimator, tpca.DistributedColumnPCAEstimator))]
    assert chosen == [est.optimize(_t(items))]
    out = pipe(_t(items)).get().to_array()
    assert tuple(out.shape) == (30, 3, 40)


# ---- k-means -------------------------------------------------------------

def test_lloyd_from_a_copied_initialisation_matches_jax():
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.standard_normal((150, 4)) + c for c in (0.0, 3.0, -3.0)])
    X = X.astype(np.float32)
    init = np.asarray(jkm._seed_plus_plus(jnp.asarray(X), jax.random.PRNGKey(1), 6))
    for iters in (1, 2, 20):
        want = np.asarray(jkm._lloyd_loop(jnp.asarray(X), jnp.asarray(init),
                                          max_iterations=iters, stop_tolerance=1e-3))
        got = tkm.lloyd(_t(X), _t(init), iters, 1e-3).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_array_equal(
            tkm.KMeansModel(_t(got)).forward(_t(X)).numpy(),
            np.asarray(jkm.KMeansModel(want).trace_batch(jnp.asarray(X))))


def test_kmeans_recovers_separated_clusters():
    rng = np.random.default_rng(4)
    centers = np.array([[0, 0], [10, 10], [-10, 10]], dtype=np.float32)
    X = np.concatenate([c + 0.5 * rng.standard_normal((100, 2)) for c in centers]).astype(np.float32)
    model = tkm.KMeansPlusPlusEstimator(3, 20, seed=0).fit(_t(X))
    means = model.means.numpy()
    for c in centers:
        assert np.min(np.linalg.norm(means - c, axis=1)) < 1.0
    assign = model.forward(_t(X)).numpy()
    np.testing.assert_allclose(assign.sum(axis=1), 1.0)
    assert (assign[:100].argmax(axis=1) == assign[0].argmax()).all()


def test_seeding_draws_distinct_points_of_the_data():
    X = np.random.default_rng(6).standard_normal((500, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(3)
    seeds = tkm.seed_plus_plus(_t(X), 8, gen).numpy()
    rows = {tuple(r) for r in X}
    assert all(tuple(s) in rows for s in seeds) and len({tuple(s) for s in seeds}) == 8
    # every point covered: the uniform fallback still gives data points
    dup = np.repeat(X[:2], 10, axis=0)
    more = tkm.seed_plus_plus(_t(dup), 4, torch.Generator().manual_seed(0)).numpy()
    assert all(tuple(s) in {tuple(r) for r in dup} for s in more)


# ---- GMM -----------------------------------------------------------------

def _mixture(rng, n=400):
    return np.concatenate([rng.standard_normal((n, 5)) + c for c in (0.0, 4.0, -4.0)]).astype(
        np.float32)


def _jax_init(X, k, seed=0):
    """The JAX estimator's k-means++ initialisation, floored."""
    Xj = jnp.asarray(X)
    km = jkm.KMeansPlusPlusEstimator(k, 1, seed=seed).fit_matrix(X)
    assign = km.trace_batch(Xj)
    mass = assign.sum(0)
    means = (assign.T @ Xj) / mass[:, None]
    variances = (assign.T @ (Xj * Xj)) / mass[:, None] - means * means
    est = tgmm.GaussianMixtureModelEstimator(k)
    floor = est.var_floor(_t(X)).numpy()
    return (np.asarray(means), np.maximum(np.asarray(variances), floor),
            np.asarray(mass / X.shape[0]), floor)


@pytest.mark.parametrize("iters", [1, 3, 10])
def test_em_from_copied_parameters_matches_jax(iters):
    X = _mixture(np.random.default_rng(0))
    m0, v0, w0, floor = _jax_init(X, 5)
    mj, vj, wj = jgmm._em_loop(jnp.asarray(X), jnp.asarray(m0), jnp.asarray(v0), jnp.asarray(w0),
                               jnp.asarray(floor), max_iterations=iters, weight_threshold=1e-4,
                               stop_tolerance=1e-4, min_cluster_size=1)
    mt, vt, wt, ran = tgmm.em_loop(_t(X), _t(m0), _t(v0), _t(w0), _t(floor),
                                   max_iterations=iters, weight_threshold=1e-4,
                                   stop_tolerance=1e-4, min_cluster_size=1)
    assert 1 <= ran <= iters
    for got, want in ((mt, mj), (vt, vj), (wt, wj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_em_min_cluster_size_stop_keeps_the_previous_parameters():
    X = _mixture(np.random.default_rng(1), n=50)
    m0, v0, w0, floor = _jax_init(X, 4)
    mj, vj, wj = jgmm._em_loop(jnp.asarray(X), jnp.asarray(m0), jnp.asarray(v0), jnp.asarray(w0),
                               jnp.asarray(floor), max_iterations=10, weight_threshold=1e-4,
                               stop_tolerance=1e-4, min_cluster_size=60)
    mt, vt, wt, ran = tgmm.em_loop(_t(X), _t(m0), _t(v0), _t(w0), _t(floor), max_iterations=10,
                                   weight_threshold=1e-4, stop_tolerance=1e-4,
                                   min_cluster_size=60)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4, atol=1e-6)


def test_estimator_from_a_copied_initialisation_matches_jax():
    """The whole estimator (variance floor included) from the JAX
    initialisation; the port's own ``initial`` is the same computation on
    its own k-means++ draw."""
    X = _mixture(np.random.default_rng(2))
    m0, v0, w0, _ = _jax_init(X, 4, seed=3)
    est = tgmm.GaussianMixtureModelEstimator(4, max_iterations=8, min_cluster_size=1)
    model = est.fit_matrix(_t(X), init=(_t(m0), _t(v0), _t(w0)))
    jm, jv, jw = jgmm._em_loop(jnp.asarray(X), jnp.asarray(m0), jnp.asarray(v0), jnp.asarray(w0),
                               jnp.asarray(est.var_floor(_t(X)).numpy()), max_iterations=8,
                               weight_threshold=1e-4, stop_tolerance=1e-4, min_cluster_size=1)
    np.testing.assert_allclose(model.means.numpy(), np.asarray(jm).T, rtol=1e-4, atol=1e-6)
    assert set(model.fit_info) == {"seeding", "em", "iterations"}


def test_gmm_em_recovers_mixture():
    rng = np.random.default_rng(5)
    means_true = np.array([[0.0, 0.0], [6.0, 6.0]])
    X = np.concatenate([means_true[0] + rng.standard_normal((200, 2)),
                        means_true[1] + 0.5 * rng.standard_normal((200, 2))]).astype(np.float32)
    gmm = tgmm.GaussianMixtureModelEstimator(2, max_iterations=50, seed=0).fit_matrix(_t(X))
    means = gmm.means.numpy().T
    for c in means_true:
        assert np.min(np.linalg.norm(means - c, axis=1)) < 0.5
    w = gmm.weights.numpy()
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(w, [0.5, 0.5], atol=0.1)
    q = gmm.forward(_t(X)).numpy()
    np.testing.assert_allclose(q.sum(axis=1), 1.0, rtol=1e-5)
    assert (q[:200].argmax(axis=1) == q[0].argmax()).all()


def test_kmeans_initialisation_with_an_empty_cluster_stays_finite(monkeypatch):
    """When the k-means round leaves a cluster without a point (where the
    JAX package divides by zero), that cluster starts at its center with
    the variance floor and a mass of one point; the others start at their
    moments, and the fit and its posteriors are finite."""
    X = _t(_mixture(np.random.default_rng(9), n=300))
    far = X.mean(dim=0) + 1e3
    centers = torch.stack([X[:150].mean(dim=0), X[150:].mean(dim=0), far])
    monkeypatch.setattr(tkm.KMeansPlusPlusEstimator, "fit_matrix",
                        lambda self, X, init=None: tkm.KMeansModel(centers))
    est = tgmm.GaussianMixtureModelEstimator(3, max_iterations=5, min_cluster_size=1)
    means, variances, weights = est.initial(X)
    assign = tkm.KMeansModel(centers).forward(X)
    assert assign[:, 2].sum() == 0
    torch.testing.assert_close(means[2], far)
    torch.testing.assert_close(variances[2], est.var_floor(X))
    torch.testing.assert_close(weights, assign.sum(dim=0).clamp_min(1.0) / X.shape[0])
    torch.testing.assert_close(means[:2], (assign.T @ X)[:2] / assign.sum(dim=0)[:2, None])
    model = est.fit_matrix(X)
    for t in (model.means, model.variances, model.weights, model.forward(X)):
        assert bool(torch.isfinite(t).all())


def test_random_initialisation_is_the_jax_draw():
    X = _mixture(np.random.default_rng(7), n=30)
    est = tgmm.GaussianMixtureModelEstimator(3, initialization_method="random", seed=4)
    m, v, w = est.initial(_t(X))
    rng = np.random.default_rng(4)
    lo, hi = X.min(0), X.max(0)
    np.testing.assert_allclose(m.numpy(), rng.random((3, 5)).astype(np.float32) * (hi - lo) + lo,
                               rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.full(3, 1 / 3, np.float32))


def test_posteriors_match_jax():
    rng = np.random.default_rng(8)
    means, variances = rng.standard_normal((4, 3)), rng.uniform(0.5, 1.5, (4, 3))
    weights = np.array([0.5, 0.3, 0.2])
    X = rng.standard_normal((50, 4)).astype(np.float32)
    want = np.asarray(jgmm.GaussianMixtureModel(means, variances, weights).trace_batch(jnp.asarray(X)))
    got = tgmm.GaussianMixtureModel(_t(means), _t(variances), _t(weights)).forward(_t(X)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_gmm_csv_load_roundtrip(tmp_path):
    rng = np.random.default_rng(8)
    means = rng.standard_normal((4, 2))
    variances = rng.uniform(0.5, 1.5, (4, 2))
    weights = np.array([0.4, 0.6])
    for name, a in (("m", means), ("v", variances), ("w", weights)):
        np.savetxt(tmp_path / f"{name}.csv", a, delimiter=",")
    paths = [str(tmp_path / f"{x}.csv") for x in "mvw"]
    gmm = tgmm.GaussianMixtureModel.load(*paths)
    ref = jgmm.GaussianMixtureModel.load(*paths)
    np.testing.assert_allclose(gmm.means.numpy(), np.asarray(ref.means), rtol=1e-6)
    np.testing.assert_allclose(gmm.variances.numpy(), np.asarray(ref.variances), rtol=1e-6)
    np.testing.assert_allclose(gmm.weights.numpy(), np.asarray(ref.weights), rtol=1e-6)
    assert (gmm.k, gmm.dim) == (ref.k, ref.dim) == (2, 4)


# ---- Fisher vectors ---------------------------------------------------------

@pytest.mark.parametrize("d,k,m", [(4, 3, 30), (16, 8, 200), (6, 5, 1)])
def test_fisher_vector_matches_jax(d, k, m):
    rng = np.random.default_rng(d + k)
    means = rng.standard_normal((d, k)).astype(np.float32)
    variances = rng.uniform(0.5, 2.0, (d, k)).astype(np.float32)
    weights = rng.dirichlet(np.ones(k)).astype(np.float32)
    X = rng.standard_normal((3, d, m)).astype(np.float32)
    want = np.asarray(_fisher_vector(jnp.asarray(X), jnp.asarray(means), jnp.asarray(variances),
                                     jnp.asarray(weights), 1e-4))
    got = fisher_vector(_t(X), _t(means), _t(variances), _t(weights), 1e-4).numpy()
    assert got.shape == (3, d, 2 * k)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    node = FisherVector(tgmm.GaussianMixtureModel(_t(means), _t(variances), _t(weights)))
    np.testing.assert_allclose(node.apply_batch(_t(X)).to_array().numpy(), got, rtol=0, atol=0)


def test_gmm_fisher_vector_estimator_end_to_end():
    items = np.random.default_rng(7).standard_normal((4, 6, 40)).astype(np.float32)
    fv = GMMFisherVectorEstimator(2, max_iterations=5, min_cluster_size=1).fit(_t(items))
    out = fv.apply_batch(_t(items)).to_array().numpy()
    assert out.shape == (4, 6, 4) and np.isfinite(out).all()
    assert fv.gmm.fit_info["iterations"] <= 5
