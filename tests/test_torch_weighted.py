"""The class-weighted least-squares family of the port against the JAX
package's on the CPU, on the same numpy-seeded problems:

* the block solver on its dense path and on its dual path at λ 0.5, 1e-4
  and 6e-5 (ImageNet's), the exact per-class solver, the reweighted BCD
  and ``solve_reweighted_l2``: predictions within 1e-4 of JAX's, relative
  to their largest magnitude (on the dual path at λ 1e-4 and 6e-5,
  held-out rows are held against the float64 solve instead: see
  ``test_block_weighted_dual_path_matches_jax``);
* the port's own agreement, at the JAX suite's tolerances
  (``tests/nodes/test_solvers.py``): block ≈ per-class ≈ reweighted at
  5e-2 and 2e-2, the dual path against the per-class solve on held-out
  rows at 2e-2 × scale, the single-block closed form at 1e-3;
* the Grams the port forms from each class's own rows against the masked
  form of the JAX package (1e-5 relative), the batched LU solve, the cost
  signature, and the front door's choice at a wide few-shot shape and a
  tall one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu import cost as jcost
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.linalg import weighted as jlw
from keystone_tpu.nodes.learning import weighted as jw
from keystone_tpu_torch import cost
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.linalg import weighted as tlw
from keystone_tpu_torch.nodes.learning import weighted as tw
from keystone_tpu_torch.workflow.env import PipelineEnv


@pytest.fixture(autouse=True)
def port_env():
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _problem(n, d, k, seed, sizes=None):
    """Labels (±1 indicators) of k classes and features that carry them."""
    rng = np.random.default_rng(seed)
    if sizes is None:
        y = rng.integers(0, k, n)
    else:
        y = np.repeat(np.arange(k), sizes)
        rng.shuffle(y)
    W = rng.standard_normal((d, k))
    X = (rng.standard_normal((n, d)) + 0.5 * W.T[y]).astype(np.float32)
    Y = -np.ones((n, k), dtype=np.float32)
    Y[np.arange(n), y] = 1.0
    return X, Y, y


def _predict_torch(model, X):
    return model.apply_batch(Dataset.of(torch.from_numpy(X))).to_array().numpy()


def _predict_jax(model, X):
    return np.asarray(model.apply_batch(JDataset.of(jnp.asarray(X))).to_array())


def _fit_both(cls, args, X, Y, **kw):
    port = getattr(tw, cls)(*args, **kw).fit(Dataset.of(torch.from_numpy(X)),
                                             Dataset.of(torch.from_numpy(Y)))
    ref = getattr(jw, cls)(*args, **kw).fit(JDataset.of(jnp.asarray(X)),
                                            JDataset.of(jnp.asarray(Y)))
    return port, ref


def _close_rel(got, want, rel):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# ---- against JAX ------------------------------------------------------------

@pytest.mark.parametrize("lam", [0.5, 1e-4, 6e-5])
def test_block_weighted_dense_path_matches_jax(lam):
    X, Y, _ = _problem(160, 12, 4, seed=7, sizes=[8, 24, 48, 80])
    port, ref = _fit_both("BlockWeightedLeastSquaresEstimator", (4, 3, lam, 0.3), X, Y,
                          class_chunk=3)
    assert port.fit_info["paths"] == ["dense"] * 3
    assert port.fit_info["class_chunks"] == 3 * 3 * 2 and port.fit_info["block_steps"] == 9
    X_test = np.random.default_rng(1).standard_normal((32, 12)).astype(np.float32)
    for batch in (X, X_test):
        _close_rel(_predict_torch(port, batch), _predict_jax(ref, batch), 1e-4)


def _exact_f64(X, Y, lam, w):
    """The per-class weighted ridge in float64 numpy: (W (d, k), b (k,))."""
    X, Y = X.astype(np.float64), Y.astype(np.float64)
    n, k = Y.shape
    y = Y.argmax(axis=1)
    counts = np.bincount(y, minlength=k)
    label_mean = 2 * w + 2 * (1 - w) * counts / n - 1
    means = w * np.stack([X[y == c].mean(axis=0) for c in range(k)]) + (1 - w) * X.mean(axis=0)
    cols = []
    for c in range(k):
        b = (1 - w) / n + np.where(y == c, w / max(counts[c], 1), 0.0)
        Xc = X - means[c]
        cols.append(np.linalg.solve(Xc.T @ (Xc * b[:, None]) + lam * np.eye(X.shape[1]),
                                    Xc.T @ ((Y[:, c] - label_mean[c]) * b)))
    W = np.stack(cols, axis=1)
    return W, label_mean - np.einsum("cd,dc->c", means, W)


@pytest.mark.parametrize("lam", [0.5, 1e-4, 6e-5])
def test_block_weighted_dual_path_matches_jax(lam):
    """On the training rows the two agree within 1e-4 at every λ. Held-out
    rows read the directions that λ alone decides: at λ 0.5 they agree
    within 1e-4 too, while at 1e-4 and 6e-5 two float32 solves differ by
    their rounding there (both packages sit 1.4e-3 to 2.8e-3 off the
    float64 solve on this problem), so the port is held to be no further
    from the float64 solve than JAX is, with a margin of 1.5 ×."""
    X, Y, _ = _problem(48, 64, 6, seed=11, sizes=[8] * 6)
    port, ref = _fit_both("BlockWeightedLeastSquaresEstimator", (64, 1, lam, 0.25), X, Y)
    assert port.fit_info == {"paths": ["dual"], "class_chunks": 1, "block_steps": 1}
    _close_rel(_predict_torch(port, X), _predict_jax(ref, X), 1e-4)
    X_test = np.random.default_rng(2).standard_normal((32, 64)).astype(np.float32)
    if lam == 0.5:
        _close_rel(_predict_torch(port, X_test), _predict_jax(ref, X_test), 1e-4)
    else:
        W, b = _exact_f64(X, Y, lam, 0.25)
        exact = X_test.astype(np.float64) @ W + b
        scale = np.abs(exact).max()
        port_err = np.abs(_predict_torch(port, X_test) - exact).max() / scale
        jax_err = np.abs(_predict_jax(ref, X_test) - exact).max() / scale
        assert port_err <= 1.5 * jax_err, (port_err, jax_err)


def test_block_weighted_dual_path_in_class_chunks_matches_jax():
    """Two feature blocks, both dual, with classes in chunks of 8 (the JAX
    formula gives min(k, 8·class_chunk, 2²⁶/(n+3)²) = 8 at class_chunk 1)."""
    X, Y, _ = _problem(20, 64, 11, seed=12)
    port, ref = _fit_both("BlockWeightedLeastSquaresEstimator", (32, 2, 1e-3, 0.25), X, Y,
                          class_chunk=1)
    assert port.fit_info["paths"] == ["dual", "dual"]
    assert port.fit_info["class_chunks"] == 2 * 2 * 2
    _close_rel(_predict_torch(port, X), _predict_jax(ref, X), 1e-4)


def test_per_class_matches_jax():
    X, Y, _ = _problem(120, 10, 3, seed=0)
    port, ref = _fit_both("PerClassWeightedLeastSquaresEstimator", (4, 1, 0.5, 0.3), X, Y)
    _close_rel(_predict_torch(port, X), _predict_jax(ref, X), 1e-4)
    assert [tuple(w.shape) for w in port.xs] == [(4, 3), (4, 3), (2, 3)]


def test_reweighted_matches_jax():
    X, Y, _ = _problem(120, 10, 3, seed=5)
    port, ref = _fit_both("ReWeightedLeastSquaresEstimator", (4, 5, 0.5, 0.3), X, Y)
    _close_rel(_predict_torch(port, X), _predict_jax(ref, X), 1e-4)


def test_solve_reweighted_l2_matches_jax():
    rng = np.random.default_rng(4)
    blocks = [rng.standard_normal((64, 3)).astype(np.float32) for _ in range(3)]
    means = [rng.standard_normal(3).astype(np.float32) * 0.1 for _ in range(3)]
    y = rng.standard_normal((64, 2)).astype(np.float32)
    b = (rng.random(64) + 0.1).astype(np.float32)
    got = tw.solve_reweighted_l2([torch.from_numpy(a) for a in blocks], torch.from_numpy(y),
                                 torch.from_numpy(b), reg=0.3, num_iter=4,
                                 means=[torch.from_numpy(m) for m in means])
    want = jw.solve_reweighted_l2(blocks, y, b, reg=0.3, num_iter=4,
                                  means=[jnp.asarray(m) for m in means])
    for g, w in zip(got, want):
        _close_rel(g.numpy(), np.asarray(w), 1e-4)


def test_batched_solve_matches_jax():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((5, 9, 9)).astype(np.float32)
    G = A @ A.transpose(0, 2, 1)
    rhs = rng.standard_normal((5, 9)).astype(np.float32)
    got = tlw._batched_solve(torch.from_numpy(G), torch.from_numpy(rhs), 0.1)
    _close_rel(got.numpy(), np.asarray(jlw._batched_solve(G, rhs, 0.1)), 1e-4)


@pytest.mark.parametrize("args", [(5000, 4096, 1000, 4096, 1), (256, 4096, 16, 4096, 1),
                                  (1000, 12000, 100, 4096, 3)])
def test_cost_signature_matches_jax(args):
    got = tlw.cost_signature(*args)
    want = jlw.cost_signature(*args)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-12)


@pytest.mark.parametrize("shape", [dict(n=1000, d=4096, k=100), dict(n=1_000_000, d=256, k=10)],
                         ids=["wide_few_shot", "tall"])
def test_front_door_choice_matches_jax(shape):
    kw = dict(shape, sparsity=1.0, machines=1)
    args = (4096, 1, 6e-5, 0.25)
    got = tw.WeightedLeastSquaresEstimator(*args, num_machines=1).choose_solver(
        cost.ShapeSignature(**kw))
    want = jw.WeightedLeastSquaresEstimator(*args, num_machines=1).choose_solver(
        jcost.ShapeSignature(**kw))
    assert got.label == want.label
    assert list(got.costs) == list(want.costs)
    for name, row in got.costs.items():
        assert row["units"] == pytest.approx(want.costs[name]["units"], rel=1e-12)


def test_front_door_fits_what_it_chooses():
    X, Y, _ = _problem(96, 10, 3, seed=9)
    door = tw.WeightedLeastSquaresEstimator(4, 1, 0.5, 0.3, num_machines=1)
    chosen = door.sample_optimize([Dataset.of(torch.from_numpy(X)),
                                   Dataset.of(torch.from_numpy(Y))], 96)
    want = jw.WeightedLeastSquaresEstimator(4, 1, 0.5, 0.3, num_machines=1).sample_optimize(
        [JDataset.of(jnp.asarray(X)), JDataset.of(jnp.asarray(Y))], 96)
    assert type(chosen).__name__ == type(want).__name__
    direct = door.fit(Dataset.of(torch.from_numpy(X)), Dataset.of(torch.from_numpy(Y)))
    own = chosen.fit(Dataset.of(torch.from_numpy(X)), Dataset.of(torch.from_numpy(Y)))
    np.testing.assert_allclose(_predict_torch(direct, X), _predict_torch(own, X), rtol=1e-6,
                               atol=1e-6)


def test_front_door_in_a_graph_is_planned_by_node_optimization():
    """In a graph the rule replaces the front door by the solver the chooser
    picks from 24 sampled rows and the full size, as JAX's rule does."""
    from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv

    X, Y, _ = _problem(96, 10, 3, seed=9)
    t_pipe = tw.WeightedLeastSquaresEstimator(4, 1, 0.5, 0.3, num_machines=1).with_data(
        torch.from_numpy(X), torch.from_numpy(Y))
    j_pipe = jw.WeightedLeastSquaresEstimator(4, 1, 0.5, 0.3, num_machines=1).with_data(
        JDataset.of(jnp.asarray(X)), JDataset.of(jnp.asarray(Y)))
    tg, _ = PipelineEnv.get_or_create().optimizer.execute(t_pipe.graph)
    jg, _ = JPipelineEnv.get_or_create().optimizer.execute(j_pipe.graph)
    solvers = ("BlockWeightedLeastSquaresEstimator", "PerClassWeightedLeastSquaresEstimator",
               "ReWeightedLeastSquaresEstimator", "WeightedLeastSquaresEstimator")
    t_ops = [type(op).__name__ for op in tg.operators.values() if type(op).__name__ in solvers]
    j_ops = [type(op).__name__ for op in jg.operators.values() if type(op).__name__ in solvers]
    assert t_ops == j_ops and len(t_ops) == 1 and t_ops[0] != "WeightedLeastSquaresEstimator"


# ---- the port's own agreement (the JAX suite's checks and tolerances) -------

def test_three_way_agreement_mixed_balance():
    X, Y, _ = _problem(160, 12, 4, seed=7, sizes=[8, 24, 48, 80])
    args = dict(lam=0.5, mixture_weight=0.3)
    fit = lambda est: est.fit(Dataset.of(torch.from_numpy(X)),  # noqa: E731
                              Dataset.of(torch.from_numpy(Y)))
    pb = _predict_torch(fit(tw.BlockWeightedLeastSquaresEstimator(4, 25, **args)), X)
    pe = _predict_torch(fit(tw.PerClassWeightedLeastSquaresEstimator(4, 1, **args)), X)
    pr = _predict_torch(fit(tw.ReWeightedLeastSquaresEstimator(4, 25, **args)), X)
    np.testing.assert_allclose(pr, pe, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(pb, pe, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(pb, pr, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("lam", [0.5, 1e-4, 6e-5])
def test_dual_path_agrees_with_per_class_on_held_out_rows(lam):
    """One block and one iteration: the block update is the exact per-class
    system, so the dual solve must match the dense per-class one, held-out
    rows included (a 1/λ-amplified ⊥ term would show there only)."""
    X, Y, _ = _problem(48, 64, 6, seed=11, sizes=[8] * 6)
    X_test = np.random.default_rng(11).standard_normal((32, 64)).astype(np.float32)
    args = dict(lam=lam, mixture_weight=0.25)
    data = (Dataset.of(torch.from_numpy(X)), Dataset.of(torch.from_numpy(Y)))
    dual = tw.BlockWeightedLeastSquaresEstimator(64, 1, **args).fit(*data)
    exact = tw.PerClassWeightedLeastSquaresEstimator(64, 1, **args).fit(*data)
    for batch in (X, X_test):
        pd_, pe = _predict_torch(dual, batch), _predict_torch(exact, batch)
        scale = np.abs(pe).max()
        np.testing.assert_allclose(pd_, pe, rtol=2e-2, atol=2e-2 * scale)


def test_single_block_reweighted_is_the_closed_form():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((64, 6)).astype(np.float32)
    y = rng.standard_normal((64, 2)).astype(np.float32)
    b = (rng.random(64) + 0.1).astype(np.float32)
    (W,) = tw.solve_reweighted_l2([torch.from_numpy(A)], torch.from_numpy(y),
                                  torch.from_numpy(b), reg=0.3, num_iter=1)
    A64, y64, b64 = A.astype(np.float64), y.astype(np.float64), b.astype(np.float64)
    want = np.linalg.solve(A64.T @ (A64 * b64[:, None]) + 0.3 * np.eye(6),
                           A64.T @ (y64 * b64[:, None]))
    np.testing.assert_allclose(W.numpy(), want, rtol=1e-3, atol=1e-3)


def test_block_weighted_learns_class_structure():
    X, Y, y = _problem(120, 10, 3, seed=1)
    model = tw.BlockWeightedLeastSquaresEstimator(10, 10, lam=0.1, mixture_weight=0.5).fit(
        Dataset.of(torch.from_numpy(X)), Dataset.of(torch.from_numpy(Y)))
    assert (_predict_torch(model, X).argmax(axis=1) == y).mean() > 0.6


# ---- pieces -------------------------------------------------------------------

def test_class_row_grams_equal_the_masked_grams():
    X, Y, y = _problem(90, 7, 9, seed=2, sizes=[0, 1, 2, 5, 9, 13, 17, 20, 23])
    A = torch.from_numpy(X)
    y_idx = torch.from_numpy(y)
    rows = tw.ClassRows(y_idx, 9)
    mask = torch.nn.functional.one_hot(y_idx, 9).float()
    for c0, c1 in ((0, 4), (4, 9), (3, 4)):
        got = rows.grams(A, c0, c1)
        want = tw._chunk_grams(A, mask[:, c0:c1])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    # the masked form is the JAX package's
    want = np.asarray(jw._chunk_grams(jnp.asarray(X), jnp.asarray(mask.numpy())))
    _close_rel(tw._chunk_grams(A, mask).numpy(), want, 1e-5)


def test_class_stats_and_sample_weights_match_jax():
    X, Y, y = _problem(40, 5, 4, seed=3)
    counts, means = tw._class_stats(torch.from_numpy(X), torch.from_numpy(y), 4)
    jcounts, jmeans = jw._class_stats(jnp.asarray(X), jnp.asarray(y), 4)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    _close_rel(means.numpy(), np.asarray(jmeans), 1e-6)
    stats = tw._joint_weighted_stats(torch.from_numpy(X), torch.from_numpy(Y), 0.3)
    jstats = jw._joint_weighted_stats(jnp.asarray(X), jnp.asarray(Y), 0.3)
    for g, w in zip(stats, jstats):
        _close_rel(g.numpy().astype(np.float64), np.asarray(w, np.float64), 1e-6)
    got = tw._class_sample_weights(stats[0], stats[1], 2, 0.3, 40)
    want = jw._class_sample_weights(jstats[0], jstats[1], 2, 0.3, 40)
    _close_rel(got.numpy(), np.asarray(want), 1e-6)


def test_what_waits_for_the_out_of_core_fit_raises():
    """The out-of-core fit is ported (``tests/test_torch_weighted_streaming.py``):
    what still raises is a snapshot of the block solver, which has no
    associative state (the typed NotAbsorbable, as in JAX)."""
    from keystone_tpu_torch.linalg.accumulators import NotAbsorbable

    assert tw.PerClassWeightedLeastSquaresEstimator(4, 1, 0.5, 0.3, snapshot=True).snapshot
    with pytest.raises(NotAbsorbable, match="snapshot"):
        tw.BlockWeightedLeastSquaresEstimator(4, 1, 0.5, 0.3, snapshot=True)
