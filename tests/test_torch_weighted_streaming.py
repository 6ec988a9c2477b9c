"""The port's out-of-core class-weighted solve and its snapshot-able state
(``keystone_tpu_torch/linalg/weighted.py``,
``keystone_tpu_torch/nodes/learning/weighted.py``) against the JAX
package's on the CPU, on the same numpy inputs; the JAX scans run with one
lane (``KEYSTONE_SCAN_LANES=1``).

Tolerances: predictions rtol 5e-3 / atol 5e-4, the JAX package's own
streaming-against-in-memory bound (``tests/linalg/test_streaming_solvers.py``);
the state's weights 1e-4 against the dense oracle and 1e-5 chunked against
whole, as ``tests/linalg/test_weighted_absorb.py`` holds them; class Grams
from class rows against the masked form 1e-5 relative (the same sums in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data import ChunkedDataset as JChunked
from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.linalg import weighted as jlw
from keystone_tpu.nodes.learning import weighted as jw
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.linalg import weighted as lw
from keystone_tpu_torch.linalg.accumulators import NotAbsorbable
from keystone_tpu_torch.nodes.learning import weighted as tw
from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode

PRED_TOL = dict(rtol=5e-3, atol=5e-4)


@pytest.fixture(autouse=True)
def envs(monkeypatch):
    """Both packages' fit-once state reset, the JAX scans on one lane."""
    monkeypatch.setenv("KEYSTONE_SCAN_LANES", "1")
    PipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    PipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weighted_problem(n=60, d=10, k=4, seed=3):
    """The JAX streaming test's problem."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.integers(0, k, size=n)
    Y = -np.ones((n, k), dtype=np.float32)
    Y[np.arange(n), labels] = 1.0
    return X, Y


def _pred(mapper, X):
    return mapper.forward(_t(X)).numpy()


def _jpred(mapper, X):
    return np.asarray(mapper.trace_batch(jnp.asarray(X)))


def _est(cls, num_iter, **kw):
    return cls(block_size=4, num_iter=num_iter, lam=1e-2, mixture_weight=0.25, class_chunk=2,
               **kw)


@pytest.mark.parametrize("num_iter", [1, 2])
def test_train_streaming_matches_jax_and_the_in_memory_fit(num_iter):
    X, Y = _weighted_problem()
    X_test = np.random.default_rng(9).standard_normal((7, 10)).astype(np.float32)
    est = _est(tw.BlockWeightedLeastSquaresEstimator, num_iter)
    streamed = est.train_streaming(ChunkedDataset.from_array(_t(X), 13), _t(Y))
    jstreamed = _est(jw.BlockWeightedLeastSquaresEstimator, num_iter).train_streaming(
        JChunked.from_array(X, 13), jnp.asarray(Y))
    np.testing.assert_allclose(_pred(streamed, X_test), _jpred(jstreamed, X_test), **PRED_TOL)
    for got, want in zip(streamed.xs, jstreamed.xs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRED_TOL)
    in_memory = est.train_with_l2([_t(X[:, i:i + 4]) for i in range(0, 10, 4)], _t(Y))
    np.testing.assert_allclose(_pred(streamed, X_test), _pred(in_memory, X_test), **PRED_TOL)
    # 3 blocks (4, 4, 2) a sweep, each 1 cross scan and one Gram scan: the
    # accumulator grows to all 4 classes (4·4² floats are far below 256 MB)
    assert lw.class_chunk_size(4, 4, 2) == 4
    info = streamed.fit_info
    assert info["scans"] == num_iter * 3 * 2
    assert info["block_steps"] == num_iter * 3 and info["class_chunks"] == num_iter * 3


def test_chunked_fit_routes_by_the_cache_budget(monkeypatch):
    X, Y = _weighted_problem()
    X_test = np.random.default_rng(2).standard_normal((6, 10)).astype(np.float32)
    est = _est(tw.BlockWeightedLeastSquaresEstimator, 1)
    small = est.fit(ChunkedDataset.from_array(_t(X), 13), Dataset.of(_t(Y)))
    assert "scans" not in small.fit_info  # cached, then solved in memory
    monkeypatch.setenv("KEYSTONE_CHUNK_CACHE_BUDGET", "1")
    big = est.fit(ChunkedDataset.from_array(_t(X), 13), Dataset.of(_t(Y)))
    assert big.fit_info["scans"] == 6  # streamed
    jbig = _est(jw.BlockWeightedLeastSquaresEstimator, 1).fit(
        JChunked.from_array(X, 13), JDataset.of(jnp.asarray(Y)))
    np.testing.assert_allclose(_pred(big, X_test), _pred(small, X_test), **PRED_TOL)
    np.testing.assert_allclose(_pred(big, X_test), _jpred(jbig, X_test), **PRED_TOL)


def test_train_streaming_caps_num_features():
    X, Y = _weighted_problem(d=12)
    X_test = np.random.default_rng(4).standard_normal((5, 12)).astype(np.float32)
    kw = dict(block_size=4, num_iter=1, lam=1e-2, mixture_weight=0.25, class_chunk=2,
              num_features=10)
    got = tw.BlockWeightedLeastSquaresEstimator(**kw).train_streaming(
        ChunkedDataset.from_array(_t(X), 13), _t(Y))
    want = jw.BlockWeightedLeastSquaresEstimator(**kw).train_streaming(
        JChunked.from_array(X, 13), jnp.asarray(Y))
    assert [w.shape[0] for w in got.xs] == [4, 4, 2]
    np.testing.assert_allclose(_pred(got, X_test[:, :10]), _jpred(want, X_test[:, :10]),
                               **PRED_TOL)


def test_streaming_takes_the_dense_per_class_lu_where_memory_takes_the_dual_path():
    """Pinned as the JAX package behaves: with n + 3 < d and λ > 0 the
    in-memory fit solves in sample space, the streaming one still solves
    the d × d per-class systems. Both optimize one objective, so at a λ
    well above the float32 noise they predict alike."""
    X, Y = _weighted_problem(n=20, d=32, k=3, seed=5)
    X_test = np.random.default_rng(6).standard_normal((5, 32)).astype(np.float32)
    kw = dict(block_size=32, num_iter=1, lam=0.5, mixture_weight=0.25, class_chunk=2)
    est = tw.BlockWeightedLeastSquaresEstimator(**kw)
    memory = est.train_with_l2([_t(X)], _t(Y))
    streamed = est.train_streaming(ChunkedDataset.from_array(_t(X), 7), _t(Y))
    jstreamed = jw.BlockWeightedLeastSquaresEstimator(**kw).train_streaming(
        JChunked.from_array(X, 7), jnp.asarray(Y))
    assert memory.fit_info["paths"] == ["dual"]
    assert streamed.fit_info["paths"] == ["dense"]
    np.testing.assert_allclose(_pred(streamed, X_test), _jpred(jstreamed, X_test), **PRED_TOL)
    np.testing.assert_allclose(_pred(streamed, X_test), _pred(memory, X_test), **PRED_TOL)


def test_class_row_grams_equal_the_masked_scan_to_1e5():
    """The Gram scan forms each class's Gram from its own rows; the JAX
    package's scan body forms it as a masked product over every row of the
    chunk. The same sums in another order: 1e-5 relative."""
    rng = np.random.default_rng(8)
    n, d, k, C = 50, 6, 7, 3
    A = rng.standard_normal((n, d)).astype(np.float32)
    y_idx = rng.integers(0, k, size=n)
    for c0 in (0, 3, 6):
        Ccur = min(C, k - c0)
        want = jnp.zeros((Ccur, d, d), jnp.float32)
        got = torch.zeros((Ccur, d, d))
        for row0 in range(0, n, 13):  # ragged chunks
            rows = min(13, n - row0)
            want = jlw._wls_stream_scan2_impl(jnp.asarray(A[row0:row0 + rows]),
                                              jnp.asarray(y_idx), want, row0, 0, c0,
                                              bs=d, C=Ccur)
            lw.ClassRows(_t(y_idx[row0:row0 + rows]), k).grams(
                _t(A[row0:row0 + rows]), c0, c0 + Ccur, out=got)
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))


def test_the_row_count_and_chunk_boundaries_are_checked():
    X, Y = _weighted_problem()
    kw = dict(block_size=4, num_iter=1, lam=1e-2, mixture_weight=0.25, class_chunk=2)
    short = lambda: iter([_t(X[:50])])  # noqa: E731
    with pytest.raises(ValueError, match="50 rows"):
        lw.solve_weighted_streaming(short, _t(Y), **kw)
    scans = [0]

    def shifting():
        scans[0] += 1
        cut = 20 if scans[0] < 3 else 30  # the boundaries move after two scans
        return iter([_t(X[:cut]), _t(X[cut:])])

    with pytest.raises(ValueError, match="changed boundaries"):
        lw.solve_weighted_streaming(shifting, _t(Y), **kw)
    with pytest.raises(ValueError, match="rows"):
        tw.BlockWeightedLeastSquaresEstimator(4, 1, 1e-2, 0.25).train_streaming(
            ChunkedDataset.from_array(_t(X[:50]), 13), _t(Y))


# ---- WeightedSolverState and the per-class snapshot fit -------------------------

D, K = 12, 4
LAM, MIX = 1e-2, 0.4


def _problem(n, seed=0, offset=1.5):
    """The JAX absorb test's problem."""
    r = np.random.RandomState(seed)
    X = (r.randn(n, D) + offset).astype(np.float32)
    yi = r.randint(0, K, n)
    Y = -np.ones((n, K), np.float32)
    Y[np.arange(n), yi] = 1.0
    return X, Y


def _per_class(snapshot=False, jax=False):
    cls = (jw if jax else tw).PerClassWeightedLeastSquaresEstimator
    return cls(5, 1, LAM, MIX, snapshot=snapshot)


def _W(mapper):
    return np.asarray(mapper._W)


def test_state_update_solve_snapshot_and_moments_match_jax():
    X, Y = _problem(256)
    st = lw.WeightedSolverState(lam=LAM, mixture_weight=MIX, block_size=5)
    jst = jlw.WeightedSolverState(lam=LAM, mixture_weight=MIX, block_size=5)
    for i in range(0, 256, 64):
        st.update(_t(X[i:i + 64]), _t(Y[i:i + 64]))
        jst.update(X[i:i + 64], Y[i:i + 64])
    for name in ("counts", "shift", "sum_dx", "class_sum_dx", "sum_y", "class_sum_y",
                 "gram_s", "class_gram_s", "cross_s", "class_cross_s"):
        got, want = getattr(st, name), getattr(jst, name)
        assert np.max(np.abs(got - want)) <= 1e-5 * max(np.max(np.abs(want)), 1.0), name
    W, b = st.solve()
    jW, jb = jst.solve()
    assert np.max(np.abs(W.numpy() - np.asarray(jW))) <= 1e-5
    assert np.max(np.abs(b.numpy() - np.asarray(jb))) <= 1e-5
    m, jm = st.moments(), jst.moments()
    np.testing.assert_allclose(m.mean, X.mean(0), atol=1e-4)
    np.testing.assert_allclose(m.std(), X.astype(np.float64).std(0), rtol=1e-3)
    np.testing.assert_allclose(m.m2, jm.m2, rtol=1e-6)
    assert st.counts.sum() == 256
    snap = st.snapshot()
    assert snap.rows_folded == 0 and st.rows_folded == 256
    snap.update(X[:8], Y[:8])
    assert st.n == 256 and snap.n == 264
    with pytest.raises(ValueError, match="does not match"):
        st.update(np.zeros((8, D + 1), np.float32), Y[:8])


def test_state_solve_matches_dense_oracle():
    X, Y = _problem(240)
    plain = _per_class().fit(Dataset.of(_t(X)), Dataset.of(_t(Y)))
    snap = _per_class(snapshot=True).fit(Dataset.of(_t(X)), Dataset.of(_t(Y)))
    jsnap = _per_class(snapshot=True, jax=True).fit(JDataset.of(X), JDataset.of(Y))
    assert np.max(np.abs(_W(plain) - _W(snap))) <= 1e-4
    assert np.max(np.abs(plain.b.numpy() - snap.b.numpy())) <= 1e-4
    assert np.max(np.abs(_W(snap) - _W(jsnap))) <= 1e-5
    st = snap.solver_state
    assert isinstance(st, lw.WeightedSolverState)
    assert st.n == 240 and st.rows_folded == 0


def test_chunked_snapshot_fit_matches_in_memory():
    X, Y = _problem(300)
    whole = _per_class(snapshot=True).fit(Dataset.of(_t(X)), Dataset.of(_t(Y)))
    chunked = _per_class(snapshot=True).fit(ChunkedDataset.from_array(_t(X), 64),
                                            Dataset.of(_t(Y)))
    assert np.max(np.abs(_W(whole) - _W(chunked))) <= 1e-5


def _mapper_of(fitted):
    return [op for op in fitted.graph.operators.values() if hasattr(op, "_W")][0]


def test_weighted_absorb_matches_from_scratch_and_jax():
    X, Y = _problem(300)
    Xn, Yn = _problem(96, seed=1, offset=1.0)
    prefix = FunctionNode(batch_fn=torch.tanh, label="feat").to_pipeline()
    fitted = prefix.and_then(_per_class(snapshot=True), ChunkedDataset.from_array(_t(X), 64),
                             Dataset.of(_t(Y))).fit()
    updated = fitted.absorb(ChunkedDataset.from_array(_t(Xn), 32), Dataset.of(_t(Yn)))
    scratch = prefix.and_then(_per_class(snapshot=True),
                              ChunkedDataset.from_array(_t(np.concatenate([X, Xn])), 64),
                              Dataset.of(_t(np.concatenate([Y, Yn])))).fit()
    mu, ms = _mapper_of(updated), _mapper_of(scratch)
    assert np.max(np.abs(_W(mu) - _W(ms))) <= 1e-5
    assert np.max(np.abs(mu.b.numpy() - ms.b.numpy())) <= 1e-5
    assert mu.solver_state.n == 396
    got = updated.apply(Dataset.of(_t(Xn[:16]))).to_array().numpy()
    want = scratch.apply(Dataset.of(_t(Xn[:16]))).to_array().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert _mapper_of(fitted).solver_state.n == 300
    # the JAX package's absorb of the same data
    jprefix = JFunctionNode(batch_fn=lambda A: jnp.tanh(A), label="feat").to_pipeline()
    jfitted = jprefix.and_then(_per_class(snapshot=True, jax=True),
                               JChunked.from_array(X, 64), JDataset.of(Y)).fit()
    jupdated = jfitted.absorb(JChunked.from_array(Xn, 32), JDataset.of(Yn))
    assert np.max(np.abs(_W(mu) - _W(_mapper_of(jupdated)))) <= 1e-5


def test_sequential_weighted_absorbs_compose():
    X, Y = _problem(200)
    Xb, Yb = _problem(64, seed=2)
    Xc, Yc = _problem(48, seed=3)
    fitted = _per_class(snapshot=True).with_data(Dataset.of(_t(X)), Dataset.of(_t(Y))).fit()
    twice = fitted.absorb(Dataset.of(_t(Xb)), Dataset.of(_t(Yb))).absorb(
        Dataset.of(_t(Xc)), Dataset.of(_t(Yc)))
    scratch = _per_class(snapshot=True).with_data(
        Dataset.of(_t(np.concatenate([X, Xb, Xc]))),
        Dataset.of(_t(np.concatenate([Y, Yb, Yc])))).fit()
    assert np.max(np.abs(_W(_mapper_of(twice)) - _W(_mapper_of(scratch)))) <= 1e-5


def test_the_iterated_families_refuse_a_snapshot_typed():
    for make in (lambda: tw.BlockWeightedLeastSquaresEstimator(5, 1, LAM, MIX, snapshot=True),
                 lambda: BlockLeastSquaresEstimator(5, 1, snapshot=True),
                 lambda: jw.BlockWeightedLeastSquaresEstimator(5, 1, LAM, MIX, snapshot=True)):
        with pytest.raises(ValueError, match="visitation order") as err:
            make()
        assert type(err.value).__name__ == "NotAbsorbable"


def test_absorb_without_state_is_typed_not_absorbable():
    X, Y = _problem(128)
    fitted = BlockLeastSquaresEstimator(5, 1, lam=LAM).with_data(
        Dataset.of(_t(X)), Dataset.of(_t(Y))).fit()
    with pytest.raises(NotAbsorbable, match="snapshot-able"):
        fitted.absorb(Dataset.of(_t(X[:16])), Dataset.of(_t(Y[:16])))


def test_the_front_door_plans_a_chunked_input_among_the_streaming_solvers(monkeypatch):
    """As the JAX package's front door: a chunked input is planned from 24
    sampled rows with ``chunked`` set, so only the block solver, which
    streams, is priced finite; over the budget it streams."""
    monkeypatch.setenv("KEYSTONE_CHUNK_CACHE_BUDGET", "1")
    X, Y = _weighted_problem()
    X_test = np.random.default_rng(2).standard_normal((6, 10)).astype(np.float32)
    kw = dict(block_size=4, num_iter=1, lam=1e-2, mixture_weight=0.25, num_machines=1)
    got = tw.WeightedLeastSquaresEstimator(**kw).fit(ChunkedDataset.from_array(_t(X), 13),
                                                     Dataset.of(_t(Y)))
    want = jw.WeightedLeastSquaresEstimator(**kw).fit(JChunked.from_array(X, 13),
                                                      JDataset.of(jnp.asarray(Y)))
    assert got.fit_info["scans"] > 0
    np.testing.assert_allclose(_pred(got, X_test), _jpred(want, X_test), **PRED_TOL)
