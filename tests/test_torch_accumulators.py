"""The port's snapshot-able accumulators (``keystone_tpu_torch/linalg/
accumulators.py``) against the JAX package's: every case of
``tests/linalg/test_accumulators.py`` run through both packages on the
same numpy chunks, at that file's tolerances, and the two packages' states
against each other (host float64 totals of float32 chunk products: 1e-5
relative to the largest entry)."""

import numpy as np
import pytest
import torch

from keystone_tpu.linalg import GramSolverState as JGram
from keystone_tpu.linalg import MomentsState as JMoments
from keystone_tpu.linalg import TsqrRState as JTsqr
from keystone_tpu_torch.linalg.accumulators import (
    GramSolverState,
    MomentsState,
    NotAbsorbable,
    TsqrRState,
)


def _data(n=200, d=16, k=3, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, d)).astype(np.float32) + 0.7
    y = rng.normal(size=(n, k)).astype(np.float32) - 1.2
    return A, y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def _states_agree(state, jstate, tol=1e-5):
    assert state.n == jstate.n and state.rows_folded == jstate.rows_folded
    for name in ("sum_x", "sum_y", "gram", "cross", "shift", "shift_y"):
        _close_rel(getattr(state, name), getattr(jstate, name), tol)


def test_gram_state_matches_dense_ridge_and_jax():
    A, y = _data()
    state, jstate = GramSolverState(), JGram()
    for i in range(0, 200, 64):  # ragged tail: 8 rows
        state.update(_t(A[i:i + 64]), _t(y[i:i + 64]))
        jstate.update(A[i:i + 64], y[i:i + 64])
    assert state.n == 200 and state.rows_folded == 200
    _states_agree(state, jstate)
    W, b, mean = state.solve(0.1)
    Ac, yc = A - A.mean(axis=0), y - y.mean(axis=0)
    G = Ac.T @ Ac + 0.1 * np.eye(16, dtype=np.float32)
    W_ref = np.linalg.solve(G.astype(np.float64), (Ac.T @ yc).astype(np.float64))
    np.testing.assert_allclose(W.numpy(), W_ref, atol=1e-3)
    np.testing.assert_allclose(mean.numpy(), A.mean(axis=0), atol=1e-5)
    np.testing.assert_allclose(b.numpy(), y.mean(axis=0), atol=1e-5)
    jW, jb, jmean = jstate.solve(0.1)
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), atol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-6)


def test_gram_state_snapshot_isolates_and_zeroes_work_counter():
    A, y = _data()
    for cls in (GramSolverState, JGram):
        state = cls().update(A[:100], y[:100])
        snap = state.snapshot()
        assert snap.n == 100 and snap.rows_folded == 0
        snap.update(A[100:], y[100:])
        assert snap.rows_folded == 100
        assert state.n == 100
        assert np.max(np.abs(state.gram - snap.gram)) > 1e-3


def test_gram_state_merge_is_the_two_chunk_fold():
    A, y = _data()
    got = {}
    for name, cls in (("port", GramSolverState), ("jax", JGram)):
        a = cls().update(A[:120], y[:120])
        b = cls().update(A[120:], y[120:])
        merged = a.merge(b)
        whole = cls().update(A[:120], y[:120]).update(A[120:], y[120:])
        np.testing.assert_allclose(merged.sum_x, whole.sum_x, atol=1e-5)
        np.testing.assert_allclose(merged.sum_y, whole.sum_y, atol=1e-5)
        assert merged.n == whole.n == 200
        Wm, bm, mm = (np.asarray(v) for v in merged.solve(0.1))
        Ww, bw, mw = (np.asarray(v) for v in whole.solve(0.1))
        np.testing.assert_allclose(Wm, Ww, atol=1e-4)
        np.testing.assert_allclose(mm, mw, atol=1e-6)
        np.testing.assert_allclose(bm, bw, atol=1e-6)
        got[name] = merged
    _states_agree(got["port"], got["jax"])


def test_gram_state_merge_into_empty_mutates_in_place():
    A, y = _data()
    totals = {}
    for name, cls in (("port", GramSolverState), ("jax", JGram)):
        p1 = cls().update(A[:120], y[:120])
        p2 = cls().update(A[120:], y[120:])
        total = cls()
        total.merge(p1)
        total.merge(p2)
        assert total.n == 200 and total.rows_folded == 200
        whole = cls().update(A[:120], y[:120]).update(A[120:], y[120:])
        Wt, _, mt = (np.asarray(v) for v in total.solve(0.1))
        Ww, _, mw = (np.asarray(v) for v in whole.solve(0.1))
        np.testing.assert_allclose(Wt, Ww, atol=1e-4)
        np.testing.assert_allclose(mt, mw, atol=1e-6)
        total.update(A[:10], y[:10])
        assert p1.n == 120
        totals[name] = total
    _states_agree(totals["port"], totals["jax"])


def test_gram_state_shape_mismatch_raises():
    A, y = _data()
    for cls in (GramSolverState, JGram):
        state = cls().update(A, y)
        with pytest.raises(ValueError, match="does not match"):
            state.update(A[:, :8], y)
        with pytest.raises(ValueError):
            cls().solve(0.1)


def test_gram_state_survives_large_offset_means():
    """mean/std = 1000 at n = 50,000: raw float32 sums lose the centered
    signal; the shifted float64 totals track the float64 solve."""
    rng = np.random.default_rng(1)
    n, d, k = 50_000, 8, 2
    A = (rng.standard_normal((n, d)) * 0.1 + 100.0).astype(np.float32)
    W0 = rng.standard_normal((d, k)).astype(np.float32)
    y = ((A - 100.0) @ W0).astype(np.float32)
    Ac = (A - A.mean(axis=0)).astype(np.float64)
    yc = (y - y.mean(axis=0)).astype(np.float64)
    W_ref = np.linalg.solve(Ac.T @ Ac + 1e-3 * np.eye(d), Ac.T @ yc)
    for cls in (GramSolverState, JGram):
        state = cls()
        for i in range(0, n, 8192):
            state.update(A[i:i + 8192], y[i:i + 8192])
        W = np.asarray(state.solve(1e-3)[0], dtype=np.float64)
        rel = np.max(np.abs(W - W_ref)) / np.max(np.abs(W_ref))
        assert rel <= 1e-3, (cls.__module__, rel)


def test_tsqr_state_resumes_the_fold():
    A, _ = _data(n=300, d=12)
    R_direct = np.linalg.qr(A, mode="r")
    R_direct *= np.sign(np.diag(R_direct))[:, None]
    finals = {}
    for name, cls in (("port", TsqrRState), ("jax", JTsqr)):
        state = cls()
        for i in range(0, 200, 64):
            state.update(A[i:min(i + 64, 200)])
        resumed = state.snapshot()
        resumed.update(A[200:])
        scratch = cls()
        for i in range(0, 300, 64):
            scratch.update(A[i:i + 64])
        np.testing.assert_allclose(np.asarray(resumed.finalize()),
                                   np.asarray(scratch.finalize()), atol=1e-4)
        np.testing.assert_allclose(np.asarray(resumed.finalize()), R_direct, atol=1e-3)
        assert resumed.n == 300 and state.n == 200
        finals[name] = np.asarray(resumed.finalize())
    np.testing.assert_allclose(finals["port"], finals["jax"], atol=1e-4)


def test_moments_state_matches_numpy_jax_and_merges():
    A, _ = _data(n=257)
    state, jstate = MomentsState(), JMoments()
    for i in range(0, 257, 50):  # ragged tail: 7 rows
        state.update(_t(A[i:i + 50]))
        jstate.update(A[i:i + 50])
    np.testing.assert_allclose(state.mean, A.mean(axis=0), atol=1e-6)
    np.testing.assert_allclose(state.std(), A.std(axis=0), atol=1e-6)
    np.testing.assert_allclose(state.mean, jstate.mean, rtol=1e-12)
    np.testing.assert_allclose(state.m2, jstate.m2, rtol=1e-12)
    left, right = MomentsState().update(A[:100]), MomentsState().update(A[100:])
    left.merge(right)
    np.testing.assert_allclose(left.mean, A.mean(axis=0), atol=1e-6)
    np.testing.assert_allclose(left.std(), A.std(axis=0), atol=1e-6)
    snap = left.snapshot()
    snap.update(A[:10])
    assert left.n == 257 and snap.n == 267


def test_a_long_chunk_folds_in_blocks_to_numpys_two_passes():
    """A chunk of many blocks, taken on several threads and merged in
    order, gives the JAX package's two float64 passes over the whole chunk
    to rounding; a chunk of one block gives its bits."""
    from keystone_tpu_torch.linalg import accumulators

    A, _ = _data(n=1000, d=7)
    state, jstate = MomentsState().update(_t(A)), JMoments()
    jstate.update(A)
    A64 = A.astype(np.float64)
    np.testing.assert_allclose(state.mean, A64.mean(axis=0), rtol=1e-12)
    np.testing.assert_allclose(state.m2, ((A64 - A64.mean(axis=0)) ** 2).sum(axis=0),
                               rtol=1e-12)
    np.testing.assert_allclose(state.m2, jstate.m2, rtol=1e-12)
    assert state.n == 1000
    block = A[:accumulators._MOMENT_ROWS]
    one, jone = MomentsState().update(block), JMoments()
    jone.update(block)
    assert np.array_equal(one.mean, jone.mean) and np.array_equal(one.m2, jone.m2)


def test_gram_state_tensor_and_host_chunks_fold_alike():
    """Chunks that are tensors (what a scan yields) fold as numpy chunks do,
    and the moments come from the raw sums."""
    A, y = _data(n=64)
    host = GramSolverState().update(A, y)
    dev = GramSolverState().update(_t(A), _t(y))
    np.testing.assert_allclose(host.gram, dev.gram, atol=1e-5)
    m = dev.moments()
    np.testing.assert_allclose(m.mean, A.mean(axis=0), atol=1e-5)
    np.testing.assert_allclose(m.std(), A.astype(np.float64).std(axis=0), rtol=1e-4)


def test_not_absorbable_is_a_value_error():
    assert issubclass(NotAbsorbable, ValueError)
