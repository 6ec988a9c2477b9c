"""``FittedPipeline.absorb`` and ``prefix_features`` of the port
(``keystone_tpu_torch/workflow/pipeline.py``) against the JAX package's:
the cases of ``tests/workflow/test_absorb.py`` on the same pipeline and
chunks through both packages.

Tolerances: within a package, absorb against a fit from scratch on the
same chunk boundaries is held at the JAX test's 1e-6 (the same float32
chunk products folded into the same float64 totals); between the packages
1e-5 relative to the largest entry (their float32 chunk products round
apart). The checkpoint case holds a resumed absorb bit for bit, as the JAX
test does.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.chunked import ChunkedDataset as JChunked
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes.learning import LinearMapEstimator as JLinearMapEstimator
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.linalg.accumulators import GramSolverState, NotAbsorbable
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode


@pytest.fixture(autouse=True)
def envs():
    PipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    PipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _featurize():
    return FunctionNode(batch_fn=lambda X: torch.tanh(X) * 2.0, label="feat")


def _jfeaturize():
    return JFunctionNode(batch_fn=lambda X: jnp.tanh(X) * 2.0, label="feat")


def _problem(n, d=24, k=3, seed=0, offset=1.5):
    """The JAX test's problem: feature and label means far from zero."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32) + offset
    W = rng.normal(size=(d, k)).astype(np.float32)
    Y = ((np.tanh(X) * 2.0) @ W + 0.1 * rng.normal(size=(n, k)) + 3.0)
    return X, Y.astype(np.float32)


def _counting_chunked(cls, arr, chunk_rows, counter):
    n = int(arr.shape[0])

    def factory():
        for i in range(0, n, chunk_rows):
            counter[0] += 1
            yield arr[i:i + chunk_rows]

    return cls(factory, n, label=f"counting[{n}]")


def _concat_chunked(cls, a, a_rows, b, b_rows):
    """The concatenation with the chunk boundaries fit-then-absorb saw."""
    def factory():
        for i in range(0, int(a.shape[0]), a_rows):
            yield a[i:i + a_rows]
        for i in range(0, int(b.shape[0]), b_rows):
            yield b[i:i + b_rows]

    return cls(factory, int(a.shape[0]) + int(b.shape[0]), label="concat")


def _model(fitted):
    ws = [op for op in fitted.graph.operators.values() if hasattr(op, "W")]
    assert len(ws) == 1
    return ws[0]


def _close_rel(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), np.max(np.abs(got - want))


def test_absorb_matches_from_scratch_with_centering_and_ragged_chunks():
    X, Y = _problem(600)
    Xn, Yn = _problem(97, seed=1)
    prefix = _featurize().to_pipeline()
    fitted = prefix.and_then(LinearMapEstimator(lam=1e-2, snapshot=True),
                             ChunkedDataset.from_array(_t(X), 64), Dataset.of(_t(Y))).fit()
    updated = fitted.absorb(ChunkedDataset.from_array(_t(Xn), 32), Dataset.of(_t(Yn)))
    scratch = prefix.and_then(LinearMapEstimator(lam=1e-2, snapshot=True),
                              _concat_chunked(ChunkedDataset, _t(X), 64, _t(Xn), 32),
                              Dataset.of(_t(np.concatenate([Y, Yn])))).fit()
    mu, ms = _model(updated), _model(scratch)
    for name in ("W", "b", "feature_mean"):
        assert np.max(np.abs(getattr(mu, name).numpy() - getattr(ms, name).numpy())) <= 1e-6
    got = updated.apply(Dataset.of(_t(Xn[:32]))).to_array().numpy()
    want = scratch.apply(Dataset.of(_t(Xn[:32]))).to_array().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the JAX package's absorb of the same chunks
    jfitted = _jfeaturize().to_pipeline().and_then(
        JLinearMapEstimator(lam=1e-2, snapshot=True), JChunked.from_array(X, 64),
        JDataset.of(Y)).fit()
    jupdated = jfitted.absorb(JChunked.from_array(Xn, 32), JDataset.of(Yn))
    jm = _model(jupdated)
    for name in ("W", "b", "feature_mean"):
        _close_rel(getattr(mu, name).numpy(), np.asarray(getattr(jm, name)))
    _close_rel(got, np.asarray(jupdated.apply(JDataset.of(Xn[:32])).to_array()))


def test_absorb_actually_moves_the_model():
    X, Y = _problem(400)
    Xn = np.random.default_rng(7).normal(size=(200, 24)).astype(np.float32) - 2.0
    Yn = np.zeros((200, 3), np.float32)
    fitted = LinearMapEstimator(lam=1e-2, snapshot=True).with_data(
        Dataset.of(_t(X)), Dataset.of(_t(Y))).fit()
    updated = fitted.absorb(Dataset.of(_t(Xn)), Dataset.of(_t(Yn)))
    assert np.max(np.abs(_model(updated).W.numpy() - _model(fitted).W.numpy())) > 1e-3
    jfitted = JLinearMapEstimator(lam=1e-2, snapshot=True).with_data(
        JDataset.of(X), JDataset.of(Y)).fit()
    jupdated = jfitted.absorb(JDataset.of(Xn), JDataset.of(Yn))
    _close_rel(_model(updated).W.numpy(), np.asarray(_model(jupdated).W))


def test_sequential_absorbs_compose():
    X, Y = _problem(300)
    Xb, Yb = _problem(64, seed=2)
    Xc, Yc = _problem(50, seed=3)

    def est():
        return LinearMapEstimator(lam=0.1, snapshot=True)

    fitted = est().with_data(ChunkedDataset.from_array(_t(X), 100), Dataset.of(_t(Y))).fit()
    twice = fitted.absorb(ChunkedDataset.from_array(_t(Xb), 64), Dataset.of(_t(Yb))).absorb(
        ChunkedDataset.from_array(_t(Xc), 50), Dataset.of(_t(Yc)))
    parts = [_t(X[i:i + 100]) for i in range(0, 300, 100)] + [_t(Xb), _t(Xc)]
    scratch = est().with_data(ChunkedDataset(lambda: iter(parts), 414, label="abc"),
                              Dataset.of(_t(np.concatenate([Y, Yb, Yc])))).fit()
    assert np.max(np.abs(_model(twice).W.numpy() - _model(scratch).W.numpy())) <= 1e-6
    jfitted = JLinearMapEstimator(lam=0.1, snapshot=True).with_data(
        JChunked.from_array(X, 100), JDataset.of(Y)).fit()
    jtwice = jfitted.absorb(JChunked.from_array(Xb, 64), JDataset.of(Yb)).absorb(
        JChunked.from_array(Xc, 50), JDataset.of(Yc))
    _close_rel(_model(twice).W.numpy(), np.asarray(_model(jtwice).W))


def test_absorb_leaves_the_original_pipeline_untouched():
    X, Y = _problem(300)
    Xn, Yn = _problem(100, seed=4)
    fitted = LinearMapEstimator(lam=1e-2, snapshot=True).with_data(
        Dataset.of(_t(X)), Dataset.of(_t(Y))).fit()
    W_before = _model(fitted).W.numpy().copy()
    state_n = _model(fitted).solver_state.n
    fitted.absorb(Dataset.of(_t(Xn)), Dataset.of(_t(Yn)))
    np.testing.assert_array_equal(_model(fitted).W.numpy(), W_before)
    assert _model(fitted).solver_state.n == state_n == 300


def test_absorb_scans_only_the_appended_chunks():
    """O(new chunks): the original data is never produced again, and the
    new data is produced once, chunk by chunk, in both packages."""
    X, Y = _problem(600)
    Xn, Yn = _problem(97, seed=1)
    counts = {}
    for name, cls, feat, ds, est in (
            ("port", ChunkedDataset, _featurize, Dataset,
             lambda: LinearMapEstimator(lam=1e-2, snapshot=True)),
            ("jax", JChunked, _jfeaturize, JDataset,
             lambda: JLinearMapEstimator(lam=1e-2, snapshot=True))):
        old_count, new_count = [0], [0]
        wrap = _t if name == "port" else (lambda a: a)
        fitted = feat().to_pipeline().and_then(
            est(), _counting_chunked(cls, wrap(X), 64, old_count), ds.of(wrap(Y))).fit()
        scans_for_fit = old_count[0]
        assert scans_for_fit >= 10
        updated = fitted.absorb(_counting_chunked(cls, wrap(Xn), 32, new_count),
                                ds.of(wrap(Yn)))
        assert old_count[0] == scans_for_fit, "absorb scanned the original training data"
        assert new_count[0] == 4  # ceil(97 / 32): one scan of the new data
        assert _model(updated).solver_state.n == 697
        counts[name] = (scans_for_fit, new_count[0])
    assert counts["port"][1] == counts["jax"][1]


def test_absorb_without_snapshot_state_raises():
    X, Y = _problem(200)
    fitted = LinearMapEstimator(lam=1e-2).with_data(Dataset.of(_t(X)), Dataset.of(_t(Y))).fit()
    with pytest.raises(NotAbsorbable, match="snapshot-able"):
        fitted.absorb(Dataset.of(_t(X[:10])), Dataset.of(_t(Y[:10])))


def test_absorb_row_mismatch_raises():
    X, Y = _problem(200)
    fitted = LinearMapEstimator(lam=1e-2, snapshot=True).with_data(
        Dataset.of(_t(X)), Dataset.of(_t(Y))).fit()
    with pytest.raises(ValueError):
        fitted.absorb(ChunkedDataset.from_array(_t(X[:64]), 32), Dataset.of(_t(Y[:50])))


def test_absorb_checkpoints_wait_for_a_later_slice_and_on_chunk_sees_each_chunk(tmp_path):
    """The JAX case of ``tests/workflow/test_absorb.py``: a crashed absorb's
    checkpoint binds the appended data (a digest of its labels in the
    default key), so an absorb of other data of the same shape starts
    fresh, and the same data crashed and run again resumes bit for bit;
    ``on_chunk`` sees each chunk this call produces."""
    X, Y = _problem(300)
    Xa, Ya = _problem(96, seed=7)
    Xb, Yb = _problem(96, seed=8)
    fitted = _featurize().to_pipeline().and_then(
        LinearMapEstimator(lam=0.1, snapshot=True), ChunkedDataset.from_array(_t(X), 64),
        Dataset.of(_t(Y))).fit()

    class Boom(Exception):
        pass

    def killer(i, chunk):
        if i == 2:
            raise Boom()

    def absorb(Xn, Yn, **kw):
        return fitted.absorb(ChunkedDataset.from_array(_t(Xn), 32), Dataset.of(_t(Yn)), **kw)

    with pytest.raises(Boom):
        absorb(Xa, Ya, checkpoint=str(tmp_path), on_chunk=killer)
    resumed_b = _model(absorb(Xb, Yb, checkpoint=str(tmp_path))).solver_state
    clean_b = _model(absorb(Xb, Yb)).solver_state
    assert np.array_equal(resumed_b.gram, clean_b.gram)
    assert np.array_equal(resumed_b.cross, clean_b.cross)
    assert resumed_b.n == clean_b.n == 396

    with pytest.raises(Boom):
        absorb(Xa, Ya, checkpoint=str(tmp_path), on_chunk=killer)
    seen = []
    resumed_a = absorb(Xa, Ya, checkpoint=str(tmp_path),
                       on_chunk=lambda i, c: seen.append((i, tuple(c.shape))))
    assert seen == [(2, (32, 24))]  # resumed after the two saved chunks
    clean_a = absorb(Xa, Ya)
    for attr in ("gram", "cross", "sum_x", "sum_y", "shift", "shift_y"):
        assert np.array_equal(getattr(_model(resumed_a).solver_state, attr),
                              getattr(_model(clean_a).solver_state, attr)), attr
    assert torch.equal(_model(resumed_a).W, _model(clean_a).W)
    assert os.listdir(tmp_path) == []
    # a caller's key names the batch instead of the labels' digest
    with pytest.raises(Boom):
        absorb(Xa, Ya, checkpoint=str(tmp_path), checkpoint_key="batch-7", on_chunk=killer)
    assert len(os.listdir(tmp_path)) == 1
    seen = []
    updated = absorb(Xa, Ya, checkpoint=str(tmp_path), checkpoint_key="batch-7",
                     on_chunk=lambda i, c: seen.append((i, tuple(c.shape))))
    assert seen == [(2, (32, 24))]
    assert _model(updated).solver_state.n == 396
    seen = []
    absorb(Xa, Ya, on_chunk=lambda i, c: seen.append((i, tuple(c.shape))))
    assert seen == [(0, (32, 24)), (1, (32, 24)), (2, (32, 24))]


def test_prefix_features_run_the_frozen_prefix():
    X, Y = _problem(200)
    fitted = _featurize().to_pipeline().and_then(
        LinearMapEstimator(lam=0.1, snapshot=True), Dataset.of(_t(X)), Dataset.of(_t(Y))).fit()
    jfitted = _jfeaturize().to_pipeline().and_then(
        JLinearMapEstimator(lam=0.1, snapshot=True), JDataset.of(X), JDataset.of(Y)).fit()
    got = fitted.prefix_features(Dataset.of(_t(X[:16]))).to_array().numpy()
    want = np.asarray(jfitted.prefix_features(JDataset.of(X[:16])).to_array())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    chunked = fitted.prefix_features(ChunkedDataset.from_array(_t(X[:40]), 16))
    assert chunked.is_chunked
    np.testing.assert_allclose(chunked.to_array().numpy(), np.tanh(X[:40]) * 2.0, rtol=1e-6,
                               atol=1e-6)
    state = _model(fitted).solver_state
    assert isinstance(state, GramSolverState) and fitted.absorbable_nodes()
    moments = state.moments()
    np.testing.assert_allclose(moments.mean, (np.tanh(X) * 2.0).mean(0), atol=1e-5)
