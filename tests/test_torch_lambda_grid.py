"""The λ-grid hooks of the three least-squares estimators of the port
(``fit_lambda_grid`` and ``grid_family`` in
``keystone_tpu_torch/nodes/learning/linear.py``) against the JAX package's
hooks on the same problem, in memory and chunked.

Tolerances: between the packages 1e-5 relative to the largest entry (their
float32 chunk products round apart); TSQR members within 1e-5 of
independent fits, and a warm-started BCD member's objective at most 1.02 ×
a cold fit's (``tests/sweep/test_grid_sweep.py``); within the port, a grid
member equals the single fit at its λ bit for bit (one code path).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.chunked import ChunkedDataset as JChunked
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes.learning import linear as jlinear
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning import linear

LAMS = [1e-2, 1e-1, 1.0]


@pytest.fixture(autouse=True)
def one_lane(monkeypatch):
    monkeypatch.setenv("KEYSTONE_SCAN_LANES", "1")


def _problem(n=200, d=12, k=3, seed=0):
    """Features and labels whose means are far from zero."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32) + 1.5
    Y = (X @ rng.normal(size=(d, k)) + 0.1 * rng.normal(size=(n, k)) + 3.0).astype(np.float32)
    return X, Y


def _inputs(X, Y, chunked):
    """(port data, port labels, JAX data, JAX labels)."""
    if chunked:
        return (ChunkedDataset.from_array(torch.from_numpy(X), 48),
                Dataset.of(torch.from_numpy(Y)), JChunked.from_array(X, 48), JDataset.of(Y))
    return (Dataset.of(torch.from_numpy(X)), Dataset.of(torch.from_numpy(Y)), JDataset.of(X),
            JDataset.of(Y))


def _close(got: torch.Tensor, want, rel=1e-5):
    want = np.asarray(want, np.float64)
    dev = np.abs(got.detach().numpy().astype(np.float64) - want).max()
    assert dev <= rel * max(np.abs(want).max(), 1e-30), dev


@pytest.mark.parametrize("how", ["memory", "chunked", "chunked-checkpoint"])
def test_linear_map_grid_matches_jax(how, tmp_path):
    X, Y = _problem()
    data, labels, jdata, jlabels = _inputs(X, Y, how != "memory")
    ckpt = str(tmp_path / "port") if how == "chunked-checkpoint" else None
    jckpt = str(tmp_path / "jax") if ckpt else None
    models = linear.LinearMapEstimator.fit_lambda_grid(
        [linear.LinearMapEstimator(lam) for lam in LAMS], data, labels, checkpoint=ckpt)
    jmodels = jlinear.LinearMapEstimator.fit_lambda_grid(
        [jlinear.LinearMapEstimator(lam) for lam in LAMS], jdata, jlabels, checkpoint=jckpt)
    for lam, m, jm in zip(LAMS, models, jmodels):
        _close(m.W, jm.W)
        _close(m.b, jm.b)
        _close(m.feature_mean, jm.feature_mean)
        assert m.solver_state.lam == jm.solver_state.lam == lam
        assert m.solver_state.n == jm.solver_state.n == len(X)
        single = linear.LinearMapEstimator(lam, snapshot=True).fit(data, labels)
        assert torch.equal(single.W, m.W)
    # each member carries its own snapshot
    assert models[0].solver_state is not models[1].solver_state
    if ckpt:
        assert os.listdir(ckpt) == [] and os.listdir(jckpt) == []


@pytest.mark.parametrize("chunked", [False, True], ids=["memory", "chunked"])
def test_tsqr_grid_members_match_independent_fits(chunked):
    X, Y = _problem()
    data, labels, jdata, jlabels = _inputs(X, Y, chunked)
    models = linear.TSQRLeastSquaresEstimator.fit_lambda_grid(
        [linear.TSQRLeastSquaresEstimator(lam) for lam in LAMS], data, labels)
    jmodels = jlinear.TSQRLeastSquaresEstimator.fit_lambda_grid(
        [jlinear.TSQRLeastSquaresEstimator(lam) for lam in LAMS], jdata, jlabels)
    for lam, m, jm in zip(LAMS, models, jmodels):
        independent = linear.TSQRLeastSquaresEstimator(lam).fit(data, labels)
        assert float((m.W - independent.W).abs().max()) <= 1e-5, lam
        _close(m.W, jm.W)
        _close(m.feature_mean, jm.feature_mean)


def _objective(model, X, Y, lam):
    W = model._W.double()
    pred = model.forward(torch.from_numpy(X)).double()
    return float(((pred - torch.from_numpy(Y).double()) ** 2).sum() + lam * (W * W).sum())


def _jobjective(model, X, Y, lam):
    W = np.asarray(model._W, np.float64)
    pred = np.asarray(model.trace_batch(jnp.asarray(X)), np.float64)
    return float(((pred - Y) ** 2).sum() + lam * (W * W).sum())


def test_warm_started_bcd_grid_descends_as_far_as_a_cold_fit():
    X, Y = _problem(n=512, d=32)
    data, labels, jdata, jlabels = _inputs(X, Y, False)
    ests = [linear.BlockLeastSquaresEstimator(16, 2, lam=lam) for lam in LAMS]
    models = linear.BlockLeastSquaresEstimator.fit_lambda_grid(ests, data, labels)
    jmodels = jlinear.BlockLeastSquaresEstimator.fit_lambda_grid(
        [jlinear.BlockLeastSquaresEstimator(16, 2, lam=lam) for lam in LAMS], jdata, jlabels)
    for lam, est, m, jm in zip(LAMS, ests, models, jmodels):
        cold = linear.BlockLeastSquaresEstimator(16, 2, lam=lam).fit(data, labels)
        assert _objective(m, X, Y, lam) <= _objective(cold, X, Y, lam) * 1.02, lam
        assert est.warm_start_ws is None  # the grid fits copies
        jcold = jlinear.BlockLeastSquaresEstimator(16, 2, lam=lam).fit(jdata, jlabels)
        assert _jobjective(jm, X, Y, lam) <= _jobjective(jcold, X, Y, lam) * 1.02, lam
        # the two packages' warm members descend to the same objective
        assert abs(_objective(m, X, Y, lam) / _jobjective(jm, X, Y, lam) - 1) <= 1e-4, lam
    # the smallest λ starts cold: it equals the cold fit
    cold = linear.BlockLeastSquaresEstimator(16, 2, lam=LAMS[0]).fit(data, labels)
    assert torch.equal(models[0]._W, cold._W)


def test_bcd_grid_fits_a_chunked_input_cold():
    X, Y = _problem(n=192, d=32)
    data, labels, _, _ = _inputs(X, Y, True)
    models = linear.BlockLeastSquaresEstimator.fit_lambda_grid(
        [linear.BlockLeastSquaresEstimator(16, 2, lam=lam) for lam in LAMS], data, labels)
    for lam, m in zip(LAMS, models):
        cold = linear.BlockLeastSquaresEstimator(16, 2, lam=lam).fit(data, labels)
        assert torch.equal(m._W, cold._W)


@pytest.mark.parametrize("make", [
    lambda m: m.LinearMapEstimator(0.1),
    lambda m: m.LinearMapEstimator(0.1, snapshot=True, checkpoint="d"),
    lambda m: m.TSQRLeastSquaresEstimator(0.1),
    lambda m: m.TSQRLeastSquaresEstimator(0.1, checkpoint="d"),
    lambda m: m.BlockLeastSquaresEstimator(16, 2, lam=0.1, num_features=32),
], ids=["gram", "gram-checkpoint", "tsqr", "tsqr-checkpoint", "bcd"])
def test_grid_family_keys_are_the_jax_packages(make):
    assert make(linear).grid_family() == make(jlinear).grid_family()
