"""The port's GridSweep (``keystone_tpu_torch/sweep/grid.py``): every case
of the JAX package's ``tests/sweep/test_grid_sweep.py`` on the port (the
shared prefix featurized once at full size, the λ families from one
accumulation, each member within 1e-6 of its independent fit, the JAX
test's bound), and each member's W against the JAX package's GridSweep
member at the tolerance of ``tests/test_torch_lambda_grid.py`` (1e-5
relative to the largest entry: the two packages' float32 products round
apart), with equal ``stats``. BCD is held at both ``warm_start`` values.
"""

import numpy as np
import pytest
import torch

import keystone_tpu_torch.cost as cost
from keystone_tpu.data.chunked import ChunkedDataset as JChunked
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes.learning import linear as jlinear
from keystone_tpu.sweep import GridSweep as JGridSweep
from keystone_tpu.workflow.transformer import Transformer as JTransformer
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.linear import (
    BlockLeastSquaresEstimator,
    LinearMapEstimator,
    TSQRLeastSquaresEstimator,
)
from keystone_tpu_torch.nodes.util import MaxClassifier
from keystone_tpu_torch.sweep import GridSweep, SweepResult
from keystone_tpu_torch.sweep.grid import expand_grid
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.optimizers import AutoCachingOptimizer, clear_memo
from keystone_tpu_torch.workflow.transformer import Transformer

LAMS = [1e-3, 1e-2, 1e-1, 1.0]


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.setenv("KEYSTONE_SCAN_LANES", "1")
    for reset in (cost.reset, clear_memo, PipelineEnv.get_or_create().reset):
        reset()
    yield
    for reset in (cost.reset, clear_memo, PipelineEnv.get_or_create().reset):
        reset()


class CountingFeaturize(Transformer):
    """A featurize stage that counts its full-size executions (the
    optimizer's 24-row samples do not count)."""

    def __init__(self, full_rows: int):
        self.full_rows = full_rows
        self.full_calls = 0

    def forward(self, X):
        if int(X.shape[0]) == self.full_rows:
            self.full_calls += 1
        return torch.tanh(X) * 2.0


class JCountingFeaturize(JTransformer):
    def __init__(self, full_rows: int):
        self.full_rows = full_rows
        self.full_calls = 0

    def trace_batch(self, X):
        import jax.numpy as jnp

        if int(X.shape[0]) == self.full_rows:
            self.full_calls += 1
        return jnp.tanh(X) * 2.0


def _problem(n=600, d=32, k=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32) + 0.5
    W = rng.normal(size=(d, k)).astype(np.float32)
    Y = (np.tanh(X) * 2.0) @ W + 0.05 * rng.normal(size=(n, k)) + 1.0
    return X, Y.astype(np.float32)


def _ds(a):
    return Dataset.of(torch.from_numpy(a))


def _model_W(fitted):
    ws = [torch.cat(list(op.xs), dim=0) if hasattr(op, "xs") else op.W
          for op in fitted.graph.operators.values() if hasattr(op, "W") or hasattr(op, "xs")]
    assert len(ws) == 1
    return ws[0].detach().numpy()


def _jmodel_W(fitted):
    ws = [np.concatenate([np.asarray(w) for w in op.xs], axis=0) if hasattr(op, "xs")
          else np.asarray(op.W)
          for op in fitted.graph.operators.values() if hasattr(op, "W") or hasattr(op, "xs")]
    assert len(ws) == 1
    return ws[0]


def _close_to_jax(W, jW, rel=1e-5):
    dev = np.abs(W.astype(np.float64) - jW.astype(np.float64)).max()
    assert dev <= rel * np.abs(jW).max(), dev


def test_expand_grid_cartesian_deterministic():
    pts = expand_grid({"lam": [1, 2], "dim": ["a", "b", "c"]})
    assert len(pts) == 6
    assert pts[0] == {"lam": 1, "dim": "a"}
    assert pts[-1] == {"lam": 2, "dim": "c"}
    assert pts == expand_grid({"lam": [1, 2], "dim": ["a", "b", "c"]})
    from keystone_tpu.sweep.grid import expand_grid as jexpand

    assert pts == jexpand({"lam": [1, 2], "dim": ["a", "b", "c"]})


def test_expand_grid_rejects_empty():
    with pytest.raises(ValueError):
        expand_grid({})
    with pytest.raises(ValueError):
        expand_grid({"lam": []})


def test_lambda_sweep_prefix_executes_once_and_members_match():
    X, Y = _problem()
    feat = CountingFeaturize(len(X))
    prefix = feat.to_pipeline()
    res = GridSweep(prefix, lambda lam: LinearMapEstimator(lam=lam), {"lam": LAMS},
                    _ds(X), _ds(Y)).fit()
    assert isinstance(res, SweepResult) and len(res) == len(LAMS)
    assert feat.full_calls == 1
    assert res.stats["groups"] == 1
    assert res.stats["gram_reuse_solves"] == len(LAMS)
    for member in res:
        independent = prefix.and_then(LinearMapEstimator(lam=member.params["lam"], snapshot=True),
                                      _ds(X), _ds(Y)).fit()
        dW = np.max(np.abs(_model_W(member.fitted) - _model_W(independent)))
        assert dW <= 1e-6, (member.params, dW)
    assert np.max(np.abs(_model_W(res.members[0].fitted)
                         - _model_W(res.members[-1].fitted))) > 1e-3


def test_sweep_members_serve_independently():
    X, Y = _problem()
    prefix = CountingFeaturize(len(X)).to_pipeline()
    res = GridSweep(prefix, lambda lam: LinearMapEstimator(lam=lam), {"lam": [1e-2, 1e-1]},
                    _ds(X), _ds(Y)).fit()
    m = res.fitted_for(lam=1e-1)
    independent = prefix.and_then(LinearMapEstimator(lam=1e-1, snapshot=True),
                                  _ds(X), _ds(Y)).fit()
    got = m.apply(_ds(X[:48])).payload
    want = independent.apply(_ds(X[:48])).payload
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert m.datum_shape == (32,) and m.datum_dtype == "float32"
    with pytest.raises(KeyError):
        res.fitted_for(lam=123.0)


def test_multi_axis_grid_forms_separate_families():
    X, Y = _problem()
    res = GridSweep(CountingFeaturize(len(X)).to_pipeline(),
                    lambda lam, snapshot: LinearMapEstimator(lam=lam, snapshot=snapshot),
                    {"lam": [1e-2, 1.0], "snapshot": [False, True]}, _ds(X), _ds(Y)).fit()
    assert len(res) == 4
    assert res.stats["groups"] == 2
    assert res.stats["gram_reuse_solves"] == 4
    ref = {}
    for member in res:
        W = _model_W(member.fitted)
        lam = member.params["lam"]
        if lam in ref:
            np.testing.assert_allclose(W, ref[lam], atol=1e-6)
        ref[lam] = W


def test_tsqr_family_grid_matches_independent_fits():
    X, Y = _problem()
    prefix = CountingFeaturize(len(X)).to_pipeline()
    res = GridSweep(prefix, lambda lam: TSQRLeastSquaresEstimator(lam=lam), {"lam": LAMS},
                    _ds(X), _ds(Y)).fit()
    assert res.stats["grouped_solves"].get("tsqr") == len(LAMS)
    for member in res:
        independent = prefix.and_then(TSQRLeastSquaresEstimator(lam=member.params["lam"]),
                                      _ds(X), _ds(Y)).fit()
        dW = np.max(np.abs(_model_W(member.fitted) - _model_W(independent)))
        assert dW <= 1e-5, (member.params, dW)


def test_ungrouped_members_still_share_the_prefix():
    """Cold BCD (its grid hook groups only under warm_start) fits each
    member apart, and the prefix still runs once; members equal their
    independent fits."""
    X, Y = _problem(n=512, d=32)
    feat = CountingFeaturize(len(X))
    prefix = feat.to_pipeline()
    res = GridSweep(prefix, lambda lam: BlockLeastSquaresEstimator(16, num_iter=2, lam=lam),
                    {"lam": [1e-2, 1e-1, 1.0]}, _ds(X), _ds(Y)).fit()
    assert feat.full_calls == 1
    assert res.stats["groups"] == 0
    for member in res:
        independent = prefix.and_then(
            BlockLeastSquaresEstimator(16, num_iter=2, lam=member.params["lam"]),
            _ds(X), _ds(Y)).fit()
        got = member.fitted.apply(_ds(X[:32])).payload
        want = independent.apply(_ds(X[:32])).payload
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_warm_started_bcd_grid():
    X, Y = _problem(n=512, d=32)
    prefix = CountingFeaturize(len(X)).to_pipeline()
    res = GridSweep(prefix, lambda lam: BlockLeastSquaresEstimator(16, num_iter=2, lam=lam),
                    {"lam": [1e-2, 1e-1, 1.0]}, _ds(X), _ds(Y), warm_start=True).fit()
    assert res.stats["groups"] == 1
    assert res.stats["warm_starts"] == 2
    for member in res:
        lam = member.params["lam"]
        cold = prefix.and_then(BlockLeastSquaresEstimator(16, num_iter=2, lam=lam),
                               _ds(X), _ds(Y)).fit()

        def objective(fitted):
            pred = fitted.apply(_ds(X)).payload.double().numpy()
            W = _model_W(fitted).astype(np.float64)
            return float(np.sum((pred - Y) ** 2)) + lam * float(np.sum(W * W))

        assert objective(member.fitted) <= objective(cold) * 1.02, lam


@pytest.mark.parametrize("warm_start", [False, True])
def test_bcd_sweep_members_match_jax_at_both_warm_start_values(warm_start):
    """The repaired ``warm_start`` of ``BlockLeastSquaresEstimator
    .fit_lambda_grid``: a cold sweep leaves the BCD members ungrouped and
    each equals its independent cold fit, as in the JAX package; a warm
    one groups them and warm-starts two. Each member's W against the JAX
    sweep's at 1e-5 relative, and the stats equal."""
    X, Y = _problem(n=512, d=32)
    lams = [1e-2, 1e-1, 1.0]
    res = GridSweep(CountingFeaturize(len(X)).to_pipeline(),
                    lambda lam: BlockLeastSquaresEstimator(16, num_iter=2, lam=lam),
                    {"lam": lams}, _ds(X), _ds(Y), warm_start=warm_start).fit()
    jres = JGridSweep(JCountingFeaturize(len(X)).to_pipeline(),
                      lambda lam: jlinear.BlockLeastSquaresEstimator(16, num_iter=2, lam=lam),
                      {"lam": lams}, JDataset.of(X), JDataset.of(Y),
                      warm_start=warm_start).fit()
    for key in ("members", "groups", "grouped_solves", "gram_reuse_solves", "warm_starts"):
        assert res.stats[key] == jres.stats[key], key
    assert res.stats["warm_starts"] == (2 if warm_start else 0)
    for m, jm in zip(res, jres):
        assert m.params == jm.params
        _close_to_jax(_model_W(m.fitted), _jmodel_W(jm.fitted))


def test_the_hook_fits_cold_without_warm_start():
    """``fit_lambda_grid(..., warm_start=False)`` is each member's own fit,
    bit for bit; with True (the default) the later members start warm."""
    X, Y = _problem(n=256, d=32)
    F = _ds(np.tanh(X) * 2.0)
    ests = [BlockLeastSquaresEstimator(16, num_iter=2, lam=lam) for lam in (1e-2, 1.0)]
    cold = BlockLeastSquaresEstimator.fit_lambda_grid(ests, F, _ds(Y), warm_start=False)
    for est, model in zip(ests, cold):
        single = BlockLeastSquaresEstimator(16, num_iter=2, lam=est.lam).fit(F, _ds(Y))
        torch.testing.assert_close(torch.cat(list(model.xs)), torch.cat(list(single.xs)),
                                   rtol=0, atol=0)
    warm = BlockLeastSquaresEstimator.fit_lambda_grid(ests, F, _ds(Y))
    assert not torch.equal(torch.cat(list(warm[1].xs)), torch.cat(list(cold[1].xs)))


@pytest.mark.parametrize("family", ["gram", "tsqr"])
def test_lambda_family_members_match_jax(family):
    X, Y = _problem()
    est, jest = ((LinearMapEstimator, jlinear.LinearMapEstimator) if family == "gram"
                 else (TSQRLeastSquaresEstimator, jlinear.TSQRLeastSquaresEstimator))
    res = GridSweep(CountingFeaturize(len(X)).to_pipeline(), lambda lam: est(lam=lam),
                    {"lam": LAMS}, _ds(X), _ds(Y)).fit()
    jres = JGridSweep(JCountingFeaturize(len(X)).to_pipeline(), lambda lam: jest(lam=lam),
                      {"lam": LAMS}, JDataset.of(X), JDataset.of(Y)).fit()
    for key in ("members", "groups", "grouped_solves", "gram_reuse_solves", "warm_starts"):
        assert res.stats[key] == jres.stats[key], key
    for m, jm in zip(res, jres):
        _close_to_jax(_model_W(m.fitted), _jmodel_W(jm.fitted))


def test_chunked_data_sweep_streams_once():
    X, Y = _problem(n=500)
    res = GridSweep(None, lambda lam: LinearMapEstimator(lam=lam), {"lam": [1e-2, 1.0]},
                    ChunkedDataset.from_array(torch.from_numpy(X), 128), _ds(Y)).fit()
    assert res.stats["gram_reuse_solves"] == 2
    jres = JGridSweep(None, lambda lam: jlinear.LinearMapEstimator(lam=lam),
                      {"lam": [1e-2, 1.0]}, JChunked.from_array(X, 128), JDataset.of(Y)).fit()
    for member, jm in zip(res, jres):
        independent = LinearMapEstimator(lam=member.params["lam"], snapshot=True).with_data(
            ChunkedDataset.from_array(torch.from_numpy(X), 128), _ds(Y)).fit()
        dW = np.max(np.abs(_model_W(member.fitted) - _model_W(independent)))
        assert dW <= 1e-6, (member.params, dW)
        _close_to_jax(_model_W(member.fitted), _jmodel_W(jm.fitted))


def test_final_stage_is_appended_to_every_member():
    X, Y = _problem()
    res = GridSweep(CountingFeaturize(len(X)).to_pipeline(),
                    lambda lam: LinearMapEstimator(lam=lam), {"lam": [1e-2]}, _ds(X), _ds(Y),
                    final=MaxClassifier()).fit()
    out = res.members[0].fitted.apply(_ds(X[:16])).payload
    assert tuple(out.shape) == (16,)
    assert not out.is_floating_point()


def test_sweep_under_autocaching_optimizer_keeps_prefix_once():
    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    X, Y = _problem()
    feat = CountingFeaturize(len(X))
    res = GridSweep(feat.to_pipeline(), lambda lam: LinearMapEstimator(lam=lam),
                    {"lam": LAMS}, _ds(X), _ds(Y)).fit()
    assert len(res) == len(LAMS)
    assert feat.full_calls == 1
    assert res.stats["gram_reuse_solves"] == len(LAMS)


def test_cold_bcd_sweep_under_autocaching_keeps_prefix_once():
    """Ungrouped members under budgeted retention: the shared prefix is
    pinned behind a Cacher, so it still runs once for all three fits."""
    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    X, Y = _problem(n=512, d=32)
    feat = CountingFeaturize(len(X))
    res = GridSweep(feat.to_pipeline(),
                    lambda lam: BlockLeastSquaresEstimator(16, num_iter=2, lam=lam),
                    {"lam": [1e-2, 1e-1, 1.0]}, _ds(X), _ds(Y)).fit()
    assert len(res) == 3 and res.stats["groups"] == 0
    assert feat.full_calls == 1


def test_second_sweep_plans_with_zero_sampling(tmp_path):
    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    cost.configure(str(tmp_path), device="cpu")
    X, Y = _problem()

    def run():
        cost.reset_sampling()
        res = GridSweep(CountingFeaturize(len(X)).to_pipeline(),
                        lambda lam: LinearMapEstimator(lam=lam), {"lam": LAMS},
                        _ds(X), _ds(Y)).fit()
        return res, cost.sampling_executions()["total"]

    res1, sampled1 = run()
    res2, sampled2 = run()
    assert sampled1 > 0
    assert sampled2 == 0, f"second sweep sampled {sampled2} executions"
    for m1, m2 in zip(res1, res2):
        np.testing.assert_allclose(_model_W(m1.fitted), _model_W(m2.fitted), atol=1e-6)
    assert any(k.startswith("plan/") for k in cost.get_store().keys())


def test_make_estimator_must_return_an_estimator():
    X, Y = _problem(n=64)
    sweep = GridSweep(None, lambda lam: MaxClassifier(), {"lam": [0.1]}, _ds(X), _ds(Y))
    with pytest.raises(TypeError, match="make_estimator"):
        sweep.fit()


def test_sweep_members_carry_absorbable_state():
    X, Y = _problem()
    res = GridSweep(None, lambda lam: LinearMapEstimator(lam=lam), {"lam": [1e-2, 1.0]},
                    _ds(X), _ds(Y)).fit()
    for member in res:
        nodes = member.fitted.absorbable_nodes()
        assert len(nodes) == 1
        state = member.fitted.graph.get_operator(nodes[0]).solver_state
        assert state.n == len(X)
        assert state.lam == pytest.approx(member.params["lam"])
