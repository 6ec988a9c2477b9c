"""``DriftMonitor`` on the port (``keystone_tpu_torch/trainer/drift.py``)
against the JAX package's: every case of ``tests/trainer/test_drift.py``
with the same ``MomentsState`` baseline and the same chunk stream through
both monitors in lockstep. After every observation and re-baseline the two
``score()`` dicts agree within 1e-12 relative (both fold the same float64
rows by the same Chan/Welford formulas) and the ``should_refit`` verdicts
are equal; each case's own assertions hold on the port. A baseline taken
from each package's fitted solver state (the same numpy fit data) agrees
within 1e-6 relative: their float32 chunk products round apart."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data.chunked import ChunkedDataset as JChunked
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.linalg.accumulators import MomentsState as JMomentsState
from keystone_tpu.nodes.learning import LinearMapEstimator as JLinearMapEstimator
from keystone_tpu.trainer import DriftMonitor as JDriftMonitor
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.linalg.accumulators import MomentsState
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.trainer import DriftMonitor
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode

D = 8
SCORE_RTOL = 1e-12


@pytest.fixture(autouse=True)
def envs():
    PipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    PipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _baselines(n=4096, seed=0, std=1.0):
    r = np.random.RandomState(seed)
    rows = (r.randn(n, D) * std + 2.0).astype(np.float64)
    port, ref = MomentsState(), JMomentsState()
    port.update(rows)
    ref.update(rows)
    return port, ref


def _close(a, b):
    if a is None or b is None:
        return a is b
    return abs(a - b) <= SCORE_RTOL * max(abs(a), abs(b), 1e-300)


class Twin:
    """The port's monitor and the JAX package's, fed the same calls; every
    call is followed by the agreement check."""

    def __init__(self, **kw):
        port, ref = _baselines()
        self.port = DriftMonitor(port, **kw)
        self.ref = JDriftMonitor(ref, **kw)
        self.steps = 0

    def agree(self):
        got, want = self.port.score(), self.ref.score()
        assert set(got) == set(want)
        assert got["rows"] == want["rows"]
        for key in ("z_max", "var_ratio_max", "residual_ratio", "drift_score"):
            assert _close(got[key], want[key]), (key, got[key], want[key])
        assert self.port.should_refit() == self.ref.should_refit()
        self.steps += 1

    def stream(self, chunks, rows, seed, shift=0.0, std=1.0, mse=None):
        r = np.random.RandomState(seed)
        for _ in range(chunks):
            feats = r.randn(rows, D) * std + 2.0 + shift
            self.port.observe(feats, mse)
            self.ref.observe(feats, mse)
            self.agree()

    def rebaseline(self):
        port, ref = _baselines()
        self.port.rebaseline(port)
        self.ref.rebaseline(ref)
        self.agree()

    def verdict(self):
        self.agree()
        return self.port.should_refit()

    def score(self):
        return self.port.score()


def test_stationary_stream_never_trips():
    twin = Twin(min_rows=64)
    for i in range(50):
        twin.stream(1, 64, seed=100 + i)
        assert twin.verdict() is None, twin.score()
    s = twin.score()
    assert s["z_max"] < 6.0 and s["var_ratio_max"] < 4.0
    assert twin.steps == 100


def test_mean_shift_trips_at_documented_threshold():
    twin = Twin(min_rows=256)
    twin.stream(4, 64, seed=1, shift=0.1)
    assert twin.verdict() is None
    twin.rebaseline()
    twin.stream(4, 64, seed=2, shift=1.0)
    reason = twin.verdict()
    assert reason is not None and "mean shift" in reason
    assert twin.score()["z_max"] > 6.0


def test_variance_shift_trips():
    twin = Twin(min_rows=256, z_threshold=50.0)
    twin.stream(4, 64, seed=3, std=1.2)
    assert twin.verdict() is None
    twin.rebaseline()
    twin.stream(4, 64, seed=4, std=3.0)
    reason = twin.verdict()
    assert reason is not None and "variance" in reason


def test_min_rows_gates_every_trigger():
    twin = Twin(min_rows=256)
    twin.stream(1, 64, seed=5, shift=5.0)
    assert twin.verdict() is None
    twin.stream(3, 64, seed=5, shift=5.0)
    assert twin.verdict() is not None


def test_residual_trigger_with_labels():
    twin = Twin(min_rows=64, residual_warmup=2)
    twin.stream(2, 64, seed=6, mse=1.0)
    twin.stream(2, 64, seed=7, mse=1.1)
    assert twin.verdict() is None
    twin.stream(4, 64, seed=8, mse=5.0)
    reason = twin.verdict()
    assert reason is not None and "residual" in reason
    assert twin.score()["residual_ratio"] > 2.0


def test_works_without_labels():
    twin = Twin(min_rows=256)
    twin.stream(4, 64, seed=9)
    assert twin.score()["residual_ratio"] is None
    assert twin.verdict() is None
    twin.stream(4, 64, seed=10, shift=1.0)
    assert twin.verdict() is not None


def test_rebaseline_resets_recent_and_residual():
    twin = Twin(min_rows=64, residual_warmup=1)
    twin.stream(4, 64, seed=11, shift=1.0, mse=1.0)
    assert twin.verdict() is not None
    twin.rebaseline()
    s = twin.score()
    assert s["rows"] == 0 and s["residual_ratio"] is None
    assert twin.verdict() is None


@pytest.mark.parametrize("cls, state", [(DriftMonitor, MomentsState),
                                        (JDriftMonitor, JMomentsState)], ids=["port", "jax"])
def test_empty_baseline_rejected(cls, state):
    with pytest.raises(ValueError, match="fitted moments"):
        cls(state())


def test_zero_baseline_residual_still_triggers():
    twin = Twin(min_rows=64, residual_warmup=2)
    twin.stream(2, 64, seed=20, mse=0.0)
    twin.stream(4, 64, seed=21, mse=1.0)
    assert twin.score()["residual_ratio"] is not None
    reason = twin.verdict()
    assert reason is not None and "residual" in reason


def test_a_card_tensor_chunk_is_folded_as_its_host_rows():
    """The daemon hands the monitor the features where they lie (a tensor
    on the card there, a CPU tensor here): the same score as the rows."""
    port, _ = _baselines()
    a, b = DriftMonitor(port, min_rows=64), DriftMonitor(port, min_rows=64)
    feats = np.random.RandomState(3).randn(128, D) + 2.5
    a.observe(torch.from_numpy(feats), 0.5)
    b.observe(feats, 0.5)
    assert a.score() == b.score()


def test_baselines_from_each_packages_fitted_state_agree():
    """The daemon's default baseline is the fitted solver state's moments:
    the same snapshot fit in both packages gives the same baseline."""
    r = np.random.RandomState(0)
    X = (r.randn(384, 12) + 1.0).astype(np.float32)
    Y = (np.tanh(X) @ r.randn(12, 3)).astype(np.float32)
    port = (FunctionNode(batch_fn=torch.tanh, label="feat").to_pipeline()
            .and_then(LinearMapEstimator(lam=1e-2, snapshot=True),
                      ChunkedDataset.from_array(torch.from_numpy(X), 64),
                      Dataset.of(torch.from_numpy(Y))).fit())
    ref = (JFunctionNode(batch_fn=lambda A: jnp.tanh(A), label="feat").to_pipeline()
           .and_then(JLinearMapEstimator(lam=1e-2, snapshot=True), JChunked.from_array(X, 64),
                     JDataset.of(Y)).fit())
    got = port._absorb_node()[1].solver_state.moments()
    want = ref._absorb_node()[1].solver_state.moments()
    assert got.n == want.n == 384
    for a, b in ((got.mean, want.mean), (got.m2, want.m2)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.max(np.abs(a - b)) <= 1e-6 * np.max(np.abs(b))
