"""The continual-learning trainer on a CUDA card: a killed absorb resumes
from its checkpoint bit for bit; the candidate's tensors, written on the
trainer thread's stream, are complete before any replica replays them
(served answers right after each promotion equal the promoted model's
eager apply); and a real out-of-memory error in the absorb stops the
daemon while the fleet serves on with the old model.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_trainer.py
"""

import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch import faults
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator, LinearMapper
from keystone_tpu_torch.obs import flight
from keystone_tpu_torch.serving import ServingFleet
from keystone_tpu_torch.trainer import ChunkLog, TrainerDaemon, TrainerStopped
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline
from keystone_tpu_torch.workflow.transformer import Transformer

WAIT = 60.0
LIMIT = 1e-5


@pytest.fixture
def cuda(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    PipelineEnv.get_or_create().reset()
    faults.clear()
    flight.reset()
    yield torch.device("cuda")
    faults.clear()
    flight.reset()
    PipelineEnv.get_or_create().reset()


class Feat(Transformer):
    """tanh(X R): a featurizer wide enough that a candidate's weights are
    large writes on the trainer's stream."""

    def __init__(self, R):
        self.R = R

    def forward(self, X):
        return torch.tanh(X @ self.R)


def _problem(cuda, d=64, width=2048, k=16, n=4096, rows=512):
    rng = np.random.RandomState(0)
    R = torch.from_numpy((rng.randn(d, width) / np.sqrt(d)).astype(np.float32)).to(cuda)
    W = rng.randn(width, k).astype(np.float32) / np.sqrt(width)

    def make(m, seed):
        r = np.random.RandomState(seed)
        X = (r.randn(m, d) + 0.5).astype(np.float32)
        Y = (np.tanh(X @ R.cpu().numpy()) @ W + 0.05 * r.randn(m, k)).astype(np.float32)
        return X, Y

    X0, Y0 = make(n, 1)
    fitted = Feat(R).to_pipeline().and_then(
        LinearMapEstimator(lam=1e-1, snapshot=True),
        ChunkedDataset.from_array(torch.from_numpy(X0).to(cuda), rows),
        Dataset.of(torch.from_numpy(Y0).to(cuda))).fit()
    return fitted, make, X0


def _state(fitted):
    return next(op for op in fitted.graph.operators.values()
                if isinstance(op, LinearMapper)).solver_state


def _wait(cond, timeout=WAIT):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout
        time.sleep(0.02)


@pytest.mark.cuda
def test_a_killed_absorb_resumes_bit_identical_on_the_card(cuda, tmp_path):
    fitted, make, _ = _problem(cuda)
    batch = [make(256, 10 + s) for s in range(4)]
    ref_log = ChunkLog()
    for X, Y in batch:
        ref_log.append(X, Y)
    want = _state(fitted.absorb(*ref_log.as_chunked(0, 4)))
    fleet = ServingFleet(fitted, replicas=1, buckets=(8,), max_wait_ms=1.0)
    log = ChunkLog()
    faults.install(faults.parse_plan("trainer.absorb=kill@2"))
    with fleet:
        with TrainerDaemon(fleet, log, poll_interval_s=0.01, refit_interval_s=0.0,
                           min_refit_chunks=4, canary_fraction=0.0, max_batch_retries=0,
                           max_restarts=1, checkpoint_dir=str(tmp_path)) as daemon:
            for X, Y in batch:
                log.append(X, Y)
            _wait(lambda: fleet.metrics.count("refits") >= 1)
            got = _state(daemon.fitted)
    assert faults.active_plan().injected.get("trainer.absorb") == 1
    assert fleet.metrics.count("trainer_restarts") == 1
    for a in ("gram", "cross", "sum_x", "sum_y"):
        assert np.array_equal(getattr(got, a), getattr(want, a)), a
    counts = log.production_counts
    assert {i: counts[i] for i in (0, 1, 2)} == {0: 1, 1: 1, 2: 2}


@pytest.mark.cuda
def test_answers_right_after_each_promotion_are_the_candidates(cuda):
    """Replicas replay on their own streams under traffic while the trainer
    thread writes each candidate: the first answers after every promotion
    equal the promoted model's eager apply."""
    fitted, make, X0 = _problem(cuda)
    rows = X0[:256]
    fleet = ServingFleet(fitted, replicas=2, buckets=(8, 32), max_wait_ms=1.0)
    log = ChunkLog()
    stop, failures = threading.Event(), []

    def client(tid):
        i = tid
        while not stop.is_set():
            try:
                fleet.predict(X0[i % len(X0)], timeout=30.0)
            except Exception as e:
                failures.append(repr(e))
            i += 4

    with fleet:
        threads = [threading.Thread(target=client, args=(t,), daemon=True) for t in range(4)]
        for t in threads:
            t.start()
        with TrainerDaemon(fleet, log, poll_interval_s=0.01, refit_interval_s=0.0,
                           min_refit_chunks=2, canary_fraction=0.5, canary_batches=2,
                           canary_timeout_s=10.0, canary_atol=1.0, canary_rtol=0.0,
                           max_batch_retries=0) as daemon:
            for b in range(3):
                for j in range(2):
                    log.append(*make(1024, 100 + 10 * b + j))
                _wait(lambda want=b + 1: fleet.metrics.count("refits") >= want)
                futures = [fleet.submit(r, timeout=30.0) for r in rows]
                got = np.stack([np.asarray(f.result(timeout=60.0)) for f in futures])
                want = daemon.fitted.apply(torch.from_numpy(rows).to(cuda)).to_array()
                assert np.max(np.abs(got - want.cpu().numpy())) <= LIMIT, b
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not failures
    assert fleet.model_version == 4 and not fleet.version_report()["skew"]


@pytest.mark.cuda
def test_an_out_of_memory_absorb_stops_the_trainer_and_the_fleet_serves_on(
        cuda, tmp_path, monkeypatch):
    fitted, make, X0 = _problem(cuda)
    probe = X0[:16]
    fleet = ServingFleet(fitted, replicas=2, buckets=(8,), max_wait_ms=1.0)
    log = ChunkLog()

    def absorb(self, *args, **kwargs):
        # more than any card holds: a real CUDA out-of-memory error
        return torch.empty(1 << 46, dtype=torch.uint8, device=cuda)

    with fleet:
        before = np.stack([np.asarray(fleet.predict(r, timeout=30.0)) for r in probe])
        monkeypatch.setattr(FittedPipeline, "absorb", absorb)
        daemon = TrainerDaemon(fleet, log, poll_interval_s=0.01, refit_interval_s=0.0,
                               min_refit_chunks=2, max_batch_retries=1, max_restarts=2)
        with daemon:
            for j in range(2):
                log.append(*make(256, 200 + j))
            _wait(lambda: daemon.device_fault is not None)
            assert isinstance(daemon.device_fault, torch.cuda.OutOfMemoryError)
            with pytest.raises(TrainerStopped) as stopped:
                daemon.start()
            assert stopped.value.__cause__ is daemon.device_fault
        monkeypatch.undo()
        after = np.stack([np.asarray(fleet.predict(r, timeout=30.0)) for r in probe])
        assert fleet.model_version == 1
    np.testing.assert_array_equal(before, after)
    assert fleet.metrics.count("trainer_restarts") == 0
    assert fleet.metrics.count("absorb_failures") == 0
    assert daemon.parked_batches == []
    assert list(tmp_path.glob("keystone-flight-*-device_fault-*.json"))
