"""The port's concurrent pull scheduler (``workflow/executor.py``), the
cases of ``tests/workflow/test_parallel_executor.py``: parallel against
serial output on the MnistRandomFFT gather (equal, and equal to the JAX
package's within the FFT tolerance of ``test_torch_mnist_fft.py``),
branches spread over workers, a diamond computed exactly once under
contention, branch exceptions propagating with their traceback, and the
``KEYSTONE_PAR_EXEC=0`` kill switch."""

import threading
import time
import traceback

import numpy as np
import pytest
import torch

from keystone_tpu.pipelines import mnist_random_fft as jm
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu_torch.pipelines import mnist_random_fft as tm
from keystone_tpu_torch.utils import env_flag, env_int
from keystone_tpu_torch.workflow import executor as texecutor
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import Pipeline
from keystone_tpu_torch.workflow.transformer import FunctionNode

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def port_env():
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _as_numpy(payload):
    if isinstance(payload, tuple):
        return np.stack([_as_numpy(p) for p in payload])
    return np.asarray(payload)


def _run(pipeline_factory, data, monkeypatch, parallel, workers=2):
    """Apply a freshly built pipeline with the executor mode pinned; a fresh
    build and a reset keep an earlier run's saved state out of the next."""
    PipelineEnv.get_or_create().reset()
    monkeypatch.setenv("KEYSTONE_PAR_EXEC", "1" if parallel else "0")
    monkeypatch.setenv("KEYSTONE_EXEC_WORKERS", str(workers))
    return _as_numpy(pipeline_factory().apply(data).get().to_array())


def test_mnist_random_fft_gather_parallel_matches_serial_and_jax(monkeypatch):
    signs = np.stack([np.array(jm.RandomSignNode.create(784, seed=3 + i).signs)
                      for i in range(4)])
    X = np.random.default_rng(0).standard_normal((16, 784)).astype(np.float32)

    def build():
        return tm.build_featurizer(tm.MnistRandomFFTConfig(num_ffts=4, seed=3), CPU,
                                   signs=signs)

    serial = _run(build, torch.from_numpy(X), monkeypatch, False)
    parallel = _run(build, torch.from_numpy(X), monkeypatch, True)
    assert serial.shape == (16, 4 * 512)
    np.testing.assert_array_equal(serial, parallel)
    JPipelineEnv.get_or_create().reset()
    want = np.asarray(jm.build_featurizer(jm.MnistRandomFFTConfig(num_ffts=4, seed=3))
                      .apply(X).get().to_array())
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(parallel - want) <= 1e-4 * scale)


def _host_branch(label, record=None, stall=0.0, boom=False):
    """A per-item branch without ``forward``: fusion cannot take it, so it
    stays a node of its own, forced on the pool."""

    def feat(x):
        if record is not None:
            record.append((label, threading.current_thread().name))
        if boom:
            raise RuntimeError(f"boom in {label}")
        if stall:
            time.sleep(stall)
        return x * 2.0

    return FunctionNode(item_fn=feat, label=label)


def test_host_branches_use_multiple_workers(monkeypatch):
    record = []
    X = torch.ones(3, 4)
    out = _run(lambda: Pipeline.gather([_host_branch(f"b{i}", record, stall=0.02)
                                        for i in range(4)]),
               X, monkeypatch, parallel=True, workers=2)
    threads = {t for _, t in record}
    assert len(threads) >= 2, threads
    assert all(t.startswith("keystone-exec") for t in threads), threads
    serial = _run(lambda: Pipeline.gather([_host_branch(f"b{i}") for i in range(4)]),
                  X, monkeypatch, parallel=False)
    np.testing.assert_array_equal(out, serial)


def test_kill_switch_keeps_everything_on_the_calling_thread(monkeypatch):
    record = []
    _run(lambda: Pipeline.gather([_host_branch(f"b{i}", record) for i in range(4)]),
         torch.ones(3, 4), monkeypatch, parallel=False)
    assert {t for _, t in record} == {threading.current_thread().name}


def test_diamond_computes_exactly_once_under_contention(monkeypatch):
    calls = []
    lock = threading.Lock()

    def shared_fn(x):
        with lock:
            calls.append(threading.current_thread().name)
        time.sleep(0.01)
        return x + 1.0

    # one shared instance in every branch: CSE merges the four copies into
    # a diamond apex that every branch races to force
    shared = FunctionNode(item_fn=shared_fn, label="shared")
    n_items = 3
    out = _run(lambda: Pipeline.gather([shared.and_then(_host_branch(f"b{i}", stall=0.01))
                                        for i in range(4)]),
               torch.ones(n_items, 4), monkeypatch, parallel=True, workers=4)
    # once per item of ONE pass: a recomputed apex would double this
    assert len(calls) == n_items, calls
    np.testing.assert_array_equal(out, np.full((4, n_items, 4), 4.0, np.float32))


def test_branch_exception_propagates_and_cancels_unstarted_siblings(monkeypatch):
    record = []

    def build():
        # boom is first in topological order: with one worker it fails
        # before any sibling is submitted
        return Pipeline.gather([_host_branch("boom", boom=True)]
                               + [_host_branch(f"b{i}", record) for i in range(1, 4)])

    with pytest.raises(RuntimeError, match="boom in boom") as excinfo:
        _run(build, torch.ones(2, 4), monkeypatch, parallel=True, workers=1)
    frames = [f.name for f in traceback.extract_tb(excinfo.value.__traceback__)]
    assert "feat" in frames, frames
    assert record == [], f"cancelled siblings still ran: {record}"


def test_branch_exception_propagates_with_concurrent_siblings(monkeypatch):
    def build():
        return Pipeline.gather([_host_branch(f"b{i}", stall=0.01) for i in range(3)]
                               + [_host_branch("boom", boom=True)])

    with pytest.raises(RuntimeError, match="boom"):
        _run(build, torch.ones(2, 4), monkeypatch, parallel=True, workers=4)


def test_a_chain_is_never_scheduled(monkeypatch):
    """A strict chain has no width: no pool, every node on the caller."""
    record = []
    chain = _host_branch("a", record).and_then(_host_branch("b", record)) \
        .and_then(_host_branch("c", record))
    _run(lambda: chain, torch.ones(2, 4), monkeypatch, parallel=True, workers=4)
    assert {t for _, t in record} == {threading.current_thread().name}


def test_stress_many_branches_more_workers_than_cores(monkeypatch):
    """More workers than cores and a short switch interval: every branch
    runs once and the result is the serial one."""
    import os
    import sys

    counts = {}
    lock = threading.Lock()

    def counted(i):
        def feat(x):
            with lock:
                counts[i] = counts.get(i, 0) + 1
            return x * float(i)
        return FunctionNode(item_fn=feat, label=f"c{i}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = 2 * (os.cpu_count() or 1) + 2
        out = _run(lambda: Pipeline.gather([counted(i) for i in range(24)]),
                   torch.ones(2, 3), monkeypatch, parallel=True, workers=workers)
    finally:
        sys.setswitchinterval(old)
    assert counts == {i: 2 for i in range(24)}  # once per item
    np.testing.assert_array_equal(out[:, 0, 0], np.arange(24, dtype=np.float32))


def test_switch_readers(monkeypatch):
    monkeypatch.delenv("KEYSTONE_PAR_EXEC", raising=False)
    assert env_flag("KEYSTONE_PAR_EXEC") and texecutor.parallel_enabled()
    for off in ("0", "false", "No", "OFF"):
        monkeypatch.setenv("KEYSTONE_PAR_EXEC", off)
        assert not texecutor.parallel_enabled()
    monkeypatch.setenv("KEYSTONE_EXEC_WORKERS", "3")
    assert texecutor.exec_workers() == 3
    monkeypatch.setenv("KEYSTONE_EXEC_WORKERS", "0")
    assert texecutor.exec_workers() == 1
    monkeypatch.setenv("KEYSTONE_EXEC_WORKERS", "many")
    assert env_int("KEYSTONE_EXEC_WORKERS", 5) == 5
