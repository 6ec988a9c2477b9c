"""The port's pipelined scan runtime and sharded producers
(``keystone_tpu_torch/data/pipeline_scan.py``, ``data/shards.py``,
``faults/retry.py``) against the JAX package's on the CPU: the cases of
``tests/data/test_pipeline_scan.py`` and ``tests/data/test_sharded_producer.py``,
each chunk stream held equal to the JAX scan's of the same numpy input.

Tolerances: scans move chunks without arithmetic, so their outputs are
equal; a chain's arithmetic (x·2 + 1) is held at rtol 1e-6 as the JAX tests
hold it; the normal-equations solve at 2 shards at 1e-6.
"""

import gc
import hashlib
import threading
import time
import traceback

import numpy as np
import pytest
import torch

from keystone_tpu.data import ChunkedDataset as JChunked
from keystone_tpu.data import pipeline_scan as jscan
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.pipeline_scan import (
    ChunkPadder,
    Chunks,
    ScanPipeline,
    bucket_ladder,
    payload_nbytes,
    scan_pipeline,
)
from keystone_tpu_torch.data.shards import ShardedChunkProducer, maybe_shard
from keystone_tpu_torch.faults import RetryBudget, TransientError, retry_call
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _chunks(n=7, rows=5, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, d)).astype(np.float32) for _ in range(n)]


def _scan_threads(prefix="ks-scan"):
    return [t for t in threading.enumerate() if t.name.startswith(prefix) and t.is_alive()]


def _wait_gone(prefix="ks-scan", seconds=5.0):
    deadline = time.monotonic() + seconds
    while _scan_threads(prefix) and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _scan_threads(prefix)


def _np(chunks):
    return [np.asarray(c) for c in chunks]


# -- the pipeline's contract -------------------------------------------------


@pytest.mark.parametrize("pipelined", ["1", "0"])
def test_order_and_content_equal_the_jax_scans(monkeypatch, pipelined):
    monkeypatch.setenv("KEYSTONE_SCAN_PIPELINE", pipelined)
    chunks = _chunks(9)
    out = []
    for c in scan_pipeline(iter(chunks), depth=2, label="t"):
        time.sleep(0.005)  # a slow consumer: the producer fills the queue
        out.append(c)
    want = _np(jscan.scan_pipeline(iter(chunks), depth=2, label="t"))
    assert all(isinstance(c, torch.Tensor) for c in out)
    assert len(out) == len(want) == 9
    for got, w in zip(out, want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert _wait_gone()


def test_bounded_queue_never_exceeds_depth():
    depth = 2
    state = {"produced": 0, "consumed": 0, "max_ahead": 0}

    def source():
        for c in _chunks(12):
            state["produced"] += 1
            state["max_ahead"] = max(state["max_ahead"], state["produced"] - state["consumed"])
            yield c

    it = scan_pipeline(source(), depth=depth, label="t")
    assert isinstance(it, ScanPipeline)
    for _ in it:
        state["consumed"] += 1
        time.sleep(0.01)  # a slow consumer forces the most read-ahead
    # the queue, the chunk in the producer's hand and the one consumed
    # (the JAX scan's bound, 2·depth + 2, counts a staging ring as well)
    assert state["max_ahead"] <= depth + 2, state
    assert it.stats.occupancy_max <= depth
    assert it.stats.chunks == 12


def test_producer_exception_surfaces_with_its_traceback():
    def boom_source():
        yield np.zeros((2, 2), np.float32)
        raise RuntimeError("chunk 1 exploded")

    it = scan_pipeline(boom_source(), label="t")
    assert tuple(next(it).shape) == (2, 2)
    with pytest.raises(RuntimeError, match="chunk 1 exploded") as ei:
        list(it)
    assert "boom_source" in "".join(traceback.format_exception(ei.type, ei.value, ei.tb))
    assert _wait_gone()


def test_early_consumer_exit_joins_the_producer():
    def slow_source():
        for c in _chunks(100):
            time.sleep(0.001)
            yield c

    it = scan_pipeline(slow_source(), depth=2, label="t")
    next(it)
    thread = it._thread
    assert thread.is_alive()
    it.close()
    thread.join(timeout=5.0)
    assert not thread.is_alive()
    assert list(it) == []


def test_an_abandoned_scan_is_reaped_by_the_garbage_collector():
    it = scan_pipeline(iter(_chunks(50)), label="t")
    next(it)
    thread = it._thread
    del it
    gc.collect()
    thread.join(timeout=5.0)
    assert not thread.is_alive()


def test_generator_exit_in_a_wrapping_generator_does_not_deadlock():
    def consumer_gen():
        for c in scan_pipeline(iter(_chunks(50)), label="t"):
            yield c

    g = consumer_gen()
    next(g)
    g.close()
    assert _wait_gone()


def test_the_kill_switch_runs_no_thread_and_keeps_the_results(monkeypatch):
    monkeypatch.setenv("KEYSTONE_SCAN_PIPELINE", "0")
    chunks = _chunks(5)
    before = threading.active_count()
    it = scan_pipeline(iter(chunks), label="t")
    assert not isinstance(it, ScanPipeline)
    out = list(it)
    assert threading.active_count() == before
    for got, want in zip(out, chunks):
        np.testing.assert_array_equal(got.numpy(), want)


def test_scan_pipeline_is_idempotent():
    it = scan_pipeline(iter(_chunks(3)), label="t")
    assert scan_pipeline(it) is it
    list(it)


def test_steps_run_on_the_consumer_and_the_source_on_the_producer():
    seen = {"source": set(), "step": set()}

    def source():
        for c in _chunks(6):
            seen["source"].add(threading.current_thread().name)
            yield c

    def step(c):
        seen["step"].add(threading.current_thread().name)
        return c * 2.0

    out = list(scan_pipeline(Chunks(source(), (step,)), label="steps"))
    assert seen["source"] == {"ks-scan[steps]"}
    assert seen["step"] == {threading.current_thread().name}
    for got, want in zip(out, _chunks(6)):
        np.testing.assert_array_equal(got.numpy(), want * 2.0)


def test_a_failing_step_closes_the_scan():
    def step(c):
        raise ValueError("step failed")

    it = scan_pipeline(Chunks(iter(_chunks(20)), (step,)), label="t")
    with pytest.raises(ValueError, match="step failed"):
        next(it)
    assert it._closed
    assert _wait_gone()


def test_chunked_dataset_scans_through_the_pipeline_and_matches_jax():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((41, 4)).astype(np.float32)
    ds = ChunkedDataset.from_array(X, 8).map_batch(lambda c: c * 2.0)
    it = ds.chunks()
    assert isinstance(it, ScanPipeline)
    it.close()
    want = np.asarray(JChunked.from_array(X, 8).map_batch(lambda c: c * 2.0).to_array())
    np.testing.assert_allclose(ds.to_array().numpy(), want, rtol=1e-6)
    assert _wait_gone()


def test_scan_stats_count_chunks_stalls_and_bytes():
    ds = ChunkedDataset.from_array(np.ones((20, 3), np.float32), 6)
    it = ds.chunks()
    list(it)
    stats = it.stats.as_dict()
    assert stats["chunks"] == 4 and stats["depth"] == 2 and stats["shards"] == 1
    for key in ("producer_seconds", "producer_stall_seconds", "consumer_stall_seconds",
                "occupancy_max", "staged_bytes", "retries"):
        assert stats[key] >= 0
    assert stats["end"] >= stats["start"]


@pytest.mark.parametrize("payload", [
    np.zeros((4, 2), np.float64), np.zeros((4, 2), np.int8),
    (np.zeros((2, 2), np.float32), np.zeros((2,), np.float16)), [1.0, 2.0],
], ids=["f64", "i8", "tuple", "python-floats"])
def test_payload_nbytes_equals_jax(payload):
    assert payload_nbytes(payload) == jscan.payload_nbytes(payload)
    tensors = payload if isinstance(payload, list) else tuple(
        torch.from_numpy(a) for a in (payload if isinstance(payload, tuple) else (payload,)))
    assert payload_nbytes(tensors) == jscan.payload_nbytes(payload)


# -- row buckets ---------------------------------------------------------------


@pytest.mark.parametrize("lead,levels,multiple", [
    (512, 4, 1), (1000, 4, 1), (1, 4, 1), (65536, 4, 1), (3392, 4, 1), (7, 3, 4),
    (4096, 1, 1), (2500, 5, 8),
])
def test_bucket_ladders_equal_jax(lead, levels, multiple):
    assert bucket_ladder(lead, levels, multiple) == jscan.bucket_ladder(lead, levels, multiple)


def test_chunk_padder_runs_per_bucket_and_is_exact():
    calls = []

    def fn(x):
        calls.append(int(x.shape[0]))
        return x + 1.0

    padder = ChunkPadder(fn)
    sizes = [512, 480, 500, 300, 450, 200]
    rng = np.random.default_rng(3)
    for r in sizes:
        x = torch.from_numpy(rng.standard_normal((r, 4)).astype(np.float32))
        out = padder(x)
        assert tuple(out.shape) == (r, 4)
        np.testing.assert_allclose(out.numpy(), x.numpy() + 1.0, rtol=1e-6)
    ladder = set(bucket_ladder(512))
    assert set(calls) <= ladder and len(set(calls)) < len(set(sizes))


def test_chunk_padder_kill_switch(monkeypatch):
    monkeypatch.setenv("KEYSTONE_CHUNK_BUCKETS", "0")
    shapes = []

    def fn(x):
        shapes.append(int(x.shape[0]))
        return x

    padder = ChunkPadder(fn)
    padder(torch.zeros(512, 2))
    padder(torch.zeros(300, 2))
    assert shapes == [512, 300]


def test_a_fused_chain_over_ragged_chunks_sees_one_shape_a_bucket():
    sizes = [64, 60, 62, 40, 25, 64]
    rng = np.random.default_rng(11)
    parts = [rng.standard_normal((r, 5)).astype(np.float32) for r in sizes]
    ds = ChunkedDataset.from_chunk_fn(lambda i: parts[i], len(sizes), sum(sizes))
    shapes = []

    def f1(x):
        shapes.append(int(x.shape[0]))
        return x * 2.0

    pipe = FunctionNode(batch_fn=f1).and_then(FunctionNode(batch_fn=lambda x: x + 1.0))
    out = pipe.apply(ds).get()
    assert isinstance(out, ChunkedDataset)
    got = out.to_array().numpy()
    jds = JChunked.from_chunk_fn(lambda i: parts[i], len(sizes), sum(sizes))
    from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode

    jpipe = JFunctionNode(batch_fn=lambda x: x * 2.0).and_then(
        JFunctionNode(batch_fn=lambda x: x + 1.0))
    np.testing.assert_allclose(got, np.asarray(jpipe.apply(jds).get().to_array()), rtol=1e-6)
    assert set(shapes) <= set(bucket_ladder(64))


def test_chunked_map_thread_pool_keeps_the_order(monkeypatch):
    rng = np.random.default_rng(13)
    X = rng.standard_normal((33, 6)).astype(np.float32)
    want = np.asarray(JChunked.from_array(X, 7).map(lambda row: row * 3.0).to_array())
    for workers in ("4", "1"):
        monkeypatch.setenv("KEYSTONE_MAP_WORKERS", workers)
        out = ChunkedDataset.from_array(X, 7).map(lambda row: row * 3.0)
        np.testing.assert_allclose(out.to_array().numpy(), want, rtol=1e-6)


# -- retries ---------------------------------------------------------------------


def test_from_chunk_fn_retries_transient_failures_within_the_budget(monkeypatch):
    monkeypatch.setenv("KEYSTONE_SCAN_RETRIES", "2")
    monkeypatch.setenv("KEYSTONE_SCAN_RETRY_BACKOFF", "0")
    fails = {1: 2}  # chunk 1 fails twice, then succeeds

    def chunk_fn(i):
        if fails.get(i, 0):
            fails[i] -= 1
            raise TransientError(f"flaky {i}")
        return np.full((2, 2), i, np.float32)

    out = ChunkedDataset.from_chunk_fn(chunk_fn, 3, 6).to_array().numpy()
    np.testing.assert_array_equal(out[:, 0], [0, 0, 1, 1, 2, 2])


@pytest.mark.parametrize("error,retries", [(TransientError("flaky"), "0"),
                                           (RuntimeError("broken"), "5")],
                         ids=["budget-spent", "not-transient"])
def test_a_failure_the_budget_does_not_cover_propagates_as_raised(monkeypatch, error, retries):
    monkeypatch.setenv("KEYSTONE_SCAN_RETRIES", retries)
    monkeypatch.setenv("KEYSTONE_SCAN_RETRY_BACKOFF", "0")

    def chunk_fn(i):
        raise error

    with pytest.raises(type(error), match=str(error)):
        ChunkedDataset.from_chunk_fn(chunk_fn, 3, 6).to_array()
    assert _wait_gone()


def test_retry_budget_counts_attempts():
    budget = RetryBudget(budget=1, backoff_s=0.0)
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            raise ConnectionError("dropped")
        return "ok"

    assert retry_call(fn, budget, "scan.stage") == "ok"
    assert budget.attempts == 1


# -- sharded production ---------------------------------------------------------


def _chunk_fn(i, rows=8, d=4):
    return np.random.RandomState(1000 + i).randn(rows, d).astype(np.float32)


def _dataset(n_chunks=12, rows=8, d=4):
    return ChunkedDataset.from_chunk_fn(lambda i: _chunk_fn(i, rows, d), n_chunks,
                                        n_chunks * rows, label="shardtest")


def _digest(chunks):
    h = hashlib.sha256()
    for c in chunks:
        h.update(np.ascontiguousarray(np.asarray(c)).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("shards", [2, 3, 5])
def test_the_stream_is_the_same_at_every_shard_count(monkeypatch, shards):
    monkeypatch.delenv("KEYSTONE_SCAN_SHARDS", raising=False)
    base = _digest(_dataset().raw_chunks())
    jds = JChunked.from_chunk_fn(lambda i: _chunk_fn(i), 12, 96, label="shardtest")
    assert _digest(jds.raw_chunks()) == base  # the JAX scan's bytes
    monkeypatch.setenv("KEYSTONE_SCAN_SHARDS", str(shards))
    assert _digest(_dataset().raw_chunks()) == base
    assert _digest(_dataset().chunks()) == base


def test_sharded_production_through_a_map_chain(monkeypatch):
    ds = _dataset().map_batch(lambda c: c * 2.0 + 1.0)
    monkeypatch.delenv("KEYSTONE_SCAN_SHARDS", raising=False)
    base = _digest(ds.raw_chunks())
    monkeypatch.setenv("KEYSTONE_SCAN_SHARDS", "3")
    assert _digest(ds.raw_chunks()) == base


def test_shards_partition_the_index_space():
    prod = ShardedChunkProducer(
        lambda start, step: iter(_chunk_fn(i) for i in range(start, 10, step)), 3, label="t")
    assert len(list(prod)) == 10
    assert sorted(prod.shard_chunks, reverse=True) == [4, 3, 3]


def test_skip_and_shards_compose(monkeypatch):
    expect = _digest(list(_dataset().raw_chunks())[4:])
    monkeypatch.setenv("KEYSTONE_SCAN_SHARDS", "2")
    assert _digest(_dataset().raw_chunks(skip=4)) == expect


def test_a_shard_error_surfaces_at_its_index():
    def fn(i):
        if i == 5:
            raise RuntimeError("boom at 5")
        return _chunk_fn(i)

    ds = ChunkedDataset.from_chunk_fn(fn, 8, 64, label="errtest")
    it = maybe_shard(ds._skip_factory, lambda: iter(ds._payload()), shards=3, label="errtest")
    got = []
    with pytest.raises(RuntimeError, match="boom at 5"):
        for c in it:
            got.append(c)
    assert len(got) == 5
    assert _digest(got) == _digest(_chunk_fn(i) for i in range(5))


def test_early_close_joins_the_shard_threads():
    prod = ShardedChunkProducer(
        lambda start, step: iter(_chunk_fn(i) for i in range(start, 100, step)), 4,
        label="close")
    next(prod)
    prod.close()
    assert _wait_gone("ks-shard[close]")


def test_an_opaque_factory_falls_back_to_one_producer(monkeypatch):
    def factory():
        for i in range(6):
            yield _chunk_fn(i)

    monkeypatch.setenv("KEYSTONE_SCAN_SHARDS", "4")
    got = list(ChunkedDataset(factory, 48, label="opaque").raw_chunks())
    assert _digest(got) == _digest(_chunk_fn(i) for i in range(6))


def test_the_streaming_solve_is_the_same_at_two_shards(monkeypatch):
    from keystone_tpu_torch.linalg.normal_equations import solve_least_squares_streaming

    W = np.random.RandomState(7).randn(6, 3).astype(np.float32)

    def xy(i):
        X = _chunk_fn(i, 16, 6)
        return X, X @ W

    ds = ChunkedDataset.from_chunk_fn(xy, 8, 128)
    monkeypatch.delenv("KEYSTONE_SCAN_SHARDS", raising=False)
    w1 = solve_least_squares_streaming(ds.raw_chunks(), reg=1e-3).numpy()
    monkeypatch.setenv("KEYSTONE_SCAN_SHARDS", "2")
    w2 = solve_least_squares_streaming(ds.raw_chunks(), reg=1e-3).numpy()
    np.testing.assert_allclose(w1, w2, atol=1e-6, rtol=1e-6)


def test_scan_stats_carry_the_shard_split(monkeypatch):
    monkeypatch.setenv("KEYSTONE_SCAN_SHARDS", "3")
    it = _dataset(n_chunks=9).chunks()
    list(it)
    assert it.stats.shards == 3 and sum(it.stats.shard_chunks) == 9
