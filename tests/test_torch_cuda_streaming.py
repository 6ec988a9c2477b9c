"""The out-of-core scan on a CUDA card: the producer thread's copies on a
stream of the scan, handed over with an event and ``record_stream``; chunks
drawn on the card by index; the fused group's CUDA graphs over ragged
chunks; and the streaming solvers, pipelined against serial.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_streaming.py

Tolerances: a scan pipelined and serial runs the same kernels on the same
data, so results are bit-equal; the record_stream check holds the card
against the same work in float64 on the host at rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.pipeline_scan import ScanPipeline, bucket_ladder, scan_pipeline
from keystone_tpu_torch.linalg import bcd
from keystone_tpu_torch.nodes.learning.linear import (
    BlockLeastSquaresEstimator,
    LinearMapEstimator,
    TSQRLeastSquaresEstimator,
)
from keystone_tpu_torch.workflow import fusion
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state and the fused groups' graphs, reset around
    each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    fusion.clear_graph_cache()
    yield env
    env.reset()
    fusion.clear_graph_cache()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _host_chunks(n=12, rows=4096, d=256, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, d)).astype(np.float32) for _ in range(n)]


def _drawn(cuda, n=6, rows=2048, d=512, seed=3):
    """A chunk source drawn on the card, each chunk by its own generator."""
    def chunk_fn(i):
        gen = torch.Generator(device=cuda).manual_seed(seed * 100_003 + i)
        return torch.randn(rows, d, device=cuda, generator=gen)

    return ChunkedDataset.from_chunk_fn(chunk_fn, n, n * rows)


@pytest.mark.cuda
def test_host_chunks_are_staged_to_the_card_bit_equal_pipelined_and_serial(cuda, monkeypatch):
    chunks = _host_chunks()
    W = torch.randn(256, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    results = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("KEYSTONE_SCAN_PIPELINE", mode)
        it = scan_pipeline(iter(chunks), label="stage", device=cuda)
        assert isinstance(it, ScanPipeline) == (mode == "1")
        acc = torch.zeros(64, 64, device=cuda)
        for c in it:
            assert c.is_cuda
            h = c @ W
            acc += h.T @ h
        if mode == "1":
            assert it.stats.staged_bytes == sum(c.nbytes for c in chunks)
        results[mode] = acc
    assert torch.equal(results["1"], results["0"])


@pytest.mark.cuda
def test_record_stream_keeps_a_staged_chunk_alive_under_allocator_pressure(cuda):
    """The consumer queues slow work on each staged chunk and drops it at
    once, while the producer keeps copying same-sized chunks into blocks
    the allocator would reuse: without ``record_stream`` a later copy could
    land in a chunk the card has not read yet."""
    chunks = _host_chunks(n=16, rows=8192, d=512, seed=4)
    big = torch.randn(4096, 4096, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    sums = []
    for c in scan_pipeline(iter(chunks), depth=1, label="pressure", device=cuda):
        for _ in range(4):  # keep the consumer's stream behind the host
            big = (big @ big).clamp_(-1.0, 1.0)
        sums.append(c.double().sum(dim=0))
        del c
    torch.cuda.synchronize()
    want = [torch.from_numpy(c.astype(np.float64).sum(axis=0)) for c in chunks]
    for got, w in zip(sums, want):
        torch.testing.assert_close(got.cpu(), w, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_a_card_drawn_source_gives_the_same_chunks_every_scan(cuda, monkeypatch):
    ds = _drawn(cuda)
    first = ds.to_array()
    assert first.is_cuda and first.shape == (6 * 2048, 512)
    assert torch.equal(first, ds.to_array())
    monkeypatch.setenv("KEYSTONE_SCAN_PIPELINE", "0")
    assert torch.equal(first, ds.to_array())
    assert not torch.equal(first[:2048], first[2048:4096])  # one generator a chunk


@pytest.mark.cuda
def test_ragged_chunks_capture_at_most_one_graph_a_bucket(cuda, monkeypatch):
    sizes = [512, 480, 500, 300, 450, 200]
    rng = np.random.default_rng(5)
    parts = [torch.from_numpy(rng.standard_normal((r, 16)).astype(np.float32)).to(cuda)
             for r in sizes]
    outs, captures = {}, {}
    for buckets in ("0", "1"):
        monkeypatch.setenv("KEYSTONE_CHUNK_BUCKETS", buckets)
        fusion.clear_graph_cache()
        PipelineEnv.get_or_create().reset()
        ds = ChunkedDataset.from_chunk_fn(lambda i: parts[i], len(sizes), sum(sizes))
        pipe = FunctionNode(batch_fn=lambda x: x * 2.0).and_then(
            FunctionNode(batch_fn=lambda x: torch.tanh(x) + 1.0))
        outs[buckets] = pipe.apply(ds).get().to_array()
        captures[buckets] = sum(len(cache) for cache in fusion._FUSED_GRAPHS.values())
    assert captures["1"] <= len(bucket_ladder(sizes[0])) < captures["0"] == len(set(sizes))
    torch.testing.assert_close(outs["1"], outs["0"], rtol=1e-6, atol=0)
    torch.testing.assert_close(outs["1"], torch.tanh(torch.cat(parts) * 2.0) + 1.0,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("make", [
    lambda: BlockLeastSquaresEstimator(256, 2, lam=1e-2),
    lambda: LinearMapEstimator(1e-2),
    lambda: TSQRLeastSquaresEstimator(1e-2),
], ids=["block", "exact", "tsqr"])
def test_streaming_fits_are_bit_equal_pipelined_and_serial(cuda, monkeypatch, make):
    ds = _drawn(cuda, n=5, rows=1024, d=512, seed=7)
    Y = torch.randn(5 * 1024, 10, device=cuda, generator=torch.Generator(cuda).manual_seed(8))
    X = torch.randn(7, 512, device=cuda, generator=torch.Generator(cuda).manual_seed(9))
    preds = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("KEYSTONE_SCAN_PIPELINE", mode)
        model = make().fit(ds, Y)
        preds[mode] = model.forward(X)
    assert torch.equal(preds["1"], preds["0"])


@pytest.mark.cuda
def test_the_streaming_bcd_on_host_chunks_matches_the_in_memory_solve(cuda):
    chunks = _host_chunks(n=6, rows=2048, d=256, seed=10)
    A = torch.from_numpy(np.concatenate(chunks)).to(cuda)
    y = torch.randn(A.shape[0], 8, device=cuda, generator=torch.Generator(cuda).manual_seed(11))
    means = A.mean(dim=0)
    ws = bcd.solve_blockwise_l2_streaming(lambda: iter(chunks), y, 0.1, 64, 2, means=means)
    mem = bcd.solve_blockwise_l2_scan(A, y, 0.1, 64, 2, means=means)
    torch.testing.assert_close(torch.cat(ws), mem, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["host", "card"])
def test_the_laned_streaming_bcd_over_four_slots_of_the_card_equals_one_lane(cuda, source):
    """The streamed BCD at 4 lanes over a mesh of 4 slots of ``cuda:0``
    against one lane on the same chunks: the same folds in another order,
    within float32 rounding (rtol 1e-5 of the weights' scale); each scan
    records its lanes and at most 2·4 + 2·3 collectives."""
    from keystone_tpu_torch.obs import SCAN_SPAN
    from keystone_tpu_torch.obs import tracer as obs_tracer
    from keystone_tpu_torch.parallel import make_mesh, use_mesh, virtual_slots

    if source == "host":
        chunks = _host_chunks(n=6, rows=2048, d=256, seed=12)
        scan = lambda: iter(chunks)  # noqa: E731
        n = 6 * 2048
    else:
        ds = _drawn(cuda, n=6, rows=2048, d=256, seed=12)
        scan, n = ds.raw_chunks, len(ds)
    y = torch.randn(n, 8, device=cuda, generator=torch.Generator(cuda).manual_seed(13))
    means, _ = bcd.stream_column_means(scan, device=cuda, lanes=1)
    one = bcd.solve_blockwise_l2_streaming(scan, y, 0.1, 64, 2, means=means, lanes=1)
    tracer = obs_tracer.start()
    try:
        with use_mesh(make_mesh(devices=virtual_slots(4, cuda))):
            four = bcd.solve_blockwise_l2_streaming(scan, y, 0.1, 64, 2, means=means)
        spans = [sp for sp in tracer.spans() if sp.name == SCAN_SPAN]
    finally:
        obs_tracer.reset()
    W1, W4 = torch.cat(one), torch.cat(four)
    assert W4.device.type == "cuda"
    assert (W4 - W1).abs().max().item() <= 1e-5 * W1.abs().max().item()
    assert len(spans) == 8 and all(sp.attrs["lanes"] == 4 for sp in spans)
    assert all(0 < sp.attrs["collectives"] <= 14 for sp in spans)
    assert all(sp.attrs["lane_chunks"] == [2, 2, 1, 1] for sp in spans)
