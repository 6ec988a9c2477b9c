"""The serving fleet on a CUDA card: co-resident replicas each capture
their own CUDA graph of each bucket on their own stream (one compile a
bucket, replicas × buckets captures), K1's launches counted exactly under
four replica threads, answers equal to the eager apply, and a swap under
traffic neither fails a capture nor corrupts a live batch.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_fleet.py
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
from keystone_tpu_torch.ops import gaussian_kernel as gk
from keystone_tpu_torch.serving import ServingFleet
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline

WAIT = 60.0
BUCKETS = (1, 8, 32)
LIMIT = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    PipelineEnv.get_or_create().reset()
    return torch.device("cuda")


def _k1_scores(cuda, seed=0, n_train=700, d=32, k=4, block=256):
    """A KRR scores chain: 700 rows in blocks of 256, 3 K1 launches a batch."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    train_X = torch.randn(n_train, d, device=cuda, generator=gen)
    W = torch.randn(n_train, k, device=cuda, generator=gen)
    head = KernelBlockLinearMapper(train_X, W, 0.05, block).to_pipeline()
    return FittedPipeline(head.graph, head.source, head.sink, datum_shape=(d,),
                          datum_dtype="float32")


def _eager(fitted, rows, cuda):
    return fitted.apply(torch.from_numpy(rows).to(cuda)).to_array().cpu().numpy()


@pytest.mark.cuda
def test_each_replica_captures_its_own_graphs_and_k1_counts_exactly(cuda):
    fitted = _k1_scores(cuda)
    rows = np.random.default_rng(1).standard_normal((400, 32)).astype(np.float32)
    want = _eager(fitted, rows, cuda)
    fleet = ServingFleet(fitted, replicas=4, buckets=BUCKETS)
    with fleet:
        streams = [r.stream for r in fleet.replicas]
        assert all(s is not None for s in streams) and len(set(streams)) == 4
        assert [r.device for r in fleet.replicas] == [torch.device("cuda", 0)] * 4
        assert fleet.metrics.count("compiles") == len(BUCKETS)
        assert fleet.captures == 4 * len(BUCKETS)
        start = gk.gaussian_kernel_block.launches
        batches0 = fleet.metrics.count("batches")
        with ThreadPoolExecutor(max_workers=16) as pool:
            got = np.stack(list(pool.map(lambda r: fleet.predict(r, timeout=WAIT), rows)))
        batches = fleet.metrics.count("batches") - batches0
        assert gk.gaussian_kernel_block.launches - start == 3 * batches
        assert fleet.metrics.count("compiles") == len(BUCKETS)  # none under traffic
        assert fleet.captures == 4 * len(BUCKETS)
        snap = fleet.metrics.snapshot()
    np.testing.assert_allclose(got, want, rtol=0, atol=LIMIT)
    assert all(row["batches"] >= 1 for row in snap["replicas"].values())
    assert len(snap["replicas"]) == 4


@pytest.mark.cuda
def test_a_swap_under_traffic_captures_beside_live_replays(cuda):
    """Four replicas serve four clients while the swap captures the
    candidate's graphs on each replica and a canary mirrors batches through
    them: no request fails, each answer is the old or the new model's, and
    after the swap every answer is the new model's."""
    old, new = _k1_scores(cuda), _k1_scores(cuda, seed=5)
    probe = np.random.default_rng(2).standard_normal((64, 32)).astype(np.float32)
    want_old, want_new = _eager(old, probe, cuda), _eager(new, probe, cuda)
    fleet = ServingFleet(old, replicas=4, buckets=BUCKETS)
    stop = threading.Event()
    answers, errors = [], []

    def hammer(k):
        i = k
        while not stop.is_set():
            try:
                answers.append((i % 64, fleet.predict(probe[i % 64], timeout=WAIT)))
            except Exception as e:
                errors.append(e)
            i += 4

    with fleet:
        threads = [threading.Thread(target=hammer, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        try:
            same = fleet.swap(_k1_scores(cuda), canary_fraction=0.25, canary_batches=8,
                              canary_timeout_s=60.0)
            report = fleet.swap(new)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=WAIT)
                assert not t.is_alive()
        after = np.stack([fleet.predict(r, timeout=WAIT) for r in probe])
        assert fleet.captures == 4 * len(BUCKETS)
    assert not errors
    assert same["canary"]["mismatches"] == 0 and same["canary"]["batches_compared"] >= 1
    assert report["version"] == 3 and report["compiles"] == len(BUCKETS)
    for i, a in answers:
        assert (np.abs(a - want_old[i]).max() <= LIMIT or np.abs(a - want_new[i]).max() <= LIMIT)
    np.testing.assert_allclose(after, want_new, rtol=0, atol=LIMIT)
    c = fleet.metrics.snapshot()["counters"]
    assert c["completed"] == c["submitted"] and c.get("batch_errors", 0) == 0
