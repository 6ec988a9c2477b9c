"""The model on two physical devices, the card and the host: the card twins
of ``tests/test_torch_fleet_devices.py`` and of the laned scan over two
devices in ``tests/test_torch_lanes.py``.

A fleet over ``cuda:0`` and the CPU serves a KRR chain fitted on the card
from the chain itself on the card and a copy on the host: answers equal to
the eager apply on the card, K1 launched only by the card replica, the
copy holding no CUDA tensor and allocating nothing on the card; a canaried
swap promotes on both devices or rolls back on both; an AOT cache exports
once a backend and loads each program onto its own device; the trainer's
promotion reaches both copies; a laned fit over the two devices runs each
lane's featurizer on its own device.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_fleet_devices.py
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from keystone_tpu_torch import compile as cmod
from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
from keystone_tpu_torch.ops import gaussian_kernel as gk
from keystone_tpu_torch.parallel.placement import tensors_of
from keystone_tpu_torch.serving import CanaryMismatch, ServingFleet
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline

WAIT = 60.0
BUCKETS = (1, 8, 32)
LIMIT = 1e-5
CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    PipelineEnv.get_or_create().reset()
    yield torch.device("cuda", 0)
    cmod.reset()


def _k1_scores(cuda, seed=0, n_train=700, d=32, k=4, block=256, scale=1.0):
    """A KRR scores chain: 700 rows in blocks of 256, 3 K1 launches a batch."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    train_X = torch.randn(n_train, d, device=cuda, generator=gen)
    W = torch.randn(n_train, k, device=cuda, generator=gen) * scale
    head = KernelBlockLinearMapper(train_X, W, 0.05, block).to_pipeline()
    return FittedPipeline(head.graph, head.source, head.sink, datum_shape=(d,),
                          datum_dtype="float32")


def _rows(n=300, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 32)).astype(np.float32)


def _eager(fitted, rows, cuda):
    return fitted.apply(torch.from_numpy(rows).to(cuda)).to_array().cpu().numpy()


def _serve(fleet, rows):
    with ThreadPoolExecutor(max_workers=8) as pool:
        return np.stack(list(pool.map(lambda r: fleet.predict(r, timeout=WAIT), rows)))


@pytest.mark.cuda
def test_a_fleet_on_the_card_and_the_host_serves_one_copy_a_device(cuda):
    fitted = _k1_scores(cuda)
    rows = _rows()
    want = _eager(fitted, rows, cuda)
    card_tensors = {id(t) for t in tensors_of(fitted)}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fleet = ServingFleet(fitted, devices=["cuda:0", "cpu"], buckets=BUCKETS)
    assert torch.cuda.memory_allocated() == before  # the host copy allocates nothing here
    published = fleet.published
    host = published.chain_for(CPU).fitted
    assert published.copies == 1 and published.chain_for(cuda).fitted is fitted
    assert {id(t) for t in tensors_of(fitted)} == card_tensors
    assert all(t.device == CPU for t in tensors_of(host))
    host._fingerprint = None
    assert host.fingerprint() == fitted.fingerprint()
    with fleet:
        assert fleet.metrics.count("compiles") == len(BUCKETS)
        start = gk.gaussian_kernel_block.launches
        batches0 = {k: v["batches"] for k, v in fleet.metrics.snapshot()["replicas"].items()}
        got = _serve(fleet, rows)
        snap = fleet.metrics.snapshot()
    batches = {k: v["batches"] - batches0.get(k, 0) for k, v in snap["replicas"].items()}
    np.testing.assert_allclose(got, want, rtol=0, atol=LIMIT)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert batches["0"] >= 1 and batches["1"] >= 1
    assert gk.gaussian_kernel_block.launches - start == 3 * batches["0"]
    assert fleet.captures == len(BUCKETS)  # the card replica's; the host runs eagerly


@pytest.mark.cuda
def test_a_canaried_swap_promotes_or_rolls_back_on_both_devices(cuda):
    fitted = _k1_scores(cuda)
    probe = _rows(64, 2)
    fleet = ServingFleet(fitted, devices=["cuda:0", "cpu"], buckets=BUCKETS)
    stop = threading.Event()
    errors = []

    def hammer(k):
        i = k
        while not stop.is_set():
            try:
                fleet.predict(probe[i % 64], timeout=WAIT)
            except Exception as e:
                errors.append(e)
            i += 4

    with fleet:
        threads = [threading.Thread(target=hammer, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        try:
            same = fleet.swap(_k1_scores(cuda), canary_fraction=1.0, canary_batches=8,
                              canary_timeout_s=60.0)
            with pytest.raises(CanaryMismatch) as bad:
                fleet.swap(_k1_scores(cuda, scale=1.01), canary_fraction=1.0,
                           canary_batches=8, canary_timeout_s=60.0)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=WAIT)
                assert not t.is_alive()
        replicas = {d["replica"] for d in bad.value.report["mismatch_details"]}
        published = fleet.published
    assert not errors
    assert same["version"] == 2 and same["canary"]["mismatches"] == 0
    assert fleet.model_version == 2 and replicas
    assert [r.compiled for r in fleet.replicas] == [published.chain_for(cuda),
                                                    published.chain_for(CPU)]
    assert all(t.device == CPU for t in tensors_of(published.chain_for(CPU).fitted))


@pytest.mark.cuda
def test_aot_exports_once_a_backend_and_loads_onto_each_device(cuda, tmp_path):
    cmod.configure(str(tmp_path))
    fitted = _k1_scores(cuda)
    probes = {}
    for boot in ("cold", "warm"):
        fleet = ServingFleet(fitted, devices=["cuda:0", "cpu"], buckets=BUCKETS)
        fleet.warm_up()
        chains = fleet.published.chains
        probes[boot] = {(str(d), b): c(fleet.policy.pad(_rows(b, 3), b))[:b]
                        for d, c in chains.items() for b in BUCKETS}
        exported = sum(c.dispatcher.traced_count for c in chains.values())
        loaded = sum(c.dispatcher.loaded_count for c in chains.values())
        assert fleet.metrics.count("compiles") == (len(BUCKETS) if boot == "cold" else 0)
        assert (exported, loaded) == ((2 * len(BUCKETS), 0) if boot == "cold"
                                      else (0, 2 * len(BUCKETS)))
        for d, c in chains.items():
            for program in c.dispatcher._by_sig.values():
                held = [t for t in vars(program).values() if isinstance(t, torch.Tensor)]
                assert held and all(t.device.type == d.type for t in held)
        fleet.shutdown()
    for key, cold in probes["cold"].items():
        assert np.array_equal(cold, probes["warm"][key]), key


@pytest.mark.cuda
def test_the_trainers_promotion_reaches_the_card_and_the_host(cuda):
    from keystone_tpu_torch.data.chunked import ChunkedDataset
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.trainer import ChunkLog, TrainerDaemon
    from keystone_tpu_torch.workflow.transformer import FunctionNode

    rng = np.random.RandomState(0)
    w = rng.randn(12, 3).astype(np.float32)

    def chunk(n, seed):
        r = np.random.RandomState(seed)
        X = (r.randn(n, 12) + 1.0).astype(np.float32)
        return X, (np.tanh(X) @ w + 0.05 * r.randn(n, 3)).astype(np.float32)

    X0, Y0 = chunk(384, 0)
    fitted = (FunctionNode(batch_fn=torch.tanh, label="feat").to_pipeline()
              .and_then(LinearMapEstimator(lam=1e-2, snapshot=True),
                        ChunkedDataset.from_array(torch.from_numpy(X0).to(cuda), 64),
                        Dataset.of(torch.from_numpy(Y0).to(cuda))).fit())
    fleet = ServingFleet(fitted, devices=["cuda:0", "cpu"], buckets=(8,), datum_shape=(12,),
                         max_wait_ms=1.0)
    log = ChunkLog()
    stop = threading.Event()

    def traffic():
        i = 0
        while not stop.is_set():
            fleet.predict(X0[i % 384], timeout=WAIT)
            i += 1

    with fleet:
        worker = threading.Thread(target=traffic)
        worker.start()
        try:
            with TrainerDaemon(fleet, log, poll_interval_s=0.01, refit_interval_s=0.05,
                               min_refit_chunks=2, canary_fraction=1.0, canary_batches=1,
                               canary_timeout_s=10.0, canary_atol=0.5, canary_rtol=0.5,
                               max_batch_retries=0) as daemon:
                for seed in (1, 2):
                    log.append(*chunk(64, seed))
                deadline = 60.0
                while fleet.metrics.count("refits") < 1 and deadline > 0:
                    stop.wait(0.05)
                    deadline -= 0.05
                promoted = daemon.fitted
        finally:
            stop.set()
            worker.join(timeout=WAIT)
        published = fleet.published
    assert fleet.model_version == 2 and published.fitted is promoted
    assert fleet.replicas[0].compiled.fitted is promoted
    host = fleet.replicas[1].compiled
    assert host is published.chain_for(CPU) and host.fitted is not promoted
    assert all(t.device == CPU for t in tensors_of(host.fitted))


@pytest.mark.cuda
def test_a_laned_fit_over_the_card_and_the_host_runs_each_lanes_steps_there(cuda):
    from keystone_tpu_torch.data.chunked import ChunkedDataset
    from keystone_tpu_torch.linalg import normal_equations
    from keystone_tpu_torch.obs import SCAN_SPAN, Tracer, install
    from keystone_tpu_torch.obs import tracer as trace_mod
    from keystone_tpu_torch.parallel import make_mesh, use_mesh

    d, k, rows, n_chunks = 64, 3, 512, 6
    gen = torch.Generator(device=cuda).manual_seed(3)
    P = torch.randn(d, d, device=cuda, generator=gen) / d ** 0.5
    w = torch.randn(d, k, device=cuda, generator=gen)

    def pair(i):
        g = torch.Generator(device=cuda).manual_seed(100 + i)
        A = torch.randn(rows, d, device=cuda, generator=g)
        return A, A @ w

    def featurize(t):
        # P is on the card; the host lane runs a copy of this step whose P
        # is on the host
        A, y = t
        return torch.cos(A @ P), y

    pairs = ChunkedDataset.from_chunk_fn(pair, n_chunks, rows * n_chunks).map_batch(featurize)
    one = normal_equations.solve_least_squares_streaming(pairs.raw_chunks(), reg=1e-3,
                                                         device=cuda, lanes=1)
    tracer = install(Tracer())
    try:
        with use_mesh(make_mesh(devices=["cuda:0", "cpu"])):
            two = normal_equations.solve_least_squares_streaming(pairs.raw_chunks(), reg=1e-3,
                                                                 lanes=2)
    finally:
        trace_mod.reset()
    (span,) = [sp.attrs for sp in tracer.spans() if sp.name == SCAN_SPAN]
    assert span["step_devices"] == ["cuda:0", "cpu"]
    assert 0 < span["collectives"] <= 2 * 2 + 2 * 1
    assert ((two.to(one.device) - one).abs().max() / one.abs().max()).item() <= 1e-5
    assert P.device == cuda
