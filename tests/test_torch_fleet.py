"""The replicated serving fleet on the port: the cases of the JAX package's
``tests/serving/test_fleet.py`` (answers across replicas, one program a
bucket shared by the replicas, typed ``QueueFull`` / ``Shed`` /
``EngineStopped``, the hammer with a swap mid-load, the canary's
mismatch, pass and latency gate) and the fleet half of
``tests/compile/test_manifest.py`` (pre-warm from the manifest) run on
``keystone_tpu_torch.serving.ServingFleet``; the answers held against the
JAX fleet's on the toy chain and against the JAX engine's on the small
RandomPatchCifarKernel chain carried from a JAX fit; replica placement;
``--serve-demo --replicas 2``; and the K1 launch count exact under many
threads.

On the CPU a replica runs its chain eagerly, one counted compile a new
signature over all replicas, so ``compiles`` equals the bucket count as on
the card, where each replica captures its own graph of each bucket
(``tests/test_torch_cuda_fleet.py``).

Every fleet is shut down in a ``finally`` or a ``with``, and every wait
has a timeout."""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from keystone_tpu.serving import ServingFleet as JServingFleet
from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
from keystone_tpu_torch import faults
from keystone_tpu_torch.check import ContractMismatchError
from keystone_tpu_torch.obs import flight
from keystone_tpu_torch.parallel.mesh import mesh_was_chosen
from keystone_tpu_torch.serving import (
    CanaryMismatch,
    EngineClosed,
    EngineStopped,
    QueueFull,
    ServingFleet,
    Shed,
)
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode
from tests.test_torch_serving import _jax_serve, _sure, cifar_fit  # noqa: F401 (fixture)

WAIT = 30.0


@pytest.fixture(autouse=True)
def port_env(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    env = PipelineEnv.get_or_create()
    env.reset()
    faults.clear()
    flight.reset()
    yield env
    faults.clear()
    flight.reset()
    env.reset()


def _double(X):
    return X * 2.0


def _linear_fitted(scale, label=None):
    return FunctionNode(batch_fn=lambda X, s=scale: X * s,
                        label=label or f"scale{scale}").to_pipeline().fit()


def _toy_fitted():
    return (FunctionNode(batch_fn=_double, label="double")
            >> FunctionNode(batch_fn=lambda X: X.sum(dim=1), label="rowsum")).fit()


def _first(x):
    return float(np.asarray(x).ravel()[0])


# ---------------------------------------------------------------------------
# lifecycle and routing
# ---------------------------------------------------------------------------


def _serve_rows(fleet, rows):
    with ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(lambda r: fleet.predict(r, timeout=WAIT), rows))


def test_fleet_serves_correct_results_across_replicas():
    rows = [np.full(3, float(i), np.float32) for i in range(48)]
    fleet = ServingFleet(_toy_fitted(), replicas=2, buckets=(4, 8), datum_shape=(3,),
                         max_wait_ms=1.0)
    with fleet:
        res = [_first(r) for r in _serve_rows(fleet, rows)]
    ref = JServingFleet((JFunctionNode(batch_fn=_double, label="double")
                         >> JFunctionNode(batch_fn=lambda X: X.sum(axis=1), label="rowsum")).fit(),
                        replicas=2, buckets=(4, 8), datum_shape=(3,), max_wait_ms=1.0)
    with ref:
        want = [_first(r) for r in _serve_rows(ref, rows)]
    assert res == want == [6.0 * i for i in range(48)]
    snap = fleet.metrics.snapshot()
    c = snap["counters"]
    assert c["completed"] == c["submitted"] == 48
    assert c.get("batch_errors", 0) == 0
    # both replicas ran batches, and the snapshot files occupancy by replica
    assert set(snap["replicas"]) == {"0", "1"}
    assert all(row["batches"] >= 1 for row in snap["replicas"].values())
    assert snap["queue_age"]["count"] == 48


def test_fleet_default_replica_count_is_one_per_device():
    """The toy chain's tensors live on the CPU, so the fleet places on the
    CPU: one replica, pinned there (the JAX fleet places one a device of
    its mesh)."""
    fleet = ServingFleet(_toy_fitted(), datum_shape=(3,))
    assert fleet.n_replicas == 1
    assert [r.device for r in fleet.replicas] == [torch.device("cpu")]
    assert [r.stream for r in fleet.replicas] == [None]  # streams are a card's
    four = ServingFleet(_toy_fitted(), replicas=4, datum_shape=(3,))
    assert [r.device for r in four.replicas] == [torch.device("cpu")] * 4
    assert not mesh_was_chosen()  # no chosen mesh: one replica on the chain's device
    assert fleet.published.chain_for("cpu").fitted is fleet.fitted and not fleet.published.copies


def test_replica_placement_over_the_visible_cards(monkeypatch):
    """``replica_devices`` and ``worker_device_indices`` over the visible
    CUDA devices (their count faked here) place as the JAX package's do
    over its 8-device test mesh; the CPU is used only when asked for."""
    from keystone_tpu.parallel import placement as jplacement
    from keystone_tpu_torch.parallel import placement

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        placement.replica_devices(2)
    assert placement.replica_devices(None, device="cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert placement.replica_devices(4) == [torch.device("cuda", 0)] * 4
    assert placement.replica_devices(None) == [torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    n_dev = len(jplacement.data_axis_devices())
    assert n_dev == 8
    for n in (None, 3, 8, 11):
        assert ([d.index for d in placement.replica_devices(n)]
                == [d.id for d in jplacement.replica_devices(n)])
    for workers in (1, 3, 8, 12):
        for w in range(workers):
            assert (placement.worker_device_indices(w, workers)
                    == jplacement.worker_device_indices(w, workers))
    with pytest.raises(ValueError):
        placement.worker_device_indices(3, 3)
    with pytest.raises(ValueError):
        placement.replica_devices(0)


def test_fleet_shares_one_executable_trace_across_replicas():
    """Each bucket is paid once however many replicas serve it."""
    fleet = ServingFleet(_toy_fitted(), replicas=4, buckets=(4, 8), datum_shape=(3,))
    fleet.start()
    try:
        assert fleet.metrics.count("compiles") == 2  # one a bucket, not × 4
        assert len(fleet.compiled_signatures) == 2
        assert fleet.captures == 0  # graphs are a card's; the CPU runs eagerly
    finally:
        fleet.shutdown()


def test_submit_after_shutdown_raises_typed_engine_stopped():
    fleet = ServingFleet(_toy_fitted(), replicas=2, datum_shape=(3,))
    fleet.start()
    fleet.shutdown()
    with pytest.raises(EngineStopped):
        fleet.submit(np.ones(3))
    with pytest.raises(EngineClosed):  # the EngineClosed it refines
        fleet.submit(np.ones(3))


def test_shutdown_without_start_answers_queued_and_is_idempotent():
    fleet = ServingFleet(_toy_fitted(), replicas=2, datum_shape=(3,))
    fut = fleet.submit(np.ones(3))
    fleet.shutdown()
    fleet.shutdown()
    with pytest.raises(EngineStopped):
        fut.result(timeout=5)


def test_queue_full_is_typed_and_counted():
    fleet = ServingFleet(_toy_fitted(), replicas=2, datum_shape=(3,), max_queue=4)
    for _ in range(4):
        fleet.submit(np.ones(3))
    with pytest.raises(QueueFull):
        fleet.submit(np.ones(3))
    assert fleet.metrics.count("rejected") == 1
    fleet.start()  # the four queued still drain
    fleet.shutdown(drain=True)
    assert fleet.metrics.count("completed") == 4


# ---------------------------------------------------------------------------
# deadline shedding at admission
# ---------------------------------------------------------------------------


def test_deadline_shed_is_deterministic_given_service_evidence():
    fleet = ServingFleet(_toy_fitted(), replicas=1, buckets=(4,), datum_shape=(3,))
    fleet.scheduler.observe_service(0.5)  # every batch "takes" 500 ms
    fleet.start()
    try:
        for _ in range(10):
            with pytest.raises(Shed):
                fleet.submit(np.ones(3), timeout=0.05)  # below the service floor
        assert fleet.metrics.count("shed") == 10
        for _ in range(5):  # a meetable deadline is never shed on an empty fleet
            assert abs(_first(fleet.predict(np.ones(3), timeout=WAIT)) - 6.0) < 1e-4
        assert fleet.metrics.count("shed") == 10
    finally:
        fleet.shutdown()
    assert fleet.metrics.snapshot()["counters"]["completed"] == 5


def test_cold_scheduler_never_sheds():
    fleet = ServingFleet(_toy_fitted(), replicas=1, buckets=(4,), datum_shape=(3,))
    assert fleet.scheduler.service_estimate is None
    assert fleet.scheduler.estimated_wait() == 0.0
    fleet.start()
    try:
        assert abs(_first(fleet.predict(np.ones(3), timeout=0.5)) - 6.0) < 1e-4
    finally:
        fleet.shutdown()
    assert fleet.metrics.count("shed") == 0


# ---------------------------------------------------------------------------
# the hammer: concurrent submitters and a fleet-wide swap mid-load
# ---------------------------------------------------------------------------


def test_fleet_hammer_with_mid_load_swap_zero_dropped_or_failed():
    fleet = ServingFleet(_linear_fitted(2.0), replicas=2, buckets=(4,), datum_shape=(2,),
                         max_wait_ms=1.0)
    with fleet:
        stop = threading.Event()
        results = []

        def hammer():
            while not stop.is_set():
                results.append(_first(fleet.predict(np.ones(2), timeout=WAIT)))

        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = [pool.submit(hammer) for _ in range(4)]
            time.sleep(0.2)
            report = fleet.swap(_linear_fitted(3.0))
            assert report["replicas_flipped"] == 2 and report["buckets_warmed"] == 1
            assert report["version"] == 2
            post = _first(fleet.predict(np.ones(2), timeout=WAIT))
            time.sleep(0.2)
            stop.set()
            for f in futs:
                f.result(timeout=WAIT)
        assert post == 3.0
        snap = fleet.metrics.snapshot()
    c = snap["counters"]
    assert c["completed"] == c["submitted"]
    assert c.get("rejected", 0) == 0 and c.get("batch_errors", 0) == 0
    assert c["swaps"] == 1 and c["compiles"] == 2  # one bucket, two versions
    assert set(results) <= {2.0, 3.0}
    assert 2.0 in results and 3.0 in results


def test_swap_rejects_contract_mismatch_and_closed_fleet():
    fleet = ServingFleet(_toy_fitted(), replicas=2, datum_shape=(2,))
    wrong = _linear_fitted(1.0, label="id3")
    wrong.datum_shape = (3,)
    with pytest.raises(ContractMismatchError, match="does not match"):
        fleet.swap(wrong)
    fleet.start()
    fleet.shutdown()
    with pytest.raises(EngineStopped):
        fleet.swap(_linear_fitted(3.0))


# ---------------------------------------------------------------------------
# the canary: shadow comparison, then promotion or rollback
# ---------------------------------------------------------------------------


def _with_traffic(fleet, fn):
    """``fn()`` while three threads keep the fleet busy."""
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            fleet.predict(np.ones(2), timeout=WAIT)

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.1)
        return fn()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()


def test_canary_mismatch_auto_rolls_back(tmp_path):
    fleet = ServingFleet(_linear_fitted(2.0), replicas=2, buckets=(4,), datum_shape=(2,),
                         max_wait_ms=1.0)
    with fleet:
        def do_swap():
            with pytest.raises(CanaryMismatch) as exc:
                fleet.swap(_linear_fitted(5.0, label="bad"), canary_fraction=1.0,
                           canary_batches=2, canary_timeout_s=20.0)
            return exc.value

        err = _with_traffic(fleet, do_swap)
        assert err.report["mismatches"] >= 1 and err.report["batches_compared"] >= 1
        assert err.report["mismatch_details"][0]["max_abs_diff"] > 1.0
        # nothing was promoted: the fleet serves the old model
        assert _first(fleet.predict(np.ones(2), timeout=WAIT)) == 2.0
        assert fleet.metrics.count("swaps") == 0
        assert fleet.metrics.count("canary_fail") == 1
        assert fleet.metrics.count("canary_pass") == 0
        assert fleet.model_version == 1
    names = [e["name"] for e in flight.recorder().entries()]
    assert "serve.canary_rollback" in names
    dumps = list(tmp_path.glob("keystone-flight-*canary_rollback*.json"))
    assert dumps


def test_canary_pass_promotes_with_verdict():
    fleet = ServingFleet(_linear_fitted(2.0), replicas=2, buckets=(4,), datum_shape=(2,),
                         max_wait_ms=1.0)
    with fleet:
        report = _with_traffic(fleet, lambda: fleet.swap(
            _linear_fitted(2.0, label="equivalent"), canary_fraction=1.0, canary_batches=2,
            canary_timeout_s=20.0))
        assert report["canary"]["mismatches"] == 0
        assert report["canary"]["batches_compared"] >= 2
        assert fleet.metrics.count("canary_pass") == 1
        assert fleet.metrics.count("swaps") == 1
        assert report["canary"]["latency_ratio"] is not None


def _slow_double(X):
    time.sleep(0.05)
    return X * 2.0


def test_canary_latency_gate_rolls_back_a_slow_candidate():
    """Equal outputs but a latency ratio above the gate still roll back."""
    fleet = ServingFleet(_linear_fitted(2.0), replicas=2, buckets=(4,), datum_shape=(2,),
                         max_wait_ms=1.0)
    slow = FunctionNode(batch_fn=_slow_double, label="slow").to_pipeline().fit()
    with fleet:
        def do_swap():
            with pytest.raises(CanaryMismatch, match="latency"):
                fleet.swap(slow, canary_fraction=1.0, canary_batches=3, canary_timeout_s=20.0,
                           max_latency_ratio=3.0)

        _with_traffic(fleet, do_swap)
        assert fleet.metrics.count("swaps") == 0
        assert _first(fleet.predict(np.ones(2), timeout=WAIT)) == 2.0


# ---------------------------------------------------------------------------
# the manifest's pre-warm (tests/compile/test_manifest.py, the fleet half)
# ---------------------------------------------------------------------------


def test_engine_export_records_manifest_and_fleet_prewarms_it(tmp_path):
    """An engine exports its buckets (the manifest records them); a fleet
    configured with fewer buckets still warms every manifest signature at
    start, all loaded from the cache, zero traces: as the JAX package's."""
    from keystone_tpu_torch import compile as compile_mod
    from keystone_tpu_torch.serving import ServingEngine

    try:
        compile_mod.configure(str(tmp_path / "aot"))
        fitted = FunctionNode(batch_fn=_double, label="double").to_pipeline().fit()
        engine = ServingEngine(fitted, buckets=(2, 4), datum_shape=(3,))
        engine.start()
        engine.shutdown()
        assert engine.metrics.count("compiles") == 2
        sigs = compile_mod.exported_signatures(compile_mod.get_cache(), fitted.fingerprint())
        assert ((2, 3), "float32") in sigs and ((4, 3), "float32") in sigs

        fleet = ServingFleet(FunctionNode(batch_fn=_double, label="double").to_pipeline().fit(),
                             replicas=2, buckets=(2,), datum_shape=(3,))
        assert fleet.warm_up() == 2  # the bucket and the manifest's (4, 3)
        assert fleet.metrics.count("compiles") == 0
        assert fleet.metrics.count("aot_loads") == 2  # once a program, not × 2 replicas
        fleet.start(warmup=False)
        out = fleet.predict(np.ones(3, np.float32), timeout=WAIT)
        np.testing.assert_allclose(np.asarray(out), 2 * np.ones(3), rtol=1e-6)
        fleet.shutdown()
        assert fleet.metrics.count("compiles") == 0
        assert fleet.version_report()["digest"] == fitted.fingerprint()
    finally:
        compile_mod.reset()


def test_manifest_filters_foreign_contracts(tmp_path):
    from keystone_tpu_torch import compile as compile_mod
    from keystone_tpu_torch.compile.manifest import record_export

    try:
        compile_mod.configure(str(tmp_path / "aot"))
        fitted = FunctionNode(batch_fn=_double, label="double").to_pipeline().fit()
        fleet = ServingFleet(fitted, replicas=1, buckets=(2,), datum_shape=(3,))
        cache = compile_mod.get_cache()
        digest = fitted.fingerprint()
        record_export(cache, digest, (8, 7), "float32")  # another item shape
        record_export(cache, digest, (8, 3), "float64")  # another dtype
        assert fleet._manifest_signatures() == []
    finally:
        compile_mod.reset()


# ---------------------------------------------------------------------------
# the CIFAR kernel chain from a 2-replica fleet, against the JAX engine
# ---------------------------------------------------------------------------


def test_krr_fleet_scores_match_the_jax_engine(cifar_fit):  # noqa: F811
    """The RandomPatchCifarKernel scores chain (K1's plain version here)
    carried from a JAX fit and served by two replicas: every row within
    1e-4 of the JAX engine's scores (the serving tolerance of
    ``test_torch_serving.py``), argmax equal where JAX is sure, one compile
    a bucket, and both replicas busy."""
    rows = cifar_fit.X.numpy()
    buckets = (1, 8, 32)
    want, j_compiles = _jax_serve(cifar_fit.j_scores, rows, buckets, (32, 32, 3))
    fleet = ServingFleet(cifar_fit.scores, replicas=2, buckets=buckets,
                         datum_shape=(32, 32, 3))
    with fleet:
        with ThreadPoolExecutor(max_workers=8) as pool:
            got = np.stack([np.asarray(r) for r in pool.map(
                lambda row: fleet.predict(row, timeout=WAIT), rows)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    sure = _sure(want)
    np.testing.assert_array_equal(got.argmax(1)[sure], want.argmax(1)[sure])
    snap = fleet.metrics.snapshot()
    assert fleet.metrics.count("compiles") == j_compiles == len(buckets)
    assert snap["counters"]["completed"] == len(rows)
    assert all(row["batches"] >= 1 for row in snap["replicas"].values())


# ---------------------------------------------------------------------------
# --serve-demo --replicas 2
# ---------------------------------------------------------------------------


def test_serve_demo_with_replicas_serves_from_a_fleet(capsys):
    from keystone_tpu_torch.__main__ import main

    assert main(["--serve-demo", "--device", "cpu", "--nTrain", "512", "--numFFTs", "2",
                 "--blockSize", "256", "--buckets", "8", "--requests", "32",
                 "--replicas", "2"]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("SERVE ok="))
    assert "SERVE ok=32/32" in line and "compiles=1" in line and "replicas=2" in line
    assert "shed=0" in line and "per_replica_batches={'0': " in line
    assert "SERVE PASS" in out


def test_serve_demo_still_refuses_workers(monkeypatch):
    """``--workers 2 --replicas 2`` takes the cluster path, whose workers
    each run a fleet of 2 replicas. The name is the one this test had while
    ``--workers`` refused, kept so that runs before and after the cluster
    tier line up; it refuses no more (the run through worker processes is
    ``tests/test_torch_cluster_router.py``)."""
    from keystone_tpu_torch.serving import demo

    seen = {}

    def through_cluster(args, fitted, data, buckets, dev):
        seen.update(workers=args.workers, replicas=args.replicas)
        return 0

    monkeypatch.setattr(demo, "_serve_through_cluster", through_cluster)
    assert demo.main(["--device", "cpu", "--workers", "2", "--replicas", "2"]) == 0
    assert seen == {"workers": 2, "replicas": 2}


# ---------------------------------------------------------------------------
# K1's launch count under many threads
# ---------------------------------------------------------------------------


def _opcode_tracer(frame, event, arg):
    # a trace call between every two opcodes: the interpreter may switch
    # threads there, so an unguarded read-add-write of the counter loses
    # updates (without it a switch falls only at calls and loop edges)
    frame.f_trace_opcodes = True
    return _opcode_tracer


def _hammer_threads(target, args_list):
    prior = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threading.settrace(_opcode_tracer)
    try:
        threads = [threading.Thread(target=target, args=args) for args in args_list]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        threading.settrace(None)
        sys.setswitchinterval(prior)


def test_k1_launch_count_is_exact_from_eight_threads():
    from keystone_tpu_torch.ops import gaussian_kernel as gk

    before = gk.gaussian_kernel_block.launches

    def add():
        for _ in range(2000):
            gk.count_launches(1)

    try:
        _hammer_threads(add, [()] * 8)
        assert gk.gaussian_kernel_block.launches - before == 8 * 2000
    finally:
        gk.gaussian_kernel_block.launches = before


class _StubGraph:
    def replay(self):
        pass


def test_replays_of_eight_lanes_count_k1_exactly():
    """Eight graph caches, as eight replicas hold, each with one stub graph
    that records 10 K1 launches, replayed from eight threads at once: the
    counter gains exactly 10 a replay."""
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.workflow.cuda_graph import GraphCache, _Captured, signature

    x = torch.zeros(4, 3)
    caches = []
    for _ in range(8):
        cache = GraphCache(lambda t: t)
        cache._graphs[signature((x,))] = _Captured(_StubGraph(), (torch.zeros(4, 3),),
                                                   torch.zeros(4, 3), kernel_launches=10)
        caches.append(cache)
    before = gk.gaussian_kernel_block.launches

    def replay(cache):
        for _ in range(200):
            cache(x)

    try:
        _hammer_threads(replay, [(c,) for c in caches])
        assert gk.gaussian_kernel_block.launches - before == 8 * 200 * 10
    finally:
        gk.gaussian_kernel_block.launches = before
