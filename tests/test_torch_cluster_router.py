"""The cluster router on the port with real worker processes: the cases
a–e of the JAX package's ``tests/cluster/test_router.py`` on
``keystone_tpu_torch.cluster.ClusterRouter`` with the stall model at
d = 32 on ``device="cpu"``, the answers held against a local apply of the
JAX package's ``build_stall_model`` (tolerance 1e-6; both draw the weights
from ``RandomState(seed)``): predict parity and load spread, the deadline
across the hop, shed determinism with a seeded estimate, a worker killed
mid-load with 0 admitted failures (respawned under a new shm generation,
the ``worker_down`` flight dump written), and a bounded shutdown with a
wedged worker. Also: the stall survives serving (the capture trap: a
host step is served eagerly, every batch stalls); the port's device-fault
choice in a worker (the faulted request fails with the fault's class, the
worker exits 3 and is respawned, nothing loops); a worker given
``virtual_devices`` serving one replica on each, as the JAX worker places
them; a worker that cannot reach a card fails the boot; and
``--serve-demo --workers 2 --device cpu``.

One module-scoped 2-worker router serves cases a–e, which run in
definition order, as in the JAX test (tier 1 runs without random
ordering)."""

import glob
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from pathlib import Path

import numpy as np
import pytest

from keystone_tpu_torch.cluster import ClusterRouter, WorkerError
from keystone_tpu_torch.serving.errors import DeadlineExceeded, EngineStopped, ServingError, Shed

ROOT = Path(__file__).resolve().parent.parent
D = 32
STALL_S = 0.002
LIMIT = 1e-6


@pytest.fixture(scope="module")
def flight_dir(tmp_path_factory):
    # the router's and the workers' flight dumps (workers inherit the env)
    path = tmp_path_factory.mktemp("flight")
    old = os.environ.get("KEYSTONE_FLIGHT_DIR")
    os.environ["KEYSTONE_FLIGHT_DIR"] = str(path)
    yield path
    if old is None:
        os.environ.pop("KEYSTONE_FLIGHT_DIR", None)
    else:
        os.environ["KEYSTONE_FLIGHT_DIR"] = old


@pytest.fixture(scope="module")
def router(flight_dir):
    r = ClusterRouter(
        ("factory", "keystone_tpu_torch.cluster.demo:build_stall_model",
         {"d": D, "stall_s": STALL_S}),
        workers=2, device="cpu", replicas_per_worker=1, buckets=(8,), datum_shape=(D,),
        max_wait_ms=1.0, spawn_timeout_s=180,
        # pongs must not warm the router's estimate behind the tests' backs
        health_interval_s=3600.0,
        drain_timeout_s=3.0, join_timeout_s=2.0, max_restarts=2)
    r.start()
    yield r
    r.shutdown(drain=False)


@pytest.fixture(scope="module")
def data():
    return np.random.RandomState(0).randn(32, D).astype(np.float32)


@pytest.fixture(scope="module")
def expected(data):
    from keystone_tpu.cluster.demo import build_stall_model

    return np.asarray(build_stall_model(d=D, stall_s=0.0).apply(data).to_array())


def test_a_predict_parity_and_load_spread(router, data, expected):
    n = 64
    with ThreadPoolExecutor(max_workers=16) as pool:
        outs = list(pool.map(lambda i: router.predict(data[i % len(data)]), range(n)))
    for i, out in enumerate(outs):
        np.testing.assert_allclose(np.asarray(out), expected[i % len(data)], atol=LIMIT, rtol=0)
    snap = router.snapshot()
    c = snap["counters"]
    assert c["submitted"] == c["completed"] == n
    workers_with_batches = {key.split("/")[0] for key, row in snap["replicas"].items()
                            if row.get("batches")}
    assert len(workers_with_batches) == 2, snap["replicas"]
    assert snap["latency"]["count"] >= n
    reports = router.worker_reports
    assert [r["devices"] for r in reports] == [["cpu"], ["cpu"]]
    assert all(r["shm"] for r in reports)


def test_b_deadline_crosses_the_process_boundary(router, data):
    # a cold router cannot shed: the expired budget is enforced worker-side
    assert router.service_estimate is None
    with pytest.raises((Shed, DeadlineExceeded)):
        router.predict(data[0], timeout=1e-9)
    out = router.predict(data[0], timeout=30.0)
    assert np.asarray(out).shape == (16,)


def test_c_shed_determinism_with_seeded_estimate(router, data):
    router.observe_service(10.0)
    before_shed = router.metrics.count("shed")
    before_submitted = router.metrics.count("submitted")
    for _ in range(10):
        with pytest.raises(Shed):
            router.submit(data[0], timeout=0.1)
    assert router.metrics.count("shed") == before_shed + 10
    assert router.metrics.count("submitted") == before_submitted
    assert router.predict(data[0]) is not None


def test_c2_the_stall_survives_serving(router, data):
    """The capture trap: a sleep in a captured ``forward`` would sleep once,
    at capture. The stall is a host step (``.cpu()``, the checker's
    ``host_callback``), so the worker serves its chain eagerly and every
    batch stalls."""
    from keystone_tpu_torch.cluster.demo import build_stall_model
    from keystone_tpu_torch.serving.metrics import MetricsRegistry
    from keystone_tpu_torch.serving.replica import compile_pipeline

    local = build_stall_model(d=D, stall_s=STALL_S, device="cpu")
    report = local.check(span=False)
    assert report.untraceable_labels() == ["stall_matmul"]
    assert set(report.verdicts.values()) == {"host_callback"}
    assert compile_pipeline(local, metrics=MetricsRegistry(), signatures=[]).eager
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda i: router.predict(data[i % len(data)]), range(24)))
    for snap in router.worker_snapshots(timeout=10.0):
        batch = snap["phases"]["serve.batch"]
        assert batch["calls"] >= 1
        assert batch["seconds"] / batch["calls"] >= STALL_S, (snap["name"], batch)


def test_d_worker_kill_mid_load_zero_admitted_failures(router, data, expected, flight_dir):
    gens = [s.shm_gen for s in router._slots]
    victim_pid = router.worker_pids[0]
    stop = [False]
    failures = []
    served = [0]

    def hammer(tid):
        while not stop[0]:
            i = served[0] % len(data)
            try:
                out = router.predict(data[i])
                np.testing.assert_allclose(np.asarray(out), expected[i], atol=LIMIT, rtol=0)
                served[0] += 1
            except Exception as e:  # the assertion below
                failures.append(e)

    threads = ThreadPoolExecutor(max_workers=6)
    futs = [threads.submit(hammer, t) for t in range(6)]
    time.sleep(0.4)
    os.kill(victim_pid, signal.SIGKILL)
    time.sleep(1.0)
    stop[0] = True
    for f in futs:
        f.result(timeout=60)
    threads.shutdown(wait=True)
    assert not failures, f"admitted requests failed: {failures[:3]}"
    assert served[0] > 0
    assert router.metrics.count("restarts") >= 1
    deadline = time.monotonic() + 120
    while router.live_workers < 2 and time.monotonic() < deadline:
        time.sleep(0.25)
    assert router.live_workers == 2, "killed worker was not respawned"
    assert router.worker_pids[0] != victim_pid
    # the respawn got fresh rings under the next generation's name
    assert router._slots[0].shm_gen == gens[0] + 1
    assert router.worker_reports[0]["shm"]
    assert glob.glob(str(flight_dir / "*worker_down*"))
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda i: router.predict(data[i % 8]), range(24)))


def test_e_bounded_shutdown_with_wedged_worker(router, data):
    victim_pid = router.worker_pids[0]
    os.kill(victim_pid, signal.SIGSTOP)
    try:
        futs = [router.submit(data[i % 8]) for i in range(8)]
        t0 = time.monotonic()
        router.shutdown(drain=True)
        elapsed = time.monotonic() - t0
        assert elapsed < 30.0, f"shutdown took {elapsed:.1f}s"
        for f in futs:
            try:
                f.result(timeout=5.0)
            except FutureTimeout:
                raise AssertionError("shutdown left an admitted request unanswered")
            except (ServingError, ConnectionError):
                pass
        with pytest.raises(EngineStopped):
            router.submit(data[0])
    finally:
        try:
            os.kill(victim_pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def test_f_a_device_fault_fails_its_request_and_respawns_the_worker(flight_dir, tmp_path):
    """The port's choice: the request whose batch met a device fault fails
    with the fault (not requeued: the same model would meet it again); the
    worker exits 3 and is respawned with a fresh context, within the
    budget. The model is shipped as bytes (the router's pickle path)."""
    from tests.torch_cluster_models import faulting_model

    trigger = tmp_path / "fault-now"
    x = np.arange(4, dtype=np.float32)
    r = ClusterRouter(faulting_model(str(trigger)), workers=1, device="cpu", buckets=(4,),
                      datum_shape=(4,), max_wait_ms=1.0, health_interval_s=3600.0,
                      drain_timeout_s=3.0, join_timeout_s=2.0, max_restarts=1)
    with r:
        np.testing.assert_allclose(r.predict(x, timeout=30.0), 2 * x)
        old = r._slots[0].proc
        trigger.touch()
        with pytest.raises(WorkerError) as err:
            r.predict(x, timeout=30.0)
        assert err.value.kind == "OutOfMemoryError"
        assert old.wait(timeout=60) == 3
        deadline = time.monotonic() + 120
        while r.live_workers < 1 and time.monotonic() < deadline:
            time.sleep(0.25)
        assert r.worker_pids[0] != old.pid and r.metrics.count("restarts") == 1
        np.testing.assert_allclose(r.predict(x, timeout=30.0), 2 * x)
        c = r.metrics.snapshot()["counters"]
        assert c["worker_errors"] == 1 and c.get("requeues", 0) == 0
    assert not trigger.exists()


def test_g_a_worker_given_virtual_devices_serves_over_its_slots(flight_dir, data, expected):
    """``virtual_devices=4``: the worker provisions 4 virtual devices (slots
    of the CPU) before its fleet starts and serves one replica on each, as
    the JAX worker places its replicas over its 4 virtual devices."""
    from keystone_tpu.cluster import worker as jworker
    from keystone_tpu.parallel import mesh as jmesh

    with jmesh.use_mesh(jmesh.make_mesh(n_data=4)):
        want = len(jworker._worker_devices(0, 1, None))
    r = ClusterRouter(("factory", "keystone_tpu_torch.cluster.demo:build_stall_model",
                       {"d": D, "stall_s": STALL_S}),
                      workers=1, device="cpu", virtual_devices=4, buckets=(8,), datum_shape=(D,),
                      max_wait_ms=1.0, spawn_timeout_s=180, health_interval_s=3600.0,
                      drain_timeout_s=3.0, join_timeout_s=2.0)
    r.start()
    try:
        ready = r._slots[0].ready_report
        assert ready["replicas"] == want == 4
        assert ready["devices"] == ["cpu"] * 4
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda x: r.predict(x, timeout=30.0), data[:16]))
        np.testing.assert_allclose(np.stack(got), expected[:16], atol=LIMIT)
    finally:
        r.shutdown(drain=False)


def test_h_a_worker_without_a_card_fails_the_boot(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    r = ClusterRouter(("factory", "keystone_tpu_torch.cluster.demo:build_stall_model",
                       {"d": D}), workers=1, buckets=(8,), datum_shape=(D,),
                      spawn_timeout_s=120, join_timeout_s=2.0)
    with pytest.raises(RuntimeError, match="failed to boot"):
        r.start()


def test_i_serve_demo_through_two_worker_processes():
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "--serve-demo", "--device", "cpu",
         "--workers", "2", "--requests", "32", "--status"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "SERVE ok=32/32" in proc.stdout and "workers=2" in proc.stdout
    assert "SERVE PASS" in proc.stdout.splitlines()[-1]
    assert "timeline [worker-0]" in proc.stdout
