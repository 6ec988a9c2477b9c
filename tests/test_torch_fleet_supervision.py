"""Replica supervision on the port: the cases of the JAX package's
``tests/serving/test_supervision.py`` (a killed or quarantined replica
requeues its work with deadlines intact, restarts within its budget and
strands no request; bounded shutdown; deadlines under requeue) and
``test_version_pinning.py`` (per-replica versions, a restart inside a
canary window pinned to the published model) run on
``keystone_tpu_torch.serving`` under the port's fault plan
(``replica.batch=kill@…``, ``transient@…``).

And the port's divergence: a kernel or device fault (``ops.is_device_fault``)
in a live batch or in the canary candidate is the card's, so it is neither
restarted, nor requeued, nor counted as a canary mismatch: every admitted
request fails with it, the fleet stops and dumps its flight ring, and
``swap`` / ``shutdown`` raise it. A Python-level failure of the candidate
is still a mismatch, as in the JAX package.

Every wait is bounded."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from keystone_tpu_torch import faults
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.obs import flight
from keystone_tpu_torch.obs import tracer as obs_tracer
from keystone_tpu_torch.ops import KernelError
from keystone_tpu_torch.serving import (
    CanaryMismatch,
    EngineClosed,
    EngineStopped,
    ServingEngine,
    ServingFleet,
    Shed,
)
from keystone_tpu_torch.serving.batching import BucketPolicy
from keystone_tpu_torch.serving.metrics import MetricsRegistry
from keystone_tpu_torch.serving.replica import _Request
from keystone_tpu_torch.serving.scheduler import FleetScheduler
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode

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


def _fitted(label="double"):
    return FunctionNode(batch_fn=lambda X: X * 2.0, label=label).to_pipeline().fit()


def _hammer(fleet, n=48, clients=8, timeout=WAIT):
    with ThreadPoolExecutor(max_workers=clients) as pool:
        return list(pool.map(
            lambda i: float(np.asarray(fleet.predict(np.full(3, float(i), np.float32),
                                                     timeout=timeout)).ravel()[0]),
            range(n)))


def _dumps(tmp_path, trigger):
    return list(tmp_path.glob(f"keystone-flight-*-{trigger}-*.json"))


# ---------------------------------------------------------------------------
# kill and restart
# ---------------------------------------------------------------------------


def test_replica_kill_loses_zero_accepted_requests_and_restarts():
    faults.install(faults.parse_plan("replica.batch#1=kill@2"))
    fleet = ServingFleet(_fitted(), replicas=2, buckets=(4, 8), datum_shape=(3,),
                         max_wait_ms=1.0)
    with fleet:
        res = _hammer(fleet, 48)
    assert all(abs(r - 2.0 * i) < 1e-4 for i, r in enumerate(res))
    c = fleet.metrics.snapshot()["counters"]
    assert c["completed"] == c["submitted"] == 48
    assert c["restarts"] >= 1 and c["requeues"] >= 1
    assert c.get("batch_errors", 0) == 0
    assert fleet.version_report()["replicas"][1]["restarts"] == 1


def test_kill_and_restart_land_in_the_trace():
    faults.install(faults.parse_plan("replica.batch=kill@1"))
    tr = obs_tracer.install(obs_tracer.Tracer())
    try:
        fleet = ServingFleet(_fitted(), replicas=2, buckets=(4,), datum_shape=(3,),
                             max_wait_ms=1.0)
        with fleet:
            _hammer(fleet, 24)
    finally:
        obs_tracer.uninstall(tr)
    names = {s.name for s in tr.spans()}
    assert {"fault.inject", "fault.replica_down", "fault.replica_restart"} <= names
    ring = {e["name"] for e in flight.recorder().entries()}
    assert {"fault.replica_down", "fault.replica_restart"} <= ring


def test_quarantine_after_consecutive_transient_failures(tmp_path):
    """Three consecutive transient failures trip replica 0's breaker: its
    batches requeue to the peer, the supervisor restarts it, its dump is
    written, and no request is lost."""
    faults.install(faults.parse_plan("replica.batch#0=transient@0,1,2"))
    fleet = ServingFleet(_fitted(), replicas=2, buckets=(4,), datum_shape=(3,),
                         max_wait_ms=1.0, quarantine_after=3)
    total = 0
    with fleet:
        # waves until replica 0 has taken (and failed) its three batches: how
        # the load interleaves is timing's, the fault schedule is not
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            res = _hammer(fleet, 16)
            assert all(abs(r - 2.0 * i) < 1e-4 for i, r in enumerate(res))
            total += len(res)
            if fleet.metrics.count("quarantined") >= 1:
                break
        else:
            pytest.fail("replica 0 never tripped its circuit breaker")
    c = fleet.metrics.snapshot()["counters"]
    assert c["completed"] == c["submitted"] == total
    assert c["quarantined"] == 1 and c["restarts"] >= 1
    assert c["batch_transient"] == 3 and c["requeues"] >= 3
    assert _dumps(tmp_path, "replica_quarantine")


def test_restart_budget_exhaustion_leaves_the_peer_serving(tmp_path):
    faults.install(faults.parse_plan("replica.batch#0=kill@p1.0x9s1"))
    fleet = ServingFleet(_fitted(), replicas=2, buckets=(4,), datum_shape=(3,),
                         max_wait_ms=1.0, max_restarts=1)
    with fleet:
        res = _hammer(fleet, 32)
    assert all(abs(r - 2.0 * i) < 1e-4 for i, r in enumerate(res))
    c = fleet.metrics.snapshot()["counters"]
    assert c["completed"] == 32
    assert c["restarts"] == 1  # the budget, not the kill count
    assert _dumps(tmp_path, "replica_down")


def test_all_replicas_down_fails_typed_never_hangs():
    faults.install(faults.parse_plan("replica.batch=kill@p1.0x9s1"))
    fleet = ServingFleet(_fitted(), replicas=1, buckets=(4,), datum_shape=(3,),
                         max_wait_ms=1.0, max_restarts=0)
    fleet.start()
    try:
        f = fleet.submit(np.zeros(3, np.float32))
        with pytest.raises(EngineStopped):
            f.result(timeout=10)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            try:
                fleet.submit(np.zeros(3, np.float32))
            except EngineStopped:
                break  # admission now refuses typed
            time.sleep(0.01)
        else:
            pytest.fail("admission kept accepting with no live replicas")
    finally:
        fleet.shutdown()


def test_supervise_off_requeues_but_never_restarts():
    faults.install(faults.parse_plan("replica.batch#0=kill@0"))
    fleet = ServingFleet(_fitted(), replicas=2, buckets=(4,), datum_shape=(3,),
                         max_wait_ms=1.0, supervise=False)
    with fleet:
        res = _hammer(fleet, 24)
    assert all(abs(r - 2.0 * i) < 1e-4 for i, r in enumerate(res))
    c = fleet.metrics.snapshot()["counters"]
    assert c["completed"] == 24
    assert c.get("restarts", 0) == 0  # the work moved to the peer instead


# ---------------------------------------------------------------------------
# deadlines under requeue
# ---------------------------------------------------------------------------


def _sched(n=2, buckets=(4,)):
    return FleetScheduler(n, BucketPolicy(buckets, datum_shape=(2,)),
                          MetricsRegistry("supervision-test"))


def test_requeued_request_keeps_its_original_deadline():
    s = _sched()
    now = time.monotonic()
    req = _Request(datum="d", deadline=now + 30.0, enqueued=now)
    req.future.set_running_or_notify_cancel()  # it was mid-batch
    assert s.requeue_batch([req], SimpleNamespace(index=0)) == 1
    assert s.queue_depths() == [0, 1]  # to the peer, at the front
    clone = s._queues[1][0]
    assert clone.deadline == req.deadline and clone.enqueued == req.enqueued
    clone.future.set_running_or_notify_cancel()
    clone.future.set_result("answer")
    assert req.future.result(timeout=1) == "answer"


def test_unmeetable_requeued_deadline_is_shed_typed_not_expired():
    s = _sched()
    s.observe_service(1.0)
    now = time.monotonic()
    doomed = _Request(datum="d", deadline=now + 0.05, enqueued=now)
    doomed.future.set_running_or_notify_cancel()
    ok = _Request(datum="d", deadline=now + 30.0, enqueued=now)
    assert s.requeue_batch([doomed, ok], SimpleNamespace(index=0)) == 1
    with pytest.raises(Shed):
        doomed.future.result(timeout=1)
    assert s._metrics.count("shed") == 1


def test_queued_requeue_sheds_unmeetable_and_moves_the_rest():
    s = _sched()
    s.observe_service(1.0)
    tight = _Request(datum="d", deadline=time.monotonic() + 0.05, enqueued=time.monotonic())
    loose = _Request(datum="d", deadline=time.monotonic() + 30.0, enqueued=time.monotonic())
    with s._cond:
        s._queues[0].extend([tight, loose])
        s._depth = 2
    s.set_active(0, False)
    assert s.requeue_replica(0) == 1
    assert s.queue_depths() == [0, 1]
    with pytest.raises(Shed):
        tight.future.result(timeout=1)
    assert s.depth == 1


def test_requeue_hop_cap_answers_with_the_cause_instead_of_bouncing():
    s = _sched()
    req = _Request(datum="d", deadline=None, enqueued=time.monotonic(),
                   hops=FleetScheduler.MAX_REQUEUE_HOPS)
    req.future.set_running_or_notify_cancel()
    assert s.requeue_batch([req], SimpleNamespace(index=0), RuntimeError("recurring fault")) == 0
    with pytest.raises(RuntimeError, match="recurring fault"):
        req.future.result(timeout=1)


def test_requeue_clone_carries_the_hop_count():
    s = _sched()
    req = _Request(datum="d", deadline=None, enqueued=time.monotonic())
    req.future.set_running_or_notify_cancel()
    assert s.requeue_batch([req], SimpleNamespace(index=0)) == 1
    assert s._queues[1][0].hops == 1


def test_engine_worker_death_closes_admission_and_shutdown_returns():
    """The single engine has no supervisor: a dead worker closes admission
    (no stranded future, no drain deadlock)."""
    faults.install(faults.parse_plan("replica.batch=kill@0"))
    eng = ServingEngine(_fitted(), buckets=(4,), datum_shape=(3,))
    eng.start()
    f = eng.submit(np.zeros(3, np.float32))
    with pytest.raises(EngineClosed):
        f.result(timeout=10)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        try:
            eng.submit(np.zeros(3, np.float32))
        except EngineClosed:
            break
        time.sleep(0.01)
    else:
        pytest.fail("admission stayed open after the worker died")
    t0 = time.monotonic()
    eng.shutdown(drain=True)
    assert time.monotonic() - t0 < 10.0


def test_requeue_with_no_live_peer_fails_typed():
    s = _sched()
    s.set_active(0, False)
    s.set_active(1, False)
    req = _Request(datum="d", deadline=None, enqueued=time.monotonic())
    req.future.set_running_or_notify_cancel()
    assert s.requeue_batch([req], SimpleNamespace(index=0)) == 0
    with pytest.raises(EngineStopped):
        req.future.result(timeout=1)


def test_admission_avoids_inactive_replicas():
    s = _sched()
    s.set_active(0, False)
    for _ in range(3):
        s.admit(_Request(datum="d", deadline=None, enqueued=time.monotonic()))
    assert s.queue_depths() == [0, 3]


# ---------------------------------------------------------------------------
# bounded shutdown
# ---------------------------------------------------------------------------

_WEDGE = threading.Event()
_RELEASE = threading.Event()


def _wedge(X):
    if _WEDGE.is_set():  # unset while the checker runs the node on fake tensors
        _RELEASE.wait(timeout=WAIT)
    return X


def test_wedged_replica_shutdown_is_bounded():
    """A replica stuck in its batch: shutdown drains and joins with time
    limits and still answers every admitted request typed."""
    fitted = FunctionNode(batch_fn=_wedge, label="wedge").to_pipeline().fit()
    fleet = ServingFleet(fitted, replicas=1, buckets=(1,), datum_shape=(3,), max_wait_ms=1.0,
                         join_timeout_s=0.5, drain_timeout_s=0.5)
    _WEDGE.set()
    _RELEASE.clear()
    fleet.start(warmup=False)
    try:
        wedged = fleet.submit(np.zeros(3, np.float32))
        time.sleep(0.2)  # the batch dispatches and wedges
        queued = fleet.submit(np.zeros(3, np.float32))
        t0 = time.monotonic()
        fleet.shutdown(drain=True)
        assert time.monotonic() - t0 < 10.0
        with pytest.raises(EngineStopped):
            queued.result(timeout=1)
        with pytest.raises(EngineStopped):
            wedged.result(timeout=1)
    finally:
        _RELEASE.set()
        _WEDGE.clear()
        time.sleep(0.1)  # the wedged thread unwinds before teardown


# ---------------------------------------------------------------------------
# version pinning (tests/serving/test_version_pinning.py)
# ---------------------------------------------------------------------------

D, K = 12, 3


def _fit_linear(seed=0, n=256):
    r = np.random.RandomState(seed)
    X = (r.randn(n, D) + 1.0).astype(np.float32)
    Y = (np.tanh(X) @ r.randn(D, K).astype(np.float32)).astype(np.float32)
    fitted = (FunctionNode(batch_fn=torch.tanh, label="feat").to_pipeline()
              .and_then(LinearMapEstimator(lam=1e-2, snapshot=True),
                        ChunkedDataset.from_array(X, 64), Dataset.of(Y))
              .fit())
    return fitted, X


def _replacement(fitted, X):
    labels = fitted.apply(Dataset.of(X[:64])).to_array()
    return fitted.absorb(Dataset.of(X[:64]), Dataset.of(labels))


def _wait_for(pred, timeout=WAIT):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_version_report_tracks_promotions():
    fitted, X = _fit_linear()
    fleet = ServingFleet(fitted, replicas=2, buckets=(8,), datum_shape=(D,), max_wait_ms=1.0)
    with fleet:
        r = fleet.version_report()
        assert r["version"] == 1 and not r["skew"]
        assert {row["version"] for row in r["replicas"].values()} == {1}
        assert fleet.swap(_replacement(fitted, X))["version"] == 2  # no canary: promoted
        r = fleet.version_report()
        assert r["version"] == 2 and not r["skew"]
        assert {row["version"] for row in r["replicas"].values()} == {2}
    assert fleet.model_version == 2


def test_restart_inside_canary_window_pins_old_version():
    """A replica killed while a canaried swap's window is open restarts on
    version 1 (the published model); the promotion then moves every
    replica to version 2, never a mixed fleet."""
    fitted, X = _fit_linear()
    replacement = _replacement(fitted, X)
    fleet = ServingFleet(fitted, replicas=2, buckets=(8,), datum_shape=(D,), max_wait_ms=1.0)
    swap_result = {}

    def do_swap():
        try:
            # a wide window, so the promotion cannot outrun the kill in it
            swap_result["report"] = fleet.swap(replacement, canary_fraction=1.0,
                                               canary_batches=48, canary_timeout_s=60.0,
                                               atol=0.5, rtol=0.5)
        except Exception as e:  # surfaced by the final assert
            swap_result["error"] = e

    stop = threading.Event()
    failures = []

    def traffic():
        i = 0
        while not stop.is_set():
            try:
                fleet.predict(X[i % len(X)], timeout=15.0)
            except Exception as e:
                failures.append(repr(e))
            i += 1

    with fleet:
        swapper = threading.Thread(target=do_swap, daemon=True)
        swapper.start()
        # the window is open when the shadow is on the replicas; traffic
        # starts only then, so nothing mirrors before the kill is planned
        assert _wait_for(lambda: any(r._shadow is not None for r in fleet.replicas))
        faults.install(faults.parse_plan("replica.batch#1=kill@0"))
        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        assert _wait_for(lambda: fleet.metrics.count("restarts") >= 1)
        mid = fleet.version_report()
        assert mid["version"] == 1 and not mid["skew"], mid
        faults.clear()
        swapper.join(timeout=90.0)
        assert not swapper.is_alive()
        stop.set()
        t.join(timeout=5)
        assert not t.is_alive()
        final = fleet.version_report()
    assert "error" not in swap_result, swap_result
    assert swap_result["report"]["version"] == 2
    assert final["version"] == 2 and not final["skew"], final
    assert {row["version"] for row in final["replicas"].values()} == {2}
    assert not failures


# ---------------------------------------------------------------------------
# the port's divergence: a kernel or device fault is the card's
# ---------------------------------------------------------------------------

_DEVICE_FAULT = threading.Event()
# a faulting batch raises once this is set; a test clears it to hold the
# fault until every request it means to admit is admitted
_ADMITTED = threading.Event()
_ADMITTED.set()


def _faulting(kind):
    def fault(X):
        if _DEVICE_FAULT.is_set():  # unset while the checker runs the node
            _ADMITTED.wait(WAIT)
            raise kind
        return X * 2.0

    return fault


DEVICE_FAULTS = [
    KernelError("gaussian_kernel_block launch failed: an illegal memory access (700)"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
]


@pytest.fixture
def device_fault():
    _DEVICE_FAULT.clear()
    _ADMITTED.set()
    yield _DEVICE_FAULT
    _DEVICE_FAULT.clear()
    _ADMITTED.set()


@pytest.mark.parametrize("error", DEVICE_FAULTS, ids=["kernel", "oom", "cuda"])
def test_a_device_fault_in_a_live_batch_fails_every_request_and_is_not_requeued(
        error, device_fault, tmp_path):
    fitted = FunctionNode(batch_fn=_faulting(error), label="faulty").to_pipeline().fit()
    fleet = ServingFleet(fitted, replicas=2, buckets=(1, 4), datum_shape=(3,),
                         max_wait_ms=1.0)
    fleet.start()
    try:
        assert float(np.asarray(fleet.predict(np.ones(3, np.float32), timeout=WAIT))[0]) == 2.0
        _ADMITTED.clear()  # the first faulting batch waits for the twelfth admission
        device_fault.set()
        futs = [fleet.submit(np.ones(3, np.float32)) for _ in range(12)]
        _ADMITTED.set()
        for f in futs:
            with pytest.raises(type(error)) as got:
                f.result(timeout=WAIT)
            assert got.value is error
        with pytest.raises(EngineStopped) as refused:
            fleet.submit(np.ones(3, np.float32))
        assert refused.value.__cause__ is error
    finally:
        with pytest.raises(type(error)):
            fleet.shutdown()
    c = fleet.metrics.snapshot()["counters"]
    assert c["device_faults"] == 1
    assert c.get("restarts", 0) == 0 and c.get("requeues", 0) == 0
    assert c.get("quarantined", 0) == 0 and c.get("batch_transient", 0) == 0
    assert c["completed"] == 1
    assert _dumps(tmp_path, "device_fault")
    (inst,) = [e for e in flight.recorder().entries() if e["name"] == "fault.device"]
    assert inst["attrs"]["replica"] in (0, 1)


def test_a_python_error_in_a_live_batch_fails_only_that_batch(device_fault):
    """The contrast: a failure that is not the card's fails its batch and
    the fleet serves on, as in the JAX package."""
    fitted = FunctionNode(batch_fn=_faulting(ValueError("bad row")),
                          label="flaky").to_pipeline().fit()
    fleet = ServingFleet(fitted, replicas=2, buckets=(1,), datum_shape=(3,), max_wait_ms=1.0)
    with fleet:
        device_fault.set()
        with pytest.raises(ValueError, match="bad row"):
            fleet.predict(np.ones(3, np.float32), timeout=WAIT)
        device_fault.clear()
        assert float(np.asarray(fleet.predict(np.ones(3, np.float32), timeout=WAIT))[0]) == 2.0
    c = fleet.metrics.snapshot()["counters"]
    assert c["batch_errors"] == 1 and c.get("device_faults", 0) == 0


def _traffic(fleet, stop, errors):
    while not stop.is_set():
        try:
            fleet.predict(np.ones(3, np.float32), timeout=WAIT)
        except Exception as e:  # the fault reaches the callers; kept to check
            errors.append(e)


def _canary(fleet, candidate):
    stop, errors = threading.Event(), []
    threads = [threading.Thread(target=_traffic, args=(fleet, stop, errors)) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.1)
        fleet.swap(candidate, warmup=False, canary_fraction=1.0, canary_batches=4,
                   canary_timeout_s=20.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
    return errors


def test_a_device_fault_in_the_canary_candidate_stops_the_fleet_not_a_mismatch(
        device_fault, tmp_path):
    error = KernelError("gaussian_kernel_block launch failed: unspecified launch failure (719)")
    candidate = FunctionNode(batch_fn=_faulting(error), label="candidate").to_pipeline().fit()
    fleet = ServingFleet(FunctionNode(batch_fn=lambda X: X * 2.0, label="live")
                         .to_pipeline().fit(), replicas=2, buckets=(1, 4), datum_shape=(3,),
                         max_wait_ms=1.0)
    fleet.start()
    try:
        device_fault.set()  # the live chain never faults; the candidate does
        with pytest.raises(KernelError) as raised:
            _canary(fleet, candidate)
        assert raised.value is error
        with pytest.raises(EngineStopped):
            fleet.submit(np.ones(3, np.float32))
    finally:
        with pytest.raises(KernelError):
            fleet.shutdown()
    c = fleet.metrics.snapshot()["counters"]
    assert c["device_faults"] == 1
    assert c.get("canary_fail", 0) == 0 and c.get("canary_pass", 0) == 0
    assert c.get("swaps", 0) == 0 and fleet.model_version == 1
    assert _dumps(tmp_path, "device_fault") and not _dumps(tmp_path, "canary_rollback")


def test_a_python_error_in_the_canary_candidate_is_a_mismatch_as_in_jax():
    """The contrast, through both packages: a candidate whose batch raises
    a Python error rolls back with the error in the evidence, and the
    fleet serves on."""
    from keystone_tpu.serving import CanaryMismatch as JCanaryMismatch
    from keystone_tpu.serving import ServingFleet as JServingFleet
    from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode

    def broken(X):
        raise ValueError("the candidate cannot run this bucket")

    reports = []
    for fleet_cls, node_cls, mismatch in (
            (JServingFleet, JFunctionNode, JCanaryMismatch),
            (ServingFleet, FunctionNode, CanaryMismatch)):
        fleet = fleet_cls(node_cls(batch_fn=lambda X: X * 2.0, label="live").to_pipeline().fit(),
                          replicas=2, buckets=(1,), datum_shape=(3,), max_wait_ms=1.0)
        # the port's checker runs a node's forward on fake tensors, so the
        # candidate raises only once served
        armed = threading.Event()

        def candidate_fn(X, armed=armed):
            if armed.is_set():
                broken(X)
            return X * 2.0

        candidate = node_cls(batch_fn=candidate_fn, label="candidate").to_pipeline().fit()
        armed.set()
        with fleet:
            with pytest.raises(mismatch) as err:
                _canary(fleet, candidate)
            assert float(np.asarray(fleet.predict(np.ones(3, np.float32), timeout=WAIT))[0]) == 2.0
            reports.append((err.value.report, fleet.metrics.count("canary_fail")))
    (j_report, j_fail), (report, fail) = reports
    assert j_fail == fail == 1
    assert j_report["mismatches"] >= 1 and report["mismatches"] >= 1
    assert "the candidate cannot run this bucket" in j_report["mismatch_details"][0]["error"]
    assert "the candidate cannot run this bucket" in report["mismatch_details"][0]["error"]


def test_injected_kill_and_transient_still_restart_and_requeue(tmp_path):
    """The injected faults keep the JAX package's recovery: a kill
    restarts its replica and requeues its batch, a transient fault
    requeues; no device fault is recorded."""
    faults.install(faults.parse_plan("replica.batch#0=kill@0;replica.batch#1=transient@0"))
    fleet = ServingFleet(_fitted(), replicas=2, buckets=(4,), datum_shape=(3,), max_wait_ms=1.0)
    with fleet:
        res = _hammer(fleet, 32)
    assert all(abs(r - 2.0 * i) < 1e-4 for i, r in enumerate(res))
    c = fleet.metrics.snapshot()["counters"]
    assert c["completed"] == 32 and c["restarts"] == 1
    assert c["requeues"] >= 1 and c["batch_transient"] == 1
    assert c.get("device_faults", 0) == 0 and not _dumps(tmp_path, "device_fault")
