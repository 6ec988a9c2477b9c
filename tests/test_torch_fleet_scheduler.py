"""The fleet scheduler on the port: the cases of the JAX package's
``tests/serving/test_scheduler.py`` (admission arithmetic, continuous
batch forming, work stealing, drain and stop), driven directly with no
replicas; and the same evidence through both packages'
``ServiceEstimate`` and ``FleetScheduler`` gives the same wait estimates,
coalesce windows, shed decisions and steals.

Every wait in a threaded case is bounded."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from keystone_tpu.serving.batching import BucketPolicy as JBucketPolicy
from keystone_tpu.serving.errors import Shed as JShed
from keystone_tpu.serving.metrics import MetricsRegistry as JMetricsRegistry
from keystone_tpu.serving.replica import _Request as JRequest
from keystone_tpu.serving.scheduler import FleetScheduler as JFleetScheduler
from keystone_tpu.serving.scheduler import ServiceEstimate as JServiceEstimate
from keystone_tpu_torch.serving.batching import BucketPolicy
from keystone_tpu_torch.serving.errors import EngineStopped, QueueFull, Shed
from keystone_tpu_torch.serving.metrics import MetricsRegistry
from keystone_tpu_torch.serving.replica import STOP, _Request
from keystone_tpu_torch.serving.scheduler import FleetScheduler, ServiceEstimate


def _req(deadline=None):
    now = time.monotonic()
    return _Request(datum=None, deadline=(now + deadline) if deadline is not None else None,
                    enqueued=now)


def _sched(n=2, buckets=(4, 8), max_queue=64, max_wait_ms=1.0, steal=True):
    return FleetScheduler(n, BucketPolicy(buckets, datum_shape=(2,)),
                          MetricsRegistry("sched-test"), max_queue=max_queue,
                          max_wait_ms=max_wait_ms, steal=steal)


def _replica(index):
    return SimpleNamespace(index=index, last_exec_seconds=None)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def test_estimated_wait_scales_with_depth_and_evidence():
    s = _sched(n=2, buckets=(4, 8))
    assert s.estimated_wait() == 0.0  # cold: no evidence, no estimate
    s.observe_service(0.1)
    assert s.estimated_wait() == pytest.approx(0.1)
    for _ in range(16):  # one full round of 2 replicas × the 8-bucket ahead
        s.admit(_req())
    assert s.estimated_wait() == pytest.approx(0.2)


def test_ewma_follows_observations():
    s = _sched()
    s.observe_service(0.1)
    for _ in range(50):
        s.observe_service(0.5)
    assert 0.45 < s.service_estimate <= 0.5


def test_admit_sheds_unmeetable_deadline_and_counts():
    s = _sched(n=1, buckets=(4,))
    s.observe_service(0.5)
    for _ in range(3):
        with pytest.raises(Shed):
            s.admit(_req(deadline=0.05))
    assert s._metrics.count("shed") == 3
    s.admit(_req(deadline=5.0))  # the same with slack admits
    assert s.depth == 1


def test_admit_respects_queue_bound_and_close():
    s = _sched(n=1, buckets=(4,), max_queue=2)
    s.admit(_req())
    s.admit(_req())
    with pytest.raises(QueueFull):
        s.admit(_req())
    s.close()
    with pytest.raises(EngineStopped):
        s.admit(_req())


def test_admission_balances_to_shallowest_queue():
    s = _sched(n=2, steal=False)
    for _ in range(6):
        s.admit(_req())
    assert s.queue_depths() == [3, 3]


# ---------------------------------------------------------------------------
# continuous batch forming
# ---------------------------------------------------------------------------


def test_next_batch_dispatches_exactly_full_bucket_without_waiting():
    s = _sched(n=1, buckets=(4, 8), max_wait_ms=10_000.0)
    for _ in range(4):
        s.admit(_req())
    t0 = time.monotonic()
    batch = s.next_batch(_replica(0))
    assert len(batch) == 4  # bucket 4 exactly full: no wait for the window
    assert time.monotonic() - t0 < 1.0


def test_request_arriving_during_forming_joins_the_batch():
    s = _sched(n=1, buckets=(2,), max_wait_ms=5_000.0)
    s.admit(_req())

    def late_arrival():
        time.sleep(0.1)
        s.admit(_req())

    t = threading.Thread(target=late_arrival)
    t.start()
    batch = s.next_batch(_replica(0))
    t.join(timeout=10)
    assert not t.is_alive()
    assert len(batch) == 2  # the late request joined and filled the bucket


def test_tight_deadline_forces_dispatch_instead_of_waiting():
    s = _sched(n=1, buckets=(8,), max_wait_ms=10_000.0)
    s.observe_service(0.05)
    s.admit(_req(deadline=0.2))
    t0 = time.monotonic()
    batch = s.next_batch(_replica(0))
    assert len(batch) == 1
    assert time.monotonic() - t0 < 0.25  # within the deadline's slack


def test_batch_done_learns_service_time_from_replica():
    s = _sched(n=1, buckets=(4,))
    s.admit(_req())
    rep = _replica(0)
    batch = s.next_batch(rep)
    rep.last_exec_seconds = 0.123
    s.batch_done(batch, rep)
    assert s.service_estimate == pytest.approx(0.123)


# ---------------------------------------------------------------------------
# work stealing
# ---------------------------------------------------------------------------


def _preload(s, index, n):
    """Place n requests on one queue, past the balanced admission: a replica
    whose bucket mix stalled it mid-drain."""
    with s._lock:
        for _ in range(n):
            s._queues[index].append(_req())
            s._depth += 1


def test_idle_replica_steals_newest_half_from_deepest_peer():
    s = _sched(n=2, buckets=(4, 8), max_wait_ms=1.0)
    _preload(s, 0, 12)
    batch = s.next_batch(_replica(1))  # replica 1's own queue is empty
    assert batch is not STOP and len(batch) >= 1
    assert s._metrics.count("steals") == 6  # the newest half of 12
    assert s.queue_depths()[0] == 6


def test_steal_disabled_pins_requests_to_their_queue():
    s = _sched(n=2, buckets=(4,), max_wait_ms=1.0, steal=False)
    _preload(s, 0, 8)
    got = []
    t = threading.Thread(target=lambda: got.append(s.next_batch(_replica(1))))
    t.start()
    time.sleep(0.3)
    s.stop()
    t.join(timeout=5)
    assert not t.is_alive()
    assert got == [STOP]
    assert s.queue_depths()[0] == 8


# ---------------------------------------------------------------------------
# drain and stop
# ---------------------------------------------------------------------------


def test_wait_idle_blocks_until_queues_and_inflight_clear():
    s = _sched(n=1, buckets=(4,))
    s.admit(_req())
    assert s.wait_idle(timeout=0.2) is False  # queued: not idle
    rep = _replica(0)
    batch = s.next_batch(rep)
    assert s.wait_idle(timeout=0.2) is False  # in flight: not idle
    s.batch_done(batch, rep)
    assert s.wait_idle(timeout=5.0) is True


def test_fail_remaining_answers_everything_with_engine_stopped():
    s = _sched(n=2, buckets=(4,))
    reqs = [_req() for _ in range(5)]
    for r in reqs:
        s.admit(r)
    assert s.fail_remaining() == 5
    for r in reqs:
        with pytest.raises(EngineStopped):
            r.future.result(timeout=1)
    assert s.depth == 0


# ---------------------------------------------------------------------------
# parity with the JAX package on the same evidence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_service_estimate_waits_and_coalesce_windows_equal_jax(seed):
    rng = np.random.default_rng(seed)
    port, ref = ServiceEstimate(), JServiceEstimate()
    assert port.coalesce_window(5.0) == ref.coalesce_window(5.0) == 0.0
    assert port.wait(100, 8) == ref.wait(100, 8) == 0.0
    for seconds in rng.uniform(0.0005, 0.05, size=40):
        port.observe(float(seconds))
        ref.observe(float(seconds))
        assert port.estimate == ref.estimate
        depth, capacity = int(rng.integers(0, 300)), int(rng.integers(1, 130))
        assert port.wait(depth, capacity) == ref.wait(depth, capacity)
        now = 100.0
        tight = None if rng.random() < 0.3 else now + float(rng.uniform(0.0, 0.1))
        cap = float(rng.uniform(0.0005, 0.01))
        assert port.coalesce_window(now, tight, cap) == ref.coalesce_window(now, tight, cap)


class _FrozenClock:
    """One ``time`` stand-in for both schedulers: ``monotonic()`` returns
    the clock the test sets, so no shed verdict rests on the time that
    passes between the two packages' admissions."""

    def __init__(self, now: float = 1000.0):
        self.now = now

    def monotonic(self) -> float:
        return self.now


def _refusals(sched, req_type, shed_type, evidence, deadlines, priorities, clock):
    for s in evidence:
        sched.observe_service(s)
    out = []
    for deadline, priority in zip(deadlines, priorities):
        now = clock.monotonic()
        r = req_type(datum=None, deadline=None if deadline is None else now + deadline,
                     enqueued=now, priority=priority)
        try:
            sched.admit(r)
            out.append("admitted")
        except shed_type:
            out.append("shed")
    return out, sched.queue_depths()


@pytest.mark.parametrize("seed", range(3))
def test_shedding_given_the_same_service_evidence_equals_jax(seed, monkeypatch):
    """The same learned service times and the same stream of deadlines and
    priorities: both schedulers shed the same requests and place the rest
    on the same queues. Both schedulers' modules read one frozen clock, and
    each request's deadline is built from it, so every verdict is taken at
    the same instant in both packages."""
    import keystone_tpu.serving.scheduler as jax_scheduler
    import keystone_tpu_torch.serving.scheduler as port_scheduler

    clock = _FrozenClock()
    monkeypatch.setattr(port_scheduler, "time", clock)
    monkeypatch.setattr(jax_scheduler, "time", clock)
    rng = np.random.default_rng(seed)
    evidence = [float(v) for v in rng.uniform(0.01, 0.03, size=5)]
    n = 200
    steps = rng.integers(0, 6, size=n)
    deadlines = [None if rng.random() < 0.2 else (float(k) + 0.6) * 0.03 for k in steps]
    priorities = [("high", "normal", "low")[int(i)] for i in rng.integers(0, 3, size=n)]
    port = FleetScheduler(3, BucketPolicy((4, 8), datum_shape=(2,)), MetricsRegistry(),
                          max_queue=1000)
    ref = JFleetScheduler(3, JBucketPolicy((4, 8), datum_shape=(2,)), JMetricsRegistry(),
                          max_queue=1000)
    got = _refusals(port, _Request, Shed, evidence, deadlines, priorities, clock)
    want = _refusals(ref, JRequest, JShed, evidence, deadlines, priorities, clock)
    assert got == want
    assert "shed" in got[0] and "admitted" in got[0]
    assert port._metrics.snapshot()["counters"] == ref._metrics.snapshot()["counters"]


def test_stealing_moves_what_jax_moves():
    """A stalled queue of mixed priorities and tenants: the idle replica
    steals the same requests, in the same order, as the JAX scheduler's."""
    port, ref = _sched(n=3, buckets=(4, 8)), JFleetScheduler(
        3, JBucketPolicy((4, 8), datum_shape=(2,)), JMetricsRegistry(), max_wait_ms=1.0)
    for i in range(13):
        kw = dict(datum=i, deadline=None, enqueued=0.0, priority=("high", "normal", "low")[i % 3],
                  tenant=("a", "b")[i % 2])
        for s, kind in ((port, _Request), (ref, JRequest)):
            with s._lock:
                s._queues[0].append(kind(**kw))
                s._depth += 1
    got = port.next_batch(_replica(2))
    want = ref.next_batch(_replica(2))
    assert [r.datum for r in got] == [r.datum for r in want]
    assert port.queue_depths() == ref.queue_depths()
    assert port._metrics.count("steals") == ref._metrics.count("steals") == 6
