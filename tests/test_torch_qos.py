"""QoS at the fleet's admission surface, on the port: the cases of the JAX
package's ``tests/serving/test_qos.py`` (weighted-fair tenancy by deficit
round robin, the priority shed order, QoS identity kept across requeues
and steals, no shedding without service evidence) run on
``keystone_tpu_torch.autoscale.qos`` and ``serving.scheduler``; and seeded
sequences of appends and pops through both packages'
``WeightedFairQueue`` give the same pop order."""

import time

import numpy as np
import pytest

from keystone_tpu.autoscale.qos import WeightedFairQueue as JWeightedFairQueue
from keystone_tpu.serving.replica import _Request as JRequest
from keystone_tpu_torch.autoscale.qos import SHED_BIAS, WeightedFairQueue, normalize_priority
from keystone_tpu_torch.serving.batching import BucketPolicy
from keystone_tpu_torch.serving.errors import Shed
from keystone_tpu_torch.serving.metrics import MetricsRegistry
from keystone_tpu_torch.serving.replica import _Request
from keystone_tpu_torch.serving.scheduler import FleetScheduler


def req(priority="normal", tenant="default", deadline=None, hops=0):
    return _Request(datum=None, deadline=deadline, enqueued=time.monotonic(), hops=hops,
                    priority=priority, tenant=tenant)


def make_sched(n=1, weights=None, max_size=1, max_queue=1024):
    return FleetScheduler(n, BucketPolicy(batch_sizes=(max_size,)), MetricsRegistry(),
                          max_queue=max_queue, tenant_weights=weights)


# -- the weighted-fair queue ----------------------------------------------


def test_wfq_serves_tenants_in_weight_ratio():
    q = WeightedFairQueue({"a": 3.0, "b": 1.0})
    for _ in range(12):
        q.append(req(tenant="a"))
        q.append(req(tenant="b"))
    assert len(q) == 24
    # quanta 1 and 1/3: three 'a' a 'b', in a fixed order
    order = [q.popleft().tenant for _ in range(16)]
    assert order[:8] == ["a", "a", "a", "b", "a", "a", "a", "b"]
    assert order.count("a") == 12 and order.count("b") == 4
    # 'a' exhausted: the remaining tenant drains directly
    assert [q.popleft().tenant for _ in range(8)] == ["b"] * 8
    assert len(q) == 0
    with pytest.raises(IndexError):
        q.popleft()


def test_wfq_priority_orders_within_one_tenant_only():
    q = WeightedFairQueue()
    a_low, a_high = req("low", "a"), req("high", "a")
    b_norm = req("normal", "b")
    q.append(a_low)
    q.append(b_norm)
    q.append(a_high)
    # within 'a' high jumps low; across tenants the round still alternates
    assert q.popleft() is a_high
    assert q.popleft() is b_norm
    assert q.popleft() is a_low


def test_wfq_emptied_tenant_forfeits_deficit():
    q = WeightedFairQueue({"a": 1.0, "b": 1.0})
    q.append(req(tenant="a"))
    q.append(req(tenant="b"))
    assert q.popleft().tenant == "a"
    assert q.popleft().tenant == "b"
    q.append(req(tenant="a"))  # back after emptying: no banked credit
    assert q.popleft().tenant == "a"


def test_wfq_steal_takes_lowest_class_newest_from_deepest():
    q = WeightedFairQueue()
    q.append(req("high", "a"))
    old_low, new_low = req("low", "b"), req("low", "b")
    q.append(old_low)
    q.append(new_low)
    assert q.pop() is new_low
    assert q.pop() is old_low
    assert q.pop().priority == "high"


def test_wfq_appendleft_requeues_into_own_lane_front():
    q = WeightedFairQueue()
    first, second = req("normal", "a"), req("normal", "a")
    q.append(first)
    q.append(second)
    rerouted = req("normal", "a")
    q.appendleft(rerouted)
    assert q.popleft() is rerouted
    high = req("high", "a")
    q.appendleft(high)  # its own rank's front, which dispatches first
    assert q.popleft() is high
    assert q.popleft() is first and q.popleft() is second


def test_wfq_introspection_and_validation():
    with pytest.raises(ValueError):
        WeightedFairQueue({"a": 0.0})
    q = WeightedFairQueue({"a": 2.0})
    q.append(req("high", "a"))
    q.append(req("low", "b"))
    q.append(req("low", "b"))
    assert q.rank_lens() == [1, 0, 2]
    assert q.tenant_depths() == {"a": 1, "b": 2}
    assert q.weight("a") == 2.0 and q.weight("b") == 1.0
    assert len(list(q)) == 3 and q[0].priority == "high"


@pytest.mark.parametrize("seed", range(6))
def test_wfq_pop_order_equals_jax_on_the_same_sequence(seed):
    """A seeded mix of append / appendleft / popleft / pop over four
    tenants of unequal weights and three priorities, through both
    packages' queues: every pop returns the same request."""
    rng = np.random.default_rng(seed)
    weights = {"gold": 3.0, "silver": 2.0, "bronze": 1.0}
    tenants = ["gold", "silver", "bronze", "default"]
    priorities = ["high", "normal", "low"]
    port, ref = WeightedFairQueue(weights), JWeightedFairQueue(weights)
    got, want = [], []
    for i in range(400):
        op = rng.choice(["append", "append", "appendleft", "popleft", "popleft", "pop"])
        if op in ("append", "appendleft"):
            t, p = tenants[rng.integers(4)], priorities[rng.integers(3)]
            getattr(port, op)(_Request(datum=i, deadline=None, enqueued=0.0, priority=p,
                                       tenant=t))
            getattr(ref, op)(JRequest(datum=i, deadline=None, enqueued=0.0, priority=p,
                                      tenant=t))
        elif len(ref):
            got.append(getattr(port, op)().datum)
            want.append(getattr(ref, op)().datum)
        assert len(port) == len(ref) and port.rank_lens() == ref.rank_lens()
    while len(ref):
        got.append(port.popleft().datum)
        want.append(ref.popleft().datum)
    assert got == want and len(got) > 100
    assert len(port) == 0


# -- the priority vocabulary -------------------------------------------------


def test_priority_vocabulary_is_closed():
    assert normalize_priority(None) == "normal"
    assert normalize_priority("HIGH") == "high"
    with pytest.raises(ValueError):
        normalize_priority("urgent")
    assert SHED_BIAS["high"] < SHED_BIAS["normal"] < SHED_BIAS["low"]


# -- admission: the shed order -----------------------------------------------


def test_shed_ordering_low_before_high_at_equal_slack():
    sched = make_sched(n=1, max_size=1)
    sched.observe_service(0.1)  # learned: 0.1 s a micro-batch
    for _ in range(4):
        sched.admit(req())  # four normals queued, no deadline
    slack = 0.3  # high prices only its own (empty) class, low everything
    with pytest.raises(Shed):
        sched.admit(req("low", deadline=time.monotonic() + slack))
    with pytest.raises(Shed):
        sched.admit(req("normal", deadline=time.monotonic() + slack))
    sched.admit(req("high", deadline=time.monotonic() + slack))
    counters = sched._metrics.snapshot()["counters"]
    assert counters["shed"] == 2
    assert counters["shed.low"] == 1 and counters["shed.normal"] == 1
    assert "shed.high" not in counters
    assert sched.qos_snapshot()["queued_by_priority"] == {"high": 1, "normal": 4, "low": 0}


def test_cold_scheduler_never_sheds():
    sched = make_sched(n=1, max_size=1)
    assert sched.service_estimate is None
    for _ in range(50):
        sched.admit(req())
    # a deadline almost now with 50 queued, but no service evidence
    sched.admit(req("low", deadline=time.monotonic() + 0.001))
    assert "shed" not in sched._metrics.snapshot()["counters"]


def test_estimated_wait_prices_same_or_better_class_only():
    sched = make_sched(n=1, max_size=1)
    sched.observe_service(0.1)
    sched.admit(req("normal"))
    sched.admit(req("normal"))
    sched.admit(req("low"))
    assert sched.estimated_wait(0) == pytest.approx(0.1)
    assert sched.estimated_wait(1) == pytest.approx(0.1 * 3)
    assert sched.estimated_wait(2) == pytest.approx(0.1 * 4)


# -- requeue and clone identity ----------------------------------------------


class _ReplicaStub:
    def __init__(self, index):
        self.index = index


def test_requeue_batch_clones_preserve_qos_identity():
    sched = make_sched(n=2, weights={"gold": 2.0})
    orig = req("high", "gold")
    assert sched.requeue_batch([orig], _ReplicaStub(0)) == 1
    clone = sched._queues[1][0]
    assert clone is not orig
    assert clone.priority == "high" and clone.tenant == "gold"
    assert clone.hops == orig.hops + 1
    assert clone.deadline == orig.deadline and clone.enqueued == orig.enqueued


def test_requeue_replica_moves_queued_with_identity():
    sched = make_sched(n=2)
    r = req("low", "bronze")
    sched.admit(r)
    if not sched._queues[0]:
        sched._queues[0].append(sched._queues[1].popleft())
    assert sched.requeue_replica(0) == 1
    landed = sched._queues[1][0]
    assert landed is r  # queued requests move; only in-flight ones are cloned
    assert landed.priority == "low" and landed.tenant == "bronze"


def test_requeued_unmeetable_deadline_sheds_typed_per_class():
    sched = make_sched(n=2, max_size=1)
    sched.observe_service(1.0)
    for _ in range(3):
        sched.admit(req())
    doomed = req("low", deadline=time.monotonic() + 0.5)
    assert sched.requeue_batch([doomed], _ReplicaStub(0)) == 0
    with pytest.raises(Shed):
        doomed.future.result(timeout=1)
    assert sched._metrics.snapshot()["counters"]["shed.low"] == 1
