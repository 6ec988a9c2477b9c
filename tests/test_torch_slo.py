"""SLO evaluation and the watchdog on the port: the cases of the JAX
package's ``tests/serving/test_slo.py`` and the policy cases of
``test_slo_budgets.py`` run on ``keystone_tpu_torch.serving.slo``; and
seeded timeline rows judged by both packages' ``SloPolicy.evaluate`` give
the same breaches. (The autoscaler case of ``test_slo_budgets.py`` is in
``tests/test_torch_scaler.py``.)"""

from dataclasses import asdict

import numpy as np
import pytest

from keystone_tpu.serving.slo import SloPolicy as JSloPolicy
from keystone_tpu_torch.obs import flight
from keystone_tpu_torch.serving.metrics import MetricsRegistry
from keystone_tpu_torch.serving.slo import SloBreach, SloPolicy, SloWatchdog


@pytest.fixture(autouse=True)
def _flight():
    flight.reset()
    yield
    flight.reset()


def _row(**over):
    row = {"ts": 100.0, "counters": {}, "gauges": {}, "latency": {}, "queue_age": {},
           "occupancy": None}
    row.update(over)
    return row


# -- tests/serving/test_slo.py ----------------------------------------------


def test_unset_objectives_are_not_evaluated():
    assert SloPolicy().evaluate(_row(latency={"p99": 99.0}, counters={"restarts": 50})) == []


def test_p99_and_queue_age_budgets():
    pol = SloPolicy(p99_budget_s=0.5, queue_age_p99_budget_s=0.1)
    traffic = {"completed": 4}
    assert pol.evaluate(_row(latency={"p99": 0.4}, queue_age={"p99": 0.05},
                             counters=traffic)) == []
    bad = pol.evaluate(_row(latency={"p99": 0.6}, queue_age={"p99": 0.2}, counters=traffic))
    assert [b.objective for b in bad] == ["p99_budget_s", "queue_age_p99_budget_s"]
    assert bad[0].observed == 0.6 and bad[0].budget == 0.5
    assert bad[0].ts == 100.0


def test_latency_budgets_judge_only_windows_with_traffic():
    pol = SloPolicy(p99_budget_s=0.5, queue_age_p99_budget_s=0.1)
    assert pol.evaluate(_row(latency={"p99": 9.0}, queue_age={"p99": 9.0})) == []
    (b,) = pol.evaluate(_row(latency={"p99": 9.0}, counters={"submitted": 1}))
    assert b.objective == "p99_budget_s"


def test_shed_rate_judged_only_with_traffic():
    pol = SloPolicy(max_shed_rate=0.25)
    assert pol.evaluate(_row()) == []
    assert pol.evaluate(_row(counters={"submitted": 9, "shed": 1})) == []
    (b,) = pol.evaluate(_row(counters={"submitted": 4, "shed": 3, "rejected": 3}))
    assert b.objective == "max_shed_rate" and b.observed == 0.6


def test_restart_burn_counts_both_tiers():
    pol = SloPolicy(max_restart_burn=1)
    assert pol.evaluate(_row(counters={"restarts": 1})) == []
    (b,) = pol.evaluate(_row(counters={"restarts": 1, "trainer_restarts": 1}))
    assert b.objective == "max_restart_burn" and b.observed == 2


def test_trainer_staleness_and_drift_gauges():
    pol = SloPolicy(max_staleness_s=60.0, max_drift_score=3.0)
    assert pol.evaluate(_row(gauges={"staleness_s": 10.0, "drift_score": 1.0})) == []
    bad = pol.evaluate(_row(gauges={"staleness_s": 120.0, "drift_score": 4.5}))
    assert [b.objective for b in bad] == ["max_staleness_s", "max_drift_score"]
    assert pol.evaluate(_row()) == []


def test_watchdog_tick_samples_judges_and_emits():
    reg = MetricsRegistry(name="fleet")
    for _ in range(8):
        reg.observe_latency(2.0)
        reg.inc("completed")
    dog = SloWatchdog(reg, SloPolicy(p99_budget_s=1.0), source="test-tier")
    found = dog.tick()
    assert [b.objective for b in found] == ["p99_budget_s"]
    assert reg.count("slo_breaches") == 1
    assert reg.count("slo_breach.p99_budget_s") == 1
    assert dog.breaches == found
    hits = [e for e in flight.recorder().entries() if e["name"] == "slo.breach"]
    assert hits and hits[-1]["attrs"]["source"] == "test-tier"
    assert hits[-1]["attrs"]["objective"] == "p99_budget_s"
    assert len(reg.timeline()) == 1  # the sample was taken inside tick


def test_watchdog_quiet_tick_emits_nothing():
    reg = MetricsRegistry(name="fleet")
    reg.observe_latency(0.1)
    dog = SloWatchdog(reg, SloPolicy(p99_budget_s=1.0))
    assert dog.tick() == []
    assert reg.count("slo_breaches") == 0


def test_breach_is_a_typed_value():
    b = SloBreach("p99_budget_s", 0.7, 0.5, 1.0)
    assert b.as_attrs() == {"objective": "p99_budget_s", "observed": 0.7, "budget": 0.5}


def test_a_breach_lands_in_the_trace():
    from keystone_tpu_torch.obs import tracer as obs_tracer

    reg = MetricsRegistry(name="fleet")
    reg.inc("submitted", 4)
    reg.inc("shed", 4)
    tr = obs_tracer.install(obs_tracer.Tracer())
    try:
        (b,) = SloWatchdog(reg, SloPolicy(max_shed_rate=0.1)).tick()
    finally:
        obs_tracer.uninstall(tr)
    assert b.objective == "max_shed_rate" and b.observed == 0.5
    (inst,) = [s for s in tr.spans() if s.name == "slo.breach"]
    assert inst.attrs["objective"] == "max_shed_rate" and inst.attrs["source"] == "serving"


# -- tests/serving/test_slo_budgets.py ---------------------------------------


def test_tenant_budget_breach_names_the_overspender():
    (b,) = SloPolicy(tenant_device_s_budget=0.25).evaluate(_row(costs={
        "gold": {"device_s": 0.4, "items": 7}, "bronze": {"device_s": 0.1, "items": 2}}))
    assert b.objective == "tenant_device_s_budget"
    assert b.detail == "gold" and b.observed == 0.4 and b.budget == 0.25
    assert b.as_attrs()["detail"] == "gold"


def test_each_overspending_tenant_breaches_separately():
    breaches = SloPolicy(tenant_device_s_budget=0.05).evaluate(_row(costs={
        "a": {"device_s": 0.1}, "b": {"device_s": 0.2}}))
    assert sorted(b.detail for b in breaches) == ["a", "b"]


def test_rows_without_costs_never_breach_the_tenant_budget():
    assert SloPolicy(tenant_device_s_budget=0.0).evaluate(_row()) == []


def test_device_mem_budget_judges_the_watermark_gauge():
    policy = SloPolicy(device_mem_budget_bytes=1000)
    (b,) = policy.evaluate(_row(gauges={"device_mem_bytes": 2048.0}))
    assert b.objective == "device_mem_budget_bytes" and b.observed == 2048.0
    assert policy.evaluate(_row(gauges={"device_mem_bytes": 512.0})) == []
    assert policy.evaluate(_row()) == []


def test_fleet_wide_breaches_carry_no_detail():
    b = SloBreach("p99_budget_s", 0.5, 0.1, 100.0)
    assert b.detail == "" and "detail" not in b.as_attrs()


# -- parity ------------------------------------------------------------------


def _random_row(rng):
    def maybe(v):
        return v if rng.random() < 0.8 else None

    counters = {k: int(rng.integers(0, 20)) for k in
                ("submitted", "completed", "shed", "rejected", "restarts", "trainer_restarts")
                if rng.random() < 0.7}
    gauges = {k: float(v) for k, v in (("staleness_s", maybe(rng.uniform(0, 200))),
                                       ("drift_score", maybe(rng.uniform(0, 6))),
                                       ("device_mem_bytes", maybe(rng.uniform(0, 4e9))))
              if v is not None}
    return {"ts": float(rng.uniform(0, 1e6)), "counters": counters, "gauges": gauges,
            "latency": {"p99": float(rng.uniform(0, 1))} if rng.random() < 0.8 else {},
            "queue_age": {"p99": float(rng.uniform(0, 0.5))} if rng.random() < 0.8 else {},
            "costs": {t: {"device_s": float(rng.uniform(0, 0.5))}
                      for t in ("gold", "silver", "bronze") if rng.random() < 0.6}}


@pytest.mark.parametrize("seed", range(4))
def test_the_same_rows_give_the_same_breaches_as_jax(seed):
    rng = np.random.default_rng(seed)
    budgets = dict(p99_budget_s=0.5, queue_age_p99_budget_s=0.2, max_shed_rate=0.3,
                   max_restart_burn=8, max_staleness_s=120.0, max_drift_score=3.0,
                   tenant_device_s_budget=0.25, device_mem_budget_bytes=2e9)
    port, ref = SloPolicy(**budgets), JSloPolicy(**budgets)
    total = 0
    for _ in range(60):
        row = _random_row(rng)
        got = [asdict(b) for b in port.evaluate(row)]
        want = [asdict(b) for b in ref.evaluate(row)]
        assert got == want
        total += len(got)
    assert total > 30
