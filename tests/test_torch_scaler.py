"""The breach-driven autoscaler on the port: the scenarios of the JAX
package's ``tests/autoscale/test_scaler.py`` driven through both packages'
``Autoscaler`` against one stub actuator each, with equal decision
sequences (action, verdict, reason, worker counts, slot, trigger; every
field but the unix stamp), equal actuator calls, counters and flight
instants; and that test's policy and evidence cases on the port."""

import time
from dataclasses import FrozenInstanceError

import pytest

import keystone_tpu.faults as jfaults
from keystone_tpu.autoscale import Autoscaler as JAutoscaler
from keystone_tpu.autoscale import ScalePolicy as JScalePolicy
from keystone_tpu.obs import flight as jflight
from keystone_tpu.serving.metrics import MetricsRegistry as JMetricsRegistry
from keystone_tpu.serving.slo import SloBreach as JSloBreach
from keystone_tpu_torch import faults
from keystone_tpu_torch.autoscale import Autoscaler, ScaleDecision, ScalePolicy
from keystone_tpu_torch.obs import flight
from keystone_tpu_torch.serving.metrics import MetricsRegistry
from keystone_tpu_torch.serving.slo import SloBreach

PORT = dict(Autoscaler=Autoscaler, ScalePolicy=ScalePolicy, Metrics=MetricsRegistry,
            Breach=SloBreach, faults=faults, flight=flight)
JAX = dict(Autoscaler=JAutoscaler, ScalePolicy=JScalePolicy, Metrics=JMetricsRegistry,
           Breach=JSloBreach, faults=jfaults, flight=jflight)


@pytest.fixture(autouse=True)
def clean():
    for side in (PORT, JAX):
        side["faults"].clear()
        side["flight"].reset()
    yield
    for side in (PORT, JAX):
        side["faults"].clear()
        side["flight"].reset()


class StubActuator:
    """The actuator verbs over plain counters: a tick sequence drives a
    tiny fleet with no processes (the JAX test's stub)."""

    def __init__(self, admitting=1, estimate=0.01):
        self.service_estimate = estimate
        self.admitting = admitting
        self.booting = 0
        self.draining = 0
        self.next_index = admitting
        self.calls = []

    def scale_view(self):
        return {"admitting": self.admitting, "booting": self.booting,
                "draining": self.draining}

    def scale_up_slot(self):
        idx = self.next_index
        self.next_index += 1
        self.booting += 1
        self.calls.append(("scale_up_slot", idx))
        return idx

    def pick_drain_candidate(self):
        return self.admitting - 1 if self.admitting > 0 else None

    def begin_drain(self, index):
        self.calls.append(("begin_drain", index))
        self.admitting -= 1
        self.draining += 1

    def reap_slot(self, index):
        self.calls.append(("reap_slot", index))
        self.booting = max(0, self.booting - 1)

    def finish_boots(self):
        self.admitting += self.booting
        self.booting = 0

    def finish_drains(self):
        self.draining = 0


FAST = dict(up_cooldown_s=0.0, down_cooldown_s=0.0, breach_window_s=60.0)

#: (policy, actuator, steps): a step is ("tick", n_breaches, queue_depth or
#: None), "boots", "drains", or ("plan", spec) / "clear" for the fault plan
SCENARIOS = {
    "cold_fleet": (dict(min_workers=2, **FAST), dict(admitting=0, estimate=None),
                   [("tick", 2, None)]),
    "two_breaches_buy_a_worker": (dict(up_breaches=2, **FAST), dict(admitting=1),
                                  [("tick", 1, None), ("tick", 1, None)]),
    "scale_up_clears_the_window": (dict(up_breaches=2, **FAST), dict(admitting=1),
                                   [("tick", 2, None), "boots", ("tick", 1, None),
                                    ("tick", 1, None)]),
    "up_cooldown": (dict(up_breaches=1, up_cooldown_s=3600.0, down_cooldown_s=0.0),
                    dict(admitting=1), [("tick", 1, None), "boots", ("tick", 1, None)]),
    "max_workers_ceiling": (dict(max_workers=3, up_breaches=1, **FAST), dict(admitting=3),
                            [("tick", 2, None)]),
    "below_min_restores": (dict(min_workers=2, **FAST), dict(admitting=1), [("tick", 0, None)]),
    "idle_ticks_drain": (dict(down_after_idle_ticks=3, **FAST), dict(admitting=3),
                         [("tick", 0, 0.0)] * 3),
    "loaded_tick_resets_idle": (dict(down_after_idle_ticks=2, **FAST), dict(admitting=3),
                                [("tick", 0, 0.0), ("tick", 0, 5.0), ("tick", 0, 0.0),
                                 ("tick", 0, 0.0)]),
    "min_workers_floor": (dict(down_after_idle_ticks=1, **FAST), dict(admitting=1),
                          [("tick", 0, 0.0)] * 5),
    "down_cooldown": (dict(down_after_idle_ticks=1, up_cooldown_s=0.0, down_cooldown_s=3600.0),
                      dict(admitting=4), [("tick", 0, 0.0), "drains"] + [("tick", 0, 0.0)] * 5),
    "up_then_down": (dict(up_breaches=1, down_after_idle_ticks=1, **FAST), dict(admitting=2),
                     [("tick", 1, None), "boots", ("tick", 0, 0.0)]),
    "kill_mid_scale_up": (dict(up_breaches=1, **FAST), dict(admitting=1),
                          [("plan", "scale.spawn=kill@0"), ("tick", 1, None), "clear",
                           ("tick", 1, None)]),
    "kill_mid_drain": (dict(down_after_idle_ticks=1, **FAST), dict(admitting=2),
                       [("plan", "scale.drain=kill@0"), ("tick", 0, 0.0), "clear"]),
}


def _breach(side):
    return side["Breach"](objective="queue_age_budget_s", observed=2.0, budget=1.0,
                          ts=time.time())


def _run(side, name):
    policy, act_kwargs, steps = SCENARIOS[name]
    act = StubActuator(**act_kwargs)
    metrics = side["Metrics"]()
    scaler = side["Autoscaler"](side["ScalePolicy"](**policy), act, metrics=metrics)
    ticks = []
    for step in steps:
        if step == "boots":
            act.finish_boots()
        elif step == "drains":
            act.finish_drains()
        elif step == "clear":
            side["faults"].clear()
        elif step[0] == "plan":
            side["faults"].install(side["faults"].parse_plan(step[1]))
        else:
            _, n, depth = step
            row = None if depth is None else {"gauges": {"queue_depth": depth}}
            made = scaler.tick([_breach(side) for _ in range(n)], row=row)
            ticks.append([{k: v for k, v in d.as_row().items() if k != "ts"} for d in made])
    return {
        "ticks": ticks,
        "calls": act.calls,
        "target": scaler.target_workers,
        "counters": {k: v for k, v in metrics.snapshot()["counters"].items()
                     if k.startswith("scale_")},
        "instants": [e["name"] for e in side["flight"].recorder().entries()
                     if e["name"].startswith("scale.")],
        "policy": scaler.describe()["policy"],
    }


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decision_sequences_equal_jax(name):
    mine, theirs = _run(PORT, name), _run(JAX, name)
    assert mine == theirs
    assert any(mine["ticks"]) or name in ("cold_fleet", "max_workers_ceiling",
                                          "min_workers_floor")


def test_policy_validates_bounds():
    for bad in (dict(min_workers=0), dict(min_workers=3, max_workers=2), dict(up_breaches=0),
                dict(down_after_idle_ticks=0)):
        with pytest.raises(ValueError):
            ScalePolicy(**bad)
        with pytest.raises(ValueError):
            JScalePolicy(**bad)


def test_policy_is_frozen_plain_data_equal_to_jax():
    p = ScalePolicy(min_workers=2, max_workers=8)
    with pytest.raises(FrozenInstanceError):
        p.max_workers = 99
    assert p.as_dict() == JScalePolicy(min_workers=2, max_workers=8).as_dict()
    assert ScalePolicy().as_dict() == JScalePolicy().as_dict()
    assert p.clamp(0) == 2 and p.clamp(100) == 8 and p.clamp(5) == 5


def test_decisions_land_as_counters_instants_and_rows():
    metrics = MetricsRegistry()
    act = StubActuator(admitting=2)
    scaler = Autoscaler(ScalePolicy(up_breaches=1, down_after_idle_ticks=1, **FAST), act,
                        metrics=metrics)
    scaler.tick([_breach(PORT)])
    act.finish_boots()
    scaler.tick(row={"gauges": {"queue_depth": 0.0}})
    counters = metrics.snapshot()["counters"]
    assert counters["scale_ups"] == 1 and counters["scale_downs"] == 1
    names = [e["name"] for e in flight.recorder().entries()]
    assert "scale.up" in names and "scale.down" in names
    rows = [d.as_row() for d in scaler.decisions]
    assert [r["action"] for r in rows] == ["up", "down"]
    assert all(isinstance(d, ScaleDecision) for d in scaler.decisions)
    desc = scaler.describe()
    assert desc["policy"]["up_breaches"] == 1 and len(desc["decisions"]) == 2


def test_scale_spans_when_traced():
    from keystone_tpu_torch.obs import tracer as trace_mod

    tracer = trace_mod.install(trace_mod.Tracer())
    try:
        act = StubActuator(admitting=1)
        Autoscaler(ScalePolicy(up_breaches=1, **FAST), act).tick([_breach(PORT)])
        (sp,) = [s for s in tracer.spans() if s.name.startswith("scale.")]
        assert sp.name == "scale.up" and sp.op_type == "Autoscaler"
        assert sp.attrs["reason"] == "breach" and sp.attrs["to_workers"] == 2
    finally:
        trace_mod.uninstall(tracer)


def test_resource_breaches_never_buy_scale_ups():
    """The autoscaler case of the JAX package's
    ``tests/serving/test_slo_budgets.py``: a tenant's spend or a memory
    watermark is no capacity shortage."""
    from keystone_tpu.autoscale.scaler import NON_CAPACITY_OBJECTIVES as J_NON_CAPACITY
    from keystone_tpu_torch.autoscale.scaler import NON_CAPACITY_OBJECTIVES

    assert NON_CAPACITY_OBJECTIVES == J_NON_CAPACITY == {
        "tenant_device_s_budget", "device_mem_budget_bytes"}

    class Actuator:
        service_estimate = 0.01

        def __init__(self):
            self.spawns = 0

        def scale_view(self):
            return {"admitting": 1, "booting": 0, "draining": 0}

        def scale_up_slot(self):
            self.spawns += 1
            raise RuntimeError("spawn refused (stub)")

        def pick_drain_candidate(self):
            return None

        def reap_slot(self, index):
            pass

    actuator = Actuator()
    scaler = Autoscaler(ScalePolicy(min_workers=1, max_workers=4, up_breaches=1,
                                    up_cooldown_s=0.0), actuator)
    row = {"gauges": {"queue_depth": 0.0}}
    breaches = [SloBreach("tenant_device_s_budget", 9.0, 1.0, 100.0, detail="gold"),
                SloBreach("device_mem_budget_bytes", 2e9, 1e9, 100.0)]
    assert scaler.tick(breaches=breaches, row=row) == []
    assert len(scaler._breach_window) == 0 and actuator.spawns == 0
    decisions = scaler.tick(breaches=[SloBreach("queue_age_p99_budget_s", 0.9, 0.1, 100.0)],
                            row=row)
    assert actuator.spawns == 1
    assert [(d.reason, d.ok) for d in decisions] == [("breach", False)]
