"""The always-on flight recorder in the port (``keystone_tpu_torch/obs/flight.py``):
every case of the JAX package's ``tests/obs/test_flight.py`` under its name
(the bounded ring, atomic JSON dumps, retention, the fault-site to
recovery-instant contract), and the Queue 3 repair held against the JAX
package: one ``KEYSTONE_FAULTS`` plan puts the same ``fault.inject``
instants into both packages' traces and flight rings, and the ``aot.read``
site's recovery instant into both rings."""

import json
import os
import threading

import pytest

import keystone_tpu.faults as jfaults
import keystone_tpu.obs.flight as jflight
import keystone_tpu_torch.faults as faults
from keystone_tpu.obs import tracer as jtracer_mod
from keystone_tpu_torch.obs import flight
from keystone_tpu_torch.obs import tracer as tracer_mod
from keystone_tpu_torch.obs.flight import (
    SITE_INSTANTS,
    FlightRecorder,
    dump,
    record_instant,
    record_span,
    recorder,
)


@pytest.fixture(autouse=True)
def _fresh_ring():
    """Each test judges its own window of the process's ring, with no fault
    plan or tracer left by another."""
    flight.reset()
    faults.clear()
    yield
    flight.reset()
    faults.clear()
    tracer_mod.reset()


def test_ring_is_bounded_and_ordered():
    rec = FlightRecorder(ring=8)
    for i in range(20):
        rec.record_span("serve.replica", 0.001 * i, seq=i)
    entries = rec.entries()
    assert len(entries) == 8
    # the ring keeps the newest window, oldest first
    assert [e["attrs"]["seq"] for e in entries] == list(range(12, 20))
    assert all(e["kind"] == "span" for e in entries)


def test_instants_and_spans_interleave_with_timestamps():
    rec = FlightRecorder(ring=16)
    rec.record_span("rpc.request", 0.5, worker=1)
    rec.record_instant("fault.worker_down", worker=1)
    a, b = rec.entries()
    assert a["kind"] == "span" and a["seconds"] == 0.5
    assert b["kind"] == "instant" and b["name"] == "fault.worker_down"
    assert b["t"] >= a["t"] > 0


def test_dump_is_valid_json_and_atomic(tmp_path):
    rec = FlightRecorder(ring=64)
    for i in range(70):
        rec.record_span("serve.replica", 0.002, replica=i % 2)
    rec.record_instant("fault.replica_down", replica=0)
    path = rec.dump("replica_quarantine", path=str(tmp_path / "f.json"))
    assert path is not None and os.path.exists(path)
    assert os.listdir(tmp_path) == ["f.json"]  # no torn temporary file left
    doc = json.loads(open(path).read())
    assert doc["trigger"] == "replica_quarantine"
    assert doc["pid"] == os.getpid()
    assert doc["ring_capacity"] == 64
    assert doc["dropped_before_window"] == 7  # 71 records into 64 slots
    assert len(doc["entries"]) == 64
    assert doc["entries"][-1]["name"] == "fault.replica_down"


def test_dump_default_dir_honors_env(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    rec = FlightRecorder(ring=4)
    rec.record_instant("slo.breach", objective="p99_budget_s")
    path = rec.dump("test_trigger")
    assert path is not None
    assert os.path.dirname(path) == str(tmp_path)
    assert "test_trigger" in os.path.basename(path)


def test_dump_failure_never_raises(tmp_path):
    rec = FlightRecorder(ring=4)
    rec.record_instant("x")
    missing = tmp_path / "no" / "such" / "dir" / "f.json"
    assert rec.dump("t", path=str(missing)) is None


def test_module_recorder_is_process_global_and_always_on():
    # no install step: recording works at once, and the module's helpers
    # share one ring
    record_span("serve.replica", 0.001, replica=0)
    record_instant("fault.inject", site="scan.chunk")
    names = [e["name"] for e in recorder().entries()]
    assert "serve.replica" in names and "fault.inject" in names


def test_concurrent_writers_never_lose_the_bound():
    rec = FlightRecorder(ring=32)

    def hammer(k):
        for i in range(200):
            rec.record_span("s", 0.0, k=k, i=i)

    threads = [threading.Thread(target=hammer, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.entries()) == 32


def _sites(plan_module):
    return {v for k, v in vars(plan_module).items()
            if k.isupper() and isinstance(v, str) and "." in v and k != "MAX_BACKOFF_S"}


def test_site_instants_covers_every_registered_fault_site():
    # every fault site constant of the port's faults/plan.py maps to a
    # recovery instant, and the map is the JAX package's
    import keystone_tpu.faults.plan as jplan
    import keystone_tpu_torch.faults.plan as plan

    sites = _sites(plan)
    assert sites, "no fault sites found: the reflection broke"
    assert sites <= set(SITE_INSTANTS), sites - set(SITE_INSTANTS)
    assert sites == _sites(jplan)
    assert SITE_INSTANTS == jflight.SITE_INSTANTS


def test_fault_point_records_into_flight_ring():
    faults.install(faults.parse_plan("scan.chunk=transient@0"))
    with pytest.raises(faults.FaultInjected):
        faults.fault_point("scan.chunk")
    hits = [e for e in recorder().entries()
            if e["name"] == "fault.inject" and e.get("attrs", {}).get("site") == "scan.chunk"]
    assert hits, recorder().entries()


def test_global_dump_writes_through_module_helper(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    record_instant("trainer.park", batch_start=0, batch_stop=2)
    path = dump("trainer_park")
    doc = json.loads(open(path).read())
    assert any(e["name"] == "trainer.park" for e in doc["entries"])
    assert doc["producer"] == "keystone_tpu_torch.obs.flight"


def test_auto_named_dumps_are_retention_bounded(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("KEYSTONE_FLIGHT_KEEP", "3")
    rec = FlightRecorder(ring=4)
    rec.record_instant("x")
    paths = []
    for i in range(6):
        paths.append(rec.dump(f"trigger{i}"))
        # distinct mtimes, so that oldest-first is well defined
        os.utime(paths[-1], (1_000_000 + i, 1_000_000 + i))
    assert all(p is not None for p in paths)
    kept = sorted(os.listdir(tmp_path))
    assert len(kept) == 3
    # the newest dumps stay; the oldest went first
    for p in paths[-3:]:
        assert os.path.basename(p) in kept
    for p in paths[:3]:
        assert os.path.basename(p) not in kept


def test_explicit_path_dumps_are_never_pruned(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("KEYSTONE_FLIGHT_KEEP", "2")
    rec = FlightRecorder(ring=4)
    rec.record_instant("x")
    # a caller's destination is an operator's file: retention manages the
    # auto-named files of the managed directory only
    for i in range(4):
        rec.dump("kept", path=str(tmp_path / f"keystone-flight-op{i}.json"))
    assert len(os.listdir(tmp_path)) == 4


# -- the Queue 3 repair: the same fault.inject instants as JAX -----------------

PLAN = "scan.chunk=transient@0,2;replica.batch=fatal@1"
CALLS = [("scan.chunk", {}), ("scan.chunk", {}), ("scan.chunk", {}),
         ("replica.batch", {"replica": 0}), ("replica.batch", {"replica": 0})]


def _inject_all(fault_point):
    """Every call of ``CALLS``, the raised error's class name or None each."""
    raised = []
    for site, attrs in CALLS:
        try:
            fault_point(site, **attrs)
            raised.append(None)
        except Exception as e:  # noqa: BLE001 — the injected errors are the data
            raised.append(type(e).__name__)
    return raised


def _inject_instants(spans):
    return [(s.name, s.op_type, dict(s.attrs)) for s in spans if s.name == "fault.inject"]


def _ring_instants(entries):
    return [(e["name"], e.get("attrs")) for e in entries if e["name"] == "fault.inject"]


def test_one_plan_gives_the_same_fault_inject_instants_as_jax():
    jflight.reset()
    jfaults.install(jfaults.parse_plan(PLAN))
    jtracer = jtracer_mod.install(jtracer_mod.Tracer())
    try:
        j_raised = _inject_all(jfaults.fault_point)
        j_spans = _inject_instants(jtracer.spans())
        j_ring = _ring_instants(jflight.recorder().entries())
    finally:
        jtracer_mod.reset()
        jfaults.clear()
        jflight.reset()
    faults.install(faults.parse_plan(PLAN))
    tracer = tracer_mod.install(tracer_mod.Tracer())
    raised = _inject_all(faults.fault_point)
    spans = _inject_instants(tracer.spans())
    ring = _ring_instants(recorder().entries())
    assert raised == j_raised == [
        "FaultInjected", None, "FaultInjected", None, "FatalFaultInjected"]
    assert spans == j_spans and len(spans) == 3
    assert ring == j_ring and len(ring) == 3
    assert spans[2] == ("fault.inject", "FaultPlan",
                        {"site": "replica.batch", "kind": "fatal", "replica": 0})


def test_an_aot_read_fault_records_its_recovery_instant_as_jax(tmp_path):
    """The ``aot.read`` site degrades to a miss in both packages' caches, and
    both rings hold the injection and ``SITE_INSTANTS["aot.read"]``."""
    from keystone_tpu.compile.cache import ExecutableCache as JCache
    from keystone_tpu_torch.compile.cache import ExecutableCache

    names = {}
    for pkg, cache, fl, fmod in (
            ("jax", JCache(str(tmp_path / "jax")), jflight, jfaults),
            ("torch", ExecutableCache(str(tmp_path / "torch")), flight, faults)):
        fl.reset()
        fmod.install(fmod.parse_plan("aot.read=transient@0"))
        try:
            assert cache.load("k" * 40) is None
            names[pkg] = [e["name"] for e in fl.recorder().entries()]
        finally:
            fmod.clear()
            fl.reset()
    assert names["torch"] == names["jax"] == ["fault.inject", SITE_INSTANTS["aot.read"]]


def test_a_retry_records_its_recovery_instant_when_traced():
    """``retry.attempt``, the scan seams' entry of ``SITE_INSTANTS``, lands in
    the trace as the JAX package's does: site, attempt, budget."""
    from keystone_tpu_torch.faults.retry import RetryBudget

    tracer = tracer_mod.install(tracer_mod.Tracer())
    budget = RetryBudget(budget=2, backoff_s=0.0, label="scan")
    assert budget.consume(faults.TransientError("flaky"), "scan.stage") == 0.0
    (sp,) = [s for s in tracer.spans() if s.name == SITE_INSTANTS["scan.stage"]]
    assert sp.op_type == "RetryBudget"
    assert (sp.attrs["site"], sp.attrs["attempt"], sp.attrs["budget"]) == ("scan.stage", 1, 2)

