"""Cross-process trace stitching on the port: the stitching cases of the
JAX package's ``tests/obs/test_context.py`` (``stitch_chrome_trace``,
``wire_spans``, trace ids, the sampler) on ``keystone_tpu_torch.obs``, the
stitched document equal to the JAX package's for the same span sets, and
the cases of ``tests/cluster/test_trace_propagation.py`` through a real
traced 2-worker ``ClusterRouter`` on ``device="cpu"``: one request's hops
across three process tracks under one trace id, the stitched export's
process and thread tracks, per-process timelines in ``status()``, the
sampling knob, and one scrape of the Prometheus plane whose merged
request counter equals the requests answered."""

import json
import os
import time
import urllib.request
from collections import defaultdict

import numpy as np
import pytest

from keystone_tpu.obs.export import stitch_chrome_trace as jstitch_chrome_trace
from keystone_tpu.obs.export import wire_spans as jwire_spans
from keystone_tpu_torch.cluster import ClusterRouter, format_status
from keystone_tpu_torch.obs import tracer as trace_mod
from keystone_tpu_torch.obs.context import Sampler, TraceContext, new_trace_id
from keystone_tpu_torch.obs.export import stitch_chrome_trace, wire_spans
from keystone_tpu_torch.obs.span import Span
from tests.obs.test_prom import parse_exposition

D = 32
STALL_S = 0.002
ROUTER_HOPS = {"rpc.admission", "rpc.send", "rpc.request"}
WORKER_HOPS = {"cluster.handle", "serve.queue", "serve.replica"}


def _span_sets():
    base = 1000.0
    router = [{
        "name": "rpc.request", "start_unix": base, "dur_s": 0.010, "instant": False,
        "pid": 100, "tid": 1, "thread_name": "main", "process_name": "keystone:router/100",
        "args": {"trace_id": "64-0"},
    }]
    worker = [
        {"name": "serve.replica", "start_unix": base + 0.004, "dur_s": 0.005,
         "instant": False, "pid": 200, "tid": 9, "thread_name": "replica-0",
         "process_name": "keystone:worker-0/200", "args": {"trace_id": "64-0"}},
        {"name": "fault.replica_down", "start_unix": base + 0.009, "dur_s": 0.0,
         "instant": True, "pid": 200, "tid": 9, "thread_name": "replica-0",
         "process_name": "keystone:worker-0/200", "args": {}},
    ]
    return router, worker


# -- tests/obs/test_context.py's stitching cases ----------------------------


def test_stitch_builds_per_process_tracks():
    router, worker = _span_sets()
    doc = stitch_chrome_trace([router, worker])
    ev = doc["traceEvents"]
    meta = [e for e in ev if e["ph"] == "M"]
    assert {(e["name"], e["pid"]) for e in meta} >= {
        ("process_name", 100), ("process_name", 200), ("thread_name", 100),
        ("thread_name", 200)}
    xs = [e for e in ev if e["ph"] == "X"]
    assert {e["pid"] for e in xs} == {100, 200}
    assert {e["args"]["trace_id"] for e in xs} == {"64-0"}
    assert min(e["ts"] for e in xs) == 0.0
    ts = [e["ts"] for e in ev]
    assert all(b >= a for a, b in zip(ts, ts[1:]))
    inst = [e for e in ev if e["ph"] == "i"]
    assert inst and inst[0]["name"] == "fault.replica_down"


@pytest.mark.parametrize("base_unix", [None, 999.5])
def test_stitched_document_equals_jax(base_unix):
    sets = list(_span_sets())
    mine = stitch_chrome_trace(sets, base_unix=base_unix)
    theirs = jstitch_chrome_trace(sets, base_unix=base_unix)
    assert mine["otherData"].pop("producer") == "keystone_tpu_torch.obs (stitched)"
    theirs["otherData"].pop("producer")
    assert mine == theirs


def test_wire_spans_rebase_onto_unix_clock_as_jax():
    sp = Span(name="serve.queue", start=501.5, end=501.75, tid=7, thread_name="w",
              op_type="ServingFleet", attrs={"trace_id": "a-1", "queue_age_s": 0.25})
    (w,) = wire_spans([sp], 500.0, 2000.0, process_name="p")
    assert w["start_unix"] == 2001.5 and abs(w["dur_s"] - 0.25) < 1e-9
    assert w["args"]["trace_id"] == "a-1"
    assert w["pid"] == os.getpid() and w["process_name"] == "p"
    from keystone_tpu.obs.span import Span as JSpan

    jsp = JSpan(name="serve.queue", start=501.5, end=501.75, tid=7, thread_name="w",
                op_type="ServingFleet", attrs={"trace_id": "a-1", "queue_age_s": 0.25})
    assert jwire_spans([jsp], 500.0, 2000.0, process_name="p") == [w]


def test_trace_context_and_sampler():
    a, b = new_trace_id(0), new_trace_id(1)
    assert a != b and a.startswith(f"{os.getpid():x}-")
    back = TraceContext.from_wire(TraceContext("abc-1", hop="rpc.request").to_wire())
    assert back.trace_id == "abc-1" and 0.0 <= back.transport_seconds() < 1.0
    s = Sampler(0.25)
    assert [s.admit() for _ in range(8)] == [True, False, False, False] * 2


def test_tracer_ships_each_span_once_and_stays_bounded():
    t = trace_mod.Tracer()
    for i in range(5):
        t.instant(f"s{i}")
    fresh, cur = t.spans_since(0)
    assert [s.name for s in fresh] == ["s0", "s1", "s2", "s3", "s4"] and cur == 5
    assert t.discard_through(cur) == 5 and t.spans() == []
    t.instant("s5")
    fresh, cur = t.spans_since(cur)
    assert [s.name for s in fresh] == ["s5"] and cur == 6


# -- tests/cluster/test_trace_propagation.py through real workers -------------


@pytest.fixture(scope="module")
def tracer():
    prev = trace_mod.stop()
    t = trace_mod.install(trace_mod.Tracer())
    yield t
    trace_mod.stop()
    if prev is not None:
        trace_mod.install(prev)


@pytest.fixture(scope="module")
def router(tracer):
    r = ClusterRouter(
        ("factory", "keystone_tpu_torch.cluster.demo:build_stall_model",
         {"d": D, "stall_s": STALL_S}),
        workers=2, device="cpu", replicas_per_worker=1, buckets=(8,), datum_shape=(D,),
        max_wait_ms=1.0, spawn_timeout_s=180, health_interval_s=0.25, drain_timeout_s=5.0,
        join_timeout_s=3.0, trace_sample=1.0, metrics_port=0)
    r.start()
    yield r
    r.shutdown(drain=False)


@pytest.fixture(scope="module")
def data():
    return np.random.RandomState(0).randn(16, D).astype(np.float32)


def _events_by_trace(span_sets):
    by_trace = defaultdict(list)
    for spans in span_sets:
        for s in spans:
            tid = (s.get("args") or {}).get("trace_id")
            if tid:
                by_trace[tid].append(s)
    return by_trace


def test_a_one_request_stitches_across_three_hops(router, data):
    router.predict(data[0], timeout=30.0)
    deadline = time.monotonic() + 10.0
    while True:
        by_trace = _events_by_trace(router.collect_trace(timeout=10.0))
        if by_trace:
            tid, spans = max(by_trace.items(), key=lambda kv: len({s["name"] for s in kv[1]}))
            names = {s["name"] for s in spans}
            if names >= ROUTER_HOPS | WORKER_HOPS:
                break
        if time.monotonic() >= deadline:
            break
        time.sleep(0.1)
    assert by_trace, "no trace ids propagated"
    assert names >= ROUTER_HOPS | WORKER_HOPS, names
    assert len({s["pid"] for s in spans}) >= 2
    handle = next(s for s in spans if s["name"] == "cluster.handle")
    assert handle["args"]["transport_s"] >= 0.0
    queue = next(s for s in spans if s["name"] == "serve.queue")
    assert queue["args"]["queue_age_s"] >= 0.0
    rpc = next(s for s in spans if s["name"] == "rpc.request")
    assert rpc["args"]["reply_transport_s"] >= 0.0 and rpc["args"]["ok"] is True
    lo, hi = rpc["start_unix"] - 0.05, rpc["start_unix"] + rpc["dur_s"] + 0.05
    for s in spans:
        assert lo <= s["start_unix"] <= hi, (s["name"], s, rpc)


def test_b_stitched_export_has_process_tracks(router, data, tmp_path):
    router.predict(data[1], timeout=30.0)
    doc = json.loads(open(router.export_trace(str(tmp_path / "stitched.json"))).read())
    ev = doc["traceEvents"]
    proc_meta = {e["pid"]: e["args"]["name"] for e in ev if e["name"] == "process_name"}
    assert len(proc_meta) >= 3, proc_meta
    assert any("router" in n for n in proc_meta.values())
    assert sum("worker" in n for n in proc_meta.values()) >= 2
    assert len({p for p, _ in ((e["pid"], e["tid"]) for e in ev
                               if e["name"] == "thread_name")}) >= 2
    ts = [e["ts"] for e in ev]
    assert all(b >= a for a, b in zip(ts, ts[1:])) and all(t >= 0.0 for t in ts)


def test_c_status_renders_per_process_timelines(router, data):
    router.predict(data[2], timeout=30.0)
    deadline = time.monotonic() + 15.0
    status = router.status(timeout=10.0)
    while time.monotonic() < deadline:
        tl = status["timelines"]
        if {"worker-0", "worker-1", "cluster-router"} <= set(tl) and all(
                tl[k] for k in ("worker-0", "worker-1", "cluster-router")):
            break
        time.sleep(0.3)
        status = router.status(timeout=10.0)
    tl = status["timelines"]
    assert {"worker-0", "worker-1", "cluster-router"} <= set(tl), tl.keys()
    assert {"ts", "counters", "gauges", "latency", "queue_age"} <= set(tl["cluster-router"][-1])
    assert status["live_workers"] == 2 and [w["index"] for w in status["workers"]] == [0, 1]
    assert status["counters"].get("completed", 0) >= 1
    text = format_status(status)
    assert "timeline [worker-0]" in text and "workers 2/2" in text


def test_d_sampling_knob_bounds_span_production(router, data, tracer):
    router._sampler = Sampler(0.5)
    try:
        _, cursor = tracer.spans_since(0)
        for i in range(4):
            router.predict(data[3 + i], timeout=30.0)
        fresh, _ = tracer.spans_since(cursor)
        assert len([s for s in fresh if s.name == "rpc.request"]) == 2
    finally:
        router._sampler = Sampler(1.0)


def test_e_one_scrape_shows_the_merged_request_counter(router, data):
    for i in range(3):
        router.predict(data[i], timeout=30.0)
    answered = router.metrics.count("completed")
    host, port = router.metrics_address
    with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as resp:
        samples = parse_exposition(resp.read().decode("utf-8"))
    assert samples["keystone_completed_total"] == answered
    assert samples["keystone_merged_processes"] == 3  # the router and two workers
