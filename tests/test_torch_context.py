"""The trace context and its sampling on the port: the context cases of
the JAX package's ``tests/obs/test_context.py`` run on
``keystone_tpu_torch.obs.context``, the two packages' samplers draw the
same positions and their contexts share one wire form; and a fleet
records a traced request's ``serve.queue`` span under its id. (The
stitching cases of that file, which test ``obs/export.py``'s cross-process
export, are in ``tests/test_torch_cluster_trace.py``.)"""

import os
import time

import numpy as np
import pytest

from keystone_tpu.obs.context import Sampler as JSampler
from keystone_tpu.obs.context import TraceContext as JTraceContext
from keystone_tpu.obs.context import new_trace_id as j_new_trace_id
from keystone_tpu_torch.obs import Sampler, TraceContext, new_trace_id, sample_rate


def test_trace_id_is_process_namespaced():
    a, b = new_trace_id(0), new_trace_id(1)
    assert a != b
    assert a.startswith(f"{os.getpid():x}-")
    assert [new_trace_id(k) for k in (0, 7, 4096)] == [j_new_trace_id(k) for k in (0, 7, 4096)]


def test_wire_round_trip_stamps_send_time():
    ctx = TraceContext("abc-1", hop="rpc.request")
    before = time.time()
    back = TraceContext.from_wire(ctx.to_wire())
    assert back.trace_id == "abc-1" and back.hop == "rpc.request"
    assert before <= back.sent_unix <= time.time()
    assert 0.0 <= back.transport_seconds() < 1.0


def test_the_wire_form_is_jax_s():
    """A context sent by either package is read back by the other."""
    enc = TraceContext("p-1", hop="serve.queue").to_wire()
    assert set(enc) == set(JTraceContext("p-1", hop="serve.queue").to_wire())
    back = JTraceContext.from_wire(enc)
    assert (back.trace_id, back.hop) == ("p-1", "serve.queue")
    port = TraceContext.from_wire(JTraceContext("j-2", hop="rpc.request").to_wire())
    assert (port.trace_id, port.hop) == ("j-2", "rpc.request")


def test_from_wire_tolerates_absence():
    assert TraceContext.from_wire(None) is None
    assert TraceContext.from_wire({}) is None
    assert TraceContext.from_wire({"hop": "x"}) is None


def test_sampler_is_deterministic_every_nth():
    s = Sampler(0.25)
    draws = [s.admit() for _ in range(12)]
    assert draws == [True, False, False, False] * 3
    fresh = Sampler(0.25)
    assert [fresh.admit() for _ in range(12)] == draws


def test_sampler_extremes():
    assert all(Sampler(1.0).admit() for _ in range(8))
    assert not any(Sampler(0.0).admit() for _ in range(8))


@pytest.mark.parametrize("rate", [0.0, 0.01, 0.1, 0.3, 0.33, 0.5, 0.7, 1.0])
def test_sampler_draws_the_positions_jax_draws(rate):
    port, ref = Sampler(rate), JSampler(rate)
    assert [port.admit() for _ in range(200)] == [ref.admit() for _ in range(200)]


def test_sample_rate_env_knob(monkeypatch):
    monkeypatch.delenv("KEYSTONE_TRACE_SAMPLE", raising=False)
    assert sample_rate() == 1.0
    monkeypatch.setenv("KEYSTONE_TRACE_SAMPLE", "0.1")
    assert sample_rate() == 0.1
    monkeypatch.setenv("KEYSTONE_TRACE_SAMPLE", "7")
    assert sample_rate() == 1.0  # clamped


def test_a_fleet_records_a_traced_request_s_queue_span_under_its_id():
    from keystone_tpu_torch.obs import tracer as obs_tracer
    from keystone_tpu_torch.serving import ServingFleet
    from keystone_tpu_torch.workflow.transformer import FunctionNode

    fitted = FunctionNode(batch_fn=lambda X: X * 2.0, label="double").to_pipeline().fit()
    tr = obs_tracer.install(obs_tracer.Tracer())
    try:
        with ServingFleet(fitted, replicas=2, buckets=(1, 4), datum_shape=(3,)) as fleet:
            traced = fleet.submit(np.ones(3, np.float32), timeout=30.0,
                                  trace=TraceContext(new_trace_id(1), hop="rpc.request"))
            plain = fleet.submit(np.ones(3, np.float32), timeout=30.0)
            np.testing.assert_allclose(traced.result(timeout=30), 2.0)
            np.testing.assert_allclose(plain.result(timeout=30), 2.0)
    finally:
        obs_tracer.uninstall(tr)
    queue = [s for s in tr.spans() if s.name == "serve.queue"]
    assert [s.attrs["trace_id"] for s in queue] == [new_trace_id(1)]
    assert queue[0].op_type == "FleetScheduler" and queue[0].end >= queue[0].start
    batches = [s for s in tr.spans() if s.name == "serve.replica"]
    assert any(s.attrs.get("trace_id") == new_trace_id(1) for s in batches)
