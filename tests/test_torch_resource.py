"""Resource accounting in the port (``keystone_tpu_torch/obs/resource.py``):
every case of the JAX package's ``tests/obs/test_resource.py`` under its
name (the equal-split arithmetic, the ``KEYSTONE_ACCOUNTING`` switch, the
watermark's throttle and merge modes), the split held equal to the JAX
package's on the same batch, and the watermark's seams: a scan's end and a
served batch."""

from types import SimpleNamespace

import numpy as np
import pytest

from keystone_tpu.obs import resource as jresource
from keystone_tpu_torch.obs import resource
from keystone_tpu_torch.serving.metrics import MetricsRegistry


@pytest.fixture(autouse=True)
def _fresh_gate():
    resource.reset()
    yield
    resource.reset()


def _req(tenant=None, priority=None, enqueued=None, nbytes=0):
    datum = SimpleNamespace(nbytes=nbytes) if nbytes else None
    return SimpleNamespace(tenant=tenant, priority=priority, enqueued=enqueued, datum=datum)


# -- attribution ---------------------------------------------------------------


def test_split_is_equal_and_sums_reconstruct_device_seconds():
    reqs = [_req("gold", "high", enqueued=9.0), _req("gold", "high", enqueued=9.5),
            _req("bronze", enqueued=8.0)]
    table = resource.split_batch_cost(reqs, device_seconds=0.3, now=10.0)
    gold = table[("gold", "high")]
    bronze = table[("bronze", "normal")]
    assert gold["device_s"] == pytest.approx(0.2)
    assert bronze["device_s"] == pytest.approx(0.1)
    assert gold["items"] == 2 and bronze["items"] == 1
    assert sum(row["device_s"] for row in table.values()) == pytest.approx(0.3)
    # queue seconds are each member's wait, summed by identity
    assert gold["queue_s"] == pytest.approx(1.0 + 0.5)
    assert bronze["queue_s"] == pytest.approx(2.0)


def test_missing_identity_defaults_and_clamped_queue_wait():
    table = resource.split_batch_cost([_req(enqueued=99.0)], device_seconds=0.05, now=10.0)
    ((key, row),) = table.items()
    assert key == ("default", "normal")
    assert row["queue_s"] == 0.0  # clock skew never charges a negative wait


def test_payload_bytes_prefer_validated_rows():
    reqs = [_req("t", nbytes=100), _req("t", nbytes=100)]
    payloads = [SimpleNamespace(nbytes=64), SimpleNamespace(nbytes=32)]
    table = resource.split_batch_cost(reqs, device_seconds=0.0, now=0.0, payloads=payloads)
    assert table[("t", "normal")]["payload_bytes"] == 96


def test_payload_bytes_fall_back_to_the_datum():
    table = resource.split_batch_cost([_req("t", nbytes=128)], device_seconds=0.0, now=0.0)
    assert table[("t", "normal")]["payload_bytes"] == 128
    assert resource.payload_nbytes(b"abcd") == 4
    assert resource.payload_nbytes(None) == 0


def test_empty_batch_charges_nothing():
    assert resource.split_batch_cost([], 1.0, 0.0) == {}


def test_the_split_equals_jax_on_one_batch():
    rng = np.random.default_rng(4)
    rows = [rng.standard_normal(8).astype(np.float32) for _ in range(5)]
    reqs = [_req(t, p, enqueued=e, nbytes=n) for t, p, e, n in (
        ("a", "high", 1.0, 10), ("a", "high", 1.5, 20), (None, None, 2.0, 0),
        ("b", "low", 3.5, 40), ("a", "normal", 0.25, 8))]
    for payloads in (None, rows):
        got = resource.split_batch_cost(reqs, 0.37, 3.0, payloads=payloads)
        want = jresource.split_batch_cost(reqs, 0.37, 3.0, payloads=payloads)
        assert got == want


# -- the switch ----------------------------------------------------------------


def test_accounting_gate_defaults_on(monkeypatch):
    monkeypatch.delenv("KEYSTONE_ACCOUNTING", raising=False)
    resource.reset()
    assert resource.accounting_enabled() is True


def test_accounting_off_disables_sampling_and_gauges(monkeypatch):
    monkeypatch.setenv("KEYSTONE_ACCOUNTING", "0")
    resource.reset()
    assert resource.accounting_enabled() is False
    assert resource.sample_memory() == 0
    m = MetricsRegistry("w0")
    resource.install_memory_gauges(m)
    assert "device_mem_bytes" not in m.snapshot()["gauges"]


# -- the watermark -------------------------------------------------------------


def test_watermark_tracks_peak_and_throttles(monkeypatch):
    wm = resource.MemoryWatermark()
    monkeypatch.setattr(resource, "device_memory_bytes", lambda: (100, 1000))
    assert wm.sample() == 100
    assert wm.peak == 100 and wm.fraction() == pytest.approx(0.1)
    monkeypatch.setattr(resource, "device_memory_bytes", lambda: (40, 1000))
    # inside the throttle window the last reading is returned
    assert wm.sample(min_interval_s=3600.0) == 100
    assert wm.sample() == 40
    assert wm.peak == 100  # the high-water mark survives the drop


def test_fraction_unknown_without_a_limit(monkeypatch):
    wm = resource.MemoryWatermark()
    monkeypatch.setattr(resource, "device_memory_bytes", lambda: (100, 0))
    wm.sample()
    assert wm.fraction() is None


def test_device_memory_bytes_never_raises():
    live, limit = resource.device_memory_bytes()
    assert live >= 0 and limit >= 0
    # on the CPU: the process's resident bytes, no limit
    assert live > 0 and limit == 0


def test_install_memory_gauges_declares_honest_merge_modes():
    m = MetricsRegistry("w0")
    resource.install_memory_gauges(m)
    modes = m.snapshot()["gauge_modes"]
    assert modes["device_mem_bytes"] == "sum"
    assert modes["device_mem_peak_bytes"] == "max"
    assert modes["device_mem_fraction"] == "mean"


# -- the seams -----------------------------------------------------------------


def _counting(monkeypatch):
    reads = []
    monkeypatch.setattr(resource, "device_memory_bytes",
                        lambda: reads.append(1) or (1234, 0))
    return reads


def test_a_scan_samples_the_watermark_at_its_end(monkeypatch):
    from keystone_tpu_torch.data.chunked import ChunkedDataset

    reads = _counting(monkeypatch)
    X = np.arange(24, dtype=np.float32).reshape(12, 2)
    out = ChunkedDataset.from_array(X, 4).to_array()
    np.testing.assert_array_equal(out.numpy(), X)
    assert reads and resource.watermark().peak == 1234


def test_a_served_batch_samples_the_watermark_and_records_a_flight_span(monkeypatch):
    from keystone_tpu_torch.obs import flight
    from keystone_tpu_torch.serving import ServingEngine
    from tests.test_torch_fingerprint import build_toy

    reads = _counting(monkeypatch)
    flight.reset()
    rows = np.linspace(0.0, 1.0, 4 * 8, dtype=np.float32).reshape(4, 8)
    with ServingEngine(build_toy(), buckets=(1, 4)) as engine:
        answers = [engine.predict(r, timeout=60.0) for r in rows]
    assert len(answers) == 4 and reads
    spans = [e for e in flight.recorder().entries() if e["name"] == "serve.microbatch"]
    assert spans and sum(e["attrs"]["items"] for e in spans) == 4
    flight.reset()
