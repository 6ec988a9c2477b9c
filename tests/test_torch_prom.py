"""The Prometheus exposition on the port: ``render_prometheus`` byte-equal
to the JAX package's for the snapshots of ``tests/obs/test_prom.py`` (the
same dict through both renderers, and each package's registry loaded the
same way through its own), and that test's cases on
``keystone_tpu_torch.obs.prom`` (format validity, name and label escaping,
monotone counters, the scrape server)."""

import threading
import urllib.error
import urllib.request

import pytest

from keystone_tpu.obs import prom as jprom
from keystone_tpu.serving.metrics import MetricsRegistry as JMetricsRegistry
from keystone_tpu_torch.obs.prom import (
    CONTENT_TYPE,
    KNOWN_COUNTERS,
    PrometheusExporter,
    escape_label_value,
    render_prometheus,
    sanitize_metric_name,
)
from keystone_tpu_torch.serving.metrics import MetricsRegistry
from tests.obs.test_prom import parse_exposition


def _load(m):
    m.inc("submitted", 10)
    m.inc("completed", 9)
    m.inc("shed.low", 2)
    m.inc("tenant.served.acme", 4)
    m.inc("slo_breach.p99_budget_s", 1)
    m.inc("wire.frames.req", 3)
    m.inc("wire.bytes_sent.req", 4096)
    m.set_gauge("queue_depth", lambda: 3.0)
    m.observe_cost("acme", "high", device_s=0.5, queue_s=0.1, payload_bytes=2048, items=4)
    m.observe_latency(0.01, priority="high")
    m.observe_queue_age(0.002)
    m.observe_batch(6, 8, replica=0)
    return m


def _hostile(m):
    m.observe_cost('ten"ant\n\\evil', "nor mal", device_s=0.1, items=1)
    return m


def _snapshots(cls):
    """The snapshots of the JAX test, each from a fresh ``cls`` registry."""
    loaded = _load(cls("w0"))
    return {
        "empty": cls("w0").snapshot(),
        "loaded": loaded.snapshot(),
        "hostile": _hostile(cls("w0")).snapshot(),
        "merged": cls.merge([loaded.snapshot(sketches=True), loaded.snapshot(sketches=True)]),
    }


@pytest.mark.parametrize("name", ["empty", "loaded", "hostile", "merged"])
@pytest.mark.parametrize("prefix", ["keystone", "ks-fleet.2"])
def test_render_is_byte_equal_to_jax(name, prefix):
    snap = _snapshots(MetricsRegistry)[name]
    text = render_prometheus(snap, prefix=prefix)
    assert text == jprom.render_prometheus(snap, prefix=prefix)
    # each package's registry, loaded the same way, renders the same text
    assert text == jprom.render_prometheus(_snapshots(JMetricsRegistry)[name], prefix=prefix)
    parse_exposition(text)


def test_vocabulary_equals_jax():
    assert KNOWN_COUNTERS == jprom.KNOWN_COUNTERS and CONTENT_TYPE == jprom.CONTENT_TYPE
    for raw in ("tenant.served.acme", "a-b c", "9lives", "", "ok_name:x"):
        assert sanitize_metric_name(raw) == jprom.sanitize_metric_name(raw)


def test_sanitize_metric_name():
    assert sanitize_metric_name("tenant.served.acme") == "tenant_served_acme"
    assert sanitize_metric_name("a-b c") == "a_b_c"
    assert sanitize_metric_name("9lives") == "_9lives"
    assert sanitize_metric_name("") == "_"
    assert sanitize_metric_name("ok_name:x") == "ok_name:x"


def test_escape_label_value():
    assert escape_label_value('a"b') == 'a\\"b'
    assert escape_label_value("a\\b") == "a\\\\b"
    assert escape_label_value("a\nb") == "a\\nb"
    assert escape_label_value(7) == "7"


def test_hostile_identity_values_render_validly():
    text = render_prometheus(_hostile(MetricsRegistry("w0")).snapshot())
    parse_exposition(text)
    assert '\\"' in text and "\\n" in text


def test_counters_render_as_total_families_with_type_lines():
    text = render_prometheus(_load(MetricsRegistry("w0")).snapshot())
    samples = parse_exposition(text)
    assert samples["keystone_submitted_total"] == 10
    assert samples["keystone_completed_total"] == 9
    assert "# TYPE keystone_submitted_total counter" in text
    assert "# TYPE keystone_queue_depth gauge" in text


def test_dotted_counters_become_labeled_families():
    samples = parse_exposition(render_prometheus(_load(MetricsRegistry("w0")).snapshot()))
    assert samples['keystone_shed_by_priority_total{priority="low"}'] == 2
    assert samples['keystone_tenant_served_total{tenant="acme"}'] == 4
    assert samples['keystone_slo_breach_total{objective="p99_budget_s"}'] == 1
    assert samples['keystone_wire_frames_total{kind="req"}'] == 3


def test_cost_table_renders_four_labeled_families():
    samples = parse_exposition(render_prometheus(_load(MetricsRegistry("w0")).snapshot()))
    labels = '{tenant="acme",priority="high"}'
    assert samples[f"keystone_tenant_device_seconds_total{labels}"] == 0.5
    assert samples[f"keystone_tenant_queue_seconds_total{labels}"] == 0.1
    assert samples[f"keystone_tenant_payload_bytes_total{labels}"] == 2048
    assert samples[f"keystone_tenant_items_total{labels}"] == 4


def test_summaries_carry_quantiles_count_and_sum():
    text = render_prometheus(_load(MetricsRegistry("w0")).snapshot())
    samples = parse_exposition(text)
    assert "# TYPE keystone_latency_seconds summary" in text
    assert samples['keystone_latency_seconds{quantile="0.99"}'] == 0.01
    assert samples["keystone_latency_seconds_count"] == 1
    assert samples['keystone_priority_latency_seconds{priority="high",quantile="0.5"}'] == 0.01


def test_merged_snapshot_renders_with_merge_width():
    m = _load(MetricsRegistry("w0"))
    merged = MetricsRegistry.merge([m.snapshot(sketches=True), m.snapshot(sketches=True)])
    samples = parse_exposition(render_prometheus(merged))
    assert samples["keystone_merged_processes"] == 2
    assert samples["keystone_submitted_total"] == 20


def test_counters_are_monotone_across_scrapes():
    m = _load(MetricsRegistry("w0"))
    seen = []
    for _ in range(5):
        samples = parse_exposition(render_prometheus(m.snapshot()))
        seen.append({k: v for k, v in samples.items() if k.endswith("_total")})
        m.inc("submitted")
        m.observe_cost("acme", "high", device_s=0.25, items=1)
    for before, after in zip(seen, seen[1:]):
        for key, value in before.items():
            assert after.get(key, 0.0) >= value, key


def test_scrape_under_concurrent_mutation_stays_valid():
    m = _load(MetricsRegistry("w0"))
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            m.inc("submitted")
            m.observe_cost(f"t{i % 3}", device_s=0.001, items=1)
            m.observe_latency(0.001)
            i += 1

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for _ in range(20):
            parse_exposition(render_prometheus(m.snapshot()))
    finally:
        stop.set()
        for t in threads:
            t.join()


def test_http_exporter_round_trip():
    m = _load(MetricsRegistry("w0"))
    exporter = PrometheusExporter(lambda: m.snapshot(), port=0)
    host, port = exporter.start()
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=5) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == CONTENT_TYPE
            body = resp.read().decode("utf-8")
        assert body == render_prometheus(m.snapshot())
        assert parse_exposition(body)["keystone_submitted_total"] == 10
        assert exporter.start() == (host, port)
    finally:
        exporter.stop()
    assert exporter.address is None


def test_http_exporter_404_off_path_and_500_on_snapshot_failure():
    exporter = PrometheusExporter(MetricsRegistry("w0").snapshot, port=0)
    host, port = exporter.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://{host}:{port}/nope", timeout=5)
        assert e.value.code == 404
    finally:
        exporter.stop()

    def broken():
        raise RuntimeError("stats hub down")

    exporter = PrometheusExporter(broken, port=0)
    host, port = exporter.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=5)
        assert e.value.code == 500
    finally:
        exporter.stop()
