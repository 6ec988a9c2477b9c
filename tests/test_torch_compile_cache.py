"""The port's executable cache, manifest, compile ledger and ``aot.read``
fault seam (``keystone_tpu_torch/compile/cache.py``, ``manifest.py``,
``obs/ledger.py``): every case of the JAX package's
``tests/compile/test_cache.py``, ``test_manifest.py`` (its engine half),
``tests/obs/test_ledger.py`` and ``tests/faults/test_aot_read.py``, run
through both packages, which are host-only file work here. The frame is
the same bytes in both, so an entry the JAX package writes into the
port's directory is read as an environment miss and left on disk.
"""

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import keystone_tpu.compile as jcompile
import keystone_tpu.compile.cache as jcache
import keystone_tpu.compile.manifest as jmanifest
import keystone_tpu.faults as jfaults
import keystone_tpu.obs.ledger as jledger
import keystone_tpu_torch.compile as tcompile
import keystone_tpu_torch.compile.cache as tcache
import keystone_tpu_torch.compile.manifest as tmanifest
import keystone_tpu_torch.faults as tfaults
import keystone_tpu_torch.obs.ledger as tledger
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": SimpleNamespace(cache=jcache, manifest=jmanifest, ledger=jledger, faults=jfaults,
                           compile=jcompile, name="keystone_tpu"),
    "port": SimpleNamespace(cache=tcache, manifest=tmanifest, ledger=tledger, faults=tfaults,
                            compile=tcompile, name="keystone_tpu_torch"),
}

ENV = {"jax": "0.0.1", "backend": "cpu"}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def clean():
    for p in PKGS.values():
        p.faults.clear()
        p.compile.reset()
    PipelineEnv.get_or_create().reset()
    yield
    for p in PKGS.values():
        p.faults.clear()
        p.compile.reset()
    PipelineEnv.get_or_create().reset()


def _store(cache, key, payload=b"payload-bytes", env=ENV, **extra):
    return cache.store(key, payload, {"env": dict(env), **extra})


# ---------------------------------------------------------------------------
# tests/compile/test_cache.py
# ---------------------------------------------------------------------------


def test_round_trip(pkg, tmp_path):
    cache = pkg.cache.ExecutableCache(str(tmp_path))
    _store(cache, "k1", b"blob", trace_seconds=1.5)
    entry = cache.load("k1", expect_env=ENV)
    assert entry is not None
    assert entry.payload == b"blob"
    assert entry.header["trace_seconds"] == 1.5
    assert entry.header["env"] == ENV


def test_absent_key_is_a_miss(pkg, tmp_path):
    assert pkg.cache.ExecutableCache(str(tmp_path)).load("nope", expect_env=ENV) is None


def test_corrupted_payload_is_discarded(pkg, tmp_path):
    cache = pkg.cache.ExecutableCache(str(tmp_path))
    path = _store(cache, "k1", b"x" * 256)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"ROT!")
    assert cache.load("k1", expect_env=ENV) is None
    assert not os.path.exists(path)


def test_truncated_entry_is_discarded(pkg, tmp_path):
    cache = pkg.cache.ExecutableCache(str(tmp_path))
    path = _store(cache, "k1", b"x" * 256)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 10)
    assert cache.load("k1", expect_env=ENV) is None
    assert not os.path.exists(path)


def test_environment_mismatch_is_a_miss_not_a_crash(pkg, tmp_path):
    """Another toolchain's entry never loads and is not deleted: its own
    toolchain may still want it."""
    cache = pkg.cache.ExecutableCache(str(tmp_path))
    path = _store(cache, "k1", env={"jax": "0.0.0", "backend": "cpu"})
    assert cache.load("k1", expect_env=ENV) is None
    assert os.path.exists(path)
    assert cache.load("k1", expect_env={"jax": "0.0.0", "backend": "cpu"})


def test_renamed_entry_is_rejected(pkg, tmp_path):
    cache = pkg.cache.ExecutableCache(str(tmp_path))
    _store(cache, "k1")
    os.rename(cache.entry_path("k1"), cache.entry_path("k2"))
    assert cache.load("k2", expect_env=ENV) is None


def test_lru_eviction_respects_recency_and_keeps_newest(pkg, tmp_path):
    payload = b"x" * 1000
    cache = pkg.cache.ExecutableCache(str(tmp_path), max_bytes=2500)
    _store(cache, "a", payload)
    time.sleep(0.02)
    _store(cache, "b", payload)
    time.sleep(0.02)
    assert cache.load("a", expect_env=ENV)  # a is now more recent than b
    time.sleep(0.02)
    _store(cache, "c", payload)  # over the bound: the oldest (b) goes
    keys = {k for k, _, _ in cache.entries()}
    assert "c" in keys, "the entry just written is never evicted"
    assert "a" in keys and "b" not in keys
    assert cache.total_bytes() <= 2500


def test_no_temp_files_left_behind(pkg, tmp_path):
    cache = pkg.cache.ExecutableCache(str(tmp_path))
    _store(cache, "k1")
    _store(cache, "k1", b"replacement")  # an overwrite is atomic too
    leftovers = [n for n in os.listdir(cache.entries_dir) if n.startswith(".tmp")]
    assert leftovers == []
    assert cache.load("k1", expect_env=ENV).payload == b"replacement"


def test_default_bound_and_env_knob(pkg, tmp_path, monkeypatch):
    assert pkg.cache.ExecutableCache(str(tmp_path / "a")).max_bytes == 1 << 30
    monkeypatch.setenv("KEYSTONE_AOT_CACHE_BYTES", "4096")
    assert pkg.cache.ExecutableCache(str(tmp_path / "b")).max_bytes == 4096


_WORKER = r"""
import sys
from {mod}.compile.cache import ExecutableCache

root, seed = sys.argv[1], int(sys.argv[2])
cache = ExecutableCache(root, max_bytes=1 << 20)
env = {{"jax": "0.0.1", "backend": "cpu"}}
payload = (b"%d-" % seed) * 64
for i in range(40):
    key = "shared-%d" % (i % 4)
    cache.store(key, payload, {{"env": env, "writer": seed}})
    got = cache.load(key, expect_env=env)
    # a concurrent writer may have replaced it, but a load is a clean miss
    # or a COMPLETE entry from some writer, never torn bytes
    if got is not None:
        first = got.payload[:2]
        assert first in (b"1-", b"2-"), got.payload[:8]
        assert got.payload == first * 64
print("OK")
"""


def test_two_process_concurrent_read_write(tmp_path):
    """A JAX process and a port process store and load the same keys in one
    directory at once: every load is a complete entry or a miss."""
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER.format(mod=mod), str(tmp_path), str(seed)],
            cwd=_REPO_ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for seed, mod in ((1, "keystone_tpu"), (2, "keystone_tpu_torch"))
    ]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "OK"


def test_the_frame_is_the_same_bytes_in_both_packages(tmp_path):
    """The same key, payload and header make the same file in both."""
    header = {"env": ENV, "created_unix": 1.0}
    paths = [PKGS[k].cache.ExecutableCache(str(tmp_path / k)).store("k1", b"blob", header)
             for k in ("jax", "port")]
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1]


def test_a_jax_entry_is_an_environment_miss_left_on_disk(tmp_path):
    """An entry the JAX package wrote into the port's directory, under the
    key the port asks for: the port's environment key differs (torch,
    CUDA, device name and capability against jax, jaxlib and device kind),
    so the load is a miss, and the entry stays for its own toolchain."""
    port_env = tcompile.environment_key(torch.device("cpu"))
    jax_env = {"format": "1", "jax": "0.4", "jaxlib": "0.4", "backend": "cpu",
               "device_kind": "cpu"}
    key = tcompile.entry_key("a" * 64, (8, 4), "float32", port_env)
    path = jcache.ExecutableCache(str(tmp_path)).store(key, b"stablehlo", {"env": jax_env})
    cache = tcache.ExecutableCache(str(tmp_path))
    assert cache.load(key, expect_env=port_env) is None
    assert os.path.exists(path)
    assert jcache.ExecutableCache(str(tmp_path)).load(key, expect_env=jax_env) is not None
    assert set(port_env) == {"format", "torch", "cuda", "backend", "device_name", "capability"}
    assert port_env["backend"] == "cpu" and port_env["torch"] == torch.__version__


def test_an_unusable_directory_turns_aot_off(pkg, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    assert pkg.compile.configure(str(blocker / "aot")) is None
    assert pkg.compile.get_cache() is None


def test_get_cache_honors_the_environment(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_AOT_CACHE", str(tmp_path / "aot"))
    pkg.compile.reset()
    cache = pkg.compile.get_cache()
    assert cache is not None and cache.root == str(tmp_path / "aot")
    pkg.compile.configure("")
    assert pkg.compile.get_cache() is None


def test_the_port_layers_no_xla_cache(tmp_path):
    cache = tcompile.configure(str(tmp_path / "aot"))
    assert sorted(os.listdir(cache.root)) == ["entries"]
    assert not hasattr(cache, "xla_cache_dir")


# ---------------------------------------------------------------------------
# tests/compile/test_manifest.py
# ---------------------------------------------------------------------------


@pytest.fixture
def mcache(pkg, tmp_path):
    return pkg, pkg.cache.ExecutableCache(str(tmp_path / "aot"))


def test_record_and_list_round_trip(mcache):
    pkg, cache = mcache
    pkg.manifest.record_export(cache, "digA", (8, 4), "float32")
    pkg.manifest.record_export(cache, "digA", (32, 4), "float32")
    pkg.manifest.record_export(cache, "digB", (8, 2), "float32")
    assert pkg.manifest.exported_signatures(cache, "digA") == [
        ((8, 4), "float32"), ((32, 4), "float32")]
    assert pkg.manifest.exported_signatures(cache, "digB") == [((8, 2), "float32")]
    assert pkg.manifest.exported_signatures(cache, "missing") == []


def test_record_is_idempotent(mcache):
    pkg, cache = mcache
    for _ in range(3):
        pkg.manifest.record_export(cache, "digA", (8, 4), "float32")
    d = os.path.join(cache.root, "manifest", "digA")
    assert len(os.listdir(d)) == 1
    assert pkg.manifest.exported_signatures(cache, "digA") == [((8, 4), "float32")]


def test_corrupt_manifest_entry_skipped_not_fatal(mcache):
    pkg, cache = mcache
    pkg.manifest.record_export(cache, "digA", (8, 4), "float32")
    d = os.path.join(cache.root, "manifest", "digA")
    with open(os.path.join(d, "garbage.json"), "w") as f:
        f.write("{not json")
    with open(os.path.join(d, "foreign.json"), "w") as f:
        f.write('{"unexpected": true}')
    assert pkg.manifest.exported_signatures(cache, "digA") == [((8, 4), "float32")]


def test_segment_records_round_trip(mcache):
    pkg, cache = mcache
    sigs = (((8, 4), "float32"), ((8, 2), "float32"))
    for _ in range(2):
        pkg.manifest.record_segment(cache, "segA", sigs)
    assert pkg.manifest.segment_signatures(cache, "segA") == [sigs]
    assert pkg.manifest.segment_digests(cache) == ["segA"]


def test_both_packages_name_manifest_files_alike(tmp_path):
    """One signature makes one file name in both packages."""
    names = []
    for k in ("jax", "port"):
        cache = PKGS[k].cache.ExecutableCache(str(tmp_path / k))
        PKGS[k].manifest.record_export(cache, "digA", (8, 4), "float32")
        names.append(os.listdir(os.path.join(cache.root, "manifest", "digA")))
    assert names[0] == names[1]


def _double(X):
    return X * 2.0


def test_engine_export_records_the_manifest(tmp_path):
    """The engine half of the JAX test: an engine under a configured cache
    exports its buckets, and the manifest lists both signatures, as the
    JAX engine's does; a second engine loads both with zero traces."""
    from keystone_tpu.serving import ServingEngine as JServingEngine
    from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
    from keystone_tpu_torch.serving import ServingEngine

    def run(compile_mod, engine_cls, fitted, root):
        compile_mod.configure(root)
        try:
            counts = []
            for _ in range(2):
                engine = engine_cls(fitted, buckets=(2, 4), datum_shape=(3,))
                engine.start()
                out = engine.predict(np.ones(3, np.float32), timeout=30.0)
                engine.shutdown()
                counts.append((engine.metrics.count("compiles"),
                               engine.metrics.count("aot_loads")))
            sigs = compile_mod.exported_signatures(compile_mod.get_cache(), fitted.fingerprint())
            return counts, sigs, np.asarray(out)
        finally:
            compile_mod.reset()

    want = run(jcompile, JServingEngine,
               JFunctionNode(batch_fn=_double, label="double").to_pipeline().fit(),
               str(tmp_path / "jax"))
    got = run(tcompile, ServingEngine,
              FunctionNode(batch_fn=_double, label="double").to_pipeline().fit(),
              str(tmp_path / "port"))
    assert got[0] == want[0] == [(2, 0), (0, 2)]
    assert got[1] == want[1] == [((2, 3), "float32"), ((4, 3), "float32")]
    np.testing.assert_array_equal(got[2], want[2])


# ---------------------------------------------------------------------------
# tests/obs/test_ledger.py
# ---------------------------------------------------------------------------


@pytest.fixture
def events_env(pkg, tmp_path, monkeypatch):
    path = tmp_path / "events.ndjson"
    monkeypatch.setenv("KEYSTONE_EVENTS", str(path))
    pkg.ledger.reset_events()
    yield pkg, path
    pkg.ledger.reset_events()


def test_sink_round_trip_one_line_per_record(pkg, tmp_path):
    sink = pkg.ledger.NdjsonSink(str(tmp_path / "a.ndjson"))
    assert sink.append({"event": "x", "n": 1})
    assert sink.append({"event": "y", "n": 2})
    rows = pkg.ledger.read_ndjson(sink.path)
    assert [r["event"] for r in rows] == ["x", "y"]
    assert open(sink.path).read().count("\n") == 2


def test_reader_skips_torn_lines(pkg, tmp_path):
    path = tmp_path / "a.ndjson"
    path.write_text('{"event":"ok"}\n{"event":"torn', encoding="utf-8")
    assert [r["event"] for r in pkg.ledger.read_ndjson(str(path))] == ["ok"]


def test_missing_file_reads_empty(pkg, tmp_path):
    assert pkg.ledger.read_ndjson(str(tmp_path / "nope.ndjson")) == []


def test_sink_disables_itself_on_write_failure(pkg, tmp_path):
    sink = pkg.ledger.NdjsonSink(str(tmp_path))  # a directory: no append
    assert sink.append({"event": "x"}) is False
    assert sink._dead
    assert sink.append({"event": "y"}) is False


def test_unserializable_record_dropped_without_killing_sink(pkg, tmp_path):
    sink = pkg.ledger.NdjsonSink(str(tmp_path / "a.ndjson"))
    assert sink.append({"bad": object()}) is True  # default=str coerces
    assert sink.append({"worse": {1j: "x"}}) is False  # unkeyable
    assert sink.append({"event": "still-alive"}) is True


def test_sink_for_shares_one_instance_per_path(pkg, tmp_path):
    p = str(tmp_path / "shared.ndjson")
    assert pkg.ledger.sink_for(p) is pkg.ledger.sink_for(p)


def test_compile_ledger_lives_in_the_cache_root(pkg, tmp_path):
    led = pkg.ledger.CompileLedger.for_cache_root(str(tmp_path))
    assert led.path == str(tmp_path / pkg.ledger.COMPILE_LEDGER_NAME)
    assert pkg.ledger.COMPILE_LEDGER_NAME == "compile-ledger.ndjson"


def test_record_stamps_envelope_rounds_floats_skips_none(pkg, tmp_path):
    led = pkg.ledger.CompileLedger(str(tmp_path / "l.ndjson"))
    assert led.record("trace", key="k1", seconds=0.123456789, label=None, nbytes=42)
    (row,) = led.entries()
    assert row["event"] == "trace" and row["pid"] == os.getpid()
    assert row["ts"] > 0
    assert row["seconds"] == 0.123457
    assert row["nbytes"] == 42
    assert "label" not in row


def test_entries_filter_by_event(pkg, tmp_path):
    led = pkg.ledger.CompileLedger(str(tmp_path / "l.ndjson"))
    led.record("trace", key="a")
    led.record("load", key="a")
    led.record("load", key="b")
    assert [r["key"] for r in led.entries("load")] == ["a", "b"]
    assert len(led.entries()) == 3


def test_cache_store_hit_evict_land_in_the_ledger(pkg, tmp_path):
    cache = pkg.cache.ExecutableCache(str(tmp_path), max_bytes=100)
    cache.store("k1", b"x" * 64, {"env": {}})
    assert cache.load("k1") is not None
    cache.store("k2", b"y" * 64, {"env": {}})  # over the bound: k1 goes
    events = [r["event"] for r in cache.ledger.entries()]
    assert events == ["store", "hit", "store", "evict"]
    assert cache.ledger.entries("store")[0]["nbytes"] == 64
    assert cache.ledger.entries("evict")[0]["key"] == "k1"


def test_emit_event_without_env_is_a_noop(pkg, monkeypatch):
    monkeypatch.delenv("KEYSTONE_EVENTS", raising=False)
    pkg.ledger.reset_events()
    try:
        assert pkg.ledger.emit_event("instant", "x.y", worker=1) is False
    finally:
        pkg.ledger.reset_events()


def test_emit_event_writes_envelope_with_nested_attrs(events_env):
    pkg, path = events_env
    assert pkg.ledger.emit_event("instant", "scale.up", worker=3, skipped=None)
    (row,) = pkg.ledger.read_ndjson(str(path))
    assert row["event"] == "instant" and row["name"] == "scale.up"
    assert row["attrs"] == {"worker": 3}
    assert row["pid"] == os.getpid() and row["ts"] > 0


def test_attr_names_cannot_shadow_the_envelope(events_env):
    pkg, path = events_env
    assert pkg.ledger.emit_event("instant", "fault.replica_down", kind="transient",
                                 name="replica-0")
    (row,) = pkg.ledger.read_ndjson(str(path))
    assert row["event"] == "instant" and row["name"] == "fault.replica_down"
    assert row["attrs"] == {"kind": "transient", "name": "replica-0"}


def test_events_sink_is_resolved_once(events_env, monkeypatch):
    pkg, path = events_env
    pkg.ledger.emit_event("instant", "first")
    monkeypatch.setenv("KEYSTONE_EVENTS", "/nonexistent/other.ndjson")
    pkg.ledger.emit_event("instant", "second")
    assert [r["name"] for r in pkg.ledger.read_ndjson(str(path))] == ["first", "second"]


# ---------------------------------------------------------------------------
# tests/faults/test_aot_read.py
# ---------------------------------------------------------------------------


def test_transient_read_fault_degrades_to_miss_then_recovers(pkg, tmp_path):
    cache = pkg.cache.ExecutableCache(str(tmp_path))
    _store(cache, "k1")
    pkg.faults.install(pkg.faults.parse_plan("aot.read=transient@0"))
    assert cache.load("k1", expect_env=ENV) is None  # injected: a miss
    entry = cache.load("k1", expect_env=ENV)  # the next read is fine
    assert entry is not None and entry.payload == b"payload-bytes"


def test_fatal_read_fault_propagates(pkg, tmp_path):
    cache = pkg.cache.ExecutableCache(str(tmp_path))
    _store(cache, "k1")
    pkg.faults.install(pkg.faults.parse_plan("aot.read=fatal@0"))
    with pytest.raises(pkg.faults.FatalFaultInjected):
        cache.load("k1", expect_env=ENV)


def test_no_plan_reads_normally(pkg, tmp_path):
    cache = pkg.cache.ExecutableCache(str(tmp_path))
    _store(cache, "k1")
    assert cache.load("k1", expect_env=ENV) is not None


def test_a_degraded_read_is_a_traced_instant(tmp_path):
    """The port's recovery instant: ``aot.read_degraded`` in the trace."""
    from keystone_tpu_torch.obs import tracer as obs_tracer

    cache = tcache.ExecutableCache(str(tmp_path))
    _store(cache, "k1")
    tfaults.install(tfaults.parse_plan("aot.read=transient@0"))
    tr = obs_tracer.install(obs_tracer.Tracer())
    try:
        assert cache.load("k1", expect_env=ENV) is None
    finally:
        obs_tracer.reset()
    assert [s.attrs["key"] for s in tr.spans() if s.name == "aot.read_degraded"] == ["k1"]
