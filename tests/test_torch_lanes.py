"""The port's staging lanes (``data/pipeline_scan.py`` with
``parallel/lanes.py``) against the JAX package's on the suite's 8-device
virtual mesh: the counterparts of ``tests/data/test_sharded_scan.py``.
Chunk ``i`` is lane ``i % k``'s, ``depth`` chunks a lane are in flight,
``lane_bytes`` shows a skew, the collective stamp lands on the span after
it was recorded, the serial scan keeps the placement, a one-lane scan keeps
today's contract, ``ChunkPadder`` pads to the lane multiple, and a
``ChunkedDataset``'s laned scan composes with its producer shards. Both
packages run the same chunks; their lane counts, byte counts, collectives
and span attrs must be equal.

The port's 8 virtual devices are 8 slots of the CPU; the autouse fixture
restores its slots and default mesh afterwards."""

import numpy as np
import pytest
import torch

from keystone_tpu.data import pipeline_scan as jscan
from keystone_tpu.obs import tracer as jtrace
from keystone_tpu.parallel import lanes as jlanes
from keystone_tpu_torch.data import pipeline_scan as tscan
from keystone_tpu_torch.obs import SCAN_LANE_SPAN, SCAN_SPAN
from keystone_tpu_torch.obs import tracer as ttrace
from keystone_tpu_torch.parallel import lanes, mesh, virtual


@pytest.fixture(autouse=True)
def port_mesh():
    saved = (mesh._default_mesh, virtual._slots)
    virtual.provision_virtual_devices(8)
    yield
    mesh._default_mesh, virtual._slots = saved


@pytest.fixture
def tracers():
    """A tracer in each package, both reset afterwards."""
    from keystone_tpu.obs import Tracer as JTracer
    from keystone_tpu.obs import install as jinstall
    from keystone_tpu_torch.obs import Tracer, install

    yield jinstall(JTracer()), install(Tracer())
    jtrace.reset()
    ttrace.reset()


def _chunks(n=8, rows=4, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, d)).astype(np.float32) for _ in range(n)]


def _scan_spans(tracer, name=SCAN_SPAN):
    return [sp for sp in tracer.spans() if sp.name == name]


def test_chunk_i_is_on_lane_i_mod_k_as_in_jax():
    chunks = _chunks(8)
    j = jscan.scan_pipeline(iter(chunks), lanes=4, label="t")
    t = tscan.scan_pipeline(iter(chunks), lanes=4, label="t")
    assert isinstance(t, tscan.ScanPipeline) and t.lanes == j.lanes == 4
    jdevs = jlanes.lane_devices(4)
    jout, tout = list(j), list(t)
    for i, (a, b) in enumerate(zip(jout, tout)):
        assert a.devices() == {jdevs[i % 4]}
        np.testing.assert_array_equal(b.numpy(), chunks[i])
    assert [s.index for s in t.lane_devices] == [d.id for d in jdevs]
    assert t.stats.lane_chunks == j.stats.lane_chunks == [2, 2, 2, 2]
    assert t.stats.lane_bytes == j.stats.lane_bytes
    assert t.stats.lane_devices == [str(s) for s in t.lane_devices]


def test_serial_scan_keeps_the_lane_placement(monkeypatch):
    monkeypatch.setenv("KEYSTONE_SCAN_PIPELINE", "0")
    chunks = _chunks(8)
    t = tscan.scan_pipeline(iter(chunks), lanes=4, label="t")
    assert not isinstance(t, tscan.ScanPipeline)
    got = list(t)
    assert len(got) == 8
    for i, c in enumerate(got):
        np.testing.assert_array_equal(c.numpy(), chunks[i])
    # with explicit slots of another device the serial scan stages to them
    slots = virtual.virtual_slots(2, "meta")
    placed = list(tscan.serial_staged(iter(_chunks(4)), lanes=2, devices=slots))
    assert [c.device.type for c in placed] == ["meta"] * 4


def test_a_lane_on_another_device_stages_there():
    """Chunk i is copied to lane i's slot's device; one slot of another
    device than the rest shows it (the JAX test commits chunks to another
    virtual device, which torch's one CPU device cannot)."""
    slots = [mesh.Slot(0, torch.device("cpu")), mesh.Slot(1, torch.device("meta"))]
    src = [torch.from_numpy(c) for c in _chunks(4)]
    t = tscan.scan_pipeline(iter(src), lanes=2, devices=slots, label="t")
    placed = list(t)
    assert [c.device.type for c in placed] == ["cpu", "meta", "cpu", "meta"]
    # lane 0's chunks were already on its device: no bytes; lane 1's moved
    assert t.stats.lane_chunks == [2, 2]
    assert t.stats.lane_bytes[0] == 0 and t.stats.lane_bytes[1] == 2 * 4 * 3 * 4


def test_depth_chunks_a_lane_are_in_flight():
    t = tscan.scan_pipeline(iter(_chunks(12)), depth=2, lanes=2, label="t")
    assert t._q.maxsize == 4
    next(t)
    list(t)
    assert t.stats.occupancy_max <= 4
    one = tscan.scan_pipeline(iter(_chunks(4)), depth=2, label="t")
    assert one._q.maxsize == 2
    list(one)


def test_lane_bytes_show_a_skew_as_in_jax(tracers):
    jtracer, ttracer = tracers

    def skewed():
        for i in range(8):
            rows = 64 if i % 4 == 0 else 4
            yield np.ones((rows, 8), np.float32)

    j = jscan.scan_pipeline(skewed(), lanes=4, label="skew")
    t = tscan.scan_pipeline(skewed(), lanes=4, label="skew")
    list(j), list(t)
    assert t.stats.lane_bytes == j.stats.lane_bytes == [2 * 64 * 8 * 4] + [2 * 4 * 8 * 4] * 3
    ja, ta = _scan_spans(jtracer)[-1].attrs, _scan_spans(ttracer)[-1].attrs
    for key in ("lanes", "collectives", "lane_chunks", "lane_bytes", "lane_imbalance", "chunks",
                "staged_bytes"):
        assert ta[key] == ja[key], key
    assert ta["lane_imbalance"] > 2.0
    assert len(ta["devices"]) == len(ja["devices"]) == 4
    jl, tl = _scan_spans(jtracer, "scan.pipeline.lane"), _scan_spans(ttracer, SCAN_LANE_SPAN)
    assert len(tl) == len(jl) == 4
    root = _scan_spans(ttracer)[-1]
    for a, b in zip(jl, tl):
        assert b.parent_id == root.span_id and b.depth == root.depth + 1
        assert {k: v for k, v in b.attrs.items() if k != "device"} == {
            k: v for k, v in a.attrs.items() if k != "device"}
        assert b.attrs["device"]


def test_the_collective_stamp_after_the_scan_lands_on_the_span(tracers):
    jtracer, ttracer = tracers
    chunks = _chunks(8)
    results = []
    for scan_mod, lane_mod in ((jscan, jlanes), (tscan, lanes)):
        it = scan_mod.scan_pipeline(iter(chunks), lanes=4, label="t")
        partials = [None] * 4
        for i, c in enumerate(it):
            s = c.sum(axis=0) if hasattr(c, "devices") else c.sum(dim=0)
            partials[i % 4] = s if partials[i % 4] is None else partials[i % 4] + s
        results.append((it, lane_mod.reduce_lane_partials(partials, scan=it)))
    (jit, jtotal), (tit, ttotal) = results
    assert tit.stats.collectives == jit.stats.collectives == 3
    assert (_scan_spans(ttracer)[-1].attrs["collectives"]
            == _scan_spans(jtracer)[-1].attrs["collectives"] == 3)
    np.testing.assert_allclose(ttotal.numpy(), np.asarray(jtotal), atol=1e-6)


def test_one_lane_keeps_todays_contract(tracers):
    _, ttracer = tracers
    t = tscan.scan_pipeline(iter(_chunks(3)), label="t")
    assert t.lanes == 1 and t.lane_devices is None
    assert len(list(t)) == 3
    assert t.stats.lanes == 1 and t.stats.lane_chunks == [] and t.stats.lane_bytes == []
    assert t.stats.collectives == 0 and t.stats.staged_bytes == 0
    attrs = _scan_spans(ttracer)[-1].attrs
    assert "lanes" not in attrs and "collectives" not in attrs
    assert not _scan_spans(ttracer, SCAN_LANE_SPAN)


@pytest.mark.parametrize("lanes_env,want", [(None, 1), ("2", 2), ("8", 2)])
def test_visible_cards_alone_give_one_lane_unless_asked(monkeypatch, lanes_env, want):
    """A mesh built only from the visible cards (here two, none provisioned)
    prices two machines but scans in one lane until ``KEYSTONE_SCAN_LANES``
    asks for more, clamped to the cards."""
    virtual.clear_virtual_devices()
    mesh.set_default_mesh(None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    if lanes_env:
        monkeypatch.setenv("KEYSTONE_SCAN_LANES", lanes_env)
    assert not mesh.mesh_was_chosen()
    assert mesh.mesh_size() == 2
    assert lanes.scan_lanes() == want
    assert [str(s) for s in lanes.lane_devices()] == [f"cuda:{i}#{i}" for i in range(want)]
    assert lanes.scan_lanes(mesh.default_mesh()) == min(int(lanes_env or 2), 2)


def test_chunk_padder_pads_to_the_lane_multiple():
    virtual.provision_virtual_devices(4)
    calls = []

    def fn(x):
        calls.append(int(x.shape[0]))
        return x + 1.0

    padder = tscan.ChunkPadder(fn)
    lead = torch.zeros(16, 2)
    tail = torch.arange(14, dtype=torch.float32).reshape(7, 2)
    torch.testing.assert_close(padder(lead), lead + 1.0)
    out = padder(tail)
    assert tuple(out.shape) == (7, 2)
    torch.testing.assert_close(out, tail + 1.0)
    assert 8 in calls and all(c % 4 == 0 for c in calls)


@pytest.mark.parametrize("lanes_env", [None, "2"])
def test_chunk_padder_default_multiple_follows_the_lanes_as_in_jax(monkeypatch, lanes_env):
    if lanes_env:
        monkeypatch.setenv("KEYSTONE_SCAN_LANES", lanes_env)
    jcalls, tcalls = [], []
    jp = jscan.ChunkPadder(lambda x: (jcalls.append(int(x.shape[0])), x)[1])
    tp = tscan.ChunkPadder(lambda x: (tcalls.append(int(x.shape[0])), x)[1])
    for rows in (20, 7, 3):
        jp(np.zeros((rows, 2), np.float32))
        tp(torch.zeros(rows, 2))
    assert tcalls == jcalls
    assert tp._buckets == jp._buckets


def test_chunk_padder_without_a_mesh_keeps_the_plain_ladder():
    virtual.clear_virtual_devices()
    tp = tscan.ChunkPadder(lambda x: x)
    tp(torch.zeros(20, 2))
    assert tp._buckets == tscan.bucket_ladder(20)


@pytest.mark.parametrize("shards", ["1", "3"])
def test_a_chunked_datasets_laned_scan_composes_with_its_producer_shards(monkeypatch, shards):
    from keystone_tpu.data import ChunkedDataset as JChunked
    from keystone_tpu_torch.data.chunked import ChunkedDataset

    monkeypatch.setenv("KEYSTONE_SCAN_SHARDS", shards)
    parts = _chunks(7, rows=5, seed=4)
    j = JChunked.from_chunk_fn(lambda i: parts[i], 7, 35).chunks(lanes=4)
    t = ChunkedDataset.from_chunk_fn(lambda i: parts[i], 7, 35).chunks(lanes=4)
    jout, tout = list(j), list(t)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert t.stats.lane_chunks == j.stats.lane_chunks == [2, 2, 2, 1]
    assert t.stats.lane_bytes == j.stats.lane_bytes
    assert t.stats.shards == j.stats.shards


def test_fault_points_count_per_chunk_under_lanes_as_in_jax(monkeypatch):
    """``scan.stage`` fires once a chunk, lanes or not: the same plan
    injects the same transient faults in both packages' laned scans."""
    import keystone_tpu.faults as jfaults
    import keystone_tpu_torch.faults as tfaults

    monkeypatch.setenv("KEYSTONE_SCAN_RETRIES", "4")
    spec = "scan.stage=transient@1,5"
    counts = []
    for faults, scan_mod in ((jfaults, jscan), (tfaults, tscan)):
        faults.install(faults.parse_plan(spec))
        try:
            it = scan_mod.scan_pipeline(iter(_chunks(8)), lanes=4, label="t")
            assert len(list(it)) == 8
            counts.append((it.stats.retries, list(it.stats.lane_chunks)))
        finally:
            faults.clear()
    assert counts[0] == counts[1] == (2, [2, 2, 2, 2])
