"""The shared-memory rings of the cluster wire on the port: the cases of
the JAX package's ``tests/cluster/test_shm.py`` and the shm cases of
``tests/cluster/test_codec.py`` run on ``keystone_tpu_torch.cluster.shm``
(slot lifecycle, exhaustion, bounds, cross-mapping visibility,
creator-owned unlink), rings shared with the JAX package's ``ShmRing``
(bytes equal both ways), and the router's respawn naming: each spawn of a
slot gets segments under a new generation name, and the old ones are
unlinked."""

from multiprocessing import resource_tracker

import numpy as np
import pytest

from keystone_tpu.cluster.shm import ShmRing as JShmRing
from keystone_tpu_torch.cluster.codec import CodecError, decode, encode
from keystone_tpu_torch.cluster.router import ring_base
from keystone_tpu_torch.cluster.shm import ShmRing, make_ring_pair


def _attach(name, slots, slot_bytes, cls=ShmRing):
    """A second mapping in this process. The attach drops the process's
    tracker claim, which the creator shares here, so it is restored."""
    ring = cls(name, slots, slot_bytes, create=False)
    resource_tracker.register(f"/{name}", "shared_memory")
    return ring


class _Counters:
    def __init__(self):
        self.counts = {}

    def inc(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n


@pytest.fixture
def ring():
    r = ShmRing("ksttshmtest", slots=3, slot_bytes=256, create=True)
    yield r
    r.close()
    r.unlink()


def test_alloc_write_view_free_cycle(ring):
    data = bytes(range(200))
    slot = ring.alloc(len(data))
    assert slot is not None
    ring.write(slot, data)
    assert ring.in_use == 1
    view = ring.view(slot, len(data))
    assert bytes(view) == data
    del view
    ring.free(slot)
    assert ring.in_use == 0


def test_exhaustion_returns_none_then_recovers(ring):
    slots = [ring.alloc(10) for _ in range(3)]
    assert all(s is not None for s in slots) and len(set(slots)) == 3
    assert ring.alloc(10) is None
    ring.free(slots[1])
    assert ring.alloc(10) == slots[1]


def test_oversized_payload_returns_none(ring):
    assert ring.alloc(257) is None
    assert ring.alloc(256) is not None


def test_out_of_range_descriptor_raises_codec_error(ring):
    with pytest.raises(CodecError):
        ring.view(7, 10)
    with pytest.raises(CodecError):
        ring.view(0, 1 << 20)
    ring.free(99)  # ignored


@pytest.mark.parametrize("peer_cls", [ShmRing, JShmRing], ids=["port", "jax"])
def test_attached_mapping_sees_writers_bytes(ring, peer_cls):
    arr = np.arange(32, dtype=np.float64)
    slot = ring.alloc(arr.nbytes)
    ring.write(slot, memoryview(arr).cast("B"))
    peer = _attach("ksttshmtest", 3, 256, peer_cls)
    try:
        assert peer.in_use == 1
        got = np.frombuffer(bytes(peer.view(slot, arr.nbytes)), dtype=np.float64)
        np.testing.assert_array_equal(got, arr)
        peer.free(slot)
        assert ring.in_use == 0
    finally:
        peer.close()


def test_a_jax_writer_and_a_port_reader_share_a_ring():
    jring = JShmRing("ksttshmjax", 2, 1 << 12, create=True)
    try:
        arr = np.arange(300, dtype=np.int32)
        slot = jring.alloc(arr.nbytes)
        jring.write(slot, memoryview(arr).cast("B"))
        peer = _attach("ksttshmjax", 2, 1 << 12)
        try:
            np.testing.assert_array_equal(
                np.frombuffer(bytes(peer.view(slot, arr.nbytes)), dtype=np.int32), arr)
            peer.free(slot)
            assert jring.in_use == 0
        finally:
            peer.close()
    finally:
        jring.close()
        jring.unlink()


def test_closed_ring_stops_allocating(ring):
    ring.close()
    assert ring.alloc(10) is None


def test_unlink_is_creator_only_and_idempotent():
    creator = ShmRing("ksttshmunlink", slots=1, slot_bytes=64, create=True)
    attached = _attach("ksttshmunlink", 1, 64)
    attached.close()
    attached.unlink()  # the attach side: a no-op
    still = _attach("ksttshmunlink", 1, 64)
    still.close()
    creator.close()
    creator.unlink()
    creator.unlink()
    with pytest.raises(FileNotFoundError):
        ShmRing("ksttshmunlink", slots=1, slot_bytes=64, create=False)


def test_make_ring_pair_creates_both_directions():
    c2w, w2c = make_ring_pair("ksttshmpair", slots=2, slot_bytes=128)
    try:
        assert c2w is not None and w2c is not None
        assert c2w.name == "ksttshmpairc" and w2c.name == "ksttshmpairr"
        assert c2w.alloc(64) is not None and w2c.alloc(64) is not None
    finally:
        for r in (c2w, w2c):
            r.close()
            r.unlink()


def test_degenerate_geometry_rejected():
    with pytest.raises(ValueError):
        ShmRing("ksttshmbad", slots=0, slot_bytes=64, create=True)
    with pytest.raises(ValueError):
        ShmRing("ksttshmbad", slots=1, slot_bytes=0, create=True)


# -- the codec over a ring ---------------------------------------------------


def _ring(name, slots=2, slot_bytes=1 << 12):
    return ShmRing(name, slots, slot_bytes, create=True)


def test_shm_placement_and_copying_decode_frees_slots():
    ring = _ring("ksttcodec1")
    try:
        metrics = _Counters()
        arr = np.arange(256, dtype=np.float32)
        payload = encode({"type": "req", "members": [{"id": 1, "datum": arr}]}, shm=ring,
                         min_shm_bytes=1024, metrics=metrics)
        assert metrics.counts["shm.payloads"] == 1 and metrics.counts["shm.bytes"] == arr.nbytes
        assert ring.in_use == 1 and len(payload) < arr.nbytes
        got = decode(payload, shm=ring, copy=True)
        np.testing.assert_array_equal(got["members"][0]["datum"], arr)
        assert "_shm_slots" not in got and ring.in_use == 0
    finally:
        ring.close()
        ring.unlink()


def test_shm_zero_copy_decode_defers_slot_free():
    ring = _ring("ksttcodec2")
    try:
        arr = np.arange(512, dtype=np.float64)
        payload = encode({"type": "req", "members": [{"id": 1, "datum": arr}]}, shm=ring,
                         min_shm_bytes=1024)
        got = decode(payload, shm=ring, copy=False)
        slots = got.pop("_shm_slots")
        datum = got["members"][0]["datum"]
        np.testing.assert_array_equal(datum, arr)
        assert len(slots) == 1 and ring.in_use == 1
        del got, datum
        for s in slots:
            ring.free(s)
        assert ring.in_use == 0
    finally:
        ring.close()
        ring.unlink()


def test_shm_exhaustion_degrades_inline_and_counts():
    ring = _ring("ksttcodec3", slots=1)
    try:
        metrics = _Counters()
        arrs = [np.arange(512, dtype=np.float32) + i for i in range(3)]
        payload = encode({"type": "req", "members": [{"id": i, "datum": a}
                                                     for i, a in enumerate(arrs)]},
                         shm=ring, min_shm_bytes=1024, metrics=metrics)
        assert metrics.counts["shm.payloads"] == 1 and metrics.counts["shm.fallback"] == 2
        got = decode(payload, shm=ring, copy=True)
        for m, a in zip(got["members"], arrs):
            np.testing.assert_array_equal(m["datum"], a)
        assert ring.in_use == 0
    finally:
        ring.close()
        ring.unlink()


def test_small_payloads_stay_inline():
    ring = _ring("ksttcodec4")
    try:
        metrics = _Counters()
        payload = encode({"type": "req", "members": [{"id": 1, "datum": np.ones(4, np.float32)}]},
                         shm=ring, min_shm_bytes=1024, metrics=metrics)
        assert ring.in_use == 0 and not metrics.counts
        got = decode(payload, shm=None, copy=True)
        np.testing.assert_array_equal(got["members"][0]["datum"], np.ones(4, np.float32))
    finally:
        ring.close()
        ring.unlink()


def test_shm_reference_without_ring_degrades_typed():
    ring = _ring("ksttcodec5")
    try:
        payload = encode({"type": "req", "members": [
            {"id": 1, "datum": np.arange(512, dtype=np.float32)}]}, shm=ring, min_shm_bytes=1024)
        with pytest.raises(CodecError, match="no ring"):
            decode(payload, shm=None)
    finally:
        ring.close()
        ring.unlink()


# -- respawn naming ------------------------------------------------------------


def test_ring_names_are_new_each_generation_and_each_router():
    # the JAX router's f"ks{pid:x}w{index}g{gen}" with the router's number
    # in the process beside the pid: JAX's two routers in one process share
    # their first rings' names
    assert ring_base(0x1f2e, 0, 3, 2) == "ks1f2er0w3g2"
    names = {ring_base(4242, r, 1, g) for r in range(2) for g in range(1, 5)}
    assert len(names) == 8


def test_two_routers_in_one_process_name_their_rings_apart():
    from keystone_tpu_torch.cluster.router import ClusterRouter

    spec = ("factory", "keystone_tpu_torch.cluster.demo:build_stall_model", {"d": 8})
    a = ClusterRouter(spec, workers=1, device="cpu")
    b = ClusterRouter(spec, workers=1, device="cpu")
    assert a._router_id != b._router_id
    assert (ring_base(4242, a._router_id, 0, 1) != ring_base(4242, b._router_id, 0, 1))


def test_a_respawn_unlinks_the_old_generation_and_creates_a_fresh_one():
    """The router's spawn path: release the slot's rings, bump the
    generation, create the new pair (``ClusterRouter._spawn_worker``)."""
    from keystone_tpu_torch.cluster.router import ClusterRouter, _WorkerSlot

    router = ClusterRouter.__new__(ClusterRouter)
    slot = _WorkerSlot(1)
    names = []
    try:
        for gen in (1, 2):
            router._release_rings(slot)
            slot.shm_gen = gen
            slot.shm_tx, slot.shm_rx = make_ring_pair(ring_base(4242, 0, 1, gen), 2, 256)
            names.append((slot.shm_tx.name, slot.shm_rx.name))
        assert names == [("ks1092r0w1g1c", "ks1092r0w1g1r"), ("ks1092r0w1g2c", "ks1092r0w1g2r")]
        for old in names[0]:
            with pytest.raises(FileNotFoundError):
                ShmRing(old, 2, 256, create=False)
    finally:
        router._release_rings(slot)
    for new in names[1]:
        with pytest.raises(FileNotFoundError):
            ShmRing(new, 2, 256, create=False)
