"""The model on every device of a fleet: the port's per-device copies of a
fitted chain (``parallel.placement.copy_to_device``) and the fleet that
serves one copy a physical device, held against the JAX fleet on the
suite's 8 virtual devices.

* Under ``provision_virtual_devices(8)`` the port's default fleet has 8
  replicas, as the JAX fleet's does on its 8 devices; they share one chain
  and the model's own tensors (no copy), answer the small
  RandomPatchCifarKernel chain within 1e-5 of the JAX fleet, argmax equal,
  and both count one compile a bucket.
* A swap mid-load drops nothing, and the canary's verdicts (promote,
  roll back on outputs, roll back on latency) are the JAX fleet's.
* A copy onto ``meta`` leaves no tensor on the CPU at any depth and keeps
  shared tensors shared; a copy onto the chain's own device is the chain.
* A fleet over the CPU and ``meta`` (built, not started: ``meta`` computes
  nothing) holds one chain a device, pins a restarted replica to its own
  device's copy of the published version, flips each replica to its
  device's copy on a swap, and frees a rolled-back candidate's copies.
* The trainer's promotion reaches every replica's chain.

The card with the host as a second device is
``tests/test_torch_cuda_fleet_devices.py``."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from keystone_tpu.serving import CanaryMismatch as JCanaryMismatch
from keystone_tpu.serving import ServingFleet as JServingFleet
from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
from keystone_tpu_torch import faults
from keystone_tpu_torch.faults import ReplicaKilled
from keystone_tpu_torch.obs import flight
from keystone_tpu_torch.parallel import mesh, virtual
from keystone_tpu_torch.parallel.placement import copy_to_device, tensors_of
from keystone_tpu_torch.serving import CanaryMismatch, ServingFleet
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline
from keystone_tpu_torch.workflow.transformer import FunctionNode, Transformer
from tests.test_torch_serving import _sure, cifar_fit  # noqa: F401 (fixture)

WAIT = 30.0
BUCKETS = (1, 8)
CPU, META = torch.device("cpu"), torch.device("meta")


@pytest.fixture(autouse=True)
def port_env(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    saved = (mesh._default_mesh, virtual._slots)
    env = PipelineEnv.get_or_create()
    env.reset()
    faults.clear()
    flight.reset()
    yield env
    faults.clear()
    flight.reset()
    env.reset()
    mesh._default_mesh, virtual._slots = saved


def _scale(X, s):
    return X * s


def _linear(scale, label=None):
    return FunctionNode(batch_fn=lambda X, s=scale: _scale(X, s),
                        label=label or f"scale{scale}").to_pipeline().fit()


def _jlinear(scale, label=None):
    return JFunctionNode(batch_fn=lambda X, s=scale: X * s,
                         label=label or f"scale{scale}").to_pipeline().fit()


def _slow(X):
    time.sleep(0.05)
    return X * 2.0


def _jslow(X):
    """The JAX package's slow candidate: a sleep in a host callback runs on
    every call of the jitted program (its own test's form)."""
    import jax

    def stall(x):
        time.sleep(0.05)
        return x

    return jax.pure_callback(stall, jax.ShapeDtypeStruct(X.shape, X.dtype), X) * 2.0


def _serve(fleet, rows):
    with ThreadPoolExecutor(max_workers=8) as pool:
        return np.stack([np.asarray(r) for r in pool.map(
            lambda r: fleet.predict(r, timeout=WAIT), rows)])


def _first(x):
    return float(np.asarray(x).ravel()[0])


# ---------------------------------------------------------------------------
# the default fleet on 8 virtual devices, against the JAX fleet
# ---------------------------------------------------------------------------


def test_eight_virtual_devices_give_eight_replicas_sharing_one_chain_as_jax(cifar_fit):  # noqa: F811
    import jax

    virtual.provision_virtual_devices(8)
    rows = cifar_fit.X.numpy()
    jfleet = JServingFleet(cifar_fit.j_scores, buckets=BUCKETS, datum_shape=(32, 32, 3))
    fleet = ServingFleet(cifar_fit.scores, buckets=BUCKETS, datum_shape=(32, 32, 3))
    assert jfleet.n_replicas == len(jax.devices()) == fleet.n_replicas == 8
    assert [r.device for r in fleet.replicas] == [CPU] * 8
    with jfleet:
        want = _serve(jfleet, rows)
    with fleet:
        got = _serve(fleet, rows)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert (fleet.metrics.count("compiles") == jfleet.metrics.count("compiles")
            == len(BUCKETS))
    # one chain, the model itself, for the 8 slots of the one CPU
    published = fleet.published
    assert published.copies == 0 and list(published.chains) == [CPU]
    assert all(r.compiled is published.chain_for(CPU) for r in fleet.replicas)
    assert published.chain_for(CPU).fitted is cifar_fit.scores
    assert {id(t) for t in tensors_of(published.chain_for(CPU).fitted)} == {
        id(t) for t in tensors_of(cifar_fit.scores)}


def _hammer_swap(fleet, new, **swap):
    """Four clients hammer ``fleet`` while it swaps to ``new``: (the swap's
    report or its ``CanaryMismatch``, the answers, the failures)."""
    stop = threading.Event()
    answers, failures = [], []

    def hammer():
        while not stop.is_set():
            try:
                answers.append(_first(fleet.predict(np.ones(2, np.float32), timeout=WAIT)))
            except Exception as e:  # counted: the gate asserts none
                failures.append(repr(e))

    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = [pool.submit(hammer) for _ in range(4)]
        time.sleep(0.1)
        try:
            try:
                outcome = fleet.swap(new, **swap)
            except (CanaryMismatch, JCanaryMismatch) as e:
                outcome = e
            time.sleep(0.1)
        finally:
            stop.set()
            for f in futs:
                f.result(timeout=WAIT)
    return outcome, answers, failures


CANARY = dict(canary_fraction=1.0, canary_batches=2, canary_timeout_s=20.0)
SWAPS = [
    ("mid-load", lambda lin: lin(3.0), {}),
    ("canary pass", lambda lin: lin(2.0, "equivalent"), CANARY),
    ("canary mismatch", lambda lin: lin(5.0, "bad"), CANARY),
]


@pytest.mark.parametrize("case", [s[0] for s in SWAPS])
def test_swaps_on_eight_devices_give_the_jax_fleets_verdicts(case):
    virtual.provision_virtual_devices(8)
    _, make, swap = next(s for s in SWAPS if s[0] == case)
    verdicts = {}
    for name, lin, Fleet in (("jax", _jlinear, JServingFleet), ("port", _linear, ServingFleet)):
        fleet = Fleet(lin(2.0), buckets=(4,), datum_shape=(2,), max_wait_ms=1.0)
        assert fleet.n_replicas == 8
        with fleet:
            outcome, answers, failures = _hammer_swap(fleet, make(lin), **swap)
            after = _first(fleet.predict(np.ones(2, np.float32), timeout=WAIT))
            c = fleet.metrics.snapshot()["counters"]
        assert not failures and c["completed"] == c["submitted"]  # nothing dropped
        rolled_back = isinstance(outcome, Exception)
        verdicts[name] = (rolled_back, fleet.model_version, after,
                          c.get("swaps", 0), c.get("canary_fail", 0), c.get("canary_pass", 0),
                          set(answers) <= {2.0, after, 5.0})
        if name == "port" and not rolled_back:
            assert all(r.compiled is fleet.published.chain_for(CPU) for r in fleet.replicas)
    assert verdicts["port"] == verdicts["jax"]


def test_a_slow_candidate_rolls_back_on_eight_devices_as_in_jax():
    virtual.provision_virtual_devices(8)
    verdicts = {}
    for name, lin, slow, Fleet in (
            ("jax", _jlinear, JFunctionNode(batch_fn=_jslow, label="slow"), JServingFleet),
            ("port", _linear, FunctionNode(batch_fn=_slow, label="slow"), ServingFleet)):
        fleet = Fleet(lin(2.0), buckets=(4,), datum_shape=(2,), max_wait_ms=1.0)
        with fleet:
            outcome, _, failures = _hammer_swap(fleet, slow.to_pipeline().fit(),
                                                max_latency_ratio=3.0, **CANARY)
            verdicts[name] = (type(outcome).__name__, "latency" in str(outcome),
                              fleet.model_version, not failures)
    assert verdicts["port"] == verdicts["jax"] == ("CanaryMismatch", True, 1, True)


# ---------------------------------------------------------------------------
# the per-device copy
# ---------------------------------------------------------------------------


class _Holds(Transformer):
    """A node holding a tensor and a view of another's storage."""

    def __init__(self, W, view):
        self.W = W
        self.view = view

    def forward(self, X):
        return X @ self.W + self.view.sum()


def _ops(fitted):
    """Every operator of ``fitted``, a fused group's steps in its place."""
    for op in fitted.graph.operators.values():
        yield from (step for step, _ in op.steps) if hasattr(op, "steps") else (op,)


def _shared_chain():
    """Two nodes that hold one tensor (as CSE leaves them) and views of one
    storage, and a closure over the tensor."""
    W = torch.randn(3, 3, generator=torch.Generator().manual_seed(0))
    base = torch.arange(12.0)
    first = _Holds(W, base[:4])
    second = _Holds(W, base[4:].view(2, 4))
    shift = FunctionNode(batch_fn=lambda X: X - W[0], label="shift")
    return (first.to_pipeline() >> second >> shift).fit(), W


def test_a_copy_onto_meta_holds_no_cpu_tensor_at_any_depth_and_keeps_sharing():
    fitted, W = _shared_chain()
    copy = copy_to_device(fitted, META)
    assert copy is not fitted and isinstance(copy, FittedPipeline)
    assert tensors_of(copy) and all(t.device == META for t in tensors_of(copy))
    ops = [op for op in _ops(copy) if isinstance(op, _Holds)]
    assert len(ops) == 2 and ops[0].W is ops[1].W  # one tensor in both nodes
    assert ops[0].view.untyped_storage().nbytes() == 48  # the whole storage moved once
    assert (ops[0].view.untyped_storage().data_ptr() == ops[1].view.untyped_storage().data_ptr())
    shift = next(op for op in _ops(copy) if op.label == "shift")
    assert shift.forward.__closure__[0].cell_contents is ops[0].W  # the closure too
    # the source is untouched, and runs as before
    assert all(t.device == CPU for t in tensors_of(fitted)) and W.device == CPU
    out = copy.apply(torch.zeros(2, 3, device=META)).to_array()
    assert out.device == META and tuple(out.shape) == (2, 3)


def test_a_copy_onto_the_chains_own_device_is_the_chain():
    fitted, _ = _shared_chain()
    assert copy_to_device(fitted, "cpu") is fitted
    assert copy_to_device(fitted, CPU) is fitted
    tensorless = _linear(2.0)
    assert copy_to_device(tensorless, META) is tensorless  # nothing to place


def test_a_copy_drops_compiled_state_and_keeps_the_fingerprint_memo():
    fitted, _ = _shared_chain()
    fitted.compile()
    digest = fitted.fingerprint()
    copy = copy_to_device(fitted, META)
    assert copy._compiled is None and copy._compiled_signatures == []
    assert copy._segment_plan is None
    assert copy.fingerprint() == digest


# ---------------------------------------------------------------------------
# a fleet over two physical devices (the CPU and meta)
# ---------------------------------------------------------------------------


def _two_device_fleet(fitted=None, **kw):
    fitted = fitted if fitted is not None else _shared_chain()[0]
    return ServingFleet(fitted, devices=["cpu", "meta"], buckets=(4,), datum_shape=(3,), **kw)


def test_a_fleet_over_two_devices_holds_one_chain_a_device():
    fitted, _ = _shared_chain()
    fleet = ServingFleet(fitted, devices=["cpu", "meta", "cpu"], buckets=(4,),
                         datum_shape=(3,))
    published = fleet.published
    assert sorted(map(str, published.chains)) == ["cpu", "meta"] and published.copies == 1
    cpu_chain, meta_chain = published.chain_for(CPU), published.chain_for(META)
    assert cpu_chain.fitted is fitted  # the model itself on its own device
    assert all(t.device == META for t in tensors_of(meta_chain.fitted))
    assert meta_chain.device == META
    assert [r.compiled for r in fleet.replicas] == [cpu_chain, meta_chain, cpu_chain]
    assert [r.stream for r in fleet.replicas] == [None] * 3
    fleet.shutdown()


def test_a_restarted_replica_is_pinned_to_its_devices_copy_of_the_published_version():
    fleet = _two_device_fleet()
    try:
        meta_rep = fleet.replicas[1]
        meta_rep.flip(fleet.published.chain_for(CPU))  # as if a canary leaked onto it
        fleet._on_replica_down(meta_rep, ReplicaKilled("killed for the test"))
        assert meta_rep.compiled is fleet.published.chain_for(META)
        assert fleet.metrics.count("restarts") == 1
    finally:
        fleet.shutdown(drain=False)


def test_a_swap_flips_each_replica_to_its_devices_copy():
    fleet = _two_device_fleet()
    new, _ = _shared_chain()
    try:
        report = fleet.swap(new, warmup=False)
        assert report["version"] == 2 and report["replicas_flipped"] == 2
        published = fleet.published
        assert published.fitted is new and fleet.fitted is new
        assert fleet.replicas[0].compiled.fitted is new
        meta = fleet.replicas[1].compiled
        assert meta is published.chain_for(META) and meta.fitted is not new
        assert all(t.device == META for t in tensors_of(meta.fitted))
    finally:
        fleet.shutdown(drain=False)


def test_a_rolled_back_candidate_frees_its_copies(monkeypatch):
    fleet = _two_device_fleet()
    made = []
    compile_ = fleet._compile
    monkeypatch.setattr(fleet, "_compile", lambda f: made.append(compile_(f)) or made[-1])

    def mismatch(candidate, **kw):
        raise CanaryMismatch("canary auto-rollback: for the test", {"mismatches": 1})

    monkeypatch.setattr(fleet, "_run_canary", mismatch)
    try:
        with pytest.raises(CanaryMismatch):
            fleet.swap(_shared_chain()[0], warmup=False, canary_fraction=1.0)
        assert len(made) == 1 and made[0].chains == {}
        assert fleet.model_version == 1 and fleet.published.copies == 1
    finally:
        fleet.shutdown(drain=False)


def test_a_swap_that_raises_after_the_flip_keeps_the_published_copies(monkeypatch):
    """Whatever raises once the candidate is published (here the swap's
    flight instant), the published version's chains stay, so a restart
    still finds its device's copy."""
    fleet = _two_device_fleet()
    record = flight.record_instant

    def fail_on_swap(name, **kw):
        if name == "serve.swap":
            raise RuntimeError("after the flip, for the test")
        return record(name, **kw)

    monkeypatch.setattr(flight, "record_instant", fail_on_swap)
    new, _ = _shared_chain()
    try:
        with pytest.raises(RuntimeError, match="after the flip"):
            fleet.swap(new, warmup=False)
        published = fleet.published
        assert published.fitted is new and sorted(map(str, published.chains)) == ["cpu", "meta"]
        meta_rep = fleet.replicas[1]
        fleet._on_replica_down(meta_rep, ReplicaKilled("killed for the test"))
        assert meta_rep.compiled is published.chain_for(META)
    finally:
        fleet.shutdown(drain=False)


class _Unpicklable(Transformer):
    """A node holding a tensor and a generator, which pickling refuses."""

    def __init__(self, W):
        self.W = W
        self.pending = (i for i in range(3))

    def forward(self, X):
        return X @ self.W


def test_a_one_device_fleet_finds_the_home_once_and_copies_nothing(monkeypatch):
    """A fleet on its chain's own device walks the chain once a version (to
    find its home) and never copies it; what pickling refuses in the chain
    does not stop it. Only a copy onto another device needs the inside."""
    from keystone_tpu_torch.parallel import placement

    calls = {"home": 0, "copy": 0}
    home, copy = placement.home_device, placement.copy_to_device

    def counted_home(obj):
        calls["home"] += 1
        return home(obj)

    def counted_copy(obj, device):
        calls["copy"] += 1
        return copy(obj, device)

    monkeypatch.setattr(placement, "home_device", counted_home)
    monkeypatch.setattr(placement, "copy_to_device", counted_copy)
    W = torch.eye(3)
    fitted = _Unpicklable(W).to_pipeline().fit()
    fleet = ServingFleet(fitted, replicas=2, buckets=(4,), datum_shape=(3,))
    assert calls == {"home": 1, "copy": 0}
    assert fleet.published.copies == 0 and fleet.published.chain_for(CPU).fitted is fitted
    with fleet:
        np.testing.assert_array_equal(
            np.asarray(fleet.predict(np.ones(3, np.float32), timeout=WAIT)), np.ones(3))
        fleet.swap(_Unpicklable(2 * W).to_pipeline().fit(), warmup=False)
        assert calls == {"home": 2, "copy": 0}
        np.testing.assert_array_equal(
            np.asarray(fleet.predict(np.ones(3, np.float32), timeout=WAIT)), 2 * np.ones(3))
    with pytest.raises(TypeError, match="cannot be copied"):
        copy(fitted, META)


def test_the_default_placement_and_the_copy_share_one_home_rule():
    """A chain whose first tensor is small on the CPU and whose bytes are
    mostly on ``meta`` lives on ``meta``: the default fleet places its
    replica there and serves the chain itself, copying nothing."""
    fitted = (_Holds(torch.ones(3, 3), torch.zeros(1)).to_pipeline()
              >> _Holds(torch.ones(3, 3), torch.zeros(4096))).fit()
    big = [op for op in _ops(fitted) if isinstance(op, _Holds)][1]
    big.W, big.view = big.W.to(META), big.view.to(META)
    fleet = ServingFleet(fitted, buckets=(4,), datum_shape=(3,))
    try:
        assert [r.device for r in fleet.replicas] == [META]
        published = fleet.published
        assert published.copies == 0 and published.chain_for(META).fitted is fitted
        assert copy_to_device(fitted, META) is fitted
    finally:
        fleet.shutdown(drain=False)


# ---------------------------------------------------------------------------
# the trainer's promotion
# ---------------------------------------------------------------------------


def test_the_trainers_promotion_reaches_every_replicas_chain():
    from tests.test_torch_trainer_daemon import (
        D, PORT, Traffic, fit_initial, make_chunk, make_daemon, wait_until)

    virtual.provision_virtual_devices(8)
    fitted, X0, _ = fit_initial(PORT)
    fleet = ServingFleet(fitted, buckets=(8,), datum_shape=(D,), max_wait_ms=1.0)
    assert fleet.n_replicas == 8
    log = PORT.ChunkLog()
    with fleet, Traffic(fleet, X0) as traffic:
        with make_daemon(PORT, fleet, log) as daemon:
            for seed in (1, 2):
                log.append(*make_chunk(64, seed))
            assert wait_until(lambda: fleet.metrics.count("refits") >= 1)
            promoted = daemon.fitted
        assert not traffic.failures
        assert fleet.fitted is promoted and fleet.model_version == 2
        chain = fleet.published.chain_for(CPU)
        assert chain.fitted is promoted
        assert all(r.compiled is chain and r.version == 2 for r in fleet.replicas)


# ---------------------------------------------------------------------------
# a loaded AOT program on its dispatcher's device
# ---------------------------------------------------------------------------


def test_a_loaded_program_is_placed_on_its_dispatchers_device():
    """A program's lifted constants load onto the device it was saved
    from; the dispatcher moves them, and the tensors its graph makes on
    that device, onto its own (two equal cards share one entry)."""
    import io

    from keystone_tpu_torch.compile.aot import _load_program, _place_program, _Program

    W = torch.randn(3, 2, generator=torch.Generator().manual_seed(0))
    exported = torch.export.export(_Program(lambda x: x @ W + torch.ones(2)),
                                   (torch.zeros(4, 3),), strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    program = _load_program(buf.getvalue())
    held = [t for t in vars(program).values() if isinstance(t, torch.Tensor)]
    assert held and all(t.device == CPU for t in held)
    assert _place_program(program, CPU) is program  # its own device: untouched
    placed = _place_program(program, META)
    held = [t for t in vars(placed).values() if isinstance(t, torch.Tensor)]
    assert held and all(t.device == META for t in held)
    assert all(n.kwargs.get("device") in (None, META) for n in placed.graph.nodes)
    out = placed(torch.zeros(4, 3, device=META))
    assert out.device == META and tuple(out.shape) == (4, 2)
