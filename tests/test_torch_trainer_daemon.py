"""``TrainerDaemon`` on the port (``keystone_tpu_torch/trainer/daemon.py``)
against the JAX package's: the five cases of ``tests/trainer/
test_daemon.py`` and the five of ``test_chaos.py``, each run on both
packages' fleets with the same appends and the same fault plans. Each
case's own assertions hold in both packages; across them the promoted W
agrees within 1e-5 relative to its largest entry (the two packages'
float32 chunk products round apart), and the trainer's counters, the
parked ranges, and the flight ring's ``trainer.*`` instant names and
batch ranges are equal.

Appends that a drift verdict depends on go through a gated log: the
daemon's ``tail`` waits while the test appends a group, so both packages
observe the same groups in the same ticks and freeze the same batches.

And the port's divergence: a kernel or device fault (``ops.is_device_fault``)
in the monitor or the absorb is not a monitor failure, not retried, not
parked and not restarted: the daemon stops (``trainer.dead``, a
``device_fault`` dump), a later ``start`` raises ``TrainerStopped`` chained
to it, and the fleet serves on with the old model. A Python error in the
absorb is retried and parked, as in the JAX package.

Every wait is bounded."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import keystone_tpu.faults as jfaults
import keystone_tpu.obs.flight as jflight
from keystone_tpu.data.chunked import ChunkedDataset as JChunked
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes.learning import LinearMapEstimator as JLinearMapEstimator
from keystone_tpu.serving import ServingFleet as JServingFleet
from keystone_tpu.trainer import ChunkLog as JChunkLog
from keystone_tpu.trainer import TrainerDaemon as JTrainerDaemon
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.pipeline import FittedPipeline as JFittedPipeline
from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
from keystone_tpu_torch import faults
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.obs import flight
from keystone_tpu_torch.ops import KernelError
from keystone_tpu_torch.serving import ServingFleet
from keystone_tpu_torch.trainer import ChunkLog, TrainerDaemon, TrainerStopped
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline
from keystone_tpu_torch.workflow.transformer import FunctionNode

D, K = 12, 3
_W_TRUE = np.random.RandomState(42).randn(D, K).astype(np.float32)
WAIT = 30.0
W_RTOL = 1e-5
TRAINER_COUNTERS = ("refits", "rollbacks", "parked_batches", "absorb_failures",
                    "absorbed_chunks", "absorbed_rows", "batch_retries", "trainer_restarts",
                    "trainer_crashes", "ingest_failures", "monitor_failures")


@pytest.fixture(autouse=True)
def envs(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    # every trainer instant of a case stays in the ring beside the
    # replicas' batch spans
    monkeypatch.setenv("KEYSTONE_FLIGHT_RING", str(1 << 16))
    for pkg in (PORT, JAX):
        pkg.env.get_or_create().reset()
        pkg.faults.clear()
        pkg.flight.reset()
    yield
    for pkg in (PORT, JAX):
        pkg.faults.clear()
        pkg.flight.reset()
        pkg.env.get_or_create().reset()


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def make_chunk(n, seed, shift=0.0, scale=1.0):
    r = np.random.RandomState(seed)
    X = (r.randn(n, D) * scale + 1.0 + shift).astype(np.float32)
    Y = (np.tanh(X) @ _W_TRUE + 0.05 * r.randn(n, K)).astype(np.float32)
    return X, Y


def _port_fit(source, Y, lam):
    return (FunctionNode(batch_fn=torch.tanh, label="feat").to_pipeline()
            .and_then(LinearMapEstimator(lam=lam, snapshot=True), source,
                      Dataset.of(torch.from_numpy(Y))).fit())


def _jax_fit(source, Y, lam):
    return (JFunctionNode(batch_fn=lambda A: jnp.tanh(A), label="feat").to_pipeline()
            .and_then(JLinearMapEstimator(lam=lam, snapshot=True), source, JDataset.of(Y))
            .fit())


PORT = SimpleNamespace(
    name="port", ChunkLog=ChunkLog, TrainerDaemon=TrainerDaemon, ServingFleet=ServingFleet,
    faults=faults, flight=flight, env=PipelineEnv, FittedPipeline=FittedPipeline,
    fit=_port_fit, chunked=lambda factory, n: ChunkedDataset(factory, n, label="concat"),
    from_array=lambda X, rows: ChunkedDataset.from_array(torch.from_numpy(X), rows))
JAX = SimpleNamespace(
    name="jax", ChunkLog=JChunkLog, TrainerDaemon=JTrainerDaemon, ServingFleet=JServingFleet,
    faults=jfaults, flight=jflight, env=JPipelineEnv, FittedPipeline=JFittedPipeline,
    fit=_jax_fit, chunked=lambda factory, n: JChunked(factory, n, label="concat"),
    from_array=JChunked.from_array)


def fit_initial(pkg, n=384, chunk_rows=64, lam=1e-2):
    X0, Y0 = make_chunk(n, 0)
    return pkg.fit(pkg.from_array(X0, chunk_rows), Y0, lam), X0, Y0


def make_fleet(pkg, fitted, replicas=2):
    return pkg.ServingFleet(fitted, replicas=replicas, buckets=(8,), datum_shape=(D,),
                            max_wait_ms=1.0, max_queue=1024)


def make_daemon(pkg, fleet, log, **kw):
    kw.setdefault("poll_interval_s", 0.01)
    kw.setdefault("refit_interval_s", 0.05)
    kw.setdefault("min_refit_chunks", 2)
    kw.setdefault("canary_fraction", 1.0)
    kw.setdefault("canary_batches", 1)
    kw.setdefault("canary_timeout_s", 3.0)
    kw.setdefault("canary_atol", 0.5)
    kw.setdefault("canary_rtol", 0.5)
    kw.setdefault("max_batch_retries", 0)
    return pkg.TrainerDaemon(fleet, log, **kw)


def gated_log(pkg):
    """A chunk log whose ``tail`` and ``append_group`` exclude each other:
    a group is seen by one tick, whole."""

    class Gated(pkg.ChunkLog):
        def __init__(self):
            super().__init__()
            self._group = threading.Lock()

        def tail(self, cursor):
            with self._group:
                return super().tail(cursor)

        def append_group(self, chunks):
            with self._group:
                for X, Y in chunks:
                    self.append(X, Y)

    return Gated()


class Traffic:
    """Closed-loop submitters; every failure is recorded (the gates assert
    none)."""

    def __init__(self, fleet, data, clients=3):
        self._fleet = fleet
        self._data = data
        self._stop = threading.Event()
        self.failures = []
        self._threads = [threading.Thread(target=self._run, args=(t, clients), daemon=True)
                         for t in range(clients)]

    def _run(self, tid, step):
        i = tid
        while not self._stop.is_set():
            try:
                self._fleet.predict(self._data[i % len(self._data)], timeout=15.0)
            except Exception as e:
                self.failures.append(repr(e))
            i += step

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)


def wait_until(pred, timeout=WAIT):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


def model_state(fitted):
    ops = [op for op in fitted.graph.operators.values()
           if getattr(op, "solver_state", None) is not None]
    assert len(ops) == 1
    return ops[0]


def record(pkg, fleet, daemon, **extra):
    """What the two packages must agree on after a case."""
    instants = [(e["name"], e.get("attrs", {}).get("batch_start"),
                 e.get("attrs", {}).get("batch_stop"))
                for e in pkg.flight.recorder().entries()
                if e["kind"] == "instant" and e["name"].startswith("trainer.")]
    return dict(counters={k: fleet.metrics.count(k) for k in TRAINER_COUNTERS},
                parked=daemon.parked_batches, instants=instants,
                W=_np(model_state(daemon.fitted).W), **extra)


def both(case, *args):
    """Run ``case`` on the JAX package, then on the port, and hold the
    port's record to JAX's."""
    want = case(JAX, *args)
    got = case(PORT, *args)
    assert got["counters"] == want["counters"]
    assert got["parked"] == want["parked"]
    assert got["instants"] == want["instants"]
    scale = np.max(np.abs(want["W"]))
    assert np.max(np.abs(got["W"] - want["W"])) <= W_RTOL * scale
    for key in set(want) - {"counters", "parked", "instants", "W"}:
        assert got[key] == want[key], key
    return got, want


# ---------------------------------------------------------------------------
# test_daemon.py
# ---------------------------------------------------------------------------


def _cadence_case(pkg):
    fitted, X0, Y0 = fit_initial(pkg)
    fleet = make_fleet(pkg, fitted)
    log = pkg.ChunkLog()
    Xa, Ya = make_chunk(64, 1)
    Xb, Yb = make_chunk(64, 2)
    with fleet, Traffic(fleet, X0) as traffic:
        with make_daemon(pkg, fleet, log) as daemon:
            log.append(Xa, Ya)
            log.append(Xb, Yb)
            assert wait_until(lambda: fleet.metrics.count("refits") >= 1)
            promoted = daemon.fitted
        assert not traffic.failures
        assert fleet.fitted is promoted
        assert fleet.model_version == 2

    def factory():
        for i in range(0, 384, 64):
            yield X0[i:i + 64]
        yield Xa
        yield Xb

    scratch = pkg.fit(pkg.chunked(factory, 512), np.concatenate([Y0, Ya, Yb]), 1e-2)
    got, want = model_state(promoted), model_state(scratch)
    assert np.max(np.abs(_np(got.W) - _np(want.W))) <= 1e-6
    assert got.solver_state.n == 512
    return record(pkg, fleet, daemon)


def test_cadence_promote_matches_from_scratch_fit():
    """Two appended chunks promote on the cadence trigger; the promoted
    model's solver state equals a from-scratch fit on the concatenated data
    (same chunk boundaries) to 1e-6, and the fleet serves it."""
    got, _ = both(_cadence_case)
    assert got["instants"] == [("trainer.promote", 0, 2)]


def _drift_case(pkg):
    fitted, X0, _ = fit_initial(pkg)
    fleet = make_fleet(pkg, fitted)
    log = gated_log(pkg)
    with fleet, Traffic(fleet, X0) as traffic:
        daemon = make_daemon(pkg, fleet, log, refit_interval_s=None, min_refit_chunks=1,
                             canary_atol=5.0, canary_rtol=5.0, drift_kwargs={"min_rows": 128})
        with daemon:
            # stationary appends: no trigger
            log.append_group([make_chunk(64, 10 + s) for s in (1, 2, 3)])
            time.sleep(0.5)
            assert fleet.metrics.count("refits") == 0
            # shifted appends: z = |shift| / sqrt(var / n) ≈ 16 over 256 rows
            log.append_group([make_chunk(64, 20 + s, shift=1.0) for s in (1, 2, 3, 4)])
            assert wait_until(lambda: fleet.metrics.count("refits") >= 1)
        assert not traffic.failures
    return record(pkg, fleet, daemon)


def test_drift_trigger_refits_without_cadence():
    """With the cadence off, a mean shift in the appended stream trips the
    drift trigger and promotes; a stationary stream does not."""
    got, _ = both(_drift_case)
    assert got["instants"] == [("trainer.promote", 0, 7)]


def _poison_case(pkg):
    fitted, X0, _ = fit_initial(pkg)
    fleet = make_fleet(pkg, fitted)
    log = pkg.ChunkLog()
    probe = X0[:8]
    with fleet, Traffic(fleet, X0) as traffic:
        with make_daemon(pkg, fleet, log, max_batch_retries=1) as daemon:
            before = np.asarray([np.asarray(fleet.predict(row, timeout=15.0)) for row in probe])
            for _ in range(2):
                log.append(np.full((64, D), 1e4, np.float32), np.full((64, K), -1e4, np.float32))
            assert wait_until(lambda: bool(daemon.parked_batches))
            assert daemon.parked_batches == [(0, 2)]
            # one retry allowed: exactly 2 rollbacks
            assert fleet.metrics.count("rollbacks") == 2
            assert fleet.metrics.count("refits") == 0
            assert fleet.model_version == 1
            after = np.asarray([np.asarray(fleet.predict(row, timeout=15.0)) for row in probe])
            np.testing.assert_array_equal(before, after)
            # the loop is not poisoned: a good batch still promotes
            for s in (1, 2):
                log.append(*make_chunk(64, 30 + s))
            assert wait_until(lambda: fleet.metrics.count("refits") >= 1)
        assert not traffic.failures
    return record(pkg, fleet, daemon)


def test_poisoned_batch_rolls_back_parks_and_old_model_serves():
    """A poisoned batch fails its canary, is parked after its retries, the
    old model keeps serving bit-equal outputs, and a later good batch still
    promotes."""
    got, _ = both(_poison_case)
    assert got["instants"] == [("trainer.rollback", 0, 2), ("trainer.rollback", 0, 2),
                               ("trainer.park", 0, 2), ("trainer.promote", 2, 4)]


def _metrics_case(pkg):
    fitted, X0, _ = fit_initial(pkg)
    fleet = make_fleet(pkg, fitted, replicas=1)
    log = pkg.ChunkLog()
    with fleet, Traffic(fleet, X0, clients=1) as traffic:
        with make_daemon(pkg, fleet, log) as daemon:
            stale_before = daemon.staleness_s()
            for s in (1, 2):
                log.append(*make_chunk(64, 40 + s))
            assert wait_until(lambda: fleet.metrics.count("refits") >= 1)
            assert daemon.staleness_s() < stale_before + 30
            snap = fleet.metrics.snapshot()
        assert not traffic.failures
    assert snap["counters"]["absorbed_chunks"] == 2
    assert snap["counters"]["absorbed_rows"] == 128
    g = snap["gauges"]
    assert "drift_score" in g and "staleness_s" in g
    assert g["trainer_backlog"] == 0
    return record(pkg, fleet, daemon, gauges=sorted(g))


def test_metrics_and_staleness():
    both(_metrics_case)


def _only_new_case(pkg):
    fitted, _, _ = fit_initial(pkg)
    fleet = make_fleet(pkg, fitted, replicas=1)
    log = pkg.ChunkLog()
    with fleet:
        with make_daemon(pkg, fleet, log, canary_fraction=0.0) as daemon:
            for s in (1, 2):
                log.append(*make_chunk(64, 50 + s))
            assert wait_until(lambda: fleet.metrics.count("refits") >= 1)
            assert log.production_counts == {0: 1, 1: 1}
            for s in (3, 4):
                log.append(*make_chunk(64, 50 + s))
            assert wait_until(lambda: fleet.metrics.count("refits") >= 2)
            assert log.production_counts == {0: 1, 1: 1, 2: 1, 3: 1}
    assert model_state(daemon.fitted).solver_state.n == 384 + 256
    return record(pkg, fleet, daemon, productions=dict(log.production_counts))


def test_absorb_through_daemon_scans_only_new_chunks():
    """A promoted refresh produced each of its chunks exactly once, and a
    second refresh never produces the first one's chunks again."""
    both(_only_new_case)


# ---------------------------------------------------------------------------
# test_chaos.py
# ---------------------------------------------------------------------------


def _kill_case(pkg, tmp_path):
    fitted, _, _ = fit_initial(pkg)
    # the uninterrupted reference: the same batch, no faults
    batch = [make_chunk(32, 60 + s) for s in range(4)]
    ref_log = pkg.ChunkLog()
    for X, Y in batch:
        ref_log.append(X, Y)
    ds, labels = ref_log.as_chunked(0, 4)
    ref_state = model_state(fitted.absorb(ds, labels)).solver_state

    fleet = make_fleet(pkg, fitted, replicas=1)
    log = pkg.ChunkLog()
    pkg.faults.install(pkg.faults.parse_plan("trainer.absorb=kill@2"))
    ckpt = tmp_path / f"ckpt-{pkg.name}"
    ckpt.mkdir()
    with fleet:
        daemon = make_daemon(pkg, fleet, log, min_refit_chunks=4, canary_fraction=0.0,
                             checkpoint_dir=str(ckpt), max_restarts=1)
        with daemon:
            for X, Y in batch:
                log.append(X, Y)
            assert wait_until(lambda: fleet.metrics.count("refits") >= 1)
            got_state = model_state(daemon.fitted).solver_state
    assert pkg.faults.active_plan().injected.get("trainer.absorb") == 1
    pkg.faults.clear()
    assert fleet.metrics.count("trainer_restarts") == 1
    for a in ("gram", "cross", "sum_x"):
        assert np.array_equal(getattr(got_state, a), getattr(ref_state, a)), a
    assert got_state.n == ref_state.n
    # chunks 0 and 1 were folded before the kill and never produced again;
    # chunk 2 (killed in its on_chunk) twice
    counts = dict(log.production_counts)
    if pkg is JAX:
        assert counts == {0: 1, 1: 1, 2: 2, 3: 1}
    else:
        # the port's producer thread runs up to KEYSTONE_SCAN_DEPTH chunks
        # ahead of the fold: chunk 3 may have been produced, unfolded,
        # before the kill, and is produced again by the resume
        assert {i: counts[i] for i in (0, 1, 2)} == {0: 1, 1: 1, 2: 2}
        assert counts[3] in (1, 2) and set(counts) == {0, 1, 2, 3}
    return record(pkg, fleet, daemon)


def test_kill_during_absorb_resumes_bit_identical(tmp_path):
    """trainer.absorb=kill@2: the third folded chunk kills the loop; the
    supervisor restarts it, the retried absorb resumes from the checkpoint
    at chunk 2, and the promoted state is bit-identical to an uninterrupted
    absorb."""
    got, _ = both(_kill_case, tmp_path)
    assert got["instants"] == [("trainer.restart", None, None), ("trainer.promote", 0, 4)]


def _canary_park_case(pkg):
    fitted, X0, _ = fit_initial(pkg)
    fleet = make_fleet(pkg, fitted, replicas=1)
    log = pkg.ChunkLog()
    pkg.faults.install(pkg.faults.parse_plan("trainer.canary=transient@0,1"))
    probe = X0[:8]
    with fleet:
        before = np.asarray([np.asarray(fleet.predict(row, timeout=15.0)) for row in probe])
        with make_daemon(pkg, fleet, log, max_batch_retries=1) as daemon:
            for s in (1, 2):
                log.append(*make_chunk(64, 70 + s))
            assert wait_until(lambda: bool(daemon.parked_batches))
        after = np.asarray([np.asarray(fleet.predict(row, timeout=15.0)) for row in probe])
    pkg.faults.clear()
    assert daemon.parked_batches == [(0, 2)]
    assert fleet.metrics.count("rollbacks") == 2
    assert fleet.metrics.count("batch_retries") == 1
    assert fleet.metrics.count("refits") == 0
    assert fleet.model_version == 1
    np.testing.assert_array_equal(before, after)
    return record(pkg, fleet, daemon)


def test_injected_canary_failure_rolls_back_then_quarantines():
    """trainer.canary=transient@0,1 with one retry allowed: both attempts
    fail the canary, the batch parks, the old model serves bit-equal
    outputs, nothing promoted."""
    both(_canary_park_case)


def _canary_retry_case(pkg):
    fitted, _, _ = fit_initial(pkg)
    fleet = make_fleet(pkg, fitted, replicas=1)
    log = pkg.ChunkLog()
    pkg.faults.install(pkg.faults.parse_plan("trainer.canary=transient@0"))
    with fleet:
        with make_daemon(pkg, fleet, log, max_batch_retries=1) as daemon:
            for s in (1, 2):
                log.append(*make_chunk(64, 80 + s))
            assert wait_until(lambda: fleet.metrics.count("refits") >= 1)
            assert not daemon.parked_batches
    pkg.faults.clear()
    assert fleet.metrics.count("rollbacks") == 1
    assert fleet.model_version == 2
    return record(pkg, fleet, daemon)


def test_injected_canary_failure_then_clean_retry_promotes():
    """trainer.canary=transient@0 only: the first attempt rolls back, the
    retry passes, and the same batch promotes."""
    both(_canary_retry_case)


def _ingest_case(pkg):
    fitted, _, _ = fit_initial(pkg)
    fleet = make_fleet(pkg, fitted, replicas=1)
    log = pkg.ChunkLog()
    pkg.faults.install(pkg.faults.parse_plan("trainer.ingest=transient@0,1"))
    with fleet:
        with make_daemon(pkg, fleet, log, canary_fraction=0.0) as daemon:
            for s in (1, 2):
                log.append(*make_chunk(64, 90 + s))
            assert wait_until(lambda: fleet.metrics.count("refits") >= 1)
    pkg.faults.clear()
    assert fleet.metrics.count("ingest_failures") == 2
    assert fleet.metrics.count("trainer_restarts") == 0
    return record(pkg, fleet, daemon)


def test_ingest_transient_faults_are_retried():
    """trainer.ingest=transient@0,1: two flaky tails are absorbed by the
    ingest retry; the loop neither dies nor loses chunks."""
    got, _ = both(_ingest_case)
    assert [name for name, _, _ in got["instants"]] == [
        "trainer.ingest_fault", "trainer.ingest_fault", "trainer.promote"]


def _replica_kill_case(pkg):
    fitted, X0, _ = fit_initial(pkg)
    fleet = make_fleet(pkg, fitted, replicas=2)
    log = pkg.ChunkLog()
    with fleet:
        # a wide canary window: the promotion must not outrun the kill
        # scheduled inside it
        daemon = make_daemon(pkg, fleet, log, canary_batches=32, canary_timeout_s=45.0)
        with daemon:
            for s in (1, 2):
                log.append(*make_chunk(64, 95 + s))
            # the window is open once the shadow hook is installed; traffic
            # starts only after, so nothing mirrors before the kill is set
            assert wait_until(lambda: any(r._shadow is not None for r in fleet.replicas),
                              timeout=20.0)
            pkg.faults.install(pkg.faults.parse_plan("replica.batch#1=kill@0"))
            with Traffic(fleet, X0) as traffic:
                assert wait_until(lambda: fleet.metrics.count("restarts") >= 1, timeout=20.0)
                report = fleet.version_report()
                # re-pinned to the old model
                assert not report["skew"], report
                assert wait_until(lambda: fleet.metrics.count("refits") >= 1, timeout=30.0)
        pkg.faults.clear()
        assert not traffic.failures
        report = fleet.version_report()
    assert report["version"] == 2
    assert not report["skew"], report
    assert {row["version"] for row in report["replicas"].values()} == {2}
    assert fleet.metrics.count("restarts") >= 1
    return record(pkg, fleet, daemon, version=report["version"])


def test_replica_kill_mid_swap_no_version_skew():
    """A replica dies inside an open canary window: supervision restarts it
    pinned to the old version; the canary completes on live traffic, the
    promotion flips every replica, with no skew and no failed request."""
    both(_replica_kill_case)


# ---------------------------------------------------------------------------
# the port's divergence: a device fault stops the trainer
# ---------------------------------------------------------------------------


def _raising(error):
    def fail(self, *args, **kwargs):
        raise error
    return fail


@pytest.mark.parametrize("where, error", [
    ("absorb", KernelError("the kernel's launch failed")),
    ("absorb", torch.cuda.OutOfMemoryError("CUDA out of memory")),
    ("prefix_features", KernelError("the kernel's launch failed")),
], ids=["absorb-kernel", "absorb-oom", "monitor-kernel"])
def test_a_device_fault_stops_the_trainer_and_the_fleet_serves_on(where, error, monkeypatch,
                                                                  tmp_path):
    fitted, X0, _ = fit_initial(PORT)
    fleet = make_fleet(PORT, fitted)
    log = ChunkLog()
    probe = X0[:8]
    with fleet:
        before = np.asarray([fleet.predict(row, timeout=15.0) for row in probe])
        monkeypatch.setattr(FittedPipeline, where, _raising(error))
        daemon = make_daemon(PORT, fleet, log, max_batch_retries=1, max_restarts=2)
        with daemon:
            for s in (1, 2):
                log.append(*make_chunk(64, 110 + s))
            assert wait_until(lambda: daemon.device_fault is not None)
            with pytest.raises(TrainerStopped) as stopped:
                daemon.start()
            assert stopped.value.__cause__ is error
        monkeypatch.undo()
        after = np.asarray([fleet.predict(row, timeout=15.0) for row in probe])
        assert fleet.model_version == 1 and fleet.fitted is fitted
    np.testing.assert_array_equal(before, after)
    c = {k: fleet.metrics.count(k) for k in TRAINER_COUNTERS}
    assert c["trainer_crashes"] == 1
    for key in ("refits", "trainer_restarts", "absorb_failures", "monitor_failures",
                "batch_retries", "parked_batches"):
        assert c[key] == 0, (key, c)
    assert daemon.parked_batches == []
    names = [e["name"] for e in flight.recorder().entries()
             if e["kind"] == "instant" and e["name"].startswith("trainer.")]
    assert names == ["trainer.dead"]
    assert list(tmp_path.glob("keystone-flight-*-device_fault-*.json"))


def _python_error_case(pkg, monkeypatch):
    monkeypatch.setattr(pkg.FittedPipeline, "absorb", _raising(RuntimeError("a bug in the fold")))
    try:
        fitted, _, _ = fit_initial(pkg)
        fleet = make_fleet(pkg, fitted, replicas=1)
        log = pkg.ChunkLog()
        with fleet:
            with make_daemon(pkg, fleet, log, max_batch_retries=1) as daemon:
                for s in (1, 2):
                    log.append(*make_chunk(64, 120 + s))
                assert wait_until(lambda: bool(daemon.parked_batches))
    finally:
        monkeypatch.undo()
    return record(pkg, fleet, daemon)


def test_a_python_error_in_the_absorb_is_retried_and_parked_as_in_jax(monkeypatch):
    got, _ = both(_python_error_case, monkeypatch)
    assert got["parked"] == [(0, 2)]
    assert got["counters"]["absorb_failures"] == 2
    assert got["counters"]["trainer_restarts"] == 0
