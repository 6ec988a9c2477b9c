"""The fault plan, the fit checkpoints and the scan seams of the port
(``keystone_tpu_torch/faults``, ``data/chunked.py``, ``data/pipeline_scan.py``)
against the JAX package's: the cases of ``tests/faults/test_plan.py``,
``test_checkpoint.py`` and ``test_scan_retry.py`` through both packages,
with the same plan text in each.

Tolerances are the JAX tests': resumed fits bit for bit, a fit under a
fault schedule within 1e-6 of the clean fit, the checkpointed TSQR within
1e-5 of the streaming one. The JAX scans run one lane. The JAX file's
``GridSweep`` case waits for ``sweep/``: its checkpoint contract is held on
``LinearMapEstimator.fit_lambda_grid``; its trace case waits for ``obs/``.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu import faults as jfaults
from keystone_tpu.data.chunked import ChunkedDataset as JChunked
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes.learning.linear import LinearMapEstimator as JLinearMapEstimator
from keystone_tpu_torch import faults
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.faults import FatalFaultInjected, FitCheckpoint
from keystone_tpu_torch.linalg.accumulators import GramSolverState, MomentsState, TsqrRState
from keystone_tpu_torch.nodes.learning.linear import (
    LinearMapEstimator,
    TSQRLeastSquaresEstimator,
)

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": jfaults, "port": faults}


@pytest.fixture(autouse=True)
def no_plan_left(monkeypatch):
    """Neither package's plan, nor ``KEYSTONE_FAULTS``, outlives a test."""
    monkeypatch.setenv("KEYSTONE_SCAN_LANES", "1")
    monkeypatch.delenv("KEYSTONE_FAULTS", raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()
    os.environ.pop("KEYSTONE_FAULTS", None)


def _specs(plan):
    return {site: [(s.site, s.kind, s.at, s.rate, s.limit, s.seed, s.match) for s in specs]
            for site, specs in plan._by_site.items()}


# ---- the plan ------------------------------------------------------------------


def test_parse_index_clause_defaults_to_first_invocation():
    plans = {k: m.parse_plan("scan.chunk=transient") for k, m in PACKAGES.items()}
    spec = plans["port"]._by_site["scan.chunk"][0]
    assert spec.kind == "transient" and spec.at == frozenset((0,))
    assert _specs(plans["port"]) == _specs(plans["jax"])


def test_parse_multi_clause_with_indices_match_and_probabilistic():
    text = "scan.chunk=transient@2,5;replica.batch#1=kill@3;scan.stage=fatal@p0.25x2s7"
    plans = {k: m.parse_plan(text) for k, m in PACKAGES.items()}
    plan = plans["port"]
    assert set(plan.sites) == {"scan.chunk", "replica.batch", "scan.stage"}
    assert plan._by_site["scan.chunk"][0].at == frozenset((2, 5))
    rb = plan._by_site["replica.batch"][0]
    assert rb.kind == "kill" and rb.match == 1 and rb.at == frozenset((3,))
    st = plan._by_site["scan.stage"][0]
    assert st.at is None and (st.rate, st.limit, st.seed) == (0.25, 2, 7)
    assert _specs(plan) == _specs(plans["jax"])


@pytest.mark.parametrize("bad", [
    "scan.chunk",                 # no '='
    "scan.chunk=explode",         # unknown kind
    "scan.chunk=transient@p1.5",  # rate out of range
    "scan.chunk=transient@x,y",   # non-integer indices
    "",                           # empty plan
    "scan.chunk#a=kill",          # non-integer match
])
def test_parse_rejects_bad_clauses_loudly(bad):
    for m in PACKAGES.values():
        with pytest.raises(ValueError):
            m.parse_plan(bad)


def test_index_clause_fires_exactly_at_its_invocations():
    for m in PACKAGES.values():
        plan = m.parse_plan("s=transient@1,3")
        hits = [plan.check("s", {}) for _ in range(6)]
        assert hits == [None, "transient", None, "transient", None, None]
        assert plan.injected["s"] == 2


def test_probabilistic_clause_is_seeded_and_bounded():
    runs = {}
    for k, m in PACKAGES.items():
        plan = m.parse_plan("s=transient@p0.5x3s42")
        runs[k] = [plan.check("s", {}) is not None for _ in range(40)]
        again = m.parse_plan("s=transient@p0.5x3s42")
        assert [again.check("s", {}) is not None for _ in range(40)] == runs[k]
        assert sum(runs[k]) == 3  # the x3 bound
        other = m.parse_plan("s=transient@p0.5x3s43")
        assert [other.check("s", {}) is not None for _ in range(40)] != runs[k]
    assert runs["port"] == runs["jax"]


def test_match_clause_counts_only_matching_invocations():
    for m in PACKAGES.values():
        plan = m.parse_plan("replica.batch#0=transient@1")
        assert plan.check("replica.batch", {"replica": 1}) is None
        assert plan.check("replica.batch", {"replica": 0}) is None  # index 0
        assert plan.check("replica.batch", {"replica": 1}) is None
        assert plan.check("replica.batch", {"replica": 0}) == "transient"


def test_reset_replays_the_identical_schedule():
    firsts = {}
    for k, m in PACKAGES.items():
        plan = m.parse_plan("s=transient@p0.4x5s9")
        firsts[k] = [plan.check("s", {}) for _ in range(30)]
        plan.reset()
        assert [plan.check("s", {}) for _ in range(30)] == firsts[k]
    assert firsts["port"] == firsts["jax"]


@pytest.mark.parametrize("text", [
    "scan.chunk=transient@p0.3x5s13;scan.stage=transient@2",
    "scan.chunk=transient@2,5;scan.chunk=fatal@12",
    "scan.chunk=fatal@p0.1s3;scan.chunk=transient@0,1,2",
    "replica.batch#1=kill@3;replica.batch=transient@p0.5x4s1",
])
def test_both_packages_fire_the_same_schedule(text):
    """One invocation sequence through each package's plan: the same kinds
    at the same invocations, clause order and seeded draws included."""
    calls = [("scan.chunk", {}), ("scan.stage", {}), ("replica.batch", {"replica": 1}),
             ("replica.batch", {"replica": 0})] * 15
    plans = {k: m.parse_plan(text) for k, m in PACKAGES.items()}
    seqs = {k: [p.check(site, attrs) for site, attrs in calls] for k, p in plans.items()}
    assert seqs["port"] == seqs["jax"]
    assert any(seqs["port"])
    assert plans["port"].injected == plans["jax"].injected


def test_fault_point_raises_typed_errors_and_noop_without_plan():
    faults.fault_point("scan.chunk")  # no plan: nothing
    faults.install(faults.parse_plan("a=transient@0;b=fatal@0;c=kill@0"))
    with pytest.raises(faults.FaultInjected) as ei:
        faults.fault_point("a")
    assert isinstance(ei.value, faults.TransientError)
    with pytest.raises(FatalFaultInjected):
        faults.fault_point("b")
    assert not faults.is_transient(FatalFaultInjected("b", 0))
    with pytest.raises(faults.ReplicaKilled) as ki:
        faults.fault_point("c")
    assert not isinstance(ki.value, Exception)  # passes `except Exception`
    faults.clear()
    faults.fault_point("a")  # cleared: nothing again


def test_env_plan_is_cached_on_raw_string(monkeypatch):
    for m in PACKAGES.values():
        m.clear()
        monkeypatch.setenv("KEYSTONE_FAULTS", "x=transient@0")
        p1 = m.active_plan()
        assert p1 is m.active_plan()  # same string: the same plan object
        with pytest.raises(m.FaultInjected):
            m.fault_point("x")
        m.fault_point("x")  # invocation 1: the counters persist
        monkeypatch.setenv("KEYSTONE_FAULTS", "x=transient@1")
        p2 = m.active_plan()
        assert p2 is not p1  # a new string: a fresh parse, fresh counters
        m.fault_point("x")
        with pytest.raises(m.FaultInjected):
            m.fault_point("x")
        monkeypatch.delenv("KEYSTONE_FAULTS")
        assert m.active_plan() is None


def test_transient_classification_covers_stdlib_families():
    assert faults.is_transient(ConnectionResetError())
    assert faults.is_transient(TimeoutError())
    assert not faults.is_transient(ValueError())
    assert not faults.is_transient(faults.ReplicaKilled("k"))


def test_retry_reexports_the_plans_classes():
    from keystone_tpu_torch.faults import retry

    assert retry.TransientError is faults.plan.TransientError
    assert retry.is_transient is faults.plan.is_transient
    assert (retry.SCAN_CHUNK, retry.SCAN_STAGE) == (jfaults.SCAN_CHUNK, jfaults.SCAN_STAGE)


def test_fault_point_without_a_plan_does_nothing():
    assert faults.active_plan() is None
    for site in (faults.SCAN_CHUNK, faults.SCAN_STAGE, faults.REPLICA_BATCH, "anything"):
        assert faults.fault_point(site, replica=0) is None
    assert faults.active_plan() is None
    os.environ["KEYSTONE_FAULTS"] = "  "  # blank: off
    assert faults.active_plan() is None


def test_every_site_constant_is_the_jax_packages():
    names = ("SCAN_CHUNK", "SCAN_STAGE", "REPLICA_BATCH", "AOT_READ", "WORKER_SPAWN",
             "TRAINER_INGEST", "TRAINER_ABSORB", "TRAINER_CANARY", "SCALE_SPAWN", "SCALE_DRAIN")
    assert {n: getattr(faults, n) for n in names} == {n: getattr(jfaults, n) for n in names}
    assert sorted(faults.__all__) == sorted(jfaults.__all__)


# ---- the checkpoint store ----------------------------------------------------------


def test_round_trip_preserves_every_accumulator_bit_for_bit(tmp_path):
    rng = np.random.RandomState(0)
    gram = GramSolverState()
    gram.update(rng.randn(8, 4).astype(np.float32), rng.randn(8, 2).astype(np.float32))
    tsqr = TsqrRState()
    tsqr.update(rng.randn(8, 4).astype(np.float32))
    mom = MomentsState()
    mom.update(rng.randn(8, 4))
    ck = FitCheckpoint(str(tmp_path), "k1")
    ck.save({"gram": gram, "tsqr": tsqr, "mom": mom}, 3, 24)
    state, chunk, rows = ck.load()
    assert (chunk, rows) == (3, 24)
    assert np.array_equal(state["gram"].gram, gram.gram)
    assert np.array_equal(state["gram"].cross, gram.cross)
    assert np.array_equal(state["gram"].shift, gram.shift)
    assert np.array_equal(state["tsqr"].r, tsqr.r)
    assert np.array_equal(state["mom"].m2, mom.m2)
    # the same file name as the JAX package's for the same key
    assert os.path.basename(ck.path) == os.path.basename(
        jfaults.FitCheckpoint(str(tmp_path / "j"), "k1").path)


def test_missing_corrupt_and_truncated_degrade_to_fresh(tmp_path):
    ck = FitCheckpoint(str(tmp_path), "k")
    assert ck.load() is None  # missing
    ck.save(MomentsState(), 1, 8)
    with open(ck.path, "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff\xff")
    assert ck.load() is None  # the checksum fails
    assert not os.path.exists(ck.path)  # and the entry was deleted
    ck.save(MomentsState(), 1, 8)
    blob = open(ck.path, "rb").read()
    with open(ck.path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    assert ck.load() is None  # truncated


def test_foreign_key_is_ignored_not_resumed(tmp_path):
    a = FitCheckpoint(str(tmp_path), "fit-a")
    a.save(MomentsState(), 2, 16)
    b = FitCheckpoint(str(tmp_path), "fit-b")
    b.path = a.path  # a prefix collision, or misuse
    assert b.load() is None
    assert os.path.exists(a.path)  # kept, not deleted


def test_save_is_atomic_no_tmp_left_and_complete_removes(tmp_path):
    ck = FitCheckpoint(str(tmp_path), "k")
    for i in range(4):
        ck.save(MomentsState(), i, i * 8)
    assert [f for f in os.listdir(tmp_path) if f.startswith(".tmp")] == []
    assert ck.exists()
    ck.complete()
    assert not ck.exists()
    ck.complete()  # idempotent


def test_unpicklable_header_is_a_miss(tmp_path):
    import hashlib

    ck = FitCheckpoint(str(tmp_path), "k")
    payload = b"not a pickle"
    with open(ck.path, "wb") as f:
        f.write(b"KSFITCKPT1\n" + hashlib.sha256(payload).digest() + payload)
    assert ck.load() is None


def test_a_jax_checkpoint_is_a_miss_left_on_disk_and_imports_nothing(tmp_path):
    """A JAX checkpoint under the same key lands on the same file: the port
    reads it as another fit's (a miss), leaves it, and imports nothing of
    the JAX package while trying (checked in a process without it)."""
    from keystone_tpu.linalg.accumulators import GramSolverState as JGram

    rng = np.random.RandomState(1)
    state = JGram()
    state.update(rng.randn(8, 4).astype(np.float32), rng.randn(8, 2).astype(np.float32))
    key = "gram_ne|n=8|y=(8, 2)|lams=[0.5]"
    jck = jfaults.FitCheckpoint(str(tmp_path), key)
    jck.save(state, 1, 8)
    assert FitCheckpoint(str(tmp_path), key).path == jck.path
    code = (
        "import sys, os\n"
        "from keystone_tpu_torch.faults import FitCheckpoint\n"
        f"ck = FitCheckpoint({str(tmp_path)!r}, {key!r})\n"
        "assert ck.load() is None\n"
        "assert os.path.exists(ck.path)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'keystone_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)
    assert FitCheckpoint(str(tmp_path), key).load() is None
    assert os.path.exists(jck.path)
    assert jck.load() is not None  # still the JAX fit's, untouched


class _Call:
    """Pickles as a call of ``fn(*args)``, as a hostile payload would."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("call", ["builtins.open", "numpy.save", "os.mkdir"])
def test_a_payload_naming_another_global_is_a_miss_and_calls_nothing(tmp_path, call):
    """The unpickler admits the globals a state names, not every callable of
    numpy or of this package: a payload that would call anything else is
    another fit's, left on disk, and nothing it names runs."""
    import builtins
    import hashlib
    import pickle

    sentinel = str(tmp_path / "called")
    fn, args = {"builtins.open": (builtins.open, (sentinel, "w")),
                "numpy.save": (np.save, (sentinel, np.zeros(1))),
                "os.mkdir": (os.mkdir, (sentinel,))}[call]
    ck = FitCheckpoint(str(tmp_path / "ck"), "k")
    payload = pickle.dumps({"key": "k", "chunk": 1, "rows": 8, "state": _Call(fn, *args)},
                           protocol=4)
    with open(ck.path, "wb") as f:
        f.write(b"KSFITCKPT1\n" + hashlib.sha256(payload).digest() + payload)
    assert ck.load() is None
    assert os.path.exists(ck.path)
    assert not any(p.startswith("called") for p in os.listdir(tmp_path))


# ---- kill-and-resume fits ----------------------------------------------------------


def _fit_problem(chunked, n=96, d=12, k=3, chunk_rows=16, label="ckfit"):
    """The JAX test's problem in ``chunked``'s package, with the chunk
    indices it produces."""
    rng = np.random.RandomState(4)
    X = rng.randn(n, d).astype(np.float32)
    Y = rng.randn(n, k).astype(np.float32)
    chunks = [X[i:i + chunk_rows] for i in range(0, n, chunk_rows)]
    produced = []

    def chunk_fn(i):
        produced.append(i)
        return chunks[i]

    return chunked.from_chunk_fn(chunk_fn, len(chunks), n, label=label), Y, produced


def _port_problem(**kw):
    ds, Y, produced = _fit_problem(ChunkedDataset, **kw)
    return ds, Dataset.of(torch.from_numpy(Y)), produced


def _killed(fit, text):
    """Run ``fit()`` under the plan ``text`` in the port; it must die with
    the fatal fault."""
    faults.install(faults.parse_plan(text))
    with pytest.raises(FatalFaultInjected):
        fit()
    faults.clear()


def test_killed_gram_fit_resumes_bit_identical_and_skips_folded(tmp_path):
    ds, labels, produced = _port_problem()
    ref = LinearMapEstimator(lam=0.5, snapshot=True).fit(ds, labels)
    produced.clear()
    fit = lambda: LinearMapEstimator(lam=0.5, snapshot=True, checkpoint=str(tmp_path)).fit(
        ds, labels)
    _killed(fit, "scan.chunk=fatal@3")
    assert sorted(set(produced)) == [0, 1, 2]
    produced.clear()
    resumed = fit()
    assert sorted(set(produced)) == [3, 4, 5]  # only the chunks not folded
    for attr in ("gram", "cross", "sum_x", "sum_y", "shift", "shift_y"):
        assert np.array_equal(getattr(ref.solver_state, attr),
                              getattr(resumed.solver_state, attr)), attr
    assert ref.solver_state.n == resumed.solver_state.n
    assert torch.equal(ref.W, resumed.W)
    assert os.listdir(tmp_path) == []  # the finished fit removed its checkpoint
    # the JAX package kills and resumes at the same chunks
    jds, Y, jproduced = _fit_problem(JChunked)
    jfit = lambda: JLinearMapEstimator(lam=0.5, snapshot=True,
                                       checkpoint=str(tmp_path / "jax")).fit(
        jds, JDataset(Y, batched=True))
    jfaults.install(jfaults.parse_plan("scan.chunk=fatal@3"))
    with pytest.raises(jfaults.FatalFaultInjected):
        jfit()
    jfaults.clear()
    assert sorted(set(jproduced)) == [0, 1, 2]
    jproduced.clear()
    jfit()
    assert sorted(set(jproduced)) == [3, 4, 5]


def test_killed_tsqr_fit_resumes_without_refolding(tmp_path):
    ds, labels, produced = _port_problem(label="cktsqr")
    ref = TSQRLeastSquaresEstimator(lam=0.5, checkpoint=str(tmp_path / "ref")).fit(ds, labels)
    produced.clear()
    fit = lambda: TSQRLeastSquaresEstimator(lam=0.5, checkpoint=str(tmp_path / "kill")).fit(
        ds, labels)
    _killed(fit, "scan.chunk=fatal@10")  # in the fold, after the means scan
    killed_at = list(produced)
    assert sorted(set(killed_at)) == [0, 1, 2, 3, 4, 5]
    produced.clear()
    resumed = fit()
    # the means were saved with the first checkpoint: no means scan again,
    # and the fold resumes after the chunks it saved
    assert produced == [3, 4, 5]
    assert torch.equal(ref.W, resumed.W)
    assert torch.equal(ref.feature_mean, resumed.feature_mean)


def test_a_resumed_fit_reads_its_checkpoint_once_and_saves_no_last_block(tmp_path,
                                                                         monkeypatch):
    """A fold reads its checkpoint once, so the means scan and the fold
    decide from one read; a fit saves every block but the last, whose save
    the completion would remove unread."""
    saves, loads = [], []
    orig_save, orig_load = FitCheckpoint.save, FitCheckpoint.load

    def save(ck, state, chunk, rows):
        saves.append(chunk)
        orig_save(ck, state, chunk, rows)

    def load(ck):
        out = orig_load(ck)
        loads.append(out is not None)
        return out

    monkeypatch.setattr(FitCheckpoint, "save", save)
    monkeypatch.setattr(FitCheckpoint, "load", load)
    ds, labels, produced = _port_problem(label="once")
    TSQRLeastSquaresEstimator(lam=0.5, checkpoint=str(tmp_path / "whole")).fit(ds, labels)
    LinearMapEstimator(lam=0.5, checkpoint=str(tmp_path / "gram"), checkpoint_every=2).fit(
        ds, labels)
    assert saves == [0, 1, 2, 3, 4, 5, 2, 4] and loads == [False, False]
    saves.clear(), loads.clear()
    fit = lambda: TSQRLeastSquaresEstimator(lam=0.5, checkpoint=str(tmp_path / "kill")).fit(
        ds, labels)
    _killed(fit, "scan.chunk=fatal@9")  # the means scan's 7 pulls, then chunks 0 and 1
    assert saves == [0, 1, 2] and loads == [False]
    saves.clear(), loads.clear(), produced.clear()
    fit()
    assert loads == [True] and saves == [3, 4, 5] and produced == [2, 3, 4, 5]


def test_tsqr_checkpoint_path_matches_the_streaming_path(tmp_path):
    """The JAX case holds the checkpointed fold against its laned one; the
    port's streaming TSQR is its one-lane form."""
    ds, labels, _ = _port_problem(label="cmp")
    streamed = TSQRLeastSquaresEstimator(lam=0.25).fit(ds, labels)
    ck = TSQRLeastSquaresEstimator(lam=0.25, checkpoint=str(tmp_path)).fit(ds, labels)
    assert float((streamed.W - ck.W).abs().max()) <= 1e-5


def test_grid_fit_keeps_the_checkpoint_contract(tmp_path):
    """The JAX case runs a ``GridSweep``, whose shared accumulation is
    ``LinearMapEstimator.fit_lambda_grid``: a killed grid run again resumes
    from the cursor instead of scanning from chunk zero."""
    ds, labels, produced = _port_problem(label="gridck")
    ests = [LinearMapEstimator(lam=lam, checkpoint=str(tmp_path)) for lam in (0.1, 1.0)]
    fit = lambda: LinearMapEstimator.fit_lambda_grid(ests, ds, labels, checkpoint=str(tmp_path))
    _killed(fit, "scan.chunk=fatal@3")
    produced.clear()
    res = fit()
    assert len(res) == 2
    assert sorted(set(produced)) == [3, 4, 5]  # resumed, not scanned again
    clean = LinearMapEstimator.fit_lambda_grid(ests, ds, labels)
    for a, b in zip(res, clean):
        assert torch.equal(a.W, b.W)


def test_checkpoint_key_change_starts_fresh(tmp_path):
    """Another λ is another fit: its checkpoint is not resumed."""
    ds, labels, produced = _port_problem(label="ckkey")
    _killed(lambda: LinearMapEstimator(lam=0.5, snapshot=True, checkpoint=str(tmp_path)).fit(
        ds, labels), "scan.chunk=fatal@3")
    produced.clear()
    LinearMapEstimator(lam=2.0, snapshot=True, checkpoint=str(tmp_path)).fit(ds, labels)
    assert sorted(set(produced)) == [0, 1, 2, 3, 4, 5]


# ---- retrying scans --------------------------------------------------------------


@pytest.fixture
def retries_on(monkeypatch):
    monkeypatch.setenv("KEYSTONE_SCAN_RETRIES", "8")
    monkeypatch.setenv("KEYSTONE_SCAN_RETRY_BACKOFF", "0.001")


def _datasets(n=48, d=6, chunk_rows=8, label="retry"):
    """The JAX test's dataset in both packages."""
    rng = np.random.RandomState(3)
    X = rng.randn(n, d).astype(np.float32)
    chunks = [X[i:i + chunk_rows] for i in range(0, n, chunk_rows)]
    return X, {k: cls.from_chunk_fn(lambda i: chunks[i], len(chunks), n, label=label)
               for k, cls in (("port", ChunkedDataset), ("jax", JChunked))}


def _scan_both(text, scan):
    """``scan(dataset)`` under the plan ``text`` in each package: the
    results and each plan's injected counts."""
    out, injected = {}, {}
    _, dss = _datasets()
    for k, m in PACKAGES.items():
        m.install(m.parse_plan(text))
        out[k] = [np.asarray(c) for c in scan(dss[k])]
        injected[k] = dict(m.active_plan().injected)
        m.clear()
    return out, injected


def test_injected_chunk_faults_retry_with_bitwise_parity(retries_on):
    X, dss = _datasets()
    clean = [np.asarray(c) for c in dss["port"].chunks()]
    out, injected = _scan_both("scan.chunk=transient@1,3,4", lambda ds: ds.chunks())
    for got in out.values():
        assert len(got) == len(clean)
        assert all(np.array_equal(a, b) for a, b in zip(clean, got))
    assert injected["port"] == injected["jax"] == {"scan.chunk": 3}


def test_injected_staging_faults_retry_in_place(retries_on):
    X, _ = _datasets()
    out, injected = _scan_both("scan.stage=transient@0,2,4", lambda ds: ds.chunks())
    for got in out.values():
        assert np.array_equal(np.concatenate(got, axis=0), X)
    assert injected["port"] == injected["jax"] == {"scan.stage": 3}


def test_raw_scan_is_injected_too(retries_on):
    out, injected = _scan_both("scan.chunk=transient@2", lambda ds: list(ds.raw_chunks()))
    assert len(out["port"]) == len(out["jax"]) == 6
    assert injected["port"] == injected["jax"] == {"scan.chunk": 1}


def test_budget_exhaustion_propagates_the_original_error(retries_on, monkeypatch):
    monkeypatch.setenv("KEYSTONE_SCAN_RETRIES", "2")
    _, dss = _datasets()
    for k, m in PACKAGES.items():
        # 4 faults at one site > 2 retries: the third surfaces
        m.install(m.parse_plan("scan.chunk=transient@0,1,2,3"))
        with pytest.raises(m.FaultInjected):
            list(dss[k].chunks())
        m.clear()


def test_retries_default_off(monkeypatch):
    monkeypatch.delenv("KEYSTONE_SCAN_RETRIES", raising=False)
    _, dss = _datasets()
    for k, m in PACKAGES.items():
        m.install(m.parse_plan("scan.chunk=transient@0"))
        with pytest.raises(m.FaultInjected):
            list(dss[k].chunks())
        m.clear()


def test_transient_chunk_fn_failures_retry_for_real_sources(retries_on):
    rng = np.random.RandomState(0)
    chunks = [rng.randn(8, 4).astype(np.float32) for _ in range(5)]
    for cls, err in ((ChunkedDataset, faults.TransientError),
                     (JChunked, jfaults.TransientError)):
        failures = {1: 2, 3: 1}  # chunk index: the times it fails first

        def chunk_fn(i):
            if failures.get(i, 0) > 0:
                failures[i] -= 1
                raise err(f"flaky read of chunk {i}")
            return chunks[i]

        got = [np.asarray(c) for c in cls.from_chunk_fn(chunk_fn, 5, 40, label="flaky").chunks()]
        assert len(got) == 5 and all(np.array_equal(a, b) for a, b in zip(chunks, got))
        assert all(v == 0 for v in failures.values())


def test_nontransient_chunk_fn_failure_is_not_retried(retries_on):
    for cls in (ChunkedDataset, JChunked):
        calls = []

        def chunk_fn(i):
            calls.append(i)
            raise ValueError("deterministic bug")

        with pytest.raises(ValueError, match="deterministic bug"):
            list(cls.from_chunk_fn(chunk_fn, 3, 12, label="bug").chunks())
        assert calls == [0]  # one attempt, no retry


def test_fit_under_chunk_fault_schedule_matches_clean_to_1e6(retries_on):
    """A streaming fit under a chunk and staging fault schedule completes,
    within 1e-6 of the clean fit (the JAX test's gate), with the JAX fit's
    injected counts."""
    rng = np.random.RandomState(11)
    n, d, k = 128, 10, 2
    X = rng.randn(n, d).astype(np.float32)
    Y = X @ rng.randn(d, k).astype(np.float32) + 0.01 * rng.randn(n, k).astype(np.float32)
    chunks = [X[i:i + 16] for i in range(0, n, 16)]
    text = "scan.chunk=transient@p0.3x5s13;scan.stage=transient@2"
    ds = ChunkedDataset.from_chunk_fn(lambda i: chunks[i], len(chunks), n, label="fitfault")
    labels = Dataset.of(torch.from_numpy(Y))
    clean = LinearMapEstimator(lam=0.1).fit(ds, labels)
    faults.install(faults.parse_plan(text))
    faulted = LinearMapEstimator(lam=0.1).fit(ds, labels)
    injected = dict(faults.active_plan().injected)
    assert sum(injected.values()) >= 1, injected
    assert float((clean.W - faulted.W).abs().max()) <= 1e-6
    jds = JChunked.from_chunk_fn(lambda i: chunks[i], len(chunks), n, label="fitfault")
    jfaults.install(jfaults.parse_plan(text))
    JLinearMapEstimator(lam=0.1).fit(jds, JDataset(Y, batched=True))
    assert injected == dict(jfaults.active_plan().injected)


def test_a_kill_at_scan_chunk_reaches_the_caller_and_the_producer_ends(retries_on):
    """A ``kill`` raised on the producer thread (a BaseException) ends the
    scan in the consumer as ``ReplicaKilled`` after the chunks before it,
    and the producer thread is joined: no hang."""
    _, dss = _datasets(label="killed")
    faults.install(faults.parse_plan("scan.chunk=kill@3"))
    result = {}

    def consume():
        got = []
        try:
            for c in dss["port"].chunks():
                got.append(c)
        except faults.ReplicaKilled as e:
            result["error"] = e
        result["chunks"] = len(got)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "the scan hung on a kill"
    assert isinstance(result.get("error"), faults.ReplicaKilled)
    assert result["chunks"] == 3
    deadline = time.monotonic() + 10
    while (any(th.name.startswith("ks-scan[killed") for th in threading.enumerate())
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert not any(th.name.startswith("ks-scan[killed") for th in threading.enumerate())
