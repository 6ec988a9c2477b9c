"""Faults and resumed fits on a CUDA card: a fatal fault and a kill in a
scan that copies host chunks on its copy stream, and checkpointed fits
killed and resumed, each against its uninterrupted run on the card.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_faults.py

Tolerance: none; a resumed fit and a fit under transient faults equal the
uninterrupted fit bit for bit (the same chunks, in the same order, folded
into the same host float64 totals).
"""

import os
import threading

import numpy as np
import pytest
import torch

from keystone_tpu_torch import faults
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.linear import (
    LinearMapEstimator,
    TSQRLeastSquaresEstimator,
)
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode

JOIN_TIMEOUT = 60.0


@pytest.fixture(autouse=True)
def no_plan_left(monkeypatch):
    monkeypatch.delenv("KEYSTONE_FAULTS", raising=False)
    monkeypatch.setenv("KEYSTONE_SCAN_RETRIES", "4")
    monkeypatch.setenv("KEYSTONE_SCAN_RETRY_BACKOFF", "0.001")
    faults.clear()
    PipelineEnv.get_or_create().reset()
    yield
    faults.clear()
    PipelineEnv.get_or_create().reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _host_chunks(n_chunks=8, rows=512, d=64):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((rows, d)).astype(np.float32) + 1.0 for _ in range(n_chunks)]


def _card_source(dev, n_chunks=8, rows=512, d=48, k=3):
    """Chunks drawn on the card from a generator made anew for each index
    (a retry or a later scan draws the same chunk), their labels, and the
    indices drawn."""
    drawn = []
    W = torch.randn(d, k, device=dev, generator=torch.Generator(dev).manual_seed(1))

    def draw(i):
        gen = torch.Generator(dev).manual_seed(1000 + i)
        return torch.randn(rows, d, device=dev, generator=gen) + 2.0

    def chunk_fn(i):
        drawn.append(i)
        return draw(i)

    Y = torch.cat([draw(i) @ W for i in range(n_chunks)]) + 0.5
    ds = ChunkedDataset.from_chunk_fn(chunk_fn, n_chunks, n_chunks * rows, label="card")
    return ds, Dataset.of(Y), drawn


def _scan_in_thread(it):
    """Consume ``it`` on another thread: (chunks, the error raised), or a
    failure when it does not end within the join timeout."""
    out = {"chunks": 0, "error": None}

    def run():
        try:
            for _ in it:
                out["chunks"] += 1
        except BaseException as e:  # noqa: BLE001 — what the scan raised
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(JOIN_TIMEOUT)
    assert not t.is_alive(), "the scan hung"
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind, error", [("fatal", faults.FatalFaultInjected),
                                         ("kill", faults.ReplicaKilled)])
def test_a_fault_in_a_card_scan_ends_it_and_a_new_scan_runs(cuda, kind, error):
    chunks = _host_chunks()
    ds = ChunkedDataset.from_chunk_fn(lambda i: chunks[i], len(chunks), 8 * 512,
                                      label=f"copy-{kind}")
    faults.install(faults.parse_plan(f"scan.chunk={kind}@3"))
    out = _scan_in_thread(ds.chunks(device=cuda))
    assert isinstance(out["error"], error) and out["chunks"] == 3
    assert not any(t.name.startswith(f"ks-scan[copy-{kind}") and t.is_alive()
                   for t in threading.enumerate())
    faults.clear()
    got = torch.cat(list(ds.chunks(device=cuda)))
    assert got.is_cuda and torch.equal(got.cpu(), torch.from_numpy(np.concatenate(chunks)))


@pytest.mark.cuda
def test_transient_faults_in_a_card_scan_retry_to_the_same_chunks(cuda):
    chunks = _host_chunks()
    ds = ChunkedDataset.from_chunk_fn(lambda i: chunks[i], len(chunks), 8 * 512)
    clean = torch.cat(list(ds.chunks(device=cuda)))
    plan = faults.install(faults.parse_plan("scan.chunk=transient@1,4;scan.stage=transient@2"))
    faulted = torch.cat(list(ds.chunks(device=cuda)))
    assert torch.equal(clean, faulted)
    assert plan.injected == {"scan.chunk": 2, "scan.stage": 1}


@pytest.mark.cuda
def test_a_killed_gram_fit_resumes_bit_equal_on_the_card(cuda, tmp_path):
    ds, labels, drawn = _card_source(cuda)
    whole = LinearMapEstimator(0.5, snapshot=True).fit(ds, labels)
    # the fatal clause counts the pulls the transient one does not take: its
    # 7th is chunk 6's, after the save at 6 chunks
    faults.install(faults.parse_plan("scan.chunk=transient@1;scan.stage=transient@3;"
                                     "scan.chunk=fatal@6"))
    with pytest.raises(faults.FatalFaultInjected):
        LinearMapEstimator(0.5, checkpoint=str(tmp_path), checkpoint_every=2).fit(ds, labels)
    faults.install(faults.parse_plan("scan.chunk=transient@0"))
    drawn.clear()
    resumed = LinearMapEstimator(0.5, checkpoint=str(tmp_path), checkpoint_every=2).fit(
        ds, labels)
    assert drawn == [6, 7]
    for attr in ("gram", "cross", "sum_x", "sum_y", "shift", "shift_y"):
        assert np.array_equal(getattr(whole.solver_state, attr),
                              getattr(resumed.solver_state, attr)), attr
    assert resumed.W.is_cuda and torch.equal(whole.W, resumed.W)
    assert os.listdir(tmp_path) == []


@pytest.mark.cuda
def test_a_killed_tsqr_fit_resumes_bit_equal_on_the_card(cuda, tmp_path):
    ds, labels, drawn = _card_source(cuda)
    whole = TSQRLeastSquaresEstimator(0.5, checkpoint=str(tmp_path / "whole"),
                                      checkpoint_every=3).fit(ds, labels)
    # the means scan pulls 9 times (8 chunks and its end); then chunk 7's pull
    faults.install(faults.parse_plan("scan.chunk=fatal@16"))
    with pytest.raises(faults.FatalFaultInjected):
        TSQRLeastSquaresEstimator(0.5, checkpoint=str(tmp_path / "killed"),
                                  checkpoint_every=3).fit(ds, labels)
    faults.clear()
    drawn.clear()
    resumed = TSQRLeastSquaresEstimator(0.5, checkpoint=str(tmp_path / "killed"),
                                        checkpoint_every=3).fit(ds, labels)
    assert drawn == [6, 7]
    assert torch.equal(whole.W, resumed.W) and torch.equal(whole.b, resumed.b)
    plain = TSQRLeastSquaresEstimator(0.5).fit(ds, labels)
    rel = (torch.linalg.norm(plain.W - whole.W) / torch.linalg.norm(plain.W)).item()
    assert rel < 1e-3, rel


@pytest.mark.cuda
def test_a_killed_absorb_resumes_bit_equal_on_the_card(cuda, tmp_path):
    ds, labels, drawn = _card_source(cuda, n_chunks=6)
    Y = labels.to_array()
    feat = FunctionNode(batch_fn=lambda X: torch.tanh(X) * 2.0, label="feat")
    base = ChunkedDataset.from_array(torch.randn(1024, 48, device=cuda) + 2.0, 256)
    fitted = feat.to_pipeline().and_then(LinearMapEstimator(0.1, snapshot=True), base,
                                         Dataset.of(Y[:1024])).fit()
    clean = fitted.absorb(ds, labels)
    faults.install(faults.parse_plan("scan.chunk=fatal@4"))
    with pytest.raises(faults.FatalFaultInjected):
        fitted.absorb(ds, labels, checkpoint=str(tmp_path), checkpoint_every=2)
    faults.clear()
    drawn.clear()
    resumed = fitted.absorb(ds, labels, checkpoint=str(tmp_path), checkpoint_every=2)
    assert drawn == [4, 5]

    def model(f):
        (m,) = [op for op in f.graph.operators.values() if hasattr(op, "solver_state")]
        return m

    assert np.array_equal(model(clean).solver_state.gram, model(resumed).solver_state.gram)
    assert torch.equal(model(clean).W, model(resumed).W)
    assert os.listdir(tmp_path) == []
