"""The out-of-core weighted fit, the accumulator states and absorb on a
CUDA card: each against the same work on the CPU, and the device-drawn
ImageNet chunks across scans.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_weighted_streaming.py

Tolerances: the card against the CPU, predictions rtol 5e-3 / atol 5e-4
(the streaming-against-in-memory bound of the weighted tests) and states
1e-5 relative to their largest entry (float32 chunk products that round
apart, totalled in float64); one computation run twice on the card, and a
chunk drawn twice, bit-equal.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.linalg import weighted as lw
from keystone_tpu_torch.linalg.accumulators import GramSolverState
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.nodes.learning.weighted import (
    BlockWeightedLeastSquaresEstimator,
    PerClassWeightedLeastSquaresEstimator,
)
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as imagenet
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode

PRED_TOL = dict(rtol=5e-3, atol=5e-4)


@pytest.fixture(autouse=True)
def port_env():
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _problem(n=3000, d=64, k=20, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((k, d)).astype(np.float32) * 0.5
    labels = rng.integers(0, k, size=n)
    X = (means[labels] + rng.standard_normal((n, d))).astype(np.float32)
    Y = -np.ones((n, k), np.float32)
    Y[np.arange(n), labels] = 1.0
    return torch.from_numpy(X), torch.from_numpy(Y)


def _rel(got, want):
    return ((got.double().cpu() - want.double().cpu()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.cuda
def test_streaming_weighted_solve_on_the_card_matches_the_cpu(cuda):
    X, Y = _problem()
    est = BlockWeightedLeastSquaresEstimator(32, 2, 1e-3, 0.25, class_chunk=6)
    got = est.train_streaming(ChunkedDataset.from_array(X.to(cuda), 512), Y.to(cuda))
    want = est.train_streaming(ChunkedDataset.from_array(X, 512), Y)
    Xt = _problem(n=200, seed=1)[0]
    torch.testing.assert_close(got.forward(Xt.to(cuda)).cpu(), want.forward(Xt), **PRED_TOL)
    assert got.fit_info == want.fit_info
    # host chunks staged to the card by the scan give the same model
    staged = est.train_streaming(ChunkedDataset.from_array(X.numpy(), 512), Y.to(cuda))
    assert staged._W.device.type == cuda.type
    assert torch.equal(staged._W, got._W)


@pytest.mark.cuda
def test_class_row_grams_are_bit_stable_and_equal_the_masked_form(cuda):
    X, Y = _problem(n=4096, d=128, k=30, seed=2)
    A, y_idx = X.to(cuda), Y.argmax(1).to(cuda)
    rows = lw.ClassRows(y_idx, 30)
    first = rows.grams(A, 4, 12)
    again = torch.zeros_like(first)
    rows.grams(A, 4, 12, out=again)
    assert torch.equal(first, again)
    mask = torch.nn.functional.one_hot(y_idx, 30).float()[:, 4:12]
    masked = torch.einsum("nd,nc,ne->cde", A.double(), mask.double(), A.double())
    assert _rel(first, masked) <= 1e-5


@pytest.mark.cuda
def test_accumulator_states_on_the_card_match_the_cpu(cuda):
    X, Y = _problem(n=2048, d=48, k=6, seed=3)
    X = X + 40.0  # an offset mean: the shift must carry it
    gram, gram_cpu = GramSolverState(), GramSolverState()
    ws, ws_cpu = (lw.WeightedSolverState(lam=1e-3, mixture_weight=0.3, block_size=16)
                  for _ in range(2))
    for i in range(0, 2048, 300):
        gram.update(X[i:i + 300].to(cuda), Y[i:i + 300].to(cuda))
        gram_cpu.update(X[i:i + 300], Y[i:i + 300])
        ws.update(X[i:i + 300].to(cuda), Y[i:i + 300].to(cuda))
        ws_cpu.update(X[i:i + 300], Y[i:i + 300])
    for name in ("gram", "cross", "sum_x", "sum_y"):
        a, b = getattr(gram, name), getattr(gram_cpu, name)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
    for name in ("gram_s", "class_gram_s", "cross_s", "class_cross_s", "counts"):
        a, b = getattr(ws, name), getattr(ws_cpu, name)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
    W, b, mean = gram.solve(1e-2, device=cuda)
    W_cpu = gram_cpu.solve(1e-2)[0]
    assert W.device.type == cuda.type and _rel(W, W_cpu) <= 1e-4
    Wc, bc = ws.solve(device=cuda)
    assert _rel(Wc, ws_cpu.solve()[0]) <= 1e-4


@pytest.mark.cuda
def test_absorb_on_the_card_equals_the_fit_from_scratch(cuda):
    X, Y = _problem(n=2560, d=40, k=5, seed=4)
    X, Y = X.to(cuda), Y.to(cuda)
    feat = FunctionNode(batch_fn=lambda A: torch.tanh(A) * 2.0, label="feat").to_pipeline()
    for est in (lambda: LinearMapEstimator(lam=1e-2, snapshot=True),
                lambda: PerClassWeightedLeastSquaresEstimator(16, 1, 1e-2, 0.3, snapshot=True)):
        PipelineEnv.get_or_create().reset()
        fitted = feat.and_then(est(), ChunkedDataset.from_array(X[:2048], 256),
                               Dataset.of(Y[:2048])).fit()
        updated = fitted.absorb(ChunkedDataset.from_array(X[2048:], 256), Dataset.of(Y[2048:]))
        scratch = feat.and_then(est(), ChunkedDataset.from_array(X, 256), Dataset.of(Y)).fit()
        got = updated.apply(X[:300]).to_array()
        want = scratch.apply(X[:300]).to_array()
        assert got.device.type == cuda.type
        assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_device_drawn_imagenet_chunks_are_the_same_every_scan(cuda, monkeypatch):
    ds, labels = imagenet.synthetic_imagenet_device(200, 50, size=64, chunk_rows=32, seed=7,
                                                    device=cuda)
    first = ds.to_array()
    assert first.device.type == cuda.type and first.dtype == torch.uint8
    assert first.shape == (200, 64, 64, 3)
    assert torch.equal(first, ds.to_array())
    monkeypatch.setenv("KEYSTONE_SCAN_PIPELINE", "0")
    assert torch.equal(first, ds.to_array())
    chunk = next(iter(ds.raw_chunks(skip=3)))
    assert torch.equal(chunk, first[96:128])
    cpu_ds, cpu_labels = imagenet.synthetic_imagenet_device(200, 50, size=64, chunk_rows=32,
                                                            seed=7, device="cpu")
    # one generator a (seed, chunk): the CPU's draws are other numbers with
    # the same statistics
    assert abs(first.float().mean().item() - cpu_ds.to_array().float().mean().item()) < 2.0
    assert np.bincount(labels, minlength=50).max() < 20
