"""CUDA graphs on a CUDA card: a fused group replayed from its captured
graph against the eager run of the same chunking (bit-equal: the same
kernels on the same shapes), K1 launches counted per replay of a compiled
chain, and a capture made while another thread works on the card.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_compile.py
"""

import threading

import numpy as np
import pytest
import torch

from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
from keystone_tpu_torch.ops import gaussian_kernel as gk
from keystone_tpu_torch.pipelines import mnist_random_fft as tm
from keystone_tpu_torch.workflow import fusion
from keystone_tpu_torch.workflow.expressions import DatasetExpression
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import FittedPipeline


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _x(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.cuda
def test_captured_fused_group_is_bit_equal_to_eager(cuda, monkeypatch):
    fitted = tm.build_featurizer(tm.MnistRandomFFTConfig(num_ffts=3, seed=2), cuda).fit()
    (op,) = fitted.graph.operators.values()
    assert isinstance(op, fusion.FusedTransformerOperator) and op.row_local
    monkeypatch.setattr(fusion, "ROW_CHUNK", 64)
    X = torch.from_numpy(_x(200, 784, 3)).to(cuda)  # three full chunks and a tail of 8
    eager = fusion.forward_in_row_chunks(op.forward, [X], 200)
    for _ in range(2):  # the first call captures, the second only replays
        got = op.batch_transform([DatasetExpression.now(Dataset(X))]).to_array()
        torch.cuda.synchronize()
        assert torch.equal(got, eager)
    assert len(op.graphs(cuda)) == 2  # 64 rows and the tail of 8
    # a group that is not chunked: one whole-batch graph, its output a copy
    small = torch.from_numpy(_x(40, 784, 4)).to(cuda)
    first = op.batch_transform([DatasetExpression.now(Dataset(small))]).to_array()
    again = op.batch_transform([DatasetExpression.now(Dataset(small * 2))]).to_array()
    assert torch.equal(first, op.forward(small)) and not torch.equal(first, again)


def _k1_chain(cuda, n_train=300, d=16, block=128):
    train_X = torch.from_numpy(_x(n_train, d, 5)).to(cuda)
    W = torch.from_numpy(_x(n_train, 4, 6)).to(cuda)
    head = KernelBlockLinearMapper(train_X, W, gamma=0.05, block_size=block).to_pipeline()
    return FittedPipeline(head.graph, head.source, head.sink)


@pytest.mark.cuda
def test_compiled_k1_chain_counts_its_launches_per_replay(cuda):
    fitted = _k1_chain(cuda)  # 300 training rows in blocks of 128: 3 launches
    X = torch.from_numpy(_x(50, 16, 7)).to(cuda)
    want = fitted.apply(X).to_array()
    start = gk.gaussian_kernel_block.launches
    first = fitted.apply_compiled(X)
    # the warm-up launches 3; the capture launches none; its replay 3
    assert gk.gaussian_kernel_block.launches - start == 6
    second = fitted.apply_compiled(X)
    assert gk.gaussian_kernel_block.launches - start == 9
    torch.cuda.synchronize()
    assert torch.equal(first, want) and torch.equal(second, want)
    assert first.data_ptr() != second.data_ptr()  # each call's own tensor
    assert fitted.compiled_signatures == [((50, 16), "float32")]
    # chunked: two chunks of 32 rows, one graph, 3 launches per replay
    start = gk.gaussian_kernel_block.launches
    out = fitted.apply_chunked(X.cpu().numpy(), chunk_size=32).to_array()
    assert gk.gaussian_kernel_block.launches - start == 3 + 2 * 3
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert fitted.compile_count == 2


@pytest.mark.cuda
def test_capture_while_another_thread_works_is_safe(cuda):
    fitted = _k1_chain(cuda)
    X = torch.from_numpy(_x(64, 16, 8)).to(cuda)
    want = fitted.apply(X).to_array()
    A = torch.from_numpy(_x(256, 256, 9)).to(cuda)
    stop = threading.Event()
    errors = []

    def busy():
        try:
            ref = (A @ A).sum().item()
            while not stop.is_set():
                got = (A @ A).sum().item()  # a host sync on each round
                if abs(got - ref) > 1e-3 * abs(ref):
                    errors.append(got)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    worker = threading.Thread(target=busy)
    worker.start()
    try:
        outs = [fitted.apply_compiled(X) for _ in range(3)]
        outs.append(fitted.apply_chunked(X, chunk_size=16).to_array())
        torch.cuda.synchronize()
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive()
    assert errors == []
    for out in outs:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
