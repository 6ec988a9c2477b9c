"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA card and nvcc; elsewhere they skip. They import
neither JAX nor the JAX package, so a machine without JAX runs them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance rtol 1e-4, atol 1e-5: float32 sums in another order than cuBLAS.
The float64 check holds K1's 3×TF32 cross term to 1e-6 of the exact value
at the CIFAR γ, where one TF32 pass is ~1e-5 off.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import gaussian_kernel as gk
from keystone_tpu_torch.workflow.cuda_graph import GraphCache

# (n, d, b): a non-tile-multiple n, ragged n, b and d, the KRR shape; d not a
# multiple of 4 and below one k8 step; b below one tile with n just past
# one; several persistent tiles both ways
SHAPES = [(700, 128, 256), (37, 5, 3), (1, 800, 100), (513, 33, 129), (10000, 800, 5000),
          (300, 7, 40), (129, 800, 17), (4100, 96, 700)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _randn(shape, device, seed=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_kernel_matches_plain(cuda, shape):
    n, d, b = shape
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    Xb = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(cuda)
    before = gk.gaussian_kernel_block.launches
    got = gk.gaussian_kernel_block(X, Xb, 0.03)
    torch.cuda.synchronize()
    assert gk.gaussian_kernel_block.launches == before + 1
    torch.testing.assert_close(got, gk.gaussian_kernel_block_plain(X, Xb, 0.03),
                               rtol=1e-4, atol=1e-5)
    # a strided row block, as the KRR step passes it
    rows = X[1:1 + max(1, n // 2)]
    torch.testing.assert_close(gk.gaussian_kernel_block(X, rows, 0.03),
                               gk.gaussian_kernel_block_plain(X, rows, 0.03),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_gaussian_kernel_row_slice_off_16_byte_alignment(cuda):
    X = _randn((600, 33), cuda)[1:]  # rows 132 B apart, the first 4 B past a 16 B edge
    Xb = _randn((70, 33), cuda, seed=3)
    assert X.data_ptr() % 16 != 0
    torch.testing.assert_close(gk.gaussian_kernel_block(X, Xb, 0.03),
                               gk.gaussian_kernel_block_plain(X, Xb, 0.03),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gk.gaussian_kernel_block(Xb, X, 0.03),
                               gk.gaussian_kernel_block_plain(Xb, X, 0.03),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_gaussian_kernel_self_block_diagonal_is_one(cuda):
    X = _randn((3000, 800), cuda)
    r, b = 1000, 700
    K = gk.gaussian_kernel_block(X, X[r:r + b], 2e-4)
    diag = K[r:r + b].diagonal()
    assert float(diag.min()) >= 1.0 - 1e-5
    assert float(diag.max()) <= 1.0


@pytest.mark.cuda
def test_gaussian_kernel_float64_accuracy_at_the_krr_shape(cuda):
    # 3×TF32 lands within 1e-6 of the exact block; one TF32 pass is ~1.3e-5 off
    X = _randn((10000, 800), cuda)
    Xb = _randn((5000, 800), cuda, seed=3)
    got = gk.gaussian_kernel_block(X, Xb, 2e-4).double()
    exact = gk.gaussian_kernel_block_plain(X.double(), Xb.double(), 2e-4)
    assert float((got - exact).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_gaussian_kernel_replays_inside_a_cuda_graph(cuda):
    X = _randn((1000, 96), cuda)
    Xb = _randn((300, 96), cuda, seed=3)
    eager = gk.gaussian_kernel_block(X, Xb, 0.03)
    # a plain capture: nothing launches and the thread's captured count grows
    graph = torch.cuda.CUDAGraph()
    gk.gaussian_kernel_block(X, Xb, 0.03)  # warm-up outside the capture
    torch.cuda.synchronize()
    launches, captured = gk.gaussian_kernel_block.launches, gk.captured_launches()
    with torch.cuda.graph(graph):
        static = gk.gaussian_kernel_block(X, Xb, 0.03)
    assert gk.captured_launches() == captured + 1
    assert gk.gaussian_kernel_block.launches == launches
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, eager)
    # through the port's graph cache: one launch counted per replay
    cache = GraphCache(lambda a, b: gk.gaussian_kernel_block(a, b, 0.03))
    cache(X, Xb)  # the warm-up, the capture and one replay
    for _ in range(3):
        before = gk.gaussian_kernel_block.launches
        out = cache(X, Xb)
        torch.cuda.synchronize()
        assert gk.gaussian_kernel_block.launches == before + 1
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_gaussian_kernel_refuses_what_it_does_not_take(cuda):
    X = torch.randn(8, 4, device=cuda)
    with pytest.raises(TypeError):
        gk.gaussian_kernel_block(X.double(), X.double(), 0.1)
    with pytest.raises(ValueError):
        gk.gaussian_kernel_block(X, torch.randn(8, 5, device=cuda), 0.1)
    with pytest.raises(ValueError):
        gk.gaussian_kernel_block(X.t(), X.t(), 0.1)  # rows not contiguous
