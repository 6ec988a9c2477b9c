"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA card and nvcc; elsewhere they skip. They import
neither JAX nor the JAX package, so a machine without JAX runs them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance rtol 1e-4, atol 1e-5: float32 sums in another order than cuBLAS.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import gaussian_kernel as gk

# (n, d, b): a non-tile-multiple n, ragged n, b and d, and the KRR shape
SHAPES = [(700, 128, 256), (37, 5, 3), (1, 800, 100), (513, 33, 129), (10000, 800, 5000)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


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
def test_gaussian_kernel_refuses_what_it_does_not_take(cuda):
    X = torch.randn(8, 4, device=cuda)
    with pytest.raises(TypeError):
        gk.gaussian_kernel_block(X.double(), X.double(), 0.1)
    with pytest.raises(ValueError):
        gk.gaussian_kernel_block(X, torch.randn(8, 5, device=cuda), 0.1)
    with pytest.raises(ValueError):
        gk.gaussian_kernel_block(X.t(), X.t(), 0.1)  # rows not contiguous
