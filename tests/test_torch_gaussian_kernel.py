"""K1, the Gaussian kernel block: the port's plain version against the JAX
package's XLA form and its Pallas kernel (interpret mode), and the front
door's CPU dispatch. The CUDA kernel itself is tested in
test_torch_cuda_kernels.py; here a plain-torch emulation of its 3×TF32
arithmetic pins why it takes three tensor-core products and not one.

Tolerance rtol 1e-5, atol 1e-6, as the JAX package holds its Pallas kernel
against its XLA form: both sides are float32 with sums in another order.
The emulation is held to the card tests' rtol 1e-4, atol 1e-5 against the
plain version, and to 1e-6 of the float64 block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.learning.kernel import _gaussian_block_xla
from keystone_tpu.ops.gaussian_kernel import gaussian_kernel_block_pallas
from keystone_tpu_torch.nodes.learning import kernel as tkernel
from keystone_tpu_torch.ops import gaussian_kernel as tgk

# (n, d, b): a non-tile-multiple n, and ragged n, b and d
SHAPES = [(700, 128, 256), (37, 5, 3), (1, 800, 100), (513, 33, 129)]
GAMMA = 0.03


def _inputs(n, d, b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_xla(shape):
    X, Xb = _inputs(*shape)
    want = np.asarray(_gaussian_block_xla(jnp.asarray(X), jnp.asarray(Xb), GAMMA))
    got = tgk.gaussian_kernel_block_plain(torch.from_numpy(X), torch.from_numpy(Xb), GAMMA)
    assert got.shape == (shape[0], shape[2])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    X, Xb = _inputs(*shape, seed=1)
    want = np.asarray(gaussian_kernel_block_pallas(X, Xb, GAMMA, interpret=True))
    got = tgk.gaussian_kernel_block_plain(torch.from_numpy(X), torch.from_numpy(Xb), GAMMA)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits'
    weight to the magnitude, then clear them (the sign bit is untouched)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _emulated_kernel(X, Xb, gamma, passes=3):
    """An idealized 3×TF32 split in plain torch: x = hi + lo by TF32
    rounding, the cross term hi·hi + hi·lo + lo·hi (or hi·hi alone for one
    pass) in exact FP32 matmuls, and the plain version's FP32 epilogue. It
    pins the split, not the card's arithmetic: the tensor cores truncate as
    they accumulate, and the kernel's promotion of its partial sums every
    32 of d, which that calls for, is held only by the card tests."""
    xh, bh = _tf32_rna(X), _tf32_rna(Xb)
    c = xh @ bh.T
    if passes == 3:
        c = c + xh @ _tf32_rna(Xb - bh).T + _tf32_rna(X - xh) @ bh.T
    xn = torch.sum(X * X, dim=1, keepdim=True)
    bn = torch.sum(Xb * Xb, dim=1)
    return torch.exp(-gamma * torch.clamp_min(xn - 2.0 * c + bn, 0.0))


def test_tf32_split_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2**-11, -(1.0 + 2**-11), 1.0 + 2**-11 - 2**-23, 0.0, -0.0])
    assert _tf32_rna(x).tolist() == [1.0 + 2**-10, -(1.0 + 2**-10), 1.0, 0.0, -0.0]
    X, _ = _inputs(50, 40, 1)
    Xt = torch.from_numpy(X)
    hi = _tf32_rna(Xt)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    # hi + lo keeps 22 of float32's 24 bits: what is left is below 2^-21 relative
    resid = (Xt - hi - _tf32_rna(Xt - hi)).abs()
    assert torch.all(resid <= Xt.abs() * 2.0**-21)


@pytest.mark.parametrize("gamma", [GAMMA, 2e-4])
@pytest.mark.parametrize("shape", SHAPES)
def test_three_tf32_products_match_fp32(shape, gamma):
    X, Xb = (torch.from_numpy(a) for a in _inputs(*shape))
    emulated = _emulated_kernel(X, Xb, gamma)
    torch.testing.assert_close(emulated, tgk.gaussian_kernel_block_plain(X, Xb, gamma),
                               rtol=1e-4, atol=1e-5)
    exact = tgk.gaussian_kernel_block_plain(X.double(), Xb.double(), gamma)
    assert float((emulated.double() - exact).abs().max()) <= 1e-6


def test_one_tf32_pass_is_not_enough():
    X, Xb = (torch.from_numpy(a) for a in _inputs(513, 33, 129))
    one = _emulated_kernel(X, Xb, GAMMA, passes=1)
    assert not torch.allclose(one, tgk.gaussian_kernel_block_plain(X, Xb, GAMMA),
                              rtol=1e-4, atol=1e-5)
    exact = tgk.gaussian_kernel_block_plain(X.double(), Xb.double(), GAMMA)
    assert float((one.double() - exact).abs().max()) > 1e-5


def test_front_door_on_cpu_takes_plain_and_launches_nothing():
    X, Xb = _inputs(64, 16, 24)
    before = tgk.gaussian_kernel_block.launches
    got = tkernel._gaussian_block(torch.from_numpy(X), torch.from_numpy(Xb), GAMMA)
    want = tgk.gaussian_kernel_block_plain(torch.from_numpy(X), torch.from_numpy(Xb), GAMMA)
    assert torch.equal(got, want)
    assert tgk.gaussian_kernel_block.launches == before == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    X, Xb = _inputs(8, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tgk.gaussian_kernel_block(torch.from_numpy(X), torch.from_numpy(Xb), GAMMA)
    assert tgk.gaussian_kernel_block.launches == 0
