"""K1, the Gaussian kernel block: the port's plain version against the JAX
package's XLA form and its Pallas kernel (interpret mode), and the front
door's CPU dispatch. The CUDA kernel itself is tested in
test_torch_cuda_kernels.py.

Tolerance rtol 1e-5, atol 1e-6, as the JAX package holds its Pallas kernel
against its XLA form: both sides are float32 with sums in another order.
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
