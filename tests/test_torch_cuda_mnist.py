"""MnistRandomFFT on a CUDA card against the same run on the CPU: cuFFT and
cuBLAS against the CPU's FFT and BLAS, with the same signs and data.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_mnist.py

Tolerance 1e-3 on the scores: float32 FFT and GEMM sums in another order,
carried through a 512-column block solve.
"""

import pytest
import torch

from keystone_tpu_torch.pipelines import mnist_random_fft as tm
from keystone_tpu_torch.workflow.env import PipelineEnv


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_small_mnist_on_the_card_matches_the_cpu(cuda):
    train, test = tm.synthetic_mnist(4096, 512, seed=7)
    conf = tm.MnistRandomFFTConfig(num_ffts=2, block_size=512, lam=10.0)
    scores, errs = {}, {}
    for where in (cuda, torch.device("cpu")):
        scorer, tr, te, _ = tm.run(train, test, conf, where)
        X = test.data.to_array().to(where)
        scores[where.type] = scorer.fit().apply(X).to_array().cpu()
        errs[where.type] = (tr, te)
    assert (scores["cuda"] - scores["cpu"]).abs().max().item() <= 1e-3
    assert errs["cuda"][1] < 0.35
