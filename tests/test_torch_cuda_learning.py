"""The learning nodes of slice 5 on a CUDA card against the same fits on
the CPU: L-BFGS (cuBLAS GEMMs, host-driven loop), the augmented TSQR
(cuSOLVER QR), logistic regression, naive Bayes, the TIMIT pipeline at a
small width, and the plan ``LeastSquaresEstimator`` makes in a graph.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_learning.py

Tolerances: weights rtol 1e-3 / atol 1e-4 (float32 GEMMs and
factorizations of two libraries, carried through up to 20 L-BFGS steps);
TSQR against the exact solve 1e-4 relative; TIMIT scores 1e-3.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.classifiers import (
    LeastSquaresEstimator,
    LogisticRegressionEstimator,
    NaiveBayesEstimator,
)
from keystone_tpu_torch.nodes.learning.lbfgs import DenseLBFGSwithL2
from keystone_tpu_torch.nodes.learning.linear import (
    BlockLeastSquaresEstimator,
    LinearMapEstimator,
    TSQRLeastSquaresEstimator,
)
from keystone_tpu_torch.nodes.stats import CosineRandomFeatures
from keystone_tpu_torch.pipelines import timit as tt
from keystone_tpu_torch.workflow.env import PipelineEnv

CPU = torch.device("cpu")


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


def _problem(n=2000, d=40, k=5, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) + 0.5).astype(np.float32)
    Y = (X @ rng.standard_normal((d, k)) + 0.1 * rng.standard_normal((n, k))).astype(np.float32)
    return X, Y


def _both(fit, *arrays, device):
    """``fit`` of the same arrays on the card and on the CPU."""
    return (fit(*[torch.from_numpy(a).to(device) for a in arrays]),
            fit(*[torch.from_numpy(a) for a in arrays]))


@pytest.mark.cuda
def test_lbfgs_on_the_card_matches_the_cpu(cuda):
    X, Y = _problem()
    card, host = _both(lambda A, B: DenseLBFGSwithL2(reg_param=0.1, num_iterations=20)
                       .fit(Dataset.of(A), Dataset.of(B)), X, Y, device=cuda)
    assert card.W.device.type == "cuda"
    np.testing.assert_allclose(card.W.cpu().numpy(), host.W.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("lam", [0.0, 3.0])
def test_tsqr_on_the_card_matches_the_exact_solve(cuda, lam):
    X, Y = _problem(seed=1)
    card, host = _both(lambda A, B: TSQRLeastSquaresEstimator(lam).fit(Dataset.of(A),
                                                                      Dataset.of(B)),
                       X, Y, device=cuda)
    exact = LinearMapEstimator(lam).fit(Dataset.of(torch.from_numpy(X).to(cuda)),
                                        Dataset.of(torch.from_numpy(Y).to(cuda)))
    W = card.W.cpu()
    assert (torch.linalg.norm(W - exact.W.cpu()) / torch.linalg.norm(exact.W.cpu())) < 1e-4
    np.testing.assert_allclose(W.numpy(), host.W.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_logistic_regression_and_naive_bayes_on_the_card_match_the_cpu(cuda):
    rng = np.random.default_rng(3)
    y = rng.integers(0, 4, size=600).astype(np.int32)
    X = (3.0 * rng.standard_normal((4, 6))[y] + rng.standard_normal((600, 6))).astype(np.float32)
    card, host = _both(lambda A, b: LogisticRegressionEstimator(4, 0.01, num_iters=30)
                       .fit(Dataset.of(A), Dataset.of(b)), X, y, device=cuda)
    np.testing.assert_allclose(card.W.cpu().numpy(), host.W.numpy(), rtol=1e-3, atol=1e-4)
    counts = rng.poisson(np.abs(X[:, :4]) + 0.5).astype(np.float32)
    card, host = _both(lambda A, b: NaiveBayesEstimator(4).fit(Dataset.of(A), Dataset.of(b)),
                       counts, y, device=cuda)
    np.testing.assert_allclose(card.theta.cpu().numpy(), host.theta.numpy(), rtol=1e-5)
    np.testing.assert_allclose(card.pi.cpu().numpy(), host.pi.numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("featurized", [False, True])
def test_least_squares_plan_on_the_card(cuda, featurized):
    """The raw frames take the exact solve and one 4096-wide cosine branch
    the block solver (1000, 3): the plan is made from sampled items on the
    card, as on the CPU."""
    X = torch.zeros((50000, 440), device=cuda)
    Y = torch.zeros((50000, 147), device=cuda)
    est = LeastSquaresEstimator(num_machines=1)
    if featurized:
        pipe = CosineRandomFeatures.create(440, 4096, 0.05555, device=cuda).and_then(est, X, Y)
    else:
        pipe = est.with_data(X, Y)
    graph, _ = PipelineEnv.get_or_create().optimizer.execute(pipe.graph)
    chosen = [op for op in graph.operators.values()
              if isinstance(op, (LinearMapEstimator, BlockLeastSquaresEstimator))]
    assert [type(op) for op in chosen] == [BlockLeastSquaresEstimator if featurized
                                           else LinearMapEstimator]


@pytest.mark.cuda
def test_small_timit_on_the_card_matches_the_cpu(cuda):
    conf = tt.TimitConfig(num_cosines=3, num_epochs=2, lam=10.0, num_classes=12,
                          cosine_features=256, gamma=0.02)
    train = tt.synthetic_timit(768, 12, seed=1)
    test = tt.synthetic_timit(256, 12, seed=2)
    params = [(b.W.numpy(), b.b.numpy()) for b in
              (tt._cosine_branch(conf, i, CPU) for i in range(conf.num_cosines))]
    scores, errs = {}, {}
    for where in (cuda, CPU):
        scorer, tr, te, _ = tt.run(train, test, conf, where, params=params)
        scores[where.type] = scorer.fit().apply(test.data.to_array().to(where)).to_array().cpu()
        errs[where.type] = te
    assert (scores["cuda"] - scores["cpu"]).abs().max().item() <= 1e-3
    assert torch.equal(scores["cuda"].argmax(1), scores["cpu"].argmax(1))
    assert errs["cuda"] < 0.2
