"""The sparse rows and the text solvers on a CUDA card against the same
code on the CPU: ``SparseRows`` gathers, scatter-adds and ``to_dense``
(empty rows and all-padding rows included), naive Bayes, logistic
regression and both strategies of ``SparseLBFGSwithL2``, and the two text
applications at a small size.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_text.py

Tolerances: the scatter-adds are atomic on the card, so float sums differ
from the CPU's by rounding (rtol 1e-5 / atol 1e-6); integer-valued sums
(naive Bayes on term counts) are equal; the L-BFGS fits within rtol 1e-3
/ atol 1e-4, the two strategies on the card at the JAX suite's agreement
tolerance (rtol 2e-2 / atol 2e-3); predictions equal.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.data.sparse import SparseRows
from keystone_tpu_torch.nodes.learning.classifiers import (
    LogisticRegressionEstimator,
    NaiveBayesEstimator,
)
from keystone_tpu_torch.nodes.learning.lbfgs import SparseLBFGSwithL2
from keystone_tpu_torch.pipelines import amazon_reviews as am
from keystone_tpu_torch.pipelines import newsgroups as ng
from keystone_tpu_torch.workflow.env import PipelineEnv

CPU = torch.device("cpu")
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = dict(rtol=1e-3, atol=1e-4)


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


def _rows(n=300, d=500, seed=0, empty_every=7):
    """Pairs with every ``empty_every``-th row empty and a few repeated
    indices in a row (summed, as the reference sums them)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        if i % empty_every == 0:
            rows.append([])
            continue
        nnz = int(rng.integers(1, 30))
        idx = rng.integers(0, d, nnz)
        rows.append(list(zip(idx.tolist(), rng.standard_normal(nnz).astype(np.float32).tolist())))
    return SparseRows.from_pairs(rows, d)


@pytest.mark.cuda
def test_sparse_rows_on_the_card_match_the_cpu(cuda):
    X = _rows()
    Xc = X.to(cuda)
    assert Xc.device.type == "cuda" and Xc.indices.dtype == torch.int64
    rng = np.random.default_rng(1)
    W = torch.from_numpy(rng.standard_normal((500, 6)).astype(np.float32))
    R = torch.from_numpy(rng.standard_normal((300, 6)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, 300))
    onehot = torch.nn.functional.one_hot(y, 5).float()
    assert torch.equal(Xc.to_dense().cpu(), X.to_dense())
    for got, want in ((Xc.matmul(W.to(cuda)), X.matmul(W)),
                      (Xc.rmatmul(R.to(cuda)), X.rmatmul(R)),
                      (Xc.class_sums(onehot.to(cuda)), X.class_sums(onehot)),
                      (Xc.label_sums(y.to(cuda), 5), X.label_sums(y, 5))):
        torch.testing.assert_close(got.cpu(), want, **SUM_TOL)
    assert Xc.nnz == X.nnz and Xc.density() == X.density()
    sl = Xc.row_slice(7, 50)
    assert torch.equal(sl.to_dense().cpu(), X.row_slice(7, 50).to_dense())


@pytest.mark.cuda
def test_all_padding_rows_on_the_card_are_inert(cuda):
    X = SparseRows(torch.zeros((64, 16), dtype=torch.int64, device=cuda),
                   torch.zeros((64, 16), device=cuda), 40)
    assert X.nnz == 0
    assert torch.count_nonzero(X.to_dense()) == 0
    assert torch.count_nonzero(X.matmul(torch.ones(40, 3, device=cuda))) == 0
    assert torch.count_nonzero(X.rmatmul(torch.ones(64, 3, device=cuda))) == 0
    assert torch.count_nonzero(X.label_sums(torch.zeros(64, dtype=torch.long, device=cuda),
                                            2)) == 0


def _counts(n=400, d=300, k=4, seed=2):
    """Term-count rows (integer values) and labels."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    rows = []
    for i in range(n):
        idx = np.unique(np.concatenate([rng.integers(0, d, 12), [y[i] * 5]]))
        rows.append([(int(j), float(rng.integers(1, 4))) for j in idx])
    return SparseRows.from_pairs(rows, d), y


@pytest.mark.cuda
def test_naive_bayes_on_the_card_matches_the_cpu(cuda):
    X, y = _counts()
    got = NaiveBayesEstimator(4).fit(Dataset(X.to(cuda)), Dataset.of(y))
    want = NaiveBayesEstimator(4).fit(Dataset(X), Dataset.of(y))
    torch.testing.assert_close(got.pi.cpu(), want.pi, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.theta.cpu(), want.theta, rtol=1e-6, atol=1e-6)
    assert torch.equal(got.apply_batch(Dataset(X.to(cuda))).to_array().argmax(1).cpu(),
                       want.apply_batch(Dataset(X)).to_array().argmax(1))


@pytest.mark.cuda
def test_logistic_regression_on_the_card_matches_the_cpu(cuda):
    X, y = _counts(k=2, seed=3)
    got = LogisticRegressionEstimator(2, num_iters=20).fit(Dataset(X.to(cuda)), Dataset.of(y))
    want = LogisticRegressionEstimator(2, num_iters=20).fit(Dataset(X), Dataset.of(y))
    torch.testing.assert_close(got.W.cpu(), want.W, **FIT_TOL)
    assert torch.equal(got.apply_batch(Dataset(X.to(cuda))).to_array().cpu(),
                       want.apply_batch(Dataset(X)).to_array())


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [2e9, 0], ids=["gram", "gather_scatter"])
def test_sparse_lbfgs_on_the_card_matches_the_cpu(cuda, budget):
    X = _rows(n=1024, d=256, seed=4)
    B = torch.from_numpy(np.sign(np.random.default_rng(5).standard_normal((1024, 1)))
                         .astype(np.float32))
    kw = dict(reg_param=1e-2, num_iterations=30, gram_budget_bytes=budget)
    got = SparseLBFGSwithL2(**kw).fit(Dataset(X.to(cuda)), Dataset.of(B))
    want = SparseLBFGSwithL2(**kw).fit(Dataset(X), Dataset.of(B))
    assert got.W.shape == (256, 1) and got.W.is_cuda
    torch.testing.assert_close(got.W.cpu(), want.W, **FIT_TOL)


@pytest.mark.cuda
def test_sparse_lbfgs_strategies_agree_on_the_card(cuda):
    X = _rows(n=1024, d=256, seed=6).to(cuda)
    B = torch.from_numpy(np.sign(np.random.default_rng(7).standard_normal((1024, 2)))
                         .astype(np.float32))

    def fit(budget):
        return SparseLBFGSwithL2(reg_param=1e-3, num_iterations=200, convergence_tol=1e-9,
                                 gram_budget_bytes=budget).fit(Dataset(X), Dataset.of(B)).W
    torch.testing.assert_close(fit(0).cpu(), fit(2e9).cpu(), rtol=2e-2, atol=2e-3)


@pytest.mark.cuda
def test_the_text_applications_on_the_card_match_the_cpu(cuda):
    train = ng.synthetic_newsgroups(256, num_classes=6, seed=1)
    test = ng.synthetic_newsgroups(96, num_classes=6, seed=2)
    conf = ng.NewsgroupsConfig(common_features=2000, num_classes=6)
    preds = {}
    for dev in (cuda, CPU):
        PipelineEnv.get_or_create().reset()
        predictor, evaluation, _ = ng.run(train, test, conf, dev)
        preds[dev.type] = predictor(test.data).get().to_array().cpu()
        assert evaluation.total_error < 0.15
    assert torch.equal(preds["cuda"], preds["cpu"])
    train, test = am.synthetic_reviews(256, seed=1), am.synthetic_reviews(96, seed=2)
    conf = am.AmazonReviewsConfig(common_features=2000, num_iters=30)
    for dev in (cuda, CPU):
        PipelineEnv.get_or_create().reset()
        predictor, evaluation, _ = am.run(train, test, conf, dev)
        preds[dev.type] = predictor(test.data).get().to_array().cpu()
        assert evaluation.accuracy > 0.9
    assert torch.equal(preds["cuda"], preds["cpu"])
