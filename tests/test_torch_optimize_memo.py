"""The port's optimize memo (``keystone_tpu_torch/workflow/optimizers.py``):
the cases of the JAX package's ``tests/workflow/test_optimize_memo.py`` on
the port, and the memo's hits, misses and bypasses equal to the JAX
package's for the same call sequences, a graph whose data leaves hold more
than 64 MiB (bypassed) and a learning fit (bypassed) among them.
"""

import numpy as np
import pytest
import torch

import keystone_tpu_torch.cost as cost
from keystone_tpu.workflow import optimizers as jopt
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.transformer import Estimator as JEstimator
from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.workflow import optimizers as opt_mod
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.rules import RuleExecutor
from keystone_tpu_torch.workflow.transformer import Estimator, FunctionNode


@pytest.fixture(autouse=True)
def clean():
    for reset in (opt_mod.clear_memo, cost.reset, PipelineEnv.get_or_create().reset,
                  jopt.clear_memo):
        reset()
    yield
    for reset in (opt_mod.clear_memo, cost.reset, PipelineEnv.get_or_create().reset,
                  jopt.clear_memo):
        reset()


class _CenterEstimator(Estimator):
    def fit(self, data):
        m = float(Dataset.of(data).to_array().mean())
        return FunctionNode(batch_fn=lambda X, m=m: X - m, label="center")


class _JCenterEstimator(JEstimator):
    def fit(self, data):
        m = np.mean(np.asarray(data.to_array()))
        return JFunctionNode(batch_fn=lambda X, m=m: X - m, label="center")


@pytest.fixture
def rule_stack_runs(monkeypatch):
    """Real rule-stack runs (a memo hit does not reach this)."""
    calls = []
    orig = RuleExecutor.execute

    def spy(self, graph, annotations=None):
        calls.append(len(graph.nodes))
        return orig(self, graph, annotations)

    monkeypatch.setattr(RuleExecutor, "execute", spy)
    return calls


def _chain(X, stages=4):
    p = FunctionNode(batch_fn=lambda X: X * 2.0, label="f0").to_pipeline()
    for _ in range(stages):
        p = p.and_then(_CenterEstimator(), X)
    return p


def test_composition_runs_zero_rule_stacks(rule_stack_runs):
    X = torch.from_numpy(np.random.RandomState(0).randn(16, 3).astype(np.float32))
    _chain(X, stages=4)
    assert rule_stack_runs == []


def test_fit_optimizes_once_and_matches_eager_semantics(rule_stack_runs):
    X = torch.from_numpy(np.random.RandomState(1).randn(16, 3).astype(np.float32))
    fitted = _chain(X, stages=3).fit()
    assert len(rule_stack_runs) == 1
    out = fitted.apply(X).payload
    expect = X * 2.0
    for _ in range(3):
        expect = expect - expect.mean()
    torch.testing.assert_close(out, expect, rtol=1e-5, atol=1e-5)


def test_repeated_optimize_of_same_graph_hits_memo(rule_stack_runs):
    X = torch.from_numpy(np.random.RandomState(2).randn(8, 3).astype(np.float32))
    p = (FunctionNode(batch_fn=lambda X: X + 1.0, label="g0").to_pipeline()
         .and_then(FunctionNode(batch_fn=lambda X: X * 3.0, label="g1")))
    a = p.apply(X).get().payload
    runs_after_first = len(rule_stack_runs)
    assert runs_after_first >= 1
    b = p.apply(X).get().payload
    assert len(rule_stack_runs) == runs_after_first
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert opt_mod.memo_stats["hits"] >= 1


def test_state_mutation_invalidates_memo(rule_stack_runs):
    X = torch.from_numpy(np.random.RandomState(3).randn(8, 3).astype(np.float32))
    p = (FunctionNode(batch_fn=lambda X: X - 1.0, label="h0").to_pipeline()
         .and_then(FunctionNode(batch_fn=lambda X: X * 0.5, label="h1")))
    p.apply(X).get()
    runs = len(rule_stack_runs)
    PipelineEnv.get_or_create().state.clear()
    p.apply(X).get()
    assert len(rule_stack_runs) == runs + 1


def test_distinct_estimator_instances_do_not_share_plans(rule_stack_runs):
    X = torch.from_numpy(np.random.RandomState(4).randn(8, 3).astype(np.float32))
    head = FunctionNode(batch_fn=lambda X: X * 2.0, label="k0").to_pipeline()
    fa = head.and_then(_CenterEstimator(), X).fit()
    fb = head.and_then(_CenterEstimator(), X).fit()
    torch.testing.assert_close(fa.apply(X).payload, fb.apply(X).payload, rtol=1e-6, atol=1e-6)


def test_memo_kill_switch(rule_stack_runs, monkeypatch):
    monkeypatch.setenv("KEYSTONE_OPT_MEMO", "0")
    X = torch.from_numpy(np.random.RandomState(5).randn(8, 3).astype(np.float32))
    p = (FunctionNode(batch_fn=lambda X: X + 2.0, label="m0").to_pipeline()
         .and_then(FunctionNode(batch_fn=lambda X: X * 2.0, label="m1")))
    p.apply(X).get()
    runs = len(rule_stack_runs)
    p.apply(X).get()
    assert len(rule_stack_runs) == runs + 1


def _sequence(pkg, X_small, X_big, store_dir):
    """One call sequence: two applies of one pipeline (miss, hit); a state
    mutation (miss); a fit; a pipeline over more than 64 MiB of data
    (bypassed); a fit with a profile store (learning: bypassed); the
    statistics after each step."""
    if pkg == "torch":
        FN, Est, env, stats, costm = (FunctionNode, _CenterEstimator,
                                      PipelineEnv.get_or_create(), opt_mod.memo_stats, cost)
        Xs, Xb = torch.from_numpy(X_small), torch.from_numpy(X_big)
    else:
        import keystone_tpu.cost as jcost

        FN, Est, env, stats, costm = (JFunctionNode, _JCenterEstimator,
                                      JPipelineEnv.get_or_create(), jopt.memo_stats, jcost)
        Xs, Xb = X_small, X_big
    seen = []
    p = FN(batch_fn=lambda X: X + 1.0, label="a").to_pipeline().and_then(
        FN(batch_fn=lambda X: X * 3.0, label="b"))
    p.apply(Xs).get()
    seen.append(dict(stats))
    p.apply(Xs).get()
    seen.append(dict(stats))
    env.state.clear()
    p.apply(Xs).get()
    seen.append(dict(stats))
    FN(batch_fn=lambda X: X * 2.0, label="c").to_pipeline().and_then(Est(), Xs).fit()
    seen.append(dict(stats))
    big = FN(batch_fn=lambda X: X * 2.0, label="d").to_pipeline()
    big.apply(Xb).get()
    big.apply(Xb).get()
    seen.append(dict(stats))
    if pkg == "torch":
        costm.configure(store_dir, device="cpu")
    else:
        costm.configure(store_dir)
    FN(batch_fn=lambda X: X * 2.0, label="e").to_pipeline().and_then(Est(), Xs).fit()
    seen.append(dict(stats))
    costm.reset()
    return seen


def test_memo_counts_equal_jax(tmp_path):
    rng = np.random.default_rng(11)
    X_small = rng.normal(size=(8, 3)).astype(np.float32)
    X_big = np.ones((5200, 4096), np.float32)  # 85 MB > 64 MiB
    got = _sequence("torch", X_small, X_big, str(tmp_path / "port"))
    want = _sequence("jax", X_small, X_big, str(tmp_path / "jax"))
    assert got == want
    assert got[-1]["bypasses"] >= 3 and got[-1]["hits"] >= 1
