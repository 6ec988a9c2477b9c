"""The closed loop in the port (``keystone_tpu_torch/cost/replan.py``, the
store path of ``workflow/node_optimization.py`` and ``autocache.py``): the
cases of the JAX package's ``tests/cost/test_replan_loop.py`` on the port.
A traced fit writes evidence; the second fit of the same pipeline, in the
same process and in a fresh one, plans from it with zero sampling
executions and predicts within the JAX test's atol 1e-6 of the first; the
solver chosen equals the JAX package's on the same shapes; per-node
calibration ratios correct the sampled extrapolation.
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import keystone_tpu_torch.cost as cost
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.classifiers import LeastSquaresEstimator
from keystone_tpu_torch.obs import tracer as tracer_mod
from keystone_tpu_torch.workflow.autocache import profile_nodes
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.graph import Graph
from keystone_tpu_torch.workflow.operators import DatasetOperator
from keystone_tpu_torch.workflow.optimizers import AutoCachingOptimizer, clear_memo
from keystone_tpu_torch.workflow.transformer import FunctionNode, Transformer

ROOT = Path(__file__).resolve().parent.parent

rng = np.random.default_rng(7)
X = rng.standard_normal((384, 12)).astype(np.float32)
Y = rng.standard_normal((384, 3)).astype(np.float32)
R = rng.standard_normal((12, 12)).astype(np.float32)
RT = torch.from_numpy(R)


@pytest.fixture(autouse=True)
def clean():
    for reset in (cost.reset, clear_memo, tracer_mod.reset, PipelineEnv.get_or_create().reset):
        reset()
    yield
    for reset in (cost.reset, clear_memo, tracer_mod.reset, PipelineEnv.get_or_create().reset):
        reset()


def _build_pipeline():
    # fresh instances each run: the fit-once state must not short-circuit
    # the second fit
    feat = FunctionNode(batch_fn=lambda A: torch.tanh(A @ RT), label="feat")
    auto = LeastSquaresEstimator(lam=1e-2)
    return feat.and_then(auto, Dataset.of(X), Dataset.of(Y))


def _fit_and_apply():
    cost.reset_sampling()
    fitted = _build_pipeline().fit()
    out = fitted.apply(Dataset.of(X[:16])).payload.numpy()
    return out, cost.sampling_executions()["total"]


def test_second_fit_plans_from_evidence_with_zero_sampling(tmp_path):
    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    cost.configure(str(tmp_path), device="cpu")
    out1, sampled1 = _fit_and_apply()
    assert sampled1 > 0
    out2, sampled2 = _fit_and_apply()
    assert sampled2 == 0
    np.testing.assert_allclose(out1, out2, atol=1e-6)
    keys = cost.get_store().keys()
    assert any(k.startswith("op/") for k in keys)
    assert any(k.startswith("solver/") for k in keys)
    assert any(k.startswith("plan/") for k in keys)


_FRESH = """
import sys, numpy as np, torch
sys.path.insert(0, sys.argv[3])
import keystone_tpu_torch.cost as cost
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.classifiers import LeastSquaresEstimator
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.optimizers import AutoCachingOptimizer
from keystone_tpu_torch.workflow.transformer import FunctionNode

rng = np.random.default_rng(7)
X = rng.standard_normal((384, 12)).astype(np.float32)
Y = rng.standard_normal((384, 3)).astype(np.float32)
R = torch.from_numpy(rng.standard_normal((12, 12)).astype(np.float32))
PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
cost.configure(sys.argv[1], device="cpu")
feat = FunctionNode(batch_fn=lambda A: torch.tanh(A @ R), label="feat")
fitted = feat.and_then(LeastSquaresEstimator(lam=1e-2), Dataset.of(X), Dataset.of(Y)).fit()
np.save(sys.argv[2], fitted.apply(Dataset.of(X[:16])).payload.numpy())
print("SAMPLED", cost.sampling_executions()["total"])
"""


def test_second_fit_in_a_fresh_process_samples_nothing(tmp_path):
    """Two processes over one store: the second plans with no sampling and
    predicts within 1e-6 of the first."""
    outs = []
    for i in range(2):
        path = tmp_path / f"out{i}.npy"
        proc = subprocess.run([sys.executable, "-c", _FRESH, str(tmp_path / "store"),
                               str(path), str(ROOT)],
                              cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        sampled = int(proc.stdout.split("SAMPLED")[1])
        assert (sampled > 0) if i == 0 else (sampled == 0)
        outs.append(np.load(path))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)


def test_plan_record_carries_observed_costs_and_ratios(tmp_path):
    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    cost.configure(str(tmp_path), device="cpu")
    _fit_and_apply()
    store = cost.get_store()
    # plan/segment/ records hold segment dispatch's evidence, another shape
    # (as tests/cost/test_replan_loop.py filters them)
    plan_keys = [k for k in store.keys()
                 if k.startswith("plan/") and not k.startswith("plan/segment/")]
    assert plan_keys
    rows = [r for k in plan_keys for r in store.load(k)["nodes"].values()]
    assert rows and all("label" in r and "seconds" in r for r in rows)
    observed = [r for r in rows if r["observed"]]
    assert observed
    assert any(isinstance(r.get("ratio"), float) and r["ratio"] > 0 for r in observed)
    rec = store.load([k for k in store.keys() if k.startswith("solver/")][0])
    assert rec["chosen"] in ("LinearMapEstimator", "TSQRLeastSquaresEstimator",
                             "BlockLeastSquaresEstimator", "DenseLBFGSwithL2")
    assert rec["shape"]["d"] == 12 and rec["shape"]["k"] == 3


def test_the_chosen_solver_and_shape_equal_jax(tmp_path):
    """The JAX package's loop on the same data, one machine in both: the
    stored shape and the chosen solver are equal."""
    import jax.numpy as jnp

    import keystone_tpu.cost as jcost
    from keystone_tpu.data.dataset import Dataset as JDataset
    from keystone_tpu.nodes.learning import LeastSquaresEstimator as JLeastSquares
    from keystone_tpu.workflow.env import PipelineEnv as JEnv
    from keystone_tpu.workflow.optimizers import AutoCachingOptimizer as JAutoCaching
    from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode

    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    cost.configure(str(tmp_path / "port"), device="cpu")
    feat = FunctionNode(batch_fn=lambda A: torch.tanh(A @ RT), label="feat")
    feat.and_then(LeastSquaresEstimator(lam=1e-2, num_machines=1), Dataset.of(X),
                  Dataset.of(Y)).fit()
    JEnv.get_or_create().set_optimizer(JAutoCaching())
    jcost.configure(str(tmp_path / "jax"))
    jfeat = JFunctionNode(batch_fn=lambda A: jnp.tanh(jnp.asarray(A) @ R), label="feat")
    jfeat.and_then(JLeastSquares(lam=1e-2, num_machines=1), JDataset.of(X),
                   JDataset.of(Y)).fit()

    def solver_rec(store):
        return store.load([k for k in store.keys() if k.startswith("solver/")][0])

    rec, jrec = solver_rec(cost.get_store()), solver_rec(jcost.get_store())
    assert rec["chosen"] == jrec["chosen"]
    assert rec["shape"] == jrec["shape"]
    assert rec["node_idx"] == jrec["node_idx"]


def test_traced_fit_emits_cost_spans_and_solver_audit(tmp_path):
    from keystone_tpu_torch.obs.audit import cache_audit

    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    cost.configure(str(tmp_path), device="cpu")
    tracer = tracer_mod.install(tracer_mod.Tracer())
    _fit_and_apply()
    names = [sp.name for sp in tracer.spans()]
    assert "cost.estimate" in names and "cost.replan" in names
    (row,) = [r for r in cache_audit(tracer) if r["kind"] == "solver"]
    assert row["solver"] == row["label"]
    assert row["observed"] and row["obs_seconds"] > 0
    assert row["alternatives"] and len(row["alternatives"]) == 5


def test_second_traced_fit_predicts_solver_seconds(tmp_path):
    from keystone_tpu_torch.obs.audit import cache_audit

    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    cost.configure(str(tmp_path), device="cpu")
    _fit_and_apply()
    tracer = tracer_mod.install(tracer_mod.Tracer())
    _fit_and_apply()
    (row,) = [r for r in cache_audit(tracer) if r["kind"] == "solver"]
    assert row["source"] == "learned"
    assert row["solver_est_seconds"] is not None
    assert row["solver_seconds_ratio"] is not None


def test_changed_pipeline_falls_back_to_sampling(tmp_path):
    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    cost.configure(str(tmp_path), device="cpu")
    _fit_and_apply()
    cost.reset_sampling()
    extra = FunctionNode(batch_fn=lambda A: A * 2.0, label="x2")
    feat = FunctionNode(batch_fn=lambda A: torch.tanh(A @ RT), label="feat")
    extra.and_then(feat).and_then(LeastSquaresEstimator(lam=1e-2), Dataset.of(X),
                                  Dataset.of(Y)).fit()
    assert cost.sampling_executions()["total"] > 0


def test_changed_parameters_fall_back_to_sampling(tmp_path):
    """The fingerprint holds the content digest of canonical parameters:
    the same pipeline with another λ is another record."""
    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    cost.configure(str(tmp_path), device="cpu")
    _fit_and_apply()
    cost.reset_sampling()
    feat = FunctionNode(batch_fn=lambda A: torch.tanh(A @ RT), label="feat")
    feat.and_then(LeastSquaresEstimator(lam=1.0), Dataset.of(X), Dataset.of(Y)).fit()
    assert cost.sampling_executions()["total"] > 0


def test_default_optimizer_solver_record_skips_sampling(tmp_path):
    cost.configure(str(tmp_path), device="cpu")
    _, sampled1 = _fit_and_apply()
    assert sampled1 > 0
    _, sampled2 = _fit_and_apply()
    assert sampled2 == 0


def test_no_store_means_no_files_and_unchanged_behavior(tmp_path, monkeypatch):
    monkeypatch.delenv("KEYSTONE_PROFILE_DIR", raising=False)
    assert cost.get_store() is None
    out1, sampled1 = _fit_and_apply()
    assert sampled1 > 0
    out2, sampled2 = _fit_and_apply()
    assert sampled2 > 0
    np.testing.assert_allclose(out1, out2, atol=1e-6)


class _Sleepy(Transformer):
    def apply_batch(self, data):
        time.sleep(0.01)
        return Dataset.of(data)

    def apply(self, x):
        return x


def _sleepy_graph():
    g = Graph()
    g, leaf = g.add_node(DatasetOperator(torch.ones((32, 4))), [])
    g, t = g.add_node(_Sleepy(), [leaf])
    g, _ = g.add_sink(t)
    return g, t


def test_calibration_scales_one_nodes_estimate():
    g, t = _sleepy_graph()
    base = profile_nodes(g, full_size=32)
    scaled = profile_nodes(g, full_size=32, calibration={t: 8.0})
    assert scaled[t].ns > 3.0 * base[t].ns


def test_calibration_ratio_is_clamped():
    g, t = _sleepy_graph()
    lo = profile_nodes(g, full_size=32, calibration={t: 1e-12})
    base = profile_nodes(g, full_size=32)
    assert lo[t].ns > base[t].ns / 200.0


def test_observed_by_node_windows_out_prior_fits():
    from keystone_tpu_torch.obs.audit import observed_by_node

    tracer = tracer_mod.Tracer()
    with tracer.span("node", node_id="3", op_type="Op"):
        time.sleep(0.01)
    watermark = len(tracer.spans())
    with tracer.span("node", node_id="3", op_type="Op"):
        time.sleep(0.01)
    merged = observed_by_node(tracer)
    windowed = observed_by_node(tracer, start=watermark)
    assert merged["3"]["computes"] == 2
    assert windowed["3"]["computes"] == 1
    assert windowed["3"]["seconds"] < merged["3"]["seconds"]


def test_repeat_traced_fits_do_not_accumulate_observed_seconds(tmp_path):
    """Two fits under one global tracer: the plan record after fit 2 holds
    fit 2's window, not the sum of both (its seconds are the finalize
    join's own, so the check is exact: every observed row of fit 2 equals
    the window's observation)."""
    from keystone_tpu_torch.obs.audit import observed_by_node

    cost.configure(str(tmp_path), device="cpu")
    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    tracer = tracer_mod.install(tracer_mod.Tracer())
    _fit_and_apply()
    PipelineEnv.get_or_create().reset()
    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    start = len(tracer.spans())
    _fit_and_apply()
    fp = [k for k in cost.get_store().keys()
          if k.startswith("plan/") and not k.startswith("plan/segment/")][0]
    rec = cost.get_store().load(fp)
    window = observed_by_node(tracer, start=start)
    merged = observed_by_node(tracer)
    observed = [r for r in rec["nodes"].values() if r["observed"]]
    assert observed
    for row in observed:
        node = next(k for k, v in window.items() if round(v["seconds"], 6) == row["seconds"])
        assert merged[node]["computes"] > window[node]["computes"]


def test_estimate_rows_do_not_inherit_stale_extras_across_passes():
    tracer = tracer_mod.Tracer()
    tracer.begin_plan_epoch()
    tracer.record_node_estimate("3", "auto-solver", kind="solver", solver="TSQRLeastSquares")
    tracer.record_node_estimate("3", "auto-solver", est_seconds=0.5)
    row = tracer.estimates["3"]
    assert row["kind"] == "solver" and row["est_seconds"] == 0.5
    tracer.begin_plan_epoch()
    tracer.record_node_estimate("3", "plain-feat", est_seconds=0.1)
    row = tracer.estimates["3"]
    assert row["label"] == "plain-feat"
    assert "kind" not in row and "solver" not in row
    assert "_epoch" not in row


def test_learned_pricing_equals_jax(tmp_path):
    """The learned half of the cost model on the same observations in both
    packages' stores: the spu and per-item EWMAs, the geometric-mean
    fallback for options without evidence, the predicted seconds and the
    node pricing are equal (to float64 rounding)."""
    from keystone_tpu.cost.model import CostEstimator as JEstimator
    from keystone_tpu.cost.model import ShapeSignature as JShape
    from keystone_tpu.cost.store import ProfileStore as JStore
    from keystone_tpu.nodes.learning import LeastSquaresEstimator as JLeastSquares
    from keystone_tpu_torch.cost.model import CostEstimator, ShapeSignature
    from keystone_tpu_torch.cost.store import ProfileStore

    est = CostEstimator(ProfileStore(str(tmp_path / "port"), device="cpu"))
    jest = JEstimator(JStore(str(tmp_path / "jax")))
    for e in (est, jest):
        e.observe_solver("LinearMapEstimator", 1e6, 0.25)
        e.observe_solver("LinearMapEstimator", 2e6, 0.3)
        e.observe_solver("TSQRLeastSquaresEstimator", 4e6, 0.5)
        e.observe_node("FunctionNode", 384, 0.01, 18432)
        e.observe_nodes("FunctionNode", [(384, 0.02, 18432), (768, 0.03, None)])
    weights = (3.8e-4, 2.9e-1, 1.32)
    got = est.solver_costs(LeastSquaresEstimator(lam=0.1).options,
                           ShapeSignature(5000, 64, 3), *weights)
    want = jest.solver_costs(JLeastSquares(lam=0.1).options, JShape(5000, 64, 3), *weights)
    assert got.keys() == want.keys()
    for label in got:
        assert got[label]["learned"] == want[label]["learned"]
        for k in ("units", "spu", "seconds"):
            assert got[label][k] == pytest.approx(want[label][k], rel=1e-12), (label, k)
    assert est.node_profile_ns("FunctionNode", 1000) == pytest.approx(
        jest.node_profile_ns("FunctionNode", 1000), rel=1e-12)
