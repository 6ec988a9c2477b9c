"""TimitPipeline, the port's fifth slice, against the JAX package on the CPU:
the TIMIT loader, the Gaussian and Cauchy featurizers, the multi-epoch
block solve, the whole pipeline at the JAX test's configuration
(``tests/pipelines/test_timit_cifar_extras.py``) with the JAX branches'
W and b copied, the optimizer's plan, and the JAX fit's parameters carried
into the port.

Tolerances: block-solve weights rtol 1e-4 / atol 1e-5 and pipeline scores
atol 1e-4, float32 GEMM sums and Cholesky solves of two bindings in another
order; the synthetic data and the loaded files are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.linalg import bcd as jbcd
from keystone_tpu.loaders.text import load_timit_features as j_load_timit
from keystone_tpu.nodes.learning.linear import BlockLinearMapper as JBlockMapper
from keystone_tpu.nodes.util import ClassLabelIndicators as JCLI
from keystone_tpu.nodes.util import MaxClassifier as JMax
from keystone_tpu.pipelines import timit as jt
from keystone_tpu.workflow import analysis as janalysis
from keystone_tpu.workflow import fusion as jfusion
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu_torch.linalg import bcd
from keystone_tpu_torch.loaders import text
from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.stats import CosineRandomFeatures
from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.pipelines import timit as tt
from keystone_tpu_torch.workflow import analysis as tanalysis
from keystone_tpu_torch.workflow import fusion as tfusion
from keystone_tpu_torch.workflow.env import PipelineEnv

CPU = torch.device("cpu")
# the configuration of the JAX package's test_timit_pipeline_synthetic
CONF = dict(num_cosines=3, num_epochs=2, lam=10.0, num_classes=12, cosine_features=256,
            gamma=0.02)
W_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _jax_params(conf):
    """(W, b) of each JAX branch, as numpy arrays."""
    return [(np.asarray(node.W), np.asarray(node.b))
            for node in (jt._cosine_branch(conf, i) for i in range(conf.num_cosines))]


# ---- data ------------------------------------------------------------------

def test_timit_constants_match_jax():
    assert (text.TIMIT_DIMENSION, text.TIMIT_NUM_CLASSES) == (440, 147)
    assert tt.NUM_COSINE_FEATURES == jt.NUM_COSINE_FEATURES == 4096
    assert tt.TimitConfig() == tt.TimitConfig(**vars(jt.TimitConfig()))


@pytest.mark.parametrize("with_test_labels", [True, False])
def test_timit_loader_matches_jax(tmp_path, with_test_labels):
    rng = np.random.default_rng(0)
    for split, n in (("train", 6), ("test", 4)):
        np.savetxt(tmp_path / f"{split}.csv", rng.standard_normal((n, 8)).astype(np.float32),
                   delimiter=",")
        with open(tmp_path / f"{split}.labels", "w") as f:
            for i in reversed(range(n)):  # "row label", 1-indexed, in any order
                f.write(f"{i + 1} {(i % 3) + 1}\n")
    args = [str(tmp_path / "train.csv"), str(tmp_path / "train.labels"),
            str(tmp_path / "train.csv" if not with_test_labels else tmp_path / "test.csv")]
    if with_test_labels:
        args.append(str(tmp_path / "test.labels"))
    got, want = text.load_timit_features(*args), j_load_timit(*args)
    assert got.train.labels.to_array().tolist() == [0, 1, 2, 0, 1, 2]
    for split in ("train", "test"):
        g, w = getattr(got, split), getattr(want, split)
        np.testing.assert_array_equal(g.labels.to_array().numpy(), np.asarray(w.labels.to_array()))
        np.testing.assert_array_equal(g.data.to_array().numpy(), np.asarray(w.data.to_array()))
    assert text._parse_sparse_labels(str(tmp_path / "train.labels")) == {
        i: (i % 3) + 1 for i in range(6)}


@pytest.mark.parametrize("n,classes,dim,seed", [(768, 12, 440, 1), (50, 147, 440, 2),
                                                (96, 4, 24, 0)])
def test_synthetic_timit_is_the_jax_data(n, classes, dim, seed):
    got = tt.synthetic_timit(n, classes, dim=dim, seed=seed)
    want = jt.synthetic_timit(n, classes, dim=dim, seed=seed)
    np.testing.assert_array_equal(got.data.to_array().numpy(), np.asarray(want.data.to_array()))
    np.testing.assert_array_equal(got.labels.to_array().numpy(),
                                  np.asarray(want.labels.to_array()))


# ---- featurizers -------------------------------------------------------------

def tt_to_jax(conf):
    return jt.TimitConfig(**vars(conf))


@pytest.mark.parametrize("rf_type", ["gaussian", "cauchy"])
def test_featurizer_shapes_and_draws(rf_type):
    """As the JAX package's cauchy shape test: 2 branches of 64 over 20
    inputs give (8, 128); the draws are numpy's, seeded per branch."""
    conf = tt.TimitConfig(num_cosines=2, rf_type=rf_type, cosine_features=64, input_dim=20)
    X = np.random.default_rng(0).standard_normal((8, 20)).astype(np.float32)
    out = tt.build_featurizer(conf, CPU)(torch.from_numpy(X)).get().to_array()
    assert out.shape == (8, 2 * 64) and out.dtype == torch.float32
    assert out.abs().max().item() <= 1.0
    want = np.asarray(jt.build_featurizer(tt_to_jax(conf))(X).get().to_array())
    assert want.shape == tuple(out.shape)
    a, b = tt._cosine_branch(conf, 0, CPU), tt._cosine_branch(conf, 1, CPU)
    again = tt._cosine_branch(conf, 0, CPU)
    assert torch.equal(a.W, again.W) and not torch.equal(a.W, b.W)
    assert 0.0 <= a.b.min().item() and a.b.max().item() < 2 * np.pi


@pytest.mark.parametrize("rf_type", ["gaussian", "cauchy"])
def test_featurizer_with_jax_parameters_matches_jax(rf_type):
    conf = tt.TimitConfig(num_cosines=3, rf_type=rf_type, cosine_features=32, input_dim=24,
                          gamma=0.1)
    X = (1.5 * np.random.default_rng(3).standard_normal((40, 24))).astype(np.float32)
    got = tt.build_featurizer(conf, CPU, _jax_params(tt_to_jax(conf)))(
        torch.from_numpy(X)).get().to_array().numpy()
    want = np.asarray(jt.build_featurizer(tt_to_jax(conf))(X).get().to_array())
    np.testing.assert_allclose(got, want, atol=1e-5)  # cos of one float32 GEMM


# ---- the multi-epoch block solve ---------------------------------------------

def _bcd_problem(n=300, d=48, k=4, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) + 0.3).astype(np.float32)
    Y = (X @ rng.standard_normal((d, k)) + 0.1 * rng.standard_normal((n, k))).astype(np.float32)
    return X, Y


@pytest.mark.parametrize("num_iter", [2, 5])
@pytest.mark.parametrize("centered", [False, True])
def test_block_solve_epochs_match_jax_scan(num_iter, centered):
    X, Y = _bcd_problem(seed=num_iter)
    means = X.mean(0) if centered else None
    got = bcd.solve_blockwise_l2_scan(torch.from_numpy(X), torch.from_numpy(Y), 0.5, 16,
                                      num_iter, means=None if means is None
                                      else torch.from_numpy(means))
    want = jbcd._bcd_scan(jnp.asarray(X), jnp.asarray(Y), jnp.float32(0.5),
                          None if means is None else jnp.asarray(means),
                          block_size=16, num_iter=num_iter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **W_TOL)


@pytest.mark.parametrize("num_iter", [2, 5])
def test_block_estimator_epochs_count_steps_and_match_jax(num_iter):
    """The estimator's sweeps: num_iter × blocks block steps, the weights
    of the JAX estimator's fit."""
    from keystone_tpu.nodes.learning.linear import BlockLeastSquaresEstimator as JBlockLS

    X, Y = _bcd_problem(n=256, d=64, seed=7)
    before = bcd._block_update_impl.steps
    got = BlockLeastSquaresEstimator(16, num_iter, 1.0).fit(torch.from_numpy(X),
                                                             torch.from_numpy(Y))
    assert bcd._block_update_impl.steps - before == 4 * num_iter
    want = JBlockLS(16, num_iter, 1.0).fit(JDataset.of(X), JDataset.of(Y))
    np.testing.assert_allclose(got._W.numpy(), np.asarray(want._W), **W_TOL)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), **W_TOL)


def test_more_epochs_lower_the_objective():
    X, Y = _bcd_problem(n=200, d=96, seed=2)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)

    def objective(W):
        return (torch.sum((Xt @ W - Yt) ** 2) + 0.1 * torch.sum(W * W)).item()

    values = [objective(bcd.solve_blockwise_l2_scan(Xt, Yt, 0.1, 24, it)) for it in (1, 2, 5)]
    assert values[0] > values[1] > values[2]


# ---- the pipeline --------------------------------------------------------------

@pytest.fixture(scope="module")
def timit_runs():
    """One fit of the JAX test's configuration in each package, on the same
    data, the port with the JAX branches' W and b."""
    conf_j = jt.TimitConfig(**CONF)
    j_train = jt.synthetic_timit(768, conf_j.num_classes, seed=1)
    j_test = jt.synthetic_timit(256, conf_j.num_classes, seed=2)
    predictor, evaluation, _ = jt.run(j_train, j_test, conf_j)
    mapper = next(o for o in predictor.fit().graph.operators.values()
                  if isinstance(o, JBlockMapper))
    featurizer = jt.build_featurizer(conf_j)
    arrays = {name: (np.array(d.labels.to_array()), np.array(d.data.to_array()))
              for name, d in (("train", j_train), ("test", j_test))}

    def j_scores(X):
        return np.asarray(mapper.trace_batch(jnp.asarray(featurizer(X).get().to_array())))

    params = _jax_params(conf_j)
    conf_t = tt.TimitConfig(**CONF)
    t_train = tt.synthetic_timit(768, conf_t.num_classes, seed=1)
    t_test = tt.synthetic_timit(256, conf_t.num_classes, seed=2)
    timings = {}
    scorer, t_tr, t_te, _ = tt.run(t_train, t_test, conf_t, CPU, timings, params)
    scores = scorer.fit()
    fitted = scorer.and_then(MaxClassifier()).fit()
    return dict(
        arrays=arrays, j_error=evaluation.total_error, t_errs=(t_tr, t_te), timings=timings,
        j_scores={k: j_scores(v[1]) for k, v in arrays.items()},
        t_scores={k: scores.apply(torch.from_numpy(v[1])).to_array().numpy()
                  for k, v in arrays.items()},
        t_preds={k: fitted.apply(torch.from_numpy(v[1])).to_array().numpy()
                 for k, v in arrays.items()},
        params=dict(cosine_W=np.stack([W for W, _ in params]),
                    cosine_b=np.stack([b for _, b in params]),
                    W=np.concatenate([np.asarray(w) for w in mapper.xs]),
                    b=np.asarray(mapper.b),
                    feature_means=np.concatenate([np.asarray(m) for m in mapper.feature_means])),
    )


@pytest.mark.parametrize("split", ["train", "test"])
def test_pipeline_scores_match_jax(timit_runs, split):
    got, want = timit_runs["t_scores"][split], timit_runs["j_scores"][split]
    assert got.shape == want.shape == (len(timit_runs["arrays"][split][0]), 12)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(timit_runs["t_preds"][split], want.argmax(1))


def test_pipeline_errors_match_jax(timit_runs):
    t_tr, t_te = timit_runs["t_errs"]
    assert t_te == timit_runs["j_error"]
    assert t_te < 0.2 and t_tr < 0.2  # 12 classes: chance errs ~92 %
    assert set(timit_runs["timings"]) == {"data", "optimize", "featurize", "solve",
                                          "executor", "apply"}


def test_weights_carried_from_jax_give_jax_scores(timit_runs):
    X = torch.from_numpy(timit_runs["arrays"]["test"][1])
    want = timit_runs["j_scores"]["test"]
    scores = tt.fitted_from_arrays(timit_runs["params"], CPU, classify=False).apply(X)
    np.testing.assert_allclose(scores.to_array().numpy(), want, atol=1e-4)
    preds = tt.fitted_from_arrays(timit_runs["params"], CPU).apply(X).to_array().numpy()
    np.testing.assert_array_equal(preds, want.argmax(1))


def _plan(analysis, fusion, graph):
    """A graph as plain data in ``linearize`` order: operator class, fused
    step labels, dependencies as positions (as ``test_torch_fusion.py``)."""
    order = [g for g in analysis.linearize(graph) if g in graph.operators]
    pos = {g: i for i, g in enumerate(order)}
    rows = []
    for g in order:
        op = graph.get_operator(g)
        steps = ([s.label for s, _ in op.steps]
                 if isinstance(op, fusion.FusedTransformerOperator) else None)
        rows.append((type(op).__name__, steps,
                     tuple(pos.get(d, "source") for d in graph.get_dependencies(g))))
    return len(order), rows


def test_plan_matches_jax():
    conf = dict(CONF, num_cosines=4)
    j_train = jt.synthetic_timit(96, 12, seed=1)
    j_labels = JCLI(12).apply_batch(j_train.labels)
    conf_j = jt.TimitConfig(**conf)
    j_pipe = jt.build_featurizer(conf_j).and_then(
        jt.BlockLeastSquaresEstimator(256, 2, 10.0), j_train.data, j_labels).and_then(JMax())
    X = torch.from_numpy(np.array(j_train.data.to_array()))
    labels = ClassLabelIndicators(12).forward(torch.from_numpy(np.array(j_train.labels.to_array())))
    t_pipe = tt.build_featurizer(tt.TimitConfig(**conf), CPU, _jax_params(conf_j)).and_then(
        BlockLeastSquaresEstimator(256, 2, 10.0), X, labels).and_then(MaxClassifier())
    jg, _ = JPipelineEnv.get_or_create().optimizer.execute(j_pipe.graph)
    tg, _ = PipelineEnv.get_or_create().optimizer.execute(t_pipe.graph)
    want = _plan(janalysis, jfusion, jg)
    assert _plan(tanalysis, tfusion, tg) == want
    # two fused featurizer copies (the fit data, the source): branches, gather, combiner
    fused = [steps for _, steps, _ in want[1] if steps]
    assert fused == [["CosineRandomFeatures"] * 4 + ["GatherTransformerOperator",
                                                     "VectorCombiner"]] * 2
    want_fitted = _plan(janalysis, jfusion, j_pipe.fit().graph)
    got_fitted = _plan(tanalysis, tfusion, t_pipe.fit().graph)
    assert got_fitted == want_fitted
    assert [cls for cls, _, _ in got_fitted[1]] == [
        "FusedTransformerOperator", "BlockLinearMapper", "MaxClassifier"]


def test_branch_nodes_are_cosine_features_on_the_device():
    feat = tt.build_featurizer(tt.TimitConfig(num_cosines=2, cosine_features=8), CPU)
    nodes = [op for op in feat.graph.operators.values() if isinstance(op, CosineRandomFeatures)]
    assert len(nodes) == 2 and all(n.W.shape == (8, 440) and n.W.device == CPU for n in nodes)


# ---- the command line ------------------------------------------------------------

def test_cli_runs_on_the_cpu_when_asked(capsys):
    from keystone_tpu_torch.__main__ import PIPELINES, main

    assert PIPELINES["TimitPipeline"] == (tt.run_app, tt.main)
    assert main(["TimitPipeline", "--device", "cpu", "--nTrain", "768", "--nTest", "256",
                 "--numCosines", "3", "--numClasses", "12", "--lambda", "10",
                 "--numEpochs", "2"]) == 0
    out = capsys.readouterr().out
    assert "TRAIN Error is" in out and "TEST Error is" in out


def test_cli_flags_and_defaults_are_the_jax_clis():
    args = tt.parse_args(["TimitPipeline"])
    assert (args.numCosines, args.gamma, args.rfType, args.lam, args.numEpochs,
            args.numClasses, args.nTrain, args.nTest) == (50, 0.05555, "gaussian", 0.0, 5,
                                                          147, 2048, 512)
    with pytest.raises(SystemExit):
        tt.parse_args(["TimitPipeline", "--rfType", "laplace"])


def test_cli_without_device_cpu_does_not_run_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.run_app(["TimitPipeline", "--nTrain", "16", "--nTest", "8", "--numCosines", "1"])
