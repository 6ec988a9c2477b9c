"""MnistRandomFFT, the port's second slice, against the JAX package on the
CPU: the random-feature nodes, the gathered featurizer, the row-chunked
apply, the synthetic task, the whole fitted pipeline at the JAX test's
config, and the JAX fit's parameters carried into the port.

The JAX nodes draw their signs with ``jax.random``; the port draws with
numpy, so every parity test here copies the JAX node's signs. The tasks
drawn on the device (``torch.Generator``) cannot match ``jax.random``'s
values either: they are held by their statistics, run on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes.learning.linear import BlockLinearMapper as JBlockMapper
from keystone_tpu.nodes.stats import LinearRectifier as JRectifier
from keystone_tpu.nodes.stats import PaddedFFT as JPaddedFFT
from keystone_tpu.nodes.stats import RandomSignNode as JSignNode
from keystone_tpu.nodes.util import VectorCombiner as JCombiner
from keystone_tpu.pipelines import mnist_random_fft as jm
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.loaders.csv_loader import LabeledData, load_labeled_csv
from keystone_tpu_torch.nodes.learning.linear import (
    BlockLeastSquaresEstimator,
    LinearMapEstimator,
)
from keystone_tpu_torch.nodes.stats import LinearRectifier, PaddedFFT, RandomSignNode
from keystone_tpu_torch.nodes.util import MaxClassifier, VectorCombiner
from keystone_tpu_torch.pipelines import mnist_random_fft as tm
from keystone_tpu_torch.workflow import fusion
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.operators import GatherTransformerOperator
from keystone_tpu_torch.workflow.pipeline import Pipeline
from keystone_tpu_torch.workflow.transformer import Identity

CPU = torch.device("cpu")
# the config of the JAX package's test_mnist_random_fft_end_to_end
CONF = dict(num_ffts=2, block_size=512, lam=10.0)


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _x(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _jax_signs(num_ffts, seed=0):
    return np.stack([np.array(JSignNode.create(784, seed=seed + i).signs)
                     for i in range(num_ffts)])


def _close_to_row_max(got, want, tol=1e-4):
    """|got − want| ≤ tol · (largest |want| of the row): the FFT sums of two
    libraries in another order."""
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=-1, keepdims=True, initial=1.0)
    assert np.all(np.abs(got - want) <= tol * scale), np.abs(got - want).max()


@pytest.mark.parametrize("d", [784, 512, 100, 1])
def test_padded_fft_matches_jax(d):
    X = _x(9, d, seed=d)
    got = PaddedFFT().forward(torch.from_numpy(X))
    want = np.asarray(JPaddedFFT().trace_batch(jnp.asarray(X)))
    assert got.is_contiguous()
    _close_to_row_max(got.numpy(), want)


def test_random_sign_node_matches_jax_with_copied_signs():
    signs = np.array(JSignNode.create(784, seed=3).signs)
    X = _x(6, 784)
    got = RandomSignNode(torch.from_numpy(signs)).forward(torch.from_numpy(X)).numpy()
    want = np.asarray(JSignNode(signs).trace_batch(jnp.asarray(X)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_random_sign_create_draws_signs_from_numpy():
    a = RandomSignNode.create(784, seed=5, device="cpu").signs
    b = RandomSignNode.create(784, seed=5, device="cpu").signs
    c = RandomSignNode.create(784, seed=6, device="cpu").signs
    assert a.dtype == torch.float32 and a.shape == (784,)
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("max_val,alpha", [(0.0, 0.0), (0.5, 0.25), (-1.0, 2.0)])
def test_linear_rectifier_matches_jax(max_val, alpha):
    X = _x(7, 33)
    got = LinearRectifier(max_val, alpha).forward(torch.from_numpy(X)).numpy()
    want = np.asarray(JRectifier(max_val, alpha).trace_batch(jnp.asarray(X)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_gather_and_combiner_match_jax():
    conf = jm.MnistRandomFFTConfig(num_ffts=3, seed=4)
    X = _x(20, 784, seed=1)
    want = np.asarray(jm.build_featurizer(conf)(JDataset.of(X)).get().to_array())
    feat = tm.build_featurizer(tm.MnistRandomFFTConfig(num_ffts=3, seed=4), CPU,
                               signs=_jax_signs(3, seed=4))
    got = feat(torch.from_numpy(X)).get().to_array().numpy()
    assert got.shape == want.shape == (20, 3 * 512)
    _close_to_row_max(got, want)
    # the combiner alone, on a gather tuple
    parts = (torch.from_numpy(X[:, :5]), torch.from_numpy(X[:, 5:7]))
    np.testing.assert_array_equal(
        VectorCombiner().forward(parts).numpy(),
        np.asarray(JCombiner().trace_batch(tuple(jnp.asarray(p.numpy()) for p in parts))))


def test_gather_is_row_local_and_runs_in_row_chunks(monkeypatch):
    signs = RandomSignNode.create(784, seed=0, device="cpu").signs, \
        RandomSignNode.create(784, seed=1, device="cpu").signs
    gather = Pipeline.gather([RandomSignNode(s).and_then(PaddedFFT()).and_then(LinearRectifier(0.0))
                              for s in signs])
    assert GatherTransformerOperator.row_local
    feat = tm.build_featurizer(tm.MnistRandomFFTConfig(num_ffts=2), CPU, signs=torch.stack(signs))
    gather_fit, feat_fit = gather.fit(), feat.fit()
    for fitted in (gather_fit, feat_fit):
        (op,) = fitted.graph.operators.values()
        assert isinstance(op, fusion.FusedTransformerOperator) and op.row_local
    X = torch.from_numpy(_x(50, 784, seed=2))
    whole_tuple = gather_fit.apply(X).to_array()
    whole = feat_fit.apply(X).to_array()
    monkeypatch.setattr(fusion, "ROW_CHUNK", 8)
    chunked_tuple = gather_fit.apply(X).to_array()
    assert isinstance(chunked_tuple, tuple) and len(chunked_tuple) == 2
    for a, b in zip(chunked_tuple, whole_tuple):
        # 1e-6 · row max: an FFT of fewer rows may take another plan
        _close_to_row_max(a.numpy(), b.numpy(), tol=1e-6)
    _close_to_row_max(feat_fit.apply(X).to_array().numpy(), whole.numpy(), tol=1e-6)
    # a tuple payload goes through a chunked run too
    combined = Identity().and_then(VectorCombiner()).fit().apply(chunked_tuple).to_array()
    torch.testing.assert_close(combined, torch.cat(chunked_tuple, dim=1), rtol=0, atol=0)


def test_gather_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="zero branches"):
        Pipeline.gather([])
    # an estimator is chained with its data, never gathered bare
    with pytest.raises(TypeError, match="not directly chainable"):
        Pipeline.gather([BlockLeastSquaresEstimator(4, 1)])


def test_tuple_dataset():
    a, b = torch.arange(12.0).reshape(6, 2), torch.arange(6.0).reshape(6, 1)
    ds = Dataset.of((a, b))
    assert len(ds) == 6 and isinstance(ds.to_array(), tuple)
    head = ds.take(4).to_array()
    assert [t.shape for t in head] == [(4, 2), (4, 1)]
    with pytest.raises(ValueError, match="differ in rows"):
        Dataset((a, b[:5]))


def test_synthetic_mnist_is_the_task():
    train, test = tm.synthetic_mnist(2000, 300, seed=3)
    again, _ = tm.synthetic_mnist(2000, 300, seed=3)
    other, _ = tm.synthetic_mnist(2000, 300, seed=4)
    X, y = train.data.to_array().numpy(), train.labels.to_array().numpy()
    assert X.shape == (2000, 784) and X.dtype == np.float32 and y.dtype == np.int32
    assert len(test) == 300 and set(np.unique(y)) == set(range(10))
    np.testing.assert_array_equal(X, again.data.to_array().numpy())
    assert not np.array_equal(X, other.data.to_array().numpy())
    # the latent: x = U·u + noise with U orthonormal (8 columns)
    task, *_ = tm._streams(3)
    mu, U = tm._latent_task_params(task)
    np.testing.assert_allclose(U.T @ U, np.eye(8), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(mu, axis=1), tm.PROTO_RADIUS, rtol=1e-5)
    resid = X - (X @ U) @ U.T
    assert abs(resid.std() - tm.AMBIENT_SIGMA) < 0.005


def test_raw_pixels_carry_no_linear_signal():
    """E[x|c] = 0: a ridge on raw pixels sits near chance (0.9 error)."""
    train, test = tm.synthetic_mnist(4096, 1024, seed=5)
    Y = 2.0 * torch.nn.functional.one_hot(train.labels.to_array().long(), 10).float() - 1.0
    model = LinearMapEstimator(lam=1.0).fit(train.data, Dataset.of(Y))
    pred = model.forward(test.data.to_array()).argmax(1).numpy()
    assert np.mean(pred != test.labels.to_array().numpy()) > 0.75


def test_bayes_error_is_the_instance_error():
    """The Monte-Carlo Bayes error equals the error of the Bayes rule (the
    nearest of ±μ_c on Uᵀx) on data drawn from the same seed, within four
    binomial standard deviations."""
    seed = 11
    bayes = tm.bayes_error_mc(seed)
    assert bayes == tm.bayes_error_mc(seed) and 0.005 < bayes < 0.1
    _, test = tm.synthetic_mnist(16, 20000, seed=seed)
    mu, U = tm._latent_task_params(tm._streams(seed)[0])
    u = test.data.to_array().numpy().astype(np.float64) @ U
    P2 = np.concatenate([mu, -mu]).astype(np.float64)
    pred = np.argmax(u @ P2.T - 0.5 * (P2 * P2).sum(1), axis=1) % 10
    err = np.mean(pred != test.labels.to_array().numpy())
    assert abs(err - bayes) < 4 * np.sqrt(bayes * (1 - bayes) / 20000) + 4 * np.sqrt(
        bayes * (1 - bayes) / 262144)


def test_device_draws_have_the_tasks_shapes_and_label_frequencies():
    """``synthetic_mnist_device`` and ``linear_task_device`` on the CPU:
    float32 rows of 784 on the device named, int32 labels on the host, each
    class near a tenth (four binomial standard deviations)."""
    train, test = tm.synthetic_mnist_device(3000, 500, seed=3, device="cpu")
    ltrain, ltest, lbayes = tm.linear_task_device(3000, 500, seed=3, device="cpu",
                                                  mc_rows=20000)
    for tr, te in ((train, test), (ltrain, ltest)):
        X, y = tr.data.to_array(), tr.labels.to_array()
        assert X.shape == (3000, 784) and X.dtype == torch.float32 and X.device == CPU
        assert y.dtype == torch.int32 and len(te) == 500
        freq = np.bincount(y.numpy(), minlength=10) / 3000
        assert np.all(np.abs(freq - 0.1) < 4 * np.sqrt(0.09 / 3000)), freq
    assert 0.005 < lbayes < 0.2


def test_device_draws_hold_the_tasks_class_statistics():
    """Per class, within an n-scaled bound (six standard errors): the linear
    task's mean is its prototype; the latent task's mean is 0 (the sign
    flip) and its second moment in the latent is μ_c μ_cᵀ + σ_eff² I."""
    n = 6000
    ltrain, _, _ = tm.linear_task_device(n, 10, seed=5, device="cpu", mc_rows=1000)
    protos = tm._linear_task_protos(5, CPU).double().numpy()
    X, y = ltrain.data.to_array().double().numpy(), ltrain.labels.to_array().numpy()
    for c in range(10):
        Xc = X[y == c]
        bound = 6 * tm.NOISE_SIGMA / np.sqrt(len(Xc))
        assert np.abs(Xc.mean(0) - protos[c]).max() < bound, c
    train, _ = tm.synthetic_mnist_device(n, 10, seed=5, device="cpu")
    mu, U = (t.double().numpy() for t in tm._latent_task_params_device(5, CPU))
    np.testing.assert_allclose(U.T @ U, np.eye(tm.LATENT_DIM), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(mu, axis=1), tm.PROTO_RADIUS, rtol=1e-5)
    X, y = train.data.to_array().double().numpy(), train.labels.to_array().numpy()
    sig2 = tm.LATENT_SIGMA ** 2 + tm.AMBIENT_SIGMA ** 2
    for c in range(10):
        u = X[y == c] @ U
        se = np.sqrt((2 * tm.PROTO_RADIUS ** 2 + sig2) * sig2 / len(u))
        assert np.abs(u.mean(0)).max() < 6 * np.sqrt((tm.PROTO_RADIUS ** 2 + sig2) / len(u)), c
        second = u.T @ u / len(u) - sig2 * np.eye(tm.LATENT_DIM)
        assert np.abs(second - np.outer(mu[c], mu[c])).max() < 6 * se + 6 * sig2 / np.sqrt(
            len(u)), c


def test_device_draws_repeat_for_a_seed_and_differ_across_seeds():
    a, at = tm.synthetic_mnist_device(500, 100, seed=7, device="cpu")
    b, bt = tm.synthetic_mnist_device(500, 100, seed=7, device="cpu")
    c, _ = tm.synthetic_mnist_device(500, 100, seed=8, device="cpu")
    assert torch.equal(a.data.to_array(), b.data.to_array())
    assert torch.equal(a.labels.to_array(), b.labels.to_array())
    assert torch.equal(at.data.to_array(), bt.data.to_array())
    assert not torch.equal(a.data.to_array(), c.data.to_array())
    assert not torch.equal(a.data.to_array()[:100], at.data.to_array())  # train ≠ test
    la = tm.linear_task_device(500, 100, seed=7, device="cpu", mc_rows=1000)
    lb = tm.linear_task_device(500, 100, seed=7, device="cpu", mc_rows=1000)
    lc = tm.linear_task_device(500, 100, seed=8, device="cpu", mc_rows=1000)
    assert torch.equal(la[0].data.to_array(), lb[0].data.to_array()) and la[2] == lb[2]
    assert not torch.equal(la[0].data.to_array(), lc[0].data.to_array())
    assert tm.bayes_error_mc_device(7, 5000, CPU) == tm.bayes_error_mc_device(7, 5000, CPU)


def test_device_bayes_errors_agree_with_the_float64_rule_on_the_same_draws():
    """Each task's Monte-Carlo Bayes error, computed on the device in
    float32, equals the Bayes rule evaluated in float64 numpy on the same
    draws, up to draws within float32 rounding of a tie."""
    n = 20000
    bayes = tm.bayes_error_mc_device(11, n, CPU)
    mu, y, u = (t.numpy() for t in tm._bayes_mc_draws(11, n, CPU))
    P2 = np.concatenate([mu, -mu]).astype(np.float64)
    pred = np.argmax(u.astype(np.float64) @ P2.T - 0.5 * (P2 * P2).sum(1), axis=1) % 10
    assert abs(np.mean(pred != y) - bayes) <= 2 / n and 0.005 < bayes < 0.1
    _, _, lbayes = tm.linear_task_device(10, 10, seed=11, device="cpu", mc_rows=n)
    protos = tm._linear_task_protos(11, CPU)
    ly, lX = tm._linear_task_draw(protos, tm._device_generator(CPU, 11, 3), n)
    P = protos.double().numpy()
    lpred = np.argmax(lX.double().numpy() @ P.T - 0.5 * (P * P).sum(1), axis=1)
    assert abs(np.mean(lpred != ly.numpy()) - lbayes) <= 2 / n and 0.005 < lbayes < 0.2


def test_load_labeled_csv_matches_jax(tmp_path):
    from keystone_tpu.loaders.csv_loader import load_labeled_csv as j_load

    rows = np.array([[1, 0.5, 2.0], [3, -1.0, 0.25], [10, 7.0, 8.0]], np.float32)
    for sep, name in ((",", "a.csv"), (" ", "b.csv")):
        path = tmp_path / name
        np.savetxt(path, rows, delimiter=sep)
        got, want = load_labeled_csv(str(path), label_offset=1), j_load(str(path), label_offset=1)
        np.testing.assert_array_equal(got.labels.to_array().numpy(),
                                      np.asarray(want.labels.to_array()))
        np.testing.assert_array_equal(got.data.to_array().numpy(),
                                      np.asarray(want.data.to_array()))


@pytest.fixture(scope="module")
def slice_runs():
    """One fit of the slice in each package on the same data and signs."""
    j_train, j_test = jm.synthetic_mnist(n_train=4096, n_test=512, seed=7)
    arrays = {name: (np.array(d.labels.to_array()), np.array(d.data.to_array()))
              for name, d in (("train", j_train), ("test", j_test))}
    t_train, t_test = (LabeledData(*arrays[k]) for k in ("train", "test"))
    conf_j = jm.MnistRandomFFTConfig(**CONF)
    j_pipe, j_tr, j_te, _ = jm.run(j_train, j_test, conf_j)
    ops = list(j_pipe.fit().graph.operators.values())
    mapper = next(o for o in ops if isinstance(o, JBlockMapper))
    featurizer = jm.build_featurizer(conf_j)

    def j_scores(X):
        feats = featurizer(JDataset.of(X)).get().to_array()
        return np.asarray(mapper.trace_batch(jnp.asarray(feats)))

    signs = _jax_signs(CONF["num_ffts"])
    t_scorer, t_tr, t_te, _ = tm.run(t_train, t_test, tm.MnistRandomFFTConfig(**CONF), CPU,
                                     signs=signs)
    scores = t_scorer.fit()
    fitted = t_scorer.and_then(MaxClassifier()).fit()
    params = dict(signs=signs, W=np.concatenate([np.asarray(w) for w in mapper.xs]),
                  b=np.asarray(mapper.b),
                  feature_means=np.concatenate([np.asarray(m) for m in mapper.feature_means]))
    return dict(
        arrays=arrays, params=params, j_errs=(j_tr, j_te), t_errs=(t_tr, t_te),
        j_scores={k: j_scores(arrays[k][1]) for k in arrays},
        t_scores={k: scores.apply(torch.from_numpy(arrays[k][1])).to_array().numpy()
                  for k in arrays},
        t_preds={k: fitted.apply(torch.from_numpy(arrays[k][1])).to_array().numpy()
                 for k in arrays},
    )


def _sure(scores, gap=1e-4):
    top2 = np.sort(scores, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > gap


@pytest.mark.parametrize("split", ["train", "test"])
def test_slice_predictions_match_jax_row_for_row(slice_runs, split):
    want = slice_runs["j_scores"][split]
    got = slice_runs["t_scores"][split]
    assert got.shape == want.shape
    # 1e-3: FFT and 512-column block solves in two float32 bindings
    np.testing.assert_allclose(got, want, atol=1e-3)
    sure = _sure(want)
    np.testing.assert_array_equal(slice_runs["t_preds"][split][sure], want.argmax(1)[sure])


def test_slice_errors_equal_jax(slice_runs):
    assert slice_runs["t_errs"] == slice_runs["j_errs"]
    assert slice_runs["t_errs"][0] < 0.15 and slice_runs["t_errs"][1] < 0.35


def test_weights_carried_from_jax_give_jax_predictions(slice_runs):
    fitted = tm.fitted_from_arrays(slice_runs["params"], CPU)
    X = torch.from_numpy(slice_runs["arrays"]["test"][1])
    want = slice_runs["j_scores"]["test"]
    scores = tm.fitted_from_arrays(slice_runs["params"], CPU, classify=False) \
        .apply(X).to_array().numpy()
    # 1e-4: the same weights; only the FFT and GEMM sum orders differ
    np.testing.assert_allclose(scores, want, atol=1e-4)
    preds = fitted.apply(X).to_array().numpy()
    sure = _sure(want)
    np.testing.assert_array_equal(preds[sure], want.argmax(1)[sure])


def test_cli_runs_on_the_cpu_when_asked(capsys):
    from keystone_tpu_torch.__main__ import main

    assert main(["MnistRandomFFT", "--device", "cpu", "--nTrain", "1024", "--nTest", "128",
                 "--numFFTs", "2", "--blockSize", "512", "--lambda", "10"]) == 0
    out = capsys.readouterr().out
    assert "TRAIN Error is" in out and "TEST Error is" in out
