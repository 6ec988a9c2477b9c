"""RandomPatchCifarKernel, the port's first slice, against the JAX package
on the CPU: the data copies, the glue nodes, the learned filters, the whole
fitted pipeline, and the JAX fit's weights carried into the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.evaluation.multiclass import MulticlassClassifierEvaluator as JEval
from keystone_tpu.loaders.cifar import load_cifar as j_load_cifar
from keystone_tpu.loaders.cifar import synthetic_cifar as j_synthetic_cifar
from keystone_tpu.nodes.learning.kernel import KernelBlockLinearMapper as JMapper
from keystone_tpu.nodes.stats.core import StandardScalerModel as JScalerModel
from keystone_tpu.nodes.util import ClassLabelIndicators as JCLI
from keystone_tpu.nodes.util import MaxClassifier as JMax
from keystone_tpu.pipelines import cifar_extras as jce
from keystone_tpu.pipelines.random_patch_cifar import learn_filters as j_learn_filters
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.cifar import load_cifar, synthetic_cifar
from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.pipelines import cifar_extras as tce
from keystone_tpu_torch.pipelines.random_patch_cifar import learn_filters
from keystone_tpu_torch.workflow.env import PipelineEnv

CPU = torch.device("cpu")
# the config of the JAX package's test_random_patch_cifar_kernel_streaming
CONF = dict(num_filters=16, lam=1.0, gamma=1e-3, block_size=64, num_epochs=1,
            cache_kernel=False, whitener_size=2000, pool_size=8, pool_stride=7)


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


@pytest.mark.parametrize("n,seed", [(5, 0), (192, 7), (48, 8)])
def test_synthetic_cifar_is_the_jax_copy_bit_for_bit(n, seed):
    a, b = synthetic_cifar(n, seed=seed), j_synthetic_cifar(n, seed=seed)
    np.testing.assert_array_equal(a.data.to_array().numpy(), np.asarray(b.data.to_array()))
    np.testing.assert_array_equal(a.labels.to_array().numpy(), np.asarray(b.labels.to_array()))


def test_load_cifar_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    rec = rng.integers(0, 256, size=(3, 1 + 32 * 32 * 3), dtype=np.uint8)
    path = tmp_path / "batch.bin"
    rec.tofile(path)
    a, b = load_cifar(str(path)), j_load_cifar(str(path))
    np.testing.assert_array_equal(a.data.to_array().numpy(), np.asarray(b.data.to_array()))
    np.testing.assert_array_equal(a.labels.to_array().numpy(), np.asarray(b.labels.to_array()))


def test_label_indicators_and_max_classifier_match_jax():
    y = np.array([0, 3, 9, 1, 3], dtype=np.int32)
    want = np.asarray(JCLI(10).apply_batch(JDataset.of(y)).to_array())
    np.testing.assert_array_equal(ClassLabelIndicators(10).forward(torch.from_numpy(y)).numpy(), want)
    # ties break to the first maximum, as jnp.argmax breaks them
    S = np.array([[1, 3, 3, 0], [2, 2, 2, 2], [0, -1, 5, 5]], dtype=np.float32)
    np.testing.assert_array_equal(MaxClassifier().forward(torch.from_numpy(S)).numpy(),
                                  np.asarray(JMax().trace_batch(jnp.asarray(S))))


def test_evaluator_matches_jax():
    rng = np.random.default_rng(1)
    p, a = rng.integers(0, 10, 300), rng.integers(0, 10, 300)
    got = MulticlassClassifierEvaluator(10).evaluate(torch.from_numpy(p), a)
    want = JEval(10).evaluate(p, a)
    np.testing.assert_array_equal(got.confusion_matrix, want.confusion_matrix)
    assert got.total_error == want.total_error
    assert got.macro_f_score() == want.macro_f_score()


@pytest.fixture(scope="module")
def slice_runs():
    """One fit of the slice in each package on the same data."""
    conf_j = jce.KernelCifarConfig(**CONF)
    conf_t = tce.KernelCifarConfig(**CONF)
    j_train, j_test = j_synthetic_cifar(192, seed=7), j_synthetic_cifar(48, seed=8)
    t_train, t_test = synthetic_cifar(192, seed=7), synthetic_cifar(48, seed=8)
    j_pipe, j_tr, j_te, _ = jce.run_random_patch_cifar_kernel(j_train, j_test, conf_j)
    j_filters, j_whitener = j_learn_filters(j_train.data, conf_j)
    ops = list(j_pipe.fit().graph.operators.values())
    scaler = next(o for o in ops if isinstance(o, JScalerModel))
    mapper = next(o for o in ops if isinstance(o, JMapper))
    feats = jce.Convolver(j_filters, 32, 32, 3, whitener=j_whitener, normalize_patches=True) \
        .and_then(jce.SymmetricRectifier(alpha=conf_j.alpha)) \
        .and_then(jce.Pooler(conf_j.pool_stride, conf_j.pool_size, None, "sum")) \
        .and_then(jce.ImageVectorizer())(j_test.data).get().to_array()
    j_scores = np.asarray(mapper.trace_batch(scaler.trace_batch(jnp.asarray(feats))))

    t_scorer, t_tr, t_te, _ = tce.run_random_patch_cifar_kernel(t_train, t_test, conf_t, CPU)
    t_filters, _ = learn_filters(t_train.data.to_array(), conf_t)
    t_scores = t_scorer.fit().apply(t_test.data.to_array()).to_array()
    params = dict(
        filters=np.asarray(j_filters), whitener=np.asarray(j_whitener.whitener),
        means=np.asarray(j_whitener.means), scaler_mean=np.asarray(scaler.mean),
        scaler_std=np.asarray(scaler.std), train_X=np.asarray(mapper.train_X),
        W=np.asarray(mapper.W), gamma=mapper.gamma, block_size=mapper.block_size,
    )
    return dict(j_filters=np.asarray(j_filters), t_filters=t_filters.numpy(),
                j_scores=j_scores, t_scores=t_scores.numpy(), j_errs=(j_tr, j_te),
                t_errs=(t_tr, t_te), params=params, conf=conf_t, test=t_test)


def test_learned_filters_match_jax(slice_runs):
    # atol 1e-4: a float32 SVD of the 2000-patch sample in two bindings
    np.testing.assert_allclose(slice_runs["t_filters"], slice_runs["j_filters"], atol=1e-4)


def test_slice_scores_and_predictions_match_jax(slice_runs):
    got, want = slice_runs["t_scores"], slice_runs["j_scores"]
    assert got.shape == want.shape == (48, 10)
    # atol 1e-3: the filter differences above, carried through the
    # featurizer, the scaler and a 192-row kernel solve
    np.testing.assert_allclose(got, want, atol=1e-3)
    top2 = np.sort(want, axis=1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-3
    np.testing.assert_array_equal(got.argmax(1)[sure], want.argmax(1)[sure])
    assert slice_runs["t_errs"][1] < 0.7


def test_weights_carried_from_jax_give_jax_scores(slice_runs):
    fitted = tce.fitted_from_arrays(slice_runs["params"], slice_runs["conf"], CPU)
    X = slice_runs["test"].data.to_array()
    scores = tce.fitted_from_arrays(slice_runs["params"], slice_runs["conf"], CPU,
                                    classify=False).apply(X).to_array().numpy()
    # atol 1e-4: the same weights; only float32 summation order differs
    np.testing.assert_allclose(scores, slice_runs["j_scores"], atol=1e-4)
    preds = fitted.apply(X).to_array().numpy()
    np.testing.assert_array_equal(preds, scores.argmax(1))


def test_cli_runs_on_the_cpu_when_asked(capsys):
    from keystone_tpu_torch.__main__ import main

    assert main(["RandomPatchCifarKernel", "--device", "cpu", "--nTrain", "64",
                 "--nTest", "16", "--numFilters", "8",
                 "--blockSize", "24", "--lambda", "1.0", "--poolSize", "8",
                 "--poolStride", "7"]) == 0
    out = capsys.readouterr().out
    assert "Training error is:" in out and "Test error is:" in out
