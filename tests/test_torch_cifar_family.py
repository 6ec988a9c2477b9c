"""The rest of the CIFAR family against the JAX package on the CPU: the
image nodes (crops, flips and patch order equal, grayscale and pixel
scaling equal to the last bit), the glue nodes (MatrixVectorizer's
column-major order, MultiClassLabelIndicators, Cacher), the augmented and
mean-average-precision evaluators (equal), and RandomPatchCifar,
LinearPixels, RandomCifar and RandomPatchCifarAugmented at the JAX tests'
sizes: equal errors and predictions, scores within 1e-3 (float32
featurizers and solves of two libraries from the same data and the same
numpy draws)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.evaluation.augmented import AugmentedExamplesEvaluator as JAugmented
from keystone_tpu.evaluation.mean_average_precision import MeanAveragePrecisionEvaluator as JMAP
from keystone_tpu.loaders.cifar import synthetic_cifar as j_synthetic_cifar
from keystone_tpu.nodes.images import core as jcore
from keystone_tpu.nodes.util import core as jutil
from keystone_tpu.pipelines import cifar_extras as jce
from keystone_tpu.pipelines import random_patch_cifar as jrpc
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.evaluation.augmented import AugmentedExamplesEvaluator
from keystone_tpu_torch.evaluation.mean_average_precision import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.loaders.cifar import synthetic_cifar
from keystone_tpu_torch.nodes.images import core as tcore
from keystone_tpu_torch.nodes.util import Cacher, MatrixVectorizer, MultiClassLabelIndicators
from keystone_tpu_torch.pipelines import cifar_extras as tce
from keystone_tpu_torch.pipelines import random_patch_cifar as trpc
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.fusion import FusedTransformerOperator

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _imgs(n=5, x=9, y=7, c=3, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (n, x, y, c)).astype(np.float32)


def _j(node, X):
    return np.asarray(node.trace_batch(jnp.asarray(X)))


# ---- image nodes: exact -------------------------------------------------

@pytest.mark.parametrize("c", [3, 1, 2])
def test_gray_and_pixel_scalers_are_bit_equal(c):
    X = _imgs(c=c)
    np.testing.assert_array_equal(tcore.GrayScaler().forward(torch.from_numpy(X)).numpy(),
                                  _j(jcore.GrayScaler(), X))
    np.testing.assert_array_equal(tcore.PixelScaler().forward(torch.from_numpy(X)).numpy(),
                                  _j(jcore.PixelScaler(), X))
    u8 = X.astype(np.uint8)
    np.testing.assert_array_equal(tcore.GrayScaler().forward(torch.from_numpy(u8)).numpy(),
                                  _j(jcore.GrayScaler(), u8))


def test_cropper_and_center_corner_patcher_are_equal():
    X = _imgs(n=3, x=10, y=8)
    np.testing.assert_array_equal(tcore.Cropper(1, 2, 7, 6).forward(torch.from_numpy(X)).numpy(),
                                  _j(jcore.Cropper(1, 2, 7, 6), X))
    for flips in (False, True):
        got = tcore.CenterCornerPatcher(5, 4, flips).forward(torch.from_numpy(X)).numpy()
        want = _j(jcore.CenterCornerPatcher(5, 4, flips), X)
        assert got.shape == want.shape == (3 * (10 if flips else 5), 5, 4, 3)
        np.testing.assert_array_equal(got, want)
    # (crop, flipped crop) pairs, image by image
    got = tcore.CenterCornerPatcher(5, 4, True).forward(torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got[1], got[0][:, ::-1])
    np.testing.assert_array_equal(got[10], X[1, :5, :4])


def test_random_patcher_and_flipper_draw_the_same_crops_and_flips():
    X = _imgs(n=6, x=12, y=11)
    mine, ref = tcore.RandomPatcher(3, 5, 4, seed=7), jcore.RandomPatcher(3, 5, 4, seed=7)
    flip, jflip = tcore.RandomImageTransformer(0.5, seed=8), jcore.RandomImageTransformer(0.5, seed=8)
    for _ in range(2):  # the second batch draws anew in both
        got = mine.apply_batch(torch.from_numpy(X)).to_array()
        want = ref.apply_batch(JDataset.of(X)).to_array()
        assert tuple(got.shape) == (18, 5, 4, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(flip.apply_batch(got).to_array().numpy(),
                                      np.asarray(jflip.apply_batch(JDataset.of(np.asarray(want)))
                                                 .to_array()))


def test_images_from_vectors_and_pack_filter_images_match_jax():
    X = _imgs(n=2, x=4, y=3, c=2)
    V = tcore.vectorize_images(torch.from_numpy(X))
    np.testing.assert_array_equal(tcore.images_from_vectors(V, 4, 3, 2).numpy(), X)
    np.testing.assert_array_equal(tcore.images_from_vectors(V, 4, 3, 2).numpy(),
                                  np.asarray(jcore.images_from_vectors(jnp.asarray(V.numpy()), 4, 3, 2)))
    F = _imgs(n=4, x=3, y=3, c=3)
    np.testing.assert_array_equal(tcore.pack_filter_images(torch.from_numpy(F)).numpy(),
                                  np.asarray(jcore.pack_filter_images(F)))


def test_extractors_pick_their_part():
    item = ([1, 4], np.zeros((2, 2, 3)))
    assert tcore.LabelExtractor().apply(item) == jcore.LabelExtractor().apply(item)
    assert tcore.MultiLabelExtractor().apply(item) == [1, 4]
    assert tcore.ImageExtractor().apply(item) is item[1]


# ---- glue nodes ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 4, 5), (2, 1, 6), (1, 7, 2)])
def test_matrix_vectorizer_is_column_major(shape):
    X = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = MatrixVectorizer().forward(torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got, _j(jutil.MatrixVectorizer(), X))
    np.testing.assert_array_equal(got[0], X[0].ravel(order="F"))


def test_multiclass_label_indicators_match_jax():
    sets = [[0], [3, 7], [19, 0, 5]]
    got = MultiClassLabelIndicators(20).apply_batch(Dataset.from_items(sets)).to_array().numpy()
    want = np.asarray(jutil.MultiClassLabelIndicators(20).apply_batch(JDataset.from_items(sets))
                      .to_array())
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        MultiClassLabelIndicators(1)


def test_cacher_holds_its_input_and_fuses_as_the_identity():
    X = torch.arange(12.0).reshape(4, 3)
    assert Cacher().apply_batch(X).to_array() is X
    fitted = Cacher().and_then(MatrixVectorizer()).fit()
    (op,) = fitted.graph.operators.values()
    assert isinstance(op, FusedTransformerOperator)
    torch.testing.assert_close(fitted.apply(X.reshape(4, 3, 1)).to_array(), X, rtol=0, atol=0)


# ---- evaluators: equal -------------------------------------------------

@pytest.mark.parametrize("policy", ["average", "borda"])
def test_augmented_evaluator_matches_jax(policy):
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((40, 10))
    names = np.repeat(np.arange(8), 5).tolist()
    labels = np.repeat(rng.integers(0, 10, 8), 5)
    got = AugmentedExamplesEvaluator(names, 10, policy).evaluate(torch.from_numpy(scores), labels)
    want = JAugmented(names, 10, policy).evaluate(scores, labels)
    np.testing.assert_array_equal(got.confusion_matrix, want.confusion_matrix)
    assert got.total_error == want.total_error


def test_mean_average_precision_matches_jax():
    rng = np.random.default_rng(4)
    scores = rng.standard_normal((30, 6))
    scores[3] = scores[4]  # ties rank stably in both
    actuals = [rng.choice(6, size=rng.integers(1, 3), replace=False) for _ in range(30)]
    got = MeanAveragePrecisionEvaluator(6).evaluate(torch.from_numpy(scores), actuals)
    np.testing.assert_array_equal(got, JMAP(6).evaluate(scores, actuals))
    # the JAX test's oracle: class 0 ranked perfectly
    preds = np.array([[0.9, 0.1], [0.8, 0.9], [0.2, 0.8], [0.1, 0.7]])
    aps = MeanAveragePrecisionEvaluator(2).evaluate(preds, [[0], [0], [1], [0, 1]])
    np.testing.assert_array_equal(aps, JMAP(2).evaluate(preds, [[0], [0], [1], [0, 1]]))
    assert aps[0] > 0.8


# ---- the four applications at the JAX tests' sizes ------------------------

def _preds(pipeline_result):
    return np.asarray(pipeline_result.get().to_array())


def test_random_patch_cifar_matches_jax():
    train, test = synthetic_cifar(512, seed=1), synthetic_cifar(128, seed=2)
    jtrain, jtest = j_synthetic_cifar(512, seed=1), j_synthetic_cifar(128, seed=2)
    kw = dict(num_filters=32, patch_steps=2, whitener_size=2000, lam=100.0, seed=0)
    jpipe, jtr, jte, _ = jrpc.run(jtrain, jtest, jrpc.RandomCifarConfig(**kw))
    pipe, tr, te, _ = trpc.run(train, test, trpc.RandomCifarConfig(**kw), CPU)
    assert (tr, te) == (jtr, jte)
    assert tr < 0.1 and te < 0.3  # the JAX test's bounds
    got = pipe.fit().apply(test.data.to_array()).to_array().numpy()
    np.testing.assert_array_equal(got, _preds(jpipe(jtest.data)))


def test_linear_pixels_matches_jax():
    train, test = synthetic_cifar(512, seed=1), synthetic_cifar(128, seed=2)
    jtrain, jtest = j_synthetic_cifar(512, seed=1), j_synthetic_cifar(128, seed=2)
    jpipe, jtr, jte, _ = jce.run_linear_pixels(jtrain, jtest, lam=10.0)
    pipe, tr, te, _ = tce.run_linear_pixels(train, test, lam=10.0, device=CPU)
    assert (tr, te) == (jtr, jte) and te < 0.5
    got = pipe.fit().apply(test.data.to_array()).to_array().numpy()
    np.testing.assert_array_equal(got, _preds(jpipe(jtest.data)))


def test_random_cifar_matches_jax():
    train, test = synthetic_cifar(256, seed=3), synthetic_cifar(96, seed=4)
    jtrain, jtest = j_synthetic_cifar(256, seed=3), j_synthetic_cifar(96, seed=4)
    jpipe, jtr, jte, _ = jce.run_random_cifar(jtrain, jtest, jrpc.RandomCifarConfig(
        num_filters=32, lam=10.0))
    pipe, tr, te, _ = tce.run_random_cifar(train, test, trpc.RandomCifarConfig(
        num_filters=32, lam=10.0), CPU)
    assert (tr, te) == (jtr, jte) and te < 0.6
    got = pipe.fit().apply(test.data.to_array()).to_array().numpy()
    np.testing.assert_array_equal(got, _preds(jpipe(jtest.data)))


def test_random_filters_are_the_jax_draw():
    conf = trpc.RandomCifarConfig(num_filters=7, patch_size=5, seed=3)
    want = np.asarray(jnp.asarray(np.random.default_rng(3).standard_normal((7, 75)),
                                  dtype=jnp.float32))
    np.testing.assert_array_equal(tce.random_filters(conf), want)


def test_random_patch_cifar_augmented_matches_jax():
    train, test = synthetic_cifar(192, seed=5), synthetic_cifar(48, seed=6)
    jtrain, jtest = j_synthetic_cifar(192, seed=5), j_synthetic_cifar(48, seed=6)
    kw = dict(num_filters=24, lam=50.0, whitener_size=3000, num_random_images_augment=2,
              pool_size=8, pool_stride=7)
    jscorer, jev, _ = jce.run_random_patch_cifar_augmented(jtrain, jtest,
                                                          jce.AugmentedCifarConfig(**kw))
    scorer, ev, _ = tce.run_random_patch_cifar_augmented(train, test,
                                                         tce.AugmentedCifarConfig(**kw), CPU)
    assert ev.total_error == jev.total_error and ev.total_error < 0.6
    np.testing.assert_array_equal(ev.confusion_matrix, jev.confusion_matrix)
    # the test crops' scores, the model's input to the vote
    test_aug = tcore.CenterCornerPatcher(24, 24, True).forward(test.data.to_array())
    got = scorer.fit().apply(test_aug).to_array().numpy()
    want = np.asarray(jscorer(JDataset.of(np.asarray(test_aug.numpy()))).get().to_array())
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_augmented_training_crops_match_jax():
    X = synthetic_cifar(10, seed=5).data.to_array()
    conf = tce.AugmentedCifarConfig(num_random_images_augment=3)
    crops, labels = tce.augment_train(X, np.arange(10), conf)
    jpatch = jcore.RandomPatcher(3, 24, 24, seed=conf.seed)
    jflip = jcore.RandomImageTransformer(conf.flip_chance, seed=conf.seed + 1)
    want = jflip.apply_batch(jpatch.apply_batch(JDataset.of(X.numpy()))).to_array()
    np.testing.assert_array_equal(crops.numpy(), np.asarray(want))
    np.testing.assert_array_equal(labels, np.repeat(np.arange(10), 3))
