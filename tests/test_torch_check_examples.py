"""Static verdicts against what compiling does, over the example pipeline
families (port of ``tests/check/test_example_agreement.py``): for every
fitted chain of the port,

* the static untraceable set (``CheckReport.untraceable_labels``) equals
  the labels of the nodes without a ``forward``, and the labels
  ``NotTraceableError`` reports; a clean verdict compiles;
* it equals the JAX package's static untraceable set for the same family.

The one difference is pinned: the JAX package's ``HostCallbackServe``
chain (a ``jax.pure_callback`` node) jits there and is untraceable here,
where its counterpart, a node with a host sync, cannot be captured into a
CUDA graph. The JAX chains are the JAX test's own builders; the port's are
built the same way from the port's node classes, fitted at tiny sizes or
given random parameters.
"""

import numpy as np
import pytest
import torch

from tests.check.test_example_agreement import FAMILIES as JAX_TEST_FAMILIES
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import NotTraceableError

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def port_env():
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _fit_mnist():
    from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier
    from keystone_tpu_torch.pipelines import mnist_random_fft as tm

    conf = tm.MnistRandomFFTConfig(num_ffts=2, block_size=512, lam=100.0)
    train, _ = tm.synthetic_mnist(n_train=128, n_test=16)
    labels = ClassLabelIndicators(10).apply_batch(train.labels)
    return (tm.build_featurizer(conf, CPU)
            .and_then(BlockLeastSquaresEstimator(512, 1, 100.0), train.data, labels)
            .and_then(MaxClassifier()).fit())


def _fit_timit():
    from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier
    from keystone_tpu_torch.pipelines.timit import TimitConfig, build_featurizer

    rng = np.random.RandomState(0)
    X = _t(rng.randn(96, 440))
    y = ClassLabelIndicators(5).apply_batch(torch.from_numpy(rng.randint(0, 5, size=96)))
    return (build_featurizer(TimitConfig(num_cosines=1, num_classes=5), CPU)
            .and_then(BlockLeastSquaresEstimator(1024, 1, 1.0), X, y)
            .and_then(MaxClassifier()).fit())


def _fit_linear_pixels():
    from keystone_tpu_torch.nodes.images.core import GrayScaler, ImageVectorizer
    from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier

    rng = np.random.RandomState(0)
    imgs = _t(rng.rand(48, 8, 8, 3))
    y = ClassLabelIndicators(4).apply_batch(torch.from_numpy(rng.randint(0, 4, size=48)))
    return (GrayScaler().and_then(ImageVectorizer())
            .and_then(LinearMapEstimator(1.0), imgs, y).and_then(MaxClassifier()).fit())


def _chain_random_patch_cifar():
    from keystone_tpu_torch.nodes.images.core import (
        Convolver, ImageVectorizer, Pooler, SymmetricRectifier)
    from keystone_tpu_torch.nodes.learning.linear import BlockLinearMapper
    from keystone_tpu_torch.nodes.stats import StandardScalerModel
    from keystone_tpu_torch.nodes.util import MaxClassifier

    rng = np.random.RandomState(0)
    conv = Convolver(_t(rng.randn(4, 6 * 6 * 3)), 16, 16, 3, normalize_patches=True)
    probe = (conv.and_then(SymmetricRectifier(alpha=0.25)).and_then(Pooler(6, 6, None, "sum"))
             .and_then(ImageVectorizer()).to_pipeline().fit())
    rep = probe.check(datum_spec=((16, 16, 3), "float32"), span=False)
    d = int(rep.sink_spec.item_shape[0])
    return (probe.to_pipeline().and_then(StandardScalerModel(torch.zeros(d)))
            .and_then(BlockLinearMapper([_t(rng.randn(d, 4))], d, b=torch.zeros(4)))
            .and_then(MaxClassifier()).fit())


def _chain_voc_sift_fisher():
    from keystone_tpu_torch.nodes.images.core import GrayScaler, PixelScaler
    from keystone_tpu_torch.nodes.images.fisher_vector import FisherVector
    from keystone_tpu_torch.nodes.images.sift import SIFTExtractor
    from keystone_tpu_torch.nodes.learning.gmm import GaussianMixtureModel
    from keystone_tpu_torch.nodes.learning.linear import BlockLinearMapper
    from keystone_tpu_torch.nodes.learning.pca import BatchPCATransformer
    from keystone_tpu_torch.nodes.stats import NormalizeRows, SignedHellingerMapper
    from keystone_tpu_torch.nodes.util import Cacher
    from keystone_tpu_torch.nodes.util.core import MatrixVectorizer

    rng = np.random.RandomState(0)
    k, pdim = 3, 8
    gmm = GaussianMixtureModel(_t(rng.rand(pdim, k)), _t(rng.rand(pdim, k) + 0.5),
                               torch.full((k,), 1.0 / k))
    fv_dim = 2 * pdim * k
    return (PixelScaler().and_then(GrayScaler()).and_then(Cacher())
            .and_then(SIFTExtractor(step=8, num_scales=1))
            .and_then(BatchPCATransformer(_t(rng.randn(128, pdim))))
            .and_then(FisherVector(gmm)).and_then(MatrixVectorizer()).and_then(NormalizeRows())
            .and_then(SignedHellingerMapper()).and_then(NormalizeRows())
            .and_then(BlockLinearMapper([_t(rng.randn(fv_dim, 2))], fv_dim, b=torch.zeros(2)))
            .to_pipeline().fit())


def _chain_imagenet_sift_lcs():
    from keystone_tpu_torch.nodes.images.core import GrayScaler, PixelScaler
    from keystone_tpu_torch.nodes.images.lcs import LCSExtractor
    from keystone_tpu_torch.nodes.images.sift import SIFTExtractor
    from keystone_tpu_torch.nodes.learning.pca import BatchPCATransformer
    from keystone_tpu_torch.nodes.util import VectorCombiner
    from keystone_tpu_torch.nodes.util.core import MatrixVectorizer
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    rng = np.random.RandomState(0)
    sift = (PixelScaler().and_then(GrayScaler()).and_then(SIFTExtractor(step=8, num_scales=1))
            .and_then(BatchPCATransformer(_t(rng.randn(128, 8)))).and_then(MatrixVectorizer()))
    lcs = PixelScaler().and_then(LCSExtractor(4, 4, 2)).and_then(MatrixVectorizer())
    return Pipeline.gather([sift, lcs]).and_then(VectorCombiner()).fit()


def _fit_newsgroups():
    from keystone_tpu_torch.pipelines.newsgroups import (
        NewsgroupsConfig, build_predictor, synthetic_newsgroups)

    train = synthetic_newsgroups(64, num_classes=3, seed=1)
    conf = NewsgroupsConfig(n_grams=1, common_features=300, num_classes=3)
    return build_predictor(train.data, train.labels, conf, CPU).fit()


def _fit_amazon():
    from keystone_tpu_torch.pipelines.amazon_reviews import (
        AmazonReviewsConfig, build_predictor, synthetic_reviews)

    train = synthetic_reviews(64, seed=1)
    conf = AmazonReviewsConfig(n_grams=1, common_features=300, num_iters=2)
    return build_predictor(train.data, train.labels, conf, CPU).fit()


def _fit_stupid_backoff():
    from keystone_tpu_torch.pipelines.stupid_backoff_pipeline import (
        synthetic_corpus, train_language_model)

    return train_language_model(synthetic_corpus(40, seed=0), n=2).to_pipeline().fit()


def _fit_host_sync_serve():
    """The counterpart of the JAX package's stall model: a row-wise chain
    whose first node reads its batch back to the host."""
    from keystone_tpu_torch.nodes.learning.linear import LinearMapper
    from keystone_tpu_torch.workflow.transformer import FunctionNode

    def stall(X):
        return torch.as_tensor(X.cpu().numpy(), device=X.device)

    rng = np.random.RandomState(0)
    return (FunctionNode(batch_fn=stall, label="stall")
            .and_then(LinearMapper(_t(rng.randn(16, 4)))).to_pipeline().fit())


def _jax_fit_timit():
    """The JAX test's TIMIT family with one cosine branch, not two: the
    verdicts are a property of the node set, and the second branch's 4096
    cosines cost the JAX fit seconds."""
    from keystone_tpu.nodes.learning.linear import BlockLeastSquaresEstimator
    from keystone_tpu.nodes.util import ClassLabelIndicators, MaxClassifier
    from keystone_tpu.pipelines.timit import TimitConfig, build_featurizer

    rng = np.random.RandomState(0)
    X = rng.randn(96, 440).astype(np.float32)
    y = ClassLabelIndicators(5).apply_batch(rng.randint(0, 5, size=96).astype(np.int32))
    return (build_featurizer(TimitConfig(num_cosines=1, num_classes=5))
            .and_then(BlockLeastSquaresEstimator(1024, 1, 1.0), X, y)
            .and_then(MaxClassifier()).fit(), (440,), "float32")


JAX_FAMILIES = dict(JAX_TEST_FAMILIES, TimitPipeline=_jax_fit_timit)

FAMILIES = {
    "MnistRandomFFT": _fit_mnist,
    "TimitPipeline": _fit_timit,
    "LinearPixels": _fit_linear_pixels,
    "RandomPatchCifar": _chain_random_patch_cifar,
    "VOCSIFTFisher": _chain_voc_sift_fisher,
    "ImageNetSiftLcsFV": _chain_imagenet_sift_lcs,
    "NewsgroupsPipeline": _fit_newsgroups,
    "AmazonReviewsPipeline": _fit_amazon,
    "StupidBackoffPipeline": _fit_stupid_backoff,
    "HostCallbackServe": _fit_host_sync_serve,
}

#: the pinned divergence: the JAX chain jits, the port's cannot be captured
HOST_SYNC = {"HostCallbackServe": ["stall"]}


def _without_forward(fitted):
    from keystone_tpu_torch.workflow.operators import GatherTransformerOperator

    return [op.label for op in (fitted.graph.get_operator(n) for n in fitted.graph.nodes)
            if not isinstance(op, GatherTransformerOperator) and getattr(op, "forward", None) is None]


def test_the_families_are_the_jax_tests():
    assert set(FAMILIES) == set(JAX_FAMILIES)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_static_verdicts_agree_with_compile_and_with_jax(family):
    fitted = FAMILIES[family]()
    static = fitted.check(span=False).untraceable_labels()
    j_fitted = JAX_FAMILIES[family]()[0]
    j_static = j_fitted.check(span=False).untraceable_labels()
    if family in HOST_SYNC:
        assert j_static == [] and static == HOST_SYNC[family]
    else:
        assert sorted(static) == sorted(_without_forward(fitted))
        assert sorted(static) == sorted(j_static)
    if static:
        with pytest.raises(NotTraceableError) as ei:
            fitted.compile(strict=True)
        assert sorted(ei.value.labels) == sorted(static)
    else:
        assert fitted.compile(strict=True) is not None
