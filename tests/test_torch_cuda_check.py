"""The static checker on a CUDA card: a check of chains whose parameters
live on the card launches no kernel (K1's abstract form included),
allocates no device memory and gives the specs, and the check at fit entry
of a card pipeline raises before any kernel when a composition is wrong.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_check.py
"""

import pytest
import torch

from keystone_tpu_torch import check
from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.nodes.stats import RandomSignNode
from keystone_tpu_torch.nodes.util import MaxClassifier
from keystone_tpu_torch.ops import gaussian_kernel as gk
from keystone_tpu_torch.pipelines import mnist_random_fft as tm
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    PipelineEnv.get_or_create().reset()
    return torch.device("cuda")


def _k1_fitted(cuda, n_train=12000, d=800, k=10, block=5000):
    gen = torch.Generator(device=cuda).manual_seed(0)
    train_X = torch.randn(n_train, d, device=cuda, generator=gen)
    W = torch.randn(n_train, k, device=cuda, generator=gen)
    head = KernelBlockLinearMapper(train_X, W, 2e-4, block).to_pipeline() \
        .and_then(MaxClassifier())
    return FittedPipeline(head.graph, head.source, head.sink, datum_shape=(d,),
                          datum_dtype="float32")


def _kernels_in(fn):
    """(CUDA kernels the profiler saw, device bytes allocated, K1 launches
    counted, K1 launches recorded for captures) around ``fn()``. Copies are
    not kernels: composing a pipeline digests a new parameter for CSE, a
    copy to the host. The first fake evaluation on the card in a process
    is run before, untimed: torch's one-time set-up allocates a block then,
    which no later check repeats (``chip_smoke.py``'s ``check_apps``)."""
    warm = KernelBlockLinearMapper(torch.ones(4, 2, device="cuda"), torch.ones(4, 1, device="cuda"),
                                   1.0, 4).to_pipeline()
    check.check_graph(warm.graph, source=warm.source, datum_spec=((2,), "float32"))
    torch.cuda.synchronize()
    before = (torch.cuda.memory_allocated(), gk.gaussian_kernel_block.launches,
              gk.captured_launches())
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    return out, dict(kernels=len(kernels),
                     allocated=torch.cuda.max_memory_allocated() - before[0],
                     k1=gk.gaussian_kernel_block.launches - before[1],
                     k1_captured=gk.captured_launches() - before[2])


@pytest.mark.cuda
def test_k1_abstract_form_on_card_tensors_launches_nothing(cuda):
    fitted = _k1_fitted(cuda)
    report, seen = _kernels_in(lambda: fitted.check(span=False))
    assert seen == dict(kernels=0, allocated=0, k1=0, k1_captured=0)
    mapper = next(n for n in fitted.graph.nodes
                  if isinstance(fitted.graph.get_operator(n), KernelBlockLinearMapper))
    assert report.specs[mapper].item == ((10,), "float32")
    assert report.untraceable_labels() == []


@pytest.mark.cuda
def test_check_of_the_mnist_chain_on_the_card_runs_nothing(cuda):
    train, _ = tm.synthetic_mnist_device(n_train=1024, n_test=64, device=cuda)
    from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators

    conf = tm.MnistRandomFFTConfig(num_ffts=4, block_size=512, lam=100.0)
    labels = ClassLabelIndicators(tm.NUM_CLASSES).apply_batch(train.labels)
    pipe = (tm.build_featurizer(conf, cuda)
            .and_then(BlockLeastSquaresEstimator(512, 1, 100.0), train.data, labels)
            .and_then(MaxClassifier()))
    report, seen = _kernels_in(lambda: pipe.check(span=False))
    assert seen["kernels"] == 0 and seen["allocated"] == 0
    assert check.spec_from_item(((), "int64")).item == report.sink_spec.item


@pytest.mark.cuda
def test_a_mismatched_composition_on_card_data_raises_before_any_kernel(cuda):
    X = torch.randn(256, 100, device=cuda)
    Y = torch.randn(256, 4, device=cuda)
    signs = RandomSignNode.create(784, seed=0, device=cuda)
    err, seen = _kernels_in(lambda: pytest.raises(
        check.PipelineCheckError, signs.and_then, LinearMapEstimator(lam=1.0), X, Y))
    assert err.value.label == "RandomSignNode"
    assert seen["kernels"] == 0 and seen["k1"] == 0


@pytest.mark.cuda
def test_ops_on_card_parameters_alone_run_nothing(cuda):
    """FisherVector's forward computes on its mixture's parameters alone
    (``means * means``); a plain fake mode would run those ops on the card.
    A check of the chain runs no kernel and allocates nothing."""
    from keystone_tpu_torch.nodes.images.fisher_vector import FisherVector
    from keystone_tpu_torch.nodes.learning.gmm import GaussianMixtureModel

    gen = torch.Generator(device=cuda).manual_seed(1)
    d, k = 64, 16
    gmm = GaussianMixtureModel(torch.randn(d, k, device=cuda, generator=gen),
                               torch.rand(d, k, device=cuda, generator=gen) + 0.5,
                               torch.full((k,), 1.0 / k, device=cuda))
    pipe = FisherVector(gmm).to_pipeline()
    report, seen = _kernels_in(lambda: check.check_graph(
        pipe.graph, source=pipe.source, datum_spec=((d, 500), "float32")))
    assert seen == dict(kernels=0, allocated=0, k1=0, k1_captured=0)
    assert report.sink_spec.item == ((d, 2 * k), "float32")
