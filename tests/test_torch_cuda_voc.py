"""VOCSIFTFisher's device work on a CUDA card against the same port on the
CPU: dense SIFT (cuDNN smoothing and pooling), GMM EM and the Fisher
vector, the k-means++ seeding's draws staying on the card, and the fused
SIFT group replayed from CUDA graphs in byte-bounded chunks.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_voc.py

Tolerances: SIFT before quantization 1e-5, after it equal but for a share
≤ 1e-3 of entries that differ by 1 (the CPU parity test's); EM from one
initialisation 1e-4 relative; Fisher vectors 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.images import sift
from keystone_tpu_torch.nodes.images.fisher_vector import fisher_vector
from keystone_tpu_torch.nodes.learning import gmm, kmeans
from keystone_tpu_torch.pipelines import voc_sift_fisher as voc
from keystone_tpu_torch.workflow import fusion
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.expressions import DatasetExpression

CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def port_env():
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _gray(size=64, n=6):
    imgs, _ = voc.synthetic_voc(n, size=size, seed=3)
    return torch.from_numpy((imgs[..., :1] / 255.0).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [64, 256])
def test_sift_on_the_card_matches_the_cpu(cuda, size):
    g = _gray(size, n=3)
    for scale in range(4):
        b = 4 + 2 * scale
        sm = sift._smooth(g[..., 0], b / 6.0)
        d_cpu, n_cpu = sift._scale_descriptors(sm, b, 3)
        d_gpu, n_gpu = sift._scale_descriptors(sm.to(cuda), b, 3)
        torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=0, atol=1e-5)
        torch.testing.assert_close(n_gpu.cpu(), n_cpu, rtol=1e-5, atol=1e-5)
    q_cpu = sift.SIFTExtractor().forward(g)
    q_gpu = sift.SIFTExtractor().forward(g.to(cuda)).cpu()
    diff = (q_gpu - q_cpu).abs()
    assert q_gpu.shape[2] == sift.num_descriptors(size, size)
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3


@pytest.mark.cuda
def test_em_and_fisher_vector_on_the_card_match_the_cpu(cuda):
    rng = np.random.default_rng(0)
    X = torch.from_numpy(np.concatenate([rng.standard_normal((3000, 16)) + c
                                         for c in (0.0, 3.0, -3.0)]).astype(np.float32))
    est = gmm.GaussianMixtureModelEstimator(8, max_iterations=10, min_cluster_size=1)
    init = est.initial(X)
    floor = est.var_floor(X)
    m, v, w = init[0], torch.maximum(init[1], floor), init[2]
    cpu = gmm.em_loop(X, m, v, w, floor, max_iterations=10, weight_threshold=1e-4,
                      stop_tolerance=1e-4, min_cluster_size=1)
    dev = gmm.em_loop(X.to(cuda), m.to(cuda), v.to(cuda), w.to(cuda), floor.to(cuda),
                      max_iterations=10, weight_threshold=1e-4, stop_tolerance=1e-4,
                      min_cluster_size=1)
    assert dev[3] == cpu[3]
    for a, b in zip(dev[:3], cpu[:3]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)
    D = torch.from_numpy(rng.standard_normal((4, 16, 500)).astype(np.float32))
    means, variances, weights = cpu[0].T.contiguous(), cpu[1].T.contiguous(), cpu[2]
    want = fisher_vector(D, means, variances, weights, 1e-4)
    got = fisher_vector(D.to(cuda), means.to(cuda), variances.to(cuda), weights.to(cuda), 1e-4)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
def test_kmeans_seeding_on_the_card_draws_data_points(cuda):
    X = torch.randn(20000, 8, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    seeds = kmeans.seed_plus_plus(X, 16, torch.Generator(cuda).manual_seed(2))
    assert seeds.shape == (16, 8)
    assert bool((seeds[:, None, :] == X[None]).all(dim=2).any(dim=1).all())
    assert len({tuple(r) for r in seeds.cpu().tolist()}) == 16


@pytest.mark.cuda
def test_sift_group_replays_in_byte_bounded_chunks(cuda, monkeypatch):
    fitted = voc.sift_featurizer(voc.SIFTFisherConfig()).fit()
    (op,) = fitted.graph.operators.values()
    X = torch.from_numpy(voc.synthetic_voc(11, size=64, seed=4)[0]).to(cuda)
    eager = op.forward(X)
    monkeypatch.setattr(fusion, "CHUNK_BYTES", 4 * op.row_bytes([X]))
    assert op.chunk_rows([X]) == 4
    for _ in range(2):
        got = op.batch_transform([DatasetExpression.now(Dataset(X))]).to_array()
        torch.cuda.synchronize()
        diff = (got - eager).abs()
        assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
    assert len(op.graphs(cuda)) == 2  # chunks of 4 and the tail of 3
