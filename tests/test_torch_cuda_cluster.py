"""The cluster tier on a CUDA card: a fitted K1 scores chain shipped to two
worker processes as host bytes, loaded onto each worker's card and served
from its CUDA graphs (answers within 1e-5 of the eager apply, both workers
busy, each on ``cuda:0`` in its own context); and the stall model's host
step, served eagerly on the card so that every batch stalls (a captured
``forward`` would stall once, at capture).

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_cluster.py
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from keystone_tpu_torch.cluster import ClusterRouter
from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline

LIMIT = 1e-5
STALL_S = 0.02


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    PipelineEnv.get_or_create().reset()
    return torch.device("cuda")


def _k1_scores(cuda, n_train=700, d=32, k=4, block=256):
    gen = torch.Generator(device=cuda).manual_seed(0)
    train_X = torch.randn(n_train, d, device=cuda, generator=gen)
    W = torch.randn(n_train, k, device=cuda, generator=gen)
    head = KernelBlockLinearMapper(train_X, W, 0.05, block).to_pipeline()
    return FittedPipeline(head.graph, head.source, head.sink, datum_shape=(d,),
                          datum_dtype="float32")


@pytest.mark.cuda
def test_a_shipped_k1_chain_serves_from_two_workers_on_the_card(cuda):
    fitted = _k1_scores(cuda)
    rows = np.random.default_rng(1).standard_normal((256, 32)).astype(np.float32)
    want = fitted.apply(torch.from_numpy(rows).to(cuda)).to_array().cpu().numpy()
    with ClusterRouter(fitted, workers=2, buckets=(1, 8, 32), health_interval_s=3600.0,
                       drain_timeout_s=10.0) as router:
        reports = router.worker_reports
        with ThreadPoolExecutor(max_workers=8) as pool:
            got = np.stack(list(pool.map(lambda r: router.predict(r, timeout=60.0), rows)))
        snap = router.snapshot()
    assert [r["devices"] for r in reports] == [["cuda:0"], ["cuda:0"]]
    assert all(r["compiles"] == 3 for r in reports)
    np.testing.assert_allclose(got, want, atol=LIMIT, rtol=0)
    busy = {k.split("/")[0] for k, row in snap["replicas"].items() if row["batches"]}
    assert busy == {"worker-0", "worker-1"}


@pytest.mark.cuda
def test_b_the_stall_survives_on_the_card(cuda):
    with ClusterRouter(("factory", "keystone_tpu_torch.cluster.demo:build_stall_model",
                        {"d": 32, "stall_s": STALL_S}), workers=1, buckets=(8,),
                       datum_shape=(32,), health_interval_s=3600.0) as router:
        x = np.ones(32, np.float32)
        for _ in range(4):
            router.predict(x, timeout=60.0)
        (snap,) = router.worker_snapshots(timeout=10.0)
    batch = snap["phases"]["serve.batch"]
    assert batch["calls"] >= 4 and batch["seconds"] / batch["calls"] >= STALL_S, batch
