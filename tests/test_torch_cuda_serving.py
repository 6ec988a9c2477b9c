"""The serving engine on a CUDA card: one CUDA-graph capture per bucket,
K1's launches counted per replay inside the graphs, answers equal to the
eager apply, no capture under traffic, and a same-contract swap.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_serving.py
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from keystone_tpu_torch.check import ContractMismatchError
from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
from keystone_tpu_torch.ops import gaussian_kernel as gk
from keystone_tpu_torch.serving import ServingEngine
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline

WAIT = 60.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    PipelineEnv.get_or_create().reset()
    return torch.device("cuda")


@pytest.fixture
def engines():
    made = []

    def make(fitted, **kwargs):
        e = ServingEngine(fitted, **kwargs)
        made.append(e)
        return e

    try:
        yield make
    finally:
        for e in made:
            e.shutdown(drain=False)


def _k1_scores(cuda, n_train=700, d=32, k=4, block=256, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    train_X = torch.randn(n_train, d, device=cuda, generator=gen)
    W = torch.randn(n_train, k, device=cuda, generator=gen)
    head = KernelBlockLinearMapper(train_X, W, 0.05, block).to_pipeline()
    return FittedPipeline(head.graph, head.source, head.sink, datum_shape=(d,),
                          datum_dtype="float32")


@pytest.mark.cuda
def test_engine_captures_once_a_bucket_and_k1_runs_inside_the_replays(cuda, engines):
    fitted = _k1_scores(cuda)  # 700 rows in blocks of 256: 3 launches a batch
    buckets = (1, 8, 32)
    rows = np.random.default_rng(1).standard_normal((100, 32)).astype(np.float32)
    want = fitted.apply(torch.from_numpy(rows).to(cuda)).to_array().cpu().numpy()
    engine = engines(fitted, buckets=buckets).start()
    assert engine.metrics.count("compiles") == len(buckets)
    start = gk.gaussian_kernel_block.launches
    with ThreadPoolExecutor(max_workers=8) as pool:
        got = np.stack(list(pool.map(lambda r: engine.predict(r, timeout=WAIT), rows)))
    batches = engine.metrics.count("batches")
    assert gk.gaussian_kernel_block.launches - start == 3 * batches
    assert engine.metrics.count("compiles") == len(buckets)  # none under traffic
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert sorted(s[0][0] for s in engine.compiled_signatures) == list(buckets)
    assert fitted.compile_count == 0


@pytest.mark.cuda
def test_a_same_contract_swap_recaptures_and_another_width_is_refused(cuda, engines):
    engine = engines(_k1_scores(cuda), buckets=(4, 16)).start()
    replacement = _k1_scores(cuda, seed=5)
    assert engine.swap(replacement) == 2
    assert engine.metrics.count("compiles") == 4
    row = np.ones(32, np.float32)
    want = replacement.apply(torch.from_numpy(row[None]).to(cuda)).to_array()[0].cpu().numpy()
    np.testing.assert_allclose(engine.predict(row, timeout=WAIT), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ContractMismatchError, match="does not match"):
        engine.swap(_k1_scores(cuda, d=16))
