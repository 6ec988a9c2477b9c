"""The AOT executable cache on a CUDA card: a KRR chain's exported program
launches K1 (the counter moves by 10 a replay, one launch per 500-row
training block), a warm boot calls the chain's trace function zero times
and captures each bucket again over the loaded program, and warm scores
are bit-equal to cold ones.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_aot.py
"""

import io

import numpy as np
import pytest
import torch

import keystone_tpu_torch.compile as cmod
from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
from keystone_tpu_torch.ops import gaussian_kernel as gk
from keystone_tpu_torch.serving import ServingEngine
from keystone_tpu_torch.utils import serialization
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline

WAIT = 60.0
BUCKETS = (1, 8, 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    PipelineEnv.get_or_create().reset()
    yield torch.device("cuda")
    cmod.reset()


def _k1_scores(cuda, n_train=5000, d=32, k=4, block=500, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    train_X = torch.randn(n_train, d, device=cuda, generator=gen)
    W = torch.randn(n_train, k, device=cuda, generator=gen)
    head = KernelBlockLinearMapper(train_X, W, 0.05, block).to_pipeline()
    return FittedPipeline(head.graph, head.source, head.sink, datum_shape=(32,),
                          datum_dtype="float32")


def _serve(engine, rows):
    with engine:
        return np.stack([engine.predict(r, timeout=WAIT) for r in rows])


@pytest.mark.cuda
def test_a_warm_boot_loads_k1_programs_and_answers_bit_equal(cuda, tmp_path, monkeypatch):
    cmod.configure(str(tmp_path))
    rows = np.random.default_rng(1).standard_normal((40, 32)).astype(np.float32)
    fitted = _k1_scores(cuda)
    cold = ServingEngine(fitted, buckets=BUCKETS)
    cold_scores = _serve(cold, rows)
    assert cold.metrics.count("compiles") == len(BUCKETS)
    assert cold.metrics.count("aot_loads") == 0 and cold._compiled.captures == len(BUCKETS)
    cache = cmod.get_cache()
    assert len(cache.entries()) == len(BUCKETS)
    for key, _, _ in cache.entries():
        program = torch.export.load(io.BytesIO(cache.load(key).payload))
        assert str(program.graph).count("keystone.gaussian_kernel_block") == 10

    calls = []
    build = FittedPipeline._build_trace_fn

    def counted(self):
        fn = build(self)

        def traced(x):
            calls.append(tuple(x.shape))
            return fn(x)

        return traced

    monkeypatch.setattr(FittedPipeline, "_build_trace_fn", counted)
    warm = ServingEngine(serialization.loads(serialization.dumps(fitted)), buckets=BUCKETS)
    with warm:
        before = gk.gaussian_kernel_block.launches
        one = warm.predict(rows[0], timeout=WAIT)
        assert gk.gaussian_kernel_block.launches - before == 10  # one replay
        warm_scores = np.stack([one] + [warm.predict(r, timeout=WAIT) for r in rows[1:]])
    assert warm.metrics.count("compiles") == 0
    assert warm.metrics.count("aot_loads") == len(BUCKETS)
    assert warm._compiled.captures == len(BUCKETS)
    assert calls == [], "a warm boot never calls the trace function"
    assert warm._compiled.device == cold._compiled.device
    np.testing.assert_array_equal(warm_scores, cold_scores)
    eager = fitted.apply(torch.from_numpy(rows).to(cuda)).to_array().cpu().numpy()
    np.testing.assert_allclose(cold_scores, eager, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_compile_with_a_cache_replays_k1_inside_the_loaded_program(cuda, tmp_path):
    cache = cmod.ExecutableCache(str(tmp_path))
    x = torch.randn(16, 32, device=cuda)
    fitted = _k1_scores(cuda)
    cold = fitted.compile(cache=cache)(x)
    clone = serialization.loads(serialization.dumps(fitted))
    compiled = clone.compile(cache=cache)
    compiled(x)  # the capture
    before = gk.gaussian_kernel_block.launches
    warm = compiled(x)
    assert gk.gaussian_kernel_block.launches - before == 10
    assert (fitted.compile_count, clone.compile_count) == (1, 0)
    assert torch.equal(cold, warm)
