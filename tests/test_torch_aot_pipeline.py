"""AOT compile wiring in the port (``keystone_tpu_torch/compile/aot.py``,
``FittedPipeline.compile(cache=...)``, the serving engine under a
configured cache): every case of the JAX package's
``tests/compile/test_aot_pipeline.py`` but its XLA-cache layering (the port
layers none), each run through both packages on the same inputs with the
same counts, and two chains carried from JAX fits:

* RandomPatchCifarKernel's KRR chain (``cifar_extras.fitted_from_arrays``):
  its exported program names ``keystone.gaussian_kernel_block``; cold,
  warm and uncached scores are bit-equal; they are within 1e-4 of JAX's
  compiled apply, and the predictions equal where JAX is sure;
* the MnistRandomFFT serving chain, served cold then warm by both engines.
"""

import io
import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import keystone_tpu.compile as jcmod
import keystone_tpu_torch.compile as cmod
from keystone_tpu.serving import ServingEngine as JServingEngine
from keystone_tpu.utils import serialization as jserialization
from keystone_tpu_torch.compile import AotDispatcher, ExecutableCache
from keystone_tpu_torch.serving import ServingEngine
from keystone_tpu_torch.utils import serialization
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode
from tests.compile.test_fingerprint import build_toy as j_build_toy
from tests.test_torch_fingerprint import build_toy

DATUM = (8,)
CPU = torch.device("cpu")
WAIT = 60.0
CIFAR_CONF = dict(num_filters=16, lam=1.0, gamma=1e-3, block_size=64, num_epochs=1,
                  cache_kernel=False, whitener_size=2000, pool_size=8, pool_stride=7)


@pytest.fixture(autouse=True)
def _isolate_global_cache():
    """These tests install a process-wide cache in both packages; the rest
    of the suite must inherit neither."""
    PipelineEnv.get_or_create().reset()
    yield
    cmod.reset()
    jcmod.reset()
    PipelineEnv.get_or_create().reset()


def _x(n=4):
    return np.linspace(0.0, 1.0, n * DATUM[0], dtype=np.float32).reshape(n, *DATUM)


def _t(n=4):
    return torch.from_numpy(_x(n))


# ---------------------------------------------------------------------------
# FittedPipeline.compile
# ---------------------------------------------------------------------------


def test_compile_exports_then_loads_with_zero_traces(tmp_path):
    cache = ExecutableCache(str(tmp_path / "port"))
    fitted = build_toy()
    y_cold = fitted.compile(cache=cache)(_t())
    assert fitted.compile_count == 1  # the export's trace, counted
    assert len(cache.entries()) == 1

    clone = serialization.loads(serialization.dumps(fitted))
    y_warm = clone.compile(cache=cache)(_t())
    assert clone.compile_count == 0, "a warm boot pays zero traces"
    legacy = build_toy().compile(cache=None)(_t())
    assert torch.equal(y_cold, y_warm) and torch.equal(y_cold, legacy)

    # the JAX package, the same steps on the same inputs
    jcache = jcmod.ExecutableCache(str(tmp_path / "jax"))
    j_fitted = j_build_toy()
    j_cold = np.asarray(j_fitted.compile(cache=jcache)(_x()))
    j_clone = jserialization.loads(jserialization.dumps(j_fitted))
    j_clone.compile(cache=jcache)(_x())
    assert (j_fitted.compile_count, j_clone.compile_count, len(jcache.entries())) == (1, 0, 1)
    np.testing.assert_array_equal(y_cold.numpy(), j_cold)


def test_corrupted_entry_falls_back_to_live_compile(tmp_path):
    def corrupt(cache):
        (key, size, _mtime), = cache.entries()
        with open(cache.entry_path(key), "r+b") as f:
            f.seek(size // 2)
            f.write(b"ROT!")

    cache = ExecutableCache(str(tmp_path / "port"))
    fitted = build_toy()
    y_ref = fitted.compile(cache=cache)(_t())
    corrupt(cache)
    clone = serialization.loads(serialization.dumps(fitted))
    y = clone.compile(cache=cache)(_t())
    assert clone.compile_count == 1  # a live export paid, not a crash
    assert torch.equal(y, y_ref), "the fallback does not change results"
    assert len(cache.entries()) == 1  # exported again over the corrupt entry

    jcache = jcmod.ExecutableCache(str(tmp_path / "jax"))
    j_fitted = j_build_toy()
    j_fitted.compile(cache=jcache)(_x())
    corrupt(jcache)
    j_clone = jserialization.loads(jserialization.dumps(j_fitted))
    j_clone.compile(cache=jcache)(_x())
    assert (j_clone.compile_count, len(jcache.entries())) == (1, 1)


def test_environment_skew_is_a_miss_then_a_fresh_export(tmp_path):
    """A cache another toolchain wrote (the dispatcher's environment key
    skewed) never loads: the pipeline traces and exports under its own
    key, and the old entry stays."""
    cache = ExecutableCache(str(tmp_path))
    fitted = build_toy()
    fitted.compile(cache=cache)(_t())
    assert len(cache.entries()) == 1

    traces = []
    disp = AotDispatcher(fitted.trace_fn(), fitted.fingerprint(), cache,
                         on_trace=traces.append, device=CPU)
    disp._env = dict(disp._env, torch="0.0.0-skewed")
    y = disp(_t())
    assert traces == [((4, 8), "float32")], "a skewed environment does not load"
    assert disp.traced_count == 1 and disp.loaded_count == 0
    assert torch.equal(y, fitted.compile(cache=None)(_t()))
    assert len(cache.entries()) == 2  # the old entry intact + the new one


def test_unfingerprintable_pipeline_compiles_without_cache(tmp_path):
    def sabotaged(node_cls, fn):
        fitted = node_cls(batch_fn=fn, label="dbl").to_pipeline().fit()
        # a lambda fingerprints by its code; a live object does not
        next(iter(fitted.graph.operators.values())).opaque = object()
        return fitted

    fitted = sabotaged(FunctionNode, lambda X: X * 2.0)
    cache = ExecutableCache(str(tmp_path / "port"))
    y = fitted.compile(cache=cache)(_t())
    assert fitted.compile_count == 1
    assert cache.entries() == []  # the cache was skipped
    assert torch.allclose(y, _t() * 2.0)

    from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode

    j_fitted = sabotaged(JFunctionNode, lambda X: X * 2.0)
    jcache = jcmod.ExecutableCache(str(tmp_path / "jax"))
    j_fitted.compile(cache=jcache)(_x())
    assert (j_fitted.compile_count, jcache.entries()) == (1, [])


def test_an_export_refusal_serves_the_trace_function_and_says_the_verdict_disagreed(
        tmp_path, monkeypatch, caplog):
    """``torch.export`` refusing a chain the checker called exportable: the
    plain trace function serves, counted as one trace, nothing is cached,
    and the disagreement is logged as an error."""
    def refuse(*args, **kwargs):
        raise RuntimeError("unsupported")

    monkeypatch.setattr(torch.export, "export", refuse)
    cache = ExecutableCache(str(tmp_path))
    fitted = build_toy()
    with caplog.at_level(logging.WARNING, logger="keystone_tpu_torch.compile.aot"):
        y = fitted.compile(cache=cache)(_t())
    assert fitted.compile_count == 1 and cache.entries() == []
    assert torch.equal(y, build_toy().compile(cache=None)(_t()))
    assert "STATIC CHECK DISAGREEMENT" in caplog.text


def test_the_trace_shows_misses_and_exports_then_loads(tmp_path):
    from keystone_tpu_torch.obs import tracer as obs_tracer

    cache = ExecutableCache(str(tmp_path))
    tr = obs_tracer.install(obs_tracer.Tracer())
    try:
        fitted = build_toy()
        fitted.compile(cache=cache)(_t())
        serialization.loads(serialization.dumps(fitted)).compile(cache=cache)(_t())
    finally:
        obs_tracer.reset()
    names = [s.name for s in tr.spans() if s.name.startswith("aot.")]
    assert names == ["aot.miss", "aot.export", "aot.load"]
    events = [r["event"] for r in cache.ledger.entries()]
    assert events == ["trace", "store", "export", "hit", "load"]


# ---------------------------------------------------------------------------
# ServingEngine warm boots
# ---------------------------------------------------------------------------


def _serve(engine, rows):
    with engine:
        return [np.asarray(engine.predict(r, timeout=WAIT)) for r in rows]


def _cold_then_warm(compile_mod, engine_cls, make_fitted, root, rows, **engine_kwargs):
    """Two engines booted against one cache directory: their answers and
    their (compiles, aot_loads)."""
    compile_mod.configure(root)
    try:
        out = []
        for _ in range(2):
            engine = engine_cls(make_fitted(), **engine_kwargs)
            preds = _serve(engine, rows)
            c = engine.metrics.snapshot()["counters"]
            out.append((np.stack(preds), (c.get("compiles", 0), c.get("aot_loads", 0))))
        return out
    finally:
        compile_mod.reset()


def test_engine_cold_then_warm_boot_zero_traces(tmp_path):
    got = _cold_then_warm(cmod, ServingEngine, build_toy, str(tmp_path / "port"), _x(6),
                          buckets=(4, 8), datum_shape=DATUM)
    want = _cold_then_warm(jcmod, JServingEngine, j_build_toy, str(tmp_path / "jax"), _x(6),
                           buckets=(4, 8), datum_shape=DATUM)
    assert [c for _, c in got] == [c for _, c in want] == [(2, 0), (0, 2)]
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][0], want[0][0])


def test_engine_without_cache_behaves_exactly_as_before(tmp_path):
    cmod.configure(None)  # explicit: AOT off
    engine = ServingEngine(build_toy(), buckets=(4,), datum_shape=DATUM)
    _serve(engine, _x(3))
    c = engine.metrics.snapshot()["counters"]
    assert c.get("compiles") == 1 and c.get("aot_loads", 0) == 0
    assert engine._compiled.dispatcher is None


# ---------------------------------------------------------------------------
# chains carried from JAX fits
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cifar_fit():
    """The RandomPatchCifarKernel chain fitted by the JAX package and carried
    to the port, ending at the scores."""
    from keystone_tpu.loaders.cifar import synthetic_cifar as j_synthetic_cifar
    from keystone_tpu.nodes.learning.kernel import KernelBlockLinearMapper as JMapper
    from keystone_tpu.nodes.stats.core import StandardScalerModel as JScalerModel
    from keystone_tpu.pipelines import cifar_extras as jce
    from keystone_tpu.pipelines.random_patch_cifar import learn_filters
    from keystone_tpu_torch.loaders.cifar import synthetic_cifar
    from keystone_tpu_torch.pipelines import cifar_extras as tce

    conf_j = jce.KernelCifarConfig(**CIFAR_CONF)
    j_train, j_test = j_synthetic_cifar(96, seed=7), j_synthetic_cifar(20, seed=8)
    j_pipe, _, _, _ = jce.run_random_patch_cifar_kernel(j_train, j_test, conf_j)
    j_filters, j_whitener = learn_filters(j_train.data, conf_j)
    ops = list(j_pipe.fit().graph.operators.values())
    scaler = next(o for o in ops if isinstance(o, JScalerModel))
    mapper = next(o for o in ops if isinstance(o, JMapper))
    j_scores = (jce.Convolver(j_filters, 32, 32, 3, whitener=j_whitener, normalize_patches=True)
                .and_then(jce.SymmetricRectifier(alpha=conf_j.alpha))
                .and_then(jce.Pooler(conf_j.pool_stride, conf_j.pool_size, None, "sum"))
                .and_then(jce.ImageVectorizer()).and_then(scaler).and_then(mapper).fit())
    params = dict(
        filters=np.asarray(j_filters), whitener=np.asarray(j_whitener.whitener),
        means=np.asarray(j_whitener.means), scaler_mean=np.asarray(scaler.mean),
        scaler_std=np.asarray(scaler.std), train_X=np.asarray(mapper.train_X),
        W=np.asarray(mapper.W), gamma=mapper.gamma, block_size=mapper.block_size,
    )
    X = synthetic_cifar(20, seed=8).data.to_array()
    return SimpleNamespace(
        X=X, j_compiled=np.asarray(j_scores.compile(cache=None)(X.numpy())),
        make=lambda: tce.fitted_from_arrays(params, tce.KernelCifarConfig(**CIFAR_CONF), CPU,
                                            classify=False))


def _sure(scores, gap=1e-3):
    top2 = np.sort(np.asarray(scores), axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > gap


def test_the_krr_chain_exports_k1_and_boots_warm_bit_equal(tmp_path, cifar_fit):
    """The exported CIFAR program names K1 (two 64-row blocks of the 96
    training rows: two calls); cold, warm and uncached scores are
    bit-equal; all are within 1e-4 of JAX's compiled apply, with equal
    predictions where JAX is sure."""
    cache = ExecutableCache(str(tmp_path))
    fitted = cifar_fit.make()
    cold = fitted.compile(cache=cache)(cifar_fit.X)
    (key, nbytes, _), = cache.entries()
    program = torch.export.load(io.BytesIO(cache.load(key).payload))
    assert str(program.graph).count("keystone.gaussian_kernel_block") == 2
    assert nbytes > 96 * 512 * 4  # the training block rides in the entry

    warm_fitted = serialization.loads(serialization.dumps(fitted))
    warm = warm_fitted.compile(cache=cache)(cifar_fit.X)
    assert (fitted.compile_count, warm_fitted.compile_count) == (1, 0)
    uncached = cifar_fit.make().compile(cache=None)(cifar_fit.X)
    assert torch.equal(cold, warm) and torch.equal(cold, uncached)
    np.testing.assert_allclose(cold.numpy(), cifar_fit.j_compiled, rtol=0, atol=1e-4)
    sure = _sure(cifar_fit.j_compiled)
    np.testing.assert_array_equal(cold.numpy().argmax(1)[sure],
                                  cifar_fit.j_compiled.argmax(1)[sure])


def test_the_krr_chain_serves_cold_then_warm_as_the_jax_engine(tmp_path, cifar_fit):
    rows = cifar_fit.X.numpy()[:6]
    got = _cold_then_warm(cmod, ServingEngine, cifar_fit.make, str(tmp_path), rows,
                          buckets=(1, 8), datum_shape=(32, 32, 3))
    assert [c for _, c in got] == [(2, 0), (0, 2)]
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_allclose(got[0][0], cifar_fit.j_compiled[:6], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def mnist_fit():
    """MnistRandomFFT fitted by the JAX package and carried to the port."""
    from keystone_tpu.nodes.learning.linear import BlockLinearMapper as JBlockMapper
    from keystone_tpu.pipelines import mnist_random_fft as jm
    from keystone_tpu_torch.pipelines import mnist_random_fft as tm

    conf = dict(num_ffts=2, block_size=512, lam=10.0)
    j_train, j_test = jm.synthetic_mnist(n_train=1024, n_test=24, seed=7)
    j_pipe, _, _, _ = jm.run(j_train, j_test, jm.MnistRandomFFTConfig(**conf))
    j_fitted = j_pipe.fit()
    mapper = next(o for o in j_fitted.graph.operators.values() if isinstance(o, JBlockMapper))
    signs = np.stack([np.array(jm.RandomSignNode.create(784, seed=i).signs)
                      for i in range(conf["num_ffts"])])
    X = np.array(j_test.data.to_array())
    feats = jm.build_featurizer(jm.MnistRandomFFTConfig(**conf))(X).get().to_array()
    params = dict(signs=signs, W=np.concatenate([np.asarray(w) for w in mapper.xs]),
                  b=np.asarray(mapper.b),
                  feature_means=np.concatenate([np.asarray(m) for m in mapper.feature_means]))
    return SimpleNamespace(j_fitted=j_fitted, X=X,
                           j_scores=np.asarray(mapper.trace_batch(feats)),
                           make=lambda: tm.fitted_from_arrays(params, CPU))


def test_the_mnist_chain_serves_cold_then_warm_as_the_jax_engine(tmp_path, mnist_fit):
    """Both engines boot cold then warm against their own cache directory:
    the same counts (two exports, then two loads), and predictions equal
    where JAX is sure."""
    rows = mnist_fit.X
    got = _cold_then_warm(cmod, ServingEngine, mnist_fit.make, str(tmp_path / "port"), rows,
                          buckets=(8, 32), datum_shape=(784,))
    want = _cold_then_warm(jcmod, JServingEngine, lambda: mnist_fit.j_fitted,
                           str(tmp_path / "jax"), rows, buckets=(8, 32), datum_shape=(784,))
    assert [c for _, c in got] == [c for _, c in want] == [(2, 0), (0, 2)]
    np.testing.assert_array_equal(got[0][0], got[1][0])
    sure = _sure(mnist_fit.j_scores)
    np.testing.assert_array_equal(got[0][0][sure], want[0][0][sure])
    assert os.listdir(os.path.join(str(tmp_path / "port"), "manifest"))
