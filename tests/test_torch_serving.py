"""The port's serving engine on the CPU: the cases of the JAX package's
``tests/serving/test_batching.py``, ``test_engine.py``, ``test_metrics.py``,
``test_metrics_merge.py``, ``test_metrics_costs.py``, ``test_recompile.py``
and ``test_demo.py`` that need no fleet, run on
``keystone_tpu_torch.serving``; and the engine's answers held against the
JAX package's engine serving the same weights, carried across by
``fitted_from_arrays`` (MnistRandomFFT and the RandomPatchCifarKernel KRR
chain).

On the CPU a compiled chain runs eagerly, one counted "compile" per new
input signature, so ``compiles`` equals the bucket count as on the card,
where each is a CUDA-graph capture (``test_torch_cuda_serving.py``).

Every engine is built in a fixture that shuts it down in a ``finally``,
every ``result`` and ``predict`` has a timeout, and no test sleeps longer
than the case needs.
"""

import logging
import pickle
import queue as _queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from keystone_tpu.serving import ServingEngine as JServingEngine
from keystone_tpu_torch.serving import (
    BucketPolicy,
    DeadlineExceeded,
    EngineClosed,
    EngineStopped,
    InvalidRequest,
    MetricsRegistry,
    QueueFull,
    ServingEngine,
)
from keystone_tpu_torch.serving.engine import _Request
from keystone_tpu_torch.serving.metrics import GAUGE_MERGE_MODES
from keystone_tpu_torch.check import ContractMismatchError
from keystone_tpu_torch.utils import timing
from keystone_tpu_torch.utils.obs import every
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, NotTraceableError
from keystone_tpu_torch.workflow.transformer import FunctionNode

CPU = torch.device("cpu")
WAIT = 30.0  # seconds any one answer may take here


@pytest.fixture(autouse=True)
def port_env():
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


@pytest.fixture
def engines():
    """Builds engines and shuts every one down, whatever the test did."""
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


def _double(X):
    return X * 2.0


def _inc(X):
    return X + 1.0


def _toy_fitted():
    """A cheap row-wise chain: doubled, then summed per row."""
    return (FunctionNode(batch_fn=_double, label="double")
            >> FunctionNode(batch_fn=lambda X: X.sum(dim=1), label="rowsum")).fit()


def _coupled_fitted():
    fitted = FunctionNode(batch_fn=lambda X: X - X.mean(dim=0),
                          label="batchmean").to_pipeline().fit()
    for node in fitted.graph.nodes:
        fitted.graph.get_operator(node).batch_coupled = True
    return fitted


def _scaled(scale):
    return FunctionNode(batch_fn=lambda X, s=scale: X * s, label="scale").to_pipeline().fit()


# ---------------------------------------------------------------------------
# BucketPolicy (tests/serving/test_batching.py)
# ---------------------------------------------------------------------------


def test_bucket_for_picks_smallest_fitting():
    p = BucketPolicy(batch_sizes=(32, 1, 8))
    assert p.batch_sizes == (1, 8, 32)
    assert [p.bucket_for(n) for n in (1, 2, 8, 9)] == [1, 8, 8, 32]
    assert p.max_size == 32
    for n in (33, 0):
        with pytest.raises(ValueError):
            p.bucket_for(n)


def test_invalid_bucket_sizes_rejected():
    for sizes in ((), (0, 4)):
        with pytest.raises(ValueError):
            BucketPolicy(batch_sizes=sizes)


def test_pad_repeats_first_row():
    p = BucketPolicy(batch_sizes=(4,), datum_shape=(2,))
    x = np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32)
    padded = p.pad(x, 4)
    assert padded.shape == (4, 2)
    np.testing.assert_array_equal(padded[2], x[0])
    np.testing.assert_array_equal(padded[3], x[0])
    assert p.pad(padded, 4) is padded
    with pytest.raises(ValueError):
        p.pad(padded, 2)


def test_validate_enforces_configured_shape():
    p = BucketPolicy(datum_shape=(3,))
    out = p.validate([1, 2, 3])
    assert out.dtype == np.float32 and out.shape == (3,)
    for bad in ([1, 2], "not a number"):
        with pytest.raises(InvalidRequest):
            p.validate(bad)


def test_validate_locks_shape_from_first_datum():
    p = BucketPolicy()
    assert p.datum_shape is None
    p.validate(np.zeros((5,)))
    assert p.datum_shape == (5,)
    with pytest.raises(InvalidRequest):
        p.validate(np.zeros((6,)))


def test_warmup_inputs_cover_every_bucket():
    p = BucketPolicy(batch_sizes=(2, 4), datum_shape=(3,), dtype=np.float32)
    inputs = list(p.warmup_inputs())
    assert [x.shape for x in inputs] == [(2, 3), (4, 3)]
    assert all(x.dtype == np.float32 for x in inputs)
    with pytest.raises(ValueError):
        list(BucketPolicy().warmup_inputs())


# ---------------------------------------------------------------------------
# ServingEngine lifecycle and admission (tests/serving/test_engine.py)
# ---------------------------------------------------------------------------


def test_predict_before_start_raises_instead_of_hanging(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,))
    with pytest.raises(RuntimeError):
        engine.predict(np.ones(2))
    fut = engine.submit(np.ones(2))  # buffered; resolves once started
    engine.start()
    assert abs(fut.result(timeout=WAIT) - 4.0) < 1e-6


def test_batch_coupled_chain_rejected_at_construction(engines):
    with pytest.raises(ContractMismatchError, match="batch-coupled") as ei:
        engines(_coupled_fitted(), datum_shape=(2,))
    assert ei.value.label == "batchmean"


def test_engine_compile_is_private_to_the_engine(engines):
    fitted = _toy_fitted()
    engine = engines(fitted, buckets=(4,), datum_shape=(2,)).start()
    assert engine.metrics.count("compiles") == 1
    fitted.compile()(torch.zeros(7, 2))
    assert fitted.compile_count == 1
    assert engine.metrics.count("compiles") == 1
    assert abs(engine.predict(np.ones(2), timeout=WAIT) - 4.0) < 1e-6
    assert engine.metrics.count("compiles") == 1


def test_concurrent_shutdown_is_safe(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,)).start()
    errors = []

    def close():
        try:
            engine.shutdown(drain=True)
        except Exception as e:  # pragma: no cover - the regression itself
            errors.append(e)

    threads = [threading.Thread(target=close) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert errors == [] and not any(t.is_alive() for t in threads)


def test_unbounded_queue_config_rejected(engines):
    with pytest.raises(ValueError, match="max_queue"):
        engines(_toy_fitted(), datum_shape=(2,), max_queue=0)


def test_worker_survives_failing_gauge(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,), log_interval_s=0.0)

    def bad_gauge():
        raise RuntimeError("gauge exploded")

    engine.metrics.set_gauge("bad", bad_gauge)
    engine.start()
    for _ in range(2):
        assert abs(engine.predict(np.ones(2), timeout=WAIT) - 4.0) < 1e-6


def test_construction_fails_fast_on_untraceable_pipeline(engines):
    fitted = FunctionNode(item_fn=lambda x: x, label="host_only").to_pipeline().fit()
    with pytest.raises(NotTraceableError) as exc:
        engines(fitted, datum_shape=(2,))
    assert "host_only" in exc.value.labels


def test_construction_refuses_a_host_sync(engines):
    """The port's divergence: a host sync cannot be captured, so a chain
    with one is refused at construction (the JAX engine jits it)."""
    fitted = FunctionNode(batch_fn=lambda X: X * X.sum().item(), label="sync") \
        .to_pipeline().fit()
    with pytest.raises(NotTraceableError) as exc:
        engines(fitted, datum_shape=(2,))
    assert exc.value.labels == ["sync"]


def test_queue_full_rejects_instead_of_growing(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,), max_queue=4)
    futs = [engine.submit(np.ones(2)) for _ in range(4)]
    with pytest.raises(QueueFull):
        engine.submit(np.ones(2))
    assert engine.metrics.count("rejected") == 1
    engine.start()
    assert all(abs(f.result(timeout=WAIT) - 4.0) < 1e-6 for f in futs)
    engine.shutdown()
    assert engine.metrics.count("completed") == 4


def test_submit_after_drain_raises_engine_closed(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,)).start()
    engine.shutdown(drain=True)
    with pytest.raises(EngineClosed):
        engine.submit(np.ones(2))


def test_submit_under_shutdown_is_typed_engine_stopped(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,)).start()
    engine.shutdown(drain=True)
    with pytest.raises(EngineStopped):
        engine.submit(np.ones(2))
    engine2 = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,))
    fut = engine2.submit(np.ones(2))
    engine2.shutdown()
    with pytest.raises(EngineStopped):
        fut.result(timeout=5)


def test_shutdown_without_start_rejects_queued_requests(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,))
    fut = engine.submit(np.ones(2))
    engine.shutdown()
    with pytest.raises(EngineClosed):
        fut.result(timeout=5)


def test_request_landing_during_shutdown_is_not_stranded(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,)).start()
    engine.shutdown(drain=True)
    late = _Request(datum=np.ones(2), deadline=None, enqueued=time.monotonic())
    try:
        engine._queue.put_nowait(late)
    except _queue.Full:
        pytest.skip("queue unexpectedly full")
    engine.shutdown()
    with pytest.raises(EngineClosed):
        late.future.result(timeout=5)


def test_abortive_shutdown_fails_queued_requests(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,))
    futs = [engine.submit(np.ones(2)) for _ in range(3)]
    engine.start()
    engine.shutdown(drain=False)
    for f in futs:
        try:
            f.result(timeout=WAIT)
        except EngineClosed:
            pass
        assert f.done()


def test_expired_deadline_surfaces_typed_error_without_stalling(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,))
    doomed = engine.submit(np.ones(2), timeout=0.001)
    time.sleep(0.01)
    engine.start()
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=WAIT)
    assert abs(engine.predict(np.ones(2), timeout=WAIT) - 4.0) < 1e-6
    engine.shutdown()
    assert engine.metrics.count("expired") == 1


def test_invalid_datum_isolated_from_rest_of_batch(engines):
    engine = engines(_toy_fitted(), buckets=(8,), datum_shape=(2,))
    good = [engine.submit(np.full(2, float(i))) for i in range(3)]
    bad = engine.submit(np.ones(5))
    engine.start()
    with pytest.raises(InvalidRequest):
        bad.result(timeout=WAIT)
    for i, f in enumerate(good):
        assert abs(f.result(timeout=WAIT) - 4.0 * i) < 1e-6
    engine.shutdown()
    assert engine.metrics.count("invalid") == 1
    assert engine.metrics.count("completed") == 3


def test_warm_up_raises_when_explicitly_requested_but_impossible(engines):
    engine = engines(_toy_fitted(), buckets=(4,))
    for call in (engine.warm_up, lambda: engine.start(warmup=True)):
        with pytest.raises(ValueError, match="warm-up requested but impossible"):
            call()
    engine.start()
    assert abs(engine.predict(np.ones(2), timeout=WAIT) - 4.0) < 1e-6


def test_predict_bounds_its_wait_past_the_deadline(engines, monkeypatch):
    """A request that far past its deadline has a stuck worker behind it:
    predict raises instead of waiting forever."""
    from keystone_tpu_torch.serving import engine as engine_mod

    monkeypatch.setattr(engine_mod, "PREDICT_GRACE_S", 0.05)
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,)).start()
    engine._stop = True  # the worker exits at its next poll: nothing answers
    engine._thread.join(timeout=WAIT)
    with pytest.raises(TimeoutError):
        engine.predict(np.ones(2), timeout=0.01)


def test_a_fault_at_the_replica_batch_seam_fails_its_batch_and_the_worker_serves_on(engines):
    """The ``replica.batch`` fault point: the first batch's injected
    transient fault is its requests' answer (the single engine has no peer
    to retry on), and the next batch is served."""
    from keystone_tpu_torch.faults import FaultInjected, plan

    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,)).start()
    plan.install(plan.parse_plan("replica.batch=transient@0"))
    try:
        with pytest.raises(FaultInjected):
            engine.predict(np.ones(2), timeout=WAIT)
        assert abs(engine.predict(np.ones(2), timeout=WAIT) - 4.0) < 1e-6
    finally:
        plan.clear()
    assert engine.metrics.count("batch_transient") == 1
    assert engine.metrics.count("batch_errors") == 1


def test_a_fatal_fault_at_the_replica_batch_seam_is_answered_as_jax_answers(engines):
    """``replica.batch=fatal@0`` through both engines on the same chain: the
    fault is not transient, so the seam re-raises it and the loop's
    backstop answers the batch ``EngineStopped("internal batch failure")``
    with ``batch_errors`` 0; the next batch is served in both."""
    from keystone_tpu import faults as jfaults
    from keystone_tpu.serving.errors import EngineStopped as JEngineStopped
    from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
    from keystone_tpu_torch.faults import plan

    def answers(engine, install, clear, stopped):
        install()
        try:
            with pytest.raises(stopped) as err:
                engine.predict(np.ones(2, np.float32), timeout=WAIT)
            served = float(np.asarray(engine.predict(np.ones(2, np.float32), timeout=WAIT)))
        finally:
            clear()
        return (str(err.value), engine.metrics.count("batch_errors"),
                engine.metrics.count("batch_transient"), served)

    j_fitted = (JFunctionNode(batch_fn=_double, label="double")
                >> JFunctionNode(batch_fn=lambda X: X.sum(axis=1), label="rowsum")).fit()
    j_engine = JServingEngine(j_fitted, buckets=(4,), datum_shape=(2,))
    try:
        j_engine.start()
        want = answers(j_engine,
                       lambda: jfaults.install(jfaults.parse_plan("replica.batch=fatal@0")),
                       jfaults.clear, JEngineStopped)
    finally:
        j_engine.shutdown(drain=False)
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,)).start()
    got = answers(engine, lambda: plan.install(plan.parse_plan("replica.batch=fatal@0")),
                  plan.clear, EngineStopped)
    assert got == want == ("internal batch failure", 0, 0, 4.0)


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------


def test_swap_serves_new_model_with_no_dropped_requests(engines):
    engine = engines(_scaled(2.0), buckets=(4,), datum_shape=(2,), max_wait_ms=1.0).start()
    stop = threading.Event()
    results = []

    def hammer():
        while not stop.is_set():
            results.append(float(np.asarray(engine.predict(np.ones(2), timeout=WAIT)).ravel()[0]))

    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = [pool.submit(hammer) for _ in range(4)]
        time.sleep(0.1)
        assert engine.swap(_scaled(3.0)) == 1
        post = float(np.asarray(engine.predict(np.ones(2), timeout=WAIT)).ravel()[0])
        time.sleep(0.1)
        stop.set()
        for f in futs:
            f.result(timeout=WAIT)
    assert post == 3.0
    engine.shutdown()
    c = engine.metrics.snapshot()["counters"]
    assert c["completed"] == c["submitted"]
    assert c.get("rejected", 0) == 0 and c.get("failed", 0) == 0
    assert c["swaps"] == 1 and c["compiles"] == 2
    assert set(results) <= {2.0, 3.0} and {2.0, 3.0} <= set(results)


def test_swap_rejects_mismatched_datum_shape(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,))
    wrong = FunctionNode(batch_fn=_double, label="id3").to_pipeline().fit()
    wrong.datum_shape = (3,)
    with pytest.raises(ContractMismatchError, match="does not match") as ei:
        engine.swap(wrong)
    assert ei.value.label == "source"


def test_swap_rejects_batch_coupled_and_closed_engine(engines):
    engine = engines(_toy_fitted(), buckets=(4,), datum_shape=(2,))
    with pytest.raises(ValueError, match="batch-coupled"):
        engine.swap(_coupled_fitted())
    engine.start()
    engine.shutdown()
    with pytest.raises(EngineClosed):
        engine.swap(_scaled(3.0))


# ---------------------------------------------------------------------------
# concurrent traffic over a fitted MnistRandomFFT pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_mnist():
    """The port's own fit, whose datum contract the engine reads."""
    from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier
    from keystone_tpu_torch.pipelines import mnist_random_fft as tm

    PipelineEnv.get_or_create().reset()
    conf = tm.MnistRandomFFTConfig(num_ffts=2, block_size=512, lam=100.0)
    train, test = tm.synthetic_mnist(n_train=1024, n_test=64)
    labels = ClassLabelIndicators(tm.NUM_CLASSES).apply_batch(train.labels)
    fitted = (tm.build_featurizer(conf, CPU)
              .and_then(BlockLeastSquaresEstimator(conf.block_size, 1, conf.lam), train.data,
                        labels)
              .and_then(MaxClassifier()).fit())
    return fitted, test.data.to_array().numpy()


def test_64_concurrent_requests_one_compile_per_bucket(engines, port_mnist):
    fitted, data = port_mnist
    buckets = (8, 32)
    before = timing.snapshot(prefix="serve.").get("serve.batch", {}).get("calls", 0)
    engine = engines(fitted, buckets=buckets, datum_shape=data.shape[1:]).start()
    assert engine.metrics.count("compiles") == len(buckets)
    with ThreadPoolExecutor(max_workers=16) as pool:
        preds = list(pool.map(lambda row: engine.predict(row, timeout=WAIT), data))
    assert engine.metrics.count("compiles") == len(buckets)
    engine.shutdown()
    snap = engine.metrics.snapshot()
    expected = fitted.apply(torch.from_numpy(data)).to_array().numpy()
    np.testing.assert_array_equal(np.asarray(preds).ravel(), expected.ravel())
    for i in range(0, 64, 16):
        assert int(preds[i]) == int(fitted.apply_datum(torch.from_numpy(data[i])))
    c = snap["counters"]
    assert c["submitted"] == c["completed"] == 64
    assert c.get("rejected", 0) == 0 and c.get("expired", 0) == 0
    assert snap["gauges"]["queue_depth"] == 0
    assert snap["batch_occupancy"]["items"] == 64 and snap["batch_occupancy"]["capacity"] >= 64
    assert snap["latency"]["count"] == 64
    assert snap["latency"]["p50"] <= snap["latency"]["p99"]
    assert c["batches"] >= 2
    assert snap["phases"]["serve.batch"]["calls"] - before == c["batches"]
    assert {sig[0][0] for sig in engine.compiled_signatures} == set(buckets)
    assert fitted.compile_count == 0


def test_datum_shape_recorded_at_fit_flows_into_the_engine(engines, port_mnist):
    fitted, data = port_mnist
    assert fitted.datum_shape == (784,) and fitted.datum_dtype == "float32"
    engine = engines(fitted, buckets=(8,))
    assert engine.policy.datum_shape == (784,)
    assert engine.warm_up() == 1
    engine.start(warmup=False)
    preds = [engine.predict(row, timeout=WAIT) for row in data[:4]]
    expected = fitted.apply(torch.from_numpy(data[:4])).to_array().numpy()
    np.testing.assert_array_equal(np.asarray(preds).ravel(), expected.ravel())


def test_datum_hint_survives_pickle(port_mnist):
    clone = pickle.loads(pickle.dumps(port_mnist[0]))
    assert clone.datum_shape == (784,) and clone.datum_dtype == "float32"


# ---------------------------------------------------------------------------
# the port's engine against the JAX package's, on carried weights
# ---------------------------------------------------------------------------


def _serve(engine, rows):
    with ThreadPoolExecutor(max_workers=8) as pool:
        return np.stack([np.asarray(r) for r in
                         pool.map(lambda row: engine.predict(row, timeout=WAIT), rows)])


def _jax_serve(fitted, rows, buckets, datum_shape):
    engine = JServingEngine(fitted, buckets=buckets, datum_shape=datum_shape)
    try:
        engine.start()
        out = _serve(engine, rows)
        return out, engine.metrics.count("compiles")
    finally:
        engine.shutdown(drain=False)


def test_mnist_engine_predictions_equal_the_jax_engine(engines, mnist_fit):
    """MnistRandomFFT fitted by the JAX package, carried to the port: both
    engines serve the same rows at buckets (1, 8, 32); predictions equal,
    and each engine compiled once per bucket."""
    rows = mnist_fit.X.numpy()
    buckets = (1, 8, 32)
    want, j_compiles = _jax_serve(mnist_fit.j_fitted, rows, buckets, (784,))
    engine = engines(mnist_fit.preds, buckets=buckets, datum_shape=(784,)).start()
    got = _serve(engine, rows)
    sure = _sure(mnist_fit.j_scores)
    np.testing.assert_array_equal(got[sure], want[sure])
    assert engine.metrics.count("compiles") == j_compiles == len(buckets)


def test_krr_engine_scores_match_the_jax_engine(engines, cifar_fit):
    """The RandomPatchCifarKernel chain (K1 on the card, its plain version
    here) carried from a JAX fit: scores through the port's engine within
    1e-4 of the JAX engine's, predictions equal where JAX is sure."""
    rows = cifar_fit.X.numpy()
    buckets = (1, 8, 32)
    want, j_compiles = _jax_serve(cifar_fit.j_scores, rows, buckets, (32, 32, 3))
    engine = engines(cifar_fit.scores, buckets=buckets, datum_shape=(32, 32, 3)).start()
    got = _serve(engine, rows)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    sure = _sure(want)
    np.testing.assert_array_equal(got.argmax(1)[sure], want.argmax(1)[sure])
    assert engine.metrics.count("compiles") == j_compiles == len(buckets)


CIFAR_CONF = dict(num_filters=16, lam=1.0, gamma=1e-3, block_size=64, num_epochs=1,
                  cache_kernel=False, whitener_size=2000, pool_size=8, pool_stride=7)


@pytest.fixture(scope="module")
def mnist_fit():
    """MnistRandomFFT fitted by the JAX package and carried to the port."""
    from keystone_tpu.nodes.learning.linear import BlockLinearMapper as JBlockMapper
    from keystone_tpu.pipelines import mnist_random_fft as jm
    from keystone_tpu_torch.pipelines import mnist_random_fft as tm

    conf = dict(num_ffts=2, block_size=512, lam=10.0)
    j_train, j_test = jm.synthetic_mnist(n_train=1024, n_test=40, seed=7)
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
    return SimpleNamespace(j_fitted=j_fitted, X=torch.from_numpy(X),
                           j_scores=np.asarray(mapper.trace_batch(feats)),
                           preds=tm.fitted_from_arrays(params, CPU))


@pytest.fixture(scope="module")
def cifar_fit():
    """The RandomPatchCifarKernel chain fitted by the JAX package and
    carried to the port, ending at the scores."""
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
    return SimpleNamespace(
        j_scores=j_scores, X=synthetic_cifar(20, seed=8).data.to_array(),
        scores=tce.fitted_from_arrays(params, tce.KernelCifarConfig(**CIFAR_CONF), CPU,
                                      classify=False))


def _sure(scores, gap=1e-3):
    top2 = np.sort(np.asarray(scores), axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > gap


# ---------------------------------------------------------------------------
# MetricsRegistry (tests/serving/test_metrics*.py)
# ---------------------------------------------------------------------------


def test_counters_and_gauges():
    m = MetricsRegistry("t")
    m.inc("submitted")
    m.inc("submitted", 3)
    m.set_gauge("queue_depth", lambda: 7)
    assert m.count("submitted") == 4
    snap = m.snapshot()
    assert snap["counters"]["submitted"] == 4 and snap["gauges"]["queue_depth"] == 7


def test_latency_quantiles_on_known_data():
    m = MetricsRegistry("t")
    vals = np.linspace(0.001, 0.1, 100)
    for v in vals:
        m.observe_latency(float(v))
    q = m.latency_quantiles()
    assert q["count"] == 100 and q["p50"] <= q["p95"] <= q["p99"]
    assert q["p99"] == float(vals[98]) and q["p50"] == float(vals[49])
    assert MetricsRegistry("e").latency_quantiles() == {"count": 0}


def test_batch_occupancy_ratio():
    m = MetricsRegistry("t")
    m.observe_batch(6, 8)
    m.observe_batch(2, 8)
    occ = m.snapshot()["batch_occupancy"]
    assert occ["items"] == 8 and occ["capacity"] == 16 and abs(occ["ratio"] - 0.5) < 1e-9
    assert m.count("batches") == 2


def test_snapshot_embeds_serve_phase_stats():
    timing.reset()
    timing.record("serve.batch", 0.25)
    timing.record("krr.local_solve", 1.0)
    try:
        assert MetricsRegistry("t").snapshot()["phases"] == {
            "serve.batch": {"seconds": 0.25, "calls": 1}}
        assert "krr.local_solve" in timing.snapshot()
    finally:
        timing.reset()


def test_obs_every_rate_limits():
    key = "test-torch-every-unique-key"
    assert every(key, 60.0) is True
    assert every(key, 60.0) is False
    assert every(key, 0.0) is True


def test_maybe_log_is_rate_limited(caplog):
    m = MetricsRegistry("rate-limit-test")
    with caplog.at_level(logging.INFO, logger="keystone_tpu_torch.serving.metrics"):
        assert m.maybe_log(60.0) is True
        assert m.maybe_log(60.0) is False
    assert len([r for r in caplog.records if r.name.endswith("serving.metrics")]) == 1


def test_queue_age_quantiles_same_schema_as_latency():
    m = MetricsRegistry("t")
    for v in np.linspace(0.001, 0.1, 100):
        m.observe_queue_age(float(v))
    q = m.queue_age_quantiles()
    assert q["count"] == 100 and q["p50"] <= q["p95"] <= q["p99"]
    assert m.snapshot()["queue_age"]["p99"] == q["p99"]
    assert MetricsRegistry("e").queue_age_quantiles() == {"count": 0}


def test_per_replica_occupancy_in_snapshot():
    m = MetricsRegistry("t")
    m.observe_batch(6, 8, replica=0)
    m.observe_batch(2, 8, replica=0)
    m.observe_batch(8, 8, replica=1)
    snap = m.snapshot()
    assert snap["batch_occupancy"]["items"] == 16
    per = snap["replicas"]
    assert per["0"]["batches"] == 2 and per["1"]["batches"] == 1
    assert abs(per["0"]["occupancy"] - 0.5) < 1e-9 and per["1"]["occupancy"] == 1.0
    m2 = MetricsRegistry("t2")
    m2.observe_batch(4, 8)
    assert m2.snapshot()["replicas"] == {}


def test_periodic_log_includes_shed_and_canary_verdicts(caplog):
    m = MetricsRegistry("shed-log-test")
    m.inc("shed", 7)
    m.inc("canary_pass")
    m.inc("canary_fail", 2)
    with caplog.at_level(logging.INFO, logger="keystone_tpu_torch.serving.metrics"):
        assert m.maybe_log(60.0) is True
    line = caplog.records[-1].getMessage()
    assert "shed=7" in line and "canary=1pass/2fail" in line


def _worker(name, n, base_latency):
    m = MetricsRegistry(name=name)
    m.inc("submitted", n)
    m.inc("completed", n)
    m.inc("shed", 2)
    for i in range(n):
        m.observe_latency(base_latency + i * 0.001)
        m.observe_queue_age(base_latency / 2 + i * 0.0005)
    m.observe_batch(6, 8, replica=0)
    m.observe_batch(8, 8, replica=1)
    m.set_gauge("queue_depth", lambda: 3.0)
    return m


def test_counters_sum_and_replicas_namespace():
    merged = MetricsRegistry.merge([_worker("w0", 10, 0.010).snapshot(sketches=True),
                                    _worker("w1", 20, 0.100).snapshot(sketches=True)])
    assert merged["counters"]["submitted"] == 30 and merged["counters"]["shed"] == 4
    assert merged["gauges"]["queue_depth"] == 6.0
    assert set(merged["replicas"]) == {"w0/0", "w0/1", "w1/0", "w1/1"}
    occ = merged["batch_occupancy"]
    assert occ["items"] == 28 and occ["capacity"] == 32 and abs(occ["ratio"] - 28 / 32) < 1e-9


def test_quantiles_recomputed_from_merged_sketches():
    merged = MetricsRegistry.merge([_worker("w0", 50, 0.010).snapshot(sketches=True),
                                    _worker("w1", 50, 0.100).snapshot(sketches=True)])
    union = sorted([0.010 + i * 0.001 for i in range(50)] + [0.100 + i * 0.001 for i in range(50)])
    lat = merged["latency"]
    assert lat["count"] == 100
    assert abs(lat["p99"] - union[98]) < 1e-12 and abs(lat["p50"] - union[49]) < 1e-12
    assert merged["queue_age"]["count"] == 100


def test_snapshot_without_sketch_still_contributes_counters():
    merged = MetricsRegistry.merge([_worker("w0", 10, 0.010).snapshot(sketches=True),
                                    _worker("w1", 10, 0.020).snapshot()])
    assert merged["counters"]["submitted"] == 20 and merged["latency"]["count"] == 10


def test_merge_of_empty_inputs_is_well_formed():
    merged = MetricsRegistry.merge([])
    assert merged["counters"] == {} and merged["latency"] == {"count": 0}
    assert merged["batch_occupancy"]["ratio"] is None
    assert MetricsRegistry.merge([{}, None])["counters"] == {}


def test_sketch_is_bounded_by_reservoir_window():
    m = MetricsRegistry(name="w", latency_window=16)
    for i in range(100):
        m.observe_latency(float(i))
    assert len(m.snapshot(sketches=True)["sketch"]["latencies"]) == 16
    assert "sketch" not in m.snapshot()


def test_observe_cost_accumulates_per_identity():
    m = MetricsRegistry("w0")
    m.observe_cost("gold", "high", device_s=0.2, queue_s=0.05, payload_bytes=100, items=2)
    m.observe_cost("gold", "high", device_s=0.1, items=1)
    m.observe_cost("gold", "low", device_s=0.3, items=1)
    m.observe_cost("bronze", device_s=0.4, items=4)
    table = m.cost_table()
    assert table["gold"]["high"] == {"device_s": pytest.approx(0.3),
                                     "queue_s": pytest.approx(0.05),
                                     "payload_bytes": 100, "items": 3}
    assert table["gold"]["low"]["device_s"] == pytest.approx(0.3)
    assert table["bronze"]["normal"]["items"] == 4
    assert m.snapshot()["costs"] == table


def test_merge_folds_cost_tables_across_workers():
    a, b = MetricsRegistry("w0"), MetricsRegistry("w1")
    a.observe_cost("gold", "high", device_s=0.2, payload_bytes=10, items=1)
    b.observe_cost("gold", "high", device_s=0.3, payload_bytes=20, items=2)
    b.observe_cost("bronze", device_s=0.1, items=1)
    merged = MetricsRegistry.merge([a.snapshot(), b.snapshot()])
    assert merged["costs"]["gold"]["high"] == {"device_s": pytest.approx(0.5), "queue_s": 0.0,
                                               "payload_bytes": 30, "items": 3}
    assert merged["costs"]["bronze"]["normal"]["items"] == 1


def test_timeline_rows_carry_windowed_spend_deltas():
    m = MetricsRegistry("w0")
    m.observe_cost("gold", "high", device_s=0.2, items=2)
    m.observe_cost("gold", "low", device_s=0.1, items=1)
    row1 = m.sample_timeline(now=1.0)
    assert row1["costs"]["gold"] == {"device_s": pytest.approx(0.3), "items": 3}
    assert "costs" not in m.sample_timeline(now=2.0)
    m.observe_cost("gold", "high", device_s=0.05, items=1)
    assert m.sample_timeline(now=3.0)["costs"]["gold"]["device_s"] == pytest.approx(0.05)


def test_set_gauge_rejects_unknown_merge_mode():
    with pytest.raises(ValueError):
        MetricsRegistry("w0").set_gauge("x", lambda: 0.0, merge="median")
    assert set(GAUGE_MERGE_MODES) == {"sum", "max", "mean"}


def test_gauges_fold_by_declared_mode():
    a, b = MetricsRegistry("w0"), MetricsRegistry("w1")
    for m, depth, peak, frac in ((a, 3.0, 100.0, 0.2), (b, 5.0, 80.0, 0.6)):
        m.set_gauge("queue_depth", lambda v=depth: v)
        m.set_gauge("peak_bytes", lambda v=peak: v, merge="max")
        m.set_gauge("mem_fraction", lambda v=frac: v, merge="mean")
    merged = MetricsRegistry.merge([a.snapshot(), b.snapshot()])
    assert merged["gauges"]["queue_depth"] == 8.0 and merged["gauges"]["peak_bytes"] == 100.0
    assert merged["gauges"]["mem_fraction"] == pytest.approx(0.4)
    assert merged["gauge_modes"]["peak_bytes"] == "max"


def test_undeclared_gauges_keep_the_historical_sum():
    a = MetricsRegistry("w0")
    a.set_gauge("queue_depth", lambda: 2.0)
    snap_a = a.snapshot()
    del snap_a["gauge_modes"]
    b = MetricsRegistry("w1")
    b.set_gauge("queue_depth", lambda: 3.0)
    assert MetricsRegistry.merge([snap_a, b.snapshot()])["gauges"]["queue_depth"] == 5.0


def test_metrics_snapshot_equals_the_jax_registry():
    """The same observations through both registries give the same
    snapshot (phases, spans and the timeline aside: process state)."""
    from keystone_tpu.serving.metrics import MetricsRegistry as JMetrics

    snaps = []
    for cls in (JMetrics, MetricsRegistry):
        m = cls("same")
        m.inc("submitted", 5)
        m.set_gauge("queue_depth", lambda: 2, merge="max")
        for v in np.linspace(0.01, 0.2, 37):
            m.observe_latency(float(v), priority="high")
            m.observe_queue_age(float(v) / 3)
        m.observe_batch(5, 8, replica=1)
        m.observe_cost("gold", "high", device_s=0.25, queue_s=0.5, payload_bytes=64, items=5)
        snap = m.snapshot(sketches=True)
        for key in ("phases", "spans", "timeline"):
            snap.pop(key)
        snaps.append(snap)
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# compile accounting (tests/serving/test_recompile.py)
# ---------------------------------------------------------------------------


def _fitted_chain():
    return (FunctionNode(batch_fn=_double, label="double")
            >> FunctionNode(batch_fn=_inc, label="inc")).fit()


def test_compiles_once_per_shape_and_counts_recompiles():
    fitted = _fitted_chain()
    traces = []
    fn = fitted.compile(on_trace=traces.append)
    fn(torch.zeros(8, 4))
    fn(torch.ones(8, 4))
    assert fitted.compile_count == 1 and traces == [((8, 4), "float32")]
    fn(torch.zeros(32, 4))
    assert fitted.compile_count == 2
    fn(torch.zeros(8, 4))
    fn(torch.zeros(32, 4))
    assert fitted.compile_count == 2
    fn(torch.zeros(13, 4))
    assert fitted.compile_count == 3
    assert fitted.compiled_signatures[-1] == ((13, 4), "float32")
    assert traces == fitted.compiled_signatures


def test_compiled_matches_uncompiled_apply():
    fitted = _fitted_chain()
    x = torch.from_numpy(np.random.RandomState(0).randn(6, 4).astype(np.float32))
    np.testing.assert_allclose(fitted.compile()(x).numpy(), fitted.apply(x).to_array().numpy(),
                               rtol=1e-6)


def test_not_traceable_error_survives_pickle():
    err = pickle.loads(pickle.dumps(NotTraceableError(["nodeA", "nodeB"])))
    assert err.labels == ["nodeA", "nodeB"] and "nodeA" in str(err)


def test_untraceable_pipeline_raises_typed_error():
    fitted = (FunctionNode(batch_fn=_double, label="double")
              >> FunctionNode(item_fn=lambda x: x, label="host_only")).fit()
    assert not fitted.is_traceable and "host_only" in fitted.untraceable_nodes()
    with pytest.raises(NotTraceableError) as exc:
        fitted.compile()
    assert "host_only" in str(exc.value) and "host_only" in exc.value.labels
    with pytest.raises(ValueError):
        fitted.compile()
    assert fitted.compile(strict=False) is None


def test_recompile_resets_signature_accounting():
    fitted = _fitted_chain()
    fn1 = fitted.compile()
    fn1(torch.zeros(8, 4))
    fn1(torch.zeros(16, 4))
    assert fitted.compile_count == 2
    fn2 = fitted.compile()
    assert fitted.compile_count == 0
    fn2(torch.zeros(8, 4))
    assert fitted.compile_count == 1
    fn1(torch.zeros(32, 4))
    assert fitted.compile_count == 1


def test_signatures_reset_across_pickle(tmp_path):
    fitted = _fitted_chain()
    fitted.compile()(torch.zeros(4, 2))
    assert fitted.compile_count == 1
    path = str(tmp_path / "p.pkl")
    fitted.save(path)
    loaded = FittedPipeline.load(path)
    assert loaded.compile_count == 0
    loaded.compile()(torch.zeros(4, 2))
    assert loaded.compile_count == 1


# ---------------------------------------------------------------------------
# --serve-demo (tests/serving/test_demo.py)
# ---------------------------------------------------------------------------

DEMO = ["--serve-demo", "--device", "cpu", "--nTrain", "512", "--numFFTs", "2",
        "--blockSize", "256", "--buckets", "8"]


def test_serve_demo_smoke(capsys):
    from keystone_tpu_torch.__main__ import main

    assert main([*DEMO, "--requests", "16"]) == 0
    out = capsys.readouterr().out
    assert "SERVE PASS" in out and "SERVE ok=16/16" in out and "compiles=1" in out


def test_log_flag_levels_root_logger():
    from keystone_tpu_torch.__main__ import main

    prior = logging.getLogger().level
    try:
        assert main([*DEMO, "--requests", "8", "--log", "error"]) == 0
        assert logging.getLogger().level == logging.ERROR
        assert main([*DEMO, "--requests", "8", "--logLevel", "warning"]) == 0
        assert logging.getLogger().level == logging.WARNING
    finally:
        logging.getLogger().setLevel(prior)


@pytest.mark.parametrize("flag", [["--replicas", "2"], ["--workers", "2"]])
def test_serve_demo_names_the_later_slice_for_a_fleet_or_a_cluster(flag, capsys, monkeypatch):
    """``--replicas N`` serves from the fleet (``tests/test_torch_fleet.py``)
    and ``--workers N`` takes the cluster path with the worker count. The
    name is the one this test had while both flags named the slice still to
    come, kept so that runs before and after line up; neither names a slice
    now (the run through worker processes is
    ``tests/test_torch_cluster_router.py``)."""
    from keystone_tpu_torch.serving import demo

    if flag[0] == "--replicas":
        assert demo.main([*DEMO[1:], "--requests", "16", *flag]) == 0
        assert "replicas=2" in capsys.readouterr().out
        return
    seen = {}

    def through_cluster(args, fitted, data, buckets, dev):
        seen.update(workers=args.workers, rows=len(data), buckets=buckets, device=str(dev))
        return 0

    monkeypatch.setattr(demo, "_serve_through_cluster", through_cluster)
    assert demo.main(["--device", "cpu", "--requests", "16", *flag]) == 0
    assert seen == {"workers": 2, "rows": 16, "buckets": (8, 32), "device": "cpu"}
