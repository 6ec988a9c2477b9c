"""The port's layer spans (``obs.layer``) and the ``torch.profiler`` mirror of
the tracer's spans: nothing at all when neither the tracer nor the profiler
is on, a ``Span`` under a tracer, a ``user_annotation`` on the calling
thread while the profiler records; and the layers a whole CIFAR kernel run
and a whole TIMIT run mark, on the CPU at tiny sizes (``benchmark/spans.py``
reads them in a traced window by these names)."""

import json
import threading

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from keystone_tpu_torch import obs
from keystone_tpu_torch.loaders.cifar import synthetic_cifar
from keystone_tpu_torch.obs import tracer as trace_mod
from keystone_tpu_torch.pipelines import cifar_extras, timit
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import Pipeline

CPU = torch.device("cpu")
CIFAR = dict(num_filters=16, lam=1.0, gamma=1e-3, block_size=64, num_epochs=1,
             cache_kernel=False, whitener_size=2000, pool_size=8, pool_stride=7)
TIMIT = dict(num_cosines=3, cosine_features=64, input_dim=24, num_epochs=1, lam=1e-2,
             num_classes=4)


def run_cifar():
    cifar_extras.run_random_patch_cifar_kernel(
        synthetic_cifar(192, seed=7), synthetic_cifar(48, seed=8),
        cifar_extras.KernelCifarConfig(**CIFAR), CPU)


def run_timit():
    timit.run(timit.synthetic_timit(96, 4, dim=24, seed=0),
              timit.synthetic_timit(24, 4, dim=24, seed=1), timit.TimitConfig(**TIMIT), CPU)


#: each application, its run, and its estimators chained by ``and_then``
APPS = {
    "cifar": (run_cifar, 2, ["fit.StandardScaler", "fit.KernelRidgeRegression"]),
    "timit": (run_timit, 1, ["fit.BlockLeastSquaresEstimator"]),
}


@pytest.fixture(autouse=True)
def clean():
    """No tracer and no fitted state leak across tests."""
    trace_mod.reset()
    PipelineEnv.get_or_create().reset()
    yield
    trace_mod.reset()
    PipelineEnv.get_or_create().reset()


@pytest.fixture
def counted(monkeypatch):
    """Counts of ``record_function`` ranges entered and ``Span`` records
    made by the tracer module."""
    counts = {"record_function": 0, "Span": 0}
    real_range, real_span = autograd_profiler.record_function, trace_mod.Span

    class CountedRange(real_range):
        def __init__(self, *args, **kwargs):
            counts["record_function"] += 1
            super().__init__(*args, **kwargs)

    def counted_span(*args, **kwargs):
        counts["Span"] += 1
        return real_span(*args, **kwargs)

    monkeypatch.setattr(autograd_profiler, "record_function", CountedRange)
    monkeypatch.setattr(trace_mod, "Span", counted_span)
    return counts


def annotations(prof, tmp_path):
    """The profiler's ``user_annotation`` events on this thread, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    me = threading.get_native_id()
    return sorted((e for e in events
                   if e.get("cat") == "user_annotation" and e.get("tid") == me),
                  key=lambda e: float(e["ts"]))


def test_layer_with_neither_on_records_nothing(counted):
    with obs.layer("check.static", where="fit"):
        torch.ones(3).sum()
    assert counted == {"record_function": 0, "Span": 0}
    # one shared no-op: nothing is made per call
    assert obs.layer("app.score", set="train") is obs.layer("fit.featurize")


@pytest.mark.parametrize("app", sorted(APPS))
def test_sites_enter_no_range_and_make_no_span_with_neither_on(counted, app):
    APPS[app][0]()
    assert counted == {"record_function": 0, "Span": 0}


def test_layer_under_a_tracer_records_a_span_and_never_waits(counted):
    tracer = trace_mod.install(trace_mod.Tracer())
    with obs.layer("app.score", set="train"):
        torch.ones(3).sum()
    (sp,) = tracer.spans()
    assert (sp.name, sp.attrs, sp.sync_seconds, sp.sync_target) == (
        "app.score", {"set": "train"}, 0.0, None)
    assert sp.end >= sp.start
    assert counted == {"record_function": 0, "Span": 1}


@pytest.mark.parametrize("with_tracer", [False, True], ids=["profiler", "profiler+tracer"])
def test_layer_under_the_profiler_annotates_the_calling_thread(tmp_path, with_tracer):
    tracer = trace_mod.install(trace_mod.Tracer()) if with_tracer else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.layer("fit.featurize"):
            torch.ones(4).sum()
    assert [e["name"] for e in annotations(prof, tmp_path)] == ["fit.featurize"]
    if with_tracer:
        assert [sp.name for sp in tracer.spans()] == ["fit.featurize"]


@pytest.mark.parametrize("kind", ["span", "instant"])
def test_tracer_spans_mirror_into_the_profiler(tmp_path, kind):
    tracer = trace_mod.install(trace_mod.Tracer())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if kind == "span":
            with tracer.span("pipeline.fit", op_type="Pipeline"):
                torch.ones(4).sum()
        else:
            tracer.instant("node.hit", node_id="3")
    assert [e["name"] for e in annotations(prof, tmp_path)] == [
        "pipeline.fit" if kind == "span" else "node.hit"]
    assert len(tracer.spans()) == 1


@pytest.mark.parametrize("check", [True, False], ids=["checked", "KEYSTONE_STATIC_CHECK=0"])
@pytest.mark.parametrize("app", sorted(APPS))
def test_a_whole_run_marks_its_layers_in_order(tmp_path, monkeypatch, app, check):
    run, chained, estimators = APPS[app]
    if not check:
        monkeypatch.setenv("KEYSTONE_STATIC_CHECK", "0")
    fits = []
    real_fit = Pipeline.fit

    def kept(pipeline):
        fitted = real_fit(pipeline)
        fits.append(dict(fitted.seconds))
        return fitted

    monkeypatch.setattr(Pipeline, "fit", kept)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = [e for e in annotations(prof, tmp_path)
             if e["name"].startswith(("app.", "fit.")) or e["name"] == "check.static"]
    names = [e["name"] for e in spans]

    # the checker at each estimator's and_then and at fit entry, then the
    # fit's phases, then the train and the test set scored
    head = ["app.filters"] if app == "cifar" else []
    checks = ["check.static"] * ((chained + 1) if check else 0)
    fit_names = [n for n in names if n.startswith("fit.")]
    assert names == head + checks + fit_names + ["app.score"] * 2
    assert set(fit_names) == {"fit.featurize", *estimators}
    assert fit_names[-1] == estimators[-1]

    # the layer spans never nest in one another
    for a, b in zip(spans, spans[1:]):
        assert float(a["ts"]) + float(a["dur"]) <= float(b["ts"])

    # each fit span covers the interval its ``seconds`` entry counts
    (seconds,) = fits
    for key, want in seconds.items():
        if key in ("optimize", "executor"):
            continue
        got = sum(float(e["dur"]) for e in spans if e["name"] == f"fit.{key}") / 1e6
        assert want - 2e-6 <= got <= want + max(0.05, 0.5 * want), key
