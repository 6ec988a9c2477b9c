"""Segment dispatch in the port (``keystone_tpu_torch/compile/segment.py``,
``cost/segments.py`` and the executor's segment table): every case of the
JAX package's ``tests/compile/test_segment.py`` under its name, with the
port's toy nodes, and the port held against the JAX package in one
process:

* the planner cuts equal graphs into equal segments (members, inputs and
  outputs by position and operator class);
* MnistRandomFFT and TimitPipeline at small widths: segment dispatch is
  bit-equal to node dispatch in the port, and within the JAX tests'
  tolerance (atol 1e-4 on the scores) of the JAX package's segment
  dispatch with the same weights;
* the deliberate divergence: a kernel's build or launch failure and an
  out-of-memory error inside a bound segment propagate; the JAX package
  demotes and falls back on every failure.

Inputs come from seeded numpy at small sizes.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import keystone_tpu.compile as jcmod
import keystone_tpu_torch.compile as cmod
import keystone_tpu_torch.cost as cost
from keystone_tpu.check import lattice as jlattice
from keystone_tpu.check.segments import plan_segments as j_plan_segments
from keystone_tpu.compile.segment import reset_dispatchers as j_reset_dispatchers
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.workflow.graph import Graph as JGraph
from keystone_tpu.workflow.operators import DatasetOperator as JDatasetOperator
from keystone_tpu.workflow.transformer import Transformer as JTransformer
from keystone_tpu_torch.check import lattice
from keystone_tpu_torch.check.segments import plan_segments
from keystone_tpu_torch.compile import ExecutableCache
from keystone_tpu_torch.compile import manifest as manifest_mod
from keystone_tpu_torch.compile import segment as segment_mod
from keystone_tpu_torch.compile.fingerprint import segment_fingerprint
from keystone_tpu_torch.compile.segment import (
    SegmentDispatcher,
    bind_segment,
    lower_segment,
    prewarm_segment_artifacts,
    reset_dispatchers,
)
from keystone_tpu_torch.cost import segments as seg_cost
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.obs import tracer as tracer_mod
from keystone_tpu_torch.ops._build import KernelError
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.graph import Graph
from keystone_tpu_torch.workflow.operators import DatasetOperator
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, _bind_source, attach_data
from keystone_tpu_torch.workflow.transformer import Transformer

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _isolate_segment_state():
    """Dispatchers are process-wide (keyed by digest and cache root), and
    some tests install a process-wide cache or profile store: none may leak,
    in either package."""
    reset_dispatchers()
    j_reset_dispatchers()
    PipelineEnv.get_or_create().reset()
    yield
    reset_dispatchers()
    j_reset_dispatchers()
    cmod.reset()
    jcmod.reset()
    cost.reset()
    tracer_mod.reset()
    PipelineEnv.get_or_create().reset()


class _Mul(Transformer):
    def __init__(self, k):
        self.k = k

    def forward(self, X):
        return X * self.k


class _Add(Transformer):
    """A two-input member: the lowering must feed it positionally. Not
    symmetric: swapped arguments change the answer."""

    def forward(self, X, Y):
        return X + 2.0 * Y


class _HostOnly(Transformer):
    """No forward: a segment barrier, as a Cacher or a host node is."""

    def apply(self, x):
        return x + 1.0


class _JMul(JTransformer):
    def __init__(self, k):
        self.k = k

    def trace_batch(self, X):
        return X * self.k


class _JAdd(JTransformer):
    def trace_batch(self, X, Y):
        return X + 2.0 * Y


def _mul_chain_fitted():
    pipe = _Mul(2.0).and_then(_Mul(3.0)).and_then(_Mul(0.5))
    return FittedPipeline(pipe.graph, pipe.source, pipe.sink)


def _plan(graph):
    verdicts = {n: lattice.classify(graph.get_operator(n)) for n in graph.nodes}
    return plan_segments(graph, verdicts, {})


def _two_input_graph(k=3.0):
    g = Graph()
    g, a = g.add_node(DatasetOperator(Dataset.of(np.ones((4, 3), np.float32))), [])
    g, b = g.add_node(DatasetOperator(Dataset.of(np.full((4, 3), 2.0, np.float32))), [])
    # deps deliberately not in id order: the pinned inputs come from the
    # linearization, not from the dependency order
    g, c = g.add_node(_Add(), [b, a])
    g, d = g.add_node(_Mul(k), [c])
    g, _ = g.add_sink(d)
    return g, (a, b, c, d)


def _j_two_input_graph():
    g = JGraph()
    g, a = g.add_node(JDatasetOperator(JDataset.of(np.ones((4, 3), np.float32))), [])
    g, b = g.add_node(JDatasetOperator(JDataset.of(np.full((4, 3), 2.0, np.float32))), [])
    g, c = g.add_node(_JAdd(), [b, a])
    g, d = g.add_node(_JMul(3.0), [c])
    g, _ = g.add_sink(d)
    return g


def _two_node_segment(g):
    (seg,) = [s for s in _plan(g)[0] if len(s.nodes) == 2]
    return seg


X10 = np.arange(40, dtype=np.float32).reshape(10, 4)


def _x10():
    return torch.from_numpy(X10.copy())


def _spans_of(fn):
    tracer = tracer_mod.install(tracer_mod.Tracer())
    try:
        value = fn()
        return value, tracer.spans()
    finally:
        tracer_mod.reset()


# ---------------------------------------------------------------------------
# The planning contract and the lowering
# ---------------------------------------------------------------------------


def test_segment_inputs_are_pinned_to_linearization_order():
    from keystone_tpu_torch.workflow import analysis

    g, (a, b, c, d) = _two_input_graph()
    seg = _two_node_segment(g)
    assert seg.nodes == [c, d] and seg.outputs == [d]
    assert set(seg.inputs) == {a, b}
    full_pos = {gid: i for i, gid in enumerate(analysis.linearize(g))}
    assert seg.inputs == sorted(seg.inputs, key=lambda i: full_pos[i])
    # the plan, and so the lowered signature, is deterministic
    seg2 = _two_node_segment(g)
    assert seg2.inputs == seg.inputs and seg2.nodes == seg.nodes


def _partition(segments, graph):
    def label(n):
        return n.id if n in graph.operators else str(n)

    return [([label(n) for n in s.nodes], [label(n) for n in s.inputs],
             [label(n) for n in s.outputs]) for s in segments]


def test_the_partition_equals_jax():
    """Equal graphs plan into equal segments in both packages: the same
    members, inputs and outputs (by node id) and the same barriers."""
    g, _ = _two_input_graph()
    jg = _j_two_input_graph()
    segs, barriers = _plan(g)
    jverdicts = {n: jlattice.classify(jg.get_operator(n)) for n in jg.nodes}
    jsegs, jbarriers = j_plan_segments(jg, jverdicts, {})
    assert _partition(segs, g) == _partition(jsegs, jg)
    assert {n.id: r for n, r in barriers.items()} == {n.id: r for n, r in jbarriers.items()}


def test_the_partition_of_a_host_split_chain_equals_jax():
    from keystone_tpu.workflow.pipeline import attach_data as j_attach_data

    class _JHostOnly(JTransformer):
        def apply(self, x):
            return x + 1.0

    pipe = _Mul(2.0).and_then(_HostOnly()).and_then(_Mul(4.0))
    g = _bind_source(pipe.graph, pipe.source, attach_data, Dataset.of(_x10()))
    jpipe = _JMul(2.0).and_then(_JHostOnly()).and_then(_JMul(4.0))
    jg, data_id = j_attach_data(jpipe.graph, JDataset.of(X10))
    jg = jg.replace_dependency(jpipe.source, data_id).remove_source(jpipe.source)
    segs, barriers = _plan(g)
    jverdicts = {n: jlattice.classify(jg.get_operator(n)) for n in jg.nodes}
    jsegs, jbarriers = j_plan_segments(jg, jverdicts, {})
    assert _partition(segs, g) == _partition(jsegs, jg)
    assert sorted(barriers.values()) == sorted(jbarriers.values())


def test_fingerprint_is_stable_and_state_sensitive():
    g, _ = _two_input_graph()
    d1 = segment_fingerprint(g, _two_node_segment(g))
    g2, _ = _two_input_graph()
    assert segment_fingerprint(g2, _two_node_segment(g2)) == d1
    gk, _ = _two_input_graph(k=4.0)  # another operator state
    assert segment_fingerprint(gk, _two_node_segment(gk)) != d1


def test_lower_segment_composes_members_positionally():
    g, (a, b, _c, _d) = _two_input_graph()
    seg = _two_node_segment(g)
    fn, steps, out_slots = lower_segment(g, seg)
    assert len(steps) == 2 and len(out_slots) == 1
    by_node = {a: torch.ones(4, 3), b: torch.full((4, 3), 2.0)}
    out = fn(*[by_node[i] for i in seg.inputs])
    # _Add's deps are (b, a): (2 + 2·1)·3; swapped arguments would give 15
    torch.testing.assert_close(out[0], torch.full((4, 3), 12.0), rtol=0, atol=0)


def test_binding_dispatches_two_input_segment_compiled():
    g, (a, b, _c, _d) = _two_input_graph()
    binding = bind_segment(g, _two_node_segment(g))
    assert binding is not None and len(binding) == 2
    ins = {a: Dataset.of(np.ones((4, 3), np.float32)),
           b: Dataset.of(np.full((4, 3), 2.0, np.float32))}
    outs, path = binding.run([ins[i] for i in binding.inputs])
    assert path == "compiled"
    torch.testing.assert_close(outs[0].to_array(), torch.full((4, 3), 12.0), rtol=0, atol=0)


def test_singleton_plain_node_is_not_bound():
    pipe = _Mul(2.0).and_then(_HostOnly()).and_then(_Mul(4.0))
    g = _bind_source(pipe.graph, pipe.source, attach_data, Dataset.of(_x10()))
    segments, barriers = _plan(g)
    # the host node is a barrier; a _Mul alone gains nothing from segment
    # dispatch and must not bind
    assert "host" in barriers.values()
    assert all(bind_segment(g, seg) is None for seg in segments)


# ---------------------------------------------------------------------------
# Executor dispatch: spans, the switch, parity
# ---------------------------------------------------------------------------


def test_chain_applies_as_one_segment_span(monkeypatch):
    fitted = _mul_chain_fitted()
    y, spans = _spans_of(lambda: fitted.apply(Dataset.of(_x10())).to_array())
    torch.testing.assert_close(y, _x10() * 3.0, rtol=0, atol=0)
    (sp,) = [s for s in spans if s.name == "exec.segment"]
    assert sp.attrs["nodes"] == 3 and sp.attrs["path"] == "compiled"
    assert len(sp.attrs["node_ids"]) == 3
    # the members record no node span of their own: the dispatch saving
    assert not any("_Mul" in s.name for s in spans)

    monkeypatch.setenv("KEYSTONE_SEGMENT_COMPILE", "0")
    y_node, node_spans = _spans_of(lambda: fitted.apply(Dataset.of(_x10())).to_array())
    assert not any(s.name == "exec.segment" for s in node_spans)
    assert sum(1 for s in node_spans if "_Mul" in s.name) == 3
    assert torch.equal(y, y_node), "the switch must not change answers"

    # the JAX package's chain, the same spans and the same answer
    from keystone_tpu.obs import tracer as jtracer_mod
    from keystone_tpu.workflow.pipeline import FittedPipeline as JFittedPipeline

    monkeypatch.delenv("KEYSTONE_SEGMENT_COMPILE")
    jpipe = _JMul(2.0).and_then(_JMul(3.0)).and_then(_JMul(0.5))
    jtracer = jtracer_mod.install(jtracer_mod.Tracer())
    try:
        jy = np.asarray(JFittedPipeline(jpipe.graph, jpipe.source, jpipe.sink)
                        .apply(JDataset.of(X10)).to_array())
        (jsp,) = [s for s in jtracer.spans() if s.name == "exec.segment"]
    finally:
        jtracer_mod.reset()
    np.testing.assert_array_equal(y.numpy(), jy)
    assert (jsp.attrs["nodes"], jsp.attrs["path"]) == (sp.attrs["nodes"], sp.attrs["path"])


def test_ragged_final_chunk_rides_chunk_padder(monkeypatch):
    fitted = _mul_chain_fitted()
    y, spans = _spans_of(
        lambda: fitted.apply(ChunkedDataset.from_array(X10, 4)).to_array())  # 4, 4, 2 rows
    torch.testing.assert_close(y, _x10() * 3.0, rtol=0, atol=0)
    (sp,) = [s for s in spans if s.name == "exec.segment"]
    assert sp.attrs["path"] == "chunked"

    monkeypatch.setenv("KEYSTONE_SEGMENT_COMPILE", "0")
    y_node = fitted.apply(ChunkedDataset.from_array(X10, 4)).to_array()
    assert torch.equal(y, y_node)


def test_host_callback_chain_degrades_to_node_dispatch():
    pipe = _Mul(2.0).and_then(_HostOnly()).and_then(_Mul(4.0))
    fitted = FittedPipeline(pipe.graph, pipe.source, pipe.sink)
    y, spans = _spans_of(lambda: fitted.apply(Dataset.of(_x10())).to_array())
    torch.testing.assert_close(y, (_x10() * 2.0 + 1.0) * 4.0)
    # no bindable segment around the host barrier: node dispatch, no error
    assert not any(s.name == "exec.segment" for s in spans)
    assert any("_HostOnly" in s.name for s in spans)


def test_a_batch_coupled_segment_runs_whole_only_within_its_budget(monkeypatch):
    """A batch-coupled member's statistics must see the whole batch: such a
    segment runs whole when what it holds at once (reckoned on fake tensors)
    fits ``WHOLE_BYTES``, and takes node dispatch otherwise; chunked input
    takes node dispatch, which refuses it as the node would."""

    class _Center(Transformer):
        batch_coupled = True

        def forward(self, X):
            return X - X.mean(dim=0, keepdim=True)

    pipe = _Center().and_then(_Mul(2.0))
    fitted = FittedPipeline(pipe.graph, pipe.source, pipe.sink)
    want = (_x10() - _x10().mean(dim=0, keepdim=True)) * 2.0

    def paths():
        reset_dispatchers()
        fitted._segment_plan = None
        y, spans = _spans_of(lambda: fitted.apply(Dataset.of(_x10())).to_array())
        torch.testing.assert_close(y, want, rtol=0, atol=0)
        return [s.attrs["path"] for s in spans if s.name == "exec.segment"]

    assert paths() == ["compiled"]
    monkeypatch.setattr(segment_mod, "WHOLE_BYTES", X10.nbytes)  # the input alone fills it
    assert paths() == ["fallback"]
    with pytest.raises(ValueError, match="batch-coupled"):
        fitted.apply(ChunkedDataset.from_array(X10, 4)).to_array()


def test_a_datum_pull_takes_node_dispatch():
    fitted = _mul_chain_fitted()
    x = torch.arange(4, dtype=torch.float32)
    assert torch.equal(fitted.apply_datum(x), x * 3.0)
    # the plan of the datum pull is cached for the next apply
    assert fitted._segment_plan is not None
    torch.testing.assert_close(fitted.apply(Dataset.of(_x10())).to_array(), _x10() * 3.0)


@pytest.mark.parametrize("order", ["datum_first", "apply_first"])
def test_a_pipeline_datum_splice_neither_reads_nor_leaves_a_plan(order):
    """A PipelineDatum spliced into ``apply_datum`` brings its prefix's
    nodes, whose ids are the ids a plain splice gives the data leaf: the
    plan of one splice must never serve the other."""
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    fitted = _mul_chain_fitted()
    prefix = _Mul(5.0).and_then(_Mul(7.0))
    x = torch.arange(4, dtype=torch.float32)

    def datum():
        return fitted.apply_datum(Pipeline.apply_datum(prefix, x))

    def batch():
        return fitted.apply(Dataset.of(_x10())).to_array()

    if order == "datum_first":
        assert torch.equal(datum(), x * 35.0 * 3.0)
        assert fitted._segment_plan is None
        assert torch.equal(batch(), _x10() * 3.0)
        assert fitted._segment_plan is not None
    else:
        assert torch.equal(batch(), _x10() * 3.0)
        plan = fitted._segment_plan
        assert torch.equal(datum(), x * 35.0 * 3.0)
        assert fitted._segment_plan is plan
        assert torch.equal(batch(), _x10() * 3.0)


def test_an_executor_plans_anew_when_a_seeded_plan_does_not_fit():
    """The executor's own guard: a plan bound on one splice, seeded into an
    executor over another whose ids collide, is checked and replanned."""
    from keystone_tpu_torch.workflow.executor import GraphExecutor
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    fitted = _mul_chain_fitted()
    fitted.apply(Dataset.of(_x10()))
    plan = fitted._segment_plan
    prefix = _Mul(5.0).and_then(_Mul(7.0))
    g = _bind_source(fitted.graph, fitted._source, attach_data,
                     Pipeline.apply(prefix, Dataset.of(_x10())))
    (binding,) = set(plan.values())
    assert not binding.holds_for(g)
    executor = GraphExecutor(g, optimize=False, segment_plan=plan)
    torch.testing.assert_close(executor.execute(fitted._sink).get().to_array(),
                               _x10() * 105.0, rtol=0, atol=0)
    assert executor.segment_plan is not plan
    g_plain = _bind_source(fitted.graph, fitted._source, attach_data, Dataset.of(_x10()))
    assert binding.holds_for(g_plain)


def test_without_a_cache_or_store_no_digest_is_computed(tmp_path, monkeypatch):
    """Without a cache and a profile store a segment's digest serves
    nothing: it is not computed, the span carries none, and bindings over
    the same operators share one dispatcher. A cache configured later
    computes it at the first run that needs it."""
    calls = []
    real = segment_mod.segment_fingerprint
    monkeypatch.setattr(segment_mod, "segment_fingerprint",
                        lambda *a: calls.append(1) or real(*a))
    fitted = _mul_chain_fitted()
    y, spans = _spans_of(lambda: fitted.apply(Dataset.of(_x10())).to_array())
    fitted._segment_plan = None  # a second plan, new bindings, the same operators
    fitted.apply(Dataset.of(_x10()))
    (sp,) = [s for s in spans if s.name == "exec.segment"]
    assert calls == [] and sp.attrs["digest"] == ""
    (disp,) = segment_mod._DISPATCHERS.values()
    assert disp.digest is None
    cache = cmod.configure(str(tmp_path))
    y_cached = fitted.apply(Dataset.of(_x10())).to_array()
    (binding,) = set(fitted._segment_plan.values())
    assert calls == [1] and binding.known_digest is not None
    assert manifest_mod.segment_digests(cache) == [binding.digest]
    assert torch.equal(y, y_cached)


def test_path_counts_are_read_without_a_tracer():
    segment_mod.reset_path_counts()
    fitted = _mul_chain_fitted()
    fitted.apply(Dataset.of(_x10()))
    fitted.apply(ChunkedDataset.from_array(X10, 4)).to_array()
    assert segment_mod.path_counts() == {"compiled": 1, "chunked": 1}
    segment_mod.reset_path_counts()
    assert segment_mod.path_counts() == {}


def test_a_fitted_pipeline_plans_once_across_applies(monkeypatch):
    fitted = _mul_chain_fitted()
    fitted.apply(Dataset.of(_x10()))
    plan = fitted._segment_plan
    assert plan and len({id(b) for b in plan.values()}) == 1
    calls = []
    monkeypatch.setattr(segment_mod, "segment_fingerprint",
                        lambda *a: calls.append(1) or "0" * 64)
    fitted.apply(Dataset.of(_x10()))
    assert fitted._segment_plan is plan and calls == []


def test_a_fit_featurizes_once_across_chained_estimators(monkeypatch):
    """After the first estimator fits, the featurizer and the fitted scaler
    form one segment; its featurizer output is already held, so the next
    estimator's pull reads it (node dispatch) and featurizes nothing again:
    the featurizer runs as often as under node dispatch."""
    from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.workflow.transformer import FunctionNode

    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.standard_normal((64, 6)).astype(np.float32))
    Y = torch.from_numpy(rng.standard_normal((64, 2)).astype(np.float32))
    calls = []

    def fit():
        PipelineEnv.get_or_create().reset()
        calls.clear()
        feat = FunctionNode(batch_fn=lambda x: calls.append(1) or x * 2.0).and_then(
            FunctionNode(batch_fn=lambda x: x + 1.0))
        fitted = feat.and_then(StandardScaler(), X).and_then(LinearMapEstimator(0.1), X, Y).fit()
        return fitted.apply(X).to_array(), len(calls)

    y_seg, seg_calls = fit()
    y_node, node_calls = _node_dispatch(monkeypatch, fit)
    assert seg_calls == node_calls
    assert torch.equal(y_seg, y_node)


# ---------------------------------------------------------------------------
# The applications: segment against node dispatch, the port against JAX
# ---------------------------------------------------------------------------

MNIST_CONF = dict(num_ffts=2, block_size=512, lam=10.0)


def _node_dispatch(monkeypatch, fn):
    monkeypatch.setenv("KEYSTONE_SEGMENT_COMPILE", "0")
    try:
        return fn()
    finally:
        monkeypatch.delenv("KEYSTONE_SEGMENT_COMPILE")


def test_mnist_random_fft_segment_vs_node_bit_equality(monkeypatch):
    from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        NUM_CLASSES,
        MnistRandomFFTConfig,
        build_featurizer,
        synthetic_mnist,
    )

    conf = MnistRandomFFTConfig(**MNIST_CONF)
    train, test = synthetic_mnist(128, 32, seed=7)

    def fit():
        PipelineEnv.get_or_create().reset()
        labels = ClassLabelIndicators(NUM_CLASSES).apply_batch(train.labels)
        return (build_featurizer(conf, CPU)
                .and_then(BlockLeastSquaresEstimator(conf.block_size, 1, conf.lam or 0.0),
                          train.data, labels)
                .and_then(MaxClassifier()).fit())

    fitted = fit()
    y_seg, spans = _spans_of(lambda: fitted.apply(test.data).to_array())
    assert [s.attrs["path"] for s in spans if s.name == "exec.segment"] == ["compiled"]
    y_node = _node_dispatch(monkeypatch, lambda: fitted.apply(test.data).to_array())
    assert torch.equal(y_seg, y_node)
    # a fit run entirely under node dispatch trains the same model
    fitted_off = _node_dispatch(monkeypatch, fit)
    assert torch.equal(fitted_off.apply(test.data).to_array(), y_seg)


def test_timit_segment_vs_node_bit_equality(monkeypatch):
    from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier
    from keystone_tpu_torch.pipelines.timit import TimitConfig, build_featurizer, synthetic_timit

    conf = TimitConfig(num_cosines=3, cosine_features=64, input_dim=24, num_epochs=1,
                       lam=1e-2, num_classes=4)
    train = synthetic_timit(96, 4, dim=24, seed=0)
    test = synthetic_timit(24, 4, dim=24, seed=1)
    labels = ClassLabelIndicators(4).apply_batch(train.labels)
    fitted = (build_featurizer(conf, CPU)
              .and_then(BlockLeastSquaresEstimator(conf.cosine_features, conf.num_epochs,
                                                   conf.lam), train.data, labels)
              .and_then(MaxClassifier()).fit())
    y_seg = fitted.apply(test.data).to_array()
    y_node = _node_dispatch(monkeypatch, lambda: fitted.apply(test.data).to_array())
    assert torch.equal(y_seg, y_node)


@pytest.fixture(scope="module")
def mnist_pair():
    """A JAX fit of MnistRandomFFT and the port's chain carrying its weights
    and signs (``fitted_from_arrays``)."""
    from keystone_tpu.nodes.learning.linear import BlockLinearMapper as JBlockMapper
    from keystone_tpu.pipelines import mnist_random_fft as jm
    from keystone_tpu_torch.pipelines import mnist_random_fft as tm

    j_train, j_test = jm.synthetic_mnist(n_train=512, n_test=40, seed=7)
    j_pipe, _, _, _ = jm.run(j_train, j_test, jm.MnistRandomFFTConfig(**MNIST_CONF))
    j_fitted = j_pipe.fit()
    mapper = next(o for o in j_fitted.graph.operators.values() if isinstance(o, JBlockMapper))
    signs = np.stack([np.array(jm.RandomSignNode.create(784, seed=i).signs)
                      for i in range(MNIST_CONF["num_ffts"])])
    X = np.array(j_test.data.to_array())
    feats = jm.build_featurizer(jm.MnistRandomFFTConfig(**MNIST_CONF))(JDataset.of(X)) \
        .get().to_array()
    params = dict(signs=signs, W=np.concatenate([np.asarray(w) for w in mapper.xs]),
                  b=np.asarray(mapper.b),
                  feature_means=np.concatenate([np.asarray(m) for m in mapper.feature_means]))
    return SimpleNamespace(j_fitted=j_fitted, X=X,
                           j_scores=np.asarray(mapper.trace_batch(feats)),
                           scores=tm.fitted_from_arrays(params, CPU, classify=False))


def test_mnist_segments_match_jax_segments(mnist_pair, monkeypatch):
    X = mnist_pair.X
    # the JAX package's fitted predictor, run by its own segment dispatch
    j_preds = np.asarray(mnist_pair.j_fitted.apply(JDataset.of(X)).to_array())
    got = mnist_pair.scores.apply(torch.from_numpy(X)).to_array()
    np.testing.assert_allclose(got.numpy(), mnist_pair.j_scores, atol=1e-4)
    top2 = np.sort(mnist_pair.j_scores, axis=1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-3
    np.testing.assert_array_equal(got.numpy().argmax(1)[sure], j_preds[sure])
    node = _node_dispatch(monkeypatch,
                          lambda: mnist_pair.scores.apply(torch.from_numpy(X)).to_array())
    assert torch.equal(got, node)


def test_the_mnist_partition_equals_jax(mnist_pair):
    """The fitted MnistRandomFFT predictor plans into the same segment in
    both packages: the fused featurizer, the block mapper and the
    classifier, fed by the data leaf, one output."""
    from keystone_tpu.workflow.pipeline import attach_data as j_attach_data
    from keystone_tpu_torch.nodes.util import MaxClassifier

    def shape(graph, segs):
        return [([type(graph.get_operator(n)).__name__ for n in s.nodes],
                 [type(graph.get_operator(n)).__name__ for n in s.inputs], len(s.outputs))
                for s in segs]

    jf = mnist_pair.j_fitted
    jg, data_id = j_attach_data(jf.graph, JDataset.of(mnist_pair.X))
    jg = jg.replace_dependency(jf._source, data_id).remove_source(jf._source)
    jsegs, _ = j_plan_segments(jg, {n: jlattice.classify(jg.get_operator(n))
                                    for n in jg.nodes}, {})
    fitted = mnist_pair.scores.and_then(MaxClassifier())
    g = _bind_source(fitted.graph, fitted.source, attach_data,
                     Dataset.of(torch.from_numpy(mnist_pair.X)))
    assert shape(g, _plan(g)[0]) == shape(jg, jsegs) == [
        (["FusedTransformerOperator", "BlockLinearMapper", "MaxClassifier"],
         ["DatasetOperator"], 1)]


def test_timit_segments_match_jax_segments(monkeypatch):
    from keystone_tpu.pipelines import timit as jt
    from keystone_tpu_torch.pipelines import timit as tt
    from tests.test_torch_timit import _jax_params

    conf = dict(num_cosines=3, num_epochs=1, lam=10.0, num_classes=4, cosine_features=64,
                gamma=0.02)
    conf_j = jt.TimitConfig(**conf)
    j_train = jt.synthetic_timit(256, conf_j.num_classes, seed=1)
    j_test = jt.synthetic_timit(64, conf_j.num_classes, seed=2)
    j_pipe, _, _ = jt.run(j_train, j_test, conf_j)
    X = np.array(j_test.data.to_array())
    conf_t = tt.TimitConfig(**conf)
    scorer, _, _, _ = tt.run(tt.synthetic_timit(256, conf_t.num_classes, seed=1),
                             tt.synthetic_timit(64, conf_t.num_classes, seed=2), conf_t, CPU,
                             {}, _jax_params(conf_j))
    fitted = scorer.fit()
    got = fitted.apply(torch.from_numpy(X)).to_array()
    node = _node_dispatch(monkeypatch, lambda: fitted.apply(torch.from_numpy(X)).to_array())
    assert torch.equal(got, node)
    from keystone_tpu.nodes.learning.linear import BlockLinearMapper as JBlockMapper

    j_fitted = j_pipe.fit()
    want = np.asarray(j_fitted.apply(JDataset.of(X)).to_array())
    assert want.shape == (64,)  # the JAX predictor ends in its classifier
    mapper = next(o for o in j_fitted.graph.operators.values() if isinstance(o, JBlockMapper))
    assert mapper is not None
    sure = np.sort(got.numpy(), axis=1)
    sure = (sure[:, -1] - sure[:, -2]) > 1e-3
    np.testing.assert_array_equal(got.numpy().argmax(1)[sure], want[sure])


# ---------------------------------------------------------------------------
# The AOT round trip: a cold run exports, a warm run loads, prewarm
# ---------------------------------------------------------------------------


def test_cold_run_exports_and_warm_run_loads_zero_trace(tmp_path):
    cache = cmod.configure(str(tmp_path))
    assert cache is not None
    y_cold = _mul_chain_fitted().apply(Dataset.of(_x10())).to_array()
    (disp,) = list(segment_mod._DISPATCHERS.values())
    assert disp.traced_count == 1 and disp.loaded_count == 0
    assert manifest_mod.segment_digests(cache) == [disp.digest]
    assert manifest_mod.segment_signatures(cache, disp.digest) == [(((10, 4), "float32"),)]

    # a "new process": the dispatchers dropped, the same pipeline rebuilt
    reset_dispatchers()
    y_warm = _mul_chain_fitted().apply(Dataset.of(_x10())).to_array()
    (disp2,) = list(segment_mod._DISPATCHERS.values())
    assert disp2.digest == disp.digest
    assert disp2.loaded_count == 1 and disp2.traced_count == 0, (
        "a warm run must load the exported segment, never trace again")
    assert torch.equal(y_cold, y_warm)
    # both the trace and the load land in the compile ledger, as segments
    from keystone_tpu_torch.obs.ledger import CompileLedger

    kinds = [(r["event"], r.get("kind")) for r in
             CompileLedger.for_cache_root(cache.root).entries()]
    assert ("trace", "segment") in kinds and ("load", "segment") in kinds


def test_an_entry_holds_no_example_input(tmp_path):
    """A batch that is a view of a larger tensor (a row chunk) is not saved
    with the program: the entry stays the size of the program alone."""
    cache = cmod.configure(str(tmp_path))
    big = torch.zeros(100_000, 4)
    big[:10] = _x10()
    y = _mul_chain_fitted().apply(Dataset(big[:10])).to_array()
    torch.testing.assert_close(y, _x10() * 3.0, rtol=0, atol=0)
    ((_, nbytes, _),) = cache.entries()
    assert nbytes < big.numel() * big.element_size() // 4


def test_a_row_local_chain_exports_a_chunk_and_a_padded_tail(tmp_path, monkeypatch):
    """A row-local segment runs per row chunk: with a cache, the full chunk
    and the tail padded up the bucket ladder are the programs exported, and
    the answer is the node path's."""
    from keystone_tpu_torch.workflow import fusion

    class _RowMul(_Mul):
        row_local = True

    monkeypatch.setattr(fusion, "ROW_CHUNK", 4)
    pipe = _RowMul(2.0).and_then(_RowMul(3.0))
    fitted = FittedPipeline(pipe.graph, pipe.source, pipe.sink)
    cache = cmod.configure(str(tmp_path))
    y = fitted.apply(Dataset.of(_x10())).to_array()  # chunks of 4, 4, 2 (padded to the ladder)
    (digest,) = manifest_mod.segment_digests(cache)
    rows = sorted(sigs[0][0][0] for sigs in manifest_mod.segment_signatures(cache, digest))
    assert rows == [2, 4]  # the ladder of 4 is (1, 2, 4): the 2-row tail is a bucket
    torch.testing.assert_close(y, _x10() * 6.0, rtol=0, atol=0)
    y_node = _node_dispatch(monkeypatch, lambda: fitted.apply(Dataset.of(_x10())).to_array())
    assert torch.equal(y, y_node)


def test_prewarm_warms_manifest_indexed_segments(tmp_path, caplog):
    cache = cmod.configure(str(tmp_path))
    _mul_chain_fitted().apply(Dataset.of(_x10())).to_array()
    assert prewarm_segment_artifacts(cache) >= 1
    # a signature over the element budget is skipped, with a log line
    with caplog.at_level("INFO", logger="keystone_tpu_torch.compile.segment"):
        assert prewarm_segment_artifacts(cache, max_elements=39) == 0
    assert "skipping" in caplog.text
    # an empty cache prewarms nothing and does not fail
    assert prewarm_segment_artifacts(ExecutableCache(str(tmp_path / "e"))) == 0


def test_dispatcher_without_cache_uses_structural_jit():
    disp = SegmentDispatcher(lambda x: (x * 2.0,), "ab" * 32, None, label="t", n_nodes=2)
    torch.testing.assert_close(disp(torch.ones(2, 2))[0], torch.full((2, 2), 2.0))
    # a second signature runs the same lowered function
    torch.testing.assert_close(disp(torch.ones(3, 2))[0], torch.full((3, 2), 2.0))
    assert disp.loaded_count == 0 and disp.traced_count == 0


def test_a_tuple_input_runs_and_is_not_exported(tmp_path):
    cache = cmod.configure(str(tmp_path))
    disp = SegmentDispatcher(lambda t: (t[0] + t[1],), "cd" * 32, cache, label="t")
    out = disp((torch.ones(2, 2), torch.ones(2, 2)))
    torch.testing.assert_close(out[0], torch.full((2, 2), 2.0))
    assert disp.traced_count == 0 and cache.entries() == []


def test_manifest_segment_records_roundtrip(tmp_path):
    cache = ExecutableCache(str(tmp_path))
    digest = "c" * 64
    sigs = (((4, 3), "float32"), ((4, 1), "int32"))
    manifest_mod.record_segment(cache, digest, sigs)
    manifest_mod.record_segment(cache, digest, sigs)  # idempotent
    assert manifest_mod.segment_signatures(cache, digest) == [sigs]
    assert manifest_mod.segment_digests(cache) == [digest]
    manifest_mod.record_segment(cache, digest, (((8, 3), "float32"),))
    assert len(manifest_mod.segment_signatures(cache, digest)) == 2


# ---------------------------------------------------------------------------
# Adaptive boundaries: the demotion policy and the runtime fallback
# ---------------------------------------------------------------------------


def test_compile_exceeding_savings_demotes_unexported_segment(tmp_path):
    cost.configure(str(tmp_path), device="cpu")
    digest = "a" * 64
    assert seg_cost.should_compile(digest, 3)
    seg_cost.record_compile(digest, 1.0, exported=False, n_nodes=3)
    for _ in range(seg_cost.MIN_RUNS_FOR_DEMOTION - 1):
        seg_cost.record_run(digest, 1e-5, n_nodes=3)
    assert seg_cost.should_compile(digest, 3)  # below the evidence floor
    seg_cost.record_run(digest, 1e-5, n_nodes=3)
    assert not seg_cost.should_compile(digest, 3)
    rec = cost.get_store().load("plan/segment/" + digest[:32])
    assert rec["why"] == "compile_exceeds_savings"


def test_exported_segment_never_demotes(tmp_path):
    cost.configure(str(tmp_path), device="cpu")
    digest = "b" * 64
    seg_cost.record_compile(digest, 100.0, exported=True, n_nodes=3)
    for _ in range(seg_cost.MIN_RUNS_FOR_DEMOTION * 2):
        seg_cost.record_run(digest, 1e-6, n_nodes=3)
    # an export serves every later process: its compile is not charged to
    # this process's dispatch savings
    assert seg_cost.should_compile(digest, 3)


def test_the_demotion_records_equal_jax(tmp_path):
    """The same evidence gives the same record in both packages' stores."""
    import keystone_tpu.cost as jcost
    from keystone_tpu.cost import segments as j_seg_cost

    cost.configure(str(tmp_path / "port"), device="cpu")
    jcost.configure(str(tmp_path / "jax"))
    try:
        digest = "e" * 64
        for mod in (seg_cost, j_seg_cost):
            mod.record_compile(digest, 0.5, exported=False, n_nodes=4)
            for _ in range(mod.MIN_RUNS_FOR_DEMOTION):
                mod.record_run(digest, 0.25, n_nodes=4)
        key = "plan/segment/" + digest[:32]
        got, want = cost.get_store().load(key), jcost.get_store().load(key)
        assert got == want and got["demoted"] is True
    finally:
        jcost.reset()


def test_runtime_failure_demotes_and_next_plan_splits(tmp_path):
    cost.configure(str(tmp_path), device="cpu")
    g, _ = _two_input_graph()
    seg = _two_node_segment(g)
    binding = bind_segment(g, seg)
    assert binding is not None
    seg_cost.record_failure(binding.digest)
    assert bind_segment(g, seg) is None, (
        "a demoted digest must split back to node dispatch at plan time")


def _mul2_binding():
    pipe = _Mul(2.0).and_then(_Mul(3.0))
    fitted = FittedPipeline(pipe.graph, pipe.source, pipe.sink)
    g = _bind_source(fitted.graph, pipe.source, attach_data, Dataset.of(_x10()))
    return bind_segment(g, _two_node_segment(g))


def test_failed_dispatch_falls_back_to_exact_node_semantics():
    binding = _mul2_binding()
    assert binding is not None

    def boom(*xs):
        raise RuntimeError("synthetic trace failure")

    binding.fn = boom
    binding.digest = "f" * 64  # a fresh dispatcher, not the cached good one
    outs, path = binding.run([Dataset.of(_x10())])
    assert path == "fallback" and binding._demoted
    torch.testing.assert_close(outs[0].to_array(), _x10() * 6.0, rtol=0, atol=0)
    # later runs stay demoted without trying the broken program again
    outs2, path2 = binding.run([Dataset.of(_x10())])
    assert path2 == "fallback"
    torch.testing.assert_close(outs2[0].to_array(), _x10() * 6.0, rtol=0, atol=0)


@pytest.mark.parametrize("fault", [
    KernelError("gaussian_kernel_block launch failed: an injected fault"),
    torch.cuda.OutOfMemoryError("CUDA out of memory (an injected fault)"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["kernel_error", "out_of_memory", "cuda_error"])
def test_a_kernel_or_device_fault_in_a_segment_propagates(fault, tmp_path):
    """The deliberate divergence from the JAX package, which demotes and
    falls back on any failure: a fault of the kernel or the card ends the
    run, and the segment is neither demoted nor recorded as failed."""
    cost.configure(str(tmp_path), device="cpu")
    binding = _mul2_binding()

    def broken(*xs):
        raise fault

    binding.fn = broken
    binding.digest = "9" * 64
    with pytest.raises(type(fault)):
        binding.run([Dataset.of(_x10())])
    assert not binding._demoted
    assert seg_cost.should_compile(binding.digest, 2)
    assert cost.get_store().load("plan/segment/" + binding.digest[:32]) is None


def test_a_device_fault_in_a_pipeline_apply_propagates(monkeypatch):
    """The same through the executor: the apply raises the fault; the node
    path is not run in its place."""
    fitted = _mul_chain_fitted()
    ran = []
    real = _Mul.forward

    def forward(self, X):
        ran.append(1)
        if len(ran) == 1:
            raise KernelError("gaussian_kernel_block launch failed: an injected fault")
        return real(self, X)

    monkeypatch.setattr(_Mul, "forward", forward)
    with pytest.raises(KernelError):
        fitted.apply(Dataset.of(_x10())).to_array()
    assert ran == [1]


def test_cost_recording_is_noop_without_store():
    assert cost.get_store() is None
    digest = "d" * 64
    seg_cost.record_compile(digest, 1.0, exported=False, n_nodes=3)
    seg_cost.record_run(digest, 1.0, n_nodes=3)
    seg_cost.record_failure(digest)
    assert seg_cost.should_compile(digest, 3)
