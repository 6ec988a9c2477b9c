"""The port's trace fusion against the JAX package's on the CPU.

* The cases of ``tests/workflow/test_fusion.py`` that the port has, run on
  both packages: the same groups (step labels) and the same outputs.
* Fused against unfused output of the MnistRandomFFT featurizer, at atol
  1e-5 (the same float32 operations, in another grouping).
* A fused row-local group run in row chunks against the whole batch, with
  ``ROW_CHUNK`` set to 7: a group that ends in a tuple-producing gather,
  and one that ends in a combiner (1e-6 · row max: an FFT of fewer rows may
  take another plan).
* Plan parity: for MnistRandomFFT at 3 FFTs and the RandomPatchCifarKernel
  chain at its small configuration, ``DefaultOptimizer`` gives the same
  plan in both packages — node count, operator class names in
  ``linearize`` order, fused groups and edges — for the fit graph and for
  the fitted pipeline's graph.
"""

import pickle
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.loaders.cifar import synthetic_cifar as j_synthetic_cifar
from keystone_tpu.nodes.learning.kernel import KernelRidgeRegression as JKRR
from keystone_tpu.nodes.learning.linear import BlockLeastSquaresEstimator as JBlockLS
from keystone_tpu.nodes.stats import StandardScaler as JScaler
from keystone_tpu.nodes.util import ClassLabelIndicators as JCLI
from keystone_tpu.nodes.util import MaxClassifier as JMax
from keystone_tpu.nodes.util import VectorCombiner as JCombiner
from keystone_tpu.pipelines import cifar_extras as jce
from keystone_tpu.pipelines import mnist_random_fft as jm
from keystone_tpu.pipelines.random_patch_cifar import learn_filters as j_learn_filters
from keystone_tpu.workflow import analysis as janalysis
from keystone_tpu.workflow import fusion as jfusion
from keystone_tpu.workflow import graph as jgraph
from keystone_tpu.workflow import pipeline as jpipeline
from keystone_tpu.workflow import rules as jrules
from keystone_tpu.workflow import transformer as jtransformer
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.expressions import DatasetExpression as JDatasetExpression
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.loaders.cifar import synthetic_cifar
from keystone_tpu_torch.nodes.learning.kernel import KernelRidgeRegression
from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.stats import LinearRectifier, PaddedFFT, RandomSignNode
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier, VectorCombiner
from keystone_tpu_torch.pipelines import cifar_extras as tce
from keystone_tpu_torch.pipelines import mnist_random_fft as tm
from keystone_tpu_torch.pipelines.random_patch_cifar import learn_filters
from keystone_tpu_torch.workflow import analysis as tanalysis
from keystone_tpu_torch.workflow import fusion as tfusion
from keystone_tpu_torch.workflow import graph as tgraph
from keystone_tpu_torch.workflow import pipeline as tpipeline
from keystone_tpu_torch.workflow import rules as trules
from keystone_tpu_torch.workflow import transformer as ttransformer
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.expressions import DatasetExpression
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


class JMul(jtransformer.Transformer):
    label = "Mul"

    def __init__(self, k):
        self.k = k

    def trace_batch(self, X):
        return X * self.k


class TMul(ttransformer.Transformer):
    label = "Mul"
    row_local = True

    def __init__(self, k):
        self.k = k

    def forward(self, X):
        return X * self.k


class JHostOnly(jtransformer.Transformer):
    """No trace_batch — a fusion boundary."""

    label = "HostOnly"

    def apply(self, x):
        return x + 1.0


class THostOnly(ttransformer.Transformer):
    """No forward — a fusion boundary."""

    label = "HostOnly"

    def apply(self, x):
        return x + 1.0


PACKAGES = {
    "jax": SimpleNamespace(Mul=JMul, HostOnly=JHostOnly, Pipeline=jpipeline.Pipeline,
                           Graph=jgraph.Graph, Dataset=JDataset, fusion=jfusion, rules=jrules,
                           Combiner=JCombiner, DatasetExpression=JDatasetExpression,
                           arr=jnp.asarray),
    "torch": SimpleNamespace(Mul=TMul, HostOnly=THostOnly, Pipeline=tpipeline.Pipeline,
                             Graph=tgraph.Graph, Dataset=Dataset, fusion=tfusion, rules=trules,
                             Combiner=VectorCombiner, DatasetExpression=DatasetExpression,
                             arr=torch.as_tensor),
}


def _np(x):
    if isinstance(x, (JDataset, Dataset)):
        x = x.payload if x.is_batched and isinstance(x.payload, tuple) else x.to_array()
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _fused_ops(p, graph):
    return [graph.get_operator(n) for n in sorted(graph.nodes)
            if isinstance(graph.get_operator(n), p.fusion.FusedTransformerOperator)]


def _groups(p, graph):
    return [[op.label for op, _ in f.steps] for f in _fused_ops(p, graph)]


def _run(p, graph, pipe, X):
    return _np(p.Pipeline(graph, pipe.source, pipe.sink)(X).get())


# ---- the cases of tests/workflow/test_fusion.py -----------------------

def linear_chain_fuses_to_one_node_with_same_output(p):
    pipe = p.Mul(2.0).and_then(p.Mul(3.0)).and_then(p.Mul(0.5))
    g, _ = p.fusion.TraceFusionRule().apply(pipe.graph, {})
    X = np.arange(6, dtype=np.float32).reshape(2, 3)
    return [_groups(p, g), len(g.nodes), _run(p, g, pipe, X)]


def host_node_bounds_groups(p):
    pipe = p.Mul(2.0).and_then(p.Mul(3.0)).and_then(p.HostOnly()).and_then(p.Mul(4.0))
    g, _ = p.fusion.TraceFusionRule().apply(pipe.graph, {})
    # the upstream pair fuses; the single node after the host boundary stays bare
    return [_groups(p, g), _run(p, g, pipe, np.ones((2, 2), np.float32))]


def _diamond(p, second_branch):
    shared = p.Mul(2.0)
    b1 = shared.and_then(p.Mul(3.0)).and_then(p.Mul(5.0))
    pipe = p.Pipeline.gather([b1, second_branch(shared)])
    graph, _ = p.rules.EquivalentNodeMergeRule().apply(pipe.graph, {})
    g, _ = p.fusion.TraceFusionRule().apply(graph, {})
    return shared, pipe, g


def diamond_with_all_consumers_traceable_fuses_whole(p):
    _, pipe, g = _diamond(p, lambda s: s.and_then(p.Mul(7.0)).and_then(p.Mul(11.0)))
    return [_groups(p, g), _run(p, g, pipe, np.ones((2, 2), np.float32))]


def node_with_consumer_outside_group_not_absorbed(p):
    shared, pipe, g = _diamond(p, lambda s: s.and_then(p.HostOnly()))
    for op in _fused_ops(p, g):
        assert shared not in [s[0] for s in op.steps]
    return [_groups(p, g), _run(p, g, pipe, np.ones((2, 2), np.float32))]


def sink_consumed_interior_node_not_absorbed(p):
    graph = p.Graph()
    graph, source = graph.add_source()
    graph, na = graph.add_node(p.Mul(2.0), [source])
    graph, nb = graph.add_node(p.Mul(3.0), [na])
    graph, _ = graph.add_sink(na)
    graph, _ = graph.add_sink(nb)
    g, _ = p.fusion.TraceFusionRule().apply(graph, {})
    return [_groups(p, g)]  # na is sink-consumed: nothing fuses


def annotated_node_not_fused(p):
    pipe = p.Mul(2.0).and_then(p.Mul(3.0))
    first = sorted(pipe.graph.nodes)[0]
    g, ann = p.fusion.TraceFusionRule().apply(pipe.graph, {first: "prefix"})
    return [_groups(p, g), ann == {first: "prefix"}]


def item_dataset_fallback_matches_batched(p):
    pipe = p.Mul(2.0).and_then(p.Mul(3.0))
    g, _ = p.fusion.TraceFusionRule().apply(pipe.graph, {})
    (fused,) = _fused_ops(p, g)
    ragged = p.Dataset.from_items([p.arr(np.ones((2,), np.float32)),
                                   p.arr(np.zeros((3,), np.float32))])
    out = fused.batch_transform([p.DatasetExpression.now(ragged)]).collect()
    return [_np(list(out))]


def fused_single_datum_path(p):
    pipe = p.Mul(2.0).and_then(p.Mul(3.0))
    g, _ = p.fusion.TraceFusionRule().apply(pipe.graph, {})
    out = p.Pipeline(g, pipe.source, pipe.sink).apply_datum(p.arr(np.ones(3, np.float32)))
    return [_np(out.get())]


def gather_and_combiner_fuse_and_agree(p):
    pipe = p.Pipeline.gather([p.Mul(float(i + 1)) for i in range(3)]).and_then(p.Combiner())
    g, _ = p.fusion.TraceFusionRule().apply(pipe.graph, {})
    # 3 muls + gather + combiner
    return [[len(s) for s in _groups(p, g)], _run(p, g, pipe, np.ones((2, 2), np.float32))]


def fusion_idempotent_and_picklable(p):
    pipe = p.Mul(2.0).and_then(p.Mul(3.0))
    g1, _ = p.fusion.TraceFusionRule().apply(pipe.graph, {})
    g2, _ = p.fusion.TraceFusionRule().apply(g1, {})
    (fused,) = _fused_ops(p, g1)
    clone = pickle.loads(pickle.dumps(fused))
    return [_groups(p, g2), [op.label for op, _ in clone.steps]]


def no_fuse_marker_respected(p):
    marked = p.Mul(3.0)
    marked.no_fuse = True
    pipe = p.Mul(2.0).and_then(marked).and_then(p.Mul(4.0))
    g, _ = p.fusion.TraceFusionRule().apply(pipe.graph, {})
    for op in _fused_ops(p, g):
        assert marked not in [s[0] for s in op.steps]
    return [_groups(p, g)]


CASES = [linear_chain_fuses_to_one_node_with_same_output, host_node_bounds_groups,
         diamond_with_all_consumers_traceable_fuses_whole,
         node_with_consumer_outside_group_not_absorbed, sink_consumed_interior_node_not_absorbed,
         annotated_node_not_fused, item_dataset_fallback_matches_batched,
         fused_single_datum_path, gather_and_combiner_fuse_and_agree,
         fusion_idempotent_and_picklable, no_fuse_marker_respected]


def _assert_same(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, atol=1e-6)
    else:
        assert got == want


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_fusion_case_matches_jax(case):
    want = case(PACKAGES["jax"])
    got = case(PACKAGES["torch"])
    _assert_same(got, want)


def test_fusion_case_values():
    """The JAX suite's literal expectations, on the port."""
    p = PACKAGES["torch"]
    groups, n_nodes, out = linear_chain_fuses_to_one_node_with_same_output(p)
    assert len(groups) == 1 and len(groups[0]) == 3 and n_nodes == 1
    np.testing.assert_allclose(out, np.arange(6).reshape(2, 3) * 3.0)
    groups, out = host_node_bounds_groups(p)
    assert [len(g) for g in groups] == [2]
    np.testing.assert_allclose(out, (np.ones((2, 2)) * 6.0 + 1.0) * 4.0)
    groups, outs = diamond_with_all_consumers_traceable_fuses_whole(p)
    assert len(groups) == 1
    np.testing.assert_allclose(outs[0], 30.0)
    np.testing.assert_allclose(outs[1], 154.0)
    assert sink_consumed_interior_node_not_absorbed(p) == [[]]
    assert annotated_node_not_fused(p) == [[], True]
    ones, zeros = item_dataset_fallback_matches_batched(p)[0]
    np.testing.assert_allclose(ones, 6.0)
    np.testing.assert_allclose(zeros, np.zeros(3))
    np.testing.assert_allclose(fused_single_datum_path(p)[0], 6.0)
    sizes, out = gather_and_combiner_fuse_and_agree(p)
    assert sizes == [5]
    np.testing.assert_allclose(out, np.concatenate([np.ones((2, 2)) * k for k in (1, 2, 3)], 1))
    assert [len(g) for g in fusion_idempotent_and_picklable(p)[0]] == [2]


# ---- fused against unfused, chunked against whole -----------------------

def _x(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _close_to_row_max(got, want, tol):
    scale = np.abs(want).max(axis=-1, keepdims=True, initial=1.0)
    assert np.all(np.abs(got - want) <= tol * scale), np.abs(got - want).max()


def test_fused_featurizer_matches_unfused():
    feat = tm.build_featurizer(tm.MnistRandomFFTConfig(num_ffts=3, seed=2), CPU)
    X = torch.from_numpy(_x(40, 784, seed=3))
    fused = feat.fit()
    assert [len(g) for g in _groups(PACKAGES["torch"], fused.graph)] == [3 * 3 + 2]
    # a FittedPipeline applies its graph as it is: here, unoptimized
    unfused = FittedPipeline(feat.graph, feat.source, feat.sink)
    assert not _fused_ops(PACKAGES["torch"], unfused.graph)
    np.testing.assert_allclose(fused.apply(X).to_array().numpy(),
                               unfused.apply(X).to_array().numpy(), atol=1e-5)


def _branches(n=2):
    return [RandomSignNode(RandomSignNode.create(784, seed=i, device="cpu").signs)
            .and_then(PaddedFFT()).and_then(LinearRectifier(0.0)) for i in range(n)]


@pytest.mark.parametrize("tail", ["gather", "combiner"])
def test_chunked_fused_group_matches_whole(monkeypatch, tail):
    pipe = Pipeline.gather(_branches())
    if tail == "combiner":
        pipe = pipe.and_then(VectorCombiner())
    fitted = pipe.fit()
    (op,) = fitted.graph.operators.values()
    assert isinstance(op, tfusion.FusedTransformerOperator) and op.row_local
    X = torch.from_numpy(_x(50, 784, seed=4))
    whole = fitted.apply(X).to_array()
    calls = []
    forward = tfusion.FusedTransformerOperator.forward
    monkeypatch.setattr(tfusion.FusedTransformerOperator, "forward",
                        lambda self, *xs: calls.append(xs[0].shape[0]) or forward(self, *xs))
    monkeypatch.setattr(tfusion, "ROW_CHUNK", 7)
    chunked = fitted.apply(X).to_array()
    assert calls == [7] * 7 + [1]
    if tail == "gather":
        assert isinstance(chunked, tuple) and len(chunked) == 2
    else:
        chunked, whole = (chunked,), (whole,)
    for a, b in zip(chunked, whole):
        assert a.shape == b.shape
        _close_to_row_max(a.numpy(), b.numpy(), tol=1e-6)


def test_a_group_that_is_not_row_local_runs_whole(monkeypatch):
    class BatchCentre(ttransformer.Transformer):
        def forward(self, X):
            return X - X.mean(0)

    fitted = TMul(2.0).and_then(BatchCentre()).fit()
    (op,) = fitted.graph.operators.values()
    assert not op.row_local
    monkeypatch.setattr(tfusion, "ROW_CHUNK", 3)
    X = torch.arange(20.0).reshape(10, 2)
    torch.testing.assert_close(fitted.apply(X).to_array(), 2 * X - (2 * X).mean(0))


@pytest.mark.parametrize("row_local", [True, False])
def test_an_unfused_node_runs_in_row_chunks_when_row_local(monkeypatch, row_local):
    """A node no group took (here the only node; in the applications the
    model fitted after fusion) runs in row chunks when it is row-local,
    as a fused group would, and whole otherwise."""
    calls = []

    class Recorded(TMul):
        def forward(self, X):
            calls.append(X.shape[0])
            return X * self.k

    node = Recorded(3.0)
    node.row_local = row_local
    fitted = node.to_pipeline().fit()
    assert [type(op) for op in fitted.graph.operators.values()] == [Recorded]
    monkeypatch.setattr(tfusion, "ROW_CHUNK", 7)
    X = torch.arange(40.0).reshape(20, 2)
    torch.testing.assert_close(fitted.apply(X).to_array(), 3.0 * X, rtol=0, atol=0)
    assert calls == ([7, 7, 6] if row_local else [20])


def test_fused_forward_drops_each_intermediate_after_its_last_use():
    """A chunk holds the live intermediates only: after a step, every value
    that no later step reads is released."""
    pipe = Pipeline.gather([TMul(2.0).and_then(TMul(3.0)), TMul(5.0)]).and_then(VectorCombiner())
    fitted = pipe.fit()
    (op,) = fitted.graph.operators.values()
    for k, (_, deps) in enumerate(op.steps):
        for i in deps:
            assert op.last_use[i] >= k
    # the input is read by two steps; each intermediate by exactly one
    reads = [sum(i in deps for _, deps in op.steps) for i in range(op.n_inputs + len(op.steps))]
    assert reads[0] == 2 and reads[-1] == 0
    X = torch.ones(3, 2)
    torch.testing.assert_close(fitted.apply(X).to_array(),
                               torch.cat([X * 6.0, X * 5.0], dim=1))


# ---- plan parity with the JAX package ---------------------------------

def _plan(analysis, fusion, graph):
    """A graph as plain data, in ``linearize`` order: each node's operator
    class, its fused group's step labels, and its dependencies as
    positions in that order (sources as "source")."""
    order = [g for g in analysis.linearize(graph) if g in graph.operators]
    pos = {g: i for i, g in enumerate(order)}
    rows = []
    for g in order:
        op = graph.get_operator(g)
        steps = ([s.label for s, _ in op.steps]
                 if isinstance(op, fusion.FusedTransformerOperator) else None)
        rows.append((type(op).__name__, steps,
                     tuple(pos.get(d, "source") for d in graph.get_dependencies(g))))
    return len(order), rows


def _assert_same_plans(j_pipe, t_pipe):
    jg, _ = JPipelineEnv.get_or_create().optimizer.execute(j_pipe.graph)
    tg, _ = PipelineEnv.get_or_create().optimizer.execute(t_pipe.graph)
    want, got = _plan(janalysis, jfusion, jg), _plan(tanalysis, tfusion, tg)
    assert got == want
    j_fitted, t_fitted = j_pipe.fit(), t_pipe.fit()
    want_fitted = _plan(janalysis, jfusion, j_fitted.graph)
    assert _plan(tanalysis, tfusion, t_fitted.graph) == want_fitted
    return want, want_fitted


def test_mnist_plan_matches_jax():
    conf = dict(num_ffts=3, block_size=512, lam=10.0)
    j_train, _ = jm.synthetic_mnist(n_train=256, n_test=8, seed=7)
    j_labels = JCLI(10).apply_batch(j_train.labels)
    j_pipe = jm.build_featurizer(jm.MnistRandomFFTConfig(**conf)).and_then(
        JBlockLS(512, 1, 10.0), j_train.data, j_labels).and_then(JMax())
    X = torch.from_numpy(np.array(j_train.data.to_array()))
    labels = ClassLabelIndicators(10).forward(torch.from_numpy(np.array(j_train.labels.to_array())))
    signs = np.stack([np.array(jm.RandomSignNode.create(784, seed=i).signs) for i in range(3)])
    t_pipe = tm.build_featurizer(tm.MnistRandomFFTConfig(**conf), CPU, signs=signs).and_then(
        BlockLeastSquaresEstimator(512, 1, 10.0), X, labels).and_then(MaxClassifier())
    (n, rows), (_, fitted_rows) = _assert_same_plans(j_pipe, t_pipe)
    # the fit graph: two fused featurizer copies (fit data, source)
    fused = [steps for _, steps, _ in rows if steps]
    assert [len(s) for s in fused] == [11, 11]
    assert fused[0][:3] == ["RandomSignNode", "PaddedFFT", "LinearRectifier"]
    assert fused[0][-2:] == ["GatherTransformerOperator", "VectorCombiner"]
    assert [cls for cls, _, _ in fitted_rows] == [
        "FusedTransformerOperator", "BlockLinearMapper", "MaxClassifier"]


def test_cifar_plan_matches_jax():
    conf = dict(num_filters=16, lam=1.0, gamma=1e-3, block_size=64, num_epochs=1,
                cache_kernel=False, whitener_size=2000, pool_size=8, pool_stride=7)
    conf_j, conf_t = jce.KernelCifarConfig(**conf), tce.KernelCifarConfig(**conf)
    j_train = j_synthetic_cifar(96, seed=7)
    t_train = synthetic_cifar(96, seed=7)
    j_filters, j_whitener = j_learn_filters(j_train.data, conf_j)
    j_labels = JCLI(10).apply_batch(j_train.labels)
    j_pipe = (
        jce.Convolver(j_filters, 32, 32, 3, whitener=j_whitener, normalize_patches=True)
        .and_then(jce.SymmetricRectifier(alpha=conf_j.alpha))
        .and_then(jce.Pooler(conf_j.pool_stride, conf_j.pool_size, None, "sum"))
        .and_then(jce.ImageVectorizer())
        .and_then(JScaler(), j_train.data)
        .and_then(JKRR(conf_j.gamma, conf_j.lam, conf_j.block_size, conf_j.num_epochs,
                       block_permuter=conf_j.seed, cache_kernel=False), j_train.data, j_labels)
        .and_then(JMax())
    )
    X = t_train.data.to_array()
    labels = ClassLabelIndicators(10).forward(t_train.labels.to_array())
    filters, whitener = learn_filters(X, conf_t)
    t_pipe = tce.conv_featurizer(filters, whitener, conf_t).and_then(StandardScaler(), X).and_then(
        KernelRidgeRegression(conf_t.gamma, conf_t.lam, conf_t.block_size, conf_t.num_epochs,
                              block_permuter=conf_t.seed, cache_kernel=False), X, labels
    ).and_then(MaxClassifier())
    (_, rows), (_, fitted_rows) = _assert_same_plans(j_pipe, t_pipe)
    featurizer = ["Convolver", "SymmetricRectifier", "Pooler", "ImageVectorizer"]
    # one featurized copy of the fit data feeds both estimators; the source has its own
    assert [steps for _, steps, _ in rows if steps] == [featurizer, featurizer]
    assert [cls for cls, _, _ in rows].count("DatasetOperator") == 2  # data, labels
    assert [cls for cls, _, _ in fitted_rows] == [
        "FusedTransformerOperator", "StandardScalerModel", "KernelBlockLinearMapper",
        "MaxClassifier"]


# ---- row chunks bounded by bytes ------------------------------------------

class _Widen(ttransformer.Transformer):
    """Row-local: each (d,) row becomes ``width`` copies of itself, with a
    declared temporary of the same size (a wide-row node, as SIFT is)."""

    row_local = True

    def __init__(self, width):
        self.width = width

    def forward(self, X):
        return X.repeat(1, self.width) * 2.0

    def row_work_bytes(self, x):
        return 2 * 4 * x.shape[1] * self.width


def test_a_group_of_wide_rows_is_chunked_under_the_byte_budget(monkeypatch):
    """Rows of 12 MB (3 M floats): the chunk is cut to the budget, far
    under ROW_CHUNK, and the chunked output equals the unchunked run."""
    fitted = _Widen(3 * 2 ** 20 // 8).and_then(TMul(0.5)).fit()
    (op,) = fitted.graph.operators.values()
    assert isinstance(op, tfusion.FusedTransformerOperator) and op.row_local
    X = torch.from_numpy(_x(9, 8, seed=2))
    row = op.row_bytes([X])
    assert row >= 2 * 12 * 2 ** 20  # the widened row with its temporary, then beside the output
    monkeypatch.setattr(tfusion, "CHUNK_BYTES", 4 * row)
    assert op.chunk_rows([X]) == 4
    calls = []
    forward = tfusion.FusedTransformerOperator.forward
    monkeypatch.setattr(tfusion.FusedTransformerOperator, "forward",
                        lambda self, *xs: calls.append(xs[0].shape[0]) or forward(self, *xs))
    chunked = fitted.apply(X).to_array()
    assert calls == [4, 4, 1]
    torch.testing.assert_close(chunked, X.repeat(1, 3 * 2 ** 20 // 8), rtol=0, atol=0)
    # a chunk's live bytes stay under the budget
    assert 4 * row <= tfusion.CHUNK_BYTES


def test_the_cifar_and_mnist_chunk_plans_are_unchanged():
    """At full width both fused featurizers keep ROW_CHUNK rows a chunk:
    CIFAR's 100 filters on 32² images (0.87 MB a row alive) and MNIST's 200
    FFT branches (0.82 MB)."""
    conf = tce.KernelCifarConfig()
    filters = torch.from_numpy(_x(100, 108, seed=3))
    cifar = tce.conv_featurizer(filters, None, conf).fit()
    mnist = tm.build_featurizer(tm.MnistRandomFFTConfig(num_ffts=200), "cpu").fit()
    for fitted, X in ((cifar, torch.zeros(5, 32, 32, 3)), (mnist, torch.zeros(5, 784))):
        (op,) = fitted.graph.operators.values()
        assert isinstance(op, tfusion.FusedTransformerOperator)
        assert op.row_bytes([X]) * tfusion.ROW_CHUNK <= tfusion.CHUNK_BYTES
        assert op.chunk_rows([X]) == tfusion.ROW_CHUNK == 2500
    assert [op.label for op, _ in next(iter(cifar.graph.operators.values())).steps] == [
        "Convolver", "SymmetricRectifier", "Pooler", "ImageVectorizer"]


def test_chunk_signatures_are_one_per_chunk_shape(monkeypatch):
    """The callable a group's chunks go through on CUDA (its graph cache)
    sees one input signature per chunk shape: the full chunk and the tail."""
    from keystone_tpu_torch.workflow.cuda_graph import signature

    fitted = _Widen(1000).and_then(TMul(3.0)).fit()
    (op,) = fitted.graph.operators.values()
    X = torch.from_numpy(_x(23, 6, seed=5))
    monkeypatch.setattr(tfusion, "CHUNK_BYTES", 5 * op.row_bytes([X]))
    rows = op.chunk_rows([X])
    seen = []

    def graphs(*xs):
        seen.append(signature(xs))
        return op.forward(*xs)

    out = tfusion.forward_in_row_chunks(graphs, [X], 23, rows)
    assert rows == 5 and len(seen) == 5 and len(set(seen)) == 2
    assert set(seen) == {(((5, 6), "float32"),), (((3, 6), "float32"),)}
    torch.testing.assert_close(out, op.forward(X), rtol=0, atol=0)


def test_an_unfused_wide_row_node_is_chunked_by_its_declared_bytes(monkeypatch):
    node = _Widen(64)
    fitted = node.to_pipeline().fit()
    X = torch.from_numpy(_x(10, 4, seed=6))
    per_row = 4 * 4 + node.row_work_bytes(X[:1])
    monkeypatch.setattr(tfusion, "CHUNK_BYTES", 3 * per_row)
    calls = []
    forward = _Widen.forward
    monkeypatch.setattr(_Widen, "forward", lambda self, X: calls.append(X.shape[0]) or forward(self, X))
    torch.testing.assert_close(fitted.apply(X).to_array(), X.repeat(1, 64) * 2.0, rtol=0, atol=0)
    assert calls == [3, 3, 3, 1]
