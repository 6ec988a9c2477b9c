"""The port's workflow core against the JAX package's on the CPU: the cases
of ``tests/workflow/test_operators.py``, ``test_pipeline.py`` and
``test_structural_cse.py`` that the port has (laziness, chaining,
``apply_datum``, fit-once across applications and pipelines, label
estimators, gather, fit, save/load, CSE), each run on both packages with
the same numpy inputs and compared; then the port's own cases: tensors
canonicalize by content (on the card too: ``test_torch_cuda_workflow.py``),
and a numpy array fed twice is one data leaf.

Outputs are compared at atol 1e-6: the same float32 operations in two
bindings.
"""

import pickle
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keystone_tpu.workflow.expressions as jexpr
import keystone_tpu.workflow.operators as jops
import keystone_tpu_torch.workflow.expressions as texpr
import keystone_tpu_torch.workflow.operators as tops
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.workflow import pipeline as jpipeline
from keystone_tpu.workflow import rules as jrules
from keystone_tpu.workflow import transformer as jtransformer
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.workflow import pipeline as tpipeline
from keystone_tpu_torch.workflow import rules as trules
from keystone_tpu_torch.workflow import transformer as ttransformer
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline
from keystone_tpu_torch.workflow.transformer import Estimator, FunctionNode, Transformer

ATOL = 1e-6


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _package(name):
    """One package's workflow surface, with the test nodes of the JAX
    suites defined on it: ``method`` is where a node's batch function
    goes (``trace_batch`` in JAX, ``forward`` here), and ``param`` makes
    a node parameter as the package keeps it (numpy in JAX, tensors
    here). The node classes are module attributes, so they pickle."""
    if name == "jax":
        p = SimpleNamespace(
            Dataset=JDataset, arr=jnp.asarray, ops=jops, expr=jexpr, pipe=jpipeline,
            rules=jrules, tr=jtransformer, method="trace_batch",
            param=lambda a: np.asarray(a, np.float32),
            from_array=JDataset.from_array, from_items=JDataset.from_items,
            mean=lambda X: jnp.mean(X, axis=0),
            lstsq=lambda X, y: jnp.linalg.lstsq(X, y, rcond=None)[0])
    else:
        p = SimpleNamespace(
            Dataset=Dataset, arr=lambda a: torch.as_tensor(np.asarray(a, np.float32)),
            ops=tops, expr=texpr, pipe=tpipeline, rules=trules, tr=ttransformer,
            method="forward", param=lambda a: torch.as_tensor(np.asarray(a, np.float32)),
            from_array=Dataset.from_array, from_items=Dataset.from_items,
            mean=lambda X: X.mean(dim=0), lstsq=lambda X, y: torch.linalg.lstsq(X, y).solution)
    T = p.tr.Transformer

    def node(cls_name, fn, init=None):
        body = {p.method: fn, "__module__": __name__,
                "__qualname__": f"{name}_{cls_name}"}
        if init is not None:
            body["__init__"] = init
        cls = type(cls_name, (T,), body)
        globals()[cls.__qualname__] = cls
        return cls

    def set_attr(attr):
        def init(self, v):
            setattr(self, attr, v)
        return init

    p.Doubler = node("Doubler", lambda self, X: X * 2)
    p.AddOne = node("AddOne", lambda self, X: X + 1)
    p.Shift = node("Shift", lambda self, X: X - self.mu, set_attr("mu"))
    p.Scale = node("_Scale", lambda self, X: X * self.s, set_attr("s"))

    class CountingMeanCenter(p.tr.Estimator):
        def __init__(self):
            self.num_fits = 0

        def fit(self, data):
            self.num_fits += 1
            return p.Shift(p.mean(data.to_array()))

    class CountingLinear(p.tr.LabelEstimator):
        def __init__(self):
            self.num_fits = 0

        def fit(self, data, labels):
            self.num_fits += 1
            w = p.lstsq(data.to_array(), labels.to_array())
            return p.tr.FunctionNode(batch_fn=lambda A: A @ w, label="linmap")

    class CountingScaleEstimator(p.tr.LabelEstimator):
        def __init__(self, s):
            self.s = s
            self.num_fits = 0

        def fit(self, data, labels):
            self.num_fits += 1
            return p.Scale(self.s)

    class Closure(T):
        def __init__(self, fn):
            self.fn = fn

        def apply_batch(self, data):
            return p.Dataset.of(data).map_batch(self.fn)

    p.CountingMeanCenter, p.CountingLinear = CountingMeanCenter, CountingLinear
    p.CountingScaleEstimator, p.Closure = CountingScaleEstimator, Closure
    return p


PACKAGES = {name: _package(name) for name in ("jax", "torch")}


def _np(x):
    if isinstance(x, (JDataset, Dataset)):
        x = x.to_array()
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _assert_same(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        assert got == want


# ---- operators (tests/workflow/test_operators.py) ------------------------

def dataset_operator(p):
    op = p.ops.DatasetOperator(p.from_array(p.arr(np.arange(6.0).reshape(3, 2))))
    out = op.execute([])
    assert isinstance(out, p.expr.DatasetExpression)
    with pytest.raises(ValueError):
        op.execute([p.expr.DatumExpression.now(1)])
    return [len(out.get()), _np(out.get())]


def datum_operator(p):
    return [p.ops.DatumOperator(42).execute([]).get()]


def function_transformer_batch_and_single(p):
    t = p.tr.FunctionNode(batch_fn=lambda X: X * 2)
    out = t.execute([p.expr.DatasetExpression.now(p.from_array(p.arr(np.ones((4, 3)))))])
    assert isinstance(out, p.expr.DatasetExpression)
    single = t.execute([p.expr.DatumExpression.now(p.arr(np.ones(3)))])
    assert isinstance(single, p.expr.DatumExpression)
    return [_np(out.get()), _np(single.get())]


def transformer_laziness(p):
    calls = []

    def f(X):
        calls.append(1)
        return X

    expr = p.tr.FunctionNode(batch_fn=f).execute(
        [p.expr.DatasetExpression.now(p.from_array(p.arr(np.ones((2, 2)))))])
    before = list(calls)  # nothing ran yet
    expr.get()
    expr.get()
    return [before, calls]  # memoized: one call


def estimator_operator_laziness_and_memoization(p):
    fits = []

    class MeanShift(p.ops.EstimatorOperator):
        def fit(self, data):
            fits.append(1)
            mu = p.mean(data.to_array())
            return p.tr.FunctionNode(batch_fn=lambda X: X - mu)

    data = p.expr.DatasetExpression.now(p.from_array(p.arr([[1.0, 3.0], [3.0, 5.0]])))
    t = MeanShift().execute([data])
    assert isinstance(t, p.expr.TransformerExpression)
    seen = [list(fits)]
    fitted = t.get()
    t.get()
    return seen + [fits, _np(fitted.execute([data]).get())]


def delegating_operator(p):
    t = p.expr.TransformerExpression.now(p.tr.FunctionNode(batch_fn=lambda X: X + 1))
    data = p.expr.DatasetExpression.now(p.from_array(p.arr(np.zeros((2, 2)))))
    out = p.ops.DelegatingOperator().execute([t, data])
    single = p.ops.DelegatingOperator().execute([t, p.expr.DatumExpression.now(p.arr(np.zeros(2)))])
    for bad in ([data], [data, data]):
        with pytest.raises(ValueError):
            p.ops.DelegatingOperator().execute(bad)
    return [_np(out.get()), _np(single.get())]


def expression_operator_passthrough(p):
    e = p.expr.DatumExpression.now(7)
    return [p.ops.ExpressionOperator(e).execute([]) is e]


def gather_zip_batched(p):
    a = p.expr.DatasetExpression.now(p.from_array(p.arr(np.ones((3, 2)))))
    b = p.expr.DatasetExpression.now(p.from_array(p.arr(np.zeros((3, 4)))))
    out = p.ops.GatherTransformerOperator().execute([a, b]).get()
    assert out.is_batched
    return [[tuple(x.shape) for x in out.payload], _np(list(out.payload))]


def gather_single(p):
    a, b = p.expr.DatumExpression.now(1), p.expr.DatumExpression.now(2)
    return [p.ops.GatherTransformerOperator().execute([a, b]).get()]


# ---- pipelines (tests/workflow/test_pipeline.py) ----------------------

def transformer_chain_lazy_and_correct(p):
    result = p.Doubler().and_then(p.AddOne())(p.arr(np.ones((4, 3))))  # lazy
    return [_np(result.get())]


def rshift_sugar(p):
    return [_np((p.Doubler() >> p.AddOne() >> p.Doubler())(p.arr(np.ones((2, 2)))).get())]


def apply_datum(p):
    return [_np(p.Doubler().to_pipeline().apply_datum(p.arr([1.0, 2.0])).get())]


def estimator_fit_once_across_applications(p):
    est = p.CountingMeanCenter()
    data = p.from_array(p.arr([[1.0, 2.0], [3.0, 4.0]]))
    pipe = est.with_data(data)
    fits = [est.num_fits]  # lazy
    out1 = pipe(data).get()
    fits.append(est.num_fits)
    out2 = pipe(data).get()
    fits.append(est.num_fits)  # saved state reused, not refit
    return [fits, _np(out1), _np(out2)]


def estimator_fit_once_shared_between_pipelines(p):
    est = p.CountingMeanCenter()
    data = p.from_array(p.arr([[1.0, 2.0], [3.0, 4.0]]))
    est.with_data(data)(data).get()
    est.with_data(data)(data).get()
    return [est.num_fits]  # same estimator instance + same data => one fit


def chain_with_estimator_trains_on_chained_data(p):
    seen = {}

    class Probe(p.tr.Estimator):
        def fit(self, data):
            seen["data"] = _np(data.to_array())
            return p.tr.Identity()

    raw = p.arr(np.ones((2, 2)))
    out = p.Doubler().and_then(Probe(), raw)(raw).get()
    return [seen["data"], _np(out)]


def label_estimator_pipeline(p):
    X = p.arr([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [2.0, 1.0]])
    y = X @ p.arr([[1.0], [2.0]])
    est = p.CountingLinear()
    pred = est.with_data(X, y)(X).get()
    np.testing.assert_allclose(_np(pred), _np(y), atol=1e-4)
    return [est.num_fits]


def gather(p):
    out = p.pipe.Pipeline.gather([p.Doubler(), p.AddOne()])(p.arr(np.ones((3, 2)))).get()
    assert out.is_batched
    return [_np(list(out.payload))]


def fit_produces_estimator_free_pipeline(p):
    est = p.CountingMeanCenter()
    data = p.from_array(p.arr([[0.0, 0.0], [2.0, 2.0]]))
    fitted = p.Doubler().and_then(est, data).fit()
    fits = [est.num_fits]
    out = fitted.apply(p.arr([[1.0, 1.0]]))
    fits.append(est.num_fits)  # applying the fitted pipeline does not refit
    single = fitted.apply_datum(p.arr([1.0, 1.0]))
    return [fits, _np(out), _np(single)]


def estimator_free_fit(p):
    fitted = (p.Doubler() >> p.AddOne()).to_pipeline().fit()
    X = p.arr(np.arange(6.0).reshape(3, 2))
    return [_np(fitted.apply(X)), _np(fitted.apply_datum(X[0]))]


def fitted_pipeline_save_load(p, tmp_path):
    data = p.from_array(p.arr([[0.0, 0.0], [2.0, 2.0]]))
    fitted = p.Doubler().and_then(p.CountingMeanCenter(), data).fit()
    path = str(tmp_path / "pipe.pkl")
    fitted.save(path)
    loaded = p.pipe.FittedPipeline.load(path)
    return [_np(loaded.apply(p.arr([[1.0, 1.0]])))]


def common_subexpression_merged(p):
    calls = []

    def counting(X):
        calls.append(1)
        return X * 2

    shared = p.tr.FunctionNode(batch_fn=counting, label="shared")
    p.pipe.Pipeline.gather([shared.to_pipeline(), shared.to_pipeline()])(
        p.arr(np.ones((2, 2)))).get()
    return [len(calls)]


# ---- structural CSE (tests/workflow/test_structural_cse.py) ---------------

def _n_nodes(graph):
    return len(list(graph.nodes))


def structural_key_equal_for_equal_params(p):
    key = p.ops.structural_key
    a, b, c = (key(p.Shift(p.param(v))) for v in ([1.0, 2.0], [1.0, 2.0], [1.0, 2.5]))
    return [key(p.Scale(2.0)) == key(p.Scale(2.0)), key(p.Scale(2.0)) == key(p.Scale(3.0)),
            a == b, a == c]


def structural_key_closure_falls_back_to_identity(p):
    f = lambda X: X  # noqa: E731
    t1, t2 = p.Closure(f), p.Closure(f)
    return [p.ops.structural_key(t1) is t1, p.ops.structural_key(t2) is t2]


def independently_built_equal_prefixes_merge(p):
    b1 = p.Scale(2.0).and_then(p.Shift(p.param([1.0])))
    b2 = p.Scale(2.0).and_then(p.Shift(p.param([1.0])))  # separate, equal objects
    pipe = p.pipe.Pipeline.gather([b1.and_then(p.Scale(3.0)), b2.and_then(p.Scale(5.0))])
    before = _n_nodes(pipe.graph)
    graph, _ = p.rules.EquivalentNodeMergeRule().apply(pipe.graph, {})
    X = p.arr(np.ones((2, 3)))
    out = p.pipe.Pipeline(graph, pipe.source, pipe.sink)(X).get()
    # the two-node equal prefix merged; the distinct tails did not
    return [before - _n_nodes(graph), _np(list(out.payload))]


def unequal_params_do_not_merge(p):
    pipe = p.pipe.Pipeline.gather([p.Scale(2.0), p.Scale(2.0000001)])
    graph, _ = p.rules.EquivalentNodeMergeRule().apply(pipe.graph, {})
    return [_n_nodes(pipe.graph) - _n_nodes(graph)]


def closure_nodes_do_not_merge(p):
    f = lambda X: X * 2.0  # noqa: E731
    pipe = p.pipe.Pipeline.gather([p.Closure(f), p.Closure(f)])
    graph, _ = p.rules.EquivalentNodeMergeRule().apply(pipe.graph, {})
    return [_n_nodes(pipe.graph) - _n_nodes(graph)]


def equal_estimators_fit_once_after_merge(p):
    X = np.arange(12, dtype=np.float32).reshape(4, 3)
    data, labels = p.Dataset.of(p.arr(X)), p.Dataset.of(p.arr(np.ones((4, 1))))
    e1, e2 = p.CountingScaleEstimator(2.0), p.CountingScaleEstimator(2.0)
    pipe = p.pipe.Pipeline.gather([p.Scale(1.0).and_then(e1, data, labels),
                                   p.Scale(1.0).and_then(e2, data, labels)])
    out = pipe(p.arr(X)).get()
    # exactly one of the two estimator objects fit, exactly once
    return [_np(list(out.payload)), e1.num_fits + e2.num_fits]


CASES = [
    dataset_operator, datum_operator, function_transformer_batch_and_single,
    transformer_laziness, estimator_operator_laziness_and_memoization, delegating_operator,
    expression_operator_passthrough, gather_zip_batched, gather_single,
    transformer_chain_lazy_and_correct, rshift_sugar, apply_datum,
    estimator_fit_once_across_applications, estimator_fit_once_shared_between_pipelines,
    chain_with_estimator_trains_on_chained_data, label_estimator_pipeline, gather,
    fit_produces_estimator_free_pipeline, estimator_free_fit, fitted_pipeline_save_load,
    common_subexpression_merged, structural_key_equal_for_equal_params,
    structural_key_closure_falls_back_to_identity, independently_built_equal_prefixes_merge,
    unequal_params_do_not_merge, closure_nodes_do_not_merge,
    equal_estimators_fit_once_after_merge,
]

#: what the JAX suites assert of each case (the ports' results must equal
#: the JAX package's, and both these)
EXPECTED = {
    datum_operator: [42],
    transformer_laziness: [[], [1]],
    estimator_fit_once_across_applications: [0, 1, 1],
    estimator_fit_once_shared_between_pipelines: [1],
    label_estimator_pipeline: [1],
    common_subexpression_merged: [1],
    structural_key_equal_for_equal_params: [True, False, True, False],
    structural_key_closure_falls_back_to_identity: [True, True],
    unequal_params_do_not_merge: [0],
    closure_nodes_do_not_merge: [0],
}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_workflow_case_matches_jax(case, tmp_path):
    args = (tmp_path,) if case is fitted_pipeline_save_load else ()
    want = case(PACKAGES["jax"], *args)
    PipelineEnv.get_or_create().reset()
    got = case(PACKAGES["torch"], *args)
    _assert_same(got, want)
    if case in EXPECTED:
        head = got[0] if case is estimator_fit_once_across_applications else got
        assert head == EXPECTED[case]


def test_fit_once_and_fused_values_of_the_examples():
    """The JAX suites' literal values, on the port: the fitted center of a
    doubled dataset is zero, a chained estimator sees the chained data, and
    an equal prefix merges two nodes."""
    p = PACKAGES["torch"]
    _, out, single = fit_produces_estimator_free_pipeline(p)
    np.testing.assert_allclose(out, 0.0)
    np.testing.assert_allclose(single, 0.0)
    seen, _ = chain_with_estimator_trains_on_chained_data(p)
    np.testing.assert_allclose(seen, 2.0)
    merged, outs = independently_built_equal_prefixes_merge(p)
    assert merged == 2
    np.testing.assert_allclose(outs[0], (np.ones((2, 3)) * 2 - 1) * 3)


# ---- the port's own cases ------------------------------------------------

def test_tensors_canonicalize_by_content():
    key = tops.structural_key
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    node = PACKAGES["torch"].Shift(a)
    assert key(node) == key(PACKAGES["torch"].Shift(a.clone()))
    assert key(node) != key(PACKAGES["torch"].Shift(a.double()))  # dtype counts
    assert key(node) != key(PACKAGES["torch"].Shift(a.reshape(3, 2)))  # shape counts
    assert key(node) != key(PACKAGES["torch"].Shift(a + 1))
    # a view digests its own elements, not its base's
    assert key(PACKAGES["torch"].Shift(a[:, 1])) == key(PACKAGES["torch"].Shift(a[:, 1].clone()))
    # the digest is kept per tensor until the tensor is written in place
    before = key(node)
    a.add_(1)
    assert key(node) != before
    assert key(node) == key(PACKAGES["torch"].Shift(a.clone()))


def test_equal_tensor_parameters_merge_in_a_gather():
    Shift = PACKAGES["torch"].Shift
    pipe = Pipeline.gather([Shift(torch.ones(3)), Shift(torch.ones(3)), Shift(torch.zeros(3))])
    graph, _ = trules.EquivalentNodeMergeRule().apply(pipe.graph, {})
    assert len(graph.nodes) == len(pipe.graph.nodes) - 1


def test_a_numpy_array_fed_twice_is_one_leaf():
    """``Dataset.of(ndarray)`` makes a fresh tensor on each call; the leaf
    is keyed by the array the caller passed, so applying a pipeline to the
    same array twice, or fitting two pipelines on it, fits once."""
    X = np.arange(8, dtype=np.float32).reshape(4, 2)
    est, double = PACKAGES["torch"].CountingMeanCenter(), PACKAGES["torch"].Doubler()
    pipe = double.and_then(est, X)
    first = pipe(X).get().to_array()
    second = pipe(X).get().to_array()
    double.and_then(est, X).fit()
    assert est.num_fits == 1
    torch.testing.assert_close(first, second)
    assert tops.DatasetOperator(X) == tops.DatasetOperator(X)
    assert tops.DatasetOperator(X) != tops.DatasetOperator(X.copy())
    # a Dataset is keyed by its payload, as in the JAX package
    ds = Dataset.of(X)
    assert tops.DatasetOperator(ds) == tops.DatasetOperator(Dataset(ds.payload))


def test_item_list_dataset():
    items = [torch.ones(2), torch.zeros(3)]
    ds = Dataset.of(items)
    assert not ds.is_batched and len(ds) == 2 and ds.first() is items[0]
    assert [t.shape[0] for t in ds.map(lambda t: t * 2)] == [2, 3]  # ragged stays a list
    stacked = Dataset.from_items([torch.ones(2), torch.zeros(2)]).map(lambda t: t + 1)
    assert stacked.is_batched and stacked.to_array().shape == (2, 2)
    zipped = Dataset.of(torch.arange(3.0)).zip(Dataset.from_items(["a", "b", "c"]))
    assert [(float(x), s) for x, s in zipped] == [(0.0, "a"), (1.0, "b"), (2.0, "c")]
    assert Dataset.of((torch.ones(3, 2), torch.zeros(3))).collect()[1][1].item() == 0.0
    cached = ds.cache()
    assert cached.collect() == items and cached.payload is not ds.payload
    with pytest.raises(ValueError, match="different lengths"):
        ds.zip(Dataset.of(torch.ones(3)))
    # a transformer maps an item list item by item
    out = FunctionNode(batch_fn=lambda X: X + 1).apply_batch(ds)
    assert [t.tolist() for t in out] == [[2.0, 2.0], [1.0, 1.0, 1.0]]


def test_fit_keeps_timings_and_frees_its_executor_state():
    class Mean(Estimator):
        def fit(self, data):
            return PACKAGES["torch"].Shift(data.to_array().mean(0))

    X = torch.randn(6, 3)
    fitted = PACKAGES["torch"].Doubler().and_then(Mean(), X).fit()
    assert {"optimize", "featurize", "Mean", "executor"} <= set(fitted.seconds)
    assert all(v >= 0.0 for v in fitted.seconds.values())
    torch.testing.assert_close(fitted.apply(X).to_array(), 2 * X - (2 * X).mean(0))
    # the fitted graph holds transformers only, and pickles
    clone = pickle.loads(pickle.dumps(fitted))
    assert isinstance(clone, FittedPipeline)
    assert all(isinstance(op, tops.TransformerOperator) for op in clone.graph.operators.values())


def test_transformer_apply_of_one_item():
    class Split(Transformer):
        row_local = True

        def forward(self, X):
            return X[:, :1], X[:, 1:]

    class Join(Transformer):
        def forward(self, parts):
            return torch.cat(parts, dim=-1)

    x = torch.tensor([1.0, 2.0, 3.0])
    first, rest = Split().apply(x)
    assert first.tolist() == [1.0] and rest.tolist() == [2.0, 3.0]
    assert Join().apply([first, rest]).tolist() == [1.0, 2.0, 3.0]
    with pytest.raises(NotImplementedError):
        Transformer().apply(x)
