"""The port's one-program apply against the JAX package's on the CPU
(the cases of ``tests/workflow/test_pipeline.py`` on ``trace_fn`` and
``apply_chunked``, run on both packages).

* ``compile`` / ``apply_compiled`` / ``apply_chunked`` of a small chain:
  outputs at rtol 1e-6 of JAX's, and ``compiled_signatures`` equal to
  JAX's (one signature per input shape, the chunked tail padded);
* the batch-coupled refusal, empty input, numpy input, the
  ``NotTraceableError`` blockers and the lattice verdict of each ported
  operator class, against JAX's ``classify``;
* both applications at small width, their parameters carried from a JAX
  fit by ``fitted_from_arrays``: scores at atol 1e-4 (the tolerance of
  the ``test_torch_*`` files for the same weights) and predictions equal
  on the rows JAX is sure of.

On the CPU a compiled chain runs eagerly; its CUDA graphs are held
against the eager path on the card in ``test_torch_cuda_compile.py``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.check import lattice as jlattice
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.loaders.cifar import synthetic_cifar as j_synthetic_cifar
from keystone_tpu.nodes.learning.kernel import KernelBlockLinearMapper as JMapper
from keystone_tpu.nodes.learning.linear import BlockLinearMapper as JBlockMapper
from keystone_tpu.nodes.stats.core import StandardScalerModel as JScalerModel
from keystone_tpu.pipelines import cifar_extras as jce
from keystone_tpu.pipelines import mnist_random_fft as jm
from keystone_tpu.pipelines.random_patch_cifar import learn_filters as j_learn_filters
from keystone_tpu.workflow import analysis as janalysis
from keystone_tpu.workflow import pipeline as jpipeline
from keystone_tpu.workflow import transformer as jtransformer
from keystone_tpu_torch.check import lattice
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.loaders.cifar import synthetic_cifar
from keystone_tpu_torch.pipelines import cifar_extras as tce
from keystone_tpu_torch.pipelines import mnist_random_fft as tm
from keystone_tpu_torch.workflow import analysis as tanalysis
from keystone_tpu_torch.workflow import pipeline as tpipeline
from keystone_tpu_torch.workflow import transformer as ttransformer
from keystone_tpu_torch.workflow.env import PipelineEnv

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


# ---- the same small chain in both packages ---------------------------

class JDoubler(jtransformer.Transformer):
    label = "Doubler"
    def trace_batch(self, X):
        return X * 2


class JAddOne(jtransformer.Transformer):
    label = "AddOne"
    def trace_batch(self, X):
        return X + 1


class JShift(jtransformer.Transformer):
    def __init__(self, mu):
        self.mu = mu

    def trace_batch(self, X):
        return X - self.mu


class JMeanCenter(jtransformer.Estimator):
    def fit(self, data):
        return JShift(jnp.mean(data.to_array(), axis=0))


class JBatchZScore(jtransformer.Transformer):
    label = "BatchZScore"
    batch_coupled = True

    def trace_batch(self, X):
        return (X - X.mean(axis=0)) / (X.std(axis=0) + 1e-6)


class JHostOnly(jtransformer.Transformer):
    label = "HostOnly"

    def apply(self, x):
        return x + 1.0


class JStateful(jtransformer.Transformer):
    label = "Stateful"
    check_verdict = "stateful"

    def trace_batch(self, X):
        return X


class TDoubler(ttransformer.Transformer):
    label = "Doubler"
    row_local = True

    def forward(self, X):
        return X * 2


class TAddOne(ttransformer.Transformer):
    label = "AddOne"
    row_local = True

    def forward(self, X):
        return X + 1


class TShift(ttransformer.Transformer):
    row_local = True

    def __init__(self, mu):
        self.mu = mu

    def forward(self, X):
        return X - self.mu


class TMeanCenter(ttransformer.Estimator):
    def fit(self, data):
        return TShift(data.to_array().mean(0))


class TBatchZScore(ttransformer.Transformer):
    label = "BatchZScore"
    batch_coupled = True

    def forward(self, X):
        # numpy's (population) standard deviation, as jnp.std
        return (X - X.mean(0)) / (X.std(0, unbiased=False) + 1e-6)


class THostOnly(ttransformer.Transformer):
    label = "HostOnly"

    def apply(self, x):
        return x + 1.0


class TStateful(ttransformer.Transformer):
    label = "Stateful"
    check_verdict = "stateful"

    def forward(self, X):
        return X


PACKAGES = {
    "jax": SimpleNamespace(Doubler=JDoubler, AddOne=JAddOne, MeanCenter=JMeanCenter,
                           BatchZScore=JBatchZScore, HostOnly=JHostOnly, Stateful=JStateful,
                           classify=jlattice.classify, analysis=janalysis,
                           NotTraceableError=jpipeline.NotTraceableError,
                           arr=jnp.asarray),
    "torch": SimpleNamespace(Doubler=TDoubler, AddOne=TAddOne, MeanCenter=TMeanCenter,
                             BatchZScore=TBatchZScore, HostOnly=THostOnly, Stateful=TStateful,
                             classify=lattice.classify, analysis=tanalysis,
                             NotTraceableError=tpipeline.NotTraceableError,
                             arr=torch.from_numpy),
}


def _fitted(pkg, with_add=True):
    P = PACKAGES[pkg]
    data = P.arr(np.array([[0.0, 0.0], [2.0, 2.0]], np.float32))
    head = P.Doubler() >> P.AddOne() if with_add else P.Doubler()
    return head.and_then(P.MeanCenter(), data).fit()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_one_function_chain_matches_apply_and_jax():
    """The fitted chain as one function (``trace_fn``) gives ``apply``'s
    result, and JAX's."""
    x = np.array([[1.0, 1.0], [0.5, -3.0]], np.float32)
    outs = {}
    for pkg in PACKAGES:
        fitted = _fitted(pkg)
        fn = fitted.trace_fn()
        assert fn is not None and fitted.is_traceable
        P = PACKAGES[pkg]
        got = _np(fn(P.arr(x)))
        np.testing.assert_allclose(got, _np(fitted.apply(P.arr(x)).to_array()), rtol=1e-6)
        outs[pkg] = _np(fitted.apply_compiled(P.arr(x)))
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-6)


def test_apply_chunked_matches_jax_at_any_batch_size():
    """apply_chunked pads the tail chunk and slices it off: the results
    match JAX's for sizes below, at, across and well above the chunk size,
    all through one program of one signature."""
    fitted = {pkg: _fitted(pkg) for pkg in PACKAGES}
    rng = np.random.default_rng(0)
    for n in (1, 3, 4, 7, 13):
        X = rng.standard_normal((n, 2)).astype(np.float32)
        want = np.asarray(fitted["jax"].apply_chunked(jnp.asarray(X), chunk_size=4).to_array())
        got = fitted["torch"].apply_chunked(torch.from_numpy(X), chunk_size=4).to_array()
        assert got.shape[0] == n
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(
            got.numpy(), fitted["torch"].apply(torch.from_numpy(X)).to_array().numpy(),
            rtol=1e-6)
    assert fitted["torch"].compiled_signatures == fitted["jax"].compiled_signatures \
        == [((4, 2), "float32")]
    # a new shape through apply_compiled is one more signature in both
    X = rng.standard_normal((7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        _np(fitted["torch"].apply_compiled(torch.from_numpy(X))),
        np.asarray(fitted["jax"].apply_compiled(jnp.asarray(X))), rtol=1e-6)
    assert fitted["torch"].compiled_signatures == fitted["jax"].compiled_signatures
    assert fitted["torch"].compile_count == fitted["jax"].compile_count == 2


def test_compile_calls_on_trace_once_per_signature_and_starts_anew():
    seen = []
    fitted = _fitted("torch")
    fn = fitted.compile(on_trace=seen.append)
    for n in (3, 3, 5):
        fn(torch.ones(n, 2))
    assert seen == [((3, 2), "float32"), ((5, 2), "float32")] == fitted.compiled_signatures
    fitted.compile()
    assert fitted.compiled_signatures == [] and fitted.compile_count == 0


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_apply_chunked_empty_input_matches_apply(pkg):
    P = PACKAGES[pkg]
    fitted = _fitted(pkg, with_add=False)
    empty = P.arr(np.zeros((0, 2), np.float32))
    got = _np(fitted.apply_chunked(empty, chunk_size=4).to_array())
    want = _np(fitted.apply(empty).to_array())
    assert got.shape == want.shape == (0, 2)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_apply_chunked_refuses_a_batch_coupled_chain(pkg):
    P = PACKAGES[pkg]
    fitted = (P.Doubler() >> P.BatchZScore()).to_pipeline().fit()
    assert fitted.batch_coupled_nodes() and fitted.is_traceable
    X = np.random.default_rng(0).standard_normal((5, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="batch-coupled"):
        fitted.apply_chunked(P.arr(X), chunk_size=4)
    # apply() still serves it
    assert _np(fitted.apply(P.arr(X)).to_array()).shape == (5, 2)


def test_batch_coupled_output_matches_jax():
    X = np.random.default_rng(1).standard_normal((5, 2)).astype(np.float32)
    out = {pkg: _np((P.Doubler() >> P.BatchZScore()).to_pipeline().fit()
                    .apply_compiled(P.arr(X))) for pkg, P in PACKAGES.items()}
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-5, atol=1e-6)


def test_numpy_input_matches_tensor_input():
    """Host (numpy) input takes the staged path; it must give what tensor
    input and apply() give, the padded tail included."""
    fitted = _fitted("torch")
    X = np.random.default_rng(3).standard_normal((11, 2)).astype(np.float32)
    want = fitted.apply(torch.from_numpy(X)).to_array().numpy()
    got_host = fitted.apply_chunked(X, chunk_size=4).to_array().numpy()
    got_tensor = fitted.apply_chunked(torch.from_numpy(X), chunk_size=4).to_array().numpy()
    np.testing.assert_allclose(got_host, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_host, got_tensor)
    np.testing.assert_array_equal(fitted.apply_compiled(X).numpy(), got_tensor)
    j_want = np.asarray(_fitted("jax").apply_chunked(X, chunk_size=4).to_array())
    # JAX's own tolerance for its host path
    np.testing.assert_allclose(got_host, j_want, rtol=1e-5, atol=1e-6)


def test_not_traceable_error_names_the_blockers_as_jax():
    labels = {}
    for pkg, P in PACKAGES.items():
        fitted = (P.Doubler() >> P.HostOnly() >> P.AddOne()).to_pipeline().fit()
        assert fitted.trace_fn() is None and not fitted.is_traceable
        assert fitted.compile(strict=False) is None
        with pytest.raises(P.NotTraceableError) as err:
            fitted.compile()
        labels[pkg] = err.value.labels
        assert labels[pkg] == fitted.untraceable_nodes()
    assert labels["torch"] == labels["jax"] == ["HostOnly"]
    # the labels survive pickling
    import pickle
    assert pickle.loads(pickle.dumps(tpipeline.NotTraceableError(["a", "b"]))).labels == ["a", "b"]


@pytest.mark.parametrize("name", ["Doubler", "BatchZScore", "HostOnly", "Stateful"])
def test_verdict_of_each_kind_matches_jax(name):
    verdicts = {pkg: P.classify(getattr(P, name)()) for pkg, P in PACKAGES.items()}
    assert verdicts["torch"] == verdicts["jax"]
    fitted = {pkg: (P.Doubler() >> getattr(P, name)()).to_pipeline().fit()
              for pkg, P in PACKAGES.items()}
    assert fitted["torch"].untraceable_nodes() == fitted["jax"].untraceable_nodes()


def test_register_verdict_pins_a_class():
    class Pinned(TDoubler):
        pass

    assert lattice.classify(Pinned()) == lattice.TRACEABLE
    lattice.register_verdict(Pinned, lattice.STATEFUL)
    try:
        assert lattice.classify(Pinned()) == lattice.STATEFUL
        with pytest.raises(ValueError):
            lattice.register_verdict(Pinned, "fast")
    finally:
        lattice._VERDICT_OVERRIDES.pop(Pinned)


def _verdicts(P, graph):
    return [(type(graph.get_operator(n)).__name__, P.classify(graph.get_operator(n)))
            for n in P.analysis.linearize(graph) if n in graph.operators]


# ---- both applications, their weights carried from a JAX fit ----------

CIFAR_CONF = dict(num_filters=16, lam=1.0, gamma=1e-3, block_size=64, num_epochs=1,
                  cache_kernel=False, whitener_size=2000, pool_size=8, pool_stride=7)
MNIST_CONF = dict(num_ffts=2, block_size=512, lam=10.0)


def _sure(scores, gap=1e-3):
    top2 = np.sort(scores, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > gap


@pytest.fixture(scope="module")
def cifar_fit():
    conf_j = jce.KernelCifarConfig(**CIFAR_CONF)
    j_train, j_test = j_synthetic_cifar(96, seed=7), j_synthetic_cifar(20, seed=8)
    j_pipe, _, _, _ = jce.run_random_patch_cifar_kernel(j_train, j_test, conf_j)
    j_fitted = j_pipe.fit()
    j_filters, j_whitener = j_learn_filters(j_train.data, conf_j)
    ops = list(j_fitted.graph.operators.values())
    scaler = next(o for o in ops if isinstance(o, JScalerModel))
    mapper = next(o for o in ops if isinstance(o, JMapper))
    feats = jce.Convolver(j_filters, 32, 32, 3, whitener=j_whitener, normalize_patches=True) \
        .and_then(jce.SymmetricRectifier(alpha=conf_j.alpha)) \
        .and_then(jce.Pooler(conf_j.pool_stride, conf_j.pool_size, None, "sum")) \
        .and_then(jce.ImageVectorizer())(j_test.data).get().to_array()
    params = dict(
        filters=np.asarray(j_filters), whitener=np.asarray(j_whitener.whitener),
        means=np.asarray(j_whitener.means), scaler_mean=np.asarray(scaler.mean),
        scaler_std=np.asarray(scaler.std), train_X=np.asarray(mapper.train_X),
        W=np.asarray(mapper.W), gamma=mapper.gamma, block_size=mapper.block_size,
    )
    conf_t = tce.KernelCifarConfig(**CIFAR_CONF)
    return SimpleNamespace(
        j_fitted=j_fitted, X=synthetic_cifar(20, seed=8).data.to_array(),
        j_X=j_test.data.to_array(),
        j_scores=np.asarray(mapper.trace_batch(scaler.trace_batch(jnp.asarray(feats)))),
        scores=tce.fitted_from_arrays(params, conf_t, CPU, classify=False),
        preds=tce.fitted_from_arrays(params, conf_t, CPU))


@pytest.fixture(scope="module")
def mnist_fit():
    j_train, j_test = jm.synthetic_mnist(n_train=1024, n_test=40, seed=7)
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
    return SimpleNamespace(
        j_fitted=j_fitted, X=torch.from_numpy(X), j_X=jnp.asarray(X),
        j_scores=np.asarray(mapper.trace_batch(jnp.asarray(feats))),
        scores=tm.fitted_from_arrays(params, CPU, classify=False),
        preds=tm.fitted_from_arrays(params, CPU))


@pytest.fixture(params=["cifar", "mnist"])
def app(request, cifar_fit, mnist_fit):
    return {"cifar": cifar_fit, "mnist": mnist_fit}[request.param]


def test_application_verdicts_match_jax(app):
    """The lattice verdict of every node of the fitted chain, in order, is
    JAX's: every node is traceable, KernelBlockLinearMapper (no_fuse)
    included."""
    got = _verdicts(PACKAGES["torch"], app.preds.graph)
    want = _verdicts(PACKAGES["jax"], app.j_fitted.graph)
    assert got == want
    assert {v for _, v in got} == {"traceable"}


def test_application_compiled_matches_jax(app):
    scores = app.scores
    compiled = scores.apply_compiled(app.X).numpy()
    # the eager chain's operations; 1e-5, as the card's chunked apply is
    # held: the CPU convolution may split its sums over threads otherwise
    # from one call to the next
    np.testing.assert_allclose(compiled, scores.apply(app.X).to_array().numpy(),
                               rtol=1e-5, atol=1e-5)
    # atol 1e-4: the same weights; only float32 summation orders differ
    np.testing.assert_allclose(compiled, app.j_scores, atol=1e-4)
    sure = _sure(app.j_scores)
    want = np.asarray(app.j_fitted.apply_compiled(app.j_X))
    got = app.preds.apply_compiled(app.X).numpy()
    np.testing.assert_array_equal(got[sure], want[sure])
    np.testing.assert_array_equal(want[sure], app.j_scores.argmax(1)[sure])


def test_application_chunked_matches_jax(app):
    n = app.X.shape[0]
    chunked = app.scores.apply_chunked(app.X, chunk_size=8).to_array().numpy()
    assert chunked.shape[0] == n
    np.testing.assert_allclose(chunked, app.j_scores, atol=1e-4)
    np.testing.assert_allclose(chunked, app.scores.apply(app.X).to_array().numpy(),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(app.j_fitted.apply_chunked(app.j_X, chunk_size=8).to_array())
    got = app.preds.apply_chunked(app.X.numpy(), chunk_size=8).to_array().numpy()
    sure = _sure(app.j_scores)
    np.testing.assert_array_equal(got[sure], want[sure])
    assert app.preds.compiled_signatures == app.j_fitted.compiled_signatures


# ---- the fused groups' CUDA graphs, shared by content ------------------

def _fused_op(*nodes):
    from keystone_tpu_torch.workflow.fusion import FusedTransformerOperator

    head = nodes[0].to_pipeline()
    for node in nodes[1:]:
        head = head.and_then(node)
    (op,) = head.fit().graph.operators.values()
    assert isinstance(op, FusedTransformerOperator)
    return op


def test_equal_fused_groups_share_their_graphs(monkeypatch):
    """As the JAX package shares one jitted program among fused chains of
    equal content (an LRU of 64), the port shares one set of CUDA graphs,
    per device. Building the cache touches no card: no graph is captured
    before a CUDA call."""
    import pickle

    from keystone_tpu_torch.workflow import fusion
    from keystone_tpu_torch.workflow.transformer import FunctionNode

    fusion.clear_graph_cache()
    card, other = torch.device("cuda:0"), torch.device("cuda:1")
    a = _fused_op(TDoubler(), TShift(torch.ones(2)))
    b = _fused_op(TDoubler(), TShift(torch.ones(2)))
    c = _fused_op(TDoubler(), TShift(torch.zeros(2)))
    assert a is not b and a.graphs(card) is b.graphs(card)
    assert len(a.graphs(card)) == 0
    assert c.graphs(card) is not a.graphs(card)
    assert _fused_op(TDoubler(), TShift(torch.ones(2))).graphs(other) is not a.graphs(card)
    # a step with no content form is keyed by identity: groups holding the
    # same step object share, groups holding equal-looking ones do not
    step = FunctionNode(batch_fn=lambda X: X + 1)
    d = _fused_op(TDoubler(), step)
    assert d.graphs(card) is _fused_op(TDoubler(), step).graphs(card)
    assert d.graphs(card) is not _fused_op(TDoubler(), FunctionNode(
        batch_fn=lambda X: X + 1)).graphs(card)
    assert len(fusion._FUSED_GRAPHS) == 5
    # least recently used first out
    monkeypatch.setattr(fusion, "_FUSED_GRAPHS_MAX", 2)
    _fused_op(TAddOne(), TDoubler()).graphs(card)
    assert len(fusion._FUSED_GRAPHS) == 2
    assert _fused_op(TDoubler(), TShift(torch.ones(2))).graphs(card) is not a.graphs(card)
    # graphs do not pickle: a copy builds its own
    assert pickle.loads(pickle.dumps(a))._graphs is None
    fusion.clear_graph_cache()
    assert not fusion._FUSED_GRAPHS
