"""The port's auto-cache rule (``keystone_tpu_torch/workflow/autocache.py``),
``AutoCachingOptimizer`` and the executor's retention table against the
JAX package's: the cases of ``tests/workflow/test_optimizer_rules.py``
(:129-262) run on both packages. The same ``Profile`` dict goes into both
rules, and the selection is deterministic given the profiles, so the
chosen Cacher sets must be equal (compared by node id: both graphs are
built in the same order).
"""

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes.util.core import Cacher as JCacher
from keystone_tpu.workflow import autocache as jac
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.graph import Graph as JGraph
from keystone_tpu.workflow.optimizers import AutoCachingOptimizer as JAutoCachingOptimizer
from keystone_tpu.workflow.pipeline import Pipeline as JPipeline
from keystone_tpu.workflow.transformer import Transformer as JTransformer
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.util.core import Cacher
from keystone_tpu_torch.ops._build import KernelError
from keystone_tpu_torch.workflow import autocache as ac
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.executor import GraphExecutor
from keystone_tpu_torch.workflow.graph import Graph
from keystone_tpu_torch.workflow.operators import DatasetOperator
from keystone_tpu_torch.workflow.optimizers import AutoCachingOptimizer, clear_memo
from keystone_tpu_torch.workflow.pipeline import Pipeline
from keystone_tpu_torch.workflow.transformer import Transformer

PKGS = {
    "torch": dict(ac=ac, Graph=Graph, Cacher=Cacher, Env=PipelineEnv,
                  Opt=AutoCachingOptimizer, Pipeline=Pipeline),
    "jax": dict(ac=jac, Graph=JGraph, Cacher=JCacher, Env=JPipelineEnv,
                Opt=JAutoCachingOptimizer, Pipeline=JPipeline),
}


@pytest.fixture(autouse=True)
def clean_env():
    import keystone_tpu_torch.cost as cost

    PipelineEnv.get_or_create().reset()
    clear_memo()
    cost.reset()
    yield
    PipelineEnv.get_or_create().reset()
    clear_memo()
    cost.reset()


class _T(Transformer):
    def __init__(self, tag):
        self.tag = tag

    def apply(self, x):
        return x


class _JT(JTransformer):
    def __init__(self, tag):
        self.tag = tag

    def apply(self, x):
        return x


def _tnode(pkg, tag):
    return (_T if pkg == "torch" else _JT)(tag)


def _diamond(pkg):
    """source -> a -> b -> (c, d) -> sink(c), sink(d): b is reused twice."""
    g = PKGS[pkg]["Graph"]()
    g, src = g.add_source()
    g, a = g.add_node(_tnode(pkg, "a"), [src])
    g, b = g.add_node(_tnode(pkg, "b"), [a])
    g, c = g.add_node(_tnode(pkg, "c"), [b])
    g, d = g.add_node(_tnode(pkg, "d"), [b])
    g, _ = g.add_sink(c)
    g, _ = g.add_sink(d)
    return g, (a, b, c, d)


def _cacher_parents(pkg, graph):
    return {graph.get_dependencies(n)[0].id for n in graph.nodes
            if isinstance(graph.get_operator(n), PKGS[pkg]["Cacher"])}


def _profiles(pkg, nodes, values):
    return {n: PKGS[pkg]["ac"].Profile(ns=ns, mem_bytes=m) for n, (ns, m) in zip(nodes, values)}


DIAMOND_PROFILES = [(1e6, 100), (5e6, 200), (1e3, 50), (1e3, 50)]


@pytest.mark.parametrize("budget, want", [(10, set()), (250, {"b"}), (10_000, {"b"})])
def test_greedy_budget_sweep_equals_jax(budget, want):
    """Below the cheapest profile nothing is cached; for one, the reused
    expensive node; a big budget still only b (once b is cached, a runs
    once, so caching it saves nothing)."""
    chosen = {}
    for pkg in PKGS:
        g, nodes = _diamond(pkg)
        rule = PKGS[pkg]["ac"].AutoCacheRule("greedy", budget,
                                             _profiles(pkg, nodes, DIAMOND_PROFILES))
        g2, _ = rule.apply(g, {})
        chosen[pkg] = _cacher_parents(pkg, g2)
        names = {"a": nodes[0].id, "b": nodes[1].id}
        assert chosen[pkg] == {names[t] for t in want}
    assert chosen["torch"] == chosen["jax"]


def test_aggressive_caches_reused_nodes_as_jax():
    chosen = {}
    for pkg in PKGS:
        g, (a, b, c, d) = _diamond(pkg)
        g2, ann = PKGS[pkg]["ac"].AutoCacheRule("aggressive").apply(g, {})
        chosen[pkg] = _cacher_parents(pkg, g2)
        assert chosen[pkg] == {b.id}
        assert ann[PKGS[pkg]["ac"].AUTOCACHE_ACTIVE] is True
    assert chosen["torch"] == chosen["jax"]


def test_insert_cachers_reroutes_consumers():
    g, (a, b, c, d) = _diamond("torch")
    g2 = ac.insert_cachers(g, [b])
    cachers = [n for n in g2.nodes if isinstance(g2.get_operator(n), Cacher)]
    assert len(cachers) == 1
    (cacher,) = cachers
    assert g2.get_dependencies(c) == (cacher,)
    assert g2.get_dependencies(d) == (cacher,)
    g3 = ac.insert_cachers(g2, [b])
    assert len([n for n in g3.nodes if isinstance(g3.get_operator(n), Cacher)]) == 1
    jg, (ja, jb, jc, jd) = _diamond("jax")
    jg2 = jac.insert_cachers(jg, [jb])
    assert sorted(n.id for n in g2.nodes) == sorted(n.id for n in jg2.nodes)
    assert {n.id: tuple(x.id for x in g2.get_dependencies(n)) for n in g2.nodes} == \
        {n.id: tuple(x.id for x in jg2.get_dependencies(n)) for n in jg2.nodes}


def test_estimate_runs_respects_weights_and_cuts_as_jax():
    for pkg in PKGS:
        g, (a, b, c, d) = _diamond(pkg)
        est = PKGS[pkg]["ac"].estimate_runs
        runs = est(g, {}, cached=set())
        assert runs[b] == 2 and runs[a] == 2
        assert est(g, {}, cached={b})[a] == 1
        assert est(g, {c: 3}, cached=set())[b] == 1 * 3 + 1


def test_insert_cachers_reuses_an_existing_cacher_for_bypass_consumers():
    for pkg in PKGS:
        g = PKGS[pkg]["Graph"]()
        g, src = g.add_source()
        g, n = g.add_node(_tnode(pkg, "n"), [src])
        g, cach = g.add_node(PKGS[pkg]["Cacher"](), [n])
        g, c = g.add_node(_tnode(pkg, "c"), [cach])
        g, e = g.add_node(_tnode(pkg, "e"), [n])
        g, _ = g.add_sink(c)
        g, _ = g.add_sink(e)
        g2 = PKGS[pkg]["ac"].insert_cachers(g, [n])
        assert len([x for x in g2.nodes
                    if isinstance(g2.get_operator(x), PKGS[pkg]["Cacher"])]) == 1
        assert g2.get_dependencies(e) == (cach,)


def test_greedy_seeds_existing_cachers_as_jax():
    for pkg in PKGS:
        g = PKGS[pkg]["Graph"]()
        g, src = g.add_source()
        g, a = g.add_node(_tnode(pkg, "a"), [src])
        g, n = g.add_node(_tnode(pkg, "n"), [a])
        g, cach = g.add_node(PKGS[pkg]["Cacher"](), [n])
        g, c = g.add_node(_tnode(pkg, "c"), [cach])
        g, d = g.add_node(_tnode(pkg, "d"), [cach])
        g, _ = g.add_sink(c)
        g, _ = g.add_sink(d)
        profiles = _profiles(pkg, (a, n), [(1e6, 10), (1e6, 10)])
        rule = PKGS[pkg]["ac"].AutoCacheRule("greedy", 1000, profiles)
        assert rule._select_greedy(g, profiles, 1000.0) == set()


def _wide(pkg):
    """leaf fans out: x -> (p, q); p -> (r, s); q -> t; r, s, t sink. The
    greedy plan has to rank several reused nodes against a budget."""
    g = PKGS[pkg]["Graph"]()
    g, src = g.add_source()
    ids = {}
    g, ids["x"] = g.add_node(_tnode(pkg, "x"), [src])
    g, ids["p"] = g.add_node(_tnode(pkg, "p"), [ids["x"]])
    g, ids["q"] = g.add_node(_tnode(pkg, "q"), [ids["x"]])
    g, ids["r"] = g.add_node(_tnode(pkg, "r"), [ids["p"]])
    g, ids["s"] = g.add_node(_tnode(pkg, "s"), [ids["p"]])
    g, ids["t"] = g.add_node(_tnode(pkg, "t"), [ids["q"]])
    for k in "rst":
        g, _ = g.add_sink(ids[k])
    return g, ids


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("budget", [150, 400, 10_000])
def test_random_profiles_choose_the_same_cachers_as_jax(seed, budget):
    """Profiles drawn from a seed with numpy, the same in both packages:
    the greedy selection is equal at every budget."""
    rng = np.random.default_rng(seed)
    values = [(float(rng.integers(1, 10**6)), float(rng.integers(10, 300))) for _ in range(6)]
    chosen = {}
    for pkg in PKGS:
        g, ids = _wide(pkg)
        profiles = _profiles(pkg, [ids[k] for k in "xpqrst"], values)
        g2, _ = PKGS[pkg]["ac"].AutoCacheRule("greedy", budget, profiles).apply(g, {})
        chosen[pkg] = _cacher_parents(pkg, g2)
    assert chosen["torch"] == chosen["jax"]


# ---- end to end: the retention table makes the budget real ----------------


class CountingNode(Transformer):
    count = 0

    def apply(self, x):
        CountingNode.count += 1
        return x

    def apply_batch(self, data):
        CountingNode.count += 1
        return Dataset.of(data)


def test_budget_zero_recomputes_across_pulls():
    env = PipelineEnv.get_or_create()
    env.set_optimizer(AutoCachingOptimizer("greedy", mem_budget_bytes=0))
    CountingNode.count = 0
    pipe = CountingNode().to_pipeline()
    X = torch.ones((4, 3))
    pipe(X).get()
    after_first = CountingNode.count
    pipe(X).get()
    assert CountingNode.count > after_first


def test_cached_node_computes_once_across_pulls():
    env = PipelineEnv.get_or_create()
    env.set_optimizer(AutoCachingOptimizer("aggressive"))
    CountingNode.count = 0
    counted = CountingNode().to_pipeline()
    branch = Pipeline.gather([counted.and_then(_T("x")), counted.and_then(_T("y"))])
    branch(torch.ones((4, 3))).get()
    # CSE merges the two counted nodes; aggressive caching puts a Cacher
    # after it; one execution in all
    assert CountingNode.count == 1


class _Count(Transformer):
    """Counts its batch applications per tag."""

    calls = {}

    def __init__(self, tag):
        self.tag = tag

    def apply_batch(self, data):
        _Count.calls[self.tag] = _Count.calls.get(self.tag, 0) + 1
        return Dataset(Dataset.of(data).payload + 1.0)

    def apply(self, x):
        return x + 1.0


def test_retention_under_autocache_recomputes_only_uncached_intermediates():
    """Under the ``autocache_active`` annotation a Cacher's result (and the
    data leaf's) outlives a pull; an uncached intermediate is recomputed
    by the next pull, whichever sink reaches it. Without the annotation
    every result is retained."""
    _Count.calls = {}
    g = Graph()
    g, leaf = g.add_node(DatasetOperator(torch.ones((4, 2))), [])
    g, u = g.add_node(_Count("uncached"), [leaf])
    g, k = g.add_node(_Count("cached"), [leaf])
    g, kc = g.add_node(Cacher(), [k])
    g, top = g.add_node(_Count("top"), [u])
    g, s_u = g.add_sink(top)
    g, s_k = g.add_sink(kc)
    g, s_both = g.add_sink(u)
    ex = GraphExecutor(g, optimize=False, parallel=False)
    ex._annotations = {ac.AUTOCACHE_ACTIVE: True}
    for _ in range(2):
        ex.execute(s_u).get()
        ex.execute(s_k).get()
    assert _Count.calls == {"uncached": 2, "top": 2, "cached": 1}
    _Count.calls = {}
    ex2 = GraphExecutor(g, optimize=False, parallel=False)
    ex2._annotations = {ac.AUTOCACHE_ACTIVE: True}
    ex2.execute(s_u).get()
    ex2.execute(s_both).get()
    assert _Count.calls["uncached"] == 2  # two pulls, nothing retained
    _Count.calls = {}
    plain = GraphExecutor(g, optimize=False, parallel=False)
    for _ in range(2):
        plain.execute(s_u).get()
        plain.execute(s_k).get()
    assert _Count.calls == {"uncached": 1, "top": 1, "cached": 1}


def test_device_budget_is_four_gib_off_the_card():
    g, _ = _diamond("torch")
    assert ac._device_budget_bytes(ac._graph_device(g)) == 4 << 30
    g2 = Graph()
    g2, _ = g2.add_node(DatasetOperator(torch.ones((3, 2))), [])
    assert ac._graph_device(g2) == torch.device("cpu")


def test_a_graph_without_data_budgets_where_the_fits_run(monkeypatch, tmp_path):
    """A graph that binds no in-memory data (a fitted pipeline's re-fit)
    is budgeted on the device the fits run on: the store's (the command
    line's ``--device``), else the card when there is one. Data on the CPU
    keeps the CPU."""
    import keystone_tpu_torch.cost as cost

    g, _ = _diamond("torch")
    data = Graph()
    data, _ = data.add_node(DatasetOperator(torch.ones((3, 2))), [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ac._graph_device(g) == torch.device("cuda")
    assert ac._graph_device(data) == torch.device("cpu")
    store = cost.configure(str(tmp_path), device="cpu")
    assert ac._graph_device(g, store) == torch.device("cpu")
    assert ac._graph_device(g, cost.ProfileStore(str(tmp_path), device="cuda")) \
        == torch.device("cuda")


class _Fails(Transformer):
    def __init__(self, error):
        self.error = error

    def apply(self, x):
        raise self.error

    def batch_transform(self, data):
        raise self.error


@pytest.mark.parametrize("error, propagates", [
    (ValueError("too few rows"), False),
    (RuntimeError("singular at sample scale"), False),
    (KernelError("gaussian_kernel_block launch failed"), True),
    (torch.cuda.OutOfMemoryError("out of memory"), True),
])
def test_a_sampled_pull_skips_the_node_but_not_a_kernel_or_device_fault(error, propagates):
    """A node that fails at sample scale goes unprofiled, as in the JAX
    package; a kernel's build or launch failure and a device fault end
    the plan."""
    g = Graph()
    g, leaf = g.add_node(DatasetOperator(torch.ones((40, 2))), [])
    g, ok = g.add_node(_T("ok"), [leaf])
    g, bad = g.add_node(_Fails(error), [ok])
    g, _ = g.add_sink(bad)
    if propagates:
        with pytest.raises(type(error)):
            ac.profile_nodes(g, full_size=40)
    else:
        profiles = ac.profile_nodes(g, full_size=40)
        assert ok in profiles and bad not in profiles


def test_auto_cached_fit_predicts_as_the_default_optimizer_and_as_jax():
    """A two-branch pipeline fitted under greedy auto-cache: predictions
    equal to the DefaultOptimizer fit's, and the JAX package's auto-cached
    fit of the same pipeline within 1e-5."""
    from keystone_tpu.nodes.learning.linear import LinearMapEstimator as JLinearMap
    from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
    from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.workflow.transformer import FunctionNode

    rng = np.random.default_rng(5)
    X = rng.normal(size=(96, 6)).astype(np.float32)
    Y = rng.normal(size=(96, 2)).astype(np.float32)

    def port_pipe():
        feat = FunctionNode(batch_fn=lambda A: torch.tanh(A) * 2.0, label="feat")
        return feat.and_then(LinearMapEstimator(lam=0.5), torch.from_numpy(X),
                             torch.from_numpy(Y))

    plain = port_pipe().fit().apply(torch.from_numpy(X)).payload
    PipelineEnv.get_or_create().reset()
    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    cached = port_pipe().fit().apply(torch.from_numpy(X)).payload
    torch.testing.assert_close(cached, plain, rtol=0, atol=0)

    import jax.numpy as jnp

    JPipelineEnv.get_or_create().set_optimizer(JAutoCachingOptimizer())
    jfeat = JFunctionNode(batch_fn=lambda A: jnp.tanh(A) * 2.0, label="feat")
    jfitted = jfeat.and_then(JLinearMap(lam=0.5), JDataset.of(X), JDataset.of(Y)).fit()
    want = np.asarray(jfitted.apply(JDataset.of(X)).to_array())
    np.testing.assert_allclose(cached.numpy(), want, rtol=1e-5, atol=1e-5)


def test_an_estimator_is_never_cached_where_jax_fails():
    """Two chained estimators under auto-cache: the first estimator's model
    feeds two delegating nodes, so the JAX package's greedy plan puts a
    Cacher after the estimator, and its fit raises (a Cacher takes
    datasets, not a fitted transformer). The port caches no estimator (the
    executor retains its model anyway) and fits as the default optimizer."""
    import jax.numpy as jnp

    from keystone_tpu.nodes.learning import LinearMapEstimator as JLinearMap
    from keystone_tpu.nodes.stats import StandardScaler as JStandardScaler
    from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
    from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.workflow.operators import EstimatorOperator
    from keystone_tpu_torch.workflow.transformer import FunctionNode

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 6)).astype(np.float32)
    Y = rng.normal(size=(200, 2)).astype(np.float32)
    JPipelineEnv.get_or_create().set_optimizer(JAutoCachingOptimizer())
    jfeat = JFunctionNode(batch_fn=lambda A: jnp.tanh(A) * 2.0, label="f1")
    jpipe = jfeat.and_then(JStandardScaler(), JDataset.of(X)).and_then(
        JLinearMap(lam=0.1), JDataset.of(X), JDataset.of(Y))
    with pytest.raises(ValueError, match="all-dataset or all-datum"):
        jpipe.fit()

    def pipe():
        feat = FunctionNode(batch_fn=lambda A: torch.tanh(A) * 2.0, label="f1")
        Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
        return feat.and_then(StandardScaler(), Xt).and_then(LinearMapEstimator(lam=0.1), Xt, Yt)

    want = pipe().fit().apply(torch.from_numpy(X)).payload
    PipelineEnv.get_or_create().reset()
    PipelineEnv.get_or_create().set_optimizer(AutoCachingOptimizer())
    p = pipe()
    graph, _ = PipelineEnv.get_or_create().optimizer.execute(p.graph)
    for n in graph.nodes:
        if isinstance(graph.get_operator(n), Cacher):
            (dep,) = graph.get_dependencies(n)
            assert not isinstance(graph.get_operator(dep), EstimatorOperator)
    got = p.fit().apply(torch.from_numpy(X)).payload
    torch.testing.assert_close(got, want, rtol=0, atol=0)
