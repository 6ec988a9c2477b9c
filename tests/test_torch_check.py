"""The port's static checker against the JAX package's on the CPU: every
case of ``tests/check/test_static_check.py`` runs through both packages on
the same numpy inputs, and the two runs must agree on the outcome (pass or
raise), the node and label named, and the specs.

A spec is compared as its per-item shape and dtype, with one known
difference: an argmax index is int64 in the port and int32 in the JAX
package (both are compared as "int").

The JAX package's host-callback cases (``jax.pure_callback`` in a
``trace_batch``) are held to the port's host-sync markers (``.cpu()``,
``.item()`` in a ``forward``). Both give the verdict ``host_callback``;
the pinned divergence is what it means: in the port a host sync cannot be
captured into a CUDA graph, so it blocks compilation, where the JAX
package jits it and refuses only export.

The rest of the file holds the port's own additions: K1's abstract form
on fake CUDA tensors (zero launches; this CPU build fakes CUDA tensors
without a card), a forward that needs concrete values, the constant
caches a check must not fill with fake tensors, and the command line's
``--check``. A check of a chain whose parameters are on the card is in
``test_torch_cuda_check.py``.
"""

import functools
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import keystone_tpu.check as jcheck
import keystone_tpu.cost as jcost
import keystone_tpu_torch.check as tcheck
import keystone_tpu_torch.cost as tcost
from keystone_tpu.data.chunked import ChunkedDataset as JChunked
from keystone_tpu.nodes.learning import linear as jlinear
from keystone_tpu.nodes.nlp.hashing import HashingTF as JHashingTF
from keystone_tpu.nodes import stats as jstats
from keystone_tpu.nodes import util as jutil
from keystone_tpu.nodes.util import core as jutil_core
from keystone_tpu.obs import tracer as jtracer
from keystone_tpu.workflow import fusion as jfusion
from keystone_tpu.workflow import pipeline as jpipeline
from keystone_tpu.workflow import transformer as jtransformer
from keystone_tpu_torch.data.chunked import ChunkedDataset as TChunked
from keystone_tpu_torch.nodes.learning import linear as tlinear
from keystone_tpu_torch.nodes.nlp.hashing import HashingTF as THashingTF
from keystone_tpu_torch.nodes import stats as tstats
from keystone_tpu_torch.nodes import util as tutil
from keystone_tpu_torch.nodes.util import core as tutil_core
from keystone_tpu_torch.obs import tracer as ttracer
from keystone_tpu_torch.workflow import fusion as tfusion
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


def _jax_cli(argv):
    from keystone_tpu.__main__ import main

    return main(["mnist", "--backend", "cpu", *argv])


def _torch_cli(argv):
    from keystone_tpu_torch.__main__ import main

    return main(["MnistRandomFFT", "--device", "cpu", *argv])


def _jax_sync_body():
    """A batch function that routes through a host callback (JAX)."""
    import jax

    def body(X):
        return jax.pure_callback(functools.partial(lambda a: a),
                                 jax.ShapeDtypeStruct(X.shape, X.dtype), X)

    return body


def _torch_sync_body():
    """A batch function with a host sync (the port)."""

    def body(X):
        return torch.as_tensor(X.cpu().numpy(), device=X.device)

    return body


J = SimpleNamespace(
    name="jax", check=jcheck, cost=jcost, Chunked=JChunked, linear=jlinear, stats=jstats,
    util=jutil, util_core=jutil_core, tracer=jtracer, Fused=jfusion.FusedTransformerOperator,
    Pipeline=jpipeline.Pipeline, FunctionNode=jtransformer.FunctionNode,
    Identity=jtransformer.Identity, HashingTF=JHashingTF,
    sign=lambda d, seed: jstats.RandomSignNode.create(d, seed=seed),
    labels=lambda k, y: jutil.ClassLabelIndicators(k).apply_batch(y),
    mean0=lambda X: X - X.mean(axis=0), sync_body=_jax_sync_body, cli=_jax_cli,
)
T = SimpleNamespace(
    name="torch", check=tcheck, cost=tcost, Chunked=TChunked, linear=tlinear, stats=tstats,
    util=tutil, util_core=tutil_core, tracer=ttracer, Fused=tfusion.FusedTransformerOperator,
    Pipeline=tpipeline.Pipeline, FunctionNode=ttransformer.FunctionNode,
    Identity=ttransformer.Identity, HashingTF=THashingTF,
    sign=lambda d, seed: tstats.RandomSignNode.create(d, seed=seed, device=CPU),
    labels=lambda k, y: tutil.ClassLabelIndicators(k).apply_batch(torch.from_numpy(y)),
    mean0=lambda X: X - X.mean(dim=0), sync_body=_torch_sync_body, cli=_torch_cli,
)


def _item(spec):
    """A spec as comparable plain data: per-item shape and dtype (an
    integer dtype as "int"), tuples element by element."""
    if spec is None:
        return None
    if hasattr(spec, "elems"):
        return ("tuple", tuple(_item(e) for e in spec.elems))
    dtype = "int" if "int" in spec.dtype else spec.dtype
    return (tuple(spec.item_shape), dtype, bool(spec.sym))


def _raises(fn):
    """(exception class name, node as a string, label) of what ``fn``
    raises, or None when it returns."""
    try:
        fn()
    except Exception as e:  # the outcome is what the case compares
        return (type(e).__name__, None if getattr(e, "node", None) is None else str(e.node),
                getattr(e, "label", None))
    return None


def _small_pipe(P, d=32, k=4, n=64, est=None):
    X = np.random.RandomState(0).randn(n, d).astype(np.float32)
    y = P.labels(k, np.random.RandomState(1).randint(0, k, size=n))
    est = est or P.linear.LinearMapEstimator(lam=1.0)
    return P.sign(d, 0).and_then(est, X, y).and_then(P.util.MaxClassifier())


def _coupled_identity(P):
    class Coupled(P.Identity):
        batch_coupled = True

    return Coupled


def _coupled_mean(P):
    class Coupled(P.Identity):
        batch_coupled = True

    if P is J:
        Coupled.trace_batch = lambda self, X: X - X.mean(axis=0)
    else:
        Coupled.forward = lambda self, X: X - X.mean(dim=0)
    return Coupled


# ---------------------------------------------------------------------------
# the cases of tests/check/test_static_check.py, one function each
# ---------------------------------------------------------------------------


def case_pure_node_traceable(P):
    return [P.check.classify(P.stats.LinearRectifier(0.0)), P.check.classify(P.stats.PaddedFFT())]


def case_host_node_opaque(P):
    return P.check.classify(P.HashingTF(64))


def case_callback_detected_statically(P):
    node = P.FunctionNode(batch_fn=P.sync_body())
    verdict = P.check.classify(node)
    return verdict, P.check.blocks_jit(verdict)


def case_callback_detected_through_closure_helper(P):
    helper = P.sync_body()

    def body(X):
        return helper(X) * 2.0

    return P.check.classify(P.FunctionNode(batch_fn=body))


def case_shared_code_object_distinct_closures(P):
    sync_helper = P.sync_body()

    def pure_helper(X):
        return X * 2.0

    def make(f):
        return P.FunctionNode(batch_fn=lambda X: f(X), label="made")

    return [P.check.classify(make(pure_helper)), P.check.classify(make(sync_helper)),
            P.check.classify(make(sync_helper)), P.check.classify(make(pure_helper))]


def case_batch_coupled_verdict_and_instance_mutation(P):
    node = P.Identity()
    node.batch_coupled = True
    return P.check.classify(_coupled_identity(P)()), P.check.classify(node)


def case_stateful_mutation_detected(P):
    class Sneaky(P.Identity):
        def trace_batch(self, X):
            self.count = getattr(self, "count", 0) + 1
            return X

        def forward(self, X):
            self.count = getattr(self, "count", 0) + 1
            return X

    return P.check.classify(Sneaky())


def case_explicit_verdict_pin(P):
    class Pinned(P.Identity):
        check_verdict = P.check.STATEFUL

    return P.check.classify(Pinned())


def case_fused_chain_is_worst_of_steps(P):
    fused = P.Fused([(P.Identity(), (0,)), (P.stats.LinearRectifier(0.0), (1,))], 1)
    fused2 = P.Fused([(P.Identity(), (0,)), (_coupled_identity(P)(), (1,))], 1)
    return P.check.classify(fused), P.check.classify(fused2)


def case_specs_propagate_from_array_leaf_to_sink(P):
    pipe = _small_pipe(P, d=16, k=3)
    rep = P.check.check_graph(pipe.graph, source=pipe.source, datum_spec=((16,), "float32"))
    return _item(rep.sink_spec), rep.summary()["verdicts"], rep.segment_count


def case_gather_produces_tuple_spec_and_combiner_concats(P):
    branches = [P.sign(8, i).and_then(P.stats.LinearRectifier(0.0)) for i in range(3)]
    pipe = P.Pipeline.gather(branches).and_then(P.util.VectorCombiner())
    rep = P.check.check_graph(pipe.graph, source=pipe.source, datum_spec=((8,), "float32"))
    return _item(rep.sink_spec), rep.segment_count, sorted(rep.barriers.values())


def case_chunked_leaf_carries_item_spec_without_production(P):
    produced = []

    def chunk(i):
        produced.append(i)
        return np.zeros((16, 8), np.float32)

    ds = P.Chunked.from_chunk_fn(chunk, 4, 64)
    ds._item_spec = ((8,), "float32")
    pipe = P.Identity().and_then(P.linear.LinearMapEstimator(lam=1.0), ds,
                                 np.zeros((64, 2), np.float32))
    rep = P.check.check_graph(pipe.graph, source=pipe.source, datum_spec=((8,), "float32"))
    assert produced == []
    return _item(rep.sink_spec)


def case_from_array_records_item_spec(P):
    return P.Chunked.from_array(np.zeros((100, 7), np.float32), 32).item_spec


def case_shape_mismatch_raises_node_attributed_at_and_then(P):
    produced = []

    def chunk(i):
        produced.append(i)
        return np.zeros((16, 100), np.float32)

    ds = P.Chunked.from_chunk_fn(chunk, 4, 64)
    ds._item_spec = ((100,), "float32")
    feat = P.sign(784, 0).and_then(P.stats.PaddedFFT()).and_then(P.stats.LinearRectifier(0.0))
    out = _raises(lambda: feat.and_then(P.linear.BlockLeastSquaresEstimator(512, 1, 1.0), ds,
                                        np.zeros((64, 10), np.float32)))
    assert produced == []
    return out


def case_dtype_weaker_than_shape_does_not_false_positive(P):
    X = np.random.RandomState(0).randn(32, 16).astype(np.float64)
    y = P.labels(3, np.random.RandomState(1).randint(0, 3, size=32))
    return _raises(lambda: P.sign(16, 0).and_then(P.linear.LinearMapEstimator(lam=1.0), X, y))


def case_batch_coupled_on_chunked_stream_raises(P):
    ds = P.Chunked.from_array(np.zeros((64, 8), np.float32), 16)
    return _raises(lambda: _coupled_mean(P)().and_then(
        P.linear.LinearMapEstimator(lam=1.0), ds, np.zeros((64, 2), np.float32)))


def case_cacher_materializes_chunked_stream_for_coupled_node(P):
    ds = P.Chunked.from_array(np.zeros((64, 8), np.float32), 16)
    pipe = (P.util.Cacher().and_then(_coupled_mean(P)())
            .and_then(P.linear.LinearMapEstimator(lam=1.0), ds, np.zeros((64, 2), np.float32)))
    return _raises(lambda: P.check.check_graph(pipe.graph, source=pipe.source))


def case_out_spec_declaration_consumed(P):
    pipe = P.util_core.MultiClassLabelIndicators(7).to_pipeline()
    return _item(P.check.check_graph(pipe.graph, source=pipe.source).sink_spec)


def case_vector_splitter_declares_tuple_spec(P):
    pipe = P.util_core.VectorSplitter(3).to_pipeline()
    rep = P.check.check_graph(pipe.graph, source=pipe.source, datum_spec=((8,), "float32"))
    return _item(rep.sink_spec)


def case_standard_scaler_fitted_out_spec_preserves(P):
    X = np.random.RandomState(0).randn(32, 12).astype(np.float32)
    pipe = P.Identity().and_then(P.stats.StandardScaler(), X).and_then(P.util.MaxClassifier())
    rep = P.check.check_graph(pipe.graph, source=pipe.source, datum_spec=((12,), "float32"))
    return _item(rep.sink_spec)


def case_segment_plan_splits_at_cacher_and_estimator(P):
    pipe = _small_pipe(P, d=16, k=3)
    rep = P.check.check_graph(pipe.graph, source=pipe.source, datum_spec=((16,), "float32"))
    frep = pipe.fit().check(span=False)
    capped = (P.sign(16, 0).and_then(P.util.Cacher()).and_then(P.stats.LinearRectifier(0.0))
              .to_pipeline())
    crep = P.check.check_graph(capped.graph, source=capped.source, datum_spec=((16,), "float32"))
    return (rep.segment_count, sorted(rep.barriers.values()), frep.segment_count,
            crep.segment_count, sorted(crep.barriers.values()))


def case_segment_bytes_priced_from_specs(P):
    pipe = P.sign(16, 0).and_then(P.stats.LinearRectifier(0.0)).to_pipeline()
    rep = P.check.check_graph(pipe.graph, source=pipe.source, datum_spec=((16,), "float32"))
    (seg,) = rep.segments
    return seg.est_item_bytes, len(seg.nodes), len(seg.inputs), len(seg.outputs)


def case_check_executes_zero_samples(P):
    P.cost.reset_sampling()
    pipe = _small_pipe(P, d=16, k=3)
    pipe.check(span=False)
    pipe.fit()
    P.cost.reset_sampling()
    pipe.check(span=False)
    return P.cost.sampling_executions()["total"]


def case_kill_switch_disables_implicit_checks(P, monkeypatch):
    monkeypatch.setenv("KEYSTONE_STATIC_CHECK", "0")
    ds = P.Chunked.from_chunk_fn(lambda i: np.zeros((16, 100), np.float32), 4, 64)
    ds._item_spec = ((100,), "float32")
    feat = P.sign(784, 0).and_then(P.stats.PaddedFFT())
    pipe = feat.and_then(P.linear.BlockLeastSquaresEstimator(512, 1, 1.0), ds,
                         np.zeros((64, 10), np.float32))
    return _raises(lambda: pipe.check(span=False))


def case_fit_entry_raises_before_any_chunk(P):
    produced = []

    def chunk(i):
        produced.append(i)
        return np.zeros((16, 100), np.float32)

    ds = P.Chunked.from_chunk_fn(chunk, 4, 64)
    feat = P.sign(784, 0).and_then(P.stats.PaddedFFT())
    pipe = feat.and_then(P.linear.BlockLeastSquaresEstimator(512, 1, 1.0), ds,
                         np.zeros((64, 10), np.float32))
    ds._item_spec = ((100,), "float32")
    out = _raises(pipe.fit)
    assert produced == []
    return out


def case_check_report_span_emitted(P):
    t = P.tracer.Tracer()
    installed = P.tracer.install(t)
    try:
        _small_pipe(P, d=16, k=3).check()
        (sp,) = [s for s in t.spans() if s.name == "check.report"]
        return sp.attrs["segments"] >= 2, sp.attrs["sampling_total"], sp.attrs["nodes"]
    finally:
        P.tracer.uninstall(installed)


def case_check_only_mode_via_cli(P, capsys):
    rc = P.cli(["--numFFTs", "1", "--blockSize", "256", "--lambda", "10", "--check"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("CHECK OK"))
    return rc, line, "static check report" in out, P.check.check_only_mode()


def case_swap_contract_mismatch_is_typed(P):
    rep = _small_pipe(P, d=16, k=3).fit().check(span=False)
    return (_raises(lambda: rep.require_contract((8,), "float32", verb="swap")),
            _raises(lambda: rep.require_contract((16,), "float64", verb="swap")),
            _raises(lambda: rep.require_contract((16,), "float32", verb="swap")))


def case_swap_contract_batch_coupled_names_node(P):
    fitted = _small_pipe(P, d=16, k=3).fit()
    node = next(iter(fitted.graph.nodes))
    fitted.graph.get_operator(node).batch_coupled = True
    rep = fitted.check(span=False)
    return _raises(lambda: rep.require_contract(None, None, verb="swap"))


def case_coupling_refused_even_with_worse_lattice_trait(P):
    body = P.sync_body()
    node = P.FunctionNode(batch_fn=lambda X: P.mean0(body(X)), label="coupled_callback")
    node.batch_coupled = True
    verdict = P.check.classify(node)
    rep = node.to_pipeline().fit().check(span=False)
    return (verdict, rep.batch_coupled_labels(),
            _raises(lambda: rep.require_contract(None, None, verb="serve")))


def case_worker_boot_contract_validation(P):
    rep = _small_pipe(P, d=16, k=3).fit().check(span=False)
    with pytest.raises(P.check.ContractMismatchError, match="boot"):
        rep.require_contract((99,), "float32", verb="boot")
    return _raises(lambda: rep.require_contract((99,), "float32", verb="boot"))


def case_check_error_pickles_with_attribution(P):
    e = P.check.PipelineCheckError("bad spec", node="node[3]", label="PaddedFFT")
    e2 = pickle.loads(pickle.dumps(e))
    return e2.node, e2.label, str(e2) == str(e), str(e2)


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}

#: the pinned divergence: a host sync blocks compilation in the port
HOST_SYNC_BLOCKS = {"callback_detected_statically": (("host_callback", False),
                                                     ("host_callback", True))}


@pytest.mark.parametrize("name", sorted(CASES))
def test_static_check_case_agrees_with_jax(name, request):
    fn = CASES[name]
    extra = [request.getfixturevalue(a) for a in fn.__code__.co_varnames[1:fn.__code__.co_argcount]]
    want = fn(J, *extra)
    PipelineEnv.get_or_create().reset()
    got = fn(T, *extra)
    if name in HOST_SYNC_BLOCKS:
        assert (want, got) == HOST_SYNC_BLOCKS[name]
    else:
        assert got == want


def test_there_are_32_cases():
    assert len(CASES) == 32


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------


def test_a_host_sync_blocks_compile_where_jax_only_refuses_export():
    """The pinned divergence, end to end: the JAX package compiles a chain
    with a host callback and refuses only its export; the port refuses to
    compile a chain with a host sync and names the node."""
    j_fitted = jtransformer.FunctionNode(batch_fn=_jax_sync_body(), label="sync").to_pipeline().fit()
    j_rep = j_fitted.check(span=False)
    assert j_rep.jit_compilable and not j_rep.exportable
    assert j_fitted.compile(cache=None) is not None
    t_fitted = ttransformer.FunctionNode(batch_fn=_torch_sync_body(), label="sync") \
        .to_pipeline().fit()
    t_rep = t_fitted.check(span=False)
    assert not t_rep.jit_compilable and not t_rep.exportable
    with pytest.raises(tpipeline.NotTraceableError) as ei:
        t_fitted.compile()
    assert ei.value.labels == ["sync"]
    # an eager apply still runs it
    got = t_fitted.apply(torch.ones(3, 2)).to_array()
    assert torch.equal(got, torch.ones(3, 2))


def test_k1_abstract_form_launches_nothing_on_fake_cuda_tensors():
    """K1 under the checker's fake mode: fake CUDA tensors in, an empty
    (n, b) float32 fake tensor out, no launch counted and none recorded
    for a capture (this CPU build fakes CUDA tensors without a card)."""
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

    from keystone_tpu_torch.ops import gaussian_kernel as gk

    before = (gk.gaussian_kernel_block.launches, gk.captured_launches())
    with FakeTensorMode(allow_non_fake_inputs=True):
        X = torch.empty(11939, 800, device="cuda")
        Xb = torch.empty(5000, 800, device="cuda")
        out = gk.gaussian_kernel_block(X, Xb, 2e-4)
    assert is_fake(out) and tuple(out.shape) == (11939, 5000)
    assert out.dtype == torch.float32 and out.device.type == "cuda"
    assert (gk.gaussian_kernel_block.launches, gk.captured_launches()) == before


def test_a_forward_needing_concrete_values_is_unknown_not_an_error():
    """``.item()`` or a data-dependent shape under fake tensors: the spec is
    unknown and the node opaque; an ordinary rejection on known inputs is
    an error."""
    nz = ttransformer.FunctionNode(batch_fn=lambda X: X[torch.nonzero(X[:, 0])[:, 0]],
                                   label="nonzero")
    pipe = nz.to_pipeline()
    values, verdicts = tcheck.infer_specs(pipe.graph, {pipe.source: tcheck.spec_from_item(
        ((4,), "float32"))})
    (node,) = pipe.graph.nodes
    assert values[node] is None and verdicts[node] == tcheck.OPAQUE
    bad = ttransformer.FunctionNode(batch_fn=lambda X: X @ torch.ones(5, 2), label="bad")
    with pytest.raises(tcheck.PipelineCheckError, match="bad"):
        tcheck.check_graph(bad.to_pipeline().graph, source=bad.to_pipeline().source,
                           datum_spec=((4,), "float32"))


def test_a_check_leaves_the_constant_caches_real():
    """A node whose forward builds cached constants (SIFT's smoothing taps)
    checked and then applied: the apply reads real constants, not a fake
    tensor cached by the check."""
    from keystone_tpu_torch.nodes.images.sift import SIFTExtractor

    sift = SIFTExtractor(step=8, num_scales=1)
    pipe = sift.to_pipeline()
    tcheck.check_graph(pipe.graph, source=pipe.source, datum_spec=((32, 32, 1), "float32"))
    X = torch.from_numpy(np.random.default_rng(0).random((2, 32, 32, 1), dtype=np.float32))
    out = sift.forward(X)
    assert torch.isfinite(out).all() and out.abs().sum() > 0


@pytest.mark.parametrize("app,args", [
    ("RandomPatchCifarKernel", ["--nTrain", "64", "--nTest", "16", "--numFilters", "8",
                                "--blockSize", "32", "--poolSize", "8", "--poolStride", "7"]),
    ("StupidBackoffPipeline", []),
])
def test_check_flag_stops_each_application_at_its_first_fit(app, args, capsys):
    from keystone_tpu_torch import __main__ as cli
    from keystone_tpu_torch.ops import gaussian_kernel as gk

    tcost.reset_sampling()
    k1 = gk.gaussian_kernel_block.launches
    device = [] if app == "StupidBackoffPipeline" else ["--device", "cpu"]
    out = cli.run([app, *device, *args, "--check"])
    assert isinstance(out["check_report"], tcheck.CheckReport)
    assert "CHECK OK" in capsys.readouterr().out
    assert tcost.sampling_executions()["total"] == 0
    assert gk.gaussian_kernel_block.launches == k1
    assert not tcheck.check_only_mode()


def test_pipeline_to_dot_names_the_nodes():
    pipe = tstats.RandomSignNode.create(4, seed=0, device=CPU).and_then(tutil.MaxClassifier())
    dot = pipe.to_dot("p")
    assert dot.startswith("digraph p {") and "RandomSignNode" in dot and "MaxClassifier" in dot
