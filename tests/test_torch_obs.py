"""The port's tracer, span export, audit, scan spans and observability
configuration (``keystone_tpu_torch/obs/``, ``utils/obs.py``) against the
JAX package's: the cases of ``tests/workflow/test_tracing.py`` and
``tests/workflow/test_obs.py`` on the port, and the same graphs traced in
both packages with equal span trees (name, operator type and cache hit or
miss per node, and parent links), equal exported keys and equal audit
sums. Times are not compared between the packages: only structure.
"""

import json
import logging
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.obs import tracer as jtrace
from keystone_tpu.obs.audit import cache_audit as jcache_audit
from keystone_tpu.obs.audit import observed_by_node as jobserved
from keystone_tpu.obs.export import to_chrome_trace as jto_chrome
from keystone_tpu.workflow.autocache import AutoCacheRule as JAutoCacheRule
from keystone_tpu.workflow.autocache import Profile as JProfile
from keystone_tpu.workflow.executor import GraphExecutor as JExecutor
from keystone_tpu.workflow.graph import Graph as JGraph
from keystone_tpu.workflow.operators import DatasetOperator as JDatasetOperator
from keystone_tpu.workflow.transformer import Transformer as JTransformer
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.obs import tracer as trace_mod
from keystone_tpu_torch.obs.audit import cache_audit, log_cache_audit, observed_by_node
from keystone_tpu_torch.obs.export import format_top_spans, to_chrome_trace, write_chrome_trace
from keystone_tpu_torch.utils import obs, timing
from keystone_tpu_torch.workflow.autocache import AutoCacheRule, Profile, profile_nodes
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.executor import GraphExecutor
from keystone_tpu_torch.workflow.graph import Graph
from keystone_tpu_torch.workflow.operators import DatasetOperator
from keystone_tpu_torch.workflow.optimizers import clear_memo
from keystone_tpu_torch.workflow.transformer import FunctionNode, Transformer


@pytest.fixture(autouse=True)
def clean():
    """No tracer, optimizer or memo leaks across tests, in either package."""
    import keystone_tpu_torch.cost as cost

    for reset in (trace_mod.reset, jtrace.reset, cost.reset, clear_memo,
                  PipelineEnv.get_or_create().reset):
        reset()
    yield
    for reset in (trace_mod.reset, jtrace.reset, cost.reset, clear_memo,
                  PipelineEnv.get_or_create().reset):
        reset()


def _installed():
    return trace_mod.install(trace_mod.Tracer())


class _Scale(Transformer):
    def __init__(self, factor):
        self.factor = factor

    def apply(self, x):
        return x * self.factor


class _JScale(JTransformer):
    def __init__(self, factor):
        self.factor = factor

    def apply(self, x):
        return x * self.factor


def _chain(G, D, DS, S, batched_kw):
    """leaf -> scale 2 -> scale 3 -> sink, in one package's classes."""
    g = G()
    g, leaf = g.add_node(D(DS(np.ones((4, 2), np.float32), **batched_kw)), [])
    g, n1 = g.add_node(S(2.0), [leaf])
    g, n2 = g.add_node(S(3.0), [n1])
    g, sink = g.add_sink(n2)
    return g, (leaf, n1, n2), sink


def _chain_graph():
    return _chain(Graph, DatasetOperator, lambda a: Dataset(torch.from_numpy(a)), _Scale, {})


def _jchain_graph():
    return _chain(JGraph, JDatasetOperator, JDataset, _JScale, {"batched": True})


def _reused(G, D, DS, S, kw):
    """leaf -> a -> b -> (c, d): b is consumed twice."""
    g = G()
    g, leaf = g.add_node(D(DS(np.ones((4, 2), np.float32), **kw)), [])
    g, a = g.add_node(S(2.0), [leaf])
    g, b = g.add_node(S(3.0), [a])
    g, c = g.add_node(S(4.0), [b])
    g, d = g.add_node(S(5.0), [b])
    g, s1 = g.add_sink(c)
    g, s2 = g.add_sink(d)
    return g, (a, b, c, d), (s1, s2)


def _reused_dag():
    return _reused(Graph, DatasetOperator, lambda a: Dataset(torch.from_numpy(a)), _Scale, {})


def _jreused_dag():
    return _reused(JGraph, JDatasetOperator, JDataset, _JScale, {"batched": True})


def _tree(spans):
    """The span tree as comparable rows: (name, op_type, cache, node_id,
    parent's name) per span, as a multiset."""
    by_id = {sp.span_id: sp for sp in spans}
    return Counter(
        (sp.name.replace("_JScale", "_Scale"), (sp.op_type or "").replace("_JScale", "_Scale"),
         sp.cache, sp.node_id,
         by_id[sp.parent_id].name.replace("_JScale", "_Scale")
         if sp.parent_id in by_id else None)
        for sp in spans
    )


# ---------------------------------------------------------------------------
# the tracer core (test_tracing.py)
# ---------------------------------------------------------------------------


def test_span_tree_nesting_and_ids():
    t = trace_mod.Tracer()
    with t.span("outer") as outer:
        with t.span("inner") as inner:
            pass
    spans = {sp.name: sp for sp in t.spans()}
    assert spans["inner"].parent_id == spans["outer"].span_id
    assert spans["inner"].depth == 1
    assert spans["outer"].parent_id is None
    assert spans["outer"].end >= spans["inner"].end
    assert outer.span_id != inner.span_id


def test_span_stacks_are_per_thread():
    t = trace_mod.Tracer()
    started = threading.Barrier(2)

    def work(name):
        with t.span(name):
            started.wait(timeout=5)

    threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert all(sp.parent_id is None for sp in t.spans())
    assert {sp.name for sp in t.spans()} == {"t0", "t1"}


def test_disabled_tracing_records_nothing():
    t = trace_mod.Tracer()
    trace_mod.install(t)
    trace_mod.stop()
    fitted = FunctionNode(batch_fn=lambda X: X * 2.0, label="double").to_pipeline().fit()
    fitted.apply(Dataset(torch.ones((3, 2))))
    assert trace_mod.current() is None
    assert t.spans() == []


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_suspended_records_nothing_and_reinstalls(pkg):
    """Inside ``suspended()`` a pull records no span, in either package."""
    mod = trace_mod if pkg == "torch" else jtrace
    t = mod.install(mod.Tracer())
    g, _, sink = _chain_graph() if pkg == "torch" else _jchain_graph()
    ex = (GraphExecutor if pkg == "torch" else JExecutor)(g, optimize=False)
    with mod.suspended():
        assert mod.current() is None
        ex.execute(sink).get()
    assert mod.current() is t
    assert t.spans() == []


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_install_if_absent_loser_installs_nothing(pkg):
    """Two fit-local tracers race for the slot: the first wins, the second
    gets None and leaves the winner installed; ``uninstall`` of the loser
    tears nothing down, of the winner empties the slot."""
    mod = trace_mod if pkg == "torch" else jtrace
    first, second = mod.Tracer(), mod.Tracer()
    assert mod.install_if_absent(first) is first
    assert mod.install_if_absent(second) is None
    assert mod.current() is first
    assert mod.uninstall(second) is False
    assert mod.current() is first
    assert mod.uninstall(first) is True
    assert mod.current() is None


def test_executor_records_miss_then_hit_spans():
    g, (leaf, n1, n2), sink = _chain_graph()
    t = _installed()
    ex = GraphExecutor(g, optimize=False)
    ex.execute(sink).get()
    misses = [sp for sp in t.spans() if sp.cache == "miss"]
    assert {sp.node_id for sp in misses} == {str(leaf.id), str(n1.id), str(n2.id)}
    for sp in misses:
        assert sp.op_type in ("DatasetOperator", "_Scale")
        assert sp.sync_seconds >= 0.0
    before = len(t.spans())
    ex.execute(sink).get()
    new = t.spans()[before:]
    assert [sp.cache for sp in new] == ["hit"]
    assert new[0].node_id == str(n2.id)
    assert new[0].instant


def test_executor_span_reports_output_bytes():
    g, (leaf, n1, n2), sink = _chain_graph()
    t = _installed()
    GraphExecutor(g, optimize=False).execute(sink).get()
    sp = next(s for s in t.spans() if s.node_id == str(n2.id))
    assert sp.output_bytes == 4 * 2 * 4  # (4, 2) float32


def test_span_trees_equal_jax_for_the_same_pulls():
    """The chain pulled twice and the diamond pulled through both sinks:
    every span's (name, op_type, cache, node, parent) equal in both."""
    t, jt = _installed(), jtrace.install(jtrace.Tracer())
    g, _, sink = _chain_graph()
    jg, _, jsink = _jchain_graph()
    ex, jex = GraphExecutor(g, optimize=False), JExecutor(jg, optimize=False)
    for _ in range(2):
        ex.execute(sink).get()
        jex.execute(jsink).get()
    d, _, (s1, s2) = _reused_dag()
    jd, _, (j1, j2) = _jreused_dag()
    dex, jdex = GraphExecutor(d, optimize=False), JExecutor(jd, optimize=False)
    for s, js in ((s1, j1), (s2, j2)):
        dex.execute(s).get()
        jdex.execute(js).get()
    assert _tree(t.spans()) == _tree(jt.spans())
    # eager leaves carry the same attrs; node spans the retained flag
    leaf = [sp.attrs for sp in t.spans() if sp.attrs.get("eager")]
    jleaf = [sp.attrs for sp in jt.spans() if sp.attrs.get("eager")]
    assert leaf == jleaf


def test_scheduled_pull_nests_worker_spans_and_matches_jax():
    """A pull with width runs on the worker pool: node spans carry
    ``queue_wait_seconds`` and ``worker`` and nest under the pull span,
    with the same tree as the JAX package's scheduled pull."""
    from keystone_tpu.workflow.pipeline import Pipeline as JPipeline
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    t, jt = _installed(), jtrace.install(jtrace.Tracer())
    X = np.ones((4, 3), np.float32)
    branches = [_Scale(float(i + 2)).to_pipeline() for i in range(3)]
    jbranches = [_JScale(float(i + 2)).to_pipeline() for i in range(3)]
    Pipeline.gather(branches)(torch.from_numpy(X)).get()
    JPipeline.gather(jbranches)(X).get()
    pool = [sp for sp in t.spans() if "worker" in sp.attrs]
    assert len(pool) == 3
    assert all(sp.attrs["queue_wait_seconds"] >= 0 for sp in pool)
    root = next(sp for sp in t.spans() if sp.name == "pipeline.pull")
    assert all(sp.parent_id == root.span_id for sp in pool)
    jpool = [sp for sp in jt.spans() if "worker" in sp.attrs]
    assert sorted(sp.name for sp in pool) == sorted(
        sp.name.replace("_JScale", "_Scale") for sp in jpool)


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


def test_chrome_trace_well_formed(tmp_path):
    g, _, sink = _chain_graph()
    t = _installed()
    GraphExecutor(g, optimize=False).execute(sink).get()
    GraphExecutor(g, optimize=False).execute(sink).get()
    doc = to_chrome_trace(t)
    events = doc["traceEvents"]
    ts = [e["ts"] for e in events]
    assert all(b >= a for a, b in zip(ts, ts[1:])), "ts must be monotonic"
    complete = [e for e in events if e["ph"] == "X"]
    assert all("dur" in e and e["dur"] >= 0 for e in complete)
    assert any(e["args"].get("cache") == "miss" for e in complete)
    path = tmp_path / "trace.json"
    write_chrome_trace(t, str(path))
    assert json.loads(path.read_text())["traceEvents"]


def test_exported_keys_equal_jax():
    """The document's keys, each event kind's keys and the node events'
    args keys are the JAX package's. ``sync_ms`` and ``compiles`` are left
    out of the args: each is written only where it is nonzero (a wait for a
    device, which a CPU tensor never needs; a compile, which JAX makes only
    the first time a process meets a function)."""
    t, jt = _installed(), jtrace.install(jtrace.Tracer())
    g, _, sink = _chain_graph()
    jg, _, jsink = _jchain_graph()
    GraphExecutor(g, optimize=False).execute(sink).get()
    JExecutor(jg, optimize=False).execute(jsink).get()
    doc, jdoc = to_chrome_trace(t), jto_chrome(jt)
    assert set(doc) == set(jdoc)
    assert set(doc["otherData"]) == set(jdoc["otherData"])

    def kinds(d):
        out = {}
        for e in d["traceEvents"]:
            key = (e["ph"], e["name"].replace("_JScale", "_Scale"))
            out.setdefault(key, (set(e), set(e["args"]) - {"sync_ms", "compiles"}))
        return out

    assert kinds(doc) == kinds(jdoc)


def test_top_summary_and_schema():
    g, _, sink = _chain_graph()
    t = _installed()
    GraphExecutor(g, optimize=False).execute(sink).get()
    summary = t.span_summary()
    assert summary
    for row in summary.values():
        assert {"seconds", "calls"} <= set(row)
    text = format_top_spans(t, n=3)
    assert "node." in text and "seconds" in text


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------


def test_cache_audit_covers_every_cacher_annotated_node(caplog):
    g, (a, b, c, d), (s1, s2) = _reused_dag()
    profiles = {a: Profile(1e6, 100), b: Profile(5e6, 200), c: Profile(1e3, 50),
                d: Profile(1e3, 50)}
    t = _installed()
    g2, ann = AutoCacheRule("greedy", 10_000, profiles).apply(g, {})
    ex = GraphExecutor(g2, optimize=False)
    ex._annotations = ann
    ex.execute(s1).get()
    ex.execute(s2).get()
    rows = cache_audit(t)
    by_node = {r["node"]: r for r in rows}
    cachers = {str(g2.get_dependencies(n)[0].id) for n in g2.nodes
               if type(g2.get_operator(n)).__name__ == "Cacher"}
    assert cachers
    for node in cachers:
        row = by_node[node]
        assert row["cacher"] is True and row["observed"] is True
        assert row["est_seconds"] > 0 and row["obs_seconds"] is not None
        assert row["est_bytes"] > 0 and row["obs_bytes"] is not None
    assert {str(n.id) for n in profiles} <= set(by_node)
    with caplog.at_level(logging.INFO, logger="keystone_tpu_torch.obs.audit"):
        assert log_cache_audit(t) == rows
    assert "autocache audit" in caplog.text


def test_cache_audit_rows_equal_jax():
    """The same injected profiles and pulls in both packages: the audit's
    rows agree in node, label, cacher flag, estimates, observed bytes and
    hits, and have the JAX package's keys."""
    t, jt = _installed(), jtrace.install(jtrace.Tracer())
    g, (a, b, c, d), (s1, s2) = _reused_dag()
    jg, (ja, jb, jc, jd), (j1, j2) = _jreused_dag()
    prof = [(1e6, 100), (5e6, 200), (1e3, 50), (1e3, 50)]
    g2, ann = AutoCacheRule("greedy", 10_000,
                            {n: Profile(*p) for n, p in zip((a, b, c, d), prof)}).apply(g, {})
    jg2, jann = JAutoCacheRule("greedy", 10_000,
                               {n: JProfile(*p) for n, p in zip((ja, jb, jc, jd), prof)}).apply(jg, {})
    ex, jex = GraphExecutor(g2, optimize=False), JExecutor(jg2, optimize=False)
    ex._annotations, jex._annotations = ann, jann
    for s, js in ((s1, j1), (s2, j2)):
        ex.execute(s).get()
        jex.execute(js).get()
    keep = ("node", "label", "cacher", "kind", "est_seconds", "est_bytes", "obs_bytes",
            "cache_hits", "observed")

    def rows(r):
        return sorted(tuple(str(x[k]).replace("_JScale", "_Scale") for k in keep) for x in r)

    audit, jaudit = cache_audit(t), jcache_audit(jt)
    assert rows(audit) == rows(jaudit)
    assert set(audit[0]) == set(jaudit[0])


def test_observed_seconds_are_exclusive_of_children():
    t = trace_mod.Tracer()
    with t.span("node.parent", node_id="1", cache="miss"):
        with t.span("node.child", node_id="2", cache="miss"):
            time.sleep(0.05)
    obs_ = observed_by_node(t)
    assert obs_["2"]["seconds"] >= 0.045
    assert obs_["1"]["seconds"] < 0.04, "child time must not count twice"


def test_observed_by_node_sums_equal_jax():
    """Spans with the same intervals in both tracers: the per-node
    exclusive seconds, computes and hits are equal."""
    t, jt = trace_mod.Tracer(), jtrace.Tracer()
    spans = [("5", 0.0, 1.0, None), ("6", 0.2, 0.5, 0), ("6", 0.6, 0.7, 0), ("7", 1.0, 3.0, None)]
    for tr, Span in ((t, trace_mod.Span), (jt, jtrace.Span)):
        made = []
        for node, s, e, parent in spans:
            sp = Span(name="node.x", start=s, end=e, node_id=node, cache="miss",
                      parent_id=None if parent is None else made[parent].span_id)
            tr.record_complete(sp)
            made.append(sp)
        tr.instant("node.x", node_id="7", cache="hit")
    got, want = observed_by_node(t), jobserved(jt)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k]["computes"] == want[k]["computes"]
        assert got[k]["hits"] == want[k]["hits"]
        assert got[k]["seconds"] == pytest.approx(want[k]["seconds"], abs=1e-12)
    assert got["5"]["seconds"] == pytest.approx(0.6)


def test_profiling_runs_do_not_pollute_the_trace():
    g, _, _ = _reused_dag()
    t = _installed()
    profile_nodes(g, sample_sizes=(2,), full_size=4)
    assert t.spans() == [], "sampled-scale profiling pulls must be suspended"


# ---------------------------------------------------------------------------
# scan spans
# ---------------------------------------------------------------------------


def test_a_scan_span_carries_the_scans_own_counters():
    from keystone_tpu_torch.data.pipeline_scan import scan_pipeline

    t = _installed()
    chunks = [torch.full((8, 3), float(i)) for i in range(5)]
    sp = scan_pipeline(iter(chunks), label="obs-test")
    assert sum(1 for _ in sp) == 5
    sp.close()
    (span,) = [s for s in t.spans() if s.name == "scan.pipeline"]
    st = sp.stats
    assert span.attrs["label"] == "obs-test"
    assert span.attrs["chunks"] == st.chunks == 5
    assert span.attrs["producer_stall_seconds"] == round(st.producer_stall_seconds, 6)
    assert span.attrs["consumer_stall_seconds"] == round(st.consumer_stall_seconds, 6)
    assert span.attrs["producer_seconds"] == round(st.producer_seconds, 6)
    assert span.attrs["staged_bytes"] == st.staged_bytes
    assert span.attrs["occupancy_max"] == st.occupancy_max
    assert (span.start, span.end) == (st.start, st.end)


def test_a_traced_chunked_fit_records_scan_spans_like_jax(monkeypatch):
    """A chunked LinearMapEstimator fit under a tracer: one scan span per
    scan, with the chunk counts of the JAX package's fit and the same attr
    keys."""
    from keystone_tpu.data.chunked import ChunkedDataset as JChunked
    from keystone_tpu.nodes.learning import linear as jlinear
    from keystone_tpu_torch.data.chunked import ChunkedDataset
    from keystone_tpu_torch.nodes.learning import linear

    monkeypatch.setenv("KEYSTONE_SCAN_LANES", "1")
    rng = np.random.default_rng(3)
    X = rng.normal(size=(200, 6)).astype(np.float32)
    Y = rng.normal(size=(200, 2)).astype(np.float32)
    t, jt = _installed(), jtrace.install(jtrace.Tracer())
    linear.LinearMapEstimator(lam=0.1).fit(ChunkedDataset.from_array(torch.from_numpy(X), 48),
                                           Dataset.of(torch.from_numpy(Y)))
    jlinear.LinearMapEstimator(lam=0.1).fit(JChunked.from_array(X, 48), JDataset.of(Y))
    spans = [s for s in t.spans() if s.name == "scan.pipeline"]
    jspans = [s for s in jt.spans() if s.name == "scan.pipeline"]
    assert spans and [s.attrs["chunks"] for s in spans] == [s.attrs["chunks"] for s in jspans]
    assert spans[0].attrs["chunks"] == 5
    assert set(spans[0].attrs) == set(jspans[0].attrs)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_trace_flag_writes_chrome_trace_and_profiles_learn(tmp_path, capsys):
    """``--trace`` writes the trace (per-node spans, a fit root); with
    ``--profiles`` a second run of the application samples 0 times."""
    import keystone_tpu_torch.cost as cost
    from keystone_tpu_torch.__main__ import main

    args = ["RandomPatchCifarKernel", "--device", "cpu", "--nTrain", "96", "--nTest", "24",
            "--numFilters", "8", "--blockSize", "32", "--lambda", "1.0", "--gamma", "1e-3",
            "--poolSize", "8", "--poolStride", "7"]
    path = tmp_path / "t.json"
    store = tmp_path / "profiles"
    cost.reset_sampling()
    assert main(args + ["--trace", str(path), "--profiles", str(store)]) == 0
    assert "Test error" in capsys.readouterr().out
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    ts = [e["ts"] for e in events]
    assert all(b >= a for a, b in zip(ts, ts[1:]))
    nodes = [e for e in events if e.get("args", {}).get("node")]
    assert nodes and any(e["args"].get("cache") for e in nodes)
    assert all(e["args"].get("op_type") for e in nodes)
    assert [e["name"] for e in events].count("pipeline.fit") == 1
    trace_mod.reset()
    PipelineEnv.get_or_create().reset()
    cost.reset_sampling()
    assert main(args + ["--profiles", str(store)]) == 0
    assert cost.sampling_executions()["total"] == 0


def test_run_configures_the_trace_and_store_but_not_logging(tmp_path):
    """``run`` (the programmatic entry) applies ``--trace`` and
    ``--profiles`` and leaves logging and phase profiling as its caller
    set them; ``main`` configures all of them."""
    import logging

    import keystone_tpu_torch.cost as cost
    from keystone_tpu_torch.__main__ import run
    from keystone_tpu_torch.utils import timing

    args = ["RandomPatchCifarKernel", "--device", "cpu", "--nTrain", "64", "--nTest", "16",
            "--numFilters", "8", "--blockSize", "32", "--lambda", "1.0", "--gamma", "1e-3",
            "--poolSize", "8", "--poolStride", "7"]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    path = tmp_path / "t.json"
    timing.enable(True)
    try:
        run(args + ["--trace", str(path), "--profiles", str(tmp_path / "profiles")])
        assert timing._profiling
    finally:
        timing.enable(False)
    assert root.handlers == handlers and root.level == level
    assert json.loads(path.read_text())["traceEvents"]
    assert cost.get_store().root == str(tmp_path / "profiles")
    trace_mod.reset()
    cost.reset()


def test_cli_rejects_an_unknown_application():
    from keystone_tpu_torch.__main__ import main

    with pytest.raises(SystemExit):
        main(["mnits"])


# ---------------------------------------------------------------------------
# utils/obs.py (test_obs.py)
# ---------------------------------------------------------------------------


def test_configure_sets_level_and_format(capsys):
    obs.configure("info")
    logging.getLogger("keystone_tpu_torch.test").info("hello obs")
    err = capsys.readouterr().err
    assert "hello obs" in err and "keystone_tpu_torch.test" in err
    obs.configure("warning")
    logging.getLogger("keystone_tpu_torch.test").info("hidden")
    assert "hidden" not in capsys.readouterr().err


def test_configure_rejects_unknown_level():
    with pytest.raises(ValueError):
        obs.configure("loud")


def test_profile_enables_phase_logs(capsys):
    obs.configure("warning", profile=True)
    try:
        timing.reset()
        with timing.phase("obs.test_phase"):
            pass
        assert "obs.test_phase" in timing.snapshot()
        assert "obs.test_phase" in capsys.readouterr().err
    finally:
        obs.configure("warning", profile=False)


def test_profile_env_parsing(monkeypatch):
    for raw, want in [("1", True), ("true", True), ("0", False), ("false", False),
                      ("", False), ("off", False)]:
        monkeypatch.setenv("KEYSTONE_PROFILE", raw)
        obs.configure("warning", profile=None)
        assert timing._profiling is want, (raw, want)
    monkeypatch.delenv("KEYSTONE_PROFILE")
    obs.configure("warning", profile=False)


def test_bad_env_level_falls_back(monkeypatch):
    monkeypatch.setenv("KEYSTONE_LOG", "trace")
    obs.configure(None)
    assert logging.getLogger().level == logging.WARNING


def test_configure_is_idempotent_one_handler():
    obs.configure("info")
    root = logging.getLogger()
    n_handlers = len(root.handlers)
    obs.configure("debug")
    obs.configure("warning")
    assert len(root.handlers) == n_handlers
    assert root.level == logging.WARNING


def test_configure_trace_and_profiles_install_and_export(tmp_path, monkeypatch):
    """``trace`` installs the tracer (kept across calls), ``profiles`` the
    store; ``export_trace`` writes the file, and nothing without a trace."""
    import keystone_tpu_torch.cost as cost

    assert obs.export_trace() is None
    path = tmp_path / "x.json"
    obs.configure("warning", trace=str(path), profiles=str(tmp_path / "p"), device="cpu")
    t = trace_mod.current()
    assert t is not None and cost.get_store() is not None
    obs.configure("warning")
    assert trace_mod.current() is t
    with t.span("one"):
        pass
    assert obs.export_trace() == str(path)
    assert json.loads(path.read_text())["traceEvents"]


def test_every_under_concurrent_callers():
    key = "test.concurrent.every"
    obs.reset_rate_limits()
    results = []
    barrier = threading.Barrier(8)

    def hit():
        barrier.wait(timeout=5)
        results.append(obs.every(key, 60.0))

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert sum(results) == 1


def test_timing_reset_clears_rate_limits():
    key = "test.reset.every"
    assert obs.every(key, 3600.0) is True
    assert obs.every(key, 3600.0) is False
    timing.reset()
    assert obs.every(key, 3600.0) is True


def test_phase_holder_sync_path():
    obs.configure("warning", profile=True)
    try:
        timing.reset()
        with timing.phase("obs.holder_sync") as holder:
            holder.append(torch.ones(4) * 2.0)
        snap = timing.snapshot()
        assert snap["obs.holder_sync"]["calls"] == 1
        assert snap["obs.holder_sync"]["seconds"] >= 0.0
    finally:
        obs.configure("warning", profile=False)
