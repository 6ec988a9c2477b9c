"""The port's graph against the JAX package's: every case of
``tests/workflow/test_graph.py`` runs the same edits on both ``Graph``
classes and compares what comes out — the sources, each node's operator
label and dependencies, the sinks — and which edits raise ``GraphError``."""

from types import SimpleNamespace

import pytest

from keystone_tpu.workflow import graph as jgraph
from keystone_tpu.workflow import operators as joperators
from keystone_tpu_torch.workflow import graph as tgraph
from keystone_tpu_torch.workflow import operators as toperators


def _package(graph_mod, operators_mod):
    class Op(operators_mod.Operator):
        """Minimal identity-distinct operator for structural tests."""

        def __init__(self, name):
            self.name = name

        @property
        def label(self):
            return self.name

    return SimpleNamespace(Graph=graph_mod.Graph, GraphError=graph_mod.GraphError,
                           NodeId=graph_mod.NodeId, SinkId=graph_mod.SinkId,
                           SourceId=graph_mod.SourceId, Op=Op)


PACKAGES = {"jax": _package(jgraph, joperators), "torch": _package(tgraph, toperators)}


def shape(g):
    """A graph as plain data: sources, node → (label, deps), sink → dep."""
    return (
        sorted(s.id for s in g.sources),
        sorted((n.id, g.get_operator(n).label, tuple(map(repr, g.get_dependencies(n))))
               for n in g.nodes),
        sorted((s.id, repr(d)) for s, d in g.sink_dependencies.items()),
    )


def raises(m, fn):
    try:
        fn()
    except m.GraphError:
        return "GraphError"
    return "no error"


def build_simple(m):
    """source -> a -> b -> sink, plus c hanging off a."""
    g = m.Graph()
    g, s = g.add_source()
    g, na = g.add_node(m.Op("a"), [s])
    g, nb = g.add_node(m.Op("b"), [na])
    g, nc = g.add_node(m.Op("c"), [na])
    g, snk = g.add_sink(nb)
    return g, s, na, nb, nc, snk


def add_node_and_accessors(m):
    g, s, na, nb, nc, snk = build_simple(m)
    assert g.nodes == {na, nb, nc} and g.sources == {s} and g.sinks == {snk}
    return [shape(g), repr(g.get_dependencies(nb)), repr(g.get_sink_dependency(snk)),
            g.get_operator(na).label]


def add_node_missing_dep_fails(m):
    g = m.Graph()
    return [raises(m, lambda: g.add_node(m.Op("x"), [m.NodeId(99)])),
            raises(m, lambda: g.add_node(m.Op("x"), [m.SourceId(0)]))]


def add_sink_missing_dep_fails(m):
    return [raises(m, lambda: m.Graph().add_sink(m.NodeId(0)))]


def get_missing_node_fails(m):
    g, *_ = build_simple(m)
    return [raises(m, lambda: g.get_operator(m.NodeId(99))),
            raises(m, lambda: g.get_dependencies(m.NodeId(99))),
            raises(m, lambda: g.get_sink_dependency(m.SinkId(99)))]


def set_dependencies_and_operator(m):
    g, s, na, nb, nc, snk = build_simple(m)
    g2 = g.set_dependencies(nb, [nc])
    new_op = m.Op("b2")
    g3 = g.set_operator(nb, new_op)
    assert g3.get_operator(nb) is new_op
    # the original is untouched (immutability)
    return [shape(g), shape(g2), shape(g3)]


def set_on_missing_node_fails(m):
    g, *_ = build_simple(m)
    return [raises(m, lambda: g.set_operator(m.NodeId(99), m.Op("x"))),
            raises(m, lambda: g.set_dependencies(m.NodeId(99), [])),
            raises(m, lambda: g.set_sink_dependency(m.SinkId(99), m.NodeId(0)))]


def remove_node_referenced_fails(m):
    g, s, na, nb, nc, snk = build_simple(m)
    return [raises(m, lambda: g.remove_node(na)),  # b and c depend on it
            raises(m, lambda: g.remove_node(nb)),  # the sink depends on it
            shape(g.remove_node(nc))]


def remove_source_referenced_fails(m):
    g, s, *_ = build_simple(m)
    return [raises(m, lambda: g.remove_source(s))]


def remove_sink_then_node(m):
    g, s, na, nb, nc, snk = build_simple(m)
    g = g.remove_sink(snk).remove_node(nb).remove_node(nc).remove_node(na).remove_source(s)
    return [shape(g)]


def replace_dependency(m):
    g, s, na, nb, nc, snk = build_simple(m)
    return [shape(g.replace_dependency(nb, nc))]  # the sink now reads c


def add_graph_disjoint_union(m):
    g1, s1, _, _, _, snk1 = build_simple(m)
    g2, s2, _, _, _, snk2 = build_simple(m)
    merged, source_map, sink_map = g1.add_graph(g2)
    assert source_map[s2] != s1 and sink_map[snk2] != snk1
    return [shape(merged), sorted((k.id, v.id) for k, v in source_map.items()),
            sorted((k.id, v.id) for k, v in sink_map.items())]


def connect_graph_splices_sink_to_source(m):
    g1 = m.Graph()
    g1, s1 = g1.add_source()
    g1, na = g1.add_node(m.Op("a"), [s1])
    g1, snk1 = g1.add_sink(na)
    g2 = m.Graph()
    g2, s2 = g2.add_source()
    g2, nb = g2.add_node(m.Op("b"), [s2])
    g2, snk2 = g2.add_sink(nb)
    merged, source_map, sink_map = g1.connect_graph(g2, {snk1: s2})
    # the spliced source and sink are gone; b reads a
    return [shape(merged), sorted(source_map), sorted((k.id, v.id) for k, v in sink_map.items())]


def connect_graph_bad_splice_fails(m):
    g1, _, _, _, _, snk1 = build_simple(m)
    g2, s2, *_ = build_simple(m)
    return [raises(m, lambda: g1.connect_graph(g2, {m.SinkId(99): s2})),
            raises(m, lambda: g1.connect_graph(g2, {snk1: m.SourceId(99)}))]


def replace_nodes(m):
    # source -> a -> b -> sink; replace b with the subgraph x -> y
    g = m.Graph()
    g, s = g.add_source()
    g, na = g.add_node(m.Op("a"), [s])
    g, nb = g.add_node(m.Op("b"), [na])
    g, snk = g.add_sink(nb)
    rep = m.Graph()
    rep, rs = rep.add_source()
    rep, nx = rep.add_node(m.Op("x"), [rs])
    rep, ny = rep.add_node(m.Op("y"), [nx])
    rep, rsnk = rep.add_sink(ny)
    return [shape(g.replace_nodes(frozenset([nb]), rep, {rs: na}, {nb: rsnk}))]


def to_dot_contains_structure(m):
    g, *_ = build_simple(m)
    return [g.to_dot()]


CASES = [add_node_and_accessors, add_node_missing_dep_fails, add_sink_missing_dep_fails,
         get_missing_node_fails, set_dependencies_and_operator, set_on_missing_node_fails,
         remove_node_referenced_fails, remove_source_referenced_fails, remove_sink_then_node,
         replace_dependency, add_graph_disjoint_union, connect_graph_splices_sink_to_source,
         connect_graph_bad_splice_fails, replace_nodes, to_dot_contains_structure]

#: the cases that must raise on every edit they try
ALL_RAISE = {add_node_missing_dep_fails, add_sink_missing_dep_fails, get_missing_node_fails,
             set_on_missing_node_fails, remove_source_referenced_fails,
             connect_graph_bad_splice_fails}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_graph_edits_match_jax(case):
    want, got = case(PACKAGES["jax"]), case(PACKAGES["torch"])
    assert got == want
    if case in ALL_RAISE:
        assert set(got) == {"GraphError"}
