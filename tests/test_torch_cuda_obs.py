"""The observe-and-learn loop on a CUDA card: a span waits for its own
stream's work and never inside a capture, CUDA-graph captures count as
compiles, a value kept by an auto-cache Cacher survives a replay of the
same graph signature, and the budget comes from the caching allocator.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_obs.py

Tolerance: none; every comparison is exact.
"""

import pytest
import torch

from keystone_tpu_torch.compile import segment
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.util.core import Cacher
from keystone_tpu_torch.obs import tracer as trace_mod
from keystone_tpu_torch.obs.span import sync_value
from keystone_tpu_torch.workflow import autocache
from keystone_tpu_torch.workflow import fusion
from keystone_tpu_torch.workflow.cuda_graph import GraphCache
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.executor import GraphExecutor
from keystone_tpu_torch.workflow.graph import Graph
from keystone_tpu_torch.workflow.operators import DatasetOperator
from keystone_tpu_torch.workflow.transformer import Transformer


@pytest.fixture(autouse=True)
def clean():
    trace_mod.reset()
    PipelineEnv.get_or_create().reset()
    fusion.clear_graph_cache()
    segment.reset_dispatchers()
    yield
    trace_mod.reset()
    PipelineEnv.get_or_create().reset()
    fusion.clear_graph_cache()
    segment.reset_dispatchers()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class _Affine(Transformer):
    row_local = True

    def __init__(self, a, b):
        self.a, self.b = a, b

    def forward(self, X):
        return X * self.a + self.b


@pytest.mark.cuda
def test_a_span_waits_for_its_streams_work_and_not_inside_a_capture(cuda):
    x = torch.randn(2048, 2048, device=cuda)
    y = x @ x
    assert sync_value(Dataset(y)) is True
    assert sync_value(torch.ones(3)) is False  # a host tensor needs no wait
    stream = torch.cuda.Stream(cuda)
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        x @ x  # the warm-up
    torch.cuda.current_stream(cuda).wait_stream(stream)
    seen = []
    with torch.cuda.graph(graph, stream=stream):
        z = x @ x
        seen.append(sync_value(z))
    assert seen == [False]
    graph.replay()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captures_count_as_compiles_in_open_spans(cuda):
    t = trace_mod.install(trace_mod.Tracer())
    cache = GraphCache(lambda x: x * 2.0)
    x = torch.randn(64, 8, device=cuda)
    with t.span("outer") as sp:
        cache(x)
        cache(x)  # a replay: no capture
        cache(torch.randn(32, 8, device=cuda))
    assert sp.compiles == 2
    with t.span("again") as sp2:
        cache(x)
    assert sp2.compiles == 0


@pytest.mark.cuda
def test_a_cached_value_survives_a_replay_of_the_same_signature(cuda):
    """A fused group runs as graph replays into its own output, so the
    value a Cacher keeps across pulls is not the graph's static buffer:
    running the same group on other data of the same shape (the same
    graph, replayed) leaves the cached value as it was."""
    X1 = torch.randn(512, 16, device=cuda)
    X2 = torch.randn(512, 16, device=cuda)
    g = Graph()
    g, leaf = g.add_node(DatasetOperator(X1), [])
    g, a = g.add_node(_Affine(2.0, 1.0), [leaf])
    g, b = g.add_node(_Affine(0.5, -3.0), [a])
    g, cached = g.add_node(Cacher(), [b])
    g, c = g.add_node(_Affine(1.0, 1.0), [b])
    g, sink = g.add_sink(cached)
    g, _ = g.add_sink(c)
    # b has two consumers: the group is (a, b), and the Cacher stays a node
    g, _ = fusion.TraceFusionRule().apply(g, {})
    (fused,) = [g.get_operator(n) for n in g.nodes
                if isinstance(g.get_operator(n), fusion.FusedTransformerOperator)]
    assert any(isinstance(g.get_operator(n), Cacher) for n in g.nodes)
    ex = GraphExecutor(g, optimize=False)
    ex._annotations = {autocache.AUTOCACHE_ACTIVE: True}
    first = ex.execute(sink).get().payload
    kept = first.clone()
    g2 = Graph()
    g2, leaf2 = g2.add_node(DatasetOperator(X2), [])
    g2, f2 = g2.add_node(fused, [leaf2])
    g2, s2 = g2.add_sink(f2)
    other = GraphExecutor(g2, optimize=False).execute(s2).get().payload
    torch.cuda.synchronize()
    assert len(fused.graphs(cuda)) >= 1  # the group ran as captured graphs
    assert not torch.equal(other, kept)
    again = ex.execute(sink).get().payload
    assert again is first  # the Cacher's value, kept across pulls
    assert torch.equal(first, kept)


@pytest.mark.cuda
def test_the_budget_is_three_quarters_of_what_the_allocator_can_hand_out(cuda):
    free, _ = torch.cuda.mem_get_info(cuda)
    slack = torch.cuda.memory_reserved(cuda) - torch.cuda.memory_allocated(cuda)
    budget = autocache._device_budget_bytes(cuda)
    assert abs(budget - 0.75 * (free + slack)) <= 0.01 * budget
    g = Graph()
    g, _ = g.add_node(DatasetOperator(torch.ones(4, 2, device=cuda)), [])
    assert autocache._graph_device(g).type == "cuda"
