"""Segment dispatch on a CUDA card: a KRR chain's segment (a row-local
scaling node, then the K1 mapper) runs as one program, eagerly for a whole
batch, launches K1 as node dispatch does (10 a run, one launch per 500-row
training block), and answers as node dispatch does, bit for bit; with an AOT cache its exported
program names K1, and a second executor loads it with zero traces and the
same scores bit for bit.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_segment.py
"""

import pytest
import torch

import keystone_tpu_torch.compile as cmod
from keystone_tpu_torch.compile import segment as segment_mod
from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
from keystone_tpu_torch.obs import tracer as tracer_mod
from keystone_tpu_torch.ops import gaussian_kernel as gk
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline
from keystone_tpu_torch.workflow.transformer import Transformer

BLOCKS = 10


class _Scale(Transformer):
    row_local = True

    def __init__(self, s):
        self.s = s

    def forward(self, X):
        return X * self.s


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    PipelineEnv.get_or_create().reset()
    segment_mod.reset_dispatchers()
    yield torch.device("cuda")
    segment_mod.reset_dispatchers()
    cmod.reset()
    tracer_mod.reset()


def _krr_chain(cuda, n_train=5000, d=32, k=4, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    train_X = torch.randn(n_train, d, device=cuda, generator=gen)
    W = torch.randn(n_train, k, device=cuda, generator=gen)
    pipe = _Scale(0.5).and_then(KernelBlockLinearMapper(train_X, W, 0.05, n_train // BLOCKS))
    return FittedPipeline(pipe.graph, pipe.source, pipe.sink)


def _apply(fitted, X):
    """(scores, K1 launches, the exec.segment paths) of one apply."""
    tracer = tracer_mod.install(tracer_mod.Tracer())
    try:
        gk.gaussian_kernel_block.launches = 0
        out = fitted.apply(X).to_array()
        torch.cuda.synchronize()
        paths = [s.attrs["path"] for s in tracer.spans() if s.name == "exec.segment"]
        return out, gk.gaussian_kernel_block.launches, paths
    finally:
        tracer_mod.reset()


@pytest.mark.cuda
def test_a_k1_segment_matches_node_dispatch_on_the_card(cuda, monkeypatch):
    fitted = _krr_chain(cuda)
    X = torch.randn(300, 32, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    # a whole batch runs eagerly at every call: no capture, no warm-up run
    runs = [_apply(fitted, X) for _ in range(3)]
    assert all(paths == ["compiled"] and k1 == BLOCKS for _, k1, paths in runs)
    monkeypatch.setenv("KEYSTONE_SEGMENT_COMPILE", "0")
    node, node_k1, node_paths = _apply(fitted, X)
    assert node_paths == [] and node_k1 == BLOCKS
    # the same kernels on the same shapes
    assert all(torch.equal(scores, node) for scores, _, _ in runs)


@pytest.mark.cuda
def test_an_exported_k1_segment_loads_warm_with_zero_traces(cuda, tmp_path):
    cmod.configure(str(tmp_path))
    X = torch.randn(300, 32, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    cold, cold_k1, paths = _apply(_krr_chain(cuda), X)
    (disp,) = segment_mod._DISPATCHERS.values()
    assert paths == ["compiled"] and disp.traced_count == 1 and disp.loaded_count == 0
    assert cold_k1 == BLOCKS  # the exported program names K1, which launches
    (program,) = [p.fn for p in disp._by_sig.values()]
    k1_nodes = [n for n in program.graph.nodes
                if "keystone.gaussian_kernel_block" in str(n.target)]
    assert len(k1_nodes) == BLOCKS
    segment_mod.reset_dispatchers()  # a new process's view
    warm, warm_k1, _ = _apply(_krr_chain(cuda), X)
    (disp2,) = segment_mod._DISPATCHERS.values()
    assert disp2.loaded_count == 1 and disp2.traced_count == 0
    assert warm_k1 == BLOCKS and torch.equal(warm, cold)
    # the loaded program runs eagerly at every call
    again, again_k1, _ = _apply(_krr_chain(cuda), X)
    assert again_k1 == BLOCKS and torch.equal(again, cold)
