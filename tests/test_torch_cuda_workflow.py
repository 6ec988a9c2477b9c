"""The workflow core on a CUDA card: CSE keys a tensor parameter by its
content wherever it lives, so a node's parameters on the card merge as the
same parameters on the CPU do.

Needs a CUDA card; elsewhere it skips. It imports neither JAX nor the JAX
package, so a machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_workflow.py
"""

import pytest
import torch

from keystone_tpu_torch.nodes.stats import RandomSignNode
from keystone_tpu_torch.workflow.operators import structural_key
from keystone_tpu_torch.workflow.pipeline import Pipeline
from keystone_tpu_torch.workflow.rules import EquivalentNodeMergeRule


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_tensor_on_the_card_canonicalizes_as_on_the_cpu(cuda):
    signs = RandomSignNode.create(784, seed=3, device="cpu").signs
    on_card = RandomSignNode(signs.to(cuda))
    assert structural_key(on_card) == structural_key(RandomSignNode(signs))
    assert structural_key(on_card) != structural_key(RandomSignNode(-signs.to(cuda)))
    # separately built equal nodes on the card merge
    pipe = Pipeline.gather([RandomSignNode(signs.to(cuda)), RandomSignNode(signs.to(cuda))])
    graph, _ = EquivalentNodeMergeRule().apply(pipe.graph, {})
    assert len(graph.nodes) == len(pipe.graph.nodes) - 1
    # a write in place is seen
    before = structural_key(on_card)
    on_card.signs.neg_()
    assert structural_key(on_card) != before
