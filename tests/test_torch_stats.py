"""The port's remaining stats nodes against the JAX package's on the CPU:
CosineRandomFeatures (W and b copied from the JAX node, atol 1e-5: one
float32 GEMM and a cosine in two bindings), NormalizeRows and
SignedHellingerMapper (rtol 1e-6: a norm and a square root, elementwise),
and ColumnSampler, whose numpy draws must pick the same columns for the
same seed (equal arrays)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes.stats import ColumnSampler as JColumnSampler
from keystone_tpu.nodes.stats import CosineRandomFeatures as JCosine
from keystone_tpu.nodes.stats import NormalizeRows as JNormalizeRows
from keystone_tpu.nodes.stats import SignedHellingerMapper as JHellinger
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.stats import (
    ColumnSampler,
    CosineRandomFeatures,
    NormalizeRows,
    SignedHellingerMapper,
)
from keystone_tpu_torch.nodes.util import VectorCombiner
from keystone_tpu_torch.workflow import fusion
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import Pipeline


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n,d_in,d_out,gamma,seed", [
    (6, 5, 8, 1.0, 0), (33, 440, 256, 0.05555, 3), (17, 20, 64, 0.02, 9)])
def test_cosine_random_features_match_jax(n, d_in, d_out, gamma, seed):
    ref = JCosine.create(d_in, d_out, gamma, seed=seed)
    W, b = np.asarray(ref.W), np.asarray(ref.b)
    X = _x((n, d_in), seed=seed, scale=1.5)
    node = CosineRandomFeatures.from_reference(W, b, "cpu")
    got = node.forward(torch.from_numpy(X)).numpy()
    want = np.asarray(ref.trace_batch(jnp.asarray(X)))
    assert got.shape == want.shape == (n, d_out)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the closed form, in float64 (atol 1e-5)
    np.testing.assert_allclose(got, np.cos(X.astype(np.float64) @ W.T + b), atol=1e-5)


def test_cosine_create_draws_from_numpy():
    a = CosineRandomFeatures.create(440, 4096, 0.05555, seed=5, device="cpu")
    again = CosineRandomFeatures.create(440, 4096, 0.05555, seed=5, device="cpu")
    other = CosineRandomFeatures.create(440, 4096, 0.05555, seed=6, device="cpu")
    assert a.W.shape == (4096, 440) and a.b.shape == (4096,)
    assert a.W.dtype == a.b.dtype == torch.float32
    assert torch.equal(a.W, again.W) and torch.equal(a.b, again.b)
    assert not torch.equal(a.W, other.W)
    assert abs(a.W.std().item() - 0.05555) < 1e-3  # γ·N(0, 1), 1.8M draws
    assert 0.0 <= a.b.min().item() and a.b.max().item() < 2 * np.pi


def test_cosine_rejects_mismatched_bias():
    with pytest.raises(ValueError, match="rows of W and size of b"):
        CosineRandomFeatures(torch.zeros(4, 3), torch.zeros(5))


def test_cosine_branches_fuse_and_run_in_row_chunks(monkeypatch):
    """Gathered cosine branches and the combiner fuse into one row-local
    operator; its row-chunked run equals the whole batch (atol 1e-6: GEMMs
    of fewer rows)."""
    nodes = [CosineRandomFeatures.create(12, 16, 0.3, seed=s, device="cpu") for s in (1, 2)]
    fitted = Pipeline.gather(nodes).and_then(VectorCombiner()).fit()
    (op,) = fitted.graph.operators.values()
    assert isinstance(op, fusion.FusedTransformerOperator) and op.row_local
    assert [s.label for s, _ in op.steps][-2:] == ["GatherTransformerOperator", "VectorCombiner"]
    X = torch.from_numpy(_x((50, 12), seed=4))
    whole = fitted.apply(X).to_array()
    monkeypatch.setattr(fusion, "ROW_CHUNK", 7)
    torch.testing.assert_close(fitted.apply(X).to_array(), whole, rtol=0, atol=1e-6)
    torch.testing.assert_close(whole, torch.cat([n.forward(X) for n in nodes], dim=1),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("node,ref", [(NormalizeRows, JNormalizeRows),
                                      (SignedHellingerMapper, JHellinger)],
                         ids=["normalize_rows", "signed_hellinger"])
@pytest.mark.parametrize("shape", [(7, 5), (3, 1), (2, 4, 6)])
def test_elementwise_nodes_match_jax(node, ref, shape):
    X = _x(shape, seed=len(shape), scale=3.0)
    X[0] = 0.0  # a zero row passes through both
    got = node().forward(torch.from_numpy(X)).numpy()
    want = np.asarray(ref().trace_batch(jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert node.row_local
    np.testing.assert_array_equal(got[0], 0.0)


def test_normalize_rows_unit_norm_and_hellinger_values():
    X = torch.tensor([[3.0, -4.0], [0.0, 0.0]])
    np.testing.assert_allclose(NormalizeRows().forward(X).numpy(), [[0.6, -0.8], [0.0, 0.0]],
                               rtol=1e-6)
    np.testing.assert_allclose(SignedHellingerMapper().forward(X)[0].numpy(),
                               [np.sqrt(3.0), -2.0], rtol=1e-6)


@pytest.mark.parametrize("n,d,m,s,seed", [(5, 3, 11, 4, 0), (8, 2, 40, 40, 7), (1, 6, 3, 9, 2)])
def test_column_sampler_batch_draws_the_columns_jax_draws(n, d, m, s, seed):
    X = _x((n, d, m), seed=seed)
    got_sampler, want_sampler = ColumnSampler(s, seed=seed), JColumnSampler(s, seed=seed)
    for _ in range(2):  # the stateful draw advances alike
        got = got_sampler.apply_batch(Dataset.of(torch.from_numpy(X))).to_array().numpy()
        want = np.asarray(want_sampler.apply_batch(JDataset.of(X)).to_array())
        assert got.shape == (n, d, s)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk_index", [0, 3])
def test_column_sampler_chunks_key_on_seed_and_index(chunk_index):
    X = _x((6, 4, 10), seed=1)
    sampler, ref = ColumnSampler(5, seed=11), JColumnSampler(5, seed=11)
    got = sampler.sample_chunk(torch.from_numpy(X), chunk_index).numpy()
    want = np.asarray(ref.sample_chunk(jnp.asarray(X), chunk_index))
    np.testing.assert_array_equal(got, want)
    # a chunk drawn again is the same chunk
    np.testing.assert_array_equal(sampler.sample_chunk(torch.from_numpy(X), chunk_index).numpy(),
                                  got)


def test_column_sampler_items_match_jax():
    items = [_x((3, 9), seed=i) for i in range(4)]
    got_sampler, want_sampler = ColumnSampler(4, seed=2), JColumnSampler(4, seed=2)
    for x in items:
        np.testing.assert_array_equal(got_sampler.apply(torch.from_numpy(x)).numpy(),
                                      np.asarray(want_sampler.apply(x)))
    listed = ColumnSampler(4, seed=2).apply_batch(Dataset.from_items(
        [torch.from_numpy(x) for x in items])).to_array()
    again = ColumnSampler(4, seed=2)
    np.testing.assert_array_equal(listed.numpy(), np.stack(
        [again.apply(torch.from_numpy(x)).numpy() for x in items]))
