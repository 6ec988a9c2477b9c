"""The port's ``ChunkedDataset`` (``keystone_tpu_torch/data/chunked.py``) and
its place in the workflow (the gather, VectorCombiner, transformers, fused
groups, the executor) against the JAX package's on the CPU: the cases of
``tests/data/test_chunked.py`` on one numpy input through both packages.

Tolerances: chunking moves rows without arithmetic (equal); chains of
float32 arithmetic rtol 1e-6, as the JAX tests hold them.
"""

import threading

import numpy as np
import pytest
import torch

from keystone_tpu.data import ChunkedDataset as JChunked
from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.data.chunked import align_and_zip as j_align_and_zip
from keystone_tpu.nodes.util import VectorCombiner as JVectorCombiner
from keystone_tpu.workflow.pipeline import Pipeline as JPipeline
from keystone_tpu.workflow.transformer import FunctionNode as JFunctionNode
from keystone_tpu_torch.data.chunked import ChunkedDataset, align_and_zip, prefetch_to_device
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.data.pipeline_scan import bucket_ladder
from keystone_tpu_torch.nodes.util import VectorCombiner
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.fusion import FusedTransformerOperator
from keystone_tpu_torch.workflow.pipeline import Pipeline
from keystone_tpu_torch.workflow.transformer import FunctionNode, Transformer


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


def _src(n=37, d=5, chunk=8, seed=0):
    X = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return X, ChunkedDataset.from_array(X, chunk)


def _cat(chunks, i=None):
    return np.concatenate([np.asarray(c if i is None else c[i]) for c in chunks])


def test_len_iter_first_to_array_equal_jax():
    X, ds = _src()
    jds = JChunked.from_array(X, 8)
    assert len(ds) == len(jds) == 37
    assert ds.is_batched and ds.is_chunked and not Dataset.of(X).is_chunked
    np.testing.assert_array_equal(ds.to_array().numpy(), np.asarray(jds.to_array()))
    np.testing.assert_array_equal(ds.first().numpy(), np.asarray(jds.first()))
    items = list(ds)
    assert len(items) == 37
    np.testing.assert_array_equal(items[11].numpy(), np.asarray(list(jds)[11]))


@pytest.mark.parametrize("n", [0, 1, 8, 10, 37])
def test_take_equals_jax_and_reads_the_leading_chunks_only(n):
    X = np.random.default_rng(1).standard_normal((37, 5)).astype(np.float32)
    produced = []

    def chunk_fn(i):
        produced.append(i)
        return X[8 * i:8 * i + 8]

    ds = ChunkedDataset.from_chunk_fn(chunk_fn, 5, 37)
    got = ds.take(n)
    want = JChunked.from_array(X, 8).take(n)
    assert len(got) == len(want) == n
    if n:
        np.testing.assert_array_equal(got.to_array().numpy(), np.asarray(want.to_array()))
    assert len(produced) == max(1, -(-n // 8))


def test_map_batch_is_lazy_and_recomputes_per_scan():
    X, ds = _src()
    calls = []

    def fn(chunk):
        calls.append(1)
        return chunk * 2.0

    mapped = ds.map_batch(fn)
    assert not calls
    np.testing.assert_allclose(mapped.to_array().numpy(), X * 2)
    assert len(calls) == 5  # ceil(37 / 8)
    mapped.to_array()
    assert len(calls) == 10  # lineage: recomputed per scan


def test_map_per_item_equals_jax():
    X, ds = _src()
    want = np.asarray(JChunked.from_array(X, 8).map(lambda row: row.sum()).to_array())
    np.testing.assert_allclose(ds.map(lambda row: row.sum()).to_array().numpy(), want, rtol=1e-6)
    # after a step the per-item map runs on the consumer, as a step
    got = ds.map_batch(lambda c: c + 1.0).map(lambda row: row.sum()).to_array().numpy()
    np.testing.assert_allclose(got, (X + 1.0).sum(axis=1), rtol=1e-6)


def test_cache_materializes_under_the_budget_only():
    X, ds = _src()
    cached = ds.cache(budget_bytes=1 << 20)
    assert not isinstance(cached, ChunkedDataset)
    np.testing.assert_array_equal(cached.to_array().numpy(), X)
    assert ds.cache(budget_bytes=16) is ds


def test_zip_chunks_aligned_and_misaligned_equal_jax():
    X, a = _src(seed=1)
    Y, b = _src(seed=2)
    chunks = list(ChunkedDataset.zip_chunks([a, b.map_batch(lambda c: c - 1.0)]).chunks())
    assert all(isinstance(c, tuple) and len(c) == 2 for c in chunks)
    jchunks = list(JChunked.zip_chunks([JChunked.from_array(X, 8),
                                        JChunked.from_array(Y, 8)]).chunks())
    np.testing.assert_array_equal(_cat(chunks, 0), _cat(jchunks, 0))
    np.testing.assert_allclose(_cat(chunks, 1), _cat(jchunks, 1) - 1.0, rtol=1e-6)
    with pytest.raises(ValueError):
        list(ChunkedDataset.zip_chunks([a, ChunkedDataset.from_array(Y, 7)]).chunks())


@pytest.mark.parametrize("order", ["three_then_two", "two_then_three"])
def test_zip_chunks_counts_rows_where_jax_drops_a_chunk(order):
    """A deliberate divergence. Branches of 3 and 2 two-row chunks, both
    declared at 6 rows: with the 3-chunk branch first, the JAX package's
    zip() consumes its third chunk and drops it, and the scan yields 4 rows
    with no error; in the other order it raises. The port counts the rows
    it yields against the declared length and raises in both orders."""

    def branches(cls, arr):
        def make(k):
            return cls(lambda: (arr[2 * i:2 * i + 2] for i in range(k)), 6, label=f"c{k}")
        pair = [make(3), make(2)]
        return pair if order == "three_then_two" else pair[::-1]

    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    jzip = JChunked.zip_chunks(branches(JChunked, X))
    if order == "three_then_two":
        assert sum(int(c[0].shape[0]) for c in jzip.chunks()) == 4
    else:
        with pytest.raises(ValueError):
            list(jzip.chunks())
    with pytest.raises(ValueError, match="chunk"):
        list(ChunkedDataset.zip_chunks(branches(ChunkedDataset, torch.from_numpy(X))).chunks())


def test_shuffler_refuses_a_chunked_dataset_where_jax_fails():
    """A deliberate divergence: both packages cannot shuffle a chunked
    dataset, since it would permute across chunks. The JAX package fails
    with a TypeError from indexing its chunk factory; the port raises a
    clear ValueError, as its batch-coupled nodes do."""
    from keystone_tpu.nodes.util import Shuffler as JShuffler
    from keystone_tpu_torch.nodes.util import Shuffler

    X, ds = _src()
    with pytest.raises(TypeError):
        JShuffler(3).apply_batch(JChunked.from_array(X, 8))
    with pytest.raises(ValueError, match="per chunk"):
        Shuffler(3).apply_batch(ds)


def test_a_transformer_composes_per_chunk():
    X, ds = _src()
    out = FunctionNode(batch_fn=lambda x: x + 1.0).apply_batch(ds)
    assert isinstance(out, ChunkedDataset)
    np.testing.assert_allclose(out.to_array().numpy(), X + 1, rtol=1e-6)


class _BatchMean(Transformer):
    batch_coupled = True

    def forward(self, X):
        return X - X.mean(dim=0)


def test_batch_coupled_nodes_refuse_chunked_input():
    X, ds = _src()
    with pytest.raises(ValueError, match="batch-coupled"):
        _BatchMean().apply_batch(ds)
    pipe = _BatchMean().and_then(FunctionNode(batch_fn=lambda x: x * 2.0))
    with pytest.raises(ValueError, match="batch-coupled"):
        pipe.apply(ds).get()
    # in memory the node runs on the whole batch
    np.testing.assert_allclose(_BatchMean().apply_batch(torch.from_numpy(X)).to_array().numpy(),
                               X - X.mean(axis=0), atol=1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_gather_and_vector_combiner_zip_chunked_branches(fused):
    X, ds = _src()
    b1 = FunctionNode(batch_fn=lambda x: x * 2.0)
    b2 = FunctionNode(batch_fn=lambda x: x - 1.0)
    if not fused:
        b1.no_fuse = b2.no_fuse = True
    out = Pipeline.gather([b1, b2]).and_then(VectorCombiner()).apply(ds).get()
    assert isinstance(out, ChunkedDataset)
    jpipe = JPipeline.gather([JFunctionNode(batch_fn=lambda x: x * 2.0),
                              JFunctionNode(batch_fn=lambda x: x - 1.0)]).and_then(
        JVectorCombiner())
    want = np.asarray(jpipe.apply(JChunked.from_array(X, 8)).get().to_array())
    np.testing.assert_allclose(out.to_array().numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(want, np.concatenate([X * 2, X - 1], axis=-1), rtol=1e-6)


def test_vector_combiner_joins_zipped_chunk_tuples():
    X, a = _src(seed=4)
    Y, b = _src(seed=5)
    out = VectorCombiner().apply_batch(ChunkedDataset.zip_chunks([a, b]))
    assert isinstance(out, ChunkedDataset)
    np.testing.assert_array_equal(out.to_array().numpy(), np.concatenate([X, Y], axis=1))


def test_from_chunk_fn_gives_the_same_chunks_every_scan():
    def chunk_fn(i):
        return np.random.default_rng(100 + i).standard_normal((4, 3)).astype(np.float32)

    ds = ChunkedDataset.from_chunk_fn(chunk_fn, num_chunks=3, num_rows=12)
    a = ds.to_array().numpy()
    np.testing.assert_array_equal(a, ds.to_array().numpy())
    jds = JChunked.from_chunk_fn(chunk_fn, num_chunks=3, num_rows=12)
    np.testing.assert_array_equal(a, np.asarray(jds.to_array()))


def test_raw_chunks_skip_starts_at_a_chunk():
    X, ds = _src()
    skipped = list(ds.raw_chunks(skip=2))
    np.testing.assert_array_equal(_cat(skipped), X[16:])
    opaque = ChunkedDataset(lambda: iter([X[:8], X[8:16], X[16:]]), 37)
    np.testing.assert_array_equal(_cat(opaque.raw_chunks(skip=1)), X[8:])


def test_align_and_zip_slices_a_materialized_branch_in_one_scan():
    X, base = _src(seed=3)
    scans = []
    counted = ChunkedDataset(lambda: (scans.append(1) or iter(list(base._payload()))),
                             len(base))
    zipped = align_and_zip([counted, Dataset(torch.from_numpy(X * 3.0))])
    assert len(zipped) == len(base) and not scans
    chunks = list(zipped.chunks())
    assert len(scans) == 1
    jchunks = list(j_align_and_zip([JChunked.from_array(X, 8),
                                    JDataset(np.asarray(X * 3.0), batched=True)]).chunks())
    for i in (0, 1):
        np.testing.assert_allclose(_cat(chunks, i), _cat(jchunks, i), rtol=1e-6)
    assert all(c[0].shape[0] == c[1].shape[0] for c in chunks)


def test_rechunk_batched_cuts_a_materialized_dataset_at_the_given_sizes():
    from keystone_tpu.data.chunked import rechunk_batched as j_rechunk

    from keystone_tpu_torch.data.chunked import rechunk_batched

    X = np.random.default_rng(2).standard_normal((20, 3)).astype(np.float32)
    sizes = [8, 5, 7]
    ds = rechunk_batched(Dataset((torch.from_numpy(X), torch.from_numpy(X * 2.0))), sizes)
    chunks = list(ds.chunks())
    assert [c[0].shape[0] for c in chunks] == sizes and len(ds) == 20
    jchunks = list(j_rechunk(JDataset((X, X * 2.0), batched=True), sizes).chunks())
    for i in (0, 1):
        np.testing.assert_array_equal(_cat(chunks, i), _cat(jchunks, i))


def test_align_and_zip_errors():
    X, a = _src(seed=3)
    with pytest.raises(ValueError):
        align_and_zip([Dataset(torch.from_numpy(X))])
    with pytest.raises(ValueError):
        align_and_zip([a, Dataset(torch.from_numpy(X[:-1]))])
    with pytest.raises(ValueError):
        list(align_and_zip([a, ChunkedDataset.from_array(X, 7)]).chunks())
    twin = ChunkedDataset.from_array(X * 2.0, 8).map_batch(lambda c: c + 1.0)
    tri = list(align_and_zip([a, twin, Dataset(torch.from_numpy(X * 3.0))]).chunks())
    np.testing.assert_allclose(_cat(tri, 1), X * 2.0 + 1.0, rtol=1e-6)
    np.testing.assert_allclose(_cat(tri, 2), X * 3.0, rtol=1e-6)


def test_prefetch_to_device_reads_ahead_boundedly():
    chunks = [np.random.default_rng(4).standard_normal((5, 3)).astype(np.float32)
              for _ in range(7)]
    pulled = []

    def source():
        for c in chunks:
            pulled.append(1)
            yield c

    it = prefetch_to_device(source(), depth=3)
    first = next(it)
    assert len(pulled) <= 4
    out = [first] + list(it)
    assert len(out) == 7
    for got, want in zip(out, chunks):
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)


def test_first_of_an_empty_chunked_dataset_raises():
    empty = ChunkedDataset(lambda: iter([]), 0)
    assert len(empty.take(3)) == 0
    with pytest.raises(IndexError):
        empty.first()
    with pytest.raises(ValueError):
        empty.to_array()


# -- fused groups and the executor on chunked input ----------------------------


def test_a_fused_group_runs_per_chunk_on_the_consumer_in_bounded_shapes():
    sizes = [40, 40, 33, 40, 12]
    rng = np.random.default_rng(9)
    parts = [rng.standard_normal((r, 6)).astype(np.float32) for r in sizes]
    ds = ChunkedDataset.from_chunk_fn(lambda i: parts[i], len(sizes), sum(sizes))
    seen = []

    def f1(x):
        seen.append((int(x.shape[0]), threading.current_thread().name))
        return x * 3.0

    pipe = FunctionNode(batch_fn=f1).and_then(FunctionNode(batch_fn=lambda x: x - 2.0))
    graph, _ = PipelineEnv.get_or_create().optimizer.execute(pipe.apply(ds)._executor.input_graph)
    fused = [graph.get_operator(n) for n in graph.nodes
             if isinstance(graph.get_operator(n), FusedTransformerOperator)]
    assert len(fused) == 1
    seen.clear()
    out = pipe.apply(ds).get()
    assert not seen  # lazy until a consumer scans
    np.testing.assert_allclose(out.to_array().numpy(), np.concatenate(parts) * 3.0 - 2.0,
                               rtol=1e-6)
    assert {name for _, name in seen} == {threading.current_thread().name}
    assert {rows for rows, _ in seen} <= set(bucket_ladder(40))


@pytest.mark.parametrize("parallel", ["1", "0"])
def test_the_executor_keeps_chunked_branches_lazy_until_consumed(monkeypatch, parallel):
    """The concurrent scheduler forces independent branches on its pool;
    on chunked input that builds their chains and produces no chunk. The
    branches are nodes of their own under node dispatch only: segment
    dispatch runs them and the join as one segment (the test below)."""
    monkeypatch.setenv("KEYSTONE_PAR_EXEC", parallel)
    monkeypatch.setenv("KEYSTONE_SEGMENT_COMPILE", "0")
    X = np.random.default_rng(6).standard_normal((50, 4)).astype(np.float32)
    produced = []

    def chunk_fn(i):
        produced.append(i)
        return X[10 * i:10 * i + 10]

    ds = ChunkedDataset.from_chunk_fn(chunk_fn, 5, 50)
    branches = []
    for k in range(3):
        b = FunctionNode(batch_fn=lambda x, k=k: x * (k + 1.0))
        b.no_fuse = True  # three unfused branches: the scheduler's width is 3
        branches.append(b)
    result = Pipeline.gather(branches).and_then(VectorCombiner()).apply(ds)
    out = result.get()
    assert isinstance(out, ChunkedDataset) and produced == []
    np.testing.assert_allclose(out.to_array().numpy(),
                               np.concatenate([X, 2 * X, 3 * X], axis=1), rtol=1e-6)
    # one scan of the source for each branch of the zip
    assert sorted(produced) == sorted(list(range(5)) * 3)


def test_a_segment_of_chunked_branches_scans_its_source_once():
    """Segment dispatch runs the three branches and their join as one
    segment per chunk: lazy until consumed, the same answer, one scan of
    the source where node dispatch makes one a branch."""
    from keystone_tpu_torch.obs import tracer as tracer_mod

    X = np.random.default_rng(6).standard_normal((50, 4)).astype(np.float32)
    produced = []

    def chunk_fn(i):
        produced.append(i)
        return X[10 * i:10 * i + 10]

    branches = []
    for k in range(3):
        b = FunctionNode(batch_fn=lambda x, k=k: x * (k + 1.0))
        b.no_fuse = True
        branches.append(b)
    tracer = tracer_mod.install(tracer_mod.Tracer())
    try:
        out = Pipeline.gather(branches).and_then(VectorCombiner()).apply(
            ChunkedDataset.from_chunk_fn(chunk_fn, 5, 50)).get()
        assert isinstance(out, ChunkedDataset) and produced == []
        np.testing.assert_allclose(out.to_array().numpy(),
                                   np.concatenate([X, 2 * X, 3 * X], axis=1), rtol=1e-6)
        paths = [s.attrs["path"] for s in tracer.spans() if s.name == "exec.segment"]
    finally:
        tracer_mod.reset()
    assert paths == ["chunked"]
    assert produced == list(range(5))


def test_the_fit_graph_reads_chunked_input_lazily_into_a_streaming_fit():
    from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator

    X = np.random.default_rng(8).standard_normal((60, 5)).astype(np.float32)
    Y = torch.from_numpy(X @ np.arange(10, dtype=np.float32).reshape(5, 2))
    ds = ChunkedDataset.from_array(X, 16)
    pipe = FunctionNode(batch_fn=lambda x: x * 2.0).and_then(LinearMapEstimator(0.0), ds, Y)
    fitted = pipe.fit()
    got = fitted.apply(torch.from_numpy(X)).to_array().numpy()
    np.testing.assert_allclose(got, Y.numpy(), atol=1e-3)
