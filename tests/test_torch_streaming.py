"""The port's streaming solvers and out-of-core fits against the JAX
package's on the CPU: the streaming BCD, column means, normal equations and
TSQR; the streaming fits of LinearMapEstimator, BlockLeastSquaresEstimator
and TSQRLeastSquaresEstimator; the one-scan StandardScaler; ColumnSampler's
chunked draws; ``LeastSquaresEstimator`` and ``NodeOptimizationRule`` on a
chunked input; TimitPipeline on a ``ChunkedDataset``. One numpy-seeded
input goes through both packages. The JAX scans run with one lane
(``KEYSTONE_SCAN_LANES=1``), as the port's do.

Tolerances (the JAX tests'): streamed weights rtol 2e-3 / atol 2e-4 against
in-memory solves (``tests/linalg/test_streaming_solvers.py``); the same
streamed solve in both packages rtol 1e-4 / atol 1e-5 (float32 sums in
another order); column means rtol 1e-5; StandardScaler mean rtol/atol 1e-4
and std rtol 1e-3 / atol 1e-4 (``tests/data/test_pipeline_scan.py``), at
|mean| 1000 std rtol 0.05 against float64 and 1e-2 against JAX (float32
rounds such values by 0.6 % of that std);
TimitPipeline scores atol 1e-4; ColumnSampler draws equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu import cost as jcost
from keystone_tpu.data import ChunkedDataset as JChunked
from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.linalg import solve_blockwise_l2_streaming as j_stream_bcd
from keystone_tpu.linalg import solve_least_squares_streaming as j_stream_ne
from keystone_tpu.linalg import stream_column_means as j_stream_means
from keystone_tpu.linalg.tsqr import tsqr_r_streaming as j_tsqr_streaming
from keystone_tpu.loaders.csv_loader import LabeledData as JLabeledData
from keystone_tpu.nodes import learning as jlearning
from keystone_tpu.nodes.learning.classifiers import LeastSquaresEstimator as JLeastSquares
from keystone_tpu.nodes.learning.linear import BlockLinearMapper as JBlockMapper
from keystone_tpu.nodes.stats import ColumnSampler as JColumnSampler
from keystone_tpu.nodes.stats import StandardScaler as JStandardScaler
from keystone_tpu.nodes.util import ClassLabelIndicators as JCLI
from keystone_tpu.nodes.util import MaxClassifier as JMax
from keystone_tpu.pipelines import timit as jt
from keystone_tpu.workflow import analysis as janalysis
from keystone_tpu.workflow import fusion as jfusion
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu_torch import cost
from keystone_tpu_torch.data.chunked import ChunkedDataset
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.linalg import bcd, normal_equations, tsqr
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.nodes.learning.classifiers import LeastSquaresEstimator
from keystone_tpu_torch.nodes.learning.linear import (
    BlockLeastSquaresEstimator,
    LinearMapEstimator,
    TSQRLeastSquaresEstimator,
)
from keystone_tpu_torch.nodes.stats import ColumnSampler, StandardScaler
from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.pipelines import timit as tt
from keystone_tpu_torch.workflow import analysis as tanalysis
from keystone_tpu_torch.workflow import fusion as tfusion
from keystone_tpu_torch.workflow import node_optimization
from keystone_tpu_torch.workflow.env import PipelineEnv

CPU = torch.device("cpu")
MEM_TOL = dict(rtol=2e-3, atol=2e-4)  # streamed against in memory
JAX_TOL = dict(rtol=1e-4, atol=1e-5)  # the same streamed solve in both packages


@pytest.fixture(autouse=True)
def port_env(monkeypatch):
    """One scan lane in the JAX package, and the fit-once state of both
    packages reset around each test."""
    monkeypatch.setenv("KEYSTONE_SCAN_LANES", "1")
    envs = (PipelineEnv.get_or_create(), JPipelineEnv.get_or_create())
    for env in envs:
        env.reset()
    yield
    for env in envs:
        env.reset()


def _problem(n=96, d=12, k=3, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((d, k)).astype(np.float32)
    y = (A @ W + 0.01 * rng.standard_normal((n, k))).astype(np.float32)
    return A, y


def _scan(A, chunk):
    return lambda: iter([A[i:i + chunk] for i in range(0, len(A), chunk)])


# ---- linalg ------------------------------------------------------------------


@pytest.mark.parametrize("num_iter", [1, 2, 3])
@pytest.mark.parametrize("chunk", [17, 32, 96])
def test_streaming_bcd_matches_jax_and_the_in_memory_scan(num_iter, chunk):
    A, y = _problem()
    means = A.mean(axis=0)
    ws = bcd.solve_blockwise_l2_streaming(_scan(A, chunk), torch.from_numpy(y), 0.1, 4,
                                          num_iter, means=torch.from_numpy(means))
    got = torch.cat(ws).numpy()
    want = np.concatenate([np.asarray(w) for w in j_stream_bcd(
        _scan(A, chunk), jnp.asarray(y), reg=0.1, block_size=4, num_iter=num_iter,
        means=jnp.asarray(means), lanes=1)])
    np.testing.assert_allclose(got, want, **JAX_TOL)
    mem = bcd.solve_blockwise_l2_scan(torch.from_numpy(A), torch.from_numpy(y), 0.1, 4,
                                      num_iter, means=torch.from_numpy(means))
    np.testing.assert_allclose(got, mem.numpy(), **MEM_TOL)


def test_streaming_bcd_counts_block_steps_and_scans():
    A, y = _problem()
    scans = []

    def scan():
        scans.append(1)
        return _scan(A, 32)()

    before = bcd.solve_blockwise_l2_streaming.block_steps
    bcd.solve_blockwise_l2_streaming(scan, torch.from_numpy(y), 0.1, 4, 2,
                                     means=torch.zeros(12))
    assert bcd.solve_blockwise_l2_streaming.block_steps - before == 6
    assert len(scans) == 6  # one scan a block step


@pytest.mark.parametrize("num_iter", [1, 3])
def test_streaming_bcd_keeps_each_blocks_factor_across_sweeps(num_iter):
    """Three blocks: each factor is formed in the first sweep's scan and
    solves the later sweeps, which accumulate the cross term alone."""
    A, y = _problem()
    means = A.mean(axis=0)
    formed, reused = bcd._block_solve.factors_formed, bcd._block_solve.factors_reused
    ws = bcd.solve_blockwise_l2_streaming(_scan(A, 32), torch.from_numpy(y), 0.1, 4, num_iter,
                                          means=torch.from_numpy(means))
    assert bcd._block_solve.factors_formed - formed == 3
    assert bcd._block_solve.factors_reused - reused == 3 * (num_iter - 1)
    want = np.concatenate([np.asarray(w) for w in j_stream_bcd(
        _scan(A, 32), jnp.asarray(y), reg=0.1, block_size=4, num_iter=num_iter,
        means=jnp.asarray(means), lanes=1)])
    np.testing.assert_allclose(torch.cat(ws).numpy(), want, **JAX_TOL)


def test_streaming_bcd_ragged_last_block_matches_jax():
    A, y = _problem(d=10)  # blocks of 4, 4, 2
    scan = lambda: iter([A[:50], A[50:]])  # noqa: E731
    ws = bcd.solve_blockwise_l2_streaming(scan, torch.from_numpy(y), 0.05, 4)
    assert [w.shape[0] for w in ws] == [4, 4, 2]
    jws = j_stream_bcd(scan, jnp.asarray(y), reg=0.05, block_size=4, lanes=1)
    mem = bcd.solve_blockwise_l2([torch.from_numpy(A[:, s:s + 4]) for s in (0, 4, 8)],
                                 torch.from_numpy(y), 0.05)
    for w, jw, m in zip(ws, jws, mem):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **JAX_TOL)
        np.testing.assert_allclose(w.numpy(), m.numpy(), **MEM_TOL)


def test_chunks_narrower_than_the_means_raise_where_jax_returns_wrong_weights():
    """The JAX package reads d from the caller's means and slices whatever
    the chunks hold (ADVICE.md, ``keystone_tpu/linalg/bcd.py:280``): d 12
    means over 8-wide chunks return three blocks of weights that fit
    nothing. The port raises."""
    A, y = _problem(d=8)
    jws = j_stream_bcd(_scan(A, 32), jnp.asarray(y), reg=0.1, block_size=4,
                       means=jnp.zeros(12), lanes=1)
    assert len(jws) == 3
    with pytest.raises(ValueError, match="8 columns wide.*d = 12"):
        bcd.solve_blockwise_l2_streaming(_scan(A, 32), torch.from_numpy(y), 0.1, 4,
                                         means=torch.zeros(12))
    with pytest.raises(ValueError, match="columns wide"):
        bcd.stream_column_means(_scan(A, 32), d=12)
    ragged = lambda: iter([A[:40], A[40:, :6]])  # noqa: E731
    with pytest.raises(ValueError, match="columns wide"):
        bcd.stream_column_means(ragged)


def test_stream_column_means_match_jax():
    A, _ = _problem()
    means, n = bcd.stream_column_means(lambda: iter([A[:40], A[40:]]))
    jmeans, jn = j_stream_means(lambda: iter([A[:40], A[40:]]), lanes=1)
    assert n == jn == len(A)
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(means.numpy(), A.mean(axis=0), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [16, 40, 96])
def test_streaming_normal_equations_match_jax(chunk):
    A, y = _problem()
    pairs = lambda: iter([(A[i:i + chunk], y[i:i + chunk])  # noqa: E731
                          for i in range(0, len(A), chunk)])
    got = normal_equations.solve_least_squares_streaming(pairs(), reg=1e-2).numpy()
    want = np.asarray(j_stream_ne(pairs(), reg=1e-2, lanes=1))
    np.testing.assert_allclose(got, want, **JAX_TOL)
    mem = normal_equations.solve_least_squares(torch.from_numpy(A), torch.from_numpy(y), 1e-2)
    np.testing.assert_allclose(got, mem.numpy(), **MEM_TOL)


@pytest.mark.parametrize("chunk", [7, 30, 96])
def test_streaming_tsqr_matches_jax_and_tsqr_r(chunk):
    A, _ = _problem(d=10)
    R = tsqr.tsqr_r_streaming(_scan(A, chunk)).numpy()
    np.testing.assert_allclose(R, np.asarray(j_tsqr_streaming(_scan(A, chunk), lanes=1)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(R, tsqr.tsqr_r(torch.from_numpy(A)).numpy(), rtol=1e-4, atol=1e-4)
    tail = np.eye(10, dtype=np.float32)
    R_tail = tsqr.tsqr_r_streaming(_scan(A, chunk), tail=torch.from_numpy(tail)).numpy()
    full = tsqr.tsqr_r(torch.from_numpy(np.concatenate([A, tail]))).numpy()
    np.testing.assert_allclose(R_tail, full, rtol=1e-4, atol=1e-4)


# ---- the estimators -----------------------------------------------------------


ESTIMATORS = {
    "exact": (lambda: LinearMapEstimator(0.1), lambda: jlearning.LinearMapEstimator(0.1)),
    "block": (lambda: BlockLeastSquaresEstimator(4, 2, lam=0.1),
              lambda: jlearning.BlockLeastSquaresEstimator(4, 2, lam=0.1)),
    "block-ragged": (lambda: BlockLeastSquaresEstimator(3, 3, lam=0.1),
                     lambda: jlearning.BlockLeastSquaresEstimator(3, 3, lam=0.1)),
    "tsqr": (lambda: TSQRLeastSquaresEstimator(0.1),
             lambda: jlearning.TSQRLeastSquaresEstimator(0.1)),
    "tsqr-lambda0": (lambda: TSQRLeastSquaresEstimator(0.0),
                     lambda: jlearning.TSQRLeastSquaresEstimator(0.0)),
}


def _apply(model, X):
    return model.forward(torch.from_numpy(X)).numpy()


def _japply(model, X):
    return np.asarray(model.trace_batch(jnp.asarray(X)))


@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_streaming_fits_match_jax_and_the_in_memory_fit(name):
    make, jmake = ESTIMATORS[name]
    A, y = _problem(n=80, d=8, k=2)
    est = make()
    assert est.supports_streaming
    streamed = est.fit(ChunkedDataset.from_array(A, 19), Dataset.of(torch.from_numpy(y)))
    in_memory = est.fit(Dataset.of(torch.from_numpy(A)), Dataset.of(torch.from_numpy(y)))
    jstreamed = jmake().fit(JChunked.from_array(A, 19), JDataset.of(jnp.asarray(y)))
    X = np.random.default_rng(7).standard_normal((5, 8)).astype(np.float32)
    np.testing.assert_allclose(_apply(streamed, X), _japply(jstreamed, X), **JAX_TOL)
    np.testing.assert_allclose(_apply(streamed, X), _apply(in_memory, X), **MEM_TOL)


@pytest.mark.parametrize("name", ["exact", "block", "tsqr"])
def test_a_streaming_fit_refuses_rows_unlike_the_labels(name):
    A, y = _problem(n=80, d=8, k=2)
    with pytest.raises(ValueError, match="rows"):
        ESTIMATORS[name][0]().fit(ChunkedDataset.from_array(A, 19),
                                  Dataset.of(torch.from_numpy(y[:70])))


@pytest.mark.parametrize("name", ["exact", "block", "tsqr"])
def test_a_streaming_fit_refuses_a_source_that_changes_width_between_scans(name):
    A, y = _problem(n=80, d=8, k=2)
    scans = []

    def factory():
        scans.append(1)
        width = 8 if len(scans) == 1 else 6  # the means scan sees 8 columns
        return iter([A[i:i + 20, :width] for i in range(0, 80, 20)])

    with pytest.raises(ValueError, match="columns wide"):
        ESTIMATORS[name][0]().fit(ChunkedDataset(factory, 80), Dataset.of(torch.from_numpy(y)))


def test_block_streaming_fit_scans_num_iter_blocks_plus_one():
    A, y = _problem(n=80, d=8, k=2)
    produced = []

    def chunk_fn(i):
        produced.append(i)
        return A[20 * i:20 * i + 20]

    ds = ChunkedDataset.from_chunk_fn(chunk_fn, 4, 80)
    BlockLeastSquaresEstimator(4, 3, lam=0.1).fit(ds, Dataset.of(torch.from_numpy(y)))
    assert len(produced) == 4 * (3 * 2 + 1)


def test_num_features_streams_the_leading_columns():
    A, y = _problem(n=80, d=8, k=2)
    est = BlockLeastSquaresEstimator(3, 2, lam=0.1, num_features=6)
    streamed = est.fit(ChunkedDataset.from_array(A, 19), Dataset.of(torch.from_numpy(y)))
    jstreamed = jlearning.BlockLeastSquaresEstimator(3, 2, lam=0.1, num_features=6).fit(
        JChunked.from_array(A, 19), JDataset.of(jnp.asarray(y)))
    X = np.random.default_rng(3).standard_normal((5, 6)).astype(np.float32)
    np.testing.assert_allclose(_apply(streamed, X), _japply(jstreamed, X), **JAX_TOL)


@pytest.mark.parametrize("make", [
    lambda d: LinearMapEstimator(snapshot=True),
    lambda d: LinearMapEstimator(lam=0.5, checkpoint=d, checkpoint_every=2),
    lambda d: TSQRLeastSquaresEstimator(lam=0.5, checkpoint=d, checkpoint_every=2),
], ids=["linear-snapshot", "linear-checkpoint", "tsqr-checkpoint"])
def test_snapshots_and_checkpoints_wait_for_a_later_slice(make, request, tmp_path):
    """The snapshot fit carries its state (``tests/test_torch_absorb.py``);
    a checkpointed chunked fit killed by a ``fatal`` fault and run again
    equals the uninterrupted fit bit for bit, drawing only the chunks after
    its last save, and leaves no checkpoint (``tests/test_torch_faults.py``
    holds the rest)."""
    from keystone_tpu_torch import faults

    if request.node.callspec.id == "linear-snapshot":
        A = np.random.default_rng(0).standard_normal((20, 3)).astype(np.float32)
        fitted = make(None).fit(Dataset.of(torch.from_numpy(A)),
                                Dataset.of(torch.from_numpy(A[:, :2])))
        assert fitted.solver_state is not None and fitted.solver_state.n == 20
        return
    A, y = _problem(n=96, d=6, k=2)
    drawn = []

    def chunk_fn(i):
        drawn.append(i)
        return A[16 * i:16 * i + 16]

    ds = ChunkedDataset.from_chunk_fn(chunk_fn, 6, 96)
    labels = Dataset.of(torch.from_numpy(y))
    whole = make(str(tmp_path / "whole")).fit(ds, labels)
    # killed at the pull of chunk 4, after the save at 4 chunks (TSQR's
    # means scan pulls 7 times first: 6 chunks and its end)
    kill_at = {"linear-checkpoint": 4, "tsqr-checkpoint": 7 + 4}[request.node.callspec.id]
    faults.install(faults.parse_plan(f"scan.chunk=fatal@{kill_at}"))
    try:
        with pytest.raises(faults.FatalFaultInjected):
            make(str(tmp_path / "killed")).fit(ds, labels)
    finally:
        faults.clear()
    drawn.clear()
    resumed = make(str(tmp_path / "killed")).fit(ds, labels)
    assert torch.equal(resumed.W, whole.W) and torch.equal(resumed.b, whole.b)
    assert torch.equal(resumed.feature_mean, whole.feature_mean)
    assert drawn == [4, 5]
    assert all(not list(p.iterdir()) for p in tmp_path.iterdir())


def test_block_snapshot_raises_as_in_jax():
    with pytest.raises(ValueError, match="no state to snapshot"):
        BlockLeastSquaresEstimator(4, 1, snapshot=True)


# ---- stats nodes -----------------------------------------------------------------


def test_streaming_standard_scaler_matches_jax_and_the_dense_fit():
    X = np.random.default_rng(17).standard_normal((57, 4)).astype(np.float32) * 3.0 + 1.0
    streamed = StandardScaler().fit(ChunkedDataset.from_array(X, 9))
    dense = StandardScaler().fit(Dataset.of(torch.from_numpy(X)))
    jstreamed = JStandardScaler().fit(JChunked.from_array(X, 9))
    for got, want in ((streamed.mean, jstreamed.mean), (streamed.std, jstreamed.std)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(streamed.mean.numpy(), dense.mean.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(streamed.std.numpy(), dense.std.numpy(), rtol=1e-3, atol=1e-4)
    centered = StandardScaler(normalize_std_dev=False).fit(ChunkedDataset.from_array(X, 9))
    assert centered.std is None


def test_streaming_standard_scaler_survives_a_large_mean_and_small_variance():
    X = (np.random.default_rng(29).standard_normal((64, 3)) * 0.01 + 1000.0).astype(np.float32)
    model = StandardScaler().fit(ChunkedDataset.from_array(X, 9))
    np.testing.assert_allclose(model.std.numpy(), X.astype(np.float64).std(axis=0, ddof=1),
                               rtol=0.05)
    # float32 rounds values near 1000 by ~6e-5, 0.6 % of this std: the two
    # packages' sums in another order differ by that much
    np.testing.assert_allclose(model.std.numpy(),
                               np.asarray(JStandardScaler().fit(JChunked.from_array(X, 9)).std),
                               rtol=1e-2)


@pytest.mark.parametrize("chunk", [3, 5, 16])
def test_column_sampler_chunked_draws_equal_jax(chunk):
    X = np.random.default_rng(5).standard_normal((16, 4, 30)).astype(np.float32)
    out = ColumnSampler(6, seed=11).apply_batch(ChunkedDataset.from_array(X, chunk))
    assert isinstance(out, ChunkedDataset) and len(out) == 16
    want = JColumnSampler(6, seed=11).apply_batch(JChunked.from_array(X, chunk)).to_array()
    np.testing.assert_array_equal(out.to_array().numpy(), np.asarray(want))
    np.testing.assert_array_equal(out.to_array().numpy(), np.asarray(want))  # every scan


# ---- the solver choice on chunked input ----------------------------------------------


@pytest.mark.parametrize("d", [440, 4096, 16384])
@pytest.mark.parametrize("chunked", [True, False])
def test_the_choice_at_timits_full_row_count_equals_jax(d, chunked):
    shape = dict(n=2228224, d=d, k=147, sparsity=1.0, chunked=chunked, machines=1)
    got = LeastSquaresEstimator(num_machines=1).choose_solver(cost.ShapeSignature(**shape))
    want = JLeastSquares(num_machines=1).choose_solver(jcost.ShapeSignature(**shape))
    assert got.label == want.label
    if chunked:
        for name in ("DenseLBFGSwithL2", "SparseLBFGSwithL2"):
            assert got.costs[name]["units"] == float("inf")


def test_least_squares_estimator_streams_a_chunked_input():
    A, y = _problem(n=400, d=6, k=2)
    est = LeastSquaresEstimator(lam=0.1, num_machines=1)
    model = est.fit(ChunkedDataset.from_array(A, 64), Dataset.of(torch.from_numpy(y)))
    jmodel = JLeastSquares(lam=0.1, num_machines=1).fit(JChunked.from_array(A, 64),
                                                        JDataset.of(jnp.asarray(y)))
    assert type(model).__name__ == type(jmodel).__name__
    X = np.random.default_rng(2).standard_normal((5, 6)).astype(np.float32)
    np.testing.assert_allclose(_apply(model, X), _japply(jmodel, X), **JAX_TOL)


def test_node_optimization_plans_a_chunked_input_as_chunked(monkeypatch):
    A, y = _problem(n=400, d=6, k=2)
    shapes = []
    orig = LeastSquaresEstimator.choose_solver

    def spy(self, shape, **kw):
        shapes.append(shape)
        return orig(self, shape, **kw)

    monkeypatch.setattr(LeastSquaresEstimator, "choose_solver", spy)
    for data, chunked in ((ChunkedDataset.from_array(A, 64), True), (torch.from_numpy(A), False)):
        shapes.clear()
        pipe = LeastSquaresEstimator(lam=0.1, num_machines=1).with_data(
            data, torch.from_numpy(y))
        graph, _ = PipelineEnv.get_or_create().optimizer.execute(pipe.graph)
        assert [s.chunked for s in shapes] == [chunked] and shapes[0].n == 400
        chosen = [op for op in graph.operators.values()
                  if type(op).__name__.endswith("Estimator")]
        assert len(chosen) == 1 and not isinstance(chosen[0], LeastSquaresEstimator)
        assert not chunked or chosen[0].supports_streaming


# ---- TimitPipeline on a ChunkedDataset -----------------------------------------------


CONF = dict(num_cosines=3, num_epochs=2, lam=10.0, num_classes=12, cosine_features=256,
            gamma=0.02)
CHUNK = 200


def _plan(analysis, fusion, graph):
    order = [g for g in analysis.linearize(graph) if g in graph.operators]
    pos = {g: i for i, g in enumerate(order)}
    rows = []
    for g in order:
        op = graph.get_operator(g)
        steps = ([s.label for s, _ in op.steps]
                 if isinstance(op, fusion.FusedTransformerOperator) else None)
        rows.append((type(op).__name__, steps,
                     tuple(pos.get(d, "source") for d in graph.get_dependencies(g))))
    return rows


@pytest.fixture(scope="module")
def chunked_timit():
    """TimitPipeline fitted on a chunked training set in both packages, the
    port with the JAX branches' W and b; the port's source counts the
    chunks it produces and its BCD fits."""
    JPipelineEnv.get_or_create().reset()
    PipelineEnv.get_or_create().reset()
    conf_j = jt.TimitConfig(**CONF)
    train = jt.synthetic_timit(768, 12, seed=1)
    test = jt.synthetic_timit(256, 12, seed=2)
    X, labels = np.array(train.data.to_array()), np.array(train.labels.to_array())
    Xt = np.array(test.data.to_array())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEYSTONE_SCAN_LANES", "1")
        predictor, evaluation, _ = jt.run(JLabeledData(labels, JChunked.from_array(X, CHUNK)),
                                          test, conf_j)
    mapper = next(o for o in predictor.fit().graph.operators.values()
                  if isinstance(o, JBlockMapper))
    j_scores = np.asarray(mapper.trace_batch(
        jnp.asarray(jt.build_featurizer(conf_j)(Xt).get().to_array())))
    params = [(np.asarray(n.W), np.asarray(n.b))
              for n in (jt._cosine_branch(conf_j, i) for i in range(conf_j.num_cosines))]

    produced, fits = [], []
    n_chunks = -(-len(X) // CHUNK)

    def chunk_fn(i):
        produced.append(i)
        return torch.from_numpy(X[CHUNK * i:CHUNK * (i + 1)])

    orig_fit = BlockLeastSquaresEstimator.fit

    def counted_fit(self, data, y):
        fits.append(data.is_chunked)
        return orig_fit(self, data, y)

    t_train = LabeledData(labels, ChunkedDataset.from_chunk_fn(chunk_fn, n_chunks, len(X)))
    t_test = LabeledData(np.array(test.labels.to_array()), Xt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BlockLeastSquaresEstimator, "fit", counted_fit)
        scorer, t_tr, t_te, _ = tt.run(t_train, t_test, tt.TimitConfig(**CONF), CPU,
                                       params=params)
    scans = len(produced) / n_chunks
    t_scores = scorer.fit().apply(torch.from_numpy(Xt)).to_array().numpy()
    return dict(j_scores=j_scores, j_error=evaluation.total_error, t_scores=t_scores,
                t_errs=(t_tr, t_te), scans=scans, fits=fits, params=params, X=X,
                labels=labels, conf_j=conf_j)


def test_chunked_timit_scores_match_jaxs_chunked_run(chunked_timit):
    got, want = chunked_timit["t_scores"], chunked_timit["j_scores"]
    assert got.shape == want.shape == (256, 12)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert chunked_timit["t_errs"][1] == chunked_timit["j_error"] < 0.2


def test_chunked_timit_fits_once_in_the_scans_the_solver_needs(chunked_timit):
    assert chunked_timit["fits"] == [True]
    # the means scan, num_epochs × nblocks block steps, then the train error's scan
    assert chunked_timit["scans"] == 1 + 2 * 3 + 1


def test_chunked_timit_plan_equals_jax_with_one_fused_featurizer_on_the_chunks():
    conf_j = jt.TimitConfig(**CONF)
    X = np.random.default_rng(4).standard_normal((96, 440)).astype(np.float32)
    y = np.random.default_rng(5).integers(0, 12, size=96)
    params = [(np.asarray(n.W), np.asarray(n.b))
              for n in (jt._cosine_branch(conf_j, i) for i in range(conf_j.num_cosines))]
    j_pipe = jt.build_featurizer(conf_j).and_then(
        jlearning.BlockLeastSquaresEstimator(256, 2, 10.0), JChunked.from_array(X, 40),
        JCLI(12).apply_batch(JDataset.of(jnp.asarray(y)))).and_then(JMax())
    chunked = ChunkedDataset.from_array(X, 40)
    t_pipe = tt.build_featurizer(tt.TimitConfig(**CONF), CPU, params).and_then(
        BlockLeastSquaresEstimator(256, 2, 10.0), chunked,
        ClassLabelIndicators(12).forward(torch.from_numpy(y))).and_then(MaxClassifier())
    jg, _ = JPipelineEnv.get_or_create().optimizer.execute(j_pipe.graph)
    tg, _ = PipelineEnv.get_or_create().optimizer.execute(t_pipe.graph)
    plan = _plan(tanalysis, tfusion, tg)
    assert plan == _plan(janalysis, jfusion, jg)
    fused = [steps for _, steps, _ in plan if steps]
    assert fused == [["CosineRandomFeatures"] * 3 + ["GatherTransformerOperator",
                                                     "VectorCombiner"]] * 2
    # the estimator's data input flows from the chunked leaf: the
    # optimizer plans it as chunked
    (est,) = [n for n in tg.nodes if isinstance(tg.get_operator(n), BlockLeastSquaresEstimator)]
    assert node_optimization._chunked_input(tg, est)
    (fit_input,) = [n for n in tg.get_dependencies(est)[:1]]
    assert isinstance(tg.get_operator(fit_input), tfusion.FusedTransformerOperator)
