"""The port's device mesh (``keystone_tpu_torch/parallel/``) against the JAX
package's on the suite's 8-device virtual mesh: ``make_mesh`` shapes and
errors, ``pad_to_multiple``, the layouts ``shard_batch`` and
``shard_classes`` choose (with their fall-back to replication), the lane
count and its clamp, the round robin of ``lane_devices``, the placements
over a mesh, the crossings ``gather_lane_partials`` counts, ``tsqr_r(mesh=)``,
``RowShardedMatrix``, the model-sharded BCD scan on a 4×2 mesh, the
mesh-sized machine counts of the cost models (the command line's
``--backend`` / ``--cpuDevices`` are in ``test_torch_cli.py``).

The port's virtual devices are 8 slots of the CPU (``provision_virtual_devices``);
each test restores the port's provisioned slots and default mesh in the
autouse fixture, so no later test sees them. Tolerance: 1e-6 absolute on
values scaled to O(1), where both packages do the same float32 arithmetic
in another order."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.parallel import lanes as jlanes
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu.parallel import placement as jplacement
from keystone_tpu_torch.parallel import lanes, mesh, placement, virtual
from keystone_tpu_torch.workflow.env import PipelineEnv

TOL = 1e-6


@pytest.fixture(autouse=True)
def port_mesh():
    """8 virtual devices in the port, as the conftest gives the JAX package;
    the port's slots and default mesh are restored afterwards."""
    saved = (mesh._default_mesh, virtual._slots)
    PipelineEnv.get_or_create().reset()
    virtual.provision_virtual_devices(8)
    yield
    mesh._default_mesh, virtual._slots = saved
    PipelineEnv.get_or_create().reset()


@contextlib.contextmanager
def both_meshes(n_data, n_model):
    with jmesh.use_mesh(jmesh.make_mesh(n_data=n_data, n_model=n_model)), \
            mesh.use_mesh(mesh.make_mesh(n_data=n_data, n_model=n_model)):
        yield


def _spec(sharding):
    return None if sharding is None or not hasattr(sharding, "spec") else tuple(sharding.spec)


# -- mesh construction --------------------------------------------------------


@pytest.mark.parametrize("n_data,n_model", [(None, 1), (None, 2), (4, 2), (2, 4), (8, 1), (1, 8),
                                            (3, 2)])
def test_make_mesh_shapes_equal_jax(n_data, n_model):
    j = jmesh.make_mesh(n_data=n_data, n_model=n_model)
    t = mesh.make_mesh(n_data=n_data, n_model=n_model)
    assert t.shape == dict(j.shape)
    assert t.size == j.size
    assert [s.index for s in t.devices.flat] == [d.id for d in j.devices.flat]
    assert all(s.device == torch.device("cpu") for s in t.devices.flat)


@pytest.mark.parametrize("n_data,n_model", [(16, 1), (3, 3), (0, 1), (2, 0)])
def test_make_mesh_errors_equal_jax(n_data, n_model):
    with pytest.raises(ValueError, match="needs"):
        jmesh.make_mesh(n_data=n_data, n_model=n_model)
    with pytest.raises(ValueError, match="needs"):
        mesh.make_mesh(n_data=n_data, n_model=n_model)


def test_without_a_card_or_virtual_devices_there_is_no_mesh_and_one_lane(monkeypatch):
    virtual.clear_virtual_devices()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.default_mesh()
    assert lanes.scan_lanes() == 1 and mesh.mesh_size() == 1
    x = torch.ones(8, 3)
    assert mesh.shard_batch(x) is x
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    m = mesh.default_mesh()
    assert m.shape == {"data": 1, "model": 1}
    assert m.devices[0, 0] == mesh.Slot(0, torch.device("cuda", 0))
    assert lanes.scan_lanes() == 1 and mesh.mesh_size() == 1


def test_use_mesh_and_set_default_mesh_restore():
    small = mesh.make_mesh(n_data=2)
    with mesh.use_mesh(small):
        assert mesh.default_mesh() is small and lanes.scan_lanes() == 2
    assert mesh.default_mesh().size == 8
    mesh.set_default_mesh(small)
    assert mesh.mesh_n_data() == 2
    virtual.provision_virtual_devices(4)  # provisioning drops a set mesh, as in JAX
    assert mesh.mesh_n_data() == 4


def test_virtual_slots_of_one_card_make_a_mesh():
    slots = virtual.virtual_slots(4, "cuda:0")
    m = mesh.make_mesh(devices=slots)
    assert m.shape == {"data": 4, "model": 1}
    assert [str(s) for s in m.devices.flat] == [f"cuda:0#{i}" for i in range(4)]
    assert placement.data_axis_devices(mesh=m) == [torch.device("cuda", 0)] * 4


def test_provision_from_env(monkeypatch):
    virtual.clear_virtual_devices()
    monkeypatch.setenv("KEYSTONE_VIRTUAL_DEVICES", "4")
    assert virtual.provision_from_env() == 4
    assert mesh.default_mesh().size == 4
    monkeypatch.setenv("KEYSTONE_VIRTUAL_DEVICES", "1")
    assert virtual.provision_from_env() == 1
    assert mesh.default_mesh().size == 4  # one asks for nothing


def test_the_port_exports_every_name_of_the_jax_package():
    import keystone_tpu.parallel as jpar
    import keystone_tpu_torch.parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)


# -- padding and layouts ------------------------------------------------------


@pytest.mark.parametrize("shape,multiple,axis", [((5, 3), 4, 0), ((8, 2), 4, 0), ((3, 5), 4, 1),
                                                 ((7,), 8, 0), ((0, 2), 3, 0)])
def test_pad_to_multiple_equals_jax(shape, multiple, axis):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) + 1.0
    jp, jn = jmesh.pad_to_multiple(x, multiple, axis=axis)
    tp, tn = mesh.pad_to_multiple(torch.from_numpy(x), multiple, axis=axis)
    assert tn == jn
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2)])
@pytest.mark.parametrize("shape", [(16, 3), (6, 3), (8,), (4, 2, 2), ()])
def test_shard_batch_layout_equals_jax(n_data, n_model, shape):
    x = np.ones(shape, np.float32)
    with both_meshes(n_data, n_model):
        j = jmesh.shard_batch(x)
        t = mesh.shard_batch(torch.from_numpy(x))
    assert _spec(mesh.sharding_of(t)) == _spec(j.sharding)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("shape,axis", [((8, 3), 0), ((6, 3), 0), ((3, 4), 1), ((2, 3, 3), 0)])
def test_shard_classes_layout_equals_jax(n_data, n_model, shape, axis):
    x = np.ones(shape, np.float32)
    with both_meshes(n_data, n_model):
        j = jmesh.shard_classes(x, axis=axis)
        t = mesh.shard_classes(torch.from_numpy(x), axis=axis)
    if n_model == 1:
        # a data-only mesh: both hand the array back with no placement
        assert mesh.sharding_of(t) is None and _spec(j.sharding) is None
    else:
        assert _spec(mesh.sharding_of(t)) == _spec(j.sharding)


def test_layout_descriptors_equal_jax():
    with both_meshes(4, 2):
        for jfn, tfn in [(jmesh.batch_sharding, mesh.batch_sharding),
                         (jmesh.column_sharding, mesh.column_sharding)]:
            for ndim in (1, 2, 3):
                assert tfn(ndim=ndim).spec == tuple(jfn(ndim=ndim).spec)
        assert mesh.replicated_sharding().spec == tuple(jmesh.replicated_sharding().spec)
        assert _spec(mesh.sharding_of(mesh.replicate(np.ones(3)))) == _spec(
            jmesh.replicate(np.ones(3)).sharding)
        assert mesh.mesh_n_data() == jmesh.mesh_n_data() == 4


def test_shard_batch_keeps_the_callers_tensor_unannotated():
    x = torch.ones(8, 2)
    t = mesh.shard_batch(x)
    assert mesh.sharding_of(t) is not None and mesh.sharding_of(x) is None
    assert t.data_ptr() == x.data_ptr()


# -- lanes --------------------------------------------------------------------


def test_scan_lanes_default_env_override_and_clamp_equal_jax(monkeypatch):
    assert lanes.scan_lanes() == jlanes.scan_lanes() == 8
    for raw, want in (("4", 4), ("1", 1), ("64", 8)):
        monkeypatch.setenv("KEYSTONE_SCAN_LANES", raw)
        assert lanes.scan_lanes() == jlanes.scan_lanes() == want
    monkeypatch.delenv("KEYSTONE_SCAN_LANES")
    with both_meshes(2, 4):
        assert lanes.scan_lanes() == jlanes.scan_lanes() == 2


@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2)])
@pytest.mark.parametrize("k", [1, 3, 8, 11])
def test_lane_devices_round_robin_equals_jax(n_data, n_model, k):
    with both_meshes(n_data, n_model):
        assert ([s.index for s in lanes.lane_devices(k)]
                == [d.id for d in jlanes.lane_devices(k)])


class _Scan:
    def __init__(self):
        self.collectives = 0

    def record_collectives(self, n):
        self.collectives += n


@pytest.mark.parametrize("live", [[0, 1, 2, 3], [0, 1], [0], [0, 1, 2]])
def test_reduce_lane_partials_counts_and_sums_as_jax(live):
    rng = np.random.default_rng(3)
    parts = [rng.standard_normal((3, 2)).astype(np.float32) for _ in range(4)]
    jdevs = jlanes.lane_devices(4)
    import jax

    jparts = [jax.device_put(parts[i], jdevs[i]) if i in live else None for i in range(4)]
    tparts = [torch.from_numpy(parts[i]) if i in live else None for i in range(4)]
    js, ts = _Scan(), _Scan()
    jt = jlanes.reduce_lane_partials(jparts, scan=js)
    tt = lanes.reduce_lane_partials(tparts, scan=ts)
    assert ts.collectives == js.collectives == len(live) - 1
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=TOL)
    # tuples of partials reduce leaf by leaf, the gather keeps lane order
    pairs = lanes.gather_lane_partials([(p, 2 * p) if p is not None else None for p in tparts])
    assert len(pairs) == len(live)
    assert lanes.reduce_lane_partials([None, None]) is None


# -- placement over a mesh ------------------------------------------------------


@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2), (2, 4)])
def test_placement_over_a_mesh_equals_jax(n_data, n_model):
    with both_meshes(n_data, n_model):
        assert len(placement.data_axis_devices()) == len(jplacement.data_axis_devices()) == n_data
        for n in (None, 3, 11):
            assert len(placement.replica_devices(n)) == len(jplacement.replica_devices(n))
        for workers in (1, 3, n_data, 12):
            for w in range(workers):
                assert (placement.worker_device_indices(w, workers)
                        == jplacement.worker_device_indices(w, workers))


def test_the_cluster_worker_places_its_replicas_as_the_jax_worker():
    """A worker given virtual devices serves over its share of them: the
    devices ``_worker_devices`` returns equal the JAX worker's in number,
    one worker or several, with and without a replica count."""
    from keystone_tpu.cluster import worker as jworker
    from keystone_tpu_torch.cluster import worker as tworker

    for workers, replicas in ((1, None), (2, None), (3, None), (1, 3), (4, 5)):
        for w in range(workers):
            got = tworker._worker_devices(w, workers, replicas)
            want = jworker._worker_devices(w, workers, replicas)
            assert len(got) == len(want)
            assert set(got) == {torch.device("cpu")}


# -- TSQR and the row-sharded matrix -----------------------------------------


@pytest.mark.parametrize("n", [96, 100, 5])
def test_tsqr_r_over_the_mesh_equals_jax(n):
    from keystone_tpu.linalg import tsqr as jtsqr
    from keystone_tpu_torch.linalg import tsqr

    A = np.random.default_rng(n).standard_normal((n, 8)).astype(np.float32)
    R_j = np.asarray(jtsqr.tsqr_r(jnp.asarray(A)))
    R_t = tsqr.tsqr_r(torch.from_numpy(A)).numpy()
    assert R_t.shape == R_j.shape
    scale = max(1.0, float(np.abs(R_j).max()))
    np.testing.assert_allclose(R_t / scale, R_j / scale, atol=TOL)
    if n >= 8:
        # one shard is one QR: the same factor to rounding (with fewer rows
        # than columns the padded shards keep zero rows that one QR has not)
        R_one = tsqr.tsqr_r(torch.from_numpy(A), mesh=mesh.make_mesh(n_data=1)).numpy()
        np.testing.assert_allclose(R_one / scale, R_t / scale, atol=1e-5)


def test_row_sharded_matrix_equals_jax():
    from keystone_tpu.linalg import RowShardedMatrix as JRSM
    from keystone_tpu_torch.linalg import RowShardedMatrix

    rng = np.random.default_rng(8)
    A = (rng.standard_normal((64, 6)) / 8).astype(np.float32)
    B = (rng.standard_normal((64, 2)) / 8).astype(np.float32)
    j, t = JRSM(A), RowShardedMatrix(A)
    assert tuple(t.shape) == tuple(j.shape)
    assert _spec(mesh.sharding_of(t.data)) == _spec(j.data.sharding)
    np.testing.assert_allclose(t.gram().numpy(), np.asarray(j.gram()), atol=TOL)
    np.testing.assert_allclose(t.t_times(RowShardedMatrix(B)).numpy(),
                               np.asarray(j.t_times(JRSM(B))), atol=TOL)
    np.testing.assert_allclose(t.qr_r().numpy(), np.asarray(j.qr_r()), atol=TOL)


# -- the model-sharded BCD scan -----------------------------------------------


@pytest.mark.parametrize("n,d,bs,n_data,n_model", [
    (64, 16, 4, 4, 2), (64, 16, 8, 4, 2), (64, 16, 4, 2, 4),   # applies
    (64, 16, 16, 4, 2), (63, 16, 4, 4, 2), (64, 16, 4, 8, 1),  # None: blocks, rows, no model axis
    (64, 12, 4, 4, 2)])                                        # None: 6 columns a slot
def test_model_sharded_scan_applies_where_jax_applies(n, d, bs, n_data, n_model):
    from keystone_tpu.linalg.bcd import _bcd_scan_model_sharded as jsharded
    from keystone_tpu_torch.linalg.bcd import _bcd_scan_model_sharded as tsharded

    with both_meshes(n_data, n_model):
        assert (tsharded(n, d, bs) is None) == (jsharded(n, d, bs, 1, True) is None)


@pytest.mark.parametrize("num_iter", [1, 2])
def test_model_sharded_scan_equals_the_unsharded_scan_and_jax(num_iter):
    from keystone_tpu.linalg import solve_blockwise_l2_scan as jscan
    from keystone_tpu_torch.linalg import solve_blockwise_l2_scan as tscan

    n, d, k, bs = 64, 16, 4, 4
    rng = np.random.default_rng(5)
    A = (rng.standard_normal((n, d)) / 8).astype(np.float32)
    y = (rng.standard_normal((n, k)) / 8).astype(np.float32)
    means = A.mean(axis=0)
    kw = dict(reg=1.0, block_size=bs, num_iter=num_iter)
    with mesh.use_mesh(mesh.make_mesh(n_data=8)):
        W_plain = tscan(torch.from_numpy(A), torch.from_numpy(y), means=torch.from_numpy(means),
                        **kw)
    with both_meshes(4, 2):
        W_j = jscan(jnp.asarray(A), jnp.asarray(y), means=jnp.asarray(means), **kw)
        W_t = tscan(torch.from_numpy(A), torch.from_numpy(y), means=torch.from_numpy(means),
                    **kw)
    assert mesh.sharding_of(W_t).spec == tuple(W_j.sharding.spec) == ("model",)
    assert torch.equal(W_t, W_plain)
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_j), atol=TOL)


def test_block_estimator_on_a_mixed_mesh_equals_a_data_mesh():
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator

    rng = np.random.default_rng(6)
    A = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))
    est = BlockLeastSquaresEstimator(block_size=4, num_iter=1, lam=0.5)
    m_data = est.fit(Dataset.of(A), Dataset.of(y))
    with mesh.use_mesh(mesh.make_mesh(n_data=4, n_model=2)):
        m_mixed = est.fit(Dataset.of(A), Dataset.of(y))
    X = A[:7]
    assert torch.equal(m_mixed.forward(X), m_data.forward(X))


# -- machine counts from the mesh ---------------------------------------------


@pytest.mark.parametrize("provisioned", [8, 1])
def test_cost_model_machines_follow_the_mesh_as_in_jax(provisioned):
    """With no ``num_machines`` the choosers price the default mesh's
    size: 8 slots against the JAX package's 8 virtual devices; with one
    slot against the JAX package told one machine."""
    import keystone_tpu.cost as jcost
    from keystone_tpu.data.dataset import Dataset as JDataset
    from keystone_tpu.nodes.learning import classifiers as jcls
    from keystone_tpu.nodes.learning import pca as jpca
    from keystone_tpu.nodes.learning import weighted as jw
    from keystone_tpu_torch import cost
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.learning import classifiers as tcls
    from keystone_tpu_torch.nodes.learning import pca as tpca
    from keystone_tpu_torch.nodes.learning import weighted as tw

    virtual.provision_virtual_devices(provisioned)
    jm = None if provisioned == 8 else 1
    X = np.zeros((24, 64), np.float32)
    Y = np.zeros((24, 3), np.float32)
    got = tcls.LeastSquaresEstimator().shape_from_samples(
        [Dataset.of(torch.from_numpy(X)), Dataset.of(torch.from_numpy(Y))], 200000)
    want = jcls.LeastSquaresEstimator(num_machines=jm).shape_from_samples(
        [JDataset.of(jnp.asarray(X)), JDataset.of(jnp.asarray(Y))], 200000)
    assert got.machines == want.machines == provisioned
    for shape in (dict(n=200000, d=4096, k=147), dict(n=50000, d=16384, k=147),
                  dict(n=2000, d=440, k=147)):
        kw = dict(shape, sparsity=1.0, machines=provisioned)
        assert (tcls.LeastSquaresEstimator().choose_solver(cost.ShapeSignature(**kw)).label
                == jcls.LeastSquaresEstimator(num_machines=jm).choose_solver(
                    jcost.ShapeSignature(**kw)).label)
        args = (4096, 1, 6e-5, 0.25)
        assert (tw.WeightedLeastSquaresEstimator(*args).choose_solver(
                    cost.ShapeSignature(**kw)).label
                == jw.WeightedLeastSquaresEstimator(*args, num_machines=jm).choose_solver(
                    jcost.ShapeSignature(**kw)).label)
    for shape, total in (((24, 128, 500), 2000), ((24, 128, 20), 48), ((24, 16, 4000), 24),
                         ((24, 64, 4000), 200000)):
        sample = np.zeros(shape, np.float32)
        want = jpca.ColumnPCAEstimator(4, num_machines=jm).optimize(JDataset.of(sample),
                                                                    total_items=total)
        got = tpca.ColumnPCAEstimator(4).optimize(torch.from_numpy(sample), total_items=total)
        assert type(got).__name__ == type(want).__name__


def test_node_optimization_plans_with_the_mesh_machines_as_jax():
    """In a graph the rule plans the front door from sampled items with the
    mesh's 8 machines, as JAX's rule does on its 8 virtual devices."""
    from keystone_tpu.data.dataset import Dataset as JDataset
    from keystone_tpu.nodes.learning import classifiers as jcls
    from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.learning import classifiers as tcls

    names = {"LeastSquaresEstimator", "DenseLBFGSwithL2", "SparseLBFGSwithL2",
             "BlockLeastSquaresEstimator", "LinearMapEstimator", "TSQRLeastSquaresEstimator"}
    for n, d in ((50000, 440), (200000, 64)):
        X = np.zeros((n, d), np.float32)
        Y = np.zeros((n, 147), np.float32)
        j_pipe = jcls.LeastSquaresEstimator().with_data(JDataset.of(X), JDataset.of(Y))
        t_pipe = tcls.LeastSquaresEstimator().with_data(Dataset.of(torch.from_numpy(X)),
                                                        Dataset.of(torch.from_numpy(Y)))
        JPipelineEnv.get_or_create().reset()
        PipelineEnv.get_or_create().reset()
        jg, _ = JPipelineEnv.get_or_create().optimizer.execute(j_pipe.graph)
        tg, _ = PipelineEnv.get_or_create().optimizer.execute(t_pipe.graph)
        j_ops = [type(op).__name__ for op in jg.operators.values() if type(op).__name__ in names]
        t_ops = [type(op).__name__ for op in tg.operators.values() if type(op).__name__ in names]
        assert t_ops == j_ops and len(t_ops) == 1
