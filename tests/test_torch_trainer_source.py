"""The trainer's ``ChunkLog`` on the port (``keystone_tpu_torch/trainer/
source.py``) against the JAX package's: the four cases of
``tests/trainer/test_source.py`` through both packages' logs on the same
appends, with the chunks ``as_chunked`` produces equal to JAX's and the
production counts equal."""

import numpy as np
import pytest
import torch

from keystone_tpu.trainer import ChunkLog as JChunkLog
from keystone_tpu_torch.trainer import AppendedChunk, ChunkLog


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _chunk(n=8, d=4, seed=0):
    r = np.random.RandomState(seed)
    return r.randn(n, d).astype(np.float32), r.randn(n, 2).astype(np.float32)


@pytest.mark.parametrize("cls", [ChunkLog, JChunkLog], ids=["port", "jax"])
def test_append_and_tail_are_strictly_forward(cls):
    log = cls()
    X0, Y0 = _chunk(seed=0)
    X1, Y1 = _chunk(seed=1)
    assert log.append(X0, Y0) == 0
    assert log.append(X1, Y1) == 1
    got = log.tail(0)
    assert [c.index for c in got] == [0, 1]
    assert log.tail(2) == []
    np.testing.assert_array_equal(log.tail(1)[0].data, X1)
    assert len(log) == 2
    assert log.total_rows == 16


def test_appended_chunks_stay_host_numpy():
    """A tensor appended to the port's log is kept as a host array, as the
    JAX package keeps its chunks."""
    log = ChunkLog()
    X, Y = _chunk()
    log.append(torch.from_numpy(X), torch.from_numpy(Y))
    (c,) = log.tail(0)
    assert isinstance(c, AppendedChunk) and c.rows == 8
    assert isinstance(c.data, np.ndarray) and isinstance(c.labels, np.ndarray)
    np.testing.assert_array_equal(c.data, X)


@pytest.mark.parametrize("cls", [ChunkLog, JChunkLog], ids=["port", "jax"])
def test_append_validates_shape_and_dtype(cls):
    log = cls()
    X, Y = _chunk()
    log.append(X, Y)
    with pytest.raises(ValueError, match="item shape"):
        log.append(np.zeros((4, 9), np.float32))
    with pytest.raises(ValueError, match="dtype"):
        log.append(np.zeros((4, 4), np.float64))
    with pytest.raises(ValueError, match="rows"):
        log.append(np.zeros((4, 4), np.float32), np.zeros((3, 2)))
    with pytest.raises(ValueError, match="batched"):
        log.append(np.zeros((4,), np.float32))


def _four_chunk_logs():
    port, ref = ChunkLog(), JChunkLog()
    parts = []
    for s in range(4):
        X, Y = _chunk(seed=s)
        parts.append((X, Y))
        port.append(X, Y)
        ref.append(X, Y)
    return port, ref, parts


def test_as_chunked_counts_productions_and_skips_without_producing():
    port, ref, parts = _four_chunk_logs()
    for log in (port, ref):
        ds, labels = log.as_chunked(1, 4)
        assert len(ds) == 24
        chunks = [_np(c) for c in ds.raw_chunks()]
        np.testing.assert_array_equal(chunks[0], parts[1][0])
        np.testing.assert_array_equal(labels[:8], parts[1][1])
        assert log.production_counts == {1: 1, 2: 1, 3: 1}
        # checkpoint-resume semantics: skip=2 must not produce the prefix
        resumed = [_np(c) for c in log.as_chunked(1, 4)[0].raw_chunks(skip=2)]
        assert len(resumed) == 1
        np.testing.assert_array_equal(resumed[0], parts[3][0])
        assert log.production_counts == {1: 1, 2: 1, 3: 2}
    assert port.production_counts == ref.production_counts


def test_as_chunked_produces_the_chunks_and_labels_jax_produces():
    port, ref, _ = _four_chunk_logs()
    (pds, plabels), (jds, jlabels) = port.as_chunked(0, 4), ref.as_chunked(0, 4)
    got = [_np(c) for c in pds.raw_chunks()]
    want = [np.asarray(c) for c in jds.raw_chunks()]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(plabels, jlabels)
    assert isinstance(plabels, np.ndarray)
    assert port.production_counts == ref.production_counts == {i: 1 for i in range(4)}


@pytest.mark.parametrize("cls", [ChunkLog, JChunkLog], ids=["port", "jax"])
def test_as_chunked_rejects_unlabeled_and_bad_ranges(cls):
    log = cls()
    X, _ = _chunk()
    log.append(X)  # an unlabeled append is fine for monitoring...
    with pytest.raises(ValueError, match="unlabeled"):
        log.as_chunked(0, 1)  # ...but cannot absorb
    with pytest.raises(ValueError, match="range"):
        log.as_chunked(0, 5)
