"""Kernel ridge regression in the port against the JAX package: the
Gauss-Seidel fit in both kernel modes, the closed forms, the fitted
mapper's apply with a ragged last block, and checkpoint and resume."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes.learning.kernel import (
    KernelBlockLinearMapper as JMapper,
    KernelRidgeRegression as JKRR,
)
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning import kernel as tkernel
from keystone_tpu_torch.nodes.learning.kernel import (
    KernelBlockLinearMapper,
    KernelRidgeRegression,
)
from keystone_tpu_torch.nodes.util import ClassLabelIndicators


def _krr_problem(n=180, d=10, k=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.integers(0, k, size=n)
    Y = ClassLabelIndicators(k).forward(torch.from_numpy(y)).numpy()
    return X, Y


def _fit(X, Y, **kw):
    return KernelRidgeRegression(**kw).fit(Dataset.of(X), Dataset.of(Y))


def _closed_form(X, Y, gamma, lam):
    diff = X[:, None, :] - X[None, :, :]
    K = np.exp(-gamma * (diff ** 2).sum(-1))
    return np.linalg.solve(K + lam * np.eye(X.shape[0]), Y)


# 180 rows in blocks of 48: the last block holds 36
@pytest.mark.parametrize("cache_kernel", [True, False])
@pytest.mark.parametrize("block_permuter", [3, None])
def test_krr_matches_jax(cache_kernel, block_permuter):
    X, Y = _krr_problem()
    kw = dict(gamma=0.1, lam=1.0, block_size=48, num_epochs=2,
              block_permuter=block_permuter, cache_kernel=cache_kernel)
    want = JKRR(**kw).fit(JDataset.of(X), JDataset.of(Y))
    got = _fit(X, Y, **kw)
    # rtol 1e-4, atol 1e-5: f32 Cholesky solves in two LAPACK call paths
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.train_X.numpy(), X)


def test_krr_cached_matches_streaming():
    X, Y = _krr_problem()
    common = dict(gamma=0.1, lam=1.0, block_size=48, num_epochs=2, block_permuter=3)
    a = _fit(X, Y, cache_kernel=True, **common)
    b = _fit(X, Y, cache_kernel=False, **common)
    np.testing.assert_allclose(a.W.numpy(), b.W.numpy(), rtol=1e-4, atol=1e-5)


def test_kernel_ridge_multiblock_matches_closed_form():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((64, 4)).astype(np.float32)
    Y = rng.standard_normal((64, 2)).astype(np.float32)
    model = _fit(X, Y, gamma=0.5, lam=1.0, block_size=16, num_epochs=25)
    np.testing.assert_allclose(model.W.numpy(), _closed_form(X, Y, 0.5, 1.0),
                               rtol=0.02, atol=0.02)


def test_kernel_ridge_one_block_matches_closed_form():
    rng = np.random.default_rng(6)
    X = rng.standard_normal((40, 3)).astype(np.float32)
    Y = rng.standard_normal((40, 2)).astype(np.float32)
    model = _fit(X, Y, gamma=0.3, lam=0.5, block_size=40, num_epochs=1)
    np.testing.assert_allclose(model.W.numpy(), _closed_form(X, Y, 0.3, 0.5),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("block_size", [32, 50, 100, 128])
def test_mapper_apply_matches_jax(block_size):
    rng = np.random.default_rng(8)
    train_X = rng.standard_normal((100, 12)).astype(np.float32)
    W = rng.standard_normal((100, 4)).astype(np.float32)
    Xq = rng.standard_normal((33, 12)).astype(np.float32)
    want = JMapper(train_X, W, 0.05, block_size).trace_batch(jnp.asarray(Xq))
    got = KernelBlockLinearMapper(torch.from_numpy(train_X), torch.from_numpy(W),
                                  0.05, block_size).forward(torch.from_numpy(Xq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


class _Killed(Exception):
    pass


@pytest.mark.parametrize("cache_kernel", [True, False])
def test_checkpoint_resume_lands_on_the_uninterrupted_fit(tmp_path, monkeypatch, cache_kernel):
    X, Y = _krr_problem(n=150, seed=2)
    kw = dict(gamma=0.1, lam=1.0, block_size=40, num_epochs=2, block_permuter=7,
              cache_kernel=cache_kernel)
    ref = _fit(X, Y, **kw)
    ckpt_dir = str(tmp_path / "ckpt")
    real = tkernel._block_update
    calls = {"n": 0}

    def dying(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 6:  # mid second epoch, after 5 checkpoints
            raise _Killed()
        return real(*args, **kwargs)

    monkeypatch.setattr(tkernel, "_block_update", dying)
    with pytest.raises(_Killed):
        _fit(X, Y, checkpoint_dir=ckpt_dir, checkpoint_interval=1, **kw)
    saved = np.load(os.path.join(ckpt_dir, "krr_state.npz"))
    assert (int(saved["epoch"]), int(saved["step"])) == (1, 1)
    monkeypatch.setattr(tkernel, "_block_update", real)
    resumed = _fit(X, Y, checkpoint_dir=ckpt_dir, checkpoint_interval=1, **kw)
    np.testing.assert_allclose(resumed.W.numpy(), ref.W.numpy(), rtol=1e-5, atol=1e-6)
    assert not os.path.exists(os.path.join(ckpt_dir, "krr_state.npz"))


def test_checkpoint_of_another_shape_is_ignored(tmp_path):
    X, Y = _krr_problem(n=60)
    np.savez(tmp_path / "krr_state.npz", W=np.ones((7, 3), np.float32), epoch=1, step=1)
    kw = dict(gamma=0.1, lam=1.0, block_size=20, num_epochs=1)
    got = _fit(X, Y, checkpoint_dir=str(tmp_path), **kw)
    np.testing.assert_array_equal(got.W.numpy(), _fit(X, Y, **kw).W.numpy())
