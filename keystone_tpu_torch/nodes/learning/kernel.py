"""Gaussian kernel blocks and the kernel ridge regression family (port of
``keystone_tpu/nodes/learning/kernel.py``).

Every kernel block comes from the K1 kernel (``ops/gaussian_kernel.py``).
Two solvers fit the same model, a :class:`KernelBlockLinearMapper`:

* :class:`KernelRidgeRegression`, Gauss-Seidel over column blocks: the
  n×n kernel matrix is never materialized; one n×b column block at a time
  is generated, optionally cached on the device, and feeds one block step;
* :class:`ExactKernelRidge`: the whole kernel from its column blocks and
  one Cholesky solve, O(n²) memory and n³/3 operations.

:class:`KernelRidgeEstimator` chooses between them by the cost model
(``nodes/learning/cost.py``), through ``NodeOptimizationRule`` in a graph
or at its own ``fit``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ...data.dataset import Dataset
from ...linalg.row_matrix import solve_spd
from ...ops import gaussian_kernel  # noqa: F401  (registers the K1 operator)
from ...workflow.node_optimization import Optimizable
from ...workflow.transformer import LabelEstimator, Transformer
from .cost import AutoSolverFrontDoor, CostModel, combine_cost


def _gaussian_block(X: torch.Tensor, Xb: torch.Tensor, gamma: float) -> torch.Tensor:
    """Kernel-block front door, the K1 operator on either device: the CUDA
    kernel for CUDA tensors (which launches or raises), the plain version
    for CPU tensors; an exported program names it."""
    return torch.ops.keystone.gaussian_kernel_block(X, Xb, float(gamma))


class BlockKernelMatrix:
    """Kernel column blocks K(X, X[idxs]) computed at first use and, with
    ``cache_blocks``, kept (parity: ``KernelMatrix.scala:50-90``)."""

    def __init__(self, X, gamma: float, cache_blocks: bool = True):
        self.X = torch.as_tensor(X, dtype=torch.float32)
        self.gamma = gamma
        self.cache_blocks = cache_blocks
        self._cache: Dict[tuple, torch.Tensor] = {}

    def _index(self, idxs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idxs), dtype=torch.long, device=self.X.device)

    def block(self, idxs) -> torch.Tensor:
        key = (int(idxs[0]), int(idxs[-1]))
        if key in self._cache:
            return self._cache[key]
        Kb = _gaussian_block(self.X, self.X[self._index(idxs)], self.gamma)
        if self.cache_blocks:
            self._cache[key] = Kb
        return Kb

    def diag_block(self, idxs) -> torch.Tensor:
        return self.block(idxs)[self._index(idxs)]

    def unpersist(self, idxs) -> None:
        self._cache.pop((int(idxs[0]), int(idxs[-1])), None)


class KernelBlockLinearMapper(Transformer):
    """Apply a kernel model: out = Σ_B K(X, train_B) · W_B, one K1 launch
    per block of ``block_size`` training rows (the last may be short)."""

    # Never fused: each K1 launch takes the whole batch against one
    # training block, so a fused group holding this node could not run in
    # row chunks, and the featurizer fused before it would run whole.
    no_fuse = True

    def __init__(self, train_X: torch.Tensor, model_W: torch.Tensor,
                 gamma: float, block_size: int):
        self.train_X = train_X.float()
        self.W = model_W.float()  # (n_train, k)
        self.gamma = gamma
        self.block_size = block_size

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.float()
        n_train = self.train_X.shape[0]
        out = torch.zeros((X.shape[0], self.W.shape[1]),
                          dtype=torch.float32, device=X.device)
        for start in range(0, n_train, self.block_size):
            end = min(start + self.block_size, n_train)
            Kb = _gaussian_block(X, self.train_X[start:end], self.gamma)
            out.addmm_(Kb, self.W[start:end])
        return out


def _block_update(Kb, Y, W, start: int, lam: float, bs: int) -> None:
    """One Gauss-Seidel block step given the kernel block Kb = K(X, X_B)
    (the cached-kernel mode calls it directly):
        (K_BB + λI) W_B ← Y_B − (K_Bᵀ W − K_BBᵀ W_B_old)
    W is updated in place (the JAX package's dynamic_update_slice)."""
    Kbb = Kb[start:start + bs]
    W_old = W[start:start + bs]
    residual = Kb.T @ W - Kbb.T @ W_old
    W[start:start + bs] = solve_spd(Kbb, Y[start:start + bs] - residual, lam)


def _krr_block_step(X, Y, W, start: int, gamma: float, lam: float, bs: int) -> None:
    """One Gauss-Seidel block step with the kernel block generated anew
    (streaming mode). The block rows are a row slice of X: no copy."""
    Kb = _gaussian_block(X, X[start:start + bs], gamma)
    _block_update(Kb, Y, W, start, lam, bs)


def _kernel_block_slice(X: torch.Tensor, start: int, gamma: float, bs: int) -> torch.Tensor:
    """K(X, X[start:start+bs]): the generation path of cached-kernel mode."""
    return _gaussian_block(X, X[start:start + bs], gamma)


class KernelRidgeRegression(LabelEstimator, CostModel):
    """Gauss-Seidel block-coordinate kernel ridge regression. Blocks are
    visited in order, or in an order drawn per epoch from
    ``default_rng(block_permuter)``. With ``checkpoint_dir`` the state
    (W, epoch, step) is saved every ``checkpoint_interval`` blocks, a fit
    resumes from it, and a completed fit deletes it."""

    def __init__(self, gamma: float, lam: float, block_size: int,
                 num_epochs: int, block_permuter: Optional[int] = None,
                 cache_kernel: bool = True,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_interval: int = 25):
        self.gamma = gamma
        self.lam = lam
        self.block_size = block_size
        self.num_epochs = num_epochs
        self.block_permuter = block_permuter
        self.cache_kernel = cache_kernel
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval = checkpoint_interval

    def _ckpt_path(self) -> Optional[str]:
        if not self.checkpoint_dir:
            return None
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        return os.path.join(self.checkpoint_dir, "krr_state.npz")

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        # kernel generation n²·d once (cached) or per epoch; per epoch each
        # block pays the n×bs residual GEMM (n²·k in all) and a bs³
        # Cholesky (n·bs² in all); cached-kernel epochs re-read n² floats
        bs = min(self.block_size, n)
        gen_epochs = 1 if self.cache_kernel else self.num_epochs
        return combine_cost(
            {
                "flops": (
                    gen_epochs * float(n) * n * d
                    + self.num_epochs * (float(n) * n * k + float(n) * bs * bs)
                ) / num_machines,
                "bytes": self.num_epochs * float(n) * n / num_machines + float(n) * d,
                "network": float(n) * k * self.num_epochs,
                "passes": self.num_epochs,
            },
            cpu_weight, mem_weight, network_weight,
        )

    def fit(self, data: Dataset, labels: Dataset) -> KernelBlockLinearMapper:
        X = Dataset.of(data).to_array().float()
        Y = Dataset.of(labels).to_array().to(X.device, torch.float32)
        n, k = Y.shape
        bs = self.block_size
        kernel_cache: Dict[int, torch.Tensor] = {}
        W = torch.zeros((n, k), dtype=torch.float32, device=X.device)

        num_blocks = -(-n // bs)
        rng = (
            np.random.default_rng(self.block_permuter)
            if self.block_permuter is not None
            else None
        )
        start_epoch, start_step = 0, 0
        ckpt = self._ckpt_path()
        if ckpt and os.path.exists(ckpt):
            saved = np.load(ckpt)
            if saved["W"].shape == (n, k):
                W = torch.as_tensor(saved["W"], device=X.device)
                start_epoch = int(saved["epoch"])
                start_step = int(saved["step"])
        steps_done = 0
        for epoch in range(self.num_epochs):
            # the permutation stream must be identical across a resume, so
            # draw it every epoch regardless of where the fit restarts
            order = list(range(num_blocks))
            if rng is not None:
                rng.shuffle(order)
            if epoch < start_epoch:
                continue
            for step, blk in enumerate(order):
                if epoch == start_epoch and step < start_step:
                    continue
                start = blk * bs
                size = min(bs, n - start)
                if self.cache_kernel:
                    Kb = kernel_cache.get(start)
                    if Kb is None:
                        Kb = _kernel_block_slice(X, start, self.gamma, size)
                        kernel_cache[start] = Kb
                    _block_update(Kb, Y, W, start, self.lam, size)
                else:
                    _krr_block_step(X, Y, W, start, self.gamma, self.lam, size)
                steps_done += 1
                if ckpt and steps_done % self.checkpoint_interval == 0:
                    np.savez(ckpt, W=W.cpu().numpy(), epoch=epoch, step=step + 1)
        if ckpt and os.path.exists(ckpt):
            os.remove(ckpt)  # complete fit: drop the restart state
        return KernelBlockLinearMapper(X, W, self.gamma, bs)


class ExactKernelRidge(LabelEstimator, CostModel):
    """Direct kernel ridge: the whole kernel K from its K1 column blocks of
    ``block_size`` columns, then (K + λI) W = Y by one Cholesky solve.
    Exact, O(n²) memory and an n³/3 factorization: the cheap end of the
    family at small n. Fits the same model as :class:`KernelRidgeRegression`."""

    def __init__(self, gamma: float, lam: float, block_size: int):
        self.gamma = gamma
        self.lam = lam
        self.block_size = block_size

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        return combine_cost(
            {
                # generation, one Cholesky and the triangular solves
                "flops": (float(n) * n * d + float(n) ** 3 / 3.0 + float(n) * n * k)
                / num_machines,
                "bytes": float(n) * n / num_machines + float(n) * d,
                "network": float(n) * k,
                "passes": 1,
            },
            cpu_weight, mem_weight, network_weight,
        )

    def fit(self, data: Dataset, labels: Dataset) -> KernelBlockLinearMapper:
        X = Dataset.of(data).to_array().float()
        Y = Dataset.of(labels).to_array().to(X.device, torch.float32)
        n = X.shape[0]
        bs = self.block_size
        K = torch.cat([_kernel_block_slice(X, start, self.gamma, min(bs, n - start))
                       for start in range(0, n, bs)], dim=1)
        W = solve_spd(K, Y, self.lam)
        return KernelBlockLinearMapper(X, W, self.gamma, bs)


class KernelRidgeEstimator(LabelEstimator, AutoSolverFrontDoor, CostModel, Optimizable):
    """Kernel ridge regression that chooses its solver by the cost model:
    :class:`ExactKernelRidge` or :class:`KernelRidgeRegression`, which fit
    the same model for the same (γ, λ), so the choice is one of cost only
    (the cubic factorization wins at small n, the block sweeps once n³
    dominates). In a graph, ``NodeOptimizationRule`` makes the choice
    before anything runs; called directly, ``fit`` makes it from 24
    sampled items."""

    def __init__(self, gamma: float, lam: float, block_size: int,
                 num_epochs: int, block_permuter: Optional[int] = None,
                 cache_kernel: bool = True,
                 num_machines: Optional[int] = None,
                 cpu_weight: Optional[float] = None,
                 mem_weight: Optional[float] = None,
                 network_weight: Optional[float] = None):
        self.gamma = gamma
        self.lam = lam
        self.block_size = block_size
        self.num_epochs = num_epochs
        self.num_machines = num_machines
        self._init_chooser_weights(cpu_weight, mem_weight, network_weight)
        self.options: Sequence = [
            KernelRidgeRegression(gamma, lam, block_size, num_epochs,
                                  block_permuter=block_permuter, cache_kernel=cache_kernel),
            ExactKernelRidge(gamma, lam, block_size),
        ]
        self.default = self.options[0]

    def fit(self, data: Dataset, labels: Dataset) -> KernelBlockLinearMapper:
        data = Dataset.of(data)
        labels = Dataset.of(labels)
        solver = self.sample_optimize([data.take(24), labels.take(24)], len(data))
        return solver.fit(data, labels)


class GaussianKernelGenerator(LabelEstimator):
    """Gaussian-kernel matrices of a dataset (parity: the
    ``GaussianKernelGenerator`` of ``KernelGenerator.scala:36-84``)."""

    def __init__(self, gamma: float):
        self.gamma = gamma

    def kernel_matrix(self, data: Dataset, cache: bool = True) -> BlockKernelMatrix:
        return BlockKernelMatrix(Dataset.of(data).to_array(), self.gamma, cache)
