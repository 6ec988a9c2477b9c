"""L-BFGS least squares (port of ``keystone_tpu/nodes/learning/lbfgs.py``).

Loss:  f(W) = ½‖AW − B‖² / n + ½·λ‖W‖²,   ∇f = Aᵀ(AW − B)/n + λW.

The JAX package compiles the whole optimization into one
``lax.while_loop``. In eager PyTorch the loop runs on the host: the
gradients, the two-loop recursion and the line search's trial points are
device work, and each Armijo test and the convergence test read one
scalar back, one device sync each. At the solver sizes here (a few dozen
iterations of GEMMs over the whole data) that costs little; capturing the
loop as one program is later work.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np
import torch

from ...data.dataset import Dataset
from ...data.sparse import SparseRows
from ...parallel.mesh import shard_batch
from ...workflow.transformer import LabelEstimator
from .cost import CostModel
from .linear import LinearMapper, SparseLinearMapper

#: Armijo's sufficient-decrease constant and the line search's halvings
ARMIJO_C1 = 1e-4
MAX_HALVINGS = 20


def _ls_value_and_grad(W: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                       lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    n = A.shape[0]
    axb = A @ W - B
    loss = 0.5 * torch.sum(axb * axb) / n + 0.5 * lam * torch.sum(W * W)
    grad = A.T @ axb / n + lam * W
    return loss, grad


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _direction(g: torch.Tensor, history: List[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """The two-loop recursion over ``history`` (oldest first): the
    approximate inverse Hessian times −g, scaled by γ = sᵀy / yᵀy of the
    newest pair. A pair with sᵀy = 0 contributes nothing, as in the JAX
    package's masked loop."""
    q = g
    alphas = []
    rhos = []
    for s, y in reversed(history):
        denom = _vdot(y, s)
        rho = torch.where(denom != 0, 1.0 / denom, torch.zeros_like(denom))
        a = rho * _vdot(s, q)
        q = q - a * y
        alphas.append(a)
        rhos.append(rho)
    if history:
        s, y = history[-1]
        sy, yy = _vdot(s, y), _vdot(y, y)
        q = torch.where(yy != 0, sy / yy, torch.ones_like(yy)) * q
    for (s, y), a, rho in zip(history, reversed(alphas), reversed(rhos)):
        b = rho * _vdot(y, q)
        q = q + (a - b) * s
    return -q


def minimize_lbfgs(value_and_grad: Callable, w0, max_iterations: int = 100,
                   num_corrections: int = 10, convergence_tol: float = 1e-4,
                   vag_args: tuple = ()) -> torch.Tensor:
    """L-BFGS with the two-loop recursion over at most ``num_corrections``
    pairs and Armijo backtracking, the JAX package's semantics:

    * a direction that is not a descent direction is replaced by −g and the
      memory is reset;
    * the line search starts at step 1 and halves up to 20 times, accepting
      f(W + t·p) ≤ f + 1e-4·t·gᵀp; when no step is accepted the run ends
      and keeps the state from before the step;
    * the run converges when |f_prev − f| < tol·max(|f|, 1), f_prev being
      the value before the step (no test at the first step).

    ``value_and_grad(W, *vag_args) -> (f, g)`` works on tensors; W and every
    scalar are float32, on ``w0``'s device. Returns the final W."""
    W = torch.as_tensor(w0).float()
    tol = np.float32(convergence_tol)

    def vag(w):
        f, g = value_and_grad(w, *vag_args)
        return torch.as_tensor(f, dtype=torch.float32, device=w.device), g

    f, g = vag(W)
    history: List[Tuple[torch.Tensor, torch.Tensor]] = []
    prev_f = math.inf
    for _ in range(max_iterations):
        p = _direction(g, history)
        gd = _vdot(g, p)
        if bool(gd >= 0):  # not a descent direction
            p, gd = -g, -_vdot(g, g)
            history.clear()
        step, accepted = 1.0, None
        for _ in range(MAX_HALVINGS):
            cand = W + step * p
            cf, cg = vag(cand)
            if bool(cf <= f + ARMIJO_C1 * step * gd):
                accepted = cand, cf, cg
                break
            step *= 0.5
        if accepted is None:  # the line search failed: keep the state
            break
        Wn, fn, gn = accepted
        history.append((Wn - W, gn - g))
        if len(history) > num_corrections:
            history.pop(0)
        fn_host = float(fn)
        converged = abs(np.float32(prev_f) - np.float32(fn_host)) < tol * max(
            abs(np.float32(fn_host)), np.float32(1.0))
        W, f, g, prev_f = Wn, fn, gn, fn_host
        if converged:
            break
    return W


class DenseLBFGSwithL2(LabelEstimator, CostModel):
    """Least squares with an L2 penalty by L-BFGS, from W = 0; no centering
    and no intercept (the reference's ``DenseLBFGSwithL2``)."""

    def __init__(self, convergence_tol: float = 1e-4, num_iterations: int = 100,
                 reg_param: float = 0.0, num_corrections: int = 10):
        self.convergence_tol = convergence_tol
        self.num_iterations = num_iterations
        self.reg_param = reg_param
        self.num_corrections = num_corrections

    @property
    def weight(self) -> int:
        """Passes over the input, for a cache planner."""
        return self.num_iterations + 1

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        A = Dataset.of(data).to_array().float()
        B = Dataset.of(labels).to_array().to(A.device, torch.float32)
        # rows over the data axis of the default mesh
        A, B = shard_batch(A), shard_batch(B)
        W0 = torch.zeros((A.shape[1], B.shape[1]), dtype=torch.float32, device=A.device)
        W = minimize_lbfgs(_ls_value_and_grad, W0, max_iterations=self.num_iterations,
                           num_corrections=self.num_corrections,
                           convergence_tol=self.convergence_tol,
                           vag_args=(A, B, self.reg_param))
        return LinearMapper(W)

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        flops = n * d * k / num_machines
        bytes_scanned = n * d / num_machines
        network = 2.0 * d * k * math.log2(max(num_machines, 2))
        return self.num_iterations * (
            max(cpu_weight * flops, mem_weight * bytes_scanned) + network_weight * network)


#: dense bytes of one row block of the streamed Gram
GRAM_BLOCK_BYTES = 256 << 20


def gram_row_chunk(d: int, m: int) -> int:
    """Rows of one dense block of :func:`streamed_gram` over d features and
    a row capacity of m: bounded by 2²¹ scattered entries and by
    :data:`GRAM_BLOCK_BYTES` of dense block, as in the JAX package."""
    return max(1, min((1 << 21) // max(m, 1), GRAM_BLOCK_BYTES // max(4 * d, 1)))


def streamed_gram(X: SparseRows, B: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """G = AᵀA (d, d) and c = AᵀB of sparse rows, summed over dense row
    blocks: each block is scattered dense, added into G and c by two FP32
    GEMMs (TF32 is off package-wide: the port's form of the JAX package's
    ``precision="high"``) and dropped, so the peak is G and one block."""
    n, m = X.indices.shape
    d = X.num_features
    rows = gram_row_chunk(d, m)
    G = torch.zeros((d, d), dtype=torch.float32, device=X.device)
    c = torch.zeros((d, B.shape[1]), dtype=torch.float32, device=X.device)
    for i in range(0, n, rows):
        Ab = X.row_slice(i, min(i + rows, n)).to_dense()
        G.addmm_(Ab.T, Ab)
        c.addmm_(Ab.T, B[i:i + rows])
        del Ab
    return G, c


def gram_value_and_grad(W, G, c, e, n: int, lam: float):
    """The least-squares objective from its Gram: (½WᵀGW − cᵀW + e)/n +
    ½λ‖W‖², with e = ½‖B‖²; one (d, d)·(d, k) product, no data."""
    GW = G @ W
    loss = (0.5 * _vdot(W, GW) - _vdot(c, W) + e) / n + 0.5 * lam * torch.sum(W * W)
    return loss, (GW - c) / n + lam * W


def sparse_ls_value_and_grad(W, X: SparseRows, B, lam: float):
    """The least-squares objective on sparse rows: AW a gather, Aᵀ(AW − B)
    a scatter-add."""
    axb = X.matmul(W) - B
    n = B.shape[0]
    loss = 0.5 * torch.sum(axb * axb) / n + 0.5 * lam * torch.sum(W * W)
    return loss, X.rmatmul(axb) / n + lam * W


class SparseLBFGSwithL2(DenseLBFGSwithL2):
    """Least squares with an L2 penalty by L-BFGS on sparse rows; priced as
    a sparse solve (``cost`` scales the work by the input's density and a
    10× sparse overhead). A SparseRows batch, or scipy sparse items
    (converted to one), is fit by one of two strategies, chosen by memory:

    * the Gram (when the d×d float32 Gram fits ``gram_budget_bytes``): the
      objective is a fixed quadratic in W, so G = AᵀA and c = AᵀB are summed
      once over dense row blocks (:func:`streamed_gram`) and every
      evaluation is one (d, d)·(d, k) product;
    * gather/scatter (``gram_budget_bytes=0`` forces it): A·W a gather and
      Aᵀ·r a scatter-add each evaluation.

    Both run :func:`minimize_lbfgs` on the same objective and reach the
    same W up to float32 rounding. The model is a SparseLinearMapper, so it
    applies sparsely either way; W is (d, k), (d, 1) for one label column.
    Dense input takes the dense fit."""

    sparse_overhead = 10.0

    def __init__(self, *args, gram_budget_bytes: float = 2e9, **kwargs):
        super().__init__(*args, **kwargs)
        self.gram_budget_bytes = gram_budget_bytes

    def fit(self, data: Dataset, labels: Dataset):
        import scipy.sparse as sp

        data = Dataset.of(data)
        if isinstance(data.payload, SparseRows):
            X = data.payload
        elif not data.is_batched and data.payload and sp.issparse(data.first()):
            X = SparseRows.from_scipy(sp.vstack(data.collect()))
        else:
            return super().fit(data, labels)

        B = Dataset.of(labels).to_array().to(X.device, torch.float32)
        n, d = B.shape[0], X.num_features
        if 4.0 * d * d <= self.gram_budget_bytes:
            G, c = streamed_gram(X, B)
            e = 0.5 * torch.sum(B * B)
            vag, vag_args = gram_value_and_grad, (G, c, e, n, self.reg_param)
        else:
            vag, vag_args = sparse_ls_value_and_grad, (X, B, self.reg_param)
        W0 = torch.zeros((d, B.shape[1]), dtype=torch.float32, device=X.device)
        W = minimize_lbfgs(vag, W0, max_iterations=self.num_iterations,
                           num_corrections=self.num_corrections,
                           convergence_tol=self.convergence_tol, vag_args=vag_args)
        return SparseLinearMapper(W)

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        flops = n * sparsity * d * k / num_machines
        bytes_scanned = n * d * sparsity / num_machines
        network = 2.0 * d * k * math.log2(max(num_machines, 2))
        return self.num_iterations * (
            self.sparse_overhead * max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network)


class LocalLeastSquaresEstimator(LabelEstimator):
    """Ridge regression in its dual form for d ≫ n: the n×n Gram of the
    centered rows, one solve, W = Ãᵀ(ÃÃᵀ + λI)⁻¹B̃."""

    def __init__(self, lam: float):
        self.lam = lam

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        A = Dataset.of(data).to_array().float()
        B = Dataset.of(labels).to_array().to(A.device, torch.float32)
        a_mean, b_mean = A.mean(dim=0), B.mean(dim=0)
        Az, Bz = A - a_mean, B - b_mean
        n = A.shape[0]
        inner = torch.linalg.solve(
            Az @ Az.T + self.lam * torch.eye(n, dtype=torch.float32, device=A.device), Bz)
        return LinearMapper(Az.T @ inner, b=b_mean, feature_mean=a_mean)
