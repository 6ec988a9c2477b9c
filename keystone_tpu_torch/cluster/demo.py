"""Module-level model factories for the cluster tier's smoke and bench
paths (port of ``keystone_tpu/cluster/demo.py``).

A worker process rebuilds its model from a ``"module:callable"`` factory,
called with the factory's keyword arguments and ``device=``, the worker's
device. The factories are deterministic: two processes calling one with
the same arguments get the same fitted parameters (drawn from
``numpy.random.RandomState(seed)``, as the JAX package draws them), hence
the same AOT fingerprint, so every worker warm-boots from the programs any
one of them exported.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..workflow.transformer import Transformer


def build_demo_model(device=None, **kwargs):
    """The serve demo's pipeline (synthetic MNIST, random FFT features,
    block least squares, argmax), fitted, for worker processes."""
    from ..serving.demo import build_demo_fitted

    fitted, _ = build_demo_fitted(device=device, **kwargs)
    return fitted


def _weights(d: int, k: int, seed: int, device) -> torch.Tensor:
    """The JAX package's draw: float32 normals over √d, rounded to float32
    as ``jnp.asarray`` rounds the quotient there."""
    rng = np.random.RandomState(seed)
    W = (rng.randn(d, k).astype(np.float32) / np.sqrt(d)).astype(np.float32)
    return torch.from_numpy(W).to(torch.device(device or "cuda"))


def _sleep_stall(x: np.ndarray, stall_s: float) -> np.ndarray:
    time.sleep(float(stall_s))
    return x


class StallMatmul(Transformer):
    """``tanh((X · scale) @ W)`` behind a per-batch host stall: the batch is
    read to the host, the host sleeps ``stall_s``, and the batch comes back.
    The ``.cpu()`` / ``.numpy()`` round trip is the port's host callback
    (the static checker's ``host_callback`` verdict); ``host_step`` makes the
    serving tiers run the chain eagerly, so the stall happens on every batch
    and is not captured away by a CUDA graph."""

    row_local = True
    host_step = True

    def __init__(self, W: torch.Tensor, scale: float, stall_s: float):
        self.W = W
        self.scale = float(scale)
        self.stall_s = float(stall_s)

    @property
    def label(self) -> str:
        return "stall_matmul"

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        host = _sleep_stall(X.detach().cpu().numpy(), self.stall_s)
        X = torch.from_numpy(host).to(X.device)
        return torch.tanh((X * self.scale) @ self.W)


class WideMatmul(Transformer):
    """``tanh(X @ W)``: one small product over a wide datum."""

    row_local = True

    def __init__(self, W: torch.Tensor):
        self.W = W

    @property
    def label(self) -> str:
        return "wide_matmul"

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.tanh(X @ self.W)


def build_stall_model(d: int = 256, k: int = 16, stall_s: float = 0.004, scale: float = 1.0,
                      seed: int = 7, device=None):
    """The bench pipeline: a per-batch host stall (the stand-in for the
    feature fetch or IO a real server does each batch) in front of a small
    product. Compute on shared cores does not parallelize, but stalls
    overlap across processes, so two workers against one measure the
    process tier's own mechanism. Deterministic in ``seed``."""
    W = _weights(d, k, seed, device)
    return StallMatmul(W, scale, stall_s).to_pipeline().fit()


def build_wide_model(d: int = 16384, k: int = 16, seed: int = 7, device=None):
    """The hot-wire bench pipeline: one small product over a wide datum and
    no host step, so a request's cost is mostly moving its payload across
    the process boundary, which the binary codec and the shm rings attack.
    Deterministic in ``seed``."""
    W = _weights(d, k, seed, device)
    return WideMatmul(W).to_pipeline().fit()
