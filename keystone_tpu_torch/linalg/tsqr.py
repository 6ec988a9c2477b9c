"""Tall-skinny QR on one device (port of ``tsqr_r`` and ``cost_signature``
of ``keystone_tpu/linalg/tsqr.py``). The JAX package takes one QR per mesh
shard and a second QR of the stacked factors; on one card that is a
single ``torch.linalg.qr`` (cuSOLVER's geqrf in float32). The streaming
fold ``tsqr_r_streaming`` comes with the out-of-core datasets."""

from __future__ import annotations

import torch


def _fix_sign(R: torch.Tensor) -> torch.Tensor:
    """R with its rows scaled so that diag(R) ≥ 0: the factor is then
    unique, and two implementations can be compared."""
    s = torch.sign(torch.diagonal(R))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return R * s[:, None]


def tsqr_r(A: torch.Tensor) -> torch.Tensor:
    """The R factor of A's QR decomposition, sign-fixed: (min(n, d), d)
    for an (n, d) A."""
    return _fix_sign(torch.linalg.qr(A.float(), mode="r").R)


def cost_signature(n: int, d: int, k: int = 0, machines: int = 1) -> dict:
    """Work terms for pricing a TSQR of an (n, d + k) augmented design
    matrix: a Householder QR pays ~2·n·w² flops for width w = d + k, twice
    the Gram route's contraction, and never squares the condition number;
    the reduction gathers one w×w factor per machine."""
    w = d + k
    return {
        "flops": 2.0 * n * w * w / machines + machines * float(w) ** 3,
        "bytes": n * w / machines + w * w,
        "network": machines * w * w,
        "passes": 1,
    }
