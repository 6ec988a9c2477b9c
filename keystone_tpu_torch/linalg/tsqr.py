"""Tall-skinny QR on one device (port of ``keystone_tpu/linalg/tsqr.py``).
The JAX package takes one QR per mesh shard and a second QR of the stacked
factors; on one card that is a single ``torch.linalg.qr`` (cuSOLVER's
geqrf in float32). The streaming form folds row chunks into a running R
factor, one lane (the JAX package's lanes are one per mesh device)."""

from __future__ import annotations

from typing import Optional

import torch

from ..data.pipeline_scan import scan_pipeline


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


def _qr_r(chunk: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(chunk, mode="r").R


def _qr_fold(R: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """One chunk folded into a running R factor: the R of qr([R; chunk])."""
    return _qr_r(torch.cat([R, chunk], dim=0))


def tsqr_r_streaming(chunk_scan, device=None, tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sign-fixed R factor of a chunked (n, d) matrix whose rows are
    never together: one scan of ``chunk_scan()`` (chunks copied to
    ``device`` when produced elsewhere) folding each chunk into R, then
    ``tail`` (rows after the last chunk, such as a ridge fit's √λ·I) and
    a last QR of the factor, as the JAX package's one-lane scan does.
    Agrees with :func:`tsqr_r` to rounding."""
    R = None
    for chunk in scan_pipeline(chunk_scan(), label="tsqr", device=device):
        chunk = chunk.float()
        R = _qr_r(chunk) if R is None else _qr_fold(R, chunk)
    if tail is not None:
        R = _qr_r(tail) if R is None else _qr_fold(R, tail)
    if R is None:
        raise ValueError("empty chunk source")
    return _fix_sign(_qr_r(R))
