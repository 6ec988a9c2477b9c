"""Tall-skinny QR (port of ``keystone_tpu/linalg/tsqr.py``).

:func:`tsqr_r` takes one QR per data-axis shard of the rows (zero rows
padded to a multiple of the axis: [A; 0] has A's R factor), each on its
slot's device, and a second QR of the stacked factors: the one-level TSQR
reduction of the JAX package. With one data-axis slot (one card, or no
mesh) it is a single ``torch.linalg.qr`` (cuSOLVER's geqrf in float32).
:func:`tsqr_r_streaming` folds row chunks into a running R factor, one
per scan lane, and stacks the lanes' factors once at the end.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.pipeline_scan import scan_pipeline
from ..parallel.mesh import DATA_AXIS, mesh_or_none, pad_to_multiple


def _fix_sign(R: torch.Tensor) -> torch.Tensor:
    """R with its rows scaled so that diag(R) ≥ 0: the factor is then
    unique, and two implementations can be compared."""
    s = torch.sign(torch.diagonal(R))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return R * s[:, None]


def tsqr_r(A: torch.Tensor, mesh=None) -> torch.Tensor:
    """The R factor of A's QR decomposition, sign-fixed: (min(n, d), d)
    for an (n, d) A, one shard of rows a data-axis slot of ``mesh``
    (default: the default mesh; none: one shard)."""
    A = torch.as_tensor(A).float()
    m = mesh_or_none(mesh)
    n_data = 1 if m is None else int(m.shape[DATA_AXIS])
    if n_data == 1:
        return _fix_sign(_qr_r(A))
    A, _ = pad_to_multiple(A, n_data, axis=0)
    slots = list(m.devices[:, 0].flat)
    rows = A.shape[0] // n_data
    Rs = [_qr_r(A[i * rows:(i + 1) * rows].to(s.device)).to(slots[0].device)
          for i, s in enumerate(slots)]
    return _fix_sign(_qr_r(torch.cat(Rs, dim=0)))


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


def tsqr_r_streaming(chunk_scan, device=None, tail: Optional[torch.Tensor] = None,
                     lanes: Optional[int] = None) -> torch.Tensor:
    """The sign-fixed R factor of a chunked (n, d) matrix whose rows are
    never together: one scan of ``chunk_scan()`` (chunks copied to
    ``device`` when produced elsewhere) folding each chunk into R, then
    ``tail`` (rows after the last chunk, such as a ridge fit's √λ·I) and
    a last QR of the factor, as the JAX package's one-lane scan does.
    Agrees with :func:`tsqr_r` to rounding.

    ``lanes`` (default ``parallel.lanes.scan_lanes()``): with more than
    one, each lane folds its own chunks (``i % lanes``) into its own R,
    and the lanes' factors (and ``tail``) are stacked once for the last
    QR, the same one-level reduction as :func:`tsqr_r`."""
    from ..parallel.lanes import gather_lane_partials, scan_lanes

    if lanes is None:
        lanes = scan_lanes()
    pipe = scan_pipeline(chunk_scan(), label="tsqr", device=device, lanes=lanes)
    lanes = getattr(pipe, "lanes", lanes)
    Rs: list = [None] * lanes
    for i, chunk in enumerate(pipe):
        chunk = chunk.float()
        lane = i % lanes
        Rs[lane] = _qr_r(chunk) if Rs[lane] is None else _qr_fold(Rs[lane], chunk)
    if lanes == 1:
        R = Rs[0]
        if tail is not None:
            R = _qr_r(tail) if R is None else _qr_fold(R, tail)
        if R is None:
            raise ValueError("empty chunk source")
        return _fix_sign(_qr_r(R))
    parts = gather_lane_partials(Rs, scan=pipe, devices=getattr(pipe, "lane_devices", None))
    if tail is not None:
        parts.append(tail.to(parts[0].device) if parts else tail)
    if not parts:
        raise ValueError("empty chunk source")
    return _fix_sign(_qr_r(torch.cat(parts, dim=0)))
