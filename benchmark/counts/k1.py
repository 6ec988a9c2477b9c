"""The work of one Gaussian kernel block K(X, X_b) = exp(−γ‖x − y‖²) of
X (n, d) against X_b (b, d), counted from its shape and the same whatever
implements it:

* operations: 2·n·b·d (the cross products; the norms, the clamp and the
  exponential are O(n·b + (n + b)·d) and not counted);
* bytes: 4·(n·d + b·d + n·b), each float32 input read once and the output
  written once.

Its least time on the card is the larger of operations at the TF32 peak and
bytes at the HBM peak."""

from __future__ import annotations

from benchmark.counts import peaks


def flops(n: int, b: int, d: int) -> float:
    return 2.0 * n * b * d


def bytes_moved(n: int, b: int, d: int) -> float:
    return 4.0 * (n * d + b * d + n * b)


def least_seconds(n: int, b: int, d: int) -> float:
    return max(flops(n, b, d) / peaks.TF32_FLOPS, bytes_moved(n, b, d) / peaks.HBM_BYTES)


def mapper_launches(rows: int, train_rows: int, d: int, block: int) -> list:
    """The blocks of a kernel model's scores of ``rows`` rows: one
    (rows, b, d) block per ``block`` training rows, the last one short."""
    return [(rows, min(block, train_rows - s), d) for s in range(0, train_rows, block)]
