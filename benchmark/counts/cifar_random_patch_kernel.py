"""Operations RandomPatchCifarKernel needs, from the configuration's shapes,
whatever implements them. Rules:

* products only (convolutions, matrix products, kernel cross terms,
  factorizations); elementwise work, norms and pooling sums are not counted;
* a product is counted once a run where its operands do not change: the
  training features once (the fit and the train scores read the same), the
  training kernel once (the fit and the train scores), each block's factor
  once however many epochs;
* a Gram, and the training kernel K(X, X), count their symmetric half;
* Cholesky is b³/3, a pair of triangular solves 2·b²·k, an SVD of s × m its
  Gram-equivalent 2·s·m².
"""

from __future__ import annotations


def _sizes(cfg: dict):
    side = cfg["image_side"]
    S = cfg["patch_size"]
    positions = ((side - S) // cfg["patch_steps"] + 1) ** 2
    m = S * S * cfg["channels"]
    npool = max(1, -(-((side - S) // cfg["patch_steps"] + 1 - cfg["pool_size"] // 2)
                     // cfg["pool_stride"]))
    d = npool * npool * 2 * cfg["num_filters"]
    return positions, m, d


def feature_dim(cfg: dict) -> int:
    """The width of the features the kernel model sees (800 at CIFAR's)."""
    return _sizes(cfg)[2]


def featurize_flops(cfg: dict, images: int) -> float:
    """The filter bank's products over every patch of ``images`` images."""
    positions, m, _ = _sizes(cfg)
    return 2.0 * images * positions * cfg["num_filters"] * m


def filters_flops(cfg: dict) -> float:
    _, m, _ = _sizes(cfg)
    s, K = cfg["whitener_size"], cfg["num_filters"]
    return 2.0 * s * m * m + 2.0 * m ** 3 + 4.0 * K * m * m


def krr_flops(cfg: dict) -> float:
    """Gauss-Seidel over column blocks: the training kernel's symmetric
    half, each block's factor once, and per epoch and block the other
    blocks' contribution K_·Bᵀ W (2·(n − b)·b·k) and the solve."""
    _, _, d = _sizes(cfg)
    n, bs, k = cfg["num_train"], cfg["block_size"], cfg["num_classes"]
    total = n * (n + 1.0) * d
    for s in range(0, n, bs):
        b = min(bs, n - s)
        total += b ** 3 / 3.0
        total += cfg["num_epochs"] * (2.0 * (n - b) * b * k + 2.0 * b * b * k)
    return total


def scores_flops(cfg: dict, rows: int, new_rows: bool) -> float:
    """The kernel model's scores of ``rows`` rows: the cross terms against
    every training row unless they are the training kernel (counted in the
    fit), and the product with W."""
    _, _, d = _sizes(cfg)
    n, k = cfg["num_train"], cfg["num_classes"]
    return (2.0 * rows * n * d if new_rows else 0.0) + 2.0 * rows * n * k


def run_flops(cfg: dict) -> float:
    """One application run: filters, features of both sets, the fit, the
    train and test scores."""
    n, nt = cfg["num_train"], cfg["num_test"]
    return (filters_flops(cfg) + featurize_flops(cfg, n + nt) + krr_flops(cfg)
            + scores_flops(cfg, n, new_rows=False) + scores_flops(cfg, nt, new_rows=True))


def batch_flops(cfg: dict, rows: int) -> float:
    """Scoring one batch with a fitted model: its features and its scores."""
    return featurize_flops(cfg, rows) + scores_flops(cfg, rows, new_rows=True)
