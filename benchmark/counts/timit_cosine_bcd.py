"""Operations TimitPipeline needs, from the configuration's shapes, whatever
implements them. Rules:

* products only (the random projections, Grams, factorizations, the
  block products); cosines, centering and means are not counted;
* a product is counted once a run where its operands do not change: the
  training features once (the fit and the train scores read the same), each
  block's Gram and its factor once however many sweeps;
* a Gram counts its symmetric half; Cholesky is b³/3;
* each block step needs the cross term Ã_jᵀ(y − pred) (2·n·b·k), the
  Gram's product with the old weights (2·b²·k), the solve from the factor
  (2·b²·k) and the prediction's update (2·n·b·k).
"""

from __future__ import annotations


def _width(cfg: dict) -> int:
    return cfg["num_cosines"] * cfg["cosine_features"]


def featurize_flops(cfg: dict, rows: int) -> float:
    return 2.0 * rows * _width(cfg) * cfg["input_dim"]


def bcd_flops(cfg: dict) -> float:
    n, k, b = cfg["num_train"], cfg["num_classes"], cfg["cosine_features"]
    blocks = cfg["num_cosines"]
    once = blocks * (n * b * (b + 1.0) + b ** 3 / 3.0)
    per_step = 4.0 * n * b * k + 4.0 * b * b * k
    return once + cfg["num_epochs"] * blocks * per_step


def scores_flops(cfg: dict, rows: int) -> float:
    return 2.0 * rows * _width(cfg) * cfg["num_classes"]


def run_flops(cfg: dict) -> float:
    """One application run: features of both sets, the fit, the train and
    test scores."""
    n, nt = cfg["num_train"], cfg["num_test"]
    return (featurize_flops(cfg, n + nt) + bcd_flops(cfg)
            + scores_flops(cfg, n) + scores_flops(cfg, nt))


def batch_flops(cfg: dict, rows: int) -> float:
    return featurize_flops(cfg, rows) + scores_flops(cfg, rows)
