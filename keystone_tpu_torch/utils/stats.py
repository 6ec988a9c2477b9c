"""Stats helpers (port of ``keystone_tpu/utils/stats.py``)."""

from __future__ import annotations

import math

import torch


def normalize_rows(mat: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Subtract each row's mean and divide by sqrt(row variance + alpha);
    the row variance uses ddof=1."""
    means = torch.nan_to_num(mat.mean(dim=1, keepdim=True))
    var = ((mat - means) ** 2).sum(dim=1, keepdim=True) / (mat.shape[1] - 1.0)
    sds = torch.sqrt(var + alpha)
    sds = torch.where(torch.isnan(sds), torch.full_like(sds, math.sqrt(alpha)), sds)
    return (mat - means) / sds
