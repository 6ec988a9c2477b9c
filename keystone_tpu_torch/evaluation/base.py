"""Evaluator base (port of ``keystone_tpu/evaluation/base.py``)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def resolve(x: Any) -> np.ndarray:
    """Materialize predictions or labels: PipelineResult → Dataset →
    tensor → numpy array on the host."""
    from ..data.dataset import Dataset
    from ..workflow.pipeline import PipelineResult

    if isinstance(x, PipelineResult):
        x = x.get()
    if isinstance(x, Dataset):
        x = x.to_array()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class Evaluator:
    def evaluate(self, predictions: Any, labels: Any):
        raise NotImplementedError
