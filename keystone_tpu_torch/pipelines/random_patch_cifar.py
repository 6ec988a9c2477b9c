"""RandomPatchCifar's configuration and filter learning (port of
``RandomCifarConfig`` and ``learn_filters`` from
``keystone_tpu/pipelines/random_patch_cifar.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.dataset import Dataset
from ..nodes.images.core import Windower, vectorize_images
from ..nodes.learning.zca import ZCAWhitener, ZCAWhitenerEstimator
from ..nodes.stats import Sampler
from ..utils.stats import normalize_rows

NUM_CLASSES = 10


@dataclass
class RandomCifarConfig:
    train_location: str = ""
    test_location: str = ""
    num_filters: int = 100
    whitening_epsilon: float = 0.1
    patch_size: int = 6
    patch_steps: int = 1
    pool_size: int = 14
    pool_stride: int = 13
    alpha: float = 0.25
    lam: Optional[float] = None
    sample_frac: Optional[float] = None
    whitener_size: int = 100000
    seed: int = 0


def learn_filters(train_images, conf: RandomCifarConfig
                  ) -> Tuple[torch.Tensor, ZCAWhitener]:
    """Sample patches, whiten, pick and scale random filters. Returns
    (filters, whitener).

    The JAX package windows every image and then samples; at CIFAR's size
    that is 36.45M patches (15.7 GB). Here the sampled windows are
    gathered directly: the same numpy draw over the same emission order
    picks the same rows."""
    X = Dataset.of(train_images).to_array()
    windower = Windower(conf.patch_steps, conf.patch_size)
    nx, ny = windower.grid(X.shape[1], X.shape[2])
    idx = Sampler(conf.whitener_size, seed=conf.seed).indices(X.shape[0] * nx * ny)
    base = vectorize_images(windower.gather(X, torch.from_numpy(idx)))
    base_mat = normalize_rows(base.float(), 10.0)
    whitener = ZCAWhitenerEstimator(conf.whitening_epsilon).fit_single(base_mat)

    rng = np.random.default_rng(conf.seed)
    pick = rng.choice(
        base_mat.shape[0], size=min(conf.num_filters, base_mat.shape[0]),
        replace=False,
    )
    sample = base_mat[torch.from_numpy(np.sort(pick)).to(base_mat.device)]
    unnorm = whitener.transform(sample)
    norms = torch.sqrt(torch.sum(unnorm * unnorm, dim=1))
    filters = (unnorm / (norms + 1e-10)[:, None]) @ whitener.whitener.T
    return filters, whitener
