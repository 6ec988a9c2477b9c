"""CIFAR-10 binary loader and synthetic CIFAR-shaped data (copies of
``keystone_tpu/loaders/cifar.py``, numpy only): 1 label byte + 3×32×32
channel-planar pixel bytes per record, landing as an (n, X, Y, C) float32
array on the host.
"""

from __future__ import annotations

import os

import numpy as np

from .csv_loader import LabeledData

NROW, NCOL, NCHAN = 32, 32, 3
RECORD = 1 + NROW * NCOL * NCHAN


def load_cifar(path: str) -> LabeledData:
    """Load one CIFAR-10 binary file (or a directory of them)."""
    files = (
        sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith(".bin")
        )
        if os.path.isdir(path)
        else [path]
    )
    raws = [np.fromfile(f, dtype=np.uint8) for f in files]
    raw = np.concatenate(raws)
    if raw.size % RECORD != 0:
        raise ValueError(f"{path}: not a whole number of CIFAR records")
    rec = raw.reshape(-1, RECORD)
    labels = rec[:, 0].astype(np.int32)
    # channel-planar bytes → (n, X=row, Y=col, C)
    imgs = (
        rec[:, 1:]
        .reshape(-1, NCHAN, NROW, NCOL)
        .transpose(0, 2, 3, 1)
        .astype(np.float32)
    )
    return LabeledData(labels, imgs)


def synthetic_cifar(n: int, seed: int = 0, num_classes: int = 10) -> LabeledData:
    """Class-structured synthetic CIFAR-shaped data for tests/benchmarks in
    this no-download environment. Class signal lives in *local texture*
    (class-specific spatial frequency + orientation), not absolute pixel
    levels — patch-normalized convolutional features deliberately discard
    means/contrast, so level-coded classes would be invisible to the
    RandomPatchCifar featurizer.

    A second, *position-fixed* low-frequency level pattern per class (shared
    across channels, so it survives grayscale conversion) makes the classes
    also visible to raw-pixel linear maps (LinearPixels); patch
    normalization subtracts patch means, so it leaves the texture signal as
    the dominant one for convolutional featurizers."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(NROW), np.arange(NCOL), indexing="ij")
    protos = np.zeros((num_classes, NROW, NCOL, NCHAN), dtype=np.float32)
    for k in range(num_classes):
        freq = 0.25 + 0.3 * (k % 5)  # cycles/pixel
        theta = np.pi * k / num_classes
        wave = np.sin(
            2 * np.pi * freq * (np.cos(theta) * xx + np.sin(theta) * yy)
        )
        for c in range(NCHAN):
            protos[k, :, :, c] = 128 + 80 * np.cos(c * 1.1) * wave
    # position-fixed smooth per-class level code (constant RNG: identical
    # across differently-seeded train/test draws)
    level_rng = np.random.default_rng(99)
    coarse = level_rng.standard_normal((num_classes, 4, 4)).astype(np.float32)
    levels = np.repeat(np.repeat(coarse, NROW // 4, axis=1), NCOL // 4, axis=2)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    phase_x = rng.integers(0, NROW, size=n)
    phase_y = rng.integers(0, NCOL, size=n)
    X = np.stack(
        [
            np.roll(protos[y[i]], (phase_x[i], phase_y[i]), axis=(0, 1))
            for i in range(n)
        ]
    )
    X = X + 30.0 * levels[y][..., None]
    X = X + 16.0 * rng.standard_normal(X.shape).astype(np.float32)
    return LabeledData(y, np.clip(X, 0, 255).astype(np.float32))
