"""CIFAR-shaped images drawn on the card from the seed: a frozen torch copy
of the port's ``loaders/cifar.py::synthetic_cifar`` (class texture waves
rolled to a random phase, a position-fixed level code per class, noise of
σ 16, clipped to [0, 255]). The prototypes and the level code come from
constant seeds, so every set of a run shares the classes; the labels,
phases and noise come from ``--seed``, in one generator, train set first."""

from __future__ import annotations

import math

import torch

SIDE, CHANNELS = 32, 3


def _prototypes(num_classes: int, device) -> torch.Tensor:
    ax = torch.arange(SIDE, device=device, dtype=torch.float32)
    xx, yy = torch.meshgrid(ax, ax, indexing="ij")
    protos = torch.empty((num_classes, SIDE, SIDE, CHANNELS), device=device)
    for k in range(num_classes):
        freq = 0.25 + 0.3 * (k % 5)
        theta = math.pi * k / num_classes
        wave = torch.sin(2 * math.pi * freq * (math.cos(theta) * xx + math.sin(theta) * yy))
        for c in range(CHANNELS):
            protos[k, :, :, c] = 128 + 80 * math.cos(c * 1.1) * wave
    return protos


def _levels(num_classes: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(99)
    coarse = torch.randn((num_classes, 4, 4), generator=gen, device=device)
    step = SIDE // 4
    return coarse.repeat_interleave(step, 1).repeat_interleave(step, 2)


def draw(n: int, gen: torch.Generator, protos: torch.Tensor, levels: torch.Tensor):
    """``n`` (images (n, 32, 32, 3) float32, labels (n,) int64) from ``gen``."""
    dev = protos.device
    k = protos.shape[0]
    y = torch.randint(0, k, (n,), generator=gen, device=dev)
    px = torch.randint(0, SIDE, (n,), generator=gen, device=dev)
    py = torch.randint(0, SIDE, (n,), generator=gen, device=dev)
    ax = torch.arange(SIDE, device=dev)
    # np.roll by (px, py): out[x, y] = proto[(x − px) mod 32, (y − py) mod 32]
    xs = (ax[None, :] - px[:, None]) % SIDE
    ys = (ax[None, :] - py[:, None]) % SIDE
    X = protos[y[:, None, None], xs[:, :, None], ys[:, None, :]]
    X += 30.0 * levels[y][..., None]
    X += 16.0 * torch.randn(X.shape, generator=gen, device=dev)
    return X.clamp_(0, 255), y


def make(cfg: dict, seed: int, device, traffic: dict) -> dict:
    """The train and test sets, and the ``distinct`` batches of ``rows``
    rows that the traffic asks for, if it asks for any."""
    gen = torch.Generator(device=device).manual_seed(seed)
    protos = _prototypes(cfg["num_classes"], device)
    levels = _levels(cfg["num_classes"], device)
    X_train, y_train = draw(cfg["num_train"], gen, protos, levels)
    X_test, y_test = draw(cfg["num_test"], gen, protos, levels)
    out = {"X_train": X_train, "y_train": y_train, "X_test": X_test, "y_test": y_test}
    if traffic.get("distinct"):
        out["batches"] = [draw(traffic["rows"], gen, protos, levels)[0]
                          for _ in range(traffic["distinct"])]
    return out
