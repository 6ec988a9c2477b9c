"""TIMIT-shaped frames and the random cosine features' weights, drawn on the
card from the seed. The frames are a frozen torch copy of the port's
``pipelines/timit.py::synthetic_timit`` (Gaussian class prototypes in the
440-d frame space from a constant seed, plus noise of σ 1.5); the weights
are those of ``CosineRandomFeatures.create`` (W = γ·N(0, 1), b uniform in
[0, 2π)), for every branch at once. The labels, the noise and the weights
come from ``--seed``, in one generator: train set, test set, weights. The
rows of the training features that the check samples are drawn from the
seed too, on the host."""

from __future__ import annotations

import math

import torch

#: rows of the training features compared with the reference (every branch)
FEATURE_ROWS = 512


def draw(n: int, gen: torch.Generator, protos: torch.Tensor):
    """``n`` (frames (n, dim) float32, labels (n,) int64) from ``gen``."""
    y = torch.randint(0, protos.shape[0], (n,), generator=gen, device=protos.device)
    X = protos[y] + 1.5 * torch.randn((n, protos.shape[1]), generator=gen,
                                      device=protos.device)
    return X, y


def make(cfg: dict, seed: int, device, traffic: dict) -> dict:
    const = torch.Generator(device=device).manual_seed(1234)
    protos = torch.randn((cfg["num_classes"], cfg["input_dim"]), generator=const,
                         device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    X_train, y_train = draw(cfg["num_train"], gen, protos)
    X_test, y_test = draw(cfg["num_test"], gen, protos)
    shape = (cfg["num_cosines"], cfg["cosine_features"], cfg["input_dim"])
    cos_W = cfg["gamma"] * torch.randn(shape, generator=gen, device=device)
    cos_b = 2 * math.pi * torch.rand(shape[:2], generator=gen, device=device)
    rows = torch.randperm(cfg["num_train"], generator=torch.Generator().manual_seed(seed))
    return {"X_train": X_train, "y_train": y_train, "X_test": X_test, "y_test": y_test,
            "cos_W": cos_W, "cos_b": cos_b,
            "feature_rows": rows[:FEATURE_ROWS].sort().values.to(device)}
