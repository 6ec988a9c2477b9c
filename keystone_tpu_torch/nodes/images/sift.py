"""Dense multi-scale SIFT on a batch of grayscale images (port of
``keystone_tpu/nodes/images/sift.py``, itself after VLFeat's dense SIFT
with a flat window, window size 1.5, magnification 6, contrast threshold
0.005 and the ×512 byte quantization).

Per scale: a Gaussian smooth (σ = bin size / 6, edge-replicated, two 1-D
convolutions), central-difference gradients with one-sided differences at
the borders, the gradient magnitude split linearly between the two nearest
of 8 orientation maps, a flat box sum of each map over a window of 1.5 bin
sizes, then 4 × 4 spatial bins gathered at each keypoint of the grid,
L2-normalized, clamped at 0.2 and renormalized; descriptors whose norm
before clamping is at most 0.005 are zeroed, and the rest quantized to
min(floor(512·v), 255).

Layout: element t + 8·i + 32·j of a descriptor is orientation t of x-bin i
and y-bin j, as in ``vl_dsift``. The orientation maps are kept
channels-first, (n, 8, X, Y), so each gathered bin is already an (n, 8,
keypoints) block of the (n, 128, N) output, which each scale writes into
its own columns. The gather indices are built once per image size and
device, outside any CUDA graph capture.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.constants import device_constant
from ...workflow.transformer import Transformer

_NBP = 4      # spatial bins per side
_NBO = 8      # orientation bins
_MAGNIF = 6.0
_CONTRAST_THRESHOLD = 0.005
_WINDOW_SIZE = 1.5
_TWO_PI = np.float32(2.0 * math.pi)


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@device_constant
def _kernel(sigma: float, device: str) -> torch.Tensor:
    return torch.from_numpy(_gaussian_kernel1d(sigma)).to(device)


def _smooth(X: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (n, X, Y) maps (σ = 0: the identity),
    with edge-replicated padding."""
    if sigma <= 0:
        return X
    k = _kernel(sigma, str(X.device))
    r = k.shape[0] // 2
    Xp = F.pad(X[:, None], (r, r, r, r), mode="replicate")
    out = F.conv2d(Xp, k.reshape(1, 1, -1, 1))
    return F.conv2d(out, k.reshape(1, 1, 1, -1))[:, 0]


def _gradient(X: torch.Tensor, dim: int) -> torch.Tensor:
    """Central differences along ``dim`` (1 or 2), one-sided at the two
    borders."""
    g = torch.empty_like(X)
    n = X.shape[dim]
    g.narrow(dim, 1, n - 2).copy_((X.narrow(dim, 2, n - 2) - X.narrow(dim, 0, n - 2)) * 0.5)
    g.narrow(dim, 0, 1).copy_(X.narrow(dim, 1, 1) - X.narrow(dim, 0, 1))
    g.narrow(dim, n - 1, 1).copy_(X.narrow(dim, n - 1, 1) - X.narrow(dim, n - 2, 1))
    return g


def _orientation_maps(X: torch.Tensor) -> torch.Tensor:
    """(n, X, Y) grayscale → (n, 8, X, Y) magnitude-weighted orientation
    maps, linearly interpolated between adjacent bins."""
    gx = _gradient(X, 1)
    gy = _gradient(X, 2)
    mag = torch.sqrt(gx * gx + gy * gy)
    theta = torch.fmod(torch.atan2(gy, gx), _TWO_PI)
    theta = torch.where((theta != 0) & (theta < 0), theta + _TWO_PI, theta)  # jnp.remainder
    t = theta / _TWO_PI * _NBO
    t0 = torch.floor(t)
    frac = t - t0
    t0 = t0.long() % _NBO
    t1 = (t0 + 1) % _NBO
    maps = torch.zeros((X.shape[0], _NBO) + tuple(X.shape[1:]), dtype=X.dtype, device=X.device)
    maps.scatter_add_(1, t0[:, None], (mag * (1.0 - frac))[:, None])
    maps.scatter_add_(1, t1[:, None], (mag * frac)[:, None])
    return maps


def _box_pool(maps: torch.Tensor, width: int) -> torch.Tensor:
    """The sum of each map over width × width windows, 'valid': (n, 8,
    X − w + 1, Y − w + 1), one axis at a time."""
    out = F.avg_pool2d(maps, (width, 1), stride=1, divisor_override=1)
    return F.avg_pool2d(out, (1, width), stride=1, divisor_override=1)


def _grid(xd: int, yd: int, bin_size: int, step: int) -> Tuple[List[int], List[int]]:
    """Keypoint x and y positions (top-left corners of the descriptors)."""
    extent = _NBP * bin_size
    return (list(range(0, xd - extent + 1, step)) if xd >= extent else [],
            list(range(0, yd - extent + 1, step)) if yd >= extent else [])


def num_descriptors(xd: int, yd: int, bin_size: int = 4, step: int = 3,
                    num_scales: int = 4, scale_step: int = 0) -> int:
    """Descriptors per image over all scales."""
    total = 0
    for scale in range(num_scales):
        kx, ky = _grid(xd, yd, bin_size + 2 * scale, step + scale * scale_step)
        total += len(kx) * len(ky)
    return total


@device_constant
def _bin_indices(xd: int, yd: int, bin_size: int, step: int, device: str):
    """For each of the 16 bins in (j, i) order, the clipped (x, y) rows of
    the pooled maps that bin reads, on ``device``."""
    window = max(1, int(round(bin_size * _WINDOW_SIZE)))
    kx, ky = _grid(xd, yd, bin_size, step)
    off = (window - bin_size) // 2
    px_max, py_max = xd - window, yd - window
    out = []
    for j in range(_NBP):
        for i in range(_NBP):
            xs = np.clip(np.asarray(kx) + i * bin_size - off, 0, px_max)
            ys = np.clip(np.asarray(ky) + j * bin_size - off, 0, py_max)
            out.append((torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)))
    return out


def _scale_descriptors(gray: torch.Tensor, bin_size: int, step: int):
    """One scale over the keypoint grid of smoothed (n, X, Y) images:
    (normalized descriptors (n, 128, N), their norms before clamping
    (n, N)), before the contrast test and quantization."""
    n, xd, yd = gray.shape
    kx, ky = _grid(xd, yd, bin_size, step)
    if not kx or not ky:
        return gray.new_zeros((n, _NBP * _NBP * _NBO, 0)), gray.new_zeros((n, 0))
    window = max(1, int(round(bin_size * _WINDOW_SIZE)))
    pooled = _box_pool(_orientation_maps(gray), window)
    blocks = [pooled.index_select(2, xs).index_select(3, ys)
              for xs, ys in _bin_indices(xd, yd, bin_size, step, str(gray.device))]
    desc = torch.stack(blocks, dim=1).reshape(n, _NBP * _NBP * _NBO, len(kx) * len(ky))
    del blocks, pooled
    norms = torch.linalg.vector_norm(desc, dim=1)
    desc /= torch.clamp_min(norms, 1e-12)[:, None]
    desc.clamp_(max=0.2)
    desc /= torch.clamp_min(torch.linalg.vector_norm(desc, dim=1, keepdim=True), 1e-12)
    return desc, norms


class SIFTExtractor(Transformer):
    """Dense multi-scale SIFT: (n, X, Y, 1) grayscale in [0, 1] → (n, 128,
    N) quantized descriptors, N the keypoints of every scale (scale s has
    bin size ``bin_size + 2s`` and step ``step + s·scale_step``)."""

    row_local = True

    def __init__(self, step: int = 3, bin_size: int = 4, num_scales: int = 4,
                 scale_step: int = 0):
        self.step = step
        self.bin_size = bin_size
        self.num_scales = num_scales
        self.scale_step = scale_step

    def _scales(self):
        for scale in range(self.num_scales):
            yield self.bin_size + 2 * scale, self.step + scale * self.scale_step

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        gray = X[..., 0].float()
        n, xd, yd = gray.shape
        total = num_descriptors(xd, yd, self.bin_size, self.step, self.num_scales,
                                self.scale_step)
        out = gray.new_empty((n, _NBP * _NBP * _NBO, total))
        col = 0
        for bin_size, step in self._scales():
            desc, norms = _scale_descriptors(_smooth(gray, bin_size / _MAGNIF), bin_size, step)
            desc.masked_fill_(~(norms > _CONTRAST_THRESHOLD)[:, None], 0.0)
            torch.clamp(torch.floor(desc.mul_(512.0)), max=255.0,
                        out=out[:, :, col:col + desc.shape[2]])
            col += desc.shape[2]
            del desc, norms
        return out

    def row_work_bytes(self, x: torch.Tensor) -> int:
        """The output, and the largest scale's temporaries: a few image-sized
        maps, 8 orientation maps three times over (maps, pooled, the first
        pooling pass) and its descriptors four times over (gathered bins,
        stacked, normalized, quantized)."""
        xd, yd = x.shape[1], x.shape[2]
        first = num_descriptors(xd, yd, self.bin_size, self.step, 1, 0)
        total = num_descriptors(xd, yd, self.bin_size, self.step, self.num_scales,
                                self.scale_step)
        return 4 * (128 * total + 12 * xd * yd + 3 * _NBO * xd * yd + 4 * 128 * first)
