"""DAISY dense descriptors (port of ``keystone_tpu/nodes/images/daisy.py``;
Tola, Lepetit and Fua, PAMI 2010).

Separable gradient convolutions, H rectified directional-gradient maps,
a cascade of Q Gaussian blurs, and ring-sampled histograms on a keypoint
grid. The H maps of a level are blurred together as one batch of cuDNN
convolutions, and each histogram is a static gather of the grid's rows
and columns.

Output per image: (H·(T·Q + 1), numDesc), the center histogram first,
then the ring histograms angle-major; descriptor index x_idx · rw + y_idx.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.constants import device_constant
from ...workflow.transformer import Transformer


@device_constant
def _taps(values: Tuple[float, ...], dtype: torch.dtype, device: str) -> torch.Tensor:
    # built on the host and moved, so under the static checker's fake
    # tensors the move is abstract too (a tensor built on the card from host
    # data would be copied there for real)
    return torch.tensor(values, dtype=dtype).to(device)


def _sep_conv_same(X: torch.Tensor, xf: Sequence[float], yf: Sequence[float]) -> torch.Tensor:
    """Zero-padded 'same' separable correlation of (n, X, Y) maps: ``xf``
    along X, then ``yf`` along Y; an even-length filter pads one more
    after than before, as the JAX package's does."""
    xf, yf = tuple(float(v) for v in xf), tuple(float(v) for v in yf)
    kx = _taps(xf, X.dtype, str(X.device)).reshape(1, 1, -1, 1)
    ky = _taps(yf, X.dtype, str(X.device)).reshape(1, 1, 1, -1)
    px = (len(xf) - 1) // 2
    py = (len(yf) - 1) // 2
    out = F.conv2d(F.pad(X[:, None], (0, 0, px, len(xf) - 1 - px)), kx)
    out = F.conv2d(F.pad(out, (py, len(yf) - 1 - py, 0, 0)), ky)
    return out[:, 0]


@device_constant
def _grid_index(start: int, stop: int, step: int, offset: int, size: int,
                device: str) -> torch.Tensor:
    """Grid positions ``range(start, stop, step) + offset`` clipped to the
    image, on ``device``."""
    pos = np.clip(np.arange(start, stop, step) + offset, 0, size - 1)
    return torch.from_numpy(pos).to(device)


class DaisyExtractor(Transformer):
    """(n, X, Y, 1) grayscale batch → (n, featureSize, numDesc); the
    defaults are the reference's."""

    row_local = True

    def __init__(self, daisy_t: int = 8, daisy_q: int = 3, daisy_r: int = 7,
                 daisy_h: int = 8, pixel_border: int = 16, stride: int = 4,
                 patch_size: int = 24):
        self.T = daisy_t
        self.Q = daisy_q
        self.R = daisy_r
        self.H = daisy_h
        self.pixel_border = pixel_border
        self.stride = stride
        self.patch_size = patch_size
        self.feature_threshold = 1e-8
        conv_threshold = 1e-6
        # the blur cascade's σ² increments
        sigma_sq = [(self.R * n / (2.0 * self.Q)) ** 2 for n in range(self.Q + 1)]
        self.g: List[np.ndarray] = []
        for t in (b - a for a, b in zip(sigma_sq, sigma_sq[1:])):
            rad = int(math.ceil(math.sqrt(-2 * t * math.log(conv_threshold)
                                          - t * math.log(2 * math.pi * t))))
            xs = np.arange(-rad, rad + 1, dtype=np.float64)
            self.g.append((np.exp(-(xs ** 2) / (2 * t)) / math.sqrt(2 * math.pi * t))
                          .astype(np.float32))

    @property
    def feature_size(self) -> int:
        return self.H * (self.T * self.Q + 1)

    def _levels(self, gray: torch.Tensor) -> List[torch.Tensor]:
        """The Q blurred levels of the H directional maps, each (n, H, X, Y)."""
        n, xd, yd = gray.shape
        ix = _sep_conv_same(gray, (1.0, 0.0, -1.0), (1.0, 2.0, 1.0))
        iy = _sep_conv_same(gray, (1.0, 2.0, 1.0), (1.0, 0.0, -1.0))
        angles = [2 * math.pi * a / self.H for a in range(self.H)]
        maps = torch.stack([torch.clamp_min(math.cos(a) * ix + math.sin(a) * iy, 0.0)
                            for a in angles], dim=1)
        levels = []
        for g in self.g[:self.Q]:
            maps = _sep_conv_same(maps.reshape(n * self.H, xd, yd), g, g).reshape(
                n, self.H, xd, yd)
            levels.append(maps)
        return levels

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        gray = X[..., 0].float()
        n, xd, yd = gray.shape
        levels = self._levels(gray)
        dev = str(gray.device)
        b, s = self.pixel_border, self.stride
        nd = len(range(b, xd - b, s)) * len(range(b, yd - b, s))
        out = gray.new_empty((n, self.feature_size, nd))

        def hist(level: int, dx: int, dy: int, col: int) -> None:
            xs = _grid_index(b, xd - b, s, dx, xd, dev)
            ys = _grid_index(b, yd - b, s, dy, yd, dev)
            h = levels[level].index_select(2, xs).index_select(3, ys).reshape(n, self.H, nd)
            nrm = torch.linalg.vector_norm(h, dim=1, keepdim=True)
            out[:, col:col + self.H] = torch.where(
                nrm > self.feature_threshold, h / torch.clamp_min(nrm, 1e-30), 0.0)

        hist(0, 0, 0, 0)
        for l in range(self.Q):
            rad = self.R * (1.0 + l) / self.Q
            for a in range(self.T):
                theta = 2 * math.pi * (a - 1) / self.T  # the reference's a − 1
                hist(l, int(round(rad * math.sin(theta))), int(round(rad * math.cos(theta))),
                     self.H + a * self.Q * self.H + l * self.H)
        return out

    def row_work_bytes(self, x: torch.Tensor) -> int:
        """The output, and Q + 2 levels of H image-sized maps alive at once."""
        xd, yd = x.shape[1], x.shape[2]
        b, s = self.pixel_border, self.stride
        nd = len(range(b, xd - b, s)) * len(range(b, yd - b, s))
        return 4 * (2 * self.feature_size * nd + (self.Q + 2) * self.H * xd * yd + 4 * xd * yd)
