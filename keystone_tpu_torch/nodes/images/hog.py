"""Histogram-of-gradients features, the Felzenszwalb voc-release5 variant
(port of ``keystone_tpu/nodes/images/hog.py``).

Each pixel's gradient (the channel of largest magnitude) is snapped to one
of 18 orientations and its magnitude split bilinearly into the four
nearest cells. Cell and weight depend on the pixel's position alone, so
each corner is one ``scatter_add_`` of magnitude × weight at a fixed cell
index plus the pixel's orientation. Float32 atomics add in no fixed
order, so the histograms agree with the JAX package's to rounding, not
bit for bit.

Output per image: (numXCells − 2)·(numYCells − 2) rows × 32 features, row
index y + x · (numYCells − 2).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.constants import device_constant
from ...workflow.transformer import Transformer

_EPS = 1e-4
_UU = (1.0, 0.9397, 0.766, 0.5, 0.1736, -0.1736, -0.5, -0.766, -0.9397)
_VV = (0.0, 0.342, 0.6428, 0.866, 0.9848, 0.9848, 0.866, 0.6428, 0.342)


def _cells(size: int, bin_size: int) -> int:
    """Cells along an axis: size / bin_size rounded half up, as Scala's
    ``math.round``."""
    return int(math.floor(size / bin_size + 0.5))


@device_constant
def _corners(n_x: int, n_y: int, bin_size: int,
             device: str) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """For each of the four bilinear corners: the flat cell index of every
    interior pixel (cells outside the grid go to an extra cell n_x·n_y) and
    its weight (0 there)."""
    b = bin_size
    pxs = np.arange(1, n_x * b - 1)
    pys = np.arange(1, n_y * b - 1)
    xp = (pxs + 0.5) / b - 0.5
    yp = (pys + 0.5) / b - 0.5
    ixp = np.floor(xp).astype(np.int64)
    iyp = np.floor(yp).astype(np.int64)
    vx0 = (xp - ixp)[:, None] * np.ones((1, len(pys)))
    vy0 = np.ones((len(pxs), 1)) * (yp - iyp)[None, :]
    IX = ixp[:, None] * np.ones((1, len(pys)), dtype=np.int64)
    IY = np.ones((len(pxs), 1), dtype=np.int64) * iyp[None, :]
    out = []
    for cx, cy, w in ((IX, IY, (1 - vx0) * (1 - vy0)), (IX, IY + 1, (1 - vx0) * vy0),
                      (IX + 1, IY, vx0 * (1 - vy0)), (IX + 1, IY + 1, vx0 * vy0)):
        valid = (cx >= 0) & (cx < n_x) & (cy >= 0) & (cy < n_y)
        seg = np.where(valid, cx + cy * n_x, n_x * n_y).reshape(-1)
        out.append((torch.from_numpy(seg).to(device),
                    torch.from_numpy((w * valid).reshape(-1).astype(np.float32)).to(device)))
    return out


@device_constant
def _directions(device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    # built on the host and moved (see daisy.py's ``_taps``)
    return (torch.tensor(_UU, dtype=torch.float32).to(device),
            torch.tensor(_VV, dtype=torch.float32).to(device))


class HogExtractor(Transformer):
    """(n, X, Y, C) → (n, numCellsWithFeatures, 32)."""

    row_local = True

    def __init__(self, bin_size: int):
        self.bin_size = bin_size

    def _histograms(self, X: torch.Tensor) -> torch.Tensor:
        """(n, X, Y, C) → (n, n_x·n_y, 18) orientation histograms of the
        cells, flat index x + y·n_x."""
        n, xd, yd, _ = X.shape
        b = self.bin_size
        n_x, n_y = _cells(xd, b), _cells(yd, b)
        vis_x, vis_y = n_x * b, n_y * b
        sub = X[:, :min(vis_x, xd), :min(vis_y, yd), :]
        if vis_x > xd or vis_y > yd:  # rounding made the visible area larger
            sub = F.pad(sub.permute(0, 3, 1, 2), (0, max(0, vis_y - yd), 0, max(0, vis_x - xd)),
                        mode="replicate").permute(0, 2, 3, 1)
        dx = (sub[:, 2:] - sub[:, :-2])[:, :, 1:-1]
        dy = (sub[:, :, 2:] - sub[:, :, :-2])[:, 1:-1]
        mag_sq = dx * dx + dy * dy
        best = torch.argmax(mag_sq, dim=-1, keepdim=True)  # ties: the lowest channel
        dx = dx.gather(-1, best)
        dy = dy.gather(-1, best)
        mag = torch.sqrt(mag_sq.gather(-1, best)[..., 0]).reshape(n, -1)
        uu, vv = _directions(str(X.device))
        dots = dy * uu + dx * vv  # (n, px, py, 9)
        orient = torch.argmax(torch.cat([dots, -dots], dim=-1), dim=-1).reshape(n, -1)
        cells = n_x * n_y + 1
        hist = X.new_zeros((n, cells * 18))
        for seg, w in _corners(n_x, n_y, b, str(X.device)):
            hist.scatter_add_(1, seg * 18 + orient, mag * w)
        return hist.reshape(n, cells, 18)[:, :-1]

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.float()
        n, xd, yd, _ = X.shape
        n_x, n_y = _cells(xd, self.bin_size), _cells(yd, self.bin_size)
        nxf, nyf = max(n_x - 2, 0), max(n_y - 2, 0)
        if nxf == 0 or nyf == 0:
            return X.new_zeros((n, 0, 32))
        hist = self._histograms(X)
        # cell energies Σ_o (h_o + h_{o+9})², indexed [y, x]
        energy = torch.sum((hist[..., :9] + hist[..., 9:]) ** 2, dim=-1).reshape(n, n_y, n_x)
        e2 = energy[:, :-1, :-1] + energy[:, :-1, 1:] + energy[:, 1:, :-1] + energy[:, 1:, 1:]
        inv = 1.0 / torch.sqrt(e2 + _EPS)
        norms = [inv[:, 1:1 + nyf, 1:1 + nxf], inv[:, 1:1 + nyf, 0:nxf],
                 inv[:, 0:nyf, 1:1 + nxf], inv[:, 0:nyf, 0:nxf]]
        hcell = hist.reshape(n, n_y, n_x, 18)[:, 1:1 + nyf, 1:1 + nxf]
        hsum = hcell[..., :9] + hcell[..., 9:]
        sens = [torch.clamp_max(hcell * nm[..., None], 0.2) for nm in norms]
        insens = [torch.clamp_max(hsum * nm[..., None], 0.2) for nm in norms]
        texture = 0.2357 * torch.stack([h.sum(dim=-1) for h in sens], dim=-1)
        feats = torch.cat([0.5 * (sens[0] + sens[1] + sens[2] + sens[3]),
                           0.5 * (insens[0] + insens[1] + insens[2] + insens[3]),
                           texture, torch.zeros_like(texture[..., :1])], dim=-1)
        # (n, nyf, nxf, 32) → rows y + x·nyf
        return feats.transpose(1, 2).reshape(n, nxf * nyf, 32)

    def row_work_bytes(self, x: torch.Tensor) -> int:
        """About forty image-sized planes: the gradients of every channel,
        their magnitudes, the nine projections and the flat indices."""
        return 4 * 40 * x.shape[1] * x.shape[2] * max(1, x.shape[3])
