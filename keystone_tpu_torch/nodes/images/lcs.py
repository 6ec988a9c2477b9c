"""Local Color Statistics descriptors (port of
``keystone_tpu/nodes/images/lcs.py``).

Per channel, the mean and standard deviation of each sub_patch_size²
window (two zero-padded box filters, cuDNN convolutions), read at a 4 × 4
neighbourhood of offsets around each keypoint of a grid by static
gathers; the values are interleaved (mean, std) per offset per channel.

Output per image: (numLCSValues, numPoolsX · numPoolsY) with descriptor
index x_idx · numPoolsY + y_idx, the reference's layout.
"""

from __future__ import annotations

from typing import List

import torch

from ...workflow.transformer import Transformer
from .daisy import _grid_index, _sep_conv_same


class LCSExtractor(Transformer):
    """(n, X, Y, C) → (n, C · 16 · 2, numDesc)."""

    row_local = True

    def __init__(self, stride: int, stride_start: int, sub_patch_size: int):
        self.stride = stride
        self.stride_start = stride_start
        self.sub_patch_size = sub_patch_size

    def _offsets(self) -> List[int]:
        sp = self.sub_patch_size
        return list(range(-2 * sp + sp // 2 - 1, sp + sp // 2, sp))

    def num_descriptors(self, xd: int, yd: int) -> int:
        b, s = self.stride_start, self.stride
        return len(range(b, xd - b, s)) * len(range(b, yd - b, s))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.float()
        n, xd, yd, nc = X.shape
        sp = self.sub_patch_size
        box = [1.0 / sp] * sp
        b, s = self.stride_start, self.stride
        offsets = self._offsets()
        nd = self.num_descriptors(xd, yd)
        dev = str(X.device)
        out = X.new_empty((n, nc, len(offsets), len(offsets), 2, nd))
        for c in range(nc):
            ch = X[..., c]
            m = _sep_conv_same(ch, box, box)
            sd = torch.sqrt(torch.clamp_min(_sep_conv_same(ch * ch, box, box) - m * m, 0.0))
            stats = torch.stack([m, sd], dim=1)  # (n, 2, X, Y)
            del m, sd
            for i, ox in enumerate(offsets):
                rows = stats.index_select(2, _grid_index(b, xd - b, s, ox, xd, dev))
                for j, oy in enumerate(offsets):
                    out[:, c, i, j] = rows.index_select(
                        3, _grid_index(b, yd - b, s, oy, yd, dev)).reshape(n, 2, nd)
        return out.reshape(n, -1, nd)

    def row_work_bytes(self, x: torch.Tensor) -> int:
        """The output, and about ten image-sized maps of one channel (the
        box filters' inputs, padded copies and outputs; the stacked mean
        and std; one offset's gathered rows)."""
        xd, yd, nc = x.shape[1], x.shape[2], x.shape[3]
        nv = nc * len(self._offsets()) ** 2 * 2
        return 4 * (nv * self.num_descriptors(xd, yd) + 10 * xd * yd)
