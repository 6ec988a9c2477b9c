"""Image operator nodes on batched (n, X, Y, C) tensors (port of
``keystone_tpu/nodes/images/core.py``).

The public layout is the JAX package's NHWC with H≡x and W≡y, and the
canonical vectorized layout is channel-major ``c + x*C + y*X*C``. Inside,
the convolution and pooling nodes permute to PyTorch's NCHW.

RandomPatcher and RandomImageTransformer draw their crops and flips with a
stateful numpy ``default_rng``, as the JAX nodes do, so one seed gives the
same crops and flips in both packages; only the index tensors go to the
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...data.dataset import Dataset
from ...workflow.transformer import Transformer

#: luminance weights of R, G and B (the reference's human-eye weights)
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def vectorize_images(X: torch.Tensor) -> torch.Tensor:
    """(n, X, Y, C) → (n, X*Y*C) in channel-major order c + x*C + y*X*C."""
    return X.permute(0, 2, 1, 3).reshape(X.shape[0], -1)


def images_from_vectors(V: torch.Tensor, x_dim: int, y_dim: int, channels: int) -> torch.Tensor:
    """Inverse of :func:`vectorize_images`."""
    return V.reshape(V.shape[0], y_dim, x_dim, channels).permute(0, 2, 1, 3)


def pack_filter_images(filters: torch.Tensor) -> torch.Tensor:
    """(k, S, S, C) filter images → (k, S·S·C) rows in the patch layout
    c + px·C + py·C·S."""
    return filters.permute(0, 2, 1, 3).reshape(filters.shape[0], -1)


class PixelScaler(Transformer):
    """Byte pixels → [0, 1] floats."""

    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X.float() / 255.0


class GrayScaler(Transformer):
    """Luminance 0.299 R + 0.587 G + 0.114 B of an RGB image, the channel
    mean of any other; one channel out."""

    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        X = X.float()
        if X.shape[-1] == 3:
            r, g, b = GRAY_WEIGHTS
            return (X[..., 0:1] * r + X[..., 1:2] * g) + X[..., 2:3] * b
        return X.mean(dim=-1, keepdim=True)


class ImageVectorizer(Transformer):
    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return vectorize_images(X)


class SymmetricRectifier(Transformer):
    """Channel-doubling rectification [max(v, x−α); max(v, −x−α)]."""

    row_local = True

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = max_val
        self.alpha = alpha

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.cat(
            [
                torch.clamp_min(X - self.alpha, self.max_val),
                torch.clamp_min(-X - self.alpha, self.max_val),
            ],
            dim=-1,
        )


class Convolver(Transformer):
    """Filter-bank convolution with per-patch normalization and an optional
    ZCA whitener's bias.

    ``filters``: (K, S²·C) rows in patch layout c + px·C + py·C·S, already
    whitened by the caller when a whitener is used. With p̂ the
    mean/variance-normalized patch,

        out(x, y, k) = (conv(img, f_k) − μ_patch·Σf_k) / sd_patch − means·f_k
    """

    row_local = True

    def __init__(self, filters: torch.Tensor, img_x: int, img_y: int,
                 img_channels: int, whitener=None,
                 normalize_patches: bool = True, var_constant: float = 10.0):
        self.filters = filters.float()
        self.img_x = img_x
        self.img_y = img_y
        self.img_channels = img_channels
        self.whitener = whitener
        self.normalize_patches = normalize_patches
        self.var_constant = var_constant
        self.conv_size = math.isqrt(self.filters.shape[1] // img_channels)
        if self.conv_size ** 2 * img_channels != self.filters.shape[1]:
            raise ValueError("filters must be square patches")
        S, C, K = self.conv_size, img_channels, self.filters.shape[0]
        # conv_weight[k, c, px, py] from the row layout c + px*C + py*C*S;
        # not ``weight``, which a cache planner reads as passes over the input
        self.conv_weight = (
            self.filters.reshape(K, S, S, C).permute(0, 3, 2, 1).contiguous()
        )

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        S, C = self.conv_size, self.img_channels
        m = S * S * C
        Xc = X.float().permute(0, 3, 1, 2)  # NCHW view, H≡x, W≡y
        conv = F.conv2d(Xc, self.conv_weight)  # (n, K, resX, resY)
        if self.normalize_patches:
            # window moments summed over S×S and the channels
            p_sum = F.avg_pool2d(Xc, S, stride=1, divisor_override=1).sum(
                dim=1, keepdim=True)
            p_sumsq = F.avg_pool2d(Xc * Xc, S, stride=1, divisor_override=1).sum(
                dim=1, keepdim=True)
            mu = p_sum / m
            var = (p_sumsq - p_sum * mu) / (m - 1)
            sd = torch.sqrt(var + self.var_constant)
            f_sum = self.filters.sum(dim=1)[None, :, None, None]
            conv = (conv - mu * f_sum) / sd
        if self.whitener is not None:
            bias = self.whitener.means @ self.filters.T  # (K,)
            conv = conv - bias[None, :, None, None]
        return conv.permute(0, 2, 3, 1)


class Pooler(Transformer):
    """Strided window pooling. Pool i covers [i·stride, i·stride + w) with
    w = 2·(pool_size // 2), not pool_size, for odd sizes; the input is
    padded at the end so the last (clipped) window fits, and the output
    is cut to ceil((dim − pool_size//2) / stride) pools a side."""

    row_local = True

    def __init__(self, stride: int, pool_size: int, pixel_fn=None,
                 pool_fn: str = "sum"):
        self.stride = stride
        self.pool_size = pool_size
        self.pixel_fn = pixel_fn
        if pool_fn not in ("sum", "max", "mean"):
            raise ValueError(f"unsupported pool_fn {pool_fn}")
        self.pool_fn = pool_fn

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        ps, st = self.pool_size, self.stride
        start = ps // 2
        w = 2 * (ps // 2)
        _, xd, yd, _ = X.shape
        if self.pixel_fn is not None:
            X = self.pixel_fn(X)
        npx = max(1, -(-(xd - start) // st))
        npy = max(1, -(-(yd - start) // st))
        ext_x = (npx - 1) * st + w
        ext_y = (npy - 1) * st + w
        Xc = X.permute(0, 3, 1, 2)
        pad_val = -math.inf if self.pool_fn == "max" else 0.0
        Xc = F.pad(Xc, (0, max(0, ext_y - yd), 0, max(0, ext_x - xd)),
                   value=pad_val)
        if self.pool_fn == "max":
            out = F.max_pool2d(Xc, w, stride=st)
        else:
            out = F.avg_pool2d(Xc, w, stride=st, divisor_override=1)
        out = out[:, :, :npx, :npy]
        if self.pool_fn == "mean":
            out = out / (ps * ps)
        return out.permute(0, 2, 3, 1)


class Windower(Transformer):
    """All window_size × window_size patches stepping by ``stride``; n
    images become n·nx·ny patch images, per image in x-major, y-minor
    order."""

    def __init__(self, stride: int, window_size: int):
        self.stride = stride
        self.window_size = window_size

    def grid(self, xd: int, yd: int):
        """Windows along x and along y."""
        w, st = self.window_size, self.stride
        return len(range(0, xd - w + 1, st)), len(range(0, yd - w + 1, st))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        n, xd, yd, c = X.shape
        w, st = self.window_size, self.stride
        nx, ny = self.grid(xd, yd)
        # unfold gives (n, nx, ny, c, w(dx), w(dy))
        patches = X.unfold(1, w, st).unfold(2, w, st)[:, :nx, :ny]
        return patches.permute(0, 1, 2, 4, 5, 3).reshape(n * nx * ny, w, w, c)

    def gather(self, X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` of :meth:`forward`'s output, without making the
        others: the (k, w, w, C) windows at those emission indices."""
        _, xd, yd, _ = X.shape
        w, st = self.window_size, self.stride
        nx, ny = self.grid(xd, yd)
        idx = idx.to(X.device)
        img = idx // (nx * ny)
        xi = (idx % (nx * ny)) // ny
        yi = idx % ny
        off = torch.arange(w, device=X.device)
        xs = (xi * st)[:, None] + off  # (k, w)
        ys = (yi * st)[:, None] + off
        return X[img[:, None, None], xs[:, :, None], ys[:, None, :], :]


class Cropper(Transformer):
    """The fixed crop [start_x, end_x) × [start_y, end_y)."""

    row_local = True

    def __init__(self, start_x: int, start_y: int, end_x: int, end_y: int):
        self.start_x, self.start_y = start_x, start_y
        self.end_x, self.end_y = end_x, end_y

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X[:, self.start_x:self.end_x, self.start_y:self.end_y, :]


class RandomPatcher(Transformer):
    """``num_patches`` random windows of each image, new draws at every
    batch, emitted image by image: (n, X, Y, C) → (n·num_patches, px, py, C).
    Per patch, the x starts of all images are drawn, then the y starts."""

    def __init__(self, num_patches: int, patch_size_x: int, patch_size_y: int,
                 seed: int = 0):
        self.num_patches = num_patches
        self.patch_size_x = patch_size_x
        self.patch_size_y = patch_size_y
        self._rng = np.random.default_rng(seed)

    def starts(self, n: int, xd: int, yd: int):
        """The next draw: (n, num_patches) x starts and y starts."""
        xs, ys = [], []
        for _ in range(self.num_patches):
            xs.append(self._rng.integers(0, xd - self.patch_size_x + 1, size=n))
            ys.append(self._rng.integers(0, yd - self.patch_size_y + 1, size=n))
        return np.stack(xs, axis=1), np.stack(ys, axis=1)

    def apply_batch(self, data) -> Dataset:
        X = Dataset.of(data).to_array()
        n, xd, yd, c = X.shape
        px, py = self.patch_size_x, self.patch_size_y
        xs, ys = self.starts(n, xd, yd)
        dev = X.device
        ix = torch.from_numpy(xs).to(dev)[:, :, None] + torch.arange(px, device=dev)
        iy = torch.from_numpy(ys).to(dev)[:, :, None] + torch.arange(py, device=dev)
        img = torch.arange(n, device=dev)[:, None, None, None]
        patches = X[img, ix[:, :, :, None], iy[:, :, None, :]]  # (n, P, px, py, C)
        return Dataset(patches.reshape(-1, px, py, c))


class CenterCornerPatcher(Transformer):
    """The four corner crops and the center crop of each image, each
    followed by its horizontal flip when ``horizontal_flips``, emitted image
    by image: 5 or 10 crops per image."""

    def __init__(self, patch_size_x: int, patch_size_y: int,
                 horizontal_flips: bool = False):
        self.px = patch_size_x
        self.py = patch_size_y
        self.horizontal_flips = horizontal_flips

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        n, xd, yd, c = X.shape
        px, py = self.px, self.py
        starts = [(0, 0), (xd - px, 0), (0, yd - py), (xd - px, yd - py),
                  ((xd - px) // 2, (yd - py) // 2)]
        crops = [X[:, sx:sx + px, sy:sy + py, :] for sx, sy in starts]
        if self.horizontal_flips:
            crops = [v for cr in crops for v in (cr, cr.flip(2))]
        return torch.stack(crops, dim=1).reshape(-1, px, py, c)


class RandomImageTransformer(Transformer):
    """Flip each image horizontally with probability ``flip_chance``, new
    draws at every batch."""

    def __init__(self, flip_chance: float = 0.5, seed: int = 0):
        self.flip_chance = flip_chance
        self._rng = np.random.default_rng(seed)

    def apply_batch(self, data) -> Dataset:
        X = Dataset.of(data).to_array()
        flips = self._rng.random(X.shape[0]) < self.flip_chance
        mask = torch.from_numpy(flips).to(X.device)[:, None, None, None]
        return Dataset(torch.where(mask, X.flip(2), X))


class LabelExtractor(Transformer):
    """(label, image) item → label."""

    def apply(self, item):
        return item[0]


class ImageExtractor(Transformer):
    """(label, image) item → image."""

    def apply(self, item):
        return item[1]


class MultiLabelExtractor(Transformer):
    """(label set, image) item → label set."""

    def apply(self, item):
        return item[0]
