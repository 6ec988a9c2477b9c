"""Stats nodes (port of ``PaddedFFT``, ``RandomSignNode``,
``LinearRectifier``, ``NormalizeRows``, ``SignedHellingerMapper``,
``TermFrequency``, ``CosineRandomFeatures``, ``StandardScaler``, ``Sampler``
and ``ColumnSampler`` of ``keystone_tpu/nodes/stats/core.py``).

On an out-of-core ``ChunkedDataset``, StandardScaler fits in one scan and
ColumnSampler samples each chunk lazily, its columns drawn by chunk index."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ... import device as pick_device
from ...data.dataset import Dataset
from ...workflow.transformer import Estimator, Transformer


class PaddedFFT(Transformer):
    """Zero-pad each row to the next power of two and keep the real part of
    the first half of its FFT: d → 2^ceil(log2 d) / 2 features."""

    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        d = X.shape[-1]
        padded = 1 << max(0, d - 1).bit_length()
        # rfft gives padded/2 + 1 bins, of which the first padded/2 are kept;
        # ``.real`` of a complex tensor is a strided view, so copy it out
        # once here rather than hand a strided operand to the next GEMM
        return torch.fft.rfft(X, n=padded, dim=-1).real[..., : padded // 2].contiguous()


class RandomSignNode(Transformer):
    """Elementwise multiply by a fixed ±1 vector."""

    row_local = True

    def __init__(self, signs: torch.Tensor):
        self.signs = signs

    @staticmethod
    def create(size: int, seed: int = 0, device=None) -> "RandomSignNode":
        """Signs drawn with numpy ``default_rng(seed)``: another stream than
        the JAX package's ``jax.random``, so the two packages' nodes of one
        seed differ; parity tests copy the JAX node's signs instead."""
        draw = np.random.default_rng(seed).integers(0, 2, size=size)
        signs = torch.from_numpy((2.0 * draw - 1.0).astype(np.float32))
        return RandomSignNode(signs.to(pick_device(device)))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X * self.signs


class LinearRectifier(Transformer):
    """max(max_val, x − alpha)."""

    row_local = True

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = max_val
        self.alpha = alpha

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(X - self.alpha if self.alpha else X, self.max_val)


class NormalizeRows(Transformer):
    """Scale each row to unit L2 norm; a zero row passes through."""

    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(X, dim=-1, keepdim=True)
        return X / torch.where(norm == 0, torch.ones_like(norm), norm)


class SignedHellingerMapper(Transformer):
    """x → sign(x)·√|x|."""

    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.sign(X) * torch.sqrt(torch.abs(X))


class TermFrequency(Transformer):
    """Sequence of terms → (distinct term, fun(count)) pairs, in first
    appearance order. ``fun`` maps the raw count, for example
    ``TermFrequency(lambda x: math.log(x) + 1)``; identity by default."""

    def __init__(self, fun=None):
        self.fun = fun

    def apply(self, terms):
        from collections import Counter

        fun = self.fun or (lambda x: x)
        counts = Counter(tuple(t) if isinstance(t, list) else t for t in terms)
        return [(term, float(fun(c))) for term, c in counts.items()]


class CosineRandomFeatures(Transformer):
    """Random Fourier features cos(x Wᵀ + b), one GEMM with the bias added
    in its epilogue, then the cosine in place.

    W: (num_output_features, num_input_features); b: (num_output_features,).
    """

    row_local = True

    def __init__(self, W: torch.Tensor, b: torch.Tensor):
        if b.shape[0] != W.shape[0]:
            raise ValueError("rows of W and size of b must match")
        self.W = W
        self.b = b

    @staticmethod
    def create(num_input_features: int, num_output_features: int, gamma: float,
               seed: int = 0, device=None) -> "CosineRandomFeatures":
        """Gaussian W scaled by ``gamma`` and uniform b in [0, 2π), drawn
        with numpy ``default_rng(seed)``: another stream than the JAX
        package's ``jax.random``, so parity tests copy the JAX node's W and
        b (:meth:`from_reference`) instead of drawing them."""
        rng = np.random.default_rng(seed)
        W = gamma * rng.standard_normal((num_output_features, num_input_features),
                                        dtype=np.float32)
        b = np.float32(2 * math.pi) * rng.random(num_output_features, dtype=np.float32)
        return CosineRandomFeatures.from_reference(W, b, device)

    @staticmethod
    def from_reference(W, b, device=None) -> "CosineRandomFeatures":
        """The node with another fit's W and b, given as arrays."""
        dev = pick_device(device)
        return CosineRandomFeatures(torch.tensor(np.asarray(W, np.float32), device=dev),
                                    torch.tensor(np.asarray(b, np.float32), device=dev))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.addmm(self.b, X, self.W.T).cos_()


class StandardScalerModel(Transformer):
    """(x − mean) / std; std of None means center-only."""

    row_local = True

    def __init__(self, mean: torch.Tensor, std: Optional[torch.Tensor] = None):
        self.mean = mean
        self.std = std

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        out = X - self.mean
        if self.std is not None:
            out = out / self.std
        return out


def _chunk_center_stats(X: torch.Tensor):
    """One chunk's column mean and centered sum of squares."""
    mean = X.mean(dim=0)
    diff = X - mean
    return mean, (diff * diff).sum(dim=0)


def _chan_merge(a, b):
    """Chan/Welford merge of two (n, mean, M2) column-stat triples."""
    na, ma, sa = a
    nb, mb, sb = b
    tot = na + nb
    delta = mb - ma
    return tot, ma + delta * (nb / tot), sa + sb + delta * delta * (na * nb / tot)


class StandardScaler(Estimator):
    """Fit column mean and std (ddof=1); a degenerate std (0, NaN or inf)
    becomes 1.0. A chunked input fits in one scan: per-chunk centered
    statistics merged Chan/Welford-style (the raw sum-of-squares form
    cancels in float32 when |mean| ≫ std)."""

    def __init__(self, normalize_std_dev: bool = True, eps: float = 1e-12):
        self.normalize_std_dev = normalize_std_dev
        self.eps = eps

    def fitted_out_spec(self, fit_in, apply_in):
        # the fitted model is (x − mean) / std: it keeps the spec
        return apply_in[0] if apply_in else None

    def fit(self, data: Dataset) -> StandardScalerModel:
        data = Dataset.of(data)
        if data.is_chunked:
            mean, var = self._streaming_stats(data)
        else:
            X = data.to_array()
            mean, var = X.mean(dim=0), X.var(dim=0, correction=1)
        if not self.normalize_std_dev:
            return StandardScalerModel(mean, None)
        std = torch.sqrt(var)
        bad = torch.isnan(std) | torch.isinf(std) | (std.abs() < self.eps)
        std = torch.where(bad, torch.ones_like(std), std)
        return StandardScalerModel(mean, std)

    @staticmethod
    def _streaming_stats(data):
        """Column mean and variance (ddof=1) of a chunked set in one scan."""
        acc = None
        for chunk in data.chunks():
            X = chunk.float()
            part = (int(X.shape[0]),) + _chunk_center_stats(X)
            acc = part if acc is None else _chan_merge(acc, part)
        if acc is None:
            raise ValueError("empty chunked dataset")
        n, mean, m2 = acc
        # n == 1 leaves m2 zero, whose std the degenerate guard maps to 1.0
        return mean, m2 / max(n - 1, 1)


class Sampler(Transformer):
    """A seeded sample of ``size`` rows without replacement, kept in row
    order. The indices are numpy ``default_rng(seed).choice``, as in the
    JAX package, so both packages pick the same rows."""

    def __init__(self, size: int, seed: int = 42):
        self.size = size
        self.seed = seed

    def indices(self, n: int) -> np.ndarray:
        k = min(self.size, n)
        return np.sort(np.random.default_rng(self.seed).choice(n, size=k, replace=False))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        idx = torch.from_numpy(self.indices(X.shape[0])).to(X.device)
        return X[idx]

    def apply_batch(self, data) -> Dataset:
        """The sample of the whole dataset: a chunked one is indexed across
        its chunks in one scan (each chunk keeps the sampled rows that fall
        in it), an item list is sampled as one list; never chunk by chunk
        or item by item."""
        data = Dataset.of(data)
        idx = self.indices(len(data))
        if data.is_chunked:
            from ...data.chunked import concat_chunks
            from ...data.pipeline_scan import map_payload, payload_rows

            parts, row0 = [], 0
            for chunk in data.chunks():
                rows = payload_rows(chunk)
                lo, hi = np.searchsorted(idx, [row0, row0 + rows])
                if hi > lo:
                    local = torch.from_numpy(idx[lo:hi] - row0)
                    parts.append(map_payload(lambda a: a[local.to(a.device)], chunk))
                row0 += rows
            if row0 != len(data):
                raise ValueError(f"the chunks hold {row0} rows, the dataset {len(data)}")
            return Dataset(concat_chunks(parts))
        if data.is_batched:
            return Dataset(self.forward(data.to_array()))
        items = data.collect()
        return Dataset.from_items([items[i] for i in idx])


class ColumnSampler(Transformer):
    """Sample ``num_samples_per_matrix`` random columns of each (d, m)
    matrix item. A batched (n, d, m) stack samples in one gather with a
    column draw per item. The draws are numpy's, as in the JAX package, so
    one seed samples the same columns in both packages: a stateful
    ``default_rng(seed)`` for whole batches, ``default_rng((seed, chunk
    index))`` for :meth:`sample_chunk`."""

    def __init__(self, num_samples_per_matrix: int, seed: int = 0):
        self.num_samples = num_samples_per_matrix
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x)
        cols = self._rng.integers(0, x.shape[1], size=self.num_samples)
        return x[:, torch.from_numpy(cols).to(x.device)]

    def apply_batch(self, data) -> Dataset:
        data = Dataset.of(data)
        if not data.is_batched:
            return data.map(self.apply)
        if data.is_chunked:
            # lazily, a gather per chunk: the sample is small and is
            # materialized by its consumer, the descriptor stack never is
            from ...data.chunked import ChunkedDataset

            parent = data.raw_chunks

            def factory():
                for i, chunk in enumerate(parent()):
                    yield self.sample_chunk(chunk, i)

            return ChunkedDataset(factory, len(data), label="col_sample")
        return Dataset(self._sample_batch(data.to_array()))

    def sample_chunk(self, X: torch.Tensor, chunk_index: int) -> torch.Tensor:
        """Sample one chunk of a chunked scan, keyed by (seed, chunk index)
        so that a scan run again draws the same columns."""
        return self._sample_batch(torch.as_tensor(X),
                                  np.random.default_rng((self.seed, chunk_index)))

    def _sample_batch(self, X: torch.Tensor, rng=None) -> torch.Tensor:
        rng = self._rng if rng is None else rng
        n, d, m = X.shape
        cols = torch.from_numpy(rng.integers(0, m, size=(n, self.num_samples)))
        return X.gather(2, cols.to(X.device)[:, None, :].expand(n, d, self.num_samples))
