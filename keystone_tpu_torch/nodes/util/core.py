"""Glue nodes (port of ``ClassLabelIndicators``,
``MultiClassLabelIndicators``, ``MaxClassifier``, ``TopKClassifier``,
``VectorCombiner``, ``VectorSplitter``, ``Cacher``, ``Shuffler``,
``FloatToDouble``, ``DoubleToFloat``, ``MatrixVectorizer``, ``Densify``
and ``Sparsify`` from ``keystone_tpu/nodes/util/core.py``)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...data.dataset import Dataset, map_leaves
from ...workflow.transformer import Transformer


class ClassLabelIndicators(Transformer):
    """Int label → ±1 indicator vector: −1 everywhere, +1 at the class."""

    row_local = True

    def __init__(self, num_classes: int):
        if num_classes <= 1:
            raise ValueError("num_classes must be > 1")
        self.num_classes = num_classes

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return 2.0 * F.one_hot(y.long(), self.num_classes).float() - 1.0


class MultiClassLabelIndicators(Transformer):
    """A label set (any number of class indices) → ±1 multi-hot vector.
    Label sets are ragged, so this is a per-item host node."""

    def __init__(self, num_classes: int):
        if num_classes <= 1:
            raise ValueError("num_classes must be > 1")
        self.num_classes = num_classes

    def apply(self, labels) -> torch.Tensor:
        out = np.full((self.num_classes,), -1.0, dtype=np.float32)
        out[np.asarray(labels, dtype=np.int64)] = 1.0
        return torch.from_numpy(out)

    def out_spec(self, labels_spec=None):
        # a per-item host node, so not abstractly evaluable, but the
        # output's spec is fixed by construction (``check/abstract.py``)
        return ((self.num_classes,), "float32")


class MaxClassifier(Transformer):
    """argmax over the score vector; ties go to the first maximum, as
    ``jnp.argmax`` breaks them."""

    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.argmax(X, dim=-1)


class TopKClassifier(Transformer):
    """Indices of the k largest scores, largest first. Ties go to the lower
    index, as ``jax.lax.top_k`` breaks them: ``torch.topk`` promises no
    order among ties, so this takes the first k of a stable descending
    sort."""

    row_local = True

    def __init__(self, k: int):
        self.k = k

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.sort(X, dim=-1, descending=True, stable=True).indices[..., :self.k]


class VectorCombiner(Transformer):
    """Concatenate the gathered branch outputs feature-wise; a single tensor
    passes through."""

    row_local = True

    def forward(self, Xs: Union[torch.Tensor, Tuple[torch.Tensor, ...]]) -> torch.Tensor:
        if isinstance(Xs, tuple):
            return torch.cat(Xs, dim=-1)
        return Xs


class VectorSplitter(Transformer):
    """Split (n, d) features into ceil(d / block_size) column blocks, as
    views; the last block may be short."""

    row_local = True

    def __init__(self, block_size: int, num_features: Optional[int] = None):
        self.block_size = block_size
        self.num_features = num_features

    def split_batch(self, X: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        d = self.num_features or X.shape[-1]
        return tuple(X[..., i:min(i + self.block_size, d)]
                     for i in range(0, d, self.block_size))

    def forward(self, X: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.split_batch(X)

    def out_spec(self, in_spec=None):
        # the blocks follow from the input width; an unknown input stays
        # unknown (the checker never guesses)
        if in_spec is None:
            return None
        shape, dtype = in_spec
        if not shape:
            raise ValueError("VectorSplitter needs a feature axis")
        d = self.num_features or int(shape[-1])
        lead = tuple(shape[:-1])
        return tuple((lead + (min(self.block_size, d - i),), dtype)
                     for i in range(0, d, self.block_size))


class Cacher(Transformer):
    """Materialize and hold the upstream result. Inside a fused group it is
    the identity, so a chain with Cachers still fuses and compiles."""

    row_local = True

    def __init__(self, name: Optional[str] = None):
        self.name = name

    def forward(self, X):
        return X

    def apply(self, x):
        return x

    def apply_batch(self, data) -> Dataset:
        return Dataset.of(data).cache()


class Shuffler(Transformer):
    """Permute the rows by ``numpy.random.default_rng(seed).permutation``,
    the JAX package's draw, so one seed gives one order in both."""

    def __init__(self, seed: int = 42):
        self.seed = seed

    def out_spec(self, in_spec=None):
        return in_spec  # a permutation keeps the spec

    def apply(self, x):
        return x

    def apply_batch(self, data) -> Dataset:
        data = Dataset.of(data)
        if data.is_chunked:
            raise ValueError(
                "Shuffler permutes the whole dataset and cannot run per chunk; "
                "materialize the dataset (e.g. .cache()) first")
        perm = np.random.default_rng(self.seed).permutation(len(data))
        if data.is_batched:
            return Dataset(map_leaves(lambda t: t[torch.from_numpy(perm).to(t.device)],
                                      data.payload))
        items = data.collect()
        return Dataset.from_items([items[i] for i in perm])


class FloatToDouble(Transformer):
    """Widen to float64."""

    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X.double()


class DoubleToFloat(Transformer):
    """Narrow to float32."""

    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X.float()


class MatrixVectorizer(Transformer):
    """Flatten each (r, c) matrix item column-major (Fortran order), as
    breeze's ``toDenseVector`` does: (n, r, c) → (n, r·c) with element
    (i, j) at i + j·r."""

    row_local = True

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X.transpose(1, 2).reshape(X.shape[0], -1)


class Densify(Transformer):
    """Sparse → dense per item: a scipy sparse item becomes a 1-D float32
    tensor, anything else a tensor."""

    def apply(self, x):
        if hasattr(x, "todense"):
            return torch.as_tensor(np.asarray(x.todense(), dtype=np.float32).squeeze())
        return torch.as_tensor(x)


class Sparsify(Transformer):
    """Dense → one scipy CSR row per item, on the host."""

    def apply(self, x):
        import scipy.sparse as sp

        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return sp.csr_matrix(np.asarray(x))
