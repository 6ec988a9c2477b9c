"""Pickle helpers for ``FittedPipeline`` persistence (port of
``keystone_tpu/utils/serialization.py``).

Torch tensors pickle as they are: a saved CUDA tensor loads back onto the
device it names. Load only bytes and files this program wrote: unpickling
can run arbitrary code.
"""

from __future__ import annotations

import pickle
from typing import Any


def dumps(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def loads(data: bytes) -> Any:
    return pickle.loads(data)


def save_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        f.write(dumps(obj))


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)
