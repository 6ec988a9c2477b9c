"""Pickle helpers for ``FittedPipeline`` persistence (port of
``keystone_tpu/utils/serialization.py``).

Torch tensors pickle as they are: a saved CUDA tensor loads back onto the
device it names. Load only files this program wrote: unpickling can run
arbitrary code.
"""

from __future__ import annotations

import pickle
from typing import Any


def save_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)
