"""keystone_tpu_torch — the PyTorch/CUDA port of keystone_tpu.

Module paths and class names mirror ``keystone_tpu`` so each ported part
can be found beside its reference. The package imports torch, numpy and
the standard library only.

Numerics: the JAX package runs its solver GEMMs at f32 "high" precision
(``keystone_tpu/linalg/row_matrix.py``). Here the same trap is TF32,
which both cuBLAS (opt-in) and cuDNN convolutions (on by default) would
use for float32 work, so both are switched off for the whole package.
"""

from __future__ import annotations

from typing import Optional

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def device(name: Optional[str] = None) -> torch.device:
    """The device the port runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (the default) and absent: the port never
    falls back to the CPU on its own; tests pass ``"cpu"`` explicitly."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device 'cpu' to run on the CPU"
        )
    return dev
