"""The control one step below the configurations' precision (float32 with
TF32 off): every float32 product of cuBLAS and cuDNN in TF32. It must come
out not correct."""

from __future__ import annotations


def install():
    """Switch the control on; returns the call that switches it off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    def undo() -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    return undo
