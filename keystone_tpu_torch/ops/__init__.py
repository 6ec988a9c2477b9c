"""The port's hand-written kernels. Importing the package registers K1 as
the ``keystone::gaussian_kernel_block`` custom operator, which a saved
``torch.export`` program names.

:data:`DEVICE_FAULTS` are the errors no fallback may hide: a kernel's build
or launch failure and the card's own faults. The auto-cache profiler's
sampled pulls and a bound segment let them propagate."""

import torch

from . import gaussian_kernel  # noqa: F401
from ._build import KernelError

DEVICE_FAULTS = (KernelError, torch.cuda.OutOfMemoryError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


def is_device_fault(exc: BaseException) -> bool:
    """One of :data:`DEVICE_FAULTS`, or a CUDA error that a torch without
    ``torch.AcceleratorError`` raises as a plain ``RuntimeError``."""
    return isinstance(exc, DEVICE_FAULTS) or (
        isinstance(exc, RuntimeError) and "CUDA error" in str(exc))
