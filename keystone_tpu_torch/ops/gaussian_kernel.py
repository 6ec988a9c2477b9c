"""K1: the Gaussian kernel block  exp(−γ·max(‖x‖² − 2x·y + ‖y‖², 0)).

Port of the Pallas TPU kernel ``gaussian_kernel_block_pallas``
(``keystone_tpu/ops/gaussian_kernel.py``) as a hand-written CUDA kernel,
``csrc/gaussian_kernel.cu`` (tiled FP32 GEMM with the norms and exp fused
into its epilogue; its header gives the design and the bound on an H100).

* :func:`gaussian_kernel_block` launches the kernel; it takes CUDA tensors
  only and counts its launches in ``gaussian_kernel_block.launches``. A
  call made while this thread captures a CUDA graph launches nothing: it
  is counted in :func:`captured_launches`, and whoever replays the graph
  adds that many to ``launches`` at each replay.
* :func:`gaussian_kernel_block_plain` is the same function in plain
  PyTorch (port of ``_gaussian_block_xla``): what CPU tensors run, and
  the reference the kernel is held against on the card.

The TPU gate ``pallas_block_supported`` (d and b multiples of 128, a VMEM
budget) is not ported: every shape goes through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

_MAX_ROW_TILES = 65535  # gridDim.y limit; the kernel tiles rows of X by 128
_ROW_TILE = 128


def gaussian_kernel_block_plain(X: torch.Tensor, Xb: torch.Tensor,
                                gamma: float) -> torch.Tensor:
    """exp(−γ‖x−y‖²) for all (row of X, row of Xb): (n, b)."""
    xn = torch.sum(X * X, dim=1, keepdim=True)
    bn = torch.sum(Xb * Xb, dim=1)
    sq = xn - 2.0 * (X @ Xb.T) + bn
    return torch.exp(-gamma * torch.clamp_min(sq, 0.0))


_BOUND = False


def _lib() -> ctypes.CDLL:
    """The built library, with its C signatures declared once (ctypes
    would otherwise pass each pointer as a 32-bit int)."""
    global _BOUND
    lib = _build.load("gaussian_kernel")
    if not _BOUND:
        lib.gaussian_kernel_block_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_void_p,
        ]
        lib.gaussian_kernel_block_f32.restype = ctypes.c_int
        lib.keystone_cuda_error_string.argtypes = [ctypes.c_int]
        lib.keystone_cuda_error_string.restype = ctypes.c_char_p
        _BOUND = True
    return lib


def gaussian_kernel_block(X: torch.Tensor, Xb: torch.Tensor,
                          gamma: float) -> torch.Tensor:
    """(n, d), (b, d) float32 CUDA tensors → (n, b) Gaussian kernel block,
    by the CUDA kernel. Rows may be strided; each row must be contiguous."""
    if not (X.is_cuda and Xb.is_cuda and X.device == Xb.device):
        raise ValueError("gaussian_kernel_block takes two tensors on one CUDA device")
    if X.dtype != torch.float32 or Xb.dtype != torch.float32:
        raise TypeError("gaussian_kernel_block takes float32 tensors")
    if X.dim() != 2 or Xb.dim() != 2 or X.shape[1] != Xb.shape[1]:
        raise ValueError(
            f"shapes {tuple(X.shape)} and {tuple(Xb.shape)}: want (n, d) and (b, d)"
        )
    n, d = X.shape
    b = Xb.shape[0]
    for t in (X, Xb):
        if d > 1 and t.shape[0] > 0 and t.stride(1) != 1:
            raise ValueError("rows of X and Xb must be contiguous (stride(1) == 1)")
    if -(-n // _ROW_TILE) > _MAX_ROW_TILES:
        raise ValueError(f"n = {n} exceeds the kernel's grid ({_MAX_ROW_TILES * _ROW_TILE} rows)")
    out = torch.empty((n, b), dtype=torch.float32, device=X.device)
    if n == 0 or b == 0:
        return out
    norms = torch.empty(n + b, dtype=torch.float32, device=X.device)
    lib = _lib()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.gaussian_kernel_block_f32(
            X.data_ptr(), X.stride(0), Xb.data_ptr(), Xb.stride(0),
            norms.data_ptr(), out.data_ptr(), n, b, d, float(gamma), stream,
        )
    if err != 0:
        msg = lib.keystone_cuda_error_string(err).decode()
        raise RuntimeError(f"gaussian_kernel_block launch failed: {msg} ({err})")
    if torch.cuda.is_current_stream_capturing():
        _captured.launches = captured_launches() + 1
    else:
        gaussian_kernel_block.launches += 1
    return out


gaussian_kernel_block.launches = 0

#: per thread: the launches recorded into CUDA graphs captured on it
_captured = threading.local()


def captured_launches() -> int:
    """How many launches this thread has recorded into CUDA graphs so far
    (a capture reads it before and after)."""
    return getattr(_captured, "launches", 0)
