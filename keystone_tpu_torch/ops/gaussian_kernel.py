"""K1: the Gaussian kernel block  exp(−γ·max(‖x‖² − 2x·y + ‖y‖², 0)).

Port of the Pallas TPU kernel ``gaussian_kernel_block_pallas``
(``keystone_tpu/ops/gaussian_kernel.py:51``, its ``pallas_call`` at :64) as
a hand-written CUDA kernel for Hopper, ``csrc/gaussian_kernel.cu``: a
pre-pass writes each row's FP32 norm and its TF32 hi/lo split into
scratch, then a persistent warp-specialized kernel forms the cross term in
3×TF32 (``wgmma`` hi·hi + hi·lo + lo·hi, fed by TMA into mbarrier-guarded
shared-memory stages, its partial sums promoted into an FP32 accumulator
every 32 of d) with the norms, clamp and exp in its epilogue.

* Bound on an H100: 3·2nbd TF32 operations at 495 TFLOP/s against
  4·(nd + bd + nb) bytes at 3.35 TB/s; operations bound it (2.42 ms
  against 0.35 ms at the KRR fit shape (50000, 800, 5000)).
* Why 3×TF32: it is as close to the float64 value as FP32 is (1.4e-7
  against plain FP32's 1.5e-7 at (10000, 800, 5000) and the CIFAR γ, on an
  H100); one TF32 pass is ~1.3e-5 off.

* ``torch.ops.keystone.gaussian_kernel_block(X, Xb, gamma)`` is K1 as a
  ``torch.library`` custom operator, so a ``torch.export`` program of a
  chain that runs K1 names it (``compile/aot.py``). Its CUDA
  implementation launches the kernel and counts each launch in
  ``gaussian_kernel_block.launches`` (through :func:`count_launches`,
  exact under concurrent serving replicas); a call made while this
  thread captures a CUDA graph launches nothing: it is counted in
  :func:`captured_launches`, and whoever replays the graph adds that many
  to ``launches`` at each replay. Its CPU implementation is the plain
  version. Its fake implementation (``torch.export``'s trace, the static
  checker's ``FakeTensorMode``) returns an empty (n, b) tensor and
  launches nothing.
* :func:`gaussian_kernel_block` is the validating front door to the
  operator for CUDA tensors, and holds the ``launches`` count.
* :func:`gaussian_kernel_block_plain` is the same function in plain
  PyTorch (port of ``_gaussian_block_xla``, FP32 with TF32 off): what CPU
  tensors run, and the reference the kernel is held against on the card.

The TPU gate ``pallas_block_supported`` (d and b multiples of 128, a VMEM
budget) is not ported: every shape goes through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

_MAX_ROWS = 2**31 - 1  # the kernel indexes rows and TMA coordinates in int32


def gaussian_kernel_block_plain(X: torch.Tensor, Xb: torch.Tensor,
                                gamma: float) -> torch.Tensor:
    """exp(−γ‖x−y‖²) for all (row of X, row of Xb): (n, b)."""
    xn = torch.sum(X * X, dim=1, keepdim=True)
    bn = torch.sum(Xb * Xb, dim=1)
    sq = xn - 2.0 * (X @ Xb.T) + bn
    return torch.exp(-gamma * torch.clamp_min(sq, 0.0))


_LIB = None
#: device indices whose kernel attributes are set (once per device)
_SET_UP: set = set()


def _lib() -> ctypes.CDLL:
    """The library built from the checkout's source, with its C signatures
    declared once (ctypes would otherwise pass each pointer as a 32-bit
    int)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("gaussian_kernel")
        lib.gaussian_kernel_scratch_floats.argtypes = [ctypes.c_int64] * 3
        lib.gaussian_kernel_scratch_floats.restype = ctypes.c_int64
        lib.gaussian_kernel_setup.argtypes = []
        lib.gaussian_kernel_setup.restype = ctypes.c_int
        lib.gaussian_kernel_block_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_void_p,
        ]
        lib.gaussian_kernel_block_f32.restype = ctypes.c_int
        lib.keystone_cuda_error_string.argtypes = [ctypes.c_int]
        lib.keystone_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero error code from ``lib``."""
    if err != 0:
        msg = lib.keystone_cuda_error_string(err).decode()
        raise _build.KernelError(f"gaussian_kernel_block {what} failed: {msg} ({err})")


def _check_shapes(X: torch.Tensor, Xb: torch.Tensor) -> None:
    if X.dim() != 2 or Xb.dim() != 2 or X.shape[1] != Xb.shape[1]:
        raise ValueError(
            f"shapes {tuple(X.shape)} and {tuple(Xb.shape)}: want (n, d) and (b, d)"
        )


@torch.library.custom_op("keystone::gaussian_kernel_block", mutates_args=(),
                         device_types="cpu")
def _k1_op(X: torch.Tensor, Xb: torch.Tensor, gamma: float) -> torch.Tensor:
    """K1 on CPU tensors: the plain version."""
    _check_shapes(X, Xb)
    return gaussian_kernel_block_plain(X, Xb, gamma)


@_k1_op.register_fake
def _k1_fake(X: torch.Tensor, Xb: torch.Tensor, gamma: float) -> torch.Tensor:
    # a fake tensor carries no data: the block's shape is the answer, and
    # nothing launches
    _check_shapes(X, Xb)
    return X.new_empty((X.shape[0], Xb.shape[0]))


@_k1_op.register_kernel("cuda")
def _k1_launch(X: torch.Tensor, Xb: torch.Tensor, gamma: float) -> torch.Tensor:
    """K1 on CUDA tensors: the kernel launches or this raises."""
    if X.device != Xb.device:
        raise ValueError("gaussian_kernel_block takes two tensors on one CUDA device")
    if X.dtype != torch.float32 or Xb.dtype != torch.float32:
        raise TypeError("gaussian_kernel_block takes float32 tensors")
    _check_shapes(X, Xb)
    n, d = X.shape
    b = Xb.shape[0]
    for t in (X, Xb):
        if d > 1 and t.shape[0] > 0 and t.stride(1) != 1:
            raise ValueError("rows of X and Xb must be contiguous (stride(1) == 1)")
    if max(n, b) > _MAX_ROWS:
        raise ValueError(f"n = {n}, b = {b}: the kernel takes at most {_MAX_ROWS} rows")
    out = torch.empty((n, b), dtype=torch.float32, device=X.device)
    if n == 0 or b == 0:
        return out
    lib = _lib()
    with torch.cuda.device(X.device):
        if X.device.index not in _SET_UP:
            _check(lib, lib.gaussian_kernel_setup(), "setup")
            _SET_UP.add(X.device.index)
        # the norms and the TF32 hi/lo split of both operands (csrc header)
        scratch = torch.empty(lib.gaussian_kernel_scratch_floats(n, b, d),
                              dtype=torch.float32, device=X.device)
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.gaussian_kernel_block_f32(
            X.data_ptr(), X.stride(0), Xb.data_ptr(), Xb.stride(0),
            scratch.data_ptr(), out.data_ptr(), n, b, d, float(gamma), stream,
        )
    _check(lib, err, "launch")
    if torch.cuda.is_current_stream_capturing():
        _captured.launches = captured_launches() + 1
    else:
        count_launches(1)
    return out


def gaussian_kernel_block(X: torch.Tensor, Xb: torch.Tensor,
                          gamma: float) -> torch.Tensor:
    """(n, d), (b, d) float32 CUDA tensors → (n, b) Gaussian kernel block,
    by the CUDA kernel (through the ``keystone::gaussian_kernel_block``
    operator). Rows may be strided; each row must be contiguous."""
    if not (X.is_cuda and Xb.is_cuda and X.device == Xb.device):
        raise ValueError("gaussian_kernel_block takes two tensors on one CUDA device")
    return torch.ops.keystone.gaussian_kernel_block(X, Xb, float(gamma))


gaussian_kernel_block.launches = 0

#: serializes the additions to ``gaussian_kernel_block.launches``: serving
#: replicas launch K1 and replay graphs holding it from several threads, and
#: ``+=`` on an attribute is a read and a write another thread can split
_LAUNCH_LOCK = threading.Lock()


def count_launches(n: int) -> None:
    """Add ``n`` launches to ``gaussian_kernel_block.launches``, exactly
    under any number of threads. Readers read the attribute and a caller
    may set it to 0 between runs, as before."""
    with _LAUNCH_LOCK:
        gaussian_kernel_block.launches += n


#: per thread: the launches recorded into CUDA graphs captured on it
_captured = threading.local()


def captured_launches() -> int:
    """How many launches this thread has recorded into CUDA graphs so far
    (a capture reads it before and after)."""
    return getattr(_captured, "launches", 0)
