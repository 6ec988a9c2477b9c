"""CUDA graphs: the port's counterpart of a jitted XLA program.

The JAX package runs a fused group, and a fitted chain compiled for
serving, as one XLA program per input shape. Here the counterpart is one
``torch.cuda.CUDAGraph`` per input signature: the function's kernels are
captured once and replayed with one host call, where the eager path pays
a Python dispatch and a launch per operation (28,872 of them for
MnistRandomFFT's 200-branch featurizer over 60000 rows).

:class:`GraphCache` keeps those graphs for one function:

* a signature is the (shape, dtype) of every input tensor;
* the first call of a signature runs the function once on a side stream
  (the warm-up: it builds the cuFFT plans, picks the cuDNN algorithms and
  builds the port's own kernels at first use), then captures it on the
  same stream;
* every graph of one cache allocates from one memory pool;
* each call copies its inputs into the graph's static input buffers and
  replays; the result is the graph's static output, which the next replay
  overwrites, so a caller copies it out under :attr:`GraphCache.lock`.

Host synchronisation breaks a capture (``.item()``, a data-dependent
shape, a Cholesky that checks its ``info``): a capture that fails raises,
and nothing falls back to the eager path. So only functions without one
are captured; estimators bound the fused groups, and no fit is captured.

The K1 kernel's wrapper counts no launch while it is being captured
(``ops/gaussian_kernel.py``): each graph records how many it holds, and
each replay adds that many to ``gaussian_kernel_block.launches``.

Each capture counts as one compile for the tracer (``obs/tracer.py``), in
the ``compiles`` of every span open around it: the counterpart of the
JAX package's XLA compile count.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from ..data.dataset import map_leaves
from ..obs.tracer import count_compile
from ..ops import gaussian_kernel

#: one capture at a time in the process: a capture from one thread while
#: another captures could record the other's launches
_CAPTURE_LOCK = threading.Lock()


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's spelling of a torch dtype (``'float32'``), the one JAX gives."""
    return str(dtype).replace("torch.", "")


def leaves(payloads: Any) -> List[torch.Tensor]:
    """The tensors of a payload or of a tuple of payloads, in order."""
    if isinstance(payloads, (tuple, list)):
        return [t for p in payloads for t in leaves(p)]
    return [payloads]


def signature(payloads: Any) -> tuple:
    """(shape, dtype name) of every tensor of ``payloads``."""
    return tuple((tuple(t.shape), dtype_name(t.dtype)) for t in leaves(payloads))


class _Captured:
    __slots__ = ("graph", "inputs", "output", "kernel_launches")

    def __init__(self, graph, inputs, output, kernel_launches: int):
        self.graph = graph
        self.inputs = inputs
        self.output = output
        self.kernel_launches = kernel_launches


class GraphCache:
    """``fn(*payloads)`` on CUDA tensors as one CUDA graph per signature.

    ``on_capture(signature)`` is called after each capture. ``len(cache)``
    is the number of graphs captured. A caller that may share the cache
    with another thread holds :attr:`lock` from the call until it has
    copied the output out."""

    def __init__(self, fn: Callable[..., Any],
                 on_capture: Optional[Callable[[tuple], None]] = None):
        self._fn = fn
        self._on_capture = on_capture
        self._graphs: Dict[tuple, _Captured] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, *xs: Any) -> Any:
        sig = signature(xs)
        with self.lock:
            entry = self._graphs.get(sig)
            if entry is None:
                entry = self._graphs[sig] = self._capture(xs)
                count_compile()
                if self._on_capture is not None:
                    self._on_capture(sig)
            for dst, src in zip(leaves(entry.inputs), leaves(xs)):
                dst.copy_(src)
            entry.graph.replay()
            gaussian_kernel.count_launches(entry.kernel_launches)
            return entry.output

    def _capture(self, xs: tuple) -> _Captured:
        device = leaves(xs)[0].device
        static = tuple(map_leaves(torch.clone, x) for x in xs)
        with _CAPTURE_LOCK, torch.cuda.device(device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
                self._pool = torch.cuda.graph_pool_handle()
            stream = self._stream
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                self._fn(*static)  # the warm-up; its result is dropped
            torch.cuda.current_stream(device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            before = gaussian_kernel.captured_launches()
            # thread_local: another thread's CUDA calls (a sync, a malloc)
            # during this capture neither fail nor end it
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = self._fn(*static)
            launches = gaussian_kernel.captured_launches() - before
        return _Captured(graph, static, out, launches)
