"""Trace MnistRandomFFT's featurizer and BCD solve on one CUDA card.

    python -m keystone_tpu_torch.trace_mnist [--numFFTs 200] [--nTrain 60000]

Draws the synthetic training set, then runs each phase once to warm up,
once on the host clock and once under ``torch.profiler``:

* ``featurize``, twice: the gathered RandomSignNode → PaddedFFT →
  LinearRectifier branches and VectorCombiner over the training rows as
  one fused operator in row chunks, first run eagerly (``path: eager``,
  one launch per operation) and then as the fit runs it on the card
  (``path: captured``, one CUDA-graph replay per chunk);
* ``solve``: the one-pass BlockLeastSquaresEstimator on those features.

Prints one JSON line per phase: the host seconds of the untraced run, the
device time the traced run's kernels cover (the union of their intervals),
the idle share of the untraced run (1 − device time / host seconds), the
kernel count, the host's kernel launches, graph launches and copies (the
CUDA runtime calls the profiler saw), the seconds between two CUDA events
around the untraced run, and the kernels that take the most device time.
The featurizer's line also gives the bytes its operations must move, each
operation's inputs read once and its outputs written once. Needs a CUDA
card; ``--out`` also writes the lines to a file.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, Iterable, List

import torch

from . import device as pick_device
from .data.dataset import Dataset
from .nodes.learning.linear import BlockLeastSquaresEstimator
from .nodes.util import ClassLabelIndicators
from .pipelines.mnist_random_fft import (
    MNIST_IMAGE_SIZE, NUM_CLASSES, MnistRandomFFTConfig, build_featurizer, synthetic_mnist,
)
from .workflow.fusion import ROW_CHUNK, FusedTransformerOperator, forward_in_row_chunks

#: the CUDA runtime and driver calls that launch one kernel, launch a
#: captured graph, or copy memory, as the profiler names them
KERNEL_LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"})
GRAPH_LAUNCH_CALLS = frozenset({"cudaGraphLaunch", "cuGraphLaunch"})
COPY_CALLS = frozenset({"cudaMemcpyAsync", "cudaMemcpy", "cuMemcpyAsync"})


def launch_counts(host_call_names: Iterable[str]) -> Dict[str, int]:
    """Kernel launches, graph launches and copies among the host-side calls
    a profiler recorded."""
    names = Counter(host_call_names)
    return {key: sum(names[n] for n in calls) for key, calls in (
        ("host_launches", KERNEL_LAUNCH_CALLS), ("graph_launches", GRAPH_LAUNCH_CALLS),
        ("copies", COPY_CALLS))}


def featurize_bytes(n: int, num_ffts: int, d: int = MNIST_IMAGE_SIZE) -> Dict[str, int]:
    """Bytes each operation of the featurizer moves over ``n`` rows, its
    float32 inputs read once and outputs written once: the sign product,
    the zero pad to P = 2^ceil(log2 d), the rfft to P/2 + 1 complex bins,
    the copy of the kept real parts, the rectifier, the combiner's
    concatenation of a chunk's branches, and the copy of each chunk into
    the preallocated output."""
    P = 1 << max(0, d - 1).bit_length()
    h = P // 2
    per_row = {"sign": d + d, "pad": d + P, "rfft": P + 2 * (h + 1),
               "real_copy": h + h, "rectify": h + h, "combine": h + h,
               "chunk_copy": h + h}
    return {k: 4 * n * num_ffts * v for k, v in per_row.items()}


def _busy_seconds(intervals: List[tuple]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy * 1e-6  # the profiler's clock is in microseconds


def trace(fn: Callable[[], object], top: int = 8) -> dict:
    """Host seconds of ``fn`` untraced, then its kernels under the
    profiler. ``fn`` has run once before, so nothing here compiles."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del out
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    del out
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = launch_counts(e.name for e in events
                          if e.device_type == torch.autograd.DeviceType.CPU)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    busy = _busy_seconds([(e.time_range.start, e.time_range.end) for e in kernels])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"host_seconds": wall, "device_seconds": busy,
            "idle_share": 1.0 - busy / wall if wall > 0 else None,
            "kernels": len(kernels), **calls,
            "event_seconds": start.elapsed_time(end) * 1e-3,
            "top": [{"name": k[:120], "count": c, "seconds": us * 1e-6}
                    for k, (c, us) in ranked]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("trace_mnist")
    p.add_argument("--numFFTs", type=int, default=200)
    p.add_argument("--blockSize", type=int, default=2048)
    p.add_argument("--lambda", dest="lam", type=float, default=1000.0)
    p.add_argument("--nTrain", type=int, default=60000)
    p.add_argument("--out", default=None, help="also write the JSON lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_mnist needs a CUDA card")
    dev = pick_device()
    train, _ = synthetic_mnist(args.nTrain, 1)
    X = train.data.to_array().to(dev, torch.float32)
    labels = ClassLabelIndicators(NUM_CLASSES).forward(train.labels.to_array().to(dev))
    # the estimator-free fit fuses the branches into one chunked operator
    featurizer = build_featurizer(MnistRandomFFTConfig(num_ffts=args.numFFTs), dev).fit()
    est = BlockLeastSquaresEstimator(args.blockSize, 1, args.lam)

    (fused,) = [op for op in featurizer.graph.operators.values()
                if isinstance(op, FusedTransformerOperator)]

    def featurize_eager():
        return forward_in_row_chunks(fused.forward, [X], len(X))

    def featurize():
        return featurizer.apply(X).to_array()

    # cuFFT plans, the allocator, and the capture of a chunk's graph
    featurizer.apply(X[:ROW_CHUNK])
    lines = [dict(phase="featurize", path=path, num_ffts=args.numFFTs, rows=args.nTrain,
                  **trace(fn), bytes=featurize_bytes(args.nTrain, args.numFFTs))
             for path, fn in (("eager", featurize_eager), ("captured", featurize))]
    F = featurize()
    est.fit(Dataset.of(F[:ROW_CHUNK]), Dataset.of(labels[:ROW_CHUNK]))
    lines.append(dict(phase="solve", d=F.shape[1], rows=F.shape[0],
                      **trace(lambda: est.fit(Dataset.of(F), Dataset.of(labels)))))
    for line in lines:
        line["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
