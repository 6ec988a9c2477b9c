"""Trace MnistRandomFFT's featurizer and BCD solve on one CUDA card.

    python -m keystone_tpu_torch.trace_mnist [--numFFTs 200] [--nTrain 60000]

Draws the synthetic training set, then runs each phase once to warm up,
once on the host clock and once under ``torch.profiler``:

* ``featurize``: the gathered RandomSignNode → PaddedFFT → LinearRectifier
  branches and VectorCombiner over the training rows, as the fit runs
  them: one fused operator, in row chunks;
* ``solve``: the one-pass BlockLeastSquaresEstimator on those features.

Prints one JSON line per phase: the host seconds of the untraced run, the
device time the traced run's kernels cover (the union of their intervals),
the idle share of the untraced run (1 − device time / host seconds), the
kernel count, and the kernels that take the most device time. The
featurizer's line also gives the bytes its operations must move, each
operation's inputs read once and its outputs written once. Needs a CUDA
card; ``--out`` also writes the lines to a file.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

from . import device as pick_device
from .data.dataset import Dataset
from .nodes.learning.linear import BlockLeastSquaresEstimator
from .nodes.util import ClassLabelIndicators
from .pipelines.mnist_random_fft import (
    MNIST_IMAGE_SIZE, NUM_CLASSES, MnistRandomFFTConfig, build_featurizer, synthetic_mnist,
)
from .workflow.fusion import ROW_CHUNK


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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del out
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    del out
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    busy = _busy_seconds([(e.time_range.start, e.time_range.end) for e in kernels])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"host_seconds": wall, "device_seconds": busy,
            "idle_share": 1.0 - busy / wall if wall > 0 else None,
            "kernels": len(kernels),
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

    def featurize():
        return featurizer.apply(X).to_array()

    featurizer.apply(X[:ROW_CHUNK])  # cuFFT plans and the allocator
    lines = [dict(phase="featurize", num_ffts=args.numFFTs, rows=args.nTrain,
                  **trace(featurize),
                  bytes=featurize_bytes(args.nTrain, args.numFFTs))]
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
