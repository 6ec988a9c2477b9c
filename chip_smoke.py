"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in the checkout, holds each
against its plain PyTorch version on the card, checks the KRR algebra
against a dense solve, then runs RandomPatchCifarKernel at full width
(CIFAR-10's 50000 / 10000 images, synthetic, from a seed) through the
command-line entry point and checks that the kernels carried it. Then
MnistRandomFFT: a small run on the card against the CPU, BASELINE's
configuration (4 FFTs) against the task's Bayes error, and the CLI's
default width (200 FFTs, d = 102,400, 50 BCD block steps over a 24.6 GB
feature matrix) with its peak memory. Both applications run through the
workflow graph; the script checks the plans the optimizer made (fused
groups, the fit data featurized once), that every estimator fitted once
across a fit and the applies, and how long the optimizer took. A fused
group runs on the card as CUDA-graph replays. Three paths follow each
application's run: one-program apply of the fitted CIFAR chain
(``apply_compiled`` on the 10000 test rows and ``apply_chunked``, with
K1's launches per replay), the same chain served by ``ServingEngine``
(``serve_cifar``: the 10000 test rows as single-row requests from 16
client threads into buckets 1 / 8 / 32 / 64, one CUDA graph a bucket, K1
10 times a batch inside the replays and held against its plain version at
each bucket's shape; ``serve_swap``: a same-contract swap under traffic,
and a replacement of another datum width refused; ``fleet_cifar``: the same
chain and traffic from a ``ServingFleet`` of 4 replicas co-resident on the
card, each with its own stream and CUDA graphs (4 compiles, 16 captures,
every replica busy, K1 exactly 10 a batch); ``fleet_swap``: under traffic a
canaried swap to the same chain promotes and a candidate with scaled KRR
weights rolls back (``CanaryMismatch``, the flight dump); ``fleet_supervision``:
a fault plan kills one replica and quarantines another, no admitted request
lost; ``fleet_devices``: the same chain from a fleet of one replica on the
card and one on the host serving a copy of it (no CUDA tensor in the copy,
no card byte allocated by it, answers within 1e-3 of the eager apply
relative to its largest score, K1 10 a card batch and none from the host, a
canaried swap promoted and one rolled back on both devices, the host replica
killed and restarted on its copy); ``fleet_devices_aot``: that fleet cold
and warm against a fresh AOT cache (4 exports a backend, 8 loads, each
program's constants on its own device, bit-equal); ``fleet_two_cards``
(only with a second card); ``cluster_cifar``: the same chain and traffic from a ``ClusterRouter``
over 2 worker processes on the card, the chain shipped as host bytes, a fresh
AOT cache (K1 exactly 10 a batch in the workers, none in this process), then
on it ``cluster_supervision`` (a SIGKILLed worker respawned warm, no admitted
request lost) and ``cluster_scale`` (the autoscaler's actuator verbs and one
tick) while a traced router boots over the warm cache for ``cluster_warm``
(0 traces, 4 loads a worker) and ``cluster_trace`` (each request's hops
stitched across 3 process tracks, one ``/metrics`` scrape), and
``cluster_boots``; ``aot_cifar``: the same
chain booted against a fresh AOT executable cache, cold (four exported
programs, each naming K1 ten times) then warm from a pickled clone (four
programs loaded, no call of the chain's trace function, four captures, K1
10 times a batch, each bucket's scores bit-equal to the cold boot's);
``aot_fallback``: one entry overwritten, the next boot exports that bucket
alone; ``segment_cifar``: segment dispatch, on by default, runs the same
chain as one eager program a batch, bit-equal to node dispatch
(``KEYSTONE_SEGMENT_COMPILE=0``) and K1 10 a run as there, then against an
AOT cache of its own a
cold executor exports the segment (each program naming K1 10 times) and a
warm one loads it with no trace, bit-equal; ``segment_prewarm``: the
manifest's programs under an element budget; ``flight_fault``: an
``aot.read`` fault plan, the flight dump holding the injection and its
recovery instant, and the memory watermark against the allocator's peak),
one-program apply at 200 FFTs (with the featurizer's host launches traced
eager against captured; ``segment_apply_mnist``: a first apply with
segments on against off, the plan and the digests timed apart;
``segment_mnist``: the same run with segments off, its predictions and
steps equal), and the KRR
family on 8000 CIFAR features (the cost-model chooser picks the exact
solve, which builds its kernel from K1 blocks). Then TimitPipeline: a small
run on the card against the CPU, and the JAX CLI's defaults (then
``segment_apply_timit`` on its fitted chain; 50 cosine
branches of 4096, d = 204,800, five sweeps of 50 blocks over a 40.96 GB
feature matrix of 50000 synthetic frames), which runs no hand-written
kernel, with a traced sweep of its block solve; and the least-squares family on those frames, where the cost model
picks the exact solve for the raw 440-wide frames and the block solver for
one 4096-wide cosine branch, with TSQR and L-BFGS held against the exact
solve and the CPU. Then the rest of the CIFAR family through the command
line's code at CIFAR-10's 50000 / 10000 (RandomPatchCifar, LinearPixels,
RandomCifar, RandomPatchCifarAugmented: error bounds, no K1 launch), the
augmented application small on the card against the CPU, and
VOCSIFTFisher: small on the card against the CPU through the load path,
the command line's defaults, and full width (dense SIFT of 2000 / 1000
synthetic 256² images, 23,599 descriptors each, PCA to 80, a 256-centre
GMM, Fisher vectors of 40,960) with its peak memory and per-phase
seconds. Last, ImageNetSiftLcsFV: DAISY, HOG and LCS against the CPU; small
on the card against the CPU through the load path; the command line's
defaults; the calibrated 100-class row at 224² against its Bayes error and
raw pixels (the weighted solver's dual path); and the reference's widths
(1000 classes, descDim 64, vocabSize 16, λ 6e-5) on 5000 / 1000 synthetic
256² images (the dense path, 125 class chunks, FVs of 4096) with its peak
memory and the solver's phases; after each of the last two, the weighted
solve is held against a float64 per-class solve. Then the text
applications: NewsgroupsPipeline and AmazonReviewsPipeline small on the card
against the CPU, then at the JAX CLIs' defaults (100,000 common features of
uni- and bigrams) on 11,314 / 7,532 and 262,144 / 65,536 synthetic
documents, with the seconds split between the host's text work (the native
frontend, which must have been built and run) and the card; the sparse
L-BFGS at the reference's Amazon shape (n 262,144, d 16,384, 85 entries a
row, 50 iterations) by its Gram and its gather/scatter strategies, against
the planted flip rate, each other and the Gram's FP32 bound; and
StupidBackoffPipeline's defaults. Last, the out-of-core fit: the pipelined
scan against a serial one (overlap, bit-equal results) and a fused chain's
CUDA graphs over ragged chunks; bench.py's streamed block and exact solves
at TIMIT's 2,228,224 rows (d 16,384 and 8,192, drawn on the card chunk by
chunk, against their planted models); TimitPipeline fitted over all
2,228,224 synthetic frames at d = 16,384 (4 cosine branches), the 146 GB
design matrix never whole (20 block steps, 21 scans of 34 chunks, peak
below 32 GB; its segments on the chunked path, and ``segment_chunked``: the
same fit under node dispatch, the same model); a snapshot fit on 8 chunks
of those frames with 2 more
absorbed, against a fit on all 10; that snapshot model served by a fleet of
2 replicas to 8 closed-loop clients while a ``TrainerDaemon`` absorbs,
canaries and swaps frame chunks 10–15 in batches of 2 (a replica killed
inside the third canary window) and rolls back and parks a poisoned batch
(``trainer_timit``); the least-squares family on the chunked
frames; and the chunked fit against the in-memory one at 200,000 frames.
Then the out-of-core weighted fit: ImageNetSiftLcsFV at
the reference's widths on 5,120 synthetic 256² images drawn on the card
chunk by chunk (their descriptor stacks never whole, 3 featurize scans); the
weighted solver streamed at ImageNet's 1,281,167 training rows of a planted
class-mean model (126 scans), each held against a float64 per-class solve
(argmax agreement and the scores' deviation, each gated);
and the same draw at 100,000 rows streamed against in memory. Then the
scan lanes: the streamed BCD over the planted stream at TIMIT's
out-of-core width (d 16,384) at lanes 1, 2 and 4 on a mesh of 4 slots of
the card, each held to one lane's W (1e-5 relative) and to the analytic
model-error band, its collectives bounded and unchanged with the chunks
doubled, its seconds a scan, peak memory and lane imbalance printed; and
the normal equations, the streaming TSQR, StandardScaler and the weighted
solve at lanes 4 against 1 (``lanes_timit``, ``lanes_family``), and the
normal equations laned over the card and the host, each lane's featurizer
step run on its own device (``lanes_devices``). Then
resumable fits: the absorb phase's 8-chunk snapshot fit
as a checkpointed λ grid, killed by a fault plan (transient chunk and
staging faults, then a fatal one) and run again, bit-equal to the
uninterrupted fit and drawing only the chunks after the last save; its
absorb killed and resumed the same way, and an absorb of other data that
starts fresh; the checkpointed TSQR on the raw frames killed and resumed,
and its λ grid against independent fits; the card-drawn MNIST tasks
against their card Monte-Carlo Bayes errors (bench.py's two gates); the
warm-started BCD λ grid at 200 FFTs against cold fits. Then the
observe-and-learn loop: RandomPatchCifarKernel and MnistRandomFFT at full
width under the auto-caching optimizer with a profile store, a first fit
that samples and a second, in a fresh environment, planned from the store
with no sampling (K1's launches by shape, the auto-cache profiler's
sampled fits apart; predictions equal to the default optimizer's runs; an
8 GiB budget at 200 FFTs); the CIFAR application through the command line
with ``--trace`` and ``--profiles``, twice, its Chrome trace read back (and
a traced streamed TSQR of the raw TIMIT frames, whose scan spans carry the
scans' own counters, among the out-of-core phases); GridSweep at 200 FFTs
on 30,000 rows over three BCD λ, cold and warm-started, each member
bit-equal to its reference fit with the 12.3 GB featurizer run once a
sweep; and GridSweep
over six λ of one TIMIT cosine branch, from one Gram. After the MNIST
phases, the static checker: ``--check`` through the command line for each
of the twelve applications, every check running no CUDA kernel (a
``torch.profiler`` trace), allocating nothing, launching no K1 and sampling
nothing (``check_apps``), and a shape- and a dtype-mismatched ``and_then``
on card data refused at their nodes before any kernel (``check_rejects``);
then ``--serve-demo`` at the JAX CLI's defaults (``serve_demo``) and with
``--replicas 2`` (``serve_demo_fleet``), and ``--sweep-demo``
(``sweep_demo``). Last, the card tests of the scan, segment dispatch, the
weighted fit, the faults, the tracer, the checker, the engine, the fleet,
the AOT cache and the stall model served eagerly by a cluster worker, in
one pytest process, with ``--serve-demo --workers 2``
(``serve_demo_cluster``), ``--trainer-demo`` (``trainer_demo``) and the cold-start probe twice in fresh processes
against one cache directory (``aot_coldstart``: every bucket exported, then
every one loaded) running beside them.
Each phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero
and prints no result.

``python3 chip_smoke.py --solve-check-controls`` runs only the controls of
the float64 solve checks' deviation limits: those checks on fits made
faulty on purpose (TF32 products; a planted source that breaks lineage),
each of which must exceed its limit.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

import torch

# H100 SXM peaks (NVIDIA's data sheet): float32 outside the tensor cores,
# TF32 on the tensor cores (dense), and device memory bandwidth
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12

GAMMA = 2e-4  # the RandomPatchCifarKernel default
CHECK_SHAPES = [(700, 128, 256), (37, 5, 3), (1, 800, 100), (513, 33, 129),
                (300, 7, 40), (129, 800, 17), (4100, 96, 700),
                (50000, 800, 5000), (10000, 800, 5000), (8000, 800, 5000),
                (8000, 800, 3000)]  # (n, d, b)
# the auto-cache profiler's sampled pulls of the CIFAR kernel graphs: KRR
# fitted on 8, 16 and 24 rows, and 8-24 rows against the fitted model's
# blocks of 5000 training rows
PROFILER_SHAPES = [(8, 800, 8), (16, 800, 16), (24, 800, 24),
                   (8, 800, 5000), (16, 800, 5000), (24, 800, 5000)]
FIT_SHAPE = (50000, 800, 5000)
APPLY_SHAPE = (10000, 800, 5000)
CHUNK_SHAPE = (2500, 800, 5000)  # apply_chunked's blocks
F64_SHAPE, F64_LIMIT = (10000, 800, 5000), 1e-6  # one TF32 pass is ~1.3e-5 off
SELF_GAMMA = 0.03  # the card tests' γ, at which a drift in a row's x·x shows
# the exact KRR solve of 8000 rows builds its kernel from two column blocks
EXACT_SHAPES = ((8000, 800, 5000), (8000, 800, 3000))
SLICE_ARGS = ["RandomPatchCifarKernel", "--nTrain", "50000", "--nTest", "10000",
              "--lambda", "5.0"]
SLICE_LAUNCHES = 30  # 10 blocks × (fit, apply to train, apply to test)
# the first auto-cached fit's profiler launches K1 once at each sampled KRR
# fit and 10 blocks × 2 times at each scale's applies (the application's two
# pull graphs)
PROFILER_LAUNCHES = dict(zip(PROFILER_SHAPES, (1, 1, 1, 20, 20, 20)))
CHUNK = 2500  # apply_chunked's rows per chunk, the fused groups' own
KRR_ROWS, KRR_LAMBDA = 8000, 5.0

# MnistRandomFFT: BASELINE's configuration (bench.py's), then the JAX CLI's
# default width; 60000 / 10000 synthetic images of MNIST's shape
MNIST_ROWS = ["--blockSize", "2048", "--lambda", "1000", "--nTrain", "60000",
              "--nTest", "10000"]
MNIST_CANONICAL = ["MnistRandomFFT", "--numFFTs", "4"] + MNIST_ROWS
MNIST_FULL_FFTS = 200
MNIST_FULL = ["MnistRandomFFT", "--numFFTs", str(MNIST_FULL_FFTS)] + MNIST_ROWS
MNIST_FULL_STEPS = 50  # 102400 features / 2048 per block, one pass
# rows of the 200-FFT featurizer traced eager and captured (all 60000 until
# the trainer's phase needed the time limit's room; 8 chunks of 2500 each way)
MNIST_TRACE_ROWS = 20000

# TimitPipeline at the JAX CLI's defaults (50 cosines of 4096, γ 0.05555,
# Gaussian, λ 0, 5 epochs, 147 classes), TIMIT's frames cut to 50000 so
# that the training features are held once on one card
TIMIT_ROWS = 50000
TIMIT_FULL = ["TimitPipeline", "--nTrain", str(TIMIT_ROWS), "--nTest", "10000"]
TIMIT_FULL_STEPS = 250  # 50 blocks × 5 epochs
TIMIT_FALLBACK_LAMBDA = 100.0  # bench.py's λ for the TIMIT block shape
LS_ITERATIONS = 20  # the L-BFGS option of LeastSquaresEstimator

# the rest of the CIFAR family at CIFAR-10's count, each CLI's defaults
# otherwise; the error bounds are the JAX package's tests'
CIFAR_ROWS = ["--nTrain", "50000", "--nTest", "10000"]
CIFAR_FAMILY = {"RandomPatchCifar": (0.1, 0.3), "LinearPixels": (None, 0.5),
                "RandomCifar": (None, 0.6), "RandomPatchCifarAugmented": (None, 0.6)}

# VOCSIFTFisher at KeystoneML's widths (descDim 80, vocabSize 256, 1e6 PCA
# and GMM samples) on 256² images: VOC2007's 5011 / 4952 images cut to 2000
# / 1000 so that the two cached descriptor stacks (24.2 + 15.1 GB) fit
VOC_TRAIN, VOC_TEST, VOC_SIZE = 2000, 1000, 256
VOC_DESCRIPTORS = 6561 + 6084 + 5625 + 5329  # steps of 3, bins 4/6/8/10 on 256²
VOC_DESC_DIM, VOC_VOCAB = 80, 256
VOC_PEAK_LIMIT = 60e9

# ImageNetSiftLcsFV at the reference's widths (1000 classes, descDim 64,
# vocabSize 16, λ 6e-5, SIFT scale step 1, LCS (4, 16, 6), one weighted
# block of 4096) on 256² images: 1.28 M images cut to 5000 / 1000, the
# fewest that take the dense path (n + 3 ≥ d), 1e7 samples to 1e6
IN_TRAIN, IN_TEST, IN_SIZE, IN_CLASSES = 5000, 1000, 256, 1000
IN_SIFT, IN_LCS = 13436, 3136  # descriptors per 256² image
IN_FV = 2 * 2 * 64 * 16
IN_CHUNKS = IN_CLASSES // 8  # the dense path's chunks of 8 classes
IN_PEAK_LIMIT = 64e9
IN_TOP5_LIMIT = 95.0  # chance is 99.5 %: breakage only
# the calibrated quality row (bench.py's): 100 classes at 224², its Bayes
# error known; 1000 test images, not 128, so that top-1 is steady
IN_QUALITY = dict(num_classes=100, size=224, theta_sigma=0.09, logf_sigma=0.030, n_theta=5,
                  f_range=(0.06, 0.45))
IN_QUALITY_TRAIN, IN_QUALITY_TEST = 1000, 1000
SOLVE_CHECK_CLASSES, SOLVE_CHECK_AGREEMENT = 8, 0.95
# the largest deviation of the fitted scores from the float64 solve's,
# relative to their largest magnitude, on ImageNet's Fisher vectors; each
# limit lies between the sound fits' readings and those of the faulty fits
# that ``--solve-check-controls`` runs (PERF.md, section 2)
SOLVE_CHECK_DEV_LIMIT = 1e-3


_STARTED = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:  # the run's timeline: seconds since the script began
        obj = dict(obj, elapsed_s=round(time.perf_counter() - _STARTED, 3))
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of one call, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: the CUDA calls (runtime `cuda*`, low-level `cu*`) that launch one kernel, launch a
#: captured graph, or copy memory, as the profiler names them
RUNTIME_CALLS = {
    "host_launches": {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"},
    "graph_launches": {"cudaGraphLaunch", "cuGraphLaunch"},
    "copies": {"cudaMemcpyAsync", "cudaMemcpy", "cuMemcpyAsync"},
}


def profiled(fn, top: int = 8) -> dict:
    """One run of ``fn`` (run before, so nothing compiles) under
    ``torch.profiler``: its host seconds up to the card's last kernel, the
    seconds its kernels kept the card busy (the union of their intervals),
    the idle share of that one window, the kernel count, the CUDA runtime's
    kernel launches, graph launches and copies, and the kernels that took
    most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = Counter(e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU)
    by_name: dict = {}
    busy, end = 0.0, float("-inf")
    for k in sorted(kernels, key=lambda k: k.time_range.start):
        s, e = k.time_range.start, k.time_range.end
        count, us = by_name.get(k.name, (0, 0.0))
        by_name[k.name] = (count + 1, us + e - s)
        if e > end:
            busy += e - max(s, end)
            end = e
    busy *= 1e-6  # the profiler's clock is in microseconds
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"host_seconds": wall, "device_seconds": busy,
            "idle_share": 1.0 - busy / wall if wall > 0 else None, "kernels": len(kernels),
            **{key: sum(host[n] for n in calls) for key, calls in RUNTIME_CALLS.items()},
            "top": [{"name": k[:120], "count": c, "seconds": us * 1e-6}
                    for k, (c, us) in ranked]}


def gaussian_bound_ms(n: int, d: int, b: int) -> dict:
    """The least time for one Gaussian block on the card: each input read
    once and the output written once, against the operations at the rate of
    their type. ``bound_ms``: the kernel's 3xTF32 cross term, 3·2·n·b·d on
    the tensor cores, beside the 2·(n+b)·d norms and five FP32 operations per
    output. ``fp32_simt_bound_ms``: the same work with the cross term as one
    FP32 FFMA product (2·n·b·d), the bound no FFMA kernel can beat."""
    t_bytes = 4.0 * (n * d + b * d + n * b) / HBM_BYTES_PER_S
    t_fp32 = (2.0 * (n + b) * d + 5.0 * n * b) / FP32_FLOPS
    t_ops = max(3 * 2.0 * n * b * d / TF32_FLOPS, t_fp32)
    t_simt = t_fp32 + 2.0 * n * b * d / FP32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "fp32_simt_bound_ms": 1e3 * max(t_bytes, t_simt)}


class Probe:
    """Counts the calls of chosen methods while the main path runs, split
    by whether a ``Pipeline.fit`` is in progress ("fit") or not ("apply"):
    calls, rows of the first argument, host seconds, and the last result.
    The methods are restored on exit."""

    def __init__(self):
        self.calls, self.rows, self.seconds = Counter(), Counter(), Counter()
        self.last = {}
        self.in_fit = False
        self._undo = []

    def _phase(self) -> str:
        return "fit" if self.in_fit else "apply"

    def watch(self, cls, name: str) -> None:
        orig = cls.__dict__[name]
        probe = self

        @functools.wraps(orig)
        def wrapper(obj, *args, **kwargs):
            key = f"{cls.__name__}.{name}:{probe._phase()}"
            probe.calls[key] += 1
            if args and hasattr(args[0], "shape"):
                probe.rows[key] += int(args[0].shape[0])
            t0 = time.perf_counter()
            out = orig(obj, *args, **kwargs)
            probe.seconds[key] += time.perf_counter() - t0
            probe.last[key] = out
            return out

        self._set(cls, name, wrapper, orig)

    def watch_fit(self, pipeline_cls) -> None:
        orig = pipeline_cls.__dict__["fit"]
        probe = self

        @functools.wraps(orig)
        def fit(pipe):
            probe.in_fit = True
            try:
                return orig(pipe)
            finally:
                probe.in_fit = False

        self._set(pipeline_cls, "fit", fit, orig)

    def _set(self, cls, name, new, orig) -> None:
        setattr(cls, name, new)
        self._undo.append((cls, name, orig))

    def __enter__(self) -> "Probe":
        return self

    def __exit__(self, *exc) -> None:
        for cls, name, orig in reversed(self._undo):
            setattr(cls, name, orig)


def fused_steps(graph) -> list:
    """The step labels of each fused node of ``graph``, largest first."""
    from keystone_tpu_torch.workflow.fusion import FusedTransformerOperator

    groups = [[op.label for op, _ in graph.get_operator(n).steps] for n in graph.nodes
              if isinstance(graph.get_operator(n), FusedTransformerOperator)]
    return sorted(groups, key=len, reverse=True)


def chain(fitted) -> list:
    """The operator class names of a fitted pipeline whose graph is one
    chain, from the source to the sink; raises when it is not a chain."""
    from keystone_tpu_torch.workflow.graph import NodeId

    graph = fitted.graph
    names, gid = [], graph.get_sink_dependency(next(iter(graph.sinks)))
    while isinstance(gid, NodeId):
        names.append(type(graph.get_operator(gid)).__name__)
        (gid,) = graph.get_dependencies(gid)
    if len(names) != len(graph.nodes):
        raise AssertionError(f"the fitted graph is not one chain: {names}")
    return names[::-1]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def fresh_env():
    """Reset the port's fit-once state, drop the fused groups' shared CUDA
    graphs, the segment dispatchers, the optimize memo's plans and the
    profile store, so a phase holds no device memory of the one before it
    and learns nothing from it."""
    from keystone_tpu_torch import cost
    from keystone_tpu_torch.compile import segment
    from keystone_tpu_torch.workflow import fusion, optimizers
    from keystone_tpu_torch.workflow.env import PipelineEnv

    PipelineEnv.get_or_create().reset()
    fusion.clear_graph_cache()
    segment.reset_dispatchers()
    optimizers.clear_memo()
    cost.reset()


def phase_group(card):
    """(start, finish, the launches by phase) of a group of phases: each
    starts from a fresh fit-once state, a zero K1 count and a reset peak;
    its row gains the seconds, the peak, the K1 launches and the card, is
    printed, and fails on any K1 launch."""
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.workflow.pipeline import clock

    launches = {}

    def start(name):
        fresh_env()
        gk.gaussian_kernel_block.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return name, clock()

    def finish(name, t0, row):
        launches[name] = gk.gaussian_kernel_block.launches
        row.update(phase=name, seconds=clock() - t0,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   k1_launches=launches[name], card=card)
        emit(row)
        check(launches[name] == 0, f"{name} launched K1 {launches[name]} times")
        return row

    return start, finish, launches


def with_env(name, value, fn):
    """``fn()`` with the environment variable ``name`` set to ``value``
    (unset when None), restored after."""
    prior = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        return fn()
    finally:
        os.environ.pop(name, None)
        if prior is not None:
            os.environ[name] = prior


def cli_run(cli, bcd, args) -> dict:
    """Run an application through the command line's code; its result with
    the BCD block steps, the peak device memory and the wall seconds
    (synthetic data drawn on the host included)."""
    fresh_env()
    bcd._block_update_impl.steps = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = cli.run(args)
    torch.cuda.synchronize()
    return dict(out, wall_seconds=time.perf_counter() - t0,
                block_steps=bcd._block_update_impl.steps,
                peak_mem_bytes=torch.cuda.max_memory_allocated())


def ls_objective(A, B, W, lam: float) -> float:
    """The L-BFGS option's objective ½‖AW − B‖²/n + ½λ‖W‖², in float64."""
    A, B, W = A.double(), B.double(), W.double()
    return (0.5 * torch.sum((A @ W - B) ** 2) / A.shape[0] + 0.5 * lam * torch.sum(W * W)).item()


def smallest_gram_eigenvalue(timit, X, block: int) -> float:
    """The smallest eigenvalue of the centered Gram of TIMIT's block
    ``block`` at the CLI's defaults (each 4096-column block of the solve is
    one cosine branch), on ``X``'s device, in float64."""
    F = timit._cosine_branch(timit.TimitConfig(), block, X.device).forward(X)
    F -= F.mean(dim=0)
    return torch.linalg.eigvalsh((F.T @ F).double()).min().item()


def timit_phases(cli, dev, card) -> int:
    """TimitPipeline: a small configuration on the card against the CPU, the
    JAX CLI's defaults on 50000 frames, then one traced sweep of five block
    steps at that shape. Returns the K1 launches of the full-width run,
    which has no hand-written kernel on its path."""
    from keystone_tpu_torch.linalg import bcd
    from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import MaxClassifier
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.pipelines import timit
    from keystone_tpu_torch.workflow.pipeline import Pipeline
    from keystone_tpu_torch.workflow.rules import RuleExecutor

    # -- TimitPipeline small: the card against the CPU, the same W, b, data
    tconf = timit.TimitConfig(num_cosines=3, num_epochs=2, lam=10.0, num_classes=12,
                              cosine_features=256, gamma=0.02)
    ttrain, ttest = timit.synthetic_timit(768, 12, seed=1), timit.synthetic_timit(256, 12, seed=2)
    params = [(node.W.numpy(), node.b.numpy()) for node in
              (timit._cosine_branch(tconf, i, "cpu") for i in range(tconf.num_cosines))]
    scores, errs = {}, {}
    for name, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
        fresh_env()
        scorer, tr, te, _ = timit.run(ttrain, ttest, tconf, where, params=params)
        scores[name] = scorer.fit().apply(ttest.data.to_array().to(where)).to_array().cpu()
        errs[name] = [tr, te]
    timit_dev = (scores["cuda"] - scores["cpu"]).abs().max().item()
    preds_equal = bool(torch.equal(scores["cuda"].argmax(1), scores["cpu"].argmax(1)))
    emit({"phase": "timit_small_vs_cpu", "max_abs_dev": timit_dev, "limit": 1e-3,
          "predictions_equal": preds_equal, "errors_cuda": errs["cuda"],
          "errors_cpu": errs["cpu"]})
    check(timit_dev <= 1e-3, f"TimitPipeline on the card is {timit_dev} off the CPU run")
    check(preds_equal, "TimitPipeline's predictions on the card differ from the CPU's")

    # -- TimitPipeline at the JAX CLI's defaults, 50000 frames ------------
    num_cosines = timit.TimitConfig().num_cosines
    feature_bytes = TIMIT_ROWS * num_cosines * timit.NUM_COSINE_FEATURES * 4
    full_steps = num_cosines + 2  # the branches, the gather, the combiner
    args, refused = TIMIT_FULL, None
    gk.gaussian_kernel_block.launches = 0
    with Probe() as probe:
        probe.watch_fit(Pipeline)
        probe.watch(BlockLeastSquaresEstimator, "fit")
        probe.watch(RuleExecutor, "execute")
        try:
            out = cli_run(cli, bcd, args)
        except torch.linalg.LinAlgError as e:
            # the Cholesky of a block refused λ = 0: report that block's
            # smallest Gram eigenvalue and run at bench.py's λ instead
            block = bcd._block_update_impl.steps % num_cosines
            fresh_env()
            Xtr = timit.synthetic_timit(TIMIT_ROWS, 147, seed=1).data.to_array().to(dev)
            refused = {"error": str(e).splitlines()[0], "block": block,
                       "smallest_gram_eigenvalue": smallest_gram_eigenvalue(timit, Xtr, block)}
            del Xtr
            for counter in (probe.calls, probe.rows, probe.seconds):
                counter.clear()
            args = TIMIT_FULL + ["--lambda", str(TIMIT_FALLBACK_LAMBDA)]
            out = cli_run(cli, bcd, args)
        fit_graph = probe.last["RuleExecutor.execute:fit"][0]
        fitted = out["scorer"].and_then(MaxClassifier()).fit()
    timit_k1 = gk.gaussian_kernel_block.launches
    fits = {k: v for k, v in probe.calls.items() if k.startswith("BlockLeast")}
    emit({"phase": "timit_full_width", "args": args, "cholesky_refused_at_lambda_0": refused,
          "train_error": out["train_error"], "test_error": out["test_error"],
          "seconds": out["seconds"], "phase_seconds": out["phases"],
          "wall_seconds": out["wall_seconds"], "block_steps": out["block_steps"],
          "feature_bytes": feature_bytes, "peak_mem_gb": out["peak_mem_bytes"] / 1e9,
          "peak_over_features": out["peak_mem_bytes"] / feature_bytes,
          "estimator_fits": fits, "fitted_chain": chain(fitted),
          "fitted_fused_steps": [len(g) for g in fused_steps(fitted.graph)],
          "fit_graph_fused_steps": [len(g) for g in fused_steps(fit_graph)],
          "k1_launches": timit_k1, "card": card})
    check(out["block_steps"] == TIMIT_FULL_STEPS,
          f"{out['block_steps']} BCD block steps, want {TIMIT_FULL_STEPS}")
    check(out["test_error"] < 0.2, f"test error {out['test_error']} is not below 0.2")
    check(out["peak_mem_bytes"] < 1.5 * feature_bytes,
          f"peak memory {out['peak_mem_bytes']} B is not below 1.5 × the "
          f"{feature_bytes} B feature matrix")
    check(fits == {"BlockLeastSquaresEstimator.fit:fit": 1},
          f"the BCD estimator must fit once, in fit(): {fits}")
    check(chain(fitted) == ["FusedTransformerOperator", "BlockLinearMapper", "MaxClassifier"],
          f"fitted chain {chain(fitted)}")
    check([len(g) for g in fused_steps(fitted.graph)] == [full_steps],
          f"fitted fused groups {[len(g) for g in fused_steps(fitted.graph)]}")
    check([len(g) for g in fused_steps(fit_graph)] == [full_steps, full_steps],
          f"fit-graph fused groups {[len(g) for g in fused_steps(fit_graph)]}")
    check(timit_k1 == 0, f"TimitPipeline launched K1 {timit_k1} times; its path has no kernel")
    Xte = timit.synthetic_timit(10000, timit.TimitConfig().num_classes,
                               seed=2).data.to_array().to(dev)
    segment_apply_cost("timit", fitted, Xte, card)
    del fitted, out, fit_graph, probe, Xte

    # -- where a sweep's time goes: 5 block steps at the full-width shape,
    # traced (random data, so the Grams are well conditioned at λ 0) ---
    fresh_env()
    gen = torch.Generator(device=dev).manual_seed(11)
    width = timit.NUM_COSINE_FEATURES
    Xb = torch.randn(TIMIT_ROWS, 5 * width, device=dev, generator=gen)
    yb = torch.randn(TIMIT_ROWS, 147, device=dev, generator=gen)
    means = Xb.mean(dim=0)

    def sweep():
        return bcd.solve_blockwise_l2_scan(Xb, yb, 0.0, width, 1, means=means)

    sweep()  # cuBLAS and cuSOLVER workspaces
    emit(dict({"phase": "timit_solve_trace", "blocks": 5, "rows": TIMIT_ROWS,
               "block_width": width, "gram_tflop_per_block": 2 * TIMIT_ROWS * width ** 2 / 1e12,
               "card": card}, **profiled(sweep)))
    del Xb, yb, means
    return timit_k1


def ls_family_phase(dev, card) -> None:
    """``LeastSquaresEstimator`` in a graph on TIMIT's frames: the raw
    frames and one cosine branch, each planned by ``NodeOptimizationRule``
    and fit; then the exact solve, TSQR and L-BFGS fit directly on the raw
    frames, TSQR held against the exact solve and L-BFGS against the
    optimum and the CPU."""
    from keystone_tpu_torch import cost
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.linalg import bcd
    from keystone_tpu_torch.nodes.learning.classifiers import LeastSquaresEstimator
    from keystone_tpu_torch.nodes.learning.lbfgs import DenseLBFGSwithL2
    from keystone_tpu_torch.nodes.learning.linear import (
        BlockLeastSquaresEstimator, BlockLinearMapper, LinearMapEstimator, LinearMapper,
        TSQRLeastSquaresEstimator,
    )
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators
    from keystone_tpu_torch.pipelines import timit
    from keystone_tpu_torch.workflow.pipeline import Pipeline, clock

    # -- the least-squares family on TIMIT's frames, planned in a graph ---
    fresh_env()
    frames = timit.synthetic_timit(TIMIT_ROWS, 147, seed=1)  # the full-width run's rows
    A = frames.data.to_array().to(dev)
    Y = ClassLabelIndicators(147).forward(frames.labels.to_array().to(dev))
    solvers = (LinearMapEstimator, BlockLeastSquaresEstimator, TSQRLeastSquaresEstimator,
               DenseLBFGSwithL2)
    branch = timit._cosine_branch(timit.TimitConfig(), 0, dev)
    plans, models = {}, {}
    for name, pipe in (("raw", LeastSquaresEstimator().with_data(A, Y)),
                       ("cosine", branch.and_then(LeastSquaresEstimator(), A, Y))):
        fresh_env()
        bcd._block_update_impl.steps = 0
        with Probe() as probe:
            probe.watch_fit(Pipeline)
            for cls in solvers:
                probe.watch(cls, "fit")
            t0 = clock()
            ls_fitted = pipe.fit()
            fit_seconds = clock() - t0
        models[name] = next(op for op in ls_fitted.graph.operators.values()
                            if isinstance(op, (LinearMapper, BlockLinearMapper)))
        plans[name] = {"fits": {k: v for k, v in probe.calls.items() if k.endswith(":fit")},
                       "fit_seconds": fit_seconds,
                       "block_steps": bcd._block_update_impl.steps}
    blocks = [int(x.shape[0]) for x in getattr(models["cosine"], "xs", [])]
    choices = {d: LeastSquaresEstimator().choose_solver(cost.ShapeSignature(TIMIT_ROWS, d, 147))
               for d in (A.shape[1], timit.NUM_COSINE_FEATURES)}
    # the exact solve, TSQR and L-BFGS fit directly on the raw frames
    seconds = {}
    for name, est in (("exact", LinearMapEstimator(0.0)), ("tsqr", TSQRLeastSquaresEstimator(0.0)),
                      ("lbfgs", DenseLBFGSwithL2(num_iterations=LS_ITERATIONS))):
        t0 = clock()
        models[name] = est.fit(Dataset.of(A), Dataset.of(Y))
        seconds[name] = clock() - t0
    t0 = time.perf_counter()
    lbfgs_cpu = DenseLBFGSwithL2(num_iterations=LS_ITERATIONS).fit(Dataset.of(A.cpu()),
                                                                   Dataset.of(Y.cpu()))
    seconds["lbfgs_cpu"] = time.perf_counter() - t0
    W_exact = models["exact"].W
    tsqr_rel = (torch.linalg.norm(models["tsqr"].W - W_exact) / torch.linalg.norm(W_exact)).item()
    Ad, Yd = A.double(), Y.double()
    W_star = torch.linalg.solve(Ad.T @ Ad, Ad.T @ Yd)  # the L-BFGS objective's minimum, λ = 0
    objective = {"lbfgs_card": ls_objective(A, Y, models["lbfgs"].W, 0.0),
                 "lbfgs_cpu": ls_objective(A.cpu(), Y.cpu(), lbfgs_cpu.W, 0.0),
                 "optimum": ls_objective(A, Y, W_star, 0.0)}
    lbfgs_rel = abs(objective["lbfgs_card"] - objective["lbfgs_cpu"]) / objective["lbfgs_cpu"]
    emit({"phase": "ls_family", "n": TIMIT_ROWS, "k": 147, "lambda": 0.0, "plans": plans,
          "cosine_block_widths": blocks,
          "choices": {d: {"label": c.label, "units": {k: r["units"] for k, r in c.costs.items()}}
                      for d, c in choices.items()},
          "fit_seconds": seconds, "tsqr_rel_dev_from_exact": tsqr_rel, "tsqr_limit": 1e-3,
          "lbfgs_iterations": LS_ITERATIONS, "objective": objective,
          "lbfgs_rel_dev_from_cpu": lbfgs_rel, "lbfgs_limit": 0.01, "card": card})
    check(choices[440].label == "LinearMapEstimator"
          and choices[timit.NUM_COSINE_FEATURES].label == "BlockLeastSquaresEstimator",
          f"chooser picked {choices[440].label} and {choices[timit.NUM_COSINE_FEATURES].label}")
    check(plans["raw"]["fits"] == {"LinearMapEstimator.fit:fit": 1},
          f"the raw frames must fit the exact solve once: {plans['raw']['fits']}")
    check(plans["cosine"]["fits"] == {"BlockLeastSquaresEstimator.fit:fit": 1},
          f"the cosine branch must fit the block solver once: {plans['cosine']['fits']}")
    check(blocks == [1000] * 4 + [96] and plans["cosine"]["block_steps"] == 15,
          f"block solver (1000, 3) over 4096 columns: widths {blocks}, "
          f"{plans['cosine']['block_steps']} steps")
    check(tsqr_rel < 1e-3, f"TSQR's W is {tsqr_rel} off the exact solve's")
    check(objective["lbfgs_card"] >= objective["optimum"] * (1 - 1e-9),
          f"L-BFGS below the optimum: {objective}")
    check(lbfgs_rel <= 0.01, f"L-BFGS on the card is {lbfgs_rel} off the CPU's objective")


def cifar_family_phases(cli, dev, card) -> int:
    """RandomPatchCifar, LinearPixels, RandomCifar and
    RandomPatchCifarAugmented through the command line's code at 50000 /
    10000 synthetic images, then Augmented small on the card against the
    CPU. Returns the K1 launches of the four runs (none of them reaches K1)."""
    import numpy as np

    from keystone_tpu_torch.linalg import bcd
    from keystone_tpu_torch.loaders.cifar import synthetic_cifar
    from keystone_tpu_torch.nodes.images.core import CenterCornerPatcher
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.pipelines import cifar_extras

    gk.gaussian_kernel_block.launches = 0
    for app, (train_limit, test_limit) in CIFAR_FAMILY.items():
        args = [app] + CIFAR_ROWS
        out = cli_run(cli, bcd, args)
        emit({"phase": "cifar_family", "app": app, "args": args,
              "train_error": out.get("train_error"), "test_error": out["test_error"],
              "train_error_limit": train_limit, "test_error_limit": test_limit,
              "seconds": out["seconds"], "phase_seconds": out["phases"],
              "wall_seconds": out["wall_seconds"], "block_steps": out["block_steps"],
              "peak_mem_gb": out["peak_mem_bytes"] / 1e9, "card": card})
        check(out["test_error"] < test_limit,
              f"{app}: test error {out['test_error']} is not below {test_limit}")
        if train_limit is not None:
            check(out["train_error"] < train_limit,
                  f"{app}: train error {out['train_error']} is not below {train_limit}")
        del out
    launches = gk.gaussian_kernel_block.launches
    check(launches == 0, f"the CIFAR family launched K1 {launches} times; its paths have none")

    # -- Augmented small: the card against the CPU, one seed -------------
    conf = cifar_extras.AugmentedCifarConfig(
        num_filters=24, lam=50.0, whitener_size=3000, num_random_images_augment=2,
        pool_size=8, pool_stride=7)
    train, test = synthetic_cifar(192, seed=5), synthetic_cifar(48, seed=6)
    crops, scores, errs = {}, {}, {}
    for name, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
        fresh_env()
        X = train.data.to_array().to(where)
        crops[name] = cifar_extras.augment_train(X, np.asarray(train.labels.to_array()),
                                                 conf)[0].cpu()
        scorer, ev, _ = cifar_extras.run_random_patch_cifar_augmented(train, test, conf, where)
        test_aug = CenterCornerPatcher(24, 24, True).forward(test.data.to_array().to(where))
        scores[name] = scorer.fit().apply(test_aug).to_array().cpu()
        errs[name] = ev.total_error
    dev_max = (scores["cuda"] - scores["cpu"]).abs().max().item()
    crops_equal = bool(torch.equal(crops["cuda"], crops["cpu"]))
    preds_equal = bool(torch.equal(scores["cuda"].argmax(1), scores["cpu"].argmax(1)))
    emit({"phase": "cifar_small_vs_cpu", "app": "RandomPatchCifarAugmented",
          "crops_bit_equal": crops_equal, "predictions_equal": preds_equal,
          "max_abs_dev": dev_max, "limit": 1e-3, "test_error_cuda": errs["cuda"],
          "test_error_cpu": errs["cpu"]})
    check(crops_equal, "the augmented crops and flips on the card differ from the CPU's")
    check(preds_equal, "the augmented predictions on the card differ from the CPU's")
    check(dev_max <= 1e-3, f"the augmented scores on the card are {dev_max} off the CPU's")
    return launches


def _voc_files(fitted, folder) -> dict:
    """The fitted PCA matrix and GMM of a VOC pipeline written as the load
    path reads them: the CSV file names by configuration field."""
    import numpy as np

    from keystone_tpu_torch.nodes.images.fisher_vector import FisherVector
    from keystone_tpu_torch.nodes.learning.pca import BatchPCATransformer

    ops = list(fitted.graph.operators.values())
    pca = next(op for op in ops if isinstance(op, BatchPCATransformer)).pca_mat
    gmm = next(op for op in ops if isinstance(op, FisherVector)).gmm
    files = {}
    for key, arr in (("pca_file", pca.T), ("gmm_mean_file", gmm.means),
                     ("gmm_var_file", gmm.variances), ("gmm_wts_file", gmm.weights)):
        files[key] = f"{folder}/{key}.csv"
        np.savetxt(files[key], arr.cpu().double().numpy(), delimiter=",", fmt="%.9e")
    return files


def voc_phases(cli, dev, card) -> int:
    """VOCSIFTFisher small on the card against the CPU through the load
    path, at the command line's defaults, and at full width. Returns the K1
    launches of the three (none reaches K1)."""
    import tempfile

    import numpy as np

    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.linalg import bcd
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.pipelines import voc_sift_fisher as voc
    from keystone_tpu_torch.workflow.expressions import DatasetExpression
    from keystone_tpu_torch.workflow.fusion import FusedTransformerOperator

    gk.gaussian_kernel_block.launches = 0
    # -- small: PCA and GMM fitted once on the CPU, carried to the card
    # through the load path; the same files on the CPU
    tr_i, tr_l = voc.synthetic_voc(48, seed=1)
    te_i, te_l = voc.synthetic_voc(16, seed=2)
    small = dict(desc_dim=16, vocab_size=8, lam=10.0)
    fresh_env()
    fit_details = {}
    voc.run(tr_i, tr_l, te_i, te_l, voc.SIFTFisherConfig(
        num_pca_samples=20_000, num_gmm_samples=20_000, **small), torch.device("cpu"),
        fit_details)
    aps, fvs = {}, {}
    with tempfile.TemporaryDirectory() as folder:
        files = _voc_files(fit_details["fitted"], folder)
        for name, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
            fresh_env()
            details = {}
            aps[name], _ = voc.run(tr_i, tr_l, te_i, te_l, voc.SIFTFisherConfig(**small, **files),
                                   where, details)
            fused = next(op for op in details["fitted"].graph.operators.values()
                         if isinstance(op, FusedTransformerOperator))
            X = torch.from_numpy(te_i).to(where)
            fvs[name] = fused.batch_transform([DatasetExpression.now(Dataset(X))]).to_array().cpu()
    fv_rel = ((fvs["cuda"] - fvs["cpu"]).abs().max() / fvs["cpu"].abs().max()).item()
    ap_dev = float(np.abs(aps["cuda"] - aps["cpu"]).max())
    emit({"phase": "voc_small_vs_cpu", "train": 48, "test": 16, "size": 64, **small,
          "fv_shape": list(fvs["cpu"].shape), "fv_max_rel_dev": fv_rel, "fv_limit": 1e-3,
          "ap_max_abs_dev": ap_dev, "ap_limit": 1e-3, "map_cuda": float(aps["cuda"].mean()),
          "map_cpu": float(aps["cpu"].mean())})
    check(fv_rel <= 1e-3, f"VOC Fisher vectors on the card are {fv_rel} (relative) off the CPU's")
    check(ap_dev <= 1e-3, f"VOC APs on the card are {ap_dev} off the CPU's")
    del fit_details, fvs

    # -- the command line's defaults (256 / 64 synthetic 64-px images,
    # descDim 24, vocabSize 16)
    out = cli_run(cli, bcd, ["VOCSIFTFisher"])
    emit({"phase": "voc_cli", "args": ["VOCSIFTFisher"], "map": out["map"],
          "seconds": out["seconds"], "phase_seconds": out["phases"],
          "descriptors": out["details"]["descriptors"], "fv_width": out["details"]["fv_width"],
          "em_iterations": out["details"]["em_iterations"],
          "pca_choice": out["details"]["pca_choice"], "block_steps": out["block_steps"],
          "peak_mem_gb": out["peak_mem_bytes"] / 1e9, "card": card})
    check(np.isfinite(out["aps"]).all() and out["aps"].shape == (voc.NUM_CLASSES,),
          f"VOCSIFTFisher CLI APs {out['aps']}")
    del out

    # -- full width: KeystoneML's widths on 2000 / 1000 images of 256²
    t0 = time.perf_counter()
    tr_i, tr_l = voc.synthetic_voc(VOC_TRAIN, size=VOC_SIZE, seed=1)
    te_i, te_l = voc.synthetic_voc(VOC_TEST, size=VOC_SIZE, seed=2)
    draw_seconds = time.perf_counter() - t0
    conf = voc.SIFTFisherConfig(num_pca_samples=1_000_000, num_gmm_samples=1_000_000,
                                vocab_size=VOC_VOCAB, desc_dim=VOC_DESC_DIM, lam=0.5)
    fresh_env()
    bcd._block_update_impl.steps = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    details = {}
    aps, seconds = voc.run(tr_i, tr_l, te_i, te_l, conf, dev, details)
    peak = torch.cuda.max_memory_allocated()
    steps = bcd._block_update_impl.steps
    stacks = VOC_TRAIN * VOC_DESCRIPTORS * 4 * (128 + VOC_DESC_DIM)
    fv_width = 2 * VOC_DESC_DIM * VOC_VOCAB
    emit({"phase": "voc_full_width", "train": VOC_TRAIN, "test": VOC_TEST, "size": VOC_SIZE,
          "desc_dim": VOC_DESC_DIM, "vocab_size": VOC_VOCAB, "lambda": 0.5,
          "map": float(aps.mean()), "map_limit": 0.3, "seconds": seconds,
          "phase_seconds": details["phases"], "host_draw_seconds": draw_seconds,
          "descriptors": details["descriptors"], "fv_width": details["fv_width"],
          "block_steps": steps, "em_iterations": details["em_iterations"],
          "pca_choice": details["pca_choice"], "peak_mem_gb": peak / 1e9,
          "peak_gb_by_phase_end": {k: v / 1e9 for k, v in details["peak_bytes"].items()},
          "cached_stacks_gb": stacks / 1e9, "peak_limit_gb": VOC_PEAK_LIMIT / 1e9, "card": card})
    check(details["descriptors"] == VOC_DESCRIPTORS,
          f"{details['descriptors']} descriptors per image, want {VOC_DESCRIPTORS}")
    check(details["fv_width"] == fv_width, f"FV width {details['fv_width']}, want {fv_width}")
    check(steps == fv_width // 4096, f"{steps} block steps, want {fv_width // 4096}")
    check(peak < VOC_PEAK_LIMIT, f"peak memory {peak} B is not below {VOC_PEAK_LIMIT} B")
    check(aps.mean() > 0.3, f"mAP {aps.mean()} is not above 0.3")
    launches = gk.gaussian_kernel_block.launches
    check(launches == 0, f"VOCSIFTFisher launched K1 {launches} times; its path has none")
    return launches


def _top5_rows(scores):
    """Rows whose 5th and 6th largest scores are more than 1e-4 of the
    largest magnitude apart: there the top-5 set is not decided by rounding."""
    s = torch.sort(scores, dim=1, descending=True).values
    return (s[:, 4] - s[:, 5]) > 1e-4 * scores.abs().max()


def weighted_solve_check(fitted, X_train, labels, X_test, scores, conf, label, card) -> None:
    """The exact per-class weighted ridge in float64 on the card for the
    first classes (:func:`weighted_f64_scores`), from the fit's own training
    Fisher vectors (with one block and one iteration the block update is that
    system), against the fitted scores of the test images: argmax agreement
    over those classes and the largest deviation of the scores relative to
    their largest magnitude, each gated."""
    row = fv_solve_deviation(fitted, X_train, labels, X_test, scores, conf)
    agreement, deviation = row["argmax_agreement"], row["max_rel_dev"]
    emit({"phase": "imagenet_solve_check", "run": label, "classes": SOLVE_CHECK_CLASSES,
          **row, "agreement_limit": SOLVE_CHECK_AGREEMENT,
          "deviation_limit": SOLVE_CHECK_DEV_LIMIT, "card": card})
    check(agreement >= SOLVE_CHECK_AGREEMENT,
          f"{label}: argmax agreement {agreement} with the float64 per-class solve")
    check(deviation <= SOLVE_CHECK_DEV_LIMIT,
          f"{label}: scores {deviation} (relative) off the float64 per-class solve")


def fv_solve_deviation(fitted, X_train, labels, X_test, scores, conf) -> dict:
    """The row of :func:`weighted_solve_check`, ungated."""
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as imagenet

    featurizer = imagenet.featurizer_of(fitted)
    F_train = featurizer.apply(X_train).to_array()
    F_test = featurizer.apply(X_test).to_array()
    y = torch.as_tensor(labels, device=F_train.device).long()
    n = F_train.shape[0]
    t0 = time.perf_counter()
    exact = weighted_f64_scores([(F_train, y)], n, conf.mixture_weight, conf.lam, F_test,
                                SOLVE_CHECK_CLASSES)
    torch.cuda.synchronize()
    agreement, deviation = f64_agreement(scores, exact)
    return {"train": n, "test": F_test.shape[0], "fv_width": F_train.shape[1],
            "argmax_agreement": agreement, "max_rel_dev": deviation,
            "f64_seconds": time.perf_counter() - t0}


def f64_agreement(scores, exact):
    """(argmax agreement, largest deviation relative to the largest
    magnitude) of the fitted scores of the first classes against the
    float64 solve's."""
    got = scores[:, :SOLVE_CHECK_CLASSES].double()
    return ((got.argmax(1) == exact.argmax(1)).double().mean().item(),
            ((got - exact).abs().max() / exact.abs().max()).item())


def imagenet_phases(cli, dev, card) -> dict:
    """ImageNetSiftLcsFV: DAISY, HOG and LCS on the card against the CPU;
    small through the load path on the card against the CPU; the command
    line's defaults; the calibrated quality row (dual path) and the
    reference's widths (dense path), each with a float64 check of its
    weighted solve. Returns the K1 launches of each path (none reaches K1)."""
    import tempfile

    import numpy as np

    from keystone_tpu_torch.linalg import bcd
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.images.core import GrayScaler, PixelScaler
    from keystone_tpu_torch.nodes.images.daisy import DaisyExtractor
    from keystone_tpu_torch.nodes.images.sift import SIFTExtractor
    from keystone_tpu_torch.nodes.learning.gmm import GaussianMixtureModel
    from keystone_tpu_torch.nodes.stats import SignedHellingerMapper
    from keystone_tpu_torch.nodes.images.hog import HogExtractor
    from keystone_tpu_torch.nodes.images.lcs import LCSExtractor
    from keystone_tpu_torch.nodes.learning.lbfgs import LocalLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as imagenet
    from keystone_tpu_torch.utils import timing

    cpu = torch.device("cpu")
    launches = {}

    # -- the descriptors on 16 seeded 256² images, the card against the CPU
    gk.gaussian_kernel_block.launches = 0
    imgs = torch.from_numpy(imagenet.synthetic_imagenet(16, 16, size=256, seed=3)[0]).float()
    rows = []
    for node, X in ((DaisyExtractor(), imgs[..., :1] / 255.0), (HogExtractor(8), imgs),
                    (LCSExtractor(4, 16, 6), imgs)):
        want = node.forward(X)
        Xd = X.to(dev)
        got = node.forward(Xd)
        err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        rows.append({"node": type(node).__name__, "shape": list(want.shape),
                     "max_rel_dev": err, "ms": time_ms(lambda: node.forward(Xd), reps=3)})
        check(err <= 1e-4, f"{type(node).__name__} on the card is {err} (relative) off the CPU")
    emit({"phase": "image_descriptors", "images": 16, "size": 256, "limit": 1e-4,
          "nodes": rows, "card": card})
    launches["image_descriptors"] = gk.gaussian_kernel_block.launches

    # -- small: each branch's PCA and GMM fitted once on the CPU, loaded
    # through the CLI's CSV files on the card and on the CPU
    gk.gaussian_kernel_block.launches = 0
    tr_i, tr_l = imagenet.synthetic_imagenet(96, 16, size=48, seed=1)
    te_i, te_l = imagenet.synthetic_imagenet(48, 16, size=48, seed=2)
    small = dict(desc_dim=16, vocab_size=4, num_classes=16, lam=1e-4)
    fresh_env()
    fit_details = {}
    imagenet.run(tr_i, tr_l, te_i, te_l, imagenet.ImageNetSiftLcsFVConfig(
        num_pca_samples=20_000, num_gmm_samples=20_000, **small), cpu, fit_details)
    out = {}
    X = torch.from_numpy(te_i)
    sift = PixelScaler().and_then(GrayScaler()).and_then(SIFTExtractor(scale_step=1)).fit()
    with tempfile.TemporaryDirectory() as folder:
        files = imagenet.write_codebooks(fit_details["codebooks"], folder)
        for name, where in (("cuda", dev), ("cpu", cpu)):
            fresh_env()
            details = {}
            _, err, _ = imagenet.run(tr_i, tr_l, te_i, te_l,
                                     imagenet.ImageNetSiftLcsFVConfig(**small, **files), where,
                                     details)
            out[name] = dict(err=err, scores=details["scores"].cpu(), top5=details["top5"].cpu(),
                             codebooks=details["codebooks"], sift=sift.apply(
                                 X.to(where)).to_array().cpu(),
                             fv=imagenet.featurizer_of(details["fitted"]).apply(
                                 X.to(where)).to_array().cpu())
    # SIFT quantizes: a last-bit difference before the quantization is a
    # step of one after it, and moves that descriptor's Fisher vector. So
    # the SIFT half is held on the CPU's descriptors, the steps counted
    steps = (out["cuda"]["sift"] - out["cpu"]["sift"]).abs()
    step_share = (steps > 0).double().mean().item()
    descs = SignedHellingerMapper().forward(out["cpu"]["sift"])
    book = out["cpu"]["codebooks"]["sift"]
    tails = {name: imagenet.codebook_tail(book["pca_mat"].to(where), GaussianMixtureModel(
        book["gmm"].means.to(where), book["gmm"].variances.to(where),
        book["gmm"].weights.to(where))).fit().apply(descs.to(where)).to_array().cpu()
        for name, where in (("cuda", dev), ("cpu", cpu))}

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    half = out["cpu"]["fv"].shape[1] // 2
    sift_fv_rel = rel(tails["cuda"], tails["cpu"])
    lcs_fv_rel = rel(out["cuda"]["fv"][:, half:], out["cpu"]["fv"][:, half:])
    fv_rel = rel(out["cuda"]["fv"], out["cpu"]["fv"])
    score_rel = rel(out["cuda"]["scores"], out["cpu"]["scores"])
    sep = _top5_rows(out["cpu"]["scores"])
    top5_equal = bool(torch.equal(out["cuda"]["top5"][sep], out["cpu"]["top5"][sep]))
    emit({"phase": "imagenet_small_vs_cpu", "train": 96, "test": 48, "size": 48, **small,
          "fv_shape": list(out["cpu"]["fv"].shape), "sift_max_step": steps.max().item(),
          "sift_step_share": step_share, "sift_step_share_limit": 1e-3,
          "sift_fv_max_rel_dev_same_descriptors": sift_fv_rel, "lcs_fv_max_rel_dev": lcs_fv_rel,
          "fv_limit": 1e-3, "fv_max_rel_dev_whole": fv_rel,
          "images_with_a_sift_step": int((steps.flatten(1) > 0).any(dim=1).sum()),
          "score_max_rel_dev": score_rel, "score_limit": 1e-3,
          "top5_rows_compared": int(sep.sum()), "top5_equal": top5_equal,
          "top5_error_cuda": out["cuda"]["err"], "top5_error_cpu": out["cpu"]["err"],
          "card": card})
    check(steps.max().item() <= 1 and step_share <= 1e-3,
          f"SIFT on the card: steps up to {steps.max().item()}, {step_share} of entries")
    check(sift_fv_rel <= 1e-3, f"SIFT-branch Fisher vectors on the card are {sift_fv_rel} off")
    check(lcs_fv_rel <= 1e-3, f"LCS-branch Fisher vectors on the card are {lcs_fv_rel} off")
    check(score_rel <= 1e-3, f"ImageNet scores on the card are {score_rel} (relative) off")
    check(top5_equal, "ImageNet top-5 on the card differs from the CPU's")
    launches["imagenet_small_vs_cpu"] = gk.gaussian_kernel_block.launches
    del out, fit_details

    # -- the command line's defaults: 256 / 64 synthetic 64-px images, 16
    # classes, descDim 64, vocabSize 16 (the dual path)
    gk.gaussian_kernel_block.launches = 0
    res = cli_run(cli, bcd, ["ImageNetSiftLcsFV"])
    details = res["details"]
    scores = details["scores"]
    emit({"phase": "imagenet_cli", "args": ["ImageNetSiftLcsFV"],
          "top5_error": res["top5_error"], "seconds": res["seconds"],
          "phase_seconds": res["phases"], "descriptors": details["descriptors"],
          "fv_width": details["fv_width"], "solver_path": details["solver_path"],
          "class_chunks": details["class_chunks"], "block_steps": details["block_steps"],
          "pca_choice": details["pca_choice"], "em_iterations": details["em_iterations"],
          "peak_mem_gb": res["peak_mem_bytes"] / 1e9, "card": card})
    check(bool(torch.isfinite(scores).all()) and tuple(details["top5"].shape) == (64, 5),
          f"ImageNet CLI: scores finite {bool(torch.isfinite(scores).all())}, top-5 shape "
          f"{tuple(details['top5'].shape)}")
    check(details["solver_path"] == "dual", f"ImageNet CLI took the {details['solver_path']} path")
    launches["imagenet_cli"] = gk.gaussian_kernel_block.launches
    del res, details, scores

    # -- the calibrated quality row: 100 classes at 224², dual path
    gk.gaussian_kernel_block.launches = 0
    t0 = time.perf_counter()
    tr_i, tr_l, bayes = imagenet.synthetic_gradient_imagenet(IN_QUALITY_TRAIN, seed=1,
                                                             **IN_QUALITY)
    te_i, te_l, _ = imagenet.synthetic_gradient_imagenet(IN_QUALITY_TEST, seed=9, **IN_QUALITY)
    draw_seconds = time.perf_counter() - t0
    conf = imagenet.ImageNetSiftLcsFVConfig(desc_dim=64, vocab_size=16,
                                            num_pca_samples=200_000, num_gmm_samples=200_000,
                                            num_classes=IN_QUALITY["num_classes"], lam=1e-4)
    fresh_env()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    details = {}
    timing.reset()
    timing.enable()
    try:
        fitted, top5_err, seconds = imagenet.run(tr_i, tr_l, te_i, te_l, conf, dev, details)
    finally:
        timing.enable(False)
    solver_phases = timing.snapshot("wls.")
    top1 = 100.0 * float((details["top5"][:, 0].cpu().numpy() != te_l).mean())
    Xtr = torch.from_numpy(tr_i).to(dev).reshape(len(tr_i), -1).float() / 255.0
    Xte = torch.from_numpy(te_i).to(dev).reshape(len(te_i), -1).float() / 255.0
    Y = ClassLabelIndicators(conf.num_classes).forward(torch.from_numpy(tr_l).to(dev))
    raw = LocalLeastSquaresEstimator(lam=10.0).fit(Dataset.of(Xtr), Dataset.of(Y))
    raw_err = 100.0 * float((raw.forward(Xte).argmax(1).cpu().numpy() != te_l).mean())
    del raw, Xtr, Xte, Y
    emit({"phase": "imagenet_quality", "train": IN_QUALITY_TRAIN, "test": IN_QUALITY_TEST,
          **{k: v for k, v in IN_QUALITY.items() if k != "f_range"},
          "f_range": list(IN_QUALITY["f_range"]), "desc_dim": 64, "vocab_size": 16,
          "samples": 200_000, "lambda": 1e-4, "top1_error": top1, "bayes_top1_error": bayes,
          "top1_band": [0.5 * bayes, 3.0 * bayes], "top5_error": top5_err,
          "raw_pixel_top1_error": raw_err, "seconds": seconds,
          "phase_seconds": details["phases"], "solver_phases": solver_phases,
          "host_draw_seconds": draw_seconds,
          "descriptors": details["descriptors"], "fv_width": details["fv_width"],
          "solver_path": details["solver_path"], "class_chunks": details["class_chunks"],
          "block_steps": details["block_steps"], "pca_choice": details["pca_choice"],
          "em_iterations": details["em_iterations"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})
    check(0.5 * bayes <= top1 <= 3.0 * bayes,
          f"quality: top-1 {top1} % is outside [0.5, 3] × the Bayes error {bayes} %")
    check(raw_err > 50.0 and raw_err > 2 * top1,
          f"quality: raw pixels err {raw_err} % against top-1 {top1} %")
    check(details["solver_path"] == "dual", f"quality took the {details['solver_path']} path")
    launches["imagenet_quality"] = gk.gaussian_kernel_block.launches
    weighted_solve_check(fitted, torch.from_numpy(tr_i).to(dev), tr_l,
                         torch.from_numpy(te_i).to(dev), details["scores"], conf, "quality", card)
    del fitted, details, tr_i, te_i

    # -- the reference's widths on 5000 / 1000 images of 256² (dense path)
    gk.gaussian_kernel_block.launches = 0
    t0 = time.perf_counter()
    tr_i, tr_l = imagenet.synthetic_imagenet(IN_TRAIN, IN_CLASSES, size=IN_SIZE, seed=1)
    te_i, te_l = imagenet.synthetic_imagenet(IN_TEST, IN_CLASSES, size=IN_SIZE, seed=2)
    draw_seconds = time.perf_counter() - t0
    conf = imagenet.ImageNetSiftLcsFVConfig(num_pca_samples=1_000_000,
                                            num_gmm_samples=1_000_000, num_classes=IN_CLASSES)
    fresh_env()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    details = {}
    timing.reset()
    timing.enable()  # each phase of the weighted solve synchronizes at its end
    try:
        fitted, top5_err, seconds = imagenet.run(tr_i, tr_l, te_i, te_l, conf, dev, details)
    finally:
        timing.enable(False)
    solver_phases = timing.snapshot("wls.")
    peak = torch.cuda.max_memory_allocated()
    stacks = IN_TRAIN * 4 * (128 * IN_SIFT + 96 * IN_LCS)
    # one LU of each class's 4096² system, (2/3)·d³ operations, at the FP32 peak
    lu_bound = IN_CLASSES * (2.0 / 3.0) * IN_FV ** 3 / FP32_FLOPS
    emit({"phase": "imagenet_full_width", "train": IN_TRAIN, "test": IN_TEST, "size": IN_SIZE,
          "classes": IN_CLASSES, "desc_dim": conf.desc_dim, "vocab_size": conf.vocab_size,
          "lambda": conf.lam, "mixture_weight": conf.mixture_weight, "samples": 1_000_000,
          "top5_error": top5_err, "top5_limit": IN_TOP5_LIMIT, "seconds": seconds,
          "fit_seconds": details["fit_seconds"], "phase_seconds": details["phases"],
          "solver_phases": solver_phases, "lu_bound_seconds": lu_bound,
          "host_draw_seconds": draw_seconds, "descriptors": details["descriptors"],
          "fv_width": details["fv_width"], "solver_path": details["solver_path"],
          "class_chunks": details["class_chunks"], "block_steps": details["block_steps"],
          "pca_choice": details["pca_choice"], "em_iterations": details["em_iterations"],
          "peak_mem_gb": peak / 1e9,
          "peak_gb_by_phase_end": {k: v / 1e9 for k, v in details["peak_bytes"].items()},
          "cached_stacks_gb": stacks / 1e9, "peak_limit_gb": IN_PEAK_LIMIT / 1e9,
          "card": card})
    check(details["descriptors"] == {"sift": IN_SIFT, "lcs": IN_LCS},
          f"descriptors per image {details['descriptors']}, want {IN_SIFT} and {IN_LCS}")
    check(details["fv_width"] == IN_FV, f"FV width {details['fv_width']}, want {IN_FV}")
    check(details["solver_path"] == "dense", f"full width took the {details['solver_path']} path")
    check(details["class_chunks"] == IN_CHUNKS,
          f"{details['class_chunks']} class chunks, want {IN_CHUNKS}")
    check(details["block_steps"] == 1, f"{details['block_steps']} weighted block steps, want 1")
    check(peak < IN_PEAK_LIMIT, f"peak memory {peak} B is not below {IN_PEAK_LIMIT} B")
    check(top5_err < IN_TOP5_LIMIT, f"top-5 error {top5_err} % is not below {IN_TOP5_LIMIT} %")
    launches["imagenet_full_width"] = gk.gaussian_kernel_block.launches
    check(all(v == 0 for v in launches.values()),
          f"ImageNetSiftLcsFV launched K1 {launches}; its paths have none")
    weighted_solve_check(fitted, torch.from_numpy(tr_i).to(dev), tr_l,
                         torch.from_numpy(te_i).to(dev), details["scores"], conf, "full_width",
                         card)
    return launches


# the text applications (NewsgroupsPipeline, AmazonReviewsPipeline) at the
# JAX CLIs' defaults: 20 Newsgroups' "bydate" split sizes, and the JAX
# package's Amazon L-BFGS row's n for the reviews (real corpora are not in
# the repository)
NEWSGROUPS_FULL = ["NewsgroupsPipeline", "--nTrain", "11314", "--nTest", "7532"]
AMAZON_FULL = ["AmazonReviewsPipeline", "--nTrain", "262144", "--nTest", "65536"]
# bench.py's _bench_sparse_lbfgs: the reference's Amazon L-BFGS shape, planted
# labels with the measured flip rate as the quality floor
AMAZON_LBFGS = dict(n=262144, d=16384, nnz=85, seed=17, iterations=50, lam=1e-7, tol=1e-5)
AMAZON_LBFGS_SMALL = dict(AMAZON_LBFGS, n=4096, d=1024)
# the JAX chooser's pick at that shape on one machine (tests/test_torch_sparse.py
# holds the port's choice against it on the CPU)
AMAZON_LBFGS_CHOICE = "SparseLBFGSwithL2"


def planted_sparse_problem(dev, n, d, nnz, seed, **_):
    """bench.py's planted problem, the same numpy draws: rows of ``nnz``
    random features with normal values, labels sign(X·w* + noise), the
    noise 0.65 × the margins' spread (it flips 18.4 % of the labels at the
    Amazon shape). Returns (X on ``dev``, the (n, 1) labels on ``dev``, the
    flip rate)."""
    import numpy as np

    from keystone_tpu_torch.data.sparse import SparseRows

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, nnz), dtype=np.int64)
    val = rng.standard_normal((n, nnz)).astype(np.float32)
    X = SparseRows(torch.from_numpy(idx), torch.from_numpy(val), d).to(dev)
    w_star = (rng.standard_normal(d) / np.sqrt(nnz)).astype(np.float32)
    margin = X.matmul(torch.from_numpy(w_star[:, None]).to(dev))[:, 0].cpu().numpy()
    noise = 0.65 * np.std(margin) * rng.standard_normal(n)
    y = np.sign(margin + noise).astype(np.float32)
    y[y == 0] = 1.0
    flip_rate = float((np.sign(margin) != y).mean())
    return X, torch.from_numpy(y[:, None]).to(dev), flip_rate


def text_phases(cli, dev, card) -> dict:
    """The text applications: small on the card against the CPU (and the
    sparse L-BFGS at (4096, 1024, 85)); NewsgroupsPipeline and
    AmazonReviewsPipeline at the CLIs' defaults on full-size synthetic
    corpora, with the seconds split between the host's text work and the
    card; the sparse L-BFGS at the reference's Amazon shape with both
    strategies; StupidBackoffPipeline's defaults. Checks that the native
    text frontend was built and ran on each text path. Returns the K1
    launches of each path (none reaches K1)."""
    from keystone_tpu_torch import native
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.learning import lbfgs
    from keystone_tpu_torch.nodes.learning.classifiers import (
        LeastSquaresEstimator, LogisticRegressionEstimator, LogisticRegressionModel,
        NaiveBayesEstimator, NaiveBayesModel,
    )
    from keystone_tpu_torch.nodes.nlp.packed_features import (
        PackedTextFeatures, PackedTextVectorizer,
    )
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.pipelines import amazon_reviews as am
    from keystone_tpu_torch.pipelines import newsgroups as ng
    from keystone_tpu_torch.workflow.pipeline import Pipeline, clock

    cpu = torch.device("cpu")
    launches = {}
    t0 = time.perf_counter()
    native.require_lib()  # a failed g++ build raises here, not a quiet fallback
    emit({"phase": "build", "library": "native text frontend", "source": str(native.SOURCE),
          "seconds": time.perf_counter() - t0})

    def native_runs(before) -> dict:
        return {k: native.CALLS[k] - before.get(k, 0) for k in native.CALLS}

    def model(fitted, cls):
        return next(op for op in fitted.graph.operators.values() if isinstance(op, cls))

    def rel(a, b) -> float:
        return ((a.cpu() - b.cpu()).abs().max() / b.cpu().abs().max()).item()

    # -- small on the card against the port on the CPU --------------------
    gk.gaussian_kernel_block.launches = 0
    before = dict(native.CALLS)
    small = {}
    for app, mod, conf, train, test, cls in (
            ("NewsgroupsPipeline", ng, ng.NewsgroupsConfig(common_features=2000, num_classes=6),
             ng.synthetic_newsgroups(256, 6, seed=1), ng.synthetic_newsgroups(96, 6, seed=2),
             NaiveBayesModel),
            ("AmazonReviewsPipeline", am, am.AmazonReviewsConfig(common_features=2000,
                                                                 num_iters=30),
             am.synthetic_reviews(256, seed=1), am.synthetic_reviews(96, seed=2),
             LogisticRegressionModel)):
        runs = {}
        for name, where in (("cuda", dev), ("cpu", cpu)):
            fresh_env()
            predictor, _, _ = mod.run(train, test, conf, where)
            fitted = predictor.fit()
            runs[name] = (fitted.apply(test.data).to_array().cpu(), model(fitted, cls))
        (p_dev, m_dev), (p_cpu, m_cpu) = runs["cuda"], runs["cpu"]
        row = {"predictions_equal": bool(torch.equal(p_dev, p_cpu))}
        if cls is NaiveBayesModel:
            row["pi_max_abs_dev"] = (m_dev.pi.cpu() - m_cpu.pi).abs().max().item()
            row["theta_max_abs_dev"] = (m_dev.theta.cpu() - m_cpu.theta).abs().max().item()
            check(max(row["pi_max_abs_dev"], row["theta_max_abs_dev"]) <= 1e-6,
                  f"{app}: naive Bayes on the card is off the CPU's: {row}")
        else:
            row["W_rel_dev"] = rel(m_dev.W, m_cpu.W)
            check(row["W_rel_dev"] <= 1e-4, f"{app}: W on the card is off the CPU's: {row}")
        check(row["predictions_equal"], f"{app}: predictions on the card differ from the CPU's")
        small[app] = row
    X, B, flip = planted_sparse_problem(cpu, **AMAZON_LBFGS_SMALL)
    for label, budget in (("gram", 2e9), ("gather_scatter", 0)):
        W = {}
        for name, where in (("cuda", dev), ("cpu", cpu)):
            est = lbfgs.SparseLBFGSwithL2(convergence_tol=AMAZON_LBFGS["tol"],
                                          num_iterations=AMAZON_LBFGS["iterations"],
                                          reg_param=AMAZON_LBFGS["lam"],
                                          gram_budget_bytes=budget)
            W[name] = est.fit(Dataset(X.to(where)), Dataset(B.to(where))).W
        small[f"sparse_lbfgs_{label}"] = {"W_rel_dev": rel(W["cuda"], W["cpu"])}
        check(small[f"sparse_lbfgs_{label}"]["W_rel_dev"] <= 1e-4,
              f"sparse L-BFGS ({label}) on the card is off the CPU's: {small}")
    launches["text_small_vs_cpu"] = gk.gaussian_kernel_block.launches
    emit({"phase": "text_small_vs_cpu", "checks": small, "limits": {
        "naive_bayes_abs": 1e-6, "W_rel": 1e-4}, "native_runs": native_runs(before),
        "card": card})

    # -- the two applications at full size, through the command line -------
    for phase, args in (("newsgroups_full_width", NEWSGROUPS_FULL),
                        ("amazon_full_width", AMAZON_FULL)):
        fresh_env()
        gk.gaussian_kernel_block.launches = 0
        before = dict(native.CALLS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # left by earlier phases, inside the peak
        with Probe() as probe:
            probe.watch_fit(Pipeline)
            probe.watch(PackedTextFeatures, "fit")
            probe.watch(PackedTextVectorizer, "apply_batch")
            for cls in (NaiveBayesEstimator, LogisticRegressionEstimator):
                probe.watch(cls, "fit")
            out = cli.run(args)
        peak = torch.cuda.max_memory_allocated()
        launches[phase] = gk.gaussian_kernel_block.launches
        runs = native_runs(before)
        fitted = out["predictor"].fit()  # fit-once: the run's fits
        vec = model(fitted, PackedTextVectorizer)
        train_rows = probe.last["PackedTextVectorizer.apply_batch:fit"].payload
        ph = out["phases"]
        vectorize = sum(v for k, v in probe.seconds.items()
                        if k.startswith("PackedTextVectorizer.apply_batch"))
        solver = "NaiveBayesEstimator" if "NaiveBayesEstimator" in ph else \
            "LogisticRegressionEstimator"
        fits = {k: v for k, v in probe.calls.items() if ".fit:" in k}
        # the host's text work: the corpus draw, the feature fit (frontend,
        # grams, selection) and both vectorizations (their rows' copy to the
        # card included); the rest of the run is the card's and the graph's
        host = ph["draw"] + ph["PackedTextFeatures"] + vectorize
        row = {"phase": phase, "args": args, "seconds": out["seconds"], "phase_seconds": ph,
               "split": {"draw": ph["draw"], "featurize": ph["PackedTextFeatures"] + ph["featurize"],
                         "fit": ph[solver], "apply": ph["apply"], "evaluate": ph["evaluate"]},
               "host_text_seconds": host,
               "card_and_graph_seconds": out["seconds"] + ph["draw"] - host,
               "vectorize_seconds": vectorize, "selected_features": vec.num_features,
               "train_rows": len(train_rows), "row_capacity": train_rows.row_capacity,
               "train_nnz": train_rows.nnz, "rows_device": str(train_rows.device),
               "estimator_fits": fits, "native_runs": runs, "peak_mem_gb": peak / 1e9,
               "held_at_start_gb": held / 1e9, "card": card}
        if phase == "newsgroups_full_width":
            row["test_error"] = out["test_error"]
            check(out["test_error"] < 0.15, f"Newsgroups test error {out['test_error']}")
        else:
            row["accuracy"] = out["accuracy"]
            check(out["accuracy"] > 0.9, f"Amazon accuracy {out['accuracy']}")
        emit(row)
        check(train_rows.device.type == "cuda", "the text features are not on the card")
        check(fits == {"PackedTextFeatures.fit:fit": 1, f"{solver}.fit:fit": 1},
              f"{phase}: each estimator must fit once: {fits}")
        check(runs.get("text_frontend_batch", 0) >= 2 and runs.get("packed_grams_unique", 0) >= 2,
              f"{phase}: the native text frontend did not carry the corpora: {runs}")
        del out, fitted, vec, train_rows, probe

    # -- the sparse L-BFGS at the reference's Amazon shape ------------------
    fresh_env()
    gk.gaussian_kernel_block.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    X, B, flip = planted_sparse_problem(dev, **AMAZON_LBFGS)
    torch.cuda.synchronize()
    draw = time.perf_counter() - t0
    n, d, lam = AMAZON_LBFGS["n"], AMAZON_LBFGS["d"], AMAZON_LBFGS["lam"]
    t0 = time.perf_counter()
    G, c = lbfgs.streamed_gram(X, B)
    torch.cuda.synchronize()
    gram_seconds = time.perf_counter() - t0
    gram_bound = 2.0 * n * d * d / FP32_FLOPS
    W_probe = torch.randn(d, 1, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    e = 0.5 * torch.sum(B * B)
    eval_ms = {
        "gram": time_ms(lambda: lbfgs.gram_value_and_grad(W_probe, G, c, e, n, lam)),
        "gather_scatter": time_ms(lambda: lbfgs.sparse_ls_value_and_grad(W_probe, X, B, lam)),
    }
    del G, c
    fits = {}
    for label, budget, fn in (("gram", 2e9, "gram_value_and_grad"),
                              ("gather_scatter", 0, "sparse_ls_value_and_grad")):
        counted = [0]
        orig = getattr(lbfgs, fn)

        def counting(*a, _orig=orig):
            counted[0] += 1
            return _orig(*a)

        setattr(lbfgs, fn, counting)
        try:
            est = lbfgs.SparseLBFGSwithL2(convergence_tol=AMAZON_LBFGS["tol"],
                                          num_iterations=AMAZON_LBFGS["iterations"],
                                          reg_param=lam, gram_budget_bytes=budget)
            t0 = clock()
            W = est.fit(Dataset(X), Dataset(B)).W
            secs = clock() - t0
        finally:
            setattr(lbfgs, fn, orig)
        err = (torch.sign(X.matmul(W)) != B).float().mean().item()
        fits[label] = {"fit_seconds": secs, "evaluations": counted[0],
                       "seconds_per_evaluation": secs / max(counted[0], 1),
                       "evaluation_ms": eval_ms[label], "train_error": err, "W": W}
        check(err < 1.5 * flip + 0.005, f"sparse L-BFGS ({label}) train error {err}, "
              f"flip rate {flip}")
    W_gram, W_gather = fits["gram"].pop("W"), fits["gather_scatter"].pop("W")
    excess = ((W_gather - W_gram).abs() - (2e-3 + 2e-2 * W_gram.abs())).max().item()
    choice = LeastSquaresEstimator(lam=lam, num_machines=1)
    shape = choice.shape_from_samples([Dataset(X).take(24), Dataset(B).take(24)], n)
    chosen = choice.choose_solver(shape)
    peak = torch.cuda.max_memory_allocated()
    launches["amazon_lbfgs_sparse"] = gk.gaussian_kernel_block.launches
    emit({"phase": "amazon_lbfgs_sparse", "n": n, "d": d, "nnz_per_row": AMAZON_LBFGS["nnz"],
          "iterations": AMAZON_LBFGS["iterations"], "lambda": lam, "draw_seconds": draw,
          "gram_seconds": gram_seconds, "gram_fp32_bound_seconds": gram_bound,
          "gram_share_of_bound": gram_bound / gram_seconds,
          "gram_block_rows": lbfgs.gram_row_chunk(d, X.row_capacity),
          "strategies": fits, "planted_flip_rate": flip,
          "train_error_limit": 1.5 * flip + 0.005,
          "strategy_agreement_excess": excess, "agreement_tolerance": {"rtol": 2e-2, "atol": 2e-3},
          "chooser": {"label": chosen.label, "sparsity": shape.sparsity,
                      "units": {k: r["units"] for k, r in chosen.costs.items()}},
          "peak_mem_gb": peak / 1e9, "held_at_start_gb": held / 1e9, "card": card})
    check(excess <= 0, f"the two strategies' W disagree beyond rtol 2e-2 / atol 2e-3 ({excess})")
    check(chosen.label == AMAZON_LBFGS_CHOICE,
          f"the cost model picked {chosen.label}, the JAX chooser {AMAZON_LBFGS_CHOICE}")
    del X, B, W_gram, W_gather, W_probe

    # -- StupidBackoffPipeline's defaults -----------------------------------
    gk.gaussian_kernel_block.launches = 0
    out = cli.run(["StupidBackoffPipeline"])
    lm = out["model"]
    bigram = next(g for g in lm.scores if len(g) == 2)
    launches["stupid_backoff_cli"] = gk.gaussian_kernel_block.launches
    emit({"phase": "stupid_backoff_cli", "seconds": out["seconds"], "tokens": lm.num_tokens,
          "vocabulary": len(lm.unigram_counts), "ngrams": len(lm.scores),
          "seen_bigram_score": lm.score(bigram)})
    check(lm.num_tokens > 0, "the language model saw no token")
    check(all(0.0 <= v <= 1.0 for v in lm.scores.values()), "a score outside [0, 1]")
    check(lm.score(bigram) > 0, f"the seen bigram {bigram} scores 0")

    check(not any(launches.values()), f"the text paths launched K1: {launches}")
    return launches


# The out-of-core fit (slice 10): TimitPipeline over all of TIMIT's frames
# (bench.py's count, 34 chunks of 65,536), the JAX TimitConfig's defaults
# but 4 cosine branches (d = 16,384, the solver comparison's TIMIT width:
# at the CLI's 50 each of the 21 scans would refeaturize 2.2 M × 204,800),
# the 2,228,224 × 16,384 design matrix (146 GB) never whole
OOC_CHUNK, OOC_CHUNKS = 65536, 34
OOC_ROWS = OOC_CHUNK * OOC_CHUNKS
OOC_COSINES, OOC_TEST = 4, 100_000
OOC_STEPS = 5 * OOC_COSINES  # epochs × blocks of 4096
OOC_PEAK_LIMIT = 32e9
OOC_MEMORY_ROWS = 200_000  # the in-memory comparison: 13.1 GB of features
# bench.py's planted streaming rows (timit_block_stream_full_n, timit_exact_d8192)
STREAM_SIGMA, STREAM_LAMBDA = 0.5, 1e-2
BLOCK_STREAM = dict(d=16384, block=4096, k=147, rows=OOC_CHUNK, chunks=OOC_CHUNKS)
EXACT_STREAM = dict(d=8192, k=147, rows=131072, chunks=17)
# bench.py's scan-overlap row: 16 host chunks of 4096 × 256, the last 1500 rows
OVERLAP_CHUNKS, OVERLAP_ROWS, OVERLAP_D, OVERLAP_TAIL = 16, 4096, 256, 1500
# bench.py's step is a 25 µs Gram queued on the card, which a serial scan
# already overlaps with host production; the gated consumer waits for each
# chunk's result (4096 cosine features and their Gram, ~2.5 ms) before it
# takes the next, which only a producer thread can overlap
OVERLAP_WIDTH, OVERLAP_TURNS = 4096, 6
RAGGED_ROWS = [512, 480, 500, 300, 450, 200]
# absorb (slice 11): a snapshot fit of the out-of-core featurizer on 8
# chunks of the frames, 2 more absorbed; λ as TIMIT's fallback (16 chunks
# until the cluster phases needed the time limit's room; 8 keep a save in
# the resumed run below, and every transient of its plan fires in each run)
ABSORB_CHUNKS, ABSORB_APPENDED, ABSORB_LAMBDA = 8, 2, TIMIT_FALLBACK_LAMBDA
# resumable fits (slice 12): the absorb phase's snapshot fit as a
# checkpointed λ grid (λ 100 is absorb's), saved every 2 chunks, killed at
# chunk 5's pull (after the saves at 2 and 4) under transient chunk and
# staging faults, then run again with the transients only (a save at 6);
# the fatal clause counts the pulls the transient clause does not take, so
# its index is the chunk's
RESUME_LAMBDAS, RESUME_EVERY, RESUME_KILL_CHUNK = (10.0, 100.0, 1000.0), 2, 5
RESUME_TRANSIENTS = "scan.chunk=transient@2,5;scan.stage=transient@3"
RESUME_RETRIES = "4"
# the checkpointed TSQR on the raw frames: saved every 4 chunks, killed at
# chunk 20's pull of the fold (after the means scan's 34 pulls and its end)
TSQR_EVERY, TSQR_KILL_CHUNK, TSQR_LAMBDAS = 4, 20, (1e3, 1e4, 1e5)
TSQR_GRID_LIMIT = 1e-5  # members against independent fits, relative to the largest entry
# the continual-learning trainer (slice 20): absorb's 8-chunk snapshot model
# served by 2 co-resident replicas to 8 closed-loop clients while a
# TrainerDaemon tails frame chunks 10–15 (after absorb's 8 and 9) in
# batches of 2, then a poisoned batch (frames 1e4, labels −1e4); bench.py's
# trainer sequence (:3643-3780): two promotions, a third with replica 1
# killed inside its open canary window, a rollback and a park
TRAINER_FIRST, TRAINER_CHUNKS, TRAINER_BATCH = 10, 6, 2
TRAINER_REPLICAS, TRAINER_BUCKETS, TRAINER_CLIENTS = 2, (8, 32), 8
TRAINER_SERVED = 512  # rows served and held against the eager apply after each promotion
TRAINER_PROBE = 64  # rows served one at a time, clients paused, before and after the rollback
TRAINER_POISON = (1e4, -1e4)  # the poisoned batch's frames and labels
# the canary's bounds: above a healthy 2-chunk absorb's move of the scores,
# far below the poisoned batch's (both measured and printed)
TRAINER_CANARY_ATOL, TRAINER_CANARY_RTOL = 1.0, 0.0
TRAINER_CANARY_BATCHES, TRAINER_KILL_WINDOW = 8, 64  # mirrored batches; the kill's window
TRAINER_PLAN = "replica.batch#1=kill@0"
TRAINER_QUIET_S = 1.0  # traffic with no refresh, before the first batch and after each
TRAINER_WAIT_S = 300.0
TRAINER_W_LIMIT = 1e-6  # the first promotion against a direct absorb, relative to the largest
TRAINER_SERVE_LIMIT = 1e-5


class FaultLog:
    """Records, while entered, each ``FitCheckpoint.save`` (chunk cursor,
    seconds, bytes written) and each transient retry by site (the
    ``RetryBudget.consume`` calls that granted one). Restored on exit."""

    def __enter__(self) -> "FaultLog":
        from keystone_tpu_torch.faults import FitCheckpoint, RetryBudget

        self.saves, self.retries = [], Counter()
        self._undo = [(FitCheckpoint, "save", FitCheckpoint.save),
                      (RetryBudget, "consume", RetryBudget.consume)]
        save, consume, log = FitCheckpoint.save, RetryBudget.consume, self

        def timed_save(ck, state, chunk, rows):
            t0 = time.perf_counter()
            save(ck, state, chunk, rows)
            log.saves.append({"chunk": chunk, "seconds": time.perf_counter() - t0,
                              "bytes": os.path.getsize(ck.path)})

        def counted_consume(budget, exc, site):
            delay = consume(budget, exc, site)
            if delay is not None:
                log.retries[site] += 1
            return delay

        FitCheckpoint.save, RetryBudget.consume = timed_save, counted_consume
        return self

    def __exit__(self, *exc) -> None:
        for cls, name, orig in self._undo:
            setattr(cls, name, orig)


def transient_fired(plan) -> dict:
    """The transient faults a plan injected, by site: what a scan retried."""
    return {site: n for site, n in ((site, sum(s.fired for s in specs if s.kind == "transient"))
                                    for site, specs in plan._by_site.items()) if n}


def host_peak_gb() -> float:
    """The process's peak resident host memory so far."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


class ScanLog:
    """Records the counters of every pipelined scan made while it is
    entered (the ScanPipeline constructor is wrapped and restored)."""

    def __enter__(self) -> list:
        from keystone_tpu_torch.data.pipeline_scan import ScanPipeline

        self._cls, self._orig = ScanPipeline, ScanPipeline.__init__
        self.scans = []
        orig, scans = self._orig, self.scans

        @functools.wraps(orig)
        def init(obj, *args, **kwargs):
            orig(obj, *args, **kwargs)
            scans.append(obj.stats)

        ScanPipeline.__init__ = init
        return self.scans

    def __exit__(self, *exc) -> None:
        self._cls.__init__ = self._orig


def stall_totals(scans) -> dict:
    return {k: sum(getattr(s, k) for s in scans)
            for k in ("producer_seconds", "producer_stall_seconds", "consumer_stall_seconds",
                      "staged_bytes")}


def planted_stream(dev, chunk_rows: int, d: int, k: int, seed: int):
    """bench.py's planted streaming problem on the card: w* ~ N(0, 1/d),
    chunk i's rows drawn from a generator seeded by (seed, i), labels
    A·w* + σ·ε. Returns (w*, the chunk function)."""
    w_star = torch.randn(d, k, device=dev,
                         generator=torch.Generator(dev).manual_seed(seed)) / d ** 0.5

    def feat(i):
        return torch.randn(chunk_rows, d, device=dev,
                           generator=torch.Generator(dev).manual_seed(seed * 1_000_003 + i))

    def labels(i, A):
        eps = torch.randn(chunk_rows, k, device=dev,
                          generator=torch.Generator(dev).manual_seed(seed * 1_000_033 + i))
        return A @ w_star + STREAM_SIGMA * eps

    return w_star, feat, labels


def _quantiles(latencies) -> dict:
    import numpy as np

    if not latencies:
        return {"count": 0}
    a = np.asarray(latencies)
    return {"count": int(a.size), "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99))}


def trainer_timit(fitted, frames, labels, Xt_host, num_classes: int, chunk_rows: int,
                  first: int = TRAINER_FIRST, chunks: int = TRAINER_CHUNKS,
                  wait_s: float = TRAINER_WAIT_S, quiet_s: float = TRAINER_QUIET_S,
                  kill_window: int = TRAINER_KILL_WINDOW) -> dict:
    """``trainer_timit``: a ``ServingFleet`` of ``fitted`` (a snapshot model
    of 440-wide frames) under closed-loop traffic while a ``TrainerDaemon``
    tails frame chunks ``first`` … ``first + chunks − 1`` of ``frames`` (a
    tensor) with ``labels`` (class indices) as host numpy, in batches of
    2, then a poisoned batch. Raises on a failed gate; returns the phase's
    row. Needs no card: run on the CPU at a small width it checks the
    same gates."""
    import numpy as np

    from keystone_tpu_torch import faults
    from keystone_tpu_torch.data.chunked import ChunkedDataset
    from keystone_tpu_torch.nodes.learning.linear import LinearMapper
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators
    from keystone_tpu_torch.serving import CanaryMismatch, ServingFleet
    from keystone_tpu_torch.trainer import ChunkLog, TrainerDaemon
    from keystone_tpu_torch.utils import timing
    from keystone_tpu_torch.workflow.pipeline import clock

    dev = frames.device
    host = [(frames[(first + i) * chunk_rows:(first + i + 1) * chunk_rows].cpu().numpy(),
             ClassLabelIndicators(num_classes).forward(torch.from_numpy(
                 labels[(first + i) * chunk_rows:(first + i + 1) * chunk_rows])).numpy())
            for i in range(chunks)]
    poison = (np.full_like(host[0][0], TRAINER_POISON[0]),
              np.full_like(host[0][1], TRAINER_POISON[1]))
    served_rows = Xt_host[:TRAINER_SERVED]
    probe_rows = Xt_host[TRAINER_SERVED:TRAINER_SERVED + TRAINER_PROBE]

    def mapper(f):
        return next(op for op in f.graph.operators.values() if isinstance(op, LinearMapper))

    def eager(f, rows):
        return f.apply(torch.from_numpy(rows).to(dev)).to_array().cpu().numpy()

    fleet = ServingFleet(fitted, replicas=TRAINER_REPLICAS, buckets=TRAINER_BUCKETS,
                         datum_shape=(Xt_host.shape[1],), max_wait_ms=2.0, max_queue=4096)
    swaps, mismatches = [], []
    swap = fleet.swap

    def recorded_swap(*args, **kwargs):
        try:
            report = swap(*args, **kwargs)
        except CanaryMismatch as e:
            mismatches.append(e.report)
            raise
        swaps.append(report)
        return report

    fleet.swap = recorded_swap
    log = ChunkLog("timit-frames")
    lock, running, stop = threading.Lock(), threading.Event(), threading.Event()
    inflight, done, failures = [0], [], []

    def client(tid):
        i = tid
        while not stop.is_set():
            with lock:
                go = running.is_set()
                if go:
                    inflight[0] += 1
            if not go:
                time.sleep(0.01)
                continue
            t1 = time.perf_counter()
            try:
                fleet.predict(Xt_host[i % len(Xt_host)], timeout=60.0)
                done.append((time.perf_counter(), time.perf_counter() - t1))
            except Exception as e:  # every failure fails the phase
                failures.append(repr(e)[:300])
            finally:
                with lock:
                    inflight[0] -= 1
            i += TRAINER_CLIENTS

    def wait_for(cond, what):
        t1 = time.perf_counter()
        while not cond():
            check(time.perf_counter() - t1 < wait_s, f"trainer_timit: no {what} in {wait_s} s")
            check(not daemon.device_fault, f"the trainer stopped on {daemon.device_fault!r}")
            time.sleep(0.02)

    def paused_probe():
        # one row a batch, the clients idle: every probe replays bucket 8
        with lock:
            running.clear()
        wait_for(lambda: inflight[0] == 0, "idle clients")
        out = np.stack([np.asarray(fleet.predict(r, timeout=60.0)) for r in probe_rows])
        running.set()
        return out

    def served(f):
        futures = [fleet.submit(r, timeout=120.0) for r in served_rows]
        got = np.stack([np.asarray(fu.result(timeout=180.0)) for fu in futures])
        want = eager(f, served_rows)
        return {"max_abs_dev": float(np.max(np.abs(got - want))),
                "argmax_equal": bool(np.array_equal(got.argmax(1), want.argmax(1)))}

    windows, quiet, promotions = [], [], []
    timing.reset()
    before_scores = eager(fitted, served_rows)
    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(TRAINER_CLIENTS)]
    with fleet:
        for t in threads:
            t.start()
        daemon = TrainerDaemon(
            fleet, log, poll_interval_s=0.05, refit_interval_s=0.1,
            min_refit_chunks=TRAINER_BATCH, canary_fraction=0.25,
            canary_batches=TRAINER_CANARY_BATCHES, canary_timeout_s=60.0,
            canary_atol=TRAINER_CANARY_ATOL, canary_rtol=TRAINER_CANARY_RTOL,
            max_batch_retries=0, max_restarts=2)
        try:
            with daemon:
                running.set()
                for b in range(chunks // TRAINER_BATCH):
                    t1 = clock()
                    time.sleep(quiet_s)
                    quiet.append((t1, clock()))
                    kill = b == 2
                    if kill:
                        daemon.canary_batches = kill_window
                    t1 = clock()
                    for X, Y in host[b * TRAINER_BATCH:(b + 1) * TRAINER_BATCH]:
                        log.append(X, Y)
                    if kill:
                        # the canary window is open once the shadow hook is in
                        wait_for(lambda: any(r._shadow is not None for r in fleet.replicas),
                                 "canary window")
                        faults.install(faults.parse_plan(TRAINER_PLAN))
                        wait_for(lambda: fleet.metrics.count("restarts") >= 1, "restart")
                    wait_for(lambda want=b + 1: fleet.metrics.count("refits") >= want,
                             f"promotion {b + 1}")
                    windows.append((t1, clock()))
                    if kill:
                        faults.clear()
                        daemon.canary_batches = TRAINER_CANARY_BATCHES
                    promotions.append(dict(served(daemon.fitted),
                                           refresh_seconds=windows[-1][1] - t1,
                                           version=fleet.model_version))
                    if b == 0:
                        first_promoted = daemon.fitted
                t1 = clock()
                time.sleep(quiet_s)
                quiet.append((t1, clock()))
                probe_before = paused_probe()
                t1 = clock()
                for _ in range(TRAINER_BATCH):
                    log.append(*poison)
                wait_for(lambda: bool(daemon.parked_batches), "parked batch")
                windows.append((t1, clock()))
                probe_after = paused_probe()
                parked = daemon.parked_batches
        finally:
            faults.clear()
            stop.set()
            for t in threads:
                t.join(timeout=120)
        snap = fleet.metrics.snapshot()
        report = fleet.version_report()
    phases = timing.snapshot("trainer.")
    # the direct absorb of the first batch's chunks, which the log does not count
    batch = host[:TRAINER_BATCH]
    direct = fitted.absorb(
        ChunkedDataset.from_chunk_fn(lambda i: batch[i][0], len(batch),
                                     len(batch) * chunk_rows, label="direct"),
        np.concatenate([Y for _, Y in batch]))
    w_dev = {}
    for p in ("W", "b"):
        got, want = getattr(mapper(first_promoted), p), getattr(mapper(direct), p)
        w_dev[p] = ((got - want).abs().max() / want.abs().max()).item()
    healthy_move = float(np.max(np.abs(eager(first_promoted, served_rows) - before_scores)))
    poisoned_move = max((d.get("max_abs_diff", float("inf")) for m in mismatches
                         for d in m.get("mismatch_details", [])), default=None)

    def rate(spans):
        seconds = sum(b - a for a, b in spans)
        lat = [s for t, s in done if any(a <= t <= b for a, b in spans)]
        return dict(_quantiles(lat), seconds=seconds,
                    requests_per_second=len(lat) / seconds if seconds else None)

    c = snap["counters"]
    n_batches = chunks // TRAINER_BATCH
    row = {
        "chunks": [first, first + chunks], "chunk_rows": chunk_rows,
        "d": int(mapper(fitted).W.shape[0]), "classes": num_classes,
        "replicas": TRAINER_REPLICAS, "buckets": TRAINER_BUCKETS, "clients": TRAINER_CLIENTS,
        "counters": {k: c.get(k, 0) for k in (
            "refits", "rollbacks", "parked_batches", "absorbed_chunks", "absorbed_rows",
            "restarts", "submitted", "completed", "failed", "canary_pass", "canary_fail",
            "monitor_failures", "absorb_failures", "trainer_restarts", "swaps")},
        "parked": parked, "productions": dict(log.production_counts),
        "version_report": report, "client_failures": failures[:5],
        "promotions": promotions,
        "refresh_seconds": [p["refresh_seconds"] for p in promotions],
        "rollback_seconds": windows[-1][1] - windows[-1][0],
        "phase_seconds": phases,
        "absorb_seconds_per_chunk": phases["trainer.absorb"]["seconds"]
        / (TRAINER_BATCH * phases["trainer.absorb"]["calls"]),
        "canary_seconds_per_swap": phases["trainer.canary"]["seconds"]
        / phases["trainer.canary"]["calls"],
        "monitor_seconds_per_chunk": phases["trainer.monitor"]["seconds"]
        / phases["trainer.monitor"]["calls"],
        "swaps": swaps, "rollback_evidence": mismatches,
        "first_promotion_vs_direct_absorb": w_dev, "w_limit": TRAINER_W_LIMIT,
        "healthy_move": healthy_move, "poisoned_move": poisoned_move,
        "canary_atol": TRAINER_CANARY_ATOL, "canary_rtol": TRAINER_CANARY_RTOL,
        "probe_bit_equal": bool(np.array_equal(probe_before, probe_after)),
        "traffic_during_refreshes": rate(windows), "traffic_between": rate(quiet),
        "final_state_rows": int(mapper(daemon.fitted).solver_state.n),
    }
    check(c.get("refits", 0) == n_batches, f"trainer_timit: refits {c.get('refits')}")
    check(c.get("rollbacks", 0) >= 1, "trainer_timit: the poisoned batch did not roll back")
    check(parked == [(chunks, chunks + TRAINER_BATCH)], f"trainer_timit: parked {parked}")
    check(all(v <= TRAINER_W_LIMIT for v in w_dev.values()),
          f"the first promotion is off a direct absorb of its chunks: {w_dev}")
    check(log.production_counts == {i: 1 for i in range(chunks + TRAINER_BATCH)},
          f"appended chunks produced {log.production_counts}; each once")
    check(not failures and c.get("failed", 0) == 0, f"failed requests: {failures[:5]}")
    check(c.get("completed") == c.get("submitted"),
          f"completed {c.get('completed')} of {c.get('submitted')}")
    check(c.get("restarts", 0) >= 1, "the killed replica was not restarted")
    check(not report["skew"] and report["version"] == 1 + n_batches,
          f"versions after recovery: {report}")
    check(all(p["max_abs_dev"] <= TRAINER_SERVE_LIMIT and p["argmax_equal"]
              for p in promotions), f"served rows after the promotions: {promotions}")
    check(row["probe_bit_equal"], "the rollback changed the served answers")
    check(healthy_move < TRAINER_CANARY_ATOL and poisoned_move is not None
          and poisoned_move > TRAINER_CANARY_ATOL,
          f"canary bound {TRAINER_CANARY_ATOL} not between the healthy move {healthy_move} "
          f"and the poisoned one {poisoned_move}")
    return row


def out_of_core_phases(dev, card) -> dict:
    """The out-of-core fit: the scan runtime's overlap and row buckets;
    bench.py's streamed block and exact solves at TIMIT's full row count;
    TimitPipeline fitted over all 2,228,224 frames with the design matrix
    never whole; the least-squares family on chunked input; the chunked fit
    against the in-memory one at 200,000 frames. Returns the K1 launches of
    each path (none reaches K1)."""
    import numpy as np

    from keystone_tpu_torch.data.chunked import ChunkedDataset
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.data.pipeline_scan import bucket_ladder, scan_pipeline
    from keystone_tpu_torch import cost
    from keystone_tpu_torch.linalg import bcd, normal_equations
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.nodes.learning.classifiers import LeastSquaresEstimator
    from keystone_tpu_torch.nodes.learning.linear import (
        BlockLeastSquaresEstimator, BlockLinearMapper, LinearMapEstimator, LinearMapper,
        TSQRLeastSquaresEstimator,
    )
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.compile import segment
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier
    from keystone_tpu_torch.pipelines import timit
    from keystone_tpu_torch.utils import timing
    from keystone_tpu_torch.workflow import fusion
    from keystone_tpu_torch.workflow.env import PipelineEnv
    from keystone_tpu_torch.workflow.pipeline import Pipeline, clock
    from keystone_tpu_torch.workflow.rules import RuleExecutor
    from keystone_tpu_torch.workflow.transformer import FunctionNode

    start, finish, launches = phase_group(card)

    # -- scan_overlap: host production against the card, serial and pipelined
    name, t0 = start("scan_overlap")

    def host_chunk(i):
        rows = OVERLAP_TAIL if i == OVERLAP_CHUNKS - 1 else OVERLAP_ROWS
        x = np.random.default_rng(1000 + i).standard_normal((rows, OVERLAP_D)).astype(np.float32)
        return np.tanh(x)

    gen = torch.Generator(dev).manual_seed(13)
    W_rf = torch.randn(OVERLAP_D, OVERLAP_WIDTH, device=dev, generator=gen) * 0.1
    b_rf = torch.rand(OVERLAP_WIDTH, device=dev, generator=gen) * 6.283185307179586

    def bench_step(acc, c):
        # bench.py's step: queued on the card, the host goes on at once
        acc.addmm_(c.T, c)

    def waiting_step(acc, c):
        # the chunk featurized to 4096 cosines and its Gram accumulated,
        # and the result read before the next chunk is taken
        F = torch.addmm(b_rf, c, W_rf).cos_()
        acc.addmm_(F.T, F)
        acc.diagonal().sum().item()

    def consume(step, width):
        def run(it):
            acc = torch.zeros(width, width, device=dev)
            for c in it:
                step(acc, c)
            torch.cuda.synchronize()
            return acc
        return run

    def src():
        return (host_chunk(i) for i in range(OVERLAP_CHUNKS))

    overlap_rows = {}
    for label, step, width in (("bench_step", bench_step, OVERLAP_D),
                               ("waiting_step", waiting_step, OVERLAP_WIDTH)):
        run = consume(step, width)
        staged = [torch.from_numpy(host_chunk(i)).to(dev) for i in range(OVERLAP_CHUNKS)]
        run(iter(staged))  # cuBLAS warm
        t1 = time.perf_counter()
        run(iter(staged))
        t_dev = time.perf_counter() - t1
        del staged
        t1 = time.perf_counter()
        for i in range(OVERLAP_CHUNKS):
            host_chunk(i)
        t_host = time.perf_counter() - t1
        times, accs = {"0": [], "1": []}, {}
        for _ in range(OVERLAP_TURNS):  # in turns: serial, pipelined
            for mode in ("0", "1"):
                t1 = time.perf_counter()
                accs[mode] = with_env("KEYSTONE_SCAN_PIPELINE", mode,
                                      lambda: run(scan_pipeline(src(), label="overlap",
                                                                device=dev)))
                times[mode].append(time.perf_counter() - t1)
        t_serial, t_pipe = min(times["0"]), min(times["1"])
        overlap_rows[label] = {
            "seconds_host_production_only": t_host, "seconds_device_consume_only": t_dev,
            "seconds_serial_scan": times["0"], "seconds_pipelined_scan": times["1"],
            "speedup_vs_serial": t_serial / t_pipe,
            "overlap_fraction": max(0.0, min(1.0, (t_serial - t_pipe)
                                             / max(min(t_host, t_dev), 1e-9))),
            "bit_equal": bool(torch.equal(accs["0"], accs["1"]))}
    # a two-step chain over ragged card chunks: CUDA graphs per bucket
    rng = np.random.default_rng(5)
    parts = [torch.from_numpy(rng.standard_normal((r, 16)).astype(np.float32)).to(dev)
             for r in RAGGED_ROWS]
    outs, captures = {}, {}
    for buckets in ("0", "1"):
        fresh_env()
        ds = ChunkedDataset.from_chunk_fn(lambda i: parts[i], len(parts), sum(RAGGED_ROWS))
        pipe = FunctionNode(batch_fn=lambda x: x * 2.0).and_then(
            FunctionNode(batch_fn=lambda x: x + 1.0))
        outs[buckets] = with_env("KEYSTONE_CHUNK_BUCKETS", buckets,
                                 lambda: pipe.apply(ds).get().to_array())
        captures[buckets] = sum(len(c) for c in fusion._FUSED_GRAPHS.values())
    ladder = bucket_ladder(RAGGED_ROWS[0])
    ragged_dev = ((outs["1"] - outs["0"]).abs() / outs["0"].abs().clamp_min(1e-30)).max().item()
    finish(name, t0, {
        "chunks": OVERLAP_CHUNKS, "rows": OVERLAP_ROWS, "tail_rows": OVERLAP_TAIL,
        "d": OVERLAP_D, "features": OVERLAP_WIDTH, "turns": OVERLAP_TURNS,
        "consumers": overlap_rows, "ragged_rows": RAGGED_ROWS, "bucket_ladder": list(ladder),
        "graph_captures": captures, "ragged_max_rel_dev": ragged_dev})
    waiting = overlap_rows["waiting_step"]
    check(waiting["overlap_fraction"] > 0,
          f"no overlap: serial {waiting['seconds_serial_scan']} s, "
          f"pipelined {waiting['seconds_pipelined_scan']} s")
    check(all(r["bit_equal"] for r in overlap_rows.values()),
          "the pipelined scan's result differs from the serial scan's")
    check(captures["1"] <= len(ladder), f"{captures['1']} graph captures, ladder {ladder}")
    check(ragged_dev <= 1e-6, f"bucketed chain {ragged_dev} off the unbucketed one")
    del parts, outs

    # -- block_stream_full_n: bench.py's streamed BCD at TIMIT's row count
    name, t0 = start("block_stream_full_n")
    d, bs, k, rows, n_chunks = (BLOCK_STREAM[key] for key in ("d", "block", "k", "rows", "chunks"))
    n = rows * n_chunks
    w_star, feat, labels_of = planted_stream(dev, rows, d, k, 29)
    y = torch.cat([labels_of(i, feat(i)) for i in range(n_chunks)])
    t_labels = clock() - t0
    ds = ChunkedDataset.from_chunk_fn(feat, n_chunks, n, label="planted")
    with ScanLog() as scans:
        t1 = clock()
        W = torch.cat(bcd.solve_blockwise_l2_streaming(
            ds.raw_chunks, y, STREAM_LAMBDA, bs, 1, means=torch.zeros(d, device=dev)))
        t_solve = clock() - t1
    rel = (torch.linalg.norm(W - w_star) / torch.linalg.norm(w_star)).item()
    analytic = STREAM_SIGMA * (d / (n - d)) ** 0.5
    flops = 2.0 * n * bs * d + 3 * 2.0 * n * d * k + (d // bs) * bs ** 3 / 3
    finish(name, t0, {
        "n": n, "d": d, "block_size": bs, "k": k, "chunks": n_chunks,
        "design_matrix_gb": n * d * 4 / 1e9, "labels_seconds": t_labels,
        "solve_seconds": t_solve, "solve_flops": flops, "fp32_bound_seconds": flops / FP32_FLOPS,
        "share_of_fp32_bound": flops / FP32_FLOPS / t_solve,
        "scans": [[s.label, s.chunks] for s in scans], "stalls": stall_totals(scans),
        "model_rel_err": rel, "model_rel_err_analytic": analytic})
    check(0.5 * analytic < rel < 2.0 * analytic,
          f"model error {rel} outside [0.5, 2] × the analytic {analytic}")
    check(len(scans) == d // bs and all(s.chunks == n_chunks for s in scans),
          f"scans {[(s.label, s.chunks) for s in scans]}")
    del W, y, ds, w_star

    # -- exact_stream_d8192: bench.py's streamed exact solve at that count
    name, t0 = start("exact_stream_d8192")
    d, k, rows, n_chunks = (EXACT_STREAM[key] for key in ("d", "k", "rows", "chunks"))
    n = rows * n_chunks
    w_star, feat, labels_of = planted_stream(dev, rows, d, k, 11)

    def pair(i):
        A = feat(i)
        return A, labels_of(i, A)

    t1 = clock()
    W = normal_equations.solve_least_squares_streaming(
        ChunkedDataset.from_chunk_fn(pair, n_chunks, n, label="planted").raw_chunks(),
        reg=STREAM_LAMBDA, device=dev)
    t_solve = clock() - t1
    rel = (torch.linalg.norm(W - w_star) / torch.linalg.norm(w_star)).item()
    analytic = STREAM_SIGMA * (d / (n - d)) ** 0.5
    flops = 2.0 * n * d * d + 2.0 * n * d * k + d ** 3 / 3
    finish(name, t0, {
        "n": n, "d": d, "k": k, "chunks": n_chunks, "design_matrix_gb": n * d * 4 / 1e9,
        "solve_seconds": t_solve, "solve_flops": flops, "fp32_bound_seconds": flops / FP32_FLOPS,
        "share_of_fp32_bound": flops / FP32_FLOPS / t_solve,
        "model_rel_err": rel, "model_rel_err_analytic": analytic})
    check(0.5 * analytic < rel < 2.0 * analytic,
          f"model error {rel} outside [0.5, 2] × the analytic {analytic}")
    del W, w_star

    # -- timit_out_of_core: the slice's main path at full width ----------
    conf = timit.TimitConfig(num_cosines=OOC_COSINES)
    t1 = time.perf_counter()
    train = timit.synthetic_timit(OOC_ROWS, conf.num_classes, seed=1)
    test = timit.synthetic_timit(OOC_TEST, conf.num_classes, seed=2)
    host_draw = time.perf_counter() - t1
    frames = train.data.to_array().to(dev)
    train_labels = train.labels.to_array().numpy()
    del train
    name, t0 = start("timit_out_of_core")
    steps0 = bcd.solve_blockwise_l2_streaming.block_steps
    chunked = LabeledData(train_labels, ChunkedDataset.from_array(frames, OOC_CHUNK))
    phases = {}
    segment.reset_path_counts()  # the segment runs' paths, counted untraced
    with Probe() as probe, ScanLog() as scans:
        probe.watch_fit(Pipeline)
        probe.watch(BlockLeastSquaresEstimator, "fit")
        probe.watch(RuleExecutor, "execute")
        scorer, tr_err, te_err, seconds = timit.run(chunked, test, conf, dev, phases)
        fit_graph = probe.last["RuleExecutor.execute:fit"][0]
        fitted = scorer.and_then(MaxClassifier()).fit()
    segment_paths = Counter(segment.path_counts())
    peak = torch.cuda.max_memory_allocated()
    steps = bcd.solve_blockwise_l2_streaming.block_steps - steps0
    fit_scans = [s for s in scans if s.label in ("column_means", "bcd.stream")]
    bcd_scans = [s for s in fit_scans if s.label == "bcd.stream"]
    step_seconds = [b.start - a.start for a, b in zip(bcd_scans, bcd_scans[1:])]
    fits = {k: v for k, v in probe.calls.items() if k.startswith("BlockLeast")}
    full_steps = OOC_COSINES + 2
    # the featurizer alone over the frames, one scan: its share of the solve
    feat_only = timit.build_featurizer(conf, dev).apply(
        ChunkedDataset.from_array(frames, OOC_CHUNK)).get()
    t1 = clock()
    for c in feat_only.chunks():
        del c
    featurize_scan = clock() - t1
    finish("timit_out_of_core", t0, {
        "rows": OOC_ROWS, "chunks": OOC_CHUNKS, "chunk_rows": OOC_CHUNK,
        "num_cosines": OOC_COSINES, "d": OOC_COSINES * timit.NUM_COSINE_FEATURES,
        "design_matrix_gb": OOC_ROWS * OOC_COSINES * timit.NUM_COSINE_FEATURES * 4 / 1e9,
        "test_rows": OOC_TEST, "host_draw_seconds": host_draw,
        "train_error": tr_err, "test_error": te_err, "run_seconds": seconds,
        "phase_seconds": phases, "block_steps": steps,
        "scans": {"column_means": [s.chunks for s in fit_scans if s.label == "column_means"],
                  "bcd.stream": [s.chunks for s in bcd_scans]},
        "means_scan_seconds": [s.end - s.start for s in fit_scans if s.label == "column_means"],
        "block_step_seconds_first_epoch": step_seconds[:OOC_COSINES],
        "block_step_seconds_later_epochs": step_seconds[OOC_COSINES:],
        "featurize_scan_seconds": featurize_scan,
        "featurize_share_of_solve": len(fit_scans) * featurize_scan / phases["solve"],
        "stalls": stall_totals(fit_scans), "peak_run_gb": peak / 1e9,
        "peak_limit_gb": OOC_PEAK_LIMIT / 1e9,
        "estimator_fits": fits, "fitted_chain": chain(fitted),
        "fitted_fused_steps": [len(g) for g in fused_steps(fitted.graph)],
        "fit_graph_fused_steps": [len(g) for g in fused_steps(fit_graph)]})
    check(steps == OOC_STEPS, f"{steps} streamed block steps, want {OOC_STEPS}")
    check([s.label for s in fit_scans] == ["column_means"] + ["bcd.stream"] * OOC_STEPS
          and all(s.chunks == OOC_CHUNKS for s in fit_scans),
          f"fit scans {[(s.label, s.chunks) for s in fit_scans]}")
    check(peak < OOC_PEAK_LIMIT, f"peak memory {peak} B is not below {OOC_PEAK_LIMIT} B")
    check(te_err < 0.2, f"test error {te_err} is not below 0.2")
    check(fits == {"BlockLeastSquaresEstimator.fit:fit": 1},
          f"the BCD estimator must fit once, in fit(): {fits}")
    check(chain(fitted) == ["FusedTransformerOperator", "BlockLinearMapper", "MaxClassifier"],
          f"fitted chain {chain(fitted)}")
    check([len(g) for g in fused_steps(fit_graph)] == [full_steps, full_steps],
          f"fit-graph fused groups {[len(g) for g in fused_steps(fit_graph)]}")
    mapper_on = next(op for op in fitted.graph.operators.values()
                     if isinstance(op, BlockLinearMapper))
    Xtest = test.data.to_array().to(dev)
    preds_on = fitted.apply(Xtest).to_array()
    del scorer, fitted, fit_graph, feat_only, probe, chunked

    # -- segment_chunked: that fit's segments ran the chunked path; the same
    # fit under node dispatch gives the same model
    name, t0 = start("segment_chunked")
    chunked = LabeledData(train_labels, ChunkedDataset.from_array(frames, OOC_CHUNK))

    def node_fit():
        scorer_, tr_, te_, seconds_ = timit.run(chunked, test, conf, dev, {})
        fitted_ = scorer_.and_then(MaxClassifier()).fit()
        return fitted_, tr_, te_, seconds_, fitted_.apply(Xtest).to_array()

    fitted_off, tr_off, te_off, seconds_off, preds_off = with_env(
        "KEYSTONE_SEGMENT_COMPILE", "0", node_fit)
    mapper_off = next(op for op in fitted_off.graph.operators.values()
                      if isinstance(op, BlockLinearMapper))
    W_on, W_off = mapper_on._W, mapper_off._W
    w_dev = ((W_on - W_off).abs() - (2e-4 + 2e-3 * W_off.abs())).max().item()
    finish(name, t0, {
        "paths_on": dict(segment_paths), "train_error": [tr_err, tr_off],
        "test_error": [te_err, te_off], "run_seconds": [seconds, seconds_off],
        "W_max_abs_dev": (W_on - W_off).abs().max().item(), "W_bit_equal": bool(torch.equal(W_on, W_off)),
        "W_rtol": 2e-3, "W_atol": 2e-4, "predictions_equal": bool(torch.equal(preds_on, preds_off))})
    check(segment_paths.get("chunked", 0) >= 1 and set(segment_paths) <= {"chunked", "compiled"},
          f"exec.segment paths {dict(segment_paths)}")
    check(w_dev <= 0, f"W with segments {w_dev} beyond rtol 2e-3 / atol 2e-4 of node dispatch")
    check(bool(torch.equal(preds_on, preds_off)), "segment and node dispatch predict differently")
    del fitted_off, mapper_on, mapper_off, W_on, W_off, preds_on, preds_off, Xtest, chunked

    # -- absorb_timit: a snapshot fit on 8 chunks, 2 more absorbed -------
    name, t0 = start("absorb_timit")
    draws = Counter()

    def frame_chunks(first, count):
        def chunk_fn(i):
            draws[first + i] += 1
            return frames[(first + i) * OOC_CHUNK:(first + i + 1) * OOC_CHUNK]
        return ChunkedDataset.from_chunk_fn(chunk_fn, count, count * OOC_CHUNK,
                                            label=f"frames[{first}:{first + count}]")

    total = ABSORB_CHUNKS + ABSORB_APPENDED
    Y = ClassLabelIndicators(conf.num_classes).forward(
        torch.from_numpy(train_labels[:total * OOC_CHUNK]).to(dev))
    cut = ABSORB_CHUNKS * OOC_CHUNK
    featurizer = timit.build_featurizer(conf, dev)
    secs, state_phases = {}, {}

    def timed(step, fn):
        # each chunk's products and its host float64 fold, synchronized apart
        timing.reset()
        timing.enable()
        try:
            t1 = clock()
            out = fn()
            secs[step] = clock() - t1
        finally:
            timing.enable(False)
        state_phases[step] = timing.snapshot("gram_state.")
        return out

    fitted = timed("snapshot_fit", lambda: featurizer.and_then(
        LinearMapEstimator(ABSORB_LAMBDA, snapshot=True), frame_chunks(0, ABSORB_CHUNKS),
        Dataset.of(Y[:cut])).fit())
    fit_draws, draws = dict(draws), Counter()
    updated = timed("absorb", lambda: fitted.absorb(
        frame_chunks(ABSORB_CHUNKS, ABSORB_APPENDED), Dataset.of(Y[cut:])))
    absorb_draws, draws = dict(draws), Counter()
    fresh_env()
    scratch = timed("scratch_fit", lambda: featurizer.and_then(
        LinearMapEstimator(ABSORB_LAMBDA, snapshot=True), frame_chunks(0, total),
        Dataset.of(Y)).fit())
    models = {k: next(op for op in f.graph.operators.values() if isinstance(op, LinearMapper))
              for k, f in (("fitted", fitted), ("absorbed", updated), ("scratch", scratch))}
    devs = {p: (getattr(models["absorbed"], p) - getattr(models["scratch"], p)).abs().max().item()
            for p in ("W", "b", "feature_mean")}
    Xt = test.data.to_array().to(dev)
    preds_equal = bool(torch.equal(updated.apply(Xt).to_array().argmax(1),
                                   scratch.apply(Xt).to_array().argmax(1)))
    moved = (models["absorbed"].W - models["fitted"].W).abs().max().item()
    state = models["absorbed"].solver_state
    finish(name, t0, {
        "chunks": ABSORB_CHUNKS, "appended_chunks": ABSORB_APPENDED, "chunk_rows": OOC_CHUNK,
        "d": OOC_COSINES * timit.NUM_COSINE_FEATURES, "lambda": ABSORB_LAMBDA,
        "seconds_by_step": secs, "state_phases_by_step": state_phases,
        "chunk_draws_fit": fit_draws, "chunk_draws_absorb": absorb_draws,
        "absorbed_vs_scratch_max_abs_dev": devs, "limit": 1e-6,
        "moved_from_the_snapshot_fit": moved, "test_predictions_equal": preds_equal,
        "state_rows": state.n, "host_gram_gb": state.gram.nbytes / 1e9})
    check(fit_draws == {i: 1 for i in range(ABSORB_CHUNKS)},
          f"the snapshot fit drew the chunks {fit_draws}")
    check(absorb_draws == {ABSORB_CHUNKS + i: 1 for i in range(ABSORB_APPENDED)},
          f"absorb drew the chunks {absorb_draws}; only the appended ones, once")
    check(all(v <= 1e-6 for v in devs.values()), f"absorb is off the fit from scratch: {devs}")
    check(preds_equal, "absorb and the fit from scratch predict differently")
    check(state.n == total * OOC_CHUNK, f"the absorbed state holds {state.n} rows")
    del updated, scratch, state, Xt

    # -- resume_timit: the snapshot fit as a checkpointed λ grid,
    # killed under a fault plan and run again --------------------------
    name, t0 = start("resume_timit")
    feats = fitted.prefix_features(frame_chunks(0, ABSORB_CHUNKS))
    ref_state = models["fitted"].solver_state
    ckpt_dir = tempfile.mkdtemp(prefix="resume-timit-")
    ests = [LinearMapEstimator(lam) for lam in RESUME_LAMBDAS]
    runs, members = {}, None
    for run, text in (("kill", f"{RESUME_TRANSIENTS};scan.chunk=fatal@{RESUME_KILL_CHUNK}"),
                      ("resume", RESUME_TRANSIENTS)):
        draws = Counter()
        plan = faults.install(faults.parse_plan(text))
        error = None
        t1 = clock()
        with FaultLog() as log:
            try:
                members = with_env("KEYSTONE_SCAN_RETRIES", RESUME_RETRIES,
                                   lambda: LinearMapEstimator.fit_lambda_grid(
                                       ests, feats, Dataset.of(Y[:cut]), checkpoint=ckpt_dir,
                                       checkpoint_every=RESUME_EVERY))
            except faults.FatalFaultInjected as e:
                error = repr(e)
            finally:
                faults.clear()
        runs[run] = {"seconds": clock() - t1, "error": error, "chunk_draws": dict(draws),
                     "saves": log.saves, "retries_by_site": dict(log.retries),
                     "injected": dict(plan.injected), "transients": transient_fired(plan),
                     "checkpoint_files": len(os.listdir(ckpt_dir))}
    got = members[RESUME_LAMBDAS.index(ABSORB_LAMBDA)]
    state_equal = {a: bool(np.array_equal(getattr(got.solver_state, a), getattr(ref_state, a)))
                   for a in ("gram", "cross", "sum_x", "sum_y", "shift", "shift_y")}
    # λ 100 against the fit's own W; the others against the state's solves
    others = [lam for lam in RESUME_LAMBDAS if lam != ABSORB_LAMBDA]
    members_equal = {lam: bool(torch.equal(members[RESUME_LAMBDAS.index(lam)].W, W))
                     for lam, (W, _, _) in zip(others, ref_state.solve_lambdas(others, dev))}
    finish(name, t0, {
        "chunks": ABSORB_CHUNKS, "d": OOC_COSINES * timit.NUM_COSINE_FEATURES,
        "lambdas": RESUME_LAMBDAS, "checkpoint_every": RESUME_EVERY,
        "kill_chunk": RESUME_KILL_CHUNK, "scan_retries": int(RESUME_RETRIES), "runs": runs,
        "state_equal": state_equal,
        "w_equal_to_the_snapshot_fit": bool(torch.equal(got.W, models["fitted"].W)),
        "members_equal_to_state_solve": members_equal,
        "host_state_gb_per_member": ref_state.gram.nbytes / 1e9,
        "disk_free_gb": shutil.disk_usage(ckpt_dir).free / 1e9,
        "peak_host_gb": host_peak_gb()})
    kill, resume = runs["kill"], runs["resume"]
    kill_saves = list(range(RESUME_EVERY, RESUME_KILL_CHUNK + 1, RESUME_EVERY))
    last = kill_saves[-1]
    check(kill["error"] is not None and "FatalFaultInjected" in kill["error"],
          f"the kill run ended with {kill['error']}")
    check([sv["chunk"] for sv in kill["saves"]] == kill_saves and kill["checkpoint_files"] == 1,
          f"the kill run saved at {[sv['chunk'] for sv in kill['saves']]}, want {kill_saves}")
    check(kill["chunk_draws"] == {i: 1 for i in range(RESUME_KILL_CHUNK)},
          f"the kill run drew {kill['chunk_draws']}")
    check(resume["chunk_draws"] == {i: 1 for i in range(last, ABSORB_CHUNKS)},
          f"the resumed run drew {resume['chunk_draws']}; those after the save at {last}, once")
    resume_saves = list(range(last + RESUME_EVERY, ABSORB_CHUNKS, RESUME_EVERY))
    check(bool(resume_saves) and [sv["chunk"] for sv in resume["saves"]] == resume_saves,
          f"the re-run saved at {[sv['chunk'] for sv in resume['saves']]}, want {resume_saves}")
    check(all(r["transients"] == {"scan.chunk": 2, "scan.stage": 1} for r in runs.values()),
          f"every transient of the plan in each run: {[r['transients'] for r in runs.values()]}")
    check(all(r["retries_by_site"] == r["transients"] for r in runs.values()),
          f"retries by site against the plans' transients: {runs}")
    check(resume["checkpoint_files"] == 0, "the completed grid left its checkpoint")
    check(all(state_equal.values()), f"the resumed state differs from the fit's: {state_equal}")
    check(torch.equal(got.W, models["fitted"].W), "the λ 100 member's W is not the fit's")
    check(all(members_equal.values()), f"members against state.solve: {members_equal}")
    del feats, members, got, ests

    # -- absorb_resume_timit: absorb's 2 chunks, killed before the second;
    # an absorb of 2 other chunks killed the same way starts at its own
    # first chunk, where a resume of the first absorb's save would skip it
    name, t0 = start("absorb_resume_timit")
    ckpt_dir = tempfile.mkdtemp(prefix="absorb-resume-")
    other = ClassLabelIndicators(conf.num_classes).forward(torch.from_numpy(
        train_labels[total * OOC_CHUNK:(total + ABSORB_APPENDED) * OOC_CHUNK]).to(dev))
    absorbs = {}
    for run, first, labels, text in (("kill", ABSORB_CHUNKS, Y[cut:], "scan.chunk=fatal@1"),
                                     ("other_data", total, other, "scan.chunk=fatal@1"),
                                     ("resume", ABSORB_CHUNKS, Y[cut:], None)):
        draws = Counter()
        if text:
            faults.install(faults.parse_plan(text))
        error = out = None
        t1 = clock()
        with FaultLog() as log:
            try:
                out = fitted.absorb(frame_chunks(first, ABSORB_APPENDED), Dataset.of(labels),
                                    checkpoint=ckpt_dir, checkpoint_every=1)
            except faults.FatalFaultInjected as e:
                error = repr(e)
            finally:
                faults.clear()
        absorbs[run] = {"seconds": clock() - t1, "error": error, "chunk_draws": dict(draws),
                        "saves": log.saves, "checkpoint_files": sorted(os.listdir(ckpt_dir)),
                        "model": out and next(op for op in out.graph.operators.values()
                                              if isinstance(op, LinearMapper))}
    resumed = absorbs["resume"].pop("model")
    absorbs["kill"].pop("model"), absorbs["other_data"].pop("model")
    files = {run: r["checkpoint_files"] for run, r in absorbs.items()}
    state_equal = {a: bool(np.array_equal(getattr(resumed.solver_state, a),
                                          getattr(models["absorbed"].solver_state, a)))
                   for a in ("gram", "cross", "sum_x", "sum_y")}
    finish(name, t0, {"appended_chunks": ABSORB_APPENDED, "runs": absorbs,
                      "state_equal": state_equal,
                      "w_equal": bool(torch.equal(resumed.W, models["absorbed"].W)),
                      "peak_host_gb": host_peak_gb()})
    for run in ("kill", "other_data"):
        check(absorbs[run]["error"] is not None and len(absorbs[run]["saves"]) == 1
              and absorbs[run]["saves"][0]["chunk"] == 1,
              f"the {run} absorb was to die after its save at 1: {absorbs[run]}")
    check(absorbs["kill"]["chunk_draws"] == {ABSORB_CHUNKS: 1},
          f"the killed absorb drew {absorbs['kill']['chunk_draws']}")
    check(absorbs["other_data"]["chunk_draws"] == {total: 1} and len(files["other_data"]) == 2,
          f"the absorb of other data did not start fresh in its own file: {absorbs['other_data']}")
    check(absorbs["resume"]["chunk_draws"] == {ABSORB_CHUNKS + 1: 1}
          and not absorbs["resume"]["saves"],
          f"the resumed absorb drew {absorbs['resume']['chunk_draws']}; only the second chunk")
    check(files["resume"] == sorted(set(files["other_data"]) - set(files["kill"])),
          f"the completed absorb left its checkpoint, or removed another's: {files}")
    check(all(state_equal.values()) and torch.equal(resumed.W, models["absorbed"].W),
          f"the resumed absorb differs from the uninterrupted one: {state_equal}")
    del models, ref_state, resumed, other, Y, featurizer

    # -- trainer_timit: the snapshot model served by a fleet while the
    # trainer absorbs, canaries and swaps chunks 10-15, then rolls back a
    # poisoned batch; the model's own training chunks are never drawn
    name, t0 = start("trainer_timit")
    draws = Counter()
    row = trainer_timit(fitted, frames, train_labels, test.data.to_array().numpy(),
                        conf.num_classes, OOC_CHUNK)
    row.update(training_chunk_draws=dict(draws), peak_host_gb=host_peak_gb())
    finish(name, t0, row)
    check(not draws, f"the trainer drew the served model's training chunks: {dict(draws)}")
    del fitted

    # -- ls_chunked: the least-squares family on the chunked frames ------
    name, t0 = start("ls_chunked")
    Y = ClassLabelIndicators(conf.num_classes).forward(torch.from_numpy(train_labels).to(dev))
    raw = ChunkedDataset.from_array(frames, OOC_CHUNK)
    with Probe() as probe:
        for cls in (LinearMapEstimator, BlockLeastSquaresEstimator, TSQRLeastSquaresEstimator):
            probe.watch(cls, "_fit_streaming")
        t1 = clock()
        raw_model = LeastSquaresEstimator().fit(raw, Dataset.of(Y))
        raw_seconds = clock() - t1
    raw_fits = dict(probe.calls)
    W_mem = LinearMapEstimator(0.0).fit(Dataset.of(frames), Dataset.of(Y)).W
    raw_rel = (torch.linalg.norm(raw_model.W - W_mem) / torch.linalg.norm(W_mem)).item()
    del W_mem
    # planned in a graph on the chunked 16,384-wide features
    pipe = timit.build_featurizer(conf, dev).and_then(LeastSquaresEstimator(), raw, Y)
    graph, _ = PipelineEnv.get_or_create().optimizer.execute(pipe.graph)
    (planned,) = [op for op in graph.operators.values()
                  if type(op).__name__.endswith("Estimator")]
    d_feat = OOC_COSINES * timit.NUM_COSINE_FEATURES
    choice = LeastSquaresEstimator().choose_solver(
        cost.ShapeSignature(OOC_ROWS, d_feat, conf.num_classes, chunked=True))
    del pipe, graph
    # TSQR against the exact solve, both streamed, on one 4096-wide branch
    branch = timit._cosine_branch(conf, 0, dev)
    feats = branch.apply_batch(raw)
    t1 = clock()
    W_tsqr = TSQRLeastSquaresEstimator(0.0).fit(feats, Dataset.of(Y)).W
    tsqr_seconds = clock() - t1
    t1 = clock()
    W_exact = LinearMapEstimator(0.0).fit(feats, Dataset.of(Y)).W
    exact_seconds = clock() - t1
    tsqr_rel = (torch.linalg.norm(W_tsqr - W_exact) / torch.linalg.norm(W_exact)).item()
    finish(name, t0, {
        "rows": OOC_ROWS, "raw_choice": type(raw_model).__name__, "raw_streaming_fits": raw_fits,
        "raw_fit_seconds": raw_seconds, "raw_rel_dev_from_in_memory": raw_rel,
        "features_plan": {"label": type(planned).__name__,
                          "block_size": getattr(planned, "block_size", None),
                          "num_iter": getattr(planned, "num_iter", None)},
        "features_units": {k: r["units"] for k, r in choice.costs.items()},
        "tsqr_fit_seconds": tsqr_seconds, "exact_fit_seconds": exact_seconds,
        "tsqr_rel_dev_from_exact": tsqr_rel, "limit": 1e-3})
    check(type(raw_model).__name__ == "LinearMapper"
          and raw_fits == {"LinearMapEstimator._fit_streaming:apply": 1},
          f"the chunked raw frames must stream LinearMapEstimator once: {raw_fits}")
    check(raw_rel < 1e-3, f"the streamed exact solve is {raw_rel} off the in-memory one")
    check(isinstance(planned, BlockLeastSquaresEstimator)
          and (planned.block_size, planned.num_iter) == (1000, 3),
          f"planned {type(planned).__name__} for the chunked features")
    check(all(math.isinf(choice.costs[k]["units"])
              for k in ("DenseLBFGSwithL2", "SparseLBFGSwithL2")),
          f"the L-BFGS options on chunked input: {choice.costs}")
    check(tsqr_rel < 1e-3, f"streamed TSQR's W is {tsqr_rel} off the streamed exact solve's")
    del feats, W_tsqr, W_exact, raw_model, branch

    # -- resume_tsqr: the checkpointed TSQR on the raw frames, killed at
    # chunk 20 of its fold and resumed; the λ grid against independent fits
    name, t0 = start("resume_tsqr")
    ckpt_dir = tempfile.mkdtemp(prefix="resume-tsqr-")
    labels = Dataset.of(Y)
    tsqr_runs, fits, rs = {}, {}, {}
    kill_at = OOC_CHUNKS + 1 + TSQR_KILL_CHUNK  # after the means scan's pulls
    with Probe() as probe:
        probe.watch(TSQRLeastSquaresEstimator, "_fold_r")
        for run, sub, text in (("whole", "whole", None),
                               ("kill", "killed", f"scan.chunk=fatal@{kill_at}"),
                               ("resume", "killed", None)):
            draws = Counter()
            if text:
                faults.install(faults.parse_plan(text))
            error = None
            t1 = clock()
            with FaultLog() as log:
                try:
                    fits[run] = TSQRLeastSquaresEstimator(
                        0.0, checkpoint=os.path.join(ckpt_dir, sub),
                        checkpoint_every=TSQR_EVERY).fit(frame_chunks(0, OOC_CHUNKS), labels)
                    rs[run] = probe.last["TSQRLeastSquaresEstimator._fold_r:apply"].r
                except faults.FatalFaultInjected as e:
                    error = repr(e)
                finally:
                    faults.clear()
            tsqr_runs[run] = {"seconds": clock() - t1, "error": error,
                              "chunk_draws": sorted(Counter(draws.values()).items()),
                              "drawn": sorted(draws), "saves": [sv["chunk"] for sv in log.saves]}
    t1 = clock()
    plain = TSQRLeastSquaresEstimator(0.0).fit(raw, labels).W
    plain_seconds = clock() - t1
    plain_rel = (torch.linalg.norm(fits["whole"].W - plain) / torch.linalg.norm(plain)).item()
    t1 = clock()
    grid = TSQRLeastSquaresEstimator.fit_lambda_grid(
        [TSQRLeastSquaresEstimator(lam) for lam in TSQR_LAMBDAS], raw, labels)
    grid_seconds = clock() - t1
    grid_dev = {}
    for lam, m in zip(TSQR_LAMBDAS, grid):
        W = TSQRLeastSquaresEstimator(lam).fit(raw, labels).W
        grid_dev[lam] = {"max_abs": (m.W - W).abs().max().item(),
                         "relative": ((m.W - W).abs().max() / W.abs().max()).item()}
    finish(name, t0, {
        "rows": OOC_ROWS, "chunks": OOC_CHUNKS, "checkpoint_every": TSQR_EVERY,
        "kill_chunk": TSQR_KILL_CHUNK, "runs": tsqr_runs,
        "r_equal": bool(torch.equal(rs["whole"], rs["resume"])),
        "w_equal": bool(torch.equal(fits["whole"].W, fits["resume"].W)),
        "rel_dev_from_plain_streaming": plain_rel, "plain_seconds": plain_seconds,
        "limit": 1e-3, "grid_lambdas": TSQR_LAMBDAS, "grid_seconds": grid_seconds,
        "grid_dev_from_independent": grid_dev, "grid_limit": TSQR_GRID_LIMIT})
    check(tsqr_runs["kill"]["error"] is not None, "the TSQR kill run did not die")
    check(tsqr_runs["kill"]["saves"] == list(range(0, TSQR_KILL_CHUNK + 1, TSQR_EVERY)),
          f"the TSQR kill run saved at {tsqr_runs['kill']['saves']}")
    check(tsqr_runs["resume"]["drawn"] == list(range(TSQR_KILL_CHUNK, OOC_CHUNKS))
          and tsqr_runs["resume"]["chunk_draws"] == [(1, OOC_CHUNKS - TSQR_KILL_CHUNK)]
          and tsqr_runs["resume"]["saves"] == list(range(TSQR_KILL_CHUNK + TSQR_EVERY,
                                                         OOC_CHUNKS, TSQR_EVERY)),
          f"the resumed TSQR drew {tsqr_runs['resume']}; the chunks after the save, once")
    check(torch.equal(rs["whole"], rs["resume"]) and torch.equal(fits["whole"].W,
                                                                 fits["resume"].W),
          "the resumed TSQR's R or W differs from the uninterrupted checkpointed fit's")
    check(plain_rel < 1e-3, f"the checkpointed TSQR is {plain_rel} off the plain streaming fit")
    check(all(v["relative"] <= TSQR_GRID_LIMIT for v in grid_dev.values()),
          f"TSQR grid members against independent fits: {grid_dev}")
    check(not any(os.listdir(os.path.join(ckpt_dir, sub)) for sub in ("whole", "killed")),
          "a completed TSQR fit left its checkpoint")

    # -- traced_tsqr: the plain streamed TSQR of the raw frames under a
    # tracer: one scan span a scan, its counters the scan's own ----------
    from keystone_tpu_torch.obs import tracer as trace_mod

    name, t0 = start("traced_tsqr")
    tracer = trace_mod.install(trace_mod.Tracer())
    try:
        with ScanLog() as scans:
            t1 = clock()
            traced_W = TSQRLeastSquaresEstimator(0.0).fit(raw, labels).W
            traced_seconds = clock() - t1
    finally:
        trace_mod.reset()
    spans = [sp for sp in tracer.spans() if sp.name == "scan.pipeline"]
    keys = ("chunks", "producer_seconds", "producer_stall_seconds", "consumer_stall_seconds",
            "staged_bytes", "occupancy_max")
    own = [{k: (round(getattr(st, k), 6) if isinstance(getattr(st, k), float) else getattr(st, k))
            for k in keys} for st in scans]
    finish(name, t0, {
        "rows": OOC_ROWS, "chunks": OOC_CHUNKS, "traced_seconds": traced_seconds,
        "untraced_seconds": plain_seconds, "scan_spans": [{k: sp.attrs[k] for k in keys}
                                                          for sp in spans],
        "scans": own, "w_equal_untraced": bool(torch.equal(traced_W, plain))})
    check(len(spans) == len(scans) >= 1 and all(o["chunks"] == OOC_CHUNKS for o in own),
          f"{len(spans)} scan spans for {len(scans)} scans of {[o['chunks'] for o in own]} chunks")
    check([{k: sp.attrs[k] for k in keys} for sp in spans] == own,
          "a scan span's counters differ from its scan's")
    check(torch.equal(traced_W, plain), "the traced TSQR fit differs from the untraced one")
    del frames, raw, Y, labels, fits, rs, plain, grid, traced_W

    # -- timit_stream_vs_memory: the chunked fit against the in-memory one
    name, t0 = start("timit_stream_vs_memory")
    train = timit.synthetic_timit(OOC_MEMORY_ROWS, conf.num_classes, seed=3)
    params = [(b.W.cpu().numpy(), b.b.cpu().numpy())
              for b in (timit._cosine_branch(conf, i, "cpu") for i in range(OOC_COSINES))]
    Xm = train.data.to_array().to(dev)
    models, preds = {}, {}
    Xt = test.data.to_array().to(dev)
    for how, data in (("memory", Xm), ("chunked", ChunkedDataset.from_array(Xm, OOC_CHUNK))):
        fresh_env()
        scorer, _, _, _ = timit.run(LabeledData(train.labels.to_array().numpy(), data), test,
                                    conf, dev, params=params)
        scores = scorer.fit()
        models[how] = next(op for op in scores.graph.operators.values()
                           if isinstance(op, BlockLinearMapper))._W
        preds[how] = scores.apply(Xt).to_array().argmax(dim=1)
    excess = ((models["chunked"] - models["memory"]).abs()
              - (2e-4 + 2e-3 * models["memory"].abs())).max().item()
    w_rel = (torch.linalg.norm(models["chunked"] - models["memory"])
             / torch.linalg.norm(models["memory"])).item()
    preds_equal = bool(torch.equal(preds["chunked"], preds["memory"]))
    finish(name, t0, {"rows": OOC_MEMORY_ROWS, "d": d_feat, "w_rel_dev": w_rel,
                      "w_tolerance_excess": excess, "tolerance": {"rtol": 2e-3, "atol": 2e-4},
                      "predictions_equal": preds_equal})
    check(excess <= 0, f"the chunked fit's W is off the in-memory one beyond tolerance ({excess})")
    check(preds_equal, "the chunked and in-memory fits predict differently")
    del Xm, Xt, models, preds, train, test
    return launches


# The out-of-core weighted fit (slice 11). ImageNetSiftLcsFV at the
# reference's widths on 5,120 synthetic 256² images drawn on the card in
# chunks of 64 (their SIFT and LCS stacks, ~41 GB, above the peak limit; 10,240
# until the trainer's phase needed the time limit's room), 1e6
# samples a codebook as the full-width ImageNet phase takes; the weighted
# solver at ImageNet's training count over a planted class-mean model
# (1,281,167 × 4096, 21 GB over the cache budget), streamed; and the same
# draw at 100,000 rows streamed against in memory
IN_OOC_TRAIN, IN_OOC_TEST, IN_OOC_CHUNK = 5120, 1000, 64
IN_OOC_PEAK_LIMIT = 40e9
WLS_N, WLS_D, WLS_K, WLS_CHUNK, WLS_TEST = 1_281_167, 4096, 1000, 65536, 10_000
WLS_MEMORY_ROWS = 100_000
WLS_SEPARATION = 8.0  # ‖μ_a − μ_b‖ of two class means, in noise standard deviations
WLS_ACCURACY_LIMIT = 0.9
WLS_DEV_LIMIT = 3e-5  # as SOLVE_CHECK_DEV_LIMIT, on the planted rows


def planted_means(dev, d: int, k: int, seed: int) -> torch.Tensor:
    """k class means s·N(0, I_d), s = WLS_SEPARATION / √(2d): two means are
    about WLS_SEPARATION noise deviations apart."""
    s = WLS_SEPARATION / math.sqrt(2 * d)
    return s * torch.randn(k, d, device=dev, generator=torch.Generator(dev).manual_seed(seed))


def planted_rows(dev, means: torch.Tensor, n: int, chunk_rows: int, seed: int,
                 lineage: bool = True):
    """Rows of the planted class-mean model drawn on the card chunk by chunk:
    chunk i's labels (uniform over the classes) and noise N(0, I) from
    generators seeded by (seed, i), made anew on every scan. Returns (the
    labels, all drawn once, and the ChunkedDataset of the rows).
    ``lineage=False`` is the fault the lineage contract forbids, as a
    control: the noise comes from one generator made once for the dataset,
    so every scan sees other rows under the same labels."""
    from keystone_tpu_torch.data.chunked import ChunkedDataset
    from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import _chunk_generator

    k, d = means.shape
    n_chunks = -(-n // chunk_rows)
    shared = None if lineage else _chunk_generator(dev, seed, 0, 1)

    def chunk_labels(i):
        rows = min(chunk_rows, n - i * chunk_rows)
        return torch.randint(0, k, (rows,), device=dev, generator=_chunk_generator(dev, seed, i, 0))

    def chunk_fn(i):
        lab = chunk_labels(i)
        gen = _chunk_generator(dev, seed, i, 1) if shared is None else shared
        X = torch.randn(lab.shape[0], d, device=dev, generator=gen)
        return X.add_(means[lab])

    labels = torch.cat([chunk_labels(i) for i in range(n_chunks)])
    return labels, ChunkedDataset.from_chunk_fn(chunk_fn, n_chunks, n,
                                                label=f"planted_classes[{n}]")


def weighted_f64_scores(chunks, n: int, w: float, lam: float, X_test, classes: int):
    """The exact per-class weighted ridge of the first ``classes`` classes
    in float64 on the card, from one scan of (rows, labels) chunks: the
    population and class sums, then per class G_c = Σᵢ bᵢ(xᵢ−μ_c)(xᵢ−μ_c)ᵀ
    and rhs_c = Σᵢ bᵢ(xᵢ−μ_c)(y_ic − m_c) (bᵢ = (1−w)/n + w·1[i∈c]/n_c), solved;
    returns the test rows' scores for those classes, (rows, classes)."""
    G = sx = None
    for X, lab in chunks:
        X = X.double()
        if G is None:
            d = X.shape[1]
            G = torch.zeros(d, d, dtype=torch.float64, device=X.device)
            sx = torch.zeros(d, dtype=torch.float64, device=X.device)
            Gc = torch.zeros(classes, d, d, dtype=torch.float64, device=X.device)
            sc = torch.zeros(classes, d, dtype=torch.float64, device=X.device)
            nc = torch.zeros(classes, dtype=torch.float64, device=X.device)
        G.addmm_(X.T, X)
        sx += X.sum(0)
        for c in range(classes):
            rows = X[lab == c]
            Gc[c].addmm_(rows.T, rows)
            sc[c] += rows.sum(0)
            nc[c] += rows.shape[0]
    eye = torch.eye(G.shape[0], dtype=torch.float64, device=G.device)
    pop_mean = sx / n
    W, b = [], []
    for c in range(classes):
        mu = w * sc[c] / nc[c] + (1 - w) * pop_mean
        m = 2 * w + 2 * (1 - w) * nc[c] / n - 1
        Gm = ((1 - w) / n * (G - torch.outer(sx, mu) - torch.outer(mu, sx)
                             + n * torch.outer(mu, mu))
              + w / nc[c] * (Gc[c] - torch.outer(sc[c], mu) - torch.outer(mu, sc[c])
                             + nc[c] * torch.outer(mu, mu)))
        rhs = ((1 - w) / n * (2 * sc[c] - sx - m * sx - mu * (2 * nc[c] - n) + n * m * mu)
               + w / nc[c] * (1 - m) * (sc[c] - nc[c] * mu))
        W.append(torch.linalg.solve(Gm + lam * eye, rhs))
        b.append(m - mu @ W[-1])
    return X_test.double() @ torch.stack(W, 1) + torch.stack(b)


def planted_solve_check(rows, labels, chunk_rows: int, w: float, lam: float, Xt, scores):
    """(argmax agreement, deviation, seconds) of a fit's scores of ``Xt``
    against the float64 per-class solve from one more scan of ``rows``."""
    from keystone_tpu_torch.workflow.pipeline import clock

    t0 = clock()
    exact = weighted_f64_scores(zip(rows.chunks(), labels.split(chunk_rows)), len(labels),
                                w, lam, Xt, SOLVE_CHECK_CLASSES)
    return (*f64_agreement(scores, exact), clock() - t0)


@contextlib.contextmanager
def tf32_products():
    """TF32 matrix products inside the block (the port keeps them off)."""
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior


def solve_check_controls(dev, card) -> None:
    """Controls of the float64 solve checks' deviation limits: the checks of
    wls_stream_full_n and imagenet_out_of_core, run as in those phases on
    fits made faulty on purpose. The faults: TF32 products in the fit
    (both), and the planted rows' noise drawn from one generator made once
    for the dataset, so that every scan sees other rows (the lineage fault,
    which raises nothing). Each row prints its deviation; a control whose
    deviation stays within its limit fails the run."""
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.learning.weighted import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as imagenet
    from keystone_tpu_torch.workflow.pipeline import clock

    start, finish, _ = phase_group(card)
    w, lam = 0.25, 6e-5
    means = planted_means(dev, WLS_D, WLS_K, 40)
    test_labels, test_rows = planted_rows(dev, means, WLS_TEST, WLS_TEST, 42)
    Xt = test_rows.to_array()
    for fault in ("tf32", "lineage"):
        name, t0 = start(f"control_wls_stream_full_n_{fault}")
        labels, rows = planted_rows(dev, means, WLS_N, WLS_CHUNK, 41, lineage=fault != "lineage")
        Y = ClassLabelIndicators(WLS_K).forward(labels)
        t1 = clock()
        with (tf32_products() if fault == "tf32" else contextlib.nullcontext()):
            mapper = BlockWeightedLeastSquaresEstimator(WLS_D, 1, lam, w).fit(rows, Dataset.of(Y))
        fit_seconds = clock() - t1
        scores = mapper.forward(Xt)
        agreement, deviation, f64_seconds = planted_solve_check(rows, labels, WLS_CHUNK, w, lam,
                                                                Xt, scores)
        accuracy = (scores.argmax(1) == test_labels).double().mean().item()
        finish(name, t0, {"fault": fault, "fit_seconds": fit_seconds,
                          "f64_argmax_agreement": agreement, "f64_max_rel_dev": deviation,
                          "deviation_limit": WLS_DEV_LIMIT, "f64_seconds": f64_seconds,
                          "test_accuracy": accuracy})
        check(deviation > WLS_DEV_LIMIT, f"the {fault} control is {deviation} off, within "
              f"the limit {WLS_DEV_LIMIT}: the gate cannot see it")
        del mapper, Y, labels, rows, scores

    name, t0 = start("control_imagenet_out_of_core_tf32")
    train, tr_l = imagenet.synthetic_imagenet_device(IN_OOC_TRAIN, IN_CLASSES, size=IN_SIZE,
                                                     chunk_rows=IN_OOC_CHUNK, seed=1, device=dev)
    test, te_l = imagenet.synthetic_imagenet_device(IN_OOC_TEST, IN_CLASSES, size=IN_SIZE,
                                                    chunk_rows=IN_OOC_CHUNK, seed=2, device=dev)
    te_i = test.to_array()
    conf = imagenet.ImageNetSiftLcsFVConfig(num_pca_samples=1_000_000,
                                            num_gmm_samples=1_000_000, num_classes=IN_CLASSES)
    details = {}
    with tf32_products():
        fitted, top5_err, _ = imagenet.run(train, tr_l, te_i, te_l, conf, dev, details)
    row = fv_solve_deviation(fitted, train, tr_l, te_i, details["scores"], conf)
    finish(name, t0, {"fault": "tf32", **row, "deviation_limit": SOLVE_CHECK_DEV_LIMIT,
                      "top5_error": top5_err})
    check(row["max_rel_dev"] > SOLVE_CHECK_DEV_LIMIT,
          f"the tf32 control is {row['max_rel_dev']} off, within the limit "
          f"{SOLVE_CHECK_DEV_LIMIT}: the gate cannot see it")


def weighted_out_of_core_phases(dev, card) -> dict:
    """The out-of-core weighted fit: ImageNetSiftLcsFV at the reference's
    widths on 5,120 card-drawn training images that are never whole as
    descriptors; the weighted solver at ImageNet's training count, streamed;
    the same draw at 100,000 rows streamed against in memory. Returns the K1
    launches of each path (none reaches K1)."""
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.linalg.weighted import class_chunk_size
    from keystone_tpu_torch.nodes.learning.weighted import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as imagenet
    from keystone_tpu_torch.utils import timing
    from keystone_tpu_torch.workflow.pipeline import clock

    start, finish, launches = phase_group(card)

    # -- imagenet_out_of_core: the application on card-drawn chunks -------
    name, t0 = start("imagenet_out_of_core")
    train, tr_l = imagenet.synthetic_imagenet_device(IN_OOC_TRAIN, IN_CLASSES, size=IN_SIZE,
                                                     chunk_rows=IN_OOC_CHUNK, seed=1, device=dev)
    test, te_l = imagenet.synthetic_imagenet_device(IN_OOC_TEST, IN_CLASSES, size=IN_SIZE,
                                                    chunk_rows=IN_OOC_CHUNK, seed=2, device=dev)
    te_i = test.to_array()
    train_chunks = -(-IN_OOC_TRAIN // IN_OOC_CHUNK)
    conf = imagenet.ImageNetSiftLcsFVConfig(num_pca_samples=1_000_000,
                                            num_gmm_samples=1_000_000, num_classes=IN_CLASSES)
    details = {}
    timing.reset()
    timing.enable()
    try:
        with ScanLog() as scans:
            fitted, top5_err, seconds = imagenet.run(train, tr_l, te_i, te_l, conf, dev, details)
    finally:
        timing.enable(False)
    solver_phases = timing.snapshot("wls.")
    peak = torch.cuda.max_memory_allocated()
    train_scans = [s.label for s in scans if s.chunks == train_chunks]
    seen = [next(iter(train.raw_chunks(skip=train_chunks // 2))) for _ in range(2)]
    same_chunk = bool(torch.equal(seen[0], seen[1]))
    stacks = IN_OOC_TRAIN * 4 * (128 * IN_SIFT + 96 * IN_LCS)
    finish(name, t0, {
        "train": IN_OOC_TRAIN, "test": IN_OOC_TEST, "chunk_rows": IN_OOC_CHUNK,
        "size": IN_SIZE, "classes": IN_CLASSES, "desc_dim": conf.desc_dim,
        "vocab_size": conf.vocab_size, "lambda": conf.lam,
        "mixture_weight": conf.mixture_weight, "samples": 1_000_000,
        "top5_error": top5_err, "top5_limit": IN_TOP5_LIMIT, "run_seconds": seconds,
        "fit_seconds": details["fit_seconds"], "phase_seconds": details["phases"],
        "solver_phases": solver_phases, "featurize_scans": train_scans,
        "descriptors": details["descriptors"], "fv_width": details["fv_width"],
        "solver_route": details["solver_route"], "solver_path": details["solver_path"],
        "class_chunks": details["class_chunks"], "pca_choice": details["pca_choice"],
        "em_iterations": details["em_iterations"], "peak_run_gb": peak / 1e9,
        "peak_gb_by_phase_end": {k: v / 1e9 for k, v in details["peak_bytes"].items()},
        "descriptor_stacks_gb": stacks / 1e9, "fv_cache_gb": IN_OOC_TRAIN * IN_FV * 4 / 1e9,
        "peak_limit_gb": IN_OOC_PEAK_LIMIT / 1e9,
        "middle_chunk_bit_equal_across_scans": same_chunk})
    check(len(train_scans) == 3, f"featurize scans of the training chunks: {train_scans}, want "
          "2 sampling scans and 1 cache scan")
    check(details["descriptors"] == {"sift": IN_SIFT, "lcs": IN_LCS},
          f"descriptors per image {details['descriptors']}")
    check(details["fv_width"] == IN_FV, f"FV width {details['fv_width']}, want {IN_FV}")
    check(details["solver_route"] == "in_memory" and details["solver_path"] == "dense",
          f"the 336 MB of FVs took the {details['solver_route']} {details['solver_path']} route")
    check(peak < IN_OOC_PEAK_LIMIT, f"peak memory {peak} B is not below {IN_OOC_PEAK_LIMIT} B")
    check(top5_err < IN_TOP5_LIMIT, f"top-5 error {top5_err} % is not below {IN_TOP5_LIMIT} %")
    check(same_chunk, "a training chunk drawn in two scans differs")
    weighted_solve_check(fitted, train, tr_l, te_i, details["scores"], conf, "out_of_core", card)
    del fitted, details, train, test, te_i, seen

    # -- wls_stream_full_n: the weighted solver at ImageNet's training count
    name, t0 = start("wls_stream_full_n")
    w, lam = 0.25, 6e-5
    means = planted_means(dev, WLS_D, WLS_K, 40)
    labels, rows = planted_rows(dev, means, WLS_N, WLS_CHUNK, 41)
    Y = ClassLabelIndicators(WLS_K).forward(labels)
    t_labels = clock() - t0
    C = class_chunk_size(WLS_K, WLS_D, 8)
    want_scans = 1 * 1 * (1 + math.ceil(WLS_K / C))
    est = BlockWeightedLeastSquaresEstimator(WLS_D, 1, lam, w)
    timing.reset()
    timing.enable()
    try:
        t1 = clock()
        mapper = est.fit(rows, Dataset.of(Y))
        fit_seconds = clock() - t1
    finally:
        timing.enable(False)
    solver_phases = timing.snapshot("wls.")
    peak = torch.cuda.max_memory_allocated()
    test_labels, test_rows = planted_rows(dev, means, WLS_TEST, WLS_TEST, 42)
    Xt = test_rows.to_array()
    scores = mapper.forward(Xt)
    accuracy = (scores.argmax(1) == test_labels).double().mean().item()
    oracle = ((Xt @ means.T - 0.5 * (means * means).sum(1)).argmax(1)
              == test_labels).double().mean().item()
    agreement, deviation, f64_seconds = planted_solve_check(rows, labels, WLS_CHUNK, w, lam, Xt,
                                                            scores)
    info = mapper.fit_info
    finish(name, t0, {
        "n": WLS_N, "d": WLS_D, "k": WLS_K, "chunk_rows": WLS_CHUNK, "lambda": lam,
        "mixture_weight": w, "separation": WLS_SEPARATION,
        "design_matrix_gb": WLS_N * WLS_D * 4 / 1e9,
        "labels_seconds": t_labels, "fit_seconds": fit_seconds, "solver_phases": solver_phases,
        "class_chunk": C, "scans": info.get("scans"), "scans_expected": want_scans,
        "class_chunks": info.get("class_chunks"), "peak_fit_gb": peak / 1e9,
        "test_rows": WLS_TEST, "test_accuracy": accuracy, "accuracy_limit": WLS_ACCURACY_LIMIT,
        "nearest_true_mean_accuracy": oracle, "f64_check_classes": SOLVE_CHECK_CLASSES,
        "f64_argmax_agreement": agreement, "agreement_limit": SOLVE_CHECK_AGREEMENT,
        "f64_max_rel_dev": deviation, "deviation_limit": WLS_DEV_LIMIT,
        "f64_seconds": f64_seconds})
    check(info.get("scans") == want_scans, f"{info.get('scans')} scans, want {want_scans}")
    check(agreement >= SOLVE_CHECK_AGREEMENT,
          f"argmax agreement {agreement} with the float64 per-class solve")
    check(deviation <= WLS_DEV_LIMIT,
          f"scores {deviation} (relative) off the float64 per-class solve")
    check(accuracy >= WLS_ACCURACY_LIMIT, f"held-out accuracy {accuracy} of the planted model")
    del mapper, Y, labels, rows, scores, Xt

    # -- wls_stream_vs_memory: the same draw at 100,000 rows, both routes
    name, t0 = start("wls_stream_vs_memory")
    labels, rows = planted_rows(dev, means, WLS_MEMORY_ROWS, WLS_CHUNK, 43)
    Y = ClassLabelIndicators(WLS_K).forward(labels)
    test_labels, test_rows = planted_rows(dev, means, WLS_TEST, WLS_TEST, 44)
    Xt = test_rows.to_array()
    secs, preds, infos = {}, {}, {}
    for route, budget in (("streamed", "1"), ("in_memory", None)):
        fresh_env()
        t1 = clock()
        mapper = with_env("KEYSTONE_CHUNK_CACHE_BUDGET", budget,
                          lambda: est.fit(rows, Dataset.of(Y)))
        secs[route] = clock() - t1
        preds[route], infos[route] = mapper.forward(Xt), mapper.fit_info
        del mapper
    excess = ((preds["streamed"] - preds["in_memory"]).abs()
              - (5e-4 + 5e-3 * preds["in_memory"].abs())).max().item()
    accuracy = {r: (p.argmax(1) == test_labels).double().mean().item() for r, p in preds.items()}
    finish(name, t0, {
        "n": WLS_MEMORY_ROWS, "d": WLS_D, "k": WLS_K, "fit_seconds": secs,
        "scans": {r: i.get("scans", 0) for r, i in infos.items()},
        "tolerance": {"rtol": 5e-3, "atol": 5e-4}, "tolerance_excess": excess,
        "test_accuracy": accuracy})
    check("scans" in infos["streamed"] and "scans" not in infos["in_memory"],
          f"routes: {infos}")
    check(excess <= 0, f"streamed predictions off the in-memory ones beyond tolerance ({excess})")
    del Y, labels, rows, preds, Xt, means
    return launches


# the card-drawn MNIST sources (slice 12) through BASELINE's configuration,
# bench.py's two gates (`bench.py:953-990`); the warm-started BCD λ grid at
# the CLI's 200 FFTs (d 102,400) on those rows, λ around the CLI's 1000
MNIST_DEVICE_ROWS, MNIST_DEVICE_FFTS, MNIST_BLOCK, MNIST_LAMBDA = (60000, 10000), 4, 2048, 1000.0
LINEAR_TASK_LAMBDA = 10.0
BCD_LAMBDAS = (100.0, 1000.0, 10000.0)
BCD_WARM_LIMIT = 1.02  # a warm member's objective against a cold fit's (the JAX test's)


# The scan lanes: the streamed BCD over the planted stream at
# TIMIT's out-of-core width (d 16,384 in blocks of 4096, 147 classes) on a
# mesh of 4 slots of the card, at lanes 1, 2 and 4; 12 chunks of 65,536 rows
# (34 in block_stream_full_n: the lanes' fits take their seconds from depth).
# The chunks are drawn on the card, so nothing is staged; the doubling check
# stages host chunks of the same width, 8 of 4096 rows against 16 of 2048.
LANES = dict(d=16384, block=4096, k=147, rows=OOC_CHUNK, chunks=12, slots=4,
             counts=(1, 2, 4), rel_limit=1e-5, host_rows=4096, host_chunks=8)
# the other laned fits at lanes 4 against 1, at a reduced depth: 8 chunks
# of 16,384 rows of a planted problem 1024 wide, 32 classes for the weighted
# solve (its LU solves at λ 1e-2 amplify the reordered sums: 1e-4)
LANES_FAMILY = dict(d=1024, k=32, rows=16384, chunks=8, block=512, rel_limit=1e-5,
                    wls_rel_limit=1e-4)


def lanes_phases(dev, card) -> dict:
    """``lanes_timit``: the streamed BCD at lanes 1, 2 and 4 over a mesh of
    4 slots of the card, the laned fits held to the one-lane fit (1e-5
    relative) and to the analytic model-error band, each scan's collectives
    within 2·lanes + 2·(lanes − 1) and unchanged when the chunks double, the
    scan spans' lane attributes; seconds a scan, peak memory and the lanes'
    imbalance at each lane count. ``lanes_family``: normal equations,
    streaming TSQR, StandardScaler and the weighted solve at lanes 4 against
    1. ``lanes_devices``: the laned fit over the card and the host
    (:func:`lanes_devices`). Returns the K1 launches of each path (none
    reaches K1)."""
    import numpy as np

    from keystone_tpu_torch.data.chunked import ChunkedDataset
    from keystone_tpu_torch.linalg import bcd, normal_equations, tsqr, weighted
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.obs import SCAN_LANE_SPAN, SCAN_SPAN
    from keystone_tpu_torch.obs import tracer as trace_mod
    from keystone_tpu_torch.parallel import make_mesh, use_mesh, virtual_slots
    from keystone_tpu_torch.workflow.pipeline import clock

    start, finish, launches = phase_group(card)
    mesh = make_mesh(devices=virtual_slots(LANES["slots"], dev))

    def traced(fn):
        """(fn()'s result, the scan spans and lane spans it recorded)."""
        tracer = trace_mod.install(trace_mod.Tracer())
        try:
            with use_mesh(mesh):
                out = fn()
        finally:
            trace_mod.reset()
        return (out, [sp.attrs for sp in tracer.spans() if sp.name == SCAN_SPAN],
                [sp.attrs for sp in tracer.spans() if sp.name == SCAN_LANE_SPAN])

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    # -- lanes_timit ---------------------------------------------------------
    name, t0 = start("lanes_timit")
    d, bs, k, rows, n_chunks = (LANES[key] for key in ("d", "block", "k", "rows", "chunks"))
    n = rows * n_chunks
    w_star, feat, labels_of = planted_stream(dev, rows, d, k, 37)
    y = torch.cat([labels_of(i, feat(i)) for i in range(n_chunks)])
    zeros = torch.zeros(d, device=dev)
    analytic = STREAM_SIGMA * (d / (n - d)) ** 0.5
    ds = ChunkedDataset.from_chunk_fn(feat, n_chunks, n, label="planted")
    W, runs = {}, {}
    for lanes in LANES["counts"]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def fit():
            t1 = clock()
            ws = bcd.solve_blockwise_l2_streaming(ds.raw_chunks, y, STREAM_LAMBDA, bs, 1,
                                                  means=zeros, lanes=lanes)
            return torch.cat(ws), clock() - t1

        (W[lanes], secs), spans, lane_spans = traced(fit)
        spans = [a for a in spans if a["label"] == "bcd.stream"]
        lane_chunks = [a.get("lane_chunks", [a["chunks"]]) for a in spans]
        runs[lanes] = {
            "seconds": secs, "seconds_per_scan": secs / max(len(spans), 1),
            "scans": len(spans), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "collectives": [a.get("collectives", 0) for a in spans],
            "lane_chunks": lane_chunks[0] if lane_chunks else [],
            "lane_bytes": spans[0].get("lane_bytes", []) if spans else [],
            # the chunks are made on the card, so no bytes are staged and the
            # span has no lane_imbalance: the same max over mean, of chunks
            "lane_imbalance_chunks": (max(lane_chunks[0]) * len(lane_chunks[0])
                                      / sum(lane_chunks[0])) if lane_chunks else None,
            "lane_spans": len(lane_spans),
            "model_rel_err": (torch.linalg.norm(W[lanes] - w_star)
                              / torch.linalg.norm(w_star)).item()}
        emit({"phase": "lanes_timit_run", "lanes": lanes, "slots": LANES["slots"],
              "seconds_per_scan": runs[lanes]["seconds_per_scan"],
              "peak_mem_gb": runs[lanes]["peak_mem_gb"],
              "lane_imbalance_chunks": runs[lanes]["lane_imbalance_chunks"], "card": card})
    for lanes in LANES["counts"]:
        r = runs[lanes]
        check(r["scans"] == d // bs, f"{r['scans']} scans at lanes {lanes}")
        check(0.5 * analytic < r["model_rel_err"] < 2.0 * analytic,
              f"model error {r['model_rel_err']} at lanes {lanes} outside [0.5, 2] × the "
              f"analytic {analytic}")
        if lanes > 1:
            r["rel_to_one_lane"] = rel(W[lanes], W[1])
            check(r["rel_to_one_lane"] <= LANES["rel_limit"],
                  f"W at lanes {lanes} {r['rel_to_one_lane']} relative off one lane's")
            check(all(0 < c <= 2 * lanes + 2 * (lanes - 1) for c in r["collectives"]),
                  f"collectives {r['collectives']} at lanes {lanes}")
            check(r["lane_spans"] == lanes * r["scans"], f"{r['lane_spans']} lane spans")
            check(sum(r["lane_chunks"]) == n_chunks and len(r["lane_chunks"]) == lanes,
                  f"lane chunks {r['lane_chunks']} at lanes {lanes}")
        else:
            check(all(c == 0 for c in r["collectives"]), f"one lane counted {r['collectives']}")
    del W, y, ds, w_star
    # the doubling check: host chunks, so the lanes stage bytes and the
    # span carries lane_imbalance; the collectives must not change
    hr, hn = LANES["host_rows"], LANES["host_chunks"]
    gen = torch.Generator(dev).manual_seed(41)
    host = torch.randn(hr * hn, d, device=dev, generator=gen).cpu().numpy()
    yh = torch.randn(hr * hn, k, device=dev, generator=gen)
    doubling = {}
    for rows_h in (hr, hr // 2):
        def fit_host(rows_h=rows_h):
            return bcd.solve_blockwise_l2_streaming(
                lambda: iter([host[i:i + rows_h] for i in range(0, len(host), rows_h)]), yh,
                STREAM_LAMBDA, bs, 1, means=zeros, lanes=4)

        _, spans, _ = traced(fit_host)
        spans = [a for a in spans if a["label"] == "bcd.stream"]
        doubling[len(host) // rows_h] = {
            "collectives": [a["collectives"] for a in spans],
            "lane_chunks": spans[0]["lane_chunks"], "lane_bytes": spans[0]["lane_bytes"],
            "lane_imbalance": spans[0].get("lane_imbalance"),
            "attrs": sorted(spans[0])}
    del host, yh
    coarse, fine = doubling[hn], doubling[2 * hn]
    emit({"phase": "lanes_timit_imbalance", "lanes": 4, "chunks": [hn, 2 * hn],
          "lane_imbalance": [coarse["lane_imbalance"], fine["lane_imbalance"]],
          "lane_bytes": coarse["lane_bytes"], "card": card})
    finish(name, t0, {
        "d": d, "block_size": bs, "k": k, "rows": n, "chunks": n_chunks,
        "slots": LANES["slots"], "model_rel_err_analytic": analytic,
        "runs": {str(l): r for l, r in runs.items()}, "doubling": {str(c): v for c, v in
                                                                    doubling.items()}})
    check(coarse["collectives"] == fine["collectives"] and len(coarse["collectives"]) == d // bs,
          f"collectives {coarse['collectives']} with {hn} chunks, {fine['collectives']} with "
          f"{2 * hn}")
    for key in ("lanes", "collectives", "lane_chunks", "lane_bytes", "devices", "lane_imbalance"):
        check(key in coarse["attrs"], f"the laned scan's span has no {key}")

    # -- lanes_family ----------------------------------------------------------
    name, t0 = start("lanes_family")
    d, k, rows, n_chunks, bs = (LANES_FAMILY[key] for key in ("d", "k", "rows", "chunks", "block"))
    n = rows * n_chunks
    w_star, feat, labels_of = planted_stream(dev, rows, d, k, 43)

    def pair(i):
        A = feat(i)
        return A, labels_of(i, A)

    pairs = ChunkedDataset.from_chunk_fn(pair, n_chunks, n, label="planted")
    raw = ChunkedDataset.from_chunk_fn(feat, n_chunks, n, label="planted")
    scores = torch.cat([feat(i) @ w_star for i in range(n_chunks)])
    Y = -torch.ones(n, k, device=dev)
    Y[torch.arange(n, device=dev), scores.argmax(dim=1)] = 1.0
    del scores
    fits, seconds, colls = {}, {}, {}
    for lanes in (1, 4):
        def family(lanes=lanes):
            out = {}
            t1 = clock()
            out["normal_eq"] = normal_equations.solve_least_squares_streaming(
                pairs.raw_chunks(), reg=STREAM_LAMBDA, device=dev, lanes=lanes)
            out["tsqr"] = tsqr.tsqr_r_streaming(raw.raw_chunks, lanes=lanes)
            scaler = with_env("KEYSTONE_SCAN_LANES", str(lanes),
                              lambda: StandardScaler().fit(raw))
            out["scaler_mean"], out["scaler_std"] = scaler.mean, scaler.std
            out["weighted"] = torch.cat(weighted.solve_weighted_streaming(
                raw.raw_chunks, Y, block_size=bs, num_iter=1, lam=STREAM_LAMBDA,
                mixture_weight=0.25, lanes=lanes)[0])
            return out, clock() - t1

        (fits[lanes], seconds[lanes]), spans, _ = traced(family)
        colls[lanes] = {}
        for a in spans:
            colls[lanes].setdefault(a["label"], []).append(a.get("collectives", 0))
    devs = {key: rel(fits[4][key], fits[1][key]) for key in fits[1]}
    finish(name, t0, {"d": d, "k": k, "rows": n, "chunks": n_chunks, "block_size": bs,
                      "seconds": {str(l): s for l, s in seconds.items()},
                      "rel_to_one_lane": devs,
                      "collectives": {str(l): c for l, c in colls.items()}})
    for key, dev_ in devs.items():
        limit = LANES_FAMILY["wls_rel_limit" if key == "weighted" else "rel_limit"]
        check(dev_ <= limit, f"{key} at lanes 4 {dev_} relative off one lane's (limit {limit})")
    check(colls[4].get("normal_eq") == [6] and colls[4].get("tsqr") == [3],
          f"collectives at lanes 4 {colls[4]}")
    check(all(c == 0 for cs in colls[1].values() for c in cs), f"one lane counted {colls[1]}")
    del fits, pairs, raw, Y, w_star
    return {"lanes_timit": launches["lanes_timit"], "lanes_family": launches["lanes_family"],
            **lanes_devices(card, [dev, "cpu"], "lanes_devices")}


# the laned fit over two physical devices, at a reduced depth: 8 chunks of
# 8,192 rows of the planted problem 1024 wide (lanes_family's width)
LANES_DEVICES = dict(d=1024, k=32, rows=8192, chunks=8, rel_limit=1e-5)


class PairProjection:
    """A featurizer step of (rows, labels) chunks: the rows times a
    projection matrix, which lives on the card; a laned scan's lane on
    another device runs a copy of the step whose matrix is there."""

    def __init__(self, P):
        self.P = P

    def __call__(self, pair):
        A, y = pair
        return A @ self.P, y


def lanes_devices(card, devices, name) -> dict:
    """``lanes_devices`` (under ``name``): the streamed normal equations
    over a mesh of one slot on each of ``devices``, lanes = their count.
    The planted stream's chunks are drawn on the card and pass a
    ``PairProjection`` step whose matrix is on ``cuda:0``: W within 1e-5
    relative (max |ΔW| / max |W|) of the one-lane fit on the card, each
    lane's steps run on its lane's device (the scan span's
    ``step_devices``), the collectives within ``lanes_timit``'s bound of
    2·lanes + 2·(lanes − 1), the card's step untouched. Returns its K1
    launches (none)."""
    from keystone_tpu_torch.data.chunked import ChunkedDataset
    from keystone_tpu_torch.linalg import normal_equations
    from keystone_tpu_torch.obs import SCAN_LANE_SPAN, SCAN_SPAN
    from keystone_tpu_torch.obs import tracer as trace_mod
    from keystone_tpu_torch.parallel import make_mesh, use_mesh
    from keystone_tpu_torch.parallel.mesh import physical
    from keystone_tpu_torch.workflow.pipeline import clock

    start, finish, launches = phase_group(card)
    name, t0 = start(name)
    dev = torch.device("cuda", 0)
    d, k, rows, n_chunks = (LANES_DEVICES[key] for key in ("d", "k", "rows", "chunks"))
    w_star, feat, labels_of = planted_stream(dev, rows, d, k, 47)
    gen = torch.Generator(dev).manual_seed(53)
    P = torch.eye(d, device=dev) + 0.1 * torch.randn(d, d, device=dev, generator=gen) / d ** 0.5
    step = PairProjection(P)

    def pair(i):
        A = feat(i)
        return A, labels_of(i, A)

    ds = ChunkedDataset.from_chunk_fn(pair, n_chunks, rows * n_chunks,
                                      label="planted").map_batch(step)
    t1 = clock()
    one = normal_equations.solve_least_squares_streaming(ds.raw_chunks(), reg=STREAM_LAMBDA,
                                                         device=dev, lanes=1)
    one_seconds = clock() - t1
    lanes = len(devices)
    tracer = trace_mod.install(trace_mod.Tracer())
    try:
        with use_mesh(make_mesh(devices=devices)):
            t1 = clock()
            laned = normal_equations.solve_least_squares_streaming(
                ds.raw_chunks(), reg=STREAM_LAMBDA, lanes=lanes)
            laned_seconds = clock() - t1
    finally:
        trace_mod.reset()
    (span,) = [sp.attrs for sp in tracer.spans()
               if sp.name == SCAN_SPAN and sp.attrs["label"] == "normal_eq"]
    lane_spans = [sp.attrs for sp in tracer.spans() if sp.name == SCAN_LANE_SPAN]
    rel = ((laned.to(dev) - one).abs().max() / one.abs().max()).item()
    want = [str(physical(x)) for x in devices]
    finish(name, t0, {
        "devices": want, "d": d, "k": k, "rows": rows * n_chunks, "chunks": n_chunks,
        "reduced": "8 chunks of 8,192 rows, lanes_family's width d 1024",
        "rel_to_one_lane": rel, "rel_limit": LANES_DEVICES["rel_limit"],
        "one_lane_seconds": one_seconds, "laned_seconds": laned_seconds,
        "lanes": span.get("lanes"), "devices_of_lanes": span.get("devices"),
        "step_devices": span.get("step_devices"),
        "lane_step_device": [a.get("step_device") for a in lane_spans],
        "lane_chunks": span.get("lane_chunks"), "lane_bytes": span.get("lane_bytes"),
        "collectives": span.get("collectives")})
    check(rel <= LANES_DEVICES["rel_limit"],
          f"W over {want} {rel} relative off the one-lane fit on the card")
    check(span.get("step_devices") == want
          and [a.get("step_device") for a in lane_spans] == want,
          f"lanes' steps ran on {span.get('step_devices')}, want {want}")
    check(0 < span.get("collectives", 0) <= 2 * lanes + 2 * (lanes - 1),
          f"collectives {span.get('collectives')} over {lanes} lanes")
    check(step.P is P and P.device == dev, "the card's step was changed")
    return {name: launches[name]}


# the card tests of the out-of-core scan, the weighted fit, the faults, the
# tracer, the serving tiers, the trainer and the stall model served eagerly
# on the card by a cluster worker: one pytest process, which reaches the
# card once
CARD_TEST_FILES = ("tests/test_torch_cuda_streaming.py",
                   "tests/test_torch_cuda_segment.py",
                   "tests/test_torch_cuda_weighted_streaming.py",
                   "tests/test_torch_cuda_faults.py",
                   "tests/test_torch_cuda_obs.py",
                   "tests/test_torch_cuda_check.py",
                   "tests/test_torch_cuda_serving.py",
                   "tests/test_torch_cuda_fleet.py",
                   "tests/test_torch_cuda_fleet_devices.py",
                   "tests/test_torch_cuda_aot.py",
                   "tests/test_torch_cuda_trainer.py",
                   "tests/test_torch_cuda_cluster.py::test_b_the_stall_survives_on_the_card")


def card_tests() -> None:
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
         *CARD_TEST_FILES], capture_output=True, text=True, timeout=900)
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    emit({"phase": "cuda_card_tests", "files": CARD_TEST_FILES, "returncode": proc.returncode,
          "summary": summary, "seconds": time.perf_counter() - t1})
    check(proc.returncode == 0 and "passed" in summary and "skipped" not in summary,
          f"the card tests: {proc.stdout[-4000:]}{proc.stderr[-2000:]}")


def ridge_objective(model, X, Y, lam: float, rows: int = 5000) -> float:
    """‖model(X) − Y‖² + λ‖W‖² in float64, the rows in chunks (the model
    centers a copy of what it is given)."""
    total = 0.0
    for i in range(0, X.shape[0], rows):
        total += ((model.forward(X[i:i + rows]) - Y[i:i + rows]).double() ** 2).sum().item()
    return total + lam * (model._W.double() ** 2).sum().item()


def mnist_device_phases(dev, card) -> dict:
    """The card-drawn MNIST sources through MnistRandomFFT at BASELINE's 4
    FFTs and the exact ridge on the linear task, against their card
    Monte-Carlo Bayes errors; the warm-started BCD λ grid at 200 FFTs on
    those rows against cold fits. Returns the K1 launches of each path
    (none reaches K1)."""
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.linalg import bcd
    from keystone_tpu_torch.nodes.learning.linear import (
        BlockLeastSquaresEstimator, LinearMapEstimator,
    )
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators
    from keystone_tpu_torch.pipelines import mnist_random_fft as mnist
    from keystone_tpu_torch.workflow.pipeline import clock

    start, finish, launches = phase_group(card)

    # -- mnist_device: the task drawn on the card, bench.py's two gates --
    name, t0 = start("mnist_device")
    t1 = clock()
    train, test = mnist.synthetic_mnist_device(*MNIST_DEVICE_ROWS, seed=mnist.DATA_SEED,
                                               device=dev)
    draw_seconds = clock() - t1
    t1 = clock()
    bayes = mnist.bayes_error_mc_device(mnist.DATA_SEED, device=dev)
    bayes_seconds = clock() - t1
    X, Xt = train.data.to_array(), test.data.to_array()
    # what fit_and_score does with them: no copy from the host
    on_card = (X.is_cuda and Xt.is_cuda and X.to(dev, torch.float32).data_ptr() == X.data_ptr()
               and Xt.to(dev, torch.float32).data_ptr() == Xt.data_ptr())
    conf = mnist.MnistRandomFFTConfig(num_ffts=MNIST_DEVICE_FFTS, block_size=MNIST_BLOCK,
                                      lam=MNIST_LAMBDA)
    phases = {}
    _, tr_err, te_err, run_seconds = mnist.run(train, test, conf, dev, phases)
    t1 = clock()
    ltrain, ltest, lbayes = mnist.linear_task_device(*MNIST_DEVICE_ROWS, seed=mnist.DATA_SEED,
                                                     device=dev)
    linear_draw_seconds = clock() - t1
    Y = ClassLabelIndicators(mnist.NUM_CLASSES).forward(ltrain.labels.to_array().to(dev))
    model = LinearMapEstimator(LINEAR_TASK_LAMBDA).fit(ltrain.data, Dataset.of(Y))
    pred = model.forward(ltest.data.to_array()).argmax(dim=1).cpu()
    lin_err = (pred != ltest.labels.to_array().long()).float().mean().item()
    finish(name, t0, {
        "rows": MNIST_DEVICE_ROWS, "num_ffts": MNIST_DEVICE_FFTS, "draw_seconds": draw_seconds,
        "bayes_seconds": bayes_seconds, "features_on_card_no_host_copy": on_card,
        "train_error": tr_err, "test_error": te_err, "bayes_error": bayes,
        "limit": 1.5 * bayes + 0.005, "run_seconds": run_seconds, "phase_seconds": phases,
        "linear_task": {"draw_seconds": linear_draw_seconds, "bayes_error": lbayes,
                        "exact_ridge_error": lin_err, "lambda": LINEAR_TASK_LAMBDA,
                        "band": [lbayes - 0.005, 1.3 * lbayes + 0.005]}})
    check(on_card, "the card-drawn rows were copied")
    check(te_err <= 1.5 * bayes + 0.005,
          f"test error {te_err} above 1.5 × the Bayes error {bayes} + 0.005")
    check(lbayes - 0.005 <= lin_err <= 1.3 * lbayes + 0.005,
          f"the exact ridge's error {lin_err} outside [Bayes − 0.005, 1.3 × Bayes + 0.005] "
          f"of the linear task (Bayes {lbayes})")
    del ltrain, ltest, model, Y, pred

    # -- bcd_lambda_grid: warm-started members against cold fits ---------
    name, t0 = start("bcd_lambda_grid")
    t1 = clock()
    feats = mnist.build_featurizer(mnist.MnistRandomFFTConfig(num_ffts=MNIST_FULL_FFTS),
                                   dev).apply(X).get().to_array()
    featurize_seconds = clock() - t1
    Y = ClassLabelIndicators(mnist.NUM_CLASSES).forward(train.labels.to_array().to(dev))
    del train, test, X, Xt
    members_log, orig_fit = [], BlockLeastSquaresEstimator.fit

    def logged_fit(est, data, labels):
        warm, steps0, t2 = est.warm_start_ws is not None, bcd._block_update_impl.steps, clock()
        out = orig_fit(est, data, labels)
        members_log.append({"lambda": est.lam, "warm": warm, "seconds": clock() - t2,
                            "block_steps": bcd._block_update_impl.steps - steps0})
        return out

    BlockLeastSquaresEstimator.fit = logged_fit
    try:
        members = BlockLeastSquaresEstimator.fit_lambda_grid(
            [BlockLeastSquaresEstimator(MNIST_BLOCK, 1, lam) for lam in BCD_LAMBDAS],
            Dataset.of(feats), Dataset.of(Y))
        grid_log, members_log = members_log, []
        colds = [BlockLeastSquaresEstimator(MNIST_BLOCK, 1, lam).fit(Dataset.of(feats),
                                                                     Dataset.of(Y))
                 for lam in BCD_LAMBDAS]
    finally:
        BlockLeastSquaresEstimator.fit = orig_fit
    objectives = {lam: {"warm": ridge_objective(m, feats, Y, lam),
                        "cold": ridge_objective(c, feats, Y, lam)}
                  for lam, m, c in zip(BCD_LAMBDAS, members, colds)}
    finish(name, t0, {
        "rows": int(feats.shape[0]), "d": int(feats.shape[1]), "block_size": MNIST_BLOCK,
        "featurize_seconds": featurize_seconds, "members": grid_log, "cold_fits": members_log,
        "objectives": objectives, "limit": BCD_WARM_LIMIT})
    check([m["warm"] for m in grid_log] == [False, True, True],
          f"the grid's warm starts: {grid_log}")
    check(all(m["block_steps"] == MNIST_FULL_STEPS for m in grid_log + members_log),
          f"block steps of the fits: {grid_log + members_log}")
    check(all(o["warm"] <= BCD_WARM_LIMIT * o["cold"] for o in objectives.values()),
          f"a warm member's objective above {BCD_WARM_LIMIT} × the cold fit's: {objectives}")
    del feats, Y, members, colds
    return launches


# The observe-and-learn loop (slice 13): the CIFAR kernel and the 200-FFT
# MNIST applications auto-cached under a profile store, traced through the
# command line, and λ grids as one merged DAG
MNIST_SMALL_BUDGET = 8 << 30
HOST_BUDGET = 4 << 30  # the auto-cache budget off the card
MNIST_TRAIN_ROWS = 60000  # the command line's training rows
SWEEP_BCD_LAMBDAS = (1e2, 1e3, 1e4)
# sweep_mnist's training rows (60,000 until the lanes' phases needed the time
# limit's room; its gates are bit-equality with the members' own fits)
SWEEP_MNIST_ROWS = 30000
SWEEP_TIMIT_LAMBDAS = (1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 1.0)  # bench.py's G_LAMS (:3278)
SWEEP_TIMIT_LIMIT = 1e-6  # a member's W against its independent fit, relative to its largest


class K1Shapes:
    """While entered: K1's calls by (n, d, b) outside the auto-cache
    profiler's sampled pulls and inside them, and the K1 launches and BCD
    block steps those pulls made (the wrapped functions restored on exit).
    A call inside a CUDA-graph capture launches nothing and is not
    counted."""

    def __enter__(self) -> "K1Shapes":
        from keystone_tpu_torch.linalg import bcd
        from keystone_tpu_torch.nodes.learning import kernel
        from keystone_tpu_torch.ops import gaussian_kernel as gk
        from keystone_tpu_torch.workflow import autocache

        self.shapes, self.profiler_shapes = Counter(), Counter()
        self.profiler_launches = self.profiler_steps = self._inside = 0
        k1, profile, log = kernel._gaussian_block, autocache._profile_at_scale, self

        def counted_k1(X, Xb, gamma):
            if not torch.cuda.is_current_stream_capturing():
                shape = (int(X.shape[0]), int(X.shape[1]), int(Xb.shape[0]))
                (log.profiler_shapes if log._inside else log.shapes)[shape] += 1
            return k1(X, Xb, gamma)

        def counted_profile(graph, size):
            l0, s0 = gk.gaussian_kernel_block.launches, bcd._block_update_impl.steps
            log._inside += 1
            try:
                return profile(graph, size)
            finally:
                log._inside -= 1
                log.profiler_launches += gk.gaussian_kernel_block.launches - l0
                log.profiler_steps += bcd._block_update_impl.steps - s0

        self._undo = [(kernel, "_gaussian_block", k1),
                      (autocache, "_profile_at_scale", profile)]
        kernel._gaussian_block, autocache._profile_at_scale = counted_k1, counted_profile
        return self

    def __exit__(self, *exc) -> None:
        for mod, name, orig in self._undo:
            setattr(mod, name, orig)

    def as_dict(self) -> dict:
        return {"by_shape": sorted([list(k), v] for k, v in self.shapes.items()),
                "profiler_by_shape": sorted([list(k), v] for k, v in self.profiler_shapes.items()),
                "profiler_launches": self.profiler_launches,
                "profiler_block_steps": self.profiler_steps}


class SweepLog:
    """While entered: the full-size runs of a ``cls`` node (a result of
    ``rows`` rows from its ``batch_transform``, or a dispatched segment
    holding it run on ``rows`` rows; with ``keep``, the first one's result
    is kept, and its memory with it), and each BlockLeastSquaresEstimator fit's λ,
    warm start and block steps, the steps counted on the fit's own thread
    (a sweep's fits overlap)."""

    def __init__(self, cls, rows: int, keep: bool = False):
        self.cls, self.rows, self.keep = cls, rows, keep

    def __enter__(self) -> "SweepLog":
        from keystone_tpu_torch.compile.segment import SegmentBinding
        from keystone_tpu_torch.linalg import bcd
        from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator

        self.featurized, self.features, self.fits = 0, None, []
        local, lock, log = threading.local(), threading.Lock(), self
        step, fit, bt, seg_run = (bcd._block_update_impl, BlockLeastSquaresEstimator.fit,
                                  self.cls.batch_transform, SegmentBinding.run)

        def counted_step(*args, **kwargs):
            local.steps = getattr(local, "steps", 0) + 1
            return step(*args, **kwargs)

        # the step adds to its own global name's counter: keep one there
        counted_step.steps = step.steps

        def logged_fit(est, data, labels):
            warm = est.warm_start_ws is not None
            local.steps = 0
            out = fit(est, data, labels)
            with lock:
                log.fits.append({"lambda": est.lam, "warm": warm, "block_steps": local.steps})
            return out

        def counted_bt(op, inputs):
            out = bt(op, inputs)
            if len(out) == log.rows:
                with lock:
                    log.featurized += 1
                    if log.keep and log.features is None:
                        log.features = out
            return out

        def counted_segment(binding, datasets):
            # a segment runs its members without their batch_transform (its
            # fallback path calls it, and is counted there)
            outs, path = seg_run(binding, datasets)
            if (path != "fallback" and datasets and len(datasets[0]) == log.rows
                    and any(isinstance(op, log.cls) for op, _ in binding.steps)):
                with lock:
                    log.featurized += 1
                    if log.keep and log.features is None and len(binding.steps) == 1:
                        log.features = outs[0]
            return outs, path

        self._step, self._undo = (bcd, step, counted_step), [
            (BlockLeastSquaresEstimator, "fit", fit), (self.cls, "batch_transform", bt),
            (SegmentBinding, "run", seg_run)]
        bcd._block_update_impl = counted_step
        BlockLeastSquaresEstimator.fit = logged_fit
        self.cls.batch_transform = counted_bt
        SegmentBinding.run = counted_segment
        return self

    def __exit__(self, *exc) -> None:
        bcd, step, counted = self._step
        step.steps = counted.steps
        bcd._block_update_impl = step
        for cls, name, orig in self._undo:
            setattr(cls, name, orig)


def observe_phases(cli, dev, card, slice_ref, mnist_ref) -> dict:
    """The observe-and-learn loop: auto-cached fits planned from a profile
    store (CIFAR with K1, MNIST at 200 FFTs), the command line traced, and
    GridSweep over BCD at 200 FFTs and over a TIMIT Gram family. Returns
    the K1 launches of each path."""
    from keystone_tpu_torch import cost
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.linalg import bcd
    from keystone_tpu_torch.loaders.cifar import synthetic_cifar
    from keystone_tpu_torch.nodes.learning.linear import (
        BlockLeastSquaresEstimator, BlockLinearMapper, LinearMapEstimator, LinearMapper,
    )
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators, MaxClassifier
    from keystone_tpu_torch.obs import tracer as trace_mod
    from keystone_tpu_torch.obs.audit import cache_audit
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.pipelines import mnist_random_fft as mnist
    from keystone_tpu_torch.pipelines import timit
    from keystone_tpu_torch.sweep import GridSweep
    from keystone_tpu_torch.workflow import optimizers
    from keystone_tpu_torch.workflow.env import PipelineEnv
    from keystone_tpu_torch.workflow.fusion import FusedTransformerOperator
    from keystone_tpu_torch.workflow.optimizers import AutoCachingOptimizer
    from keystone_tpu_torch.workflow.pipeline import Pipeline, clock
    from keystone_tpu_torch.workflow.rules import RuleExecutor

    launches = {}
    store_root = tempfile.mkdtemp(prefix="profiles-")

    def learn_env(store_dir, optimizer):
        """A fresh environment with ``optimizer`` and the store read anew
        from disk."""
        fresh_env()
        cost.configure(store_dir)
        PipelineEnv.get_or_create().set_optimizer(optimizer)

    def budgets(store_dir):
        store = cost.ProfileStore(store_dir)
        return sorted({store.load(k).get("budget") for k in store.keys()
                       if k.startswith("plan/")} - {None})

    def cachers(tracer):
        return [{"label": r["label"], "est_bytes": r["est_bytes"], "obs_bytes": r["obs_bytes"],
                 "observed": r["observed"]} for r in cache_audit(tracer) if r["cacher"]]

    def traced_run(args):
        """``cli.run(args)`` under a tracer and K1's shape log; the tracer
        is removed after."""
        tracer = trace_mod.install(trace_mod.Tracer())
        t1 = clock()
        try:
            with K1Shapes() as k1:
                out = cli.run(args)
        finally:
            trace_mod.reset()
        return out, tracer, k1, clock() - t1

    # -- autocache_cifar: the kernel application auto-cached, twice -------
    Xt = synthetic_cifar(10000, seed=2).data.to_array().to(dev)  # the CLI's test set
    cifar_dir = os.path.join(store_root, "cifar")
    runs = {}
    for run in ("first", "second"):
        learn_env(cifar_dir, AutoCachingOptimizer())
        gk.gaussian_kernel_block.launches = 0
        out, tracer, k1, seconds = traced_run(SLICE_ARGS)
        total = gk.gaussian_kernel_block.launches
        sampling = cost.sampling_executions()
        audit = cache_audit(tracer)
        preds = out["scorer"].and_then(MaxClassifier())(Xt).get().to_array().cpu()
        runs[run] = {"app_seconds": out["seconds"], "phase_seconds": out["phases"],
                     "wall_seconds": seconds, "test_error": out["test_error"],
                     "k1_launches": total, "k1": k1.as_dict(), "sampling_executions": sampling,
                     "cachers": cachers(tracer), "budgets": budgets(cifar_dir),
                     "audit": [{k: r[k] for k in ("node", "label", "kind", "cacher",
                                                  "est_seconds", "obs_seconds", "seconds_ratio",
                                                  "est_bytes", "obs_bytes", "observed")}
                               for r in audit],
                     "memo": dict(optimizers.memo_stats),
                     "predictions": preds}
        launches[f"autocache_cifar_{run}"] = total
        del out, tracer
    first, second = runs["first"], runs["second"]
    equal = {run: bool(torch.equal(r.pop("predictions"), slice_ref["predictions"]))
             for run, r in runs.items()}
    emit({"phase": "autocache_cifar", "args": SLICE_ARGS, "runs": runs,
          "predictions_equal_default_optimizer": equal,
          "untraced_default_seconds": slice_ref["seconds"], "card": card})
    check(first["sampling_executions"]["total"] > 0, "the first auto-cached fit did not sample")
    by_shape = {tuple(k): v for k, v in first["k1"]["profiler_by_shape"]}
    check(by_shape == PROFILER_LAUNCHES
          and first["k1"]["profiler_launches"] == sum(PROFILER_LAUNCHES.values()),
          f"the first fit's profiler launched K1 {first['k1']['profiler_launches']} times, "
          f"by shape {by_shape}; want {PROFILER_LAUNCHES}")
    check(all(b > HOST_BUDGET for r in runs.values() for b in r["budgets"]),
          f"an auto-cached CIFAR plan under the host's budget: "
          f"{[r['budgets'] for r in runs.values()]}")
    check(first["k1_launches"] - first["k1"]["profiler_launches"] == SLICE_LAUNCHES,
          f"the first auto-cached run launched K1 {first['k1_launches']} times, "
          f"{first['k1']['profiler_launches']} in the profiler; want {SLICE_LAUNCHES} outside it")
    check(second["sampling_executions"]["total"] == 0,
          f"the second auto-cached fit sampled {second['sampling_executions']}")
    check(second["k1_launches"] == SLICE_LAUNCHES and second["k1"]["profiler_launches"] == 0,
          f"the second auto-cached run launched K1 {second['k1_launches']} times")
    check(all(equal.values()), f"auto-cached predictions differ from the default's: {equal}")
    check(all(r["test_error"] < 0.7 for r in runs.values()),
          f"auto-cached test errors {[r['test_error'] for r in runs.values()]}")

    # -- autocache_mnist: 200 FFTs at the card's budget, again, and at 8 GiB
    mnist_dir = os.path.join(store_root, "mnist")
    feature_bytes = MNIST_TRAIN_ROWS * MNIST_FULL_FFTS * 512 * 4
    _, mtest = mnist.synthetic_mnist(60000, 10000)  # the command line's data
    Xm = mtest.data.to_array().to(dev)
    runs = {}
    for run, budget in (("first", None), ("second", None), ("budget_8gib", MNIST_SMALL_BUDGET)):
        learn_env(mnist_dir, AutoCachingOptimizer("greedy", budget))
        bcd._block_update_impl.steps = 0
        gk.gaussian_kernel_block.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with SweepLog(FusedTransformerOperator, MNIST_TRAIN_ROWS) as featurize, \
                Probe() as probe:
            probe.watch_fit(Pipeline)
            probe.watch(RuleExecutor, "execute")
            out, tracer, k1, seconds = traced_run(MNIST_FULL)
            fit_graph = probe.last["RuleExecutor.execute:fit"][0]
        peak = torch.cuda.max_memory_allocated()
        steps = bcd._block_update_impl.steps
        launches[f"autocache_mnist_{run}"] = gk.gaussian_kernel_block.launches
        sampling = cost.sampling_executions()
        fitted = out["scorer"].and_then(MaxClassifier()).fit()
        preds = fitted.apply(Xm).to_array().cpu()
        graph_cachers = [type(op).__name__ for op in fit_graph.operators.values()
                         if type(op).__name__ == "Cacher"]
        runs[run] = {
            "budget": budget, "app_seconds": out["seconds"], "phase_seconds": out["phases"],
            "wall_seconds": seconds, "test_error": out["test_error"],
            "k1_launches": launches[f"autocache_mnist_{run}"],
            "block_steps": steps - k1.profiler_steps, "profiler_block_steps": k1.profiler_steps,
            "sampling_executions": sampling, "featurized_full_size": featurize.featurized,
            "cachers_planned": cachers(tracer), "budgets": budgets(mnist_dir),
            "cacher_nodes_after_fusion": len(graph_cachers),
            "fused_steps": [len(g) for g in fused_steps(fit_graph)],
            "peak_mem_gb": peak / 1e9, "peak_over_features": peak / feature_bytes,
            "memo": dict(optimizers.memo_stats),
            "predictions_equal_default_optimizer": bool(torch.equal(preds,
                                                                    mnist_ref["predictions"])),
        }
        del out, tracer, fitted, fit_graph, preds, featurize
    emit({"phase": "autocache_mnist", "args": MNIST_FULL, "feature_bytes": feature_bytes,
          "runs": runs, "untraced_default_seconds": mnist_ref["seconds"], "card": card})
    for run, r in runs.items():
        check(r["k1_launches"] == 0, f"{run}: the MNIST fit launched K1 {r['k1_launches']} times")
        check(r["block_steps"] == MNIST_FULL_STEPS,
              f"{run}: {r['block_steps']} BCD block steps outside the profiler, "
              f"want {MNIST_FULL_STEPS}")
        check(r["test_error"] < 0.35, f"{run}: test error {r['test_error']}")
        check(r["predictions_equal_default_optimizer"],
              f"{run}: predictions differ from the default optimizer's")
        check(r["peak_over_features"] < 1.5, f"{run}: peak {r['peak_mem_gb']} GB")
    check(runs["first"]["sampling_executions"]["total"] > 0, "the first MNIST fit did not sample")
    check(runs["second"]["sampling_executions"]["total"] == 0,
          f"the second MNIST fit sampled {runs['second']['sampling_executions']}")
    check(all(b > HOST_BUDGET for run in ("first", "second") for b in runs[run]["budgets"]),
          f"an MNIST plan at the card's budget under the host's: "
          f"{[runs[run]['budgets'] for run in ('first', 'second')]}")
    small = runs["budget_8gib"]
    check(small["budgets"] == [float(MNIST_SMALL_BUDGET)],
          f"the 8 GiB run planned under {small['budgets']}")
    check(all((c["est_bytes"] or 0) <= MNIST_SMALL_BUDGET for c in small["cachers_planned"])
          and sum(c["est_bytes"] or 0 for c in small["cachers_planned"]) <= MNIST_SMALL_BUDGET,
          f"a Cacher above the 8 GiB budget: {small['cachers_planned']}")
    check(small["featurized_full_size"] == 2,
          f"the 8 GiB run featurized the fit data {small['featurized_full_size']} times, want 2 "
          "(the fit and the train apply)")
    del Xm, mtest

    # -- traced_cifar: the command line with --trace and --profiles, twice
    trace_dir = tempfile.mkdtemp(prefix="traces-")
    traced_dir = os.path.join(store_root, "traced")
    runs = {}
    for run in ("first", "second"):
        fresh_env()
        gk.gaussian_kernel_block.launches = 0
        path = os.path.join(trace_dir, f"{run}.json")
        t1 = clock()
        out = cli.run(SLICE_ARGS + ["--trace", path, "--profiles", traced_dir])
        seconds = clock() - t1
        tracer = trace_mod.current()
        trace_mod.reset()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        nodes = [e for e in events if e["ph"] == "X" and "node" in e["args"]]
        # a dispatched segment's captures are counted in its exec.segment span
        segments = [e for e in events if e["ph"] == "X" and e["name"] == "exec.segment"]
        # K1 runs in the KRR fit and in the applies of its model, which the
        # application's lazy pulls make through delegating nodes
        k1_nodes = [e for e in nodes if e["args"].get("op_type") in
                    ("KernelRidgeRegression", "DelegatingOperator")]
        roots = [sp for sp in tracer.spans() if sp.name == "pipeline.fit"]
        runs[run] = {
            "app_seconds": out["seconds"], "phase_seconds": out["phases"],
            "wall_seconds": seconds, "test_error": out["test_error"],
            "k1_launches": gk.gaussian_kernel_block.launches,
            "sampling_executions": cost.sampling_executions(), "events": len(events),
            "node_spans": len(nodes), "fit_roots": len(roots),
            "fit_root_parentless": all(sp.parent_id is None for sp in roots),
            "node_spans_with_op_type": sum(1 for e in nodes if e["args"].get("op_type")),
            "node_spans_with_sync": sum(1 for e in nodes if e["args"].get("sync_ms")),
            "k1_node_spans": [{k: e["args"].get(k) for k in ("op_type", "cache", "sync_ms")}
                              for e in k1_nodes],
            "segment_paths": sorted(e["args"].get("path") for e in segments),
            "compiles": sum(e["args"].get("compiles", 0) for e in nodes + segments),
            "top_spans": {k: v["seconds"] for k, v in sorted(
                tracer.span_summary().items(), key=lambda kv: -kv[1]["seconds"])[:8]},
        }
        launches[f"traced_cifar_{run}"] = runs[run]["k1_launches"]
        del out, tracer, events
    emit({"phase": "traced_cifar", "args": SLICE_ARGS, "runs": runs,
          "untraced_seconds": slice_ref["seconds"], "card": card})
    for run, r in runs.items():
        check(r["fit_roots"] == 1 and r["fit_root_parentless"],
              f"{run}: {r['fit_roots']} pipeline.fit roots")
        check(r["node_spans"] > 0 and r["node_spans_with_op_type"] == r["node_spans"],
              f"{run}: node spans without an operator type")
        check(sum(e["op_type"] == "KernelRidgeRegression" for e in r["k1_node_spans"]) == 1
              and sum(bool(e["sync_ms"]) for e in r["k1_node_spans"]
                      if e["op_type"] == "DelegatingOperator") >= 2,
              f"{run}: the K1-bearing node spans {r['k1_node_spans']}")
        check(r["compiles"] >= 1,
              f"{run}: no CUDA-graph capture counted in the node and segment spans")
        check(r["k1_launches"] == SLICE_LAUNCHES, f"{run}: K1 launched {r['k1_launches']} times")
        check(r["test_error"] < 0.7, f"{run}: test error {r['test_error']}")
    check(runs["second"]["sampling_executions"]["total"] == 0,
          f"the second traced run sampled {runs['second']['sampling_executions']}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    shutil.rmtree(store_root, ignore_errors=True)

    start, finish, zero = phase_group(card)

    # -- sweep_mnist: GridSweep at 200 FFTs over three BCD λ --------------
    name, t0 = start("sweep_mnist")
    mtrain, _ = mnist.synthetic_mnist(SWEEP_MNIST_ROWS, 10000)
    X = mtrain.data.to_array().to(dev, torch.float32)
    Y = ClassLabelIndicators(mnist.NUM_CLASSES).forward(mtrain.labels.to_array().to(dev))
    conf = mnist.MnistRandomFFTConfig(num_ffts=MNIST_FULL_FFTS)
    sweeps = {}
    for warm in (False, True):
        fresh_env()
        featurizer = mnist.build_featurizer(conf, dev)
        with SweepLog(FusedTransformerOperator, X.shape[0], keep=True) as log, \
                Probe() as probe:
            probe.watch(RuleExecutor, "execute")
            t1 = clock()
            res = GridSweep(featurizer,
                            lambda lam: BlockLeastSquaresEstimator(MNIST_BLOCK, 1, lam),
                            {"lam": list(SWEEP_BCD_LAMBDAS)}, X, Y, warm_start=warm).fit()
            sweep_seconds = clock() - t1
            sweep_fits = list(log.fits)
            feats = log.features
            t1 = clock()
            if warm:
                refs = BlockLeastSquaresEstimator.fit_lambda_grid(
                    [BlockLeastSquaresEstimator(MNIST_BLOCK, 1, lam) for lam in SWEEP_BCD_LAMBDAS],
                    feats, Dataset.of(Y))
            else:
                refs = [BlockLeastSquaresEstimator(MNIST_BLOCK, 1, lam).fit(feats, Dataset.of(Y))
                        for lam in SWEEP_BCD_LAMBDAS]
            ref_seconds = clock() - t1
        equal = []
        for m, ref in zip(res, refs):
            (mapper,) = [op for op in m.fitted.graph.operators.values()
                         if isinstance(op, BlockLinearMapper)]
            equal.append(torch.equal(mapper._W, ref._W) and (
                mapper.b is ref.b is None or torch.equal(mapper.b, ref.b)))
        sweeps["warm" if warm else "cold"] = {
            "seconds": sweep_seconds, "optimize_seconds": probe.seconds.get(
                "RuleExecutor.execute:apply", 0.0),
            "reference_seconds": ref_seconds, "featurized_full_size": log.featurized,
            "stats": res.stats, "fits": sweep_fits, "members_equal_reference": equal}
        del res, refs, feats, featurizer, log
    finish(name, t0, {"num_ffts": MNIST_FULL_FFTS, "rows": int(X.shape[0]),
                      "lambdas": SWEEP_BCD_LAMBDAS, "sweeps": sweeps})
    cold, warm_ = sweeps["cold"], sweeps["warm"]
    for kind, sw in sweeps.items():
        check(sw["featurized_full_size"] == 1,
              f"{kind} sweep featurized the fit data {sw['featurized_full_size']} times")
        check(all(sw["members_equal_reference"]),
              f"{kind} sweep members differ from their reference fits: "
              f"{sw['members_equal_reference']}")
    check(cold["stats"]["warm_starts"] == 0 and cold["stats"]["groups"] == 0
          and sorted(f["block_steps"] for f in cold["fits"][:3]) == [MNIST_FULL_STEPS] * 3
          and not any(f["warm"] for f in cold["fits"][:3]),
          f"the cold sweep's fits: {cold['fits']}, stats {cold['stats']}")
    check(warm_["stats"]["warm_starts"] == 2 and warm_["stats"]["groups"] == 1,
          f"the warm sweep's stats {warm_['stats']}")
    del X, Y, mtrain

    # -- sweep_timit: six λ of one 4096-wide cosine branch from one Gram --
    name, t0 = start("sweep_timit")
    tconf = timit.TimitConfig()
    train = timit.synthetic_timit(TIMIT_ROWS, tconf.num_classes, seed=1)
    X = train.data.to_array().to(dev, torch.float32)
    Y = ClassLabelIndicators(tconf.num_classes).forward(train.labels.to_array().to(dev))
    prefix = timit._cosine_branch(tconf, 0, dev).to_pipeline()
    t1 = clock()
    res = GridSweep(prefix, lambda lam: LinearMapEstimator(lam=lam),
                    {"lam": list(SWEEP_TIMIT_LAMBDAS)}, X, Y).fit()
    sweep_seconds = clock() - t1
    devs, ind_seconds = {}, []
    for m in res:
        lam = m.params["lam"]
        t1 = clock()
        ind = prefix.and_then(LinearMapEstimator(lam=lam, snapshot=True), X, Y).fit()
        ind_seconds.append(clock() - t1)
        (W,) = [op.W for op in m.fitted.graph.operators.values() if isinstance(op, LinearMapper)]
        (Wi,) = [op.W for op in ind.graph.operators.values() if isinstance(op, LinearMapper)]
        devs[lam] = ((W - Wi).abs().max() / Wi.abs().max()).item()
    finish(name, t0, {"rows": TIMIT_ROWS, "d": tconf.cosine_features, "k": tconf.num_classes,
                      "lambdas": SWEEP_TIMIT_LAMBDAS, "stats": res.stats,
                      "sweep_seconds": sweep_seconds, "independent_fit_seconds": ind_seconds,
                      "independent_total_seconds": sum(ind_seconds),
                      "rel_dev_from_independent": devs, "limit": SWEEP_TIMIT_LIMIT})
    check(res.stats["gram_reuse_solves"] == len(SWEEP_TIMIT_LAMBDAS),
          f"the TIMIT sweep's stats {res.stats}")
    check(all(v <= SWEEP_TIMIT_LIMIT for v in devs.values()),
          f"TIMIT sweep members against independent fits: {devs}")
    del X, Y, res, prefix, train
    launches.update(zero)
    return launches


# -- the static checker and the serving engine (slice 15) ------------------

#: the command line's per-item widths at small row counts: a check reads
#: the symbolic lead dimension, so n does not change the report
CHECK_APPS = {
    **{app: ["--nTrain", "256", "--nTest", "64"]
       for app in ("RandomPatchCifarKernel", "RandomPatchCifar", "LinearPixels", "RandomCifar",
                   "RandomPatchCifarAugmented")},
    "MnistRandomFFT": ["--nTrain", "512", "--nTest", "64"],
    "TimitPipeline": ["--nTrain", "512", "--nTest", "64"],
    "VOCSIFTFisher": ["--nTrain", "16", "--nTest", "8"],
    "ImageNetSiftLcsFV": ["--nTrain", "16", "--nTest", "8"],
    "NewsgroupsPipeline": ["--nTrain", "64", "--nTest", "16"],
    "AmazonReviewsPipeline": ["--nTrain", "64", "--nTest", "16"],
    "StupidBackoffPipeline": [],
}
SERVE_BUCKETS = (1, 8, 32, 64)
SERVE_CLIENTS = 16
SERVE_BLOCKS = 10  # 50000 training rows in blocks of 5000: K1 launches a batch
SERVE_LIMIT = 1e-5  # a served row's scores against the eager apply's (compiled_cifar's)


@contextlib.contextmanager
def device_quiet():
    """Counts what runs on the card inside the block: ``seen["kernels"]``
    (CUDA kernels in a ``torch.profiler`` trace), ``seen["copies"]``
    (memory copies and sets in it), ``seen["allocated"]``
    (bytes the caching allocator handed out above what was live),
    ``seen["k1"]`` (K1 launches counted, and recorded for captures), and
    ``seen["sampling"]`` (``cost.count_sampling`` executions)."""
    from keystone_tpu_torch import cost
    from keystone_tpu_torch.ops import gaussian_kernel as gk

    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    k1 = gk.gaussian_kernel_block.launches + gk.captured_launches()
    sampled = cost.sampling_executions()["total"]
    torch.cuda.reset_peak_memory_stats()
    seen = {}
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield seen
        torch.cuda.synchronize()
    seen["seconds"] = time.perf_counter() - t0
    on_card = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [n for n in on_card if n.startswith(("Memcpy", "Memset"))]
    seen["kernels"] = len(on_card) - len(copies)
    seen["copies"] = len(copies)
    seen["kernel_names"] = sorted(Counter(on_card).items(), key=lambda kv: -kv[1])[:5]
    seen["allocated"] = torch.cuda.max_memory_allocated() - live
    seen["k1"] = gk.gaussian_kernel_block.launches + gk.captured_launches() - k1
    seen["sampling"] = cost.sampling_executions()["total"] - sampled


def check_phases(cli, dev, card) -> None:
    """``check_apps``: ``--check`` through the command line for each of the
    twelve applications; every check (at ``and_then`` and at fit entry)
    runs no CUDA kernel, allocates nothing on the card, launches no K1 and
    samples nothing, and each application ends at its first fit with a
    report. ``check_rejects``: on card data, a shape-mismatched and a
    dtype-mismatched ``and_then`` raise ``PipelineCheckError`` naming the
    node, with no kernel run by the composition."""
    from keystone_tpu_torch import check as check_pkg
    from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator, LinearMapper
    from keystone_tpu_torch.nodes.stats import RandomSignNode

    real_check_graph = check_pkg.check_graph
    calls = []

    def watched(*args, **kwargs):
        with device_quiet() as seen:
            report = real_check_graph(*args, **kwargs)
        calls.append(dict(seen, nodes=len(report.order)))
        return report

    apps = {}
    t_all = time.perf_counter()
    check_pkg.check_graph = watched
    try:
        for app, args in CHECK_APPS.items():
            fresh_env()
            calls.clear()
            device = [] if app == "StupidBackoffPipeline" else ["--device", str(dev)]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(open(os.devnull, "w")):
                out = cli.run([app, *device, *args, "--check"])
            report = out.get("check_report")
            apps[app] = {"seconds": time.perf_counter() - t0,
                         "checks": [{k: c[k] for k in ("seconds", "nodes", "kernels", "copies",
                                                       "allocated", "k1", "sampling")}
                                    for c in calls],
                         "summary": None if report is None else report.summary()}
            check(isinstance(report, check_pkg.CheckReport), f"{app}: no check report")
            for c in calls:
                check(c["kernels"] == 0 and c["copies"] == 0 and c["allocated"] == 0
                      and c["k1"] == 0 and c["sampling"] == 0,
                      f"{app}: a check ran on the card: {c}")
    finally:
        check_pkg.check_graph = real_check_graph
    emit({"phase": "check_apps", "apps": apps, "seconds": time.perf_counter() - t_all,
          "card": card})

    # -- compositions refused on card data, before any kernel ------------
    fresh_env()
    gen = torch.Generator(device=dev).manual_seed(15)
    X = torch.randn(256, 100, device=dev, generator=gen)  # 100 wide: the signs are 784
    X64 = torch.randn(256, 784, device=dev, generator=gen, dtype=torch.float64)
    Y = torch.randn(256, 10, device=dev, generator=gen)
    signs = RandomSignNode.create(784, seed=0, device=dev)
    mapper = LinearMapper(torch.randn(784, 32, device=dev, generator=gen))  # float32 weights
    rejects = {}
    for name, head, data in (("shape", signs, X), ("dtype", mapper, X64)):
        with device_quiet() as seen:
            try:
                head.and_then(LinearMapEstimator(lam=1.0), data, Y)
                err = None
            except check_pkg.PipelineCheckError as e:
                err = e
        rejects[name] = {"raised": err is not None, "node": str(getattr(err, "node", None)),
                         "label": getattr(err, "label", None), "message": str(err)[:300],
                         "kernels": seen["kernels"], "copies": seen["copies"], "k1": seen["k1"]}
    emit({"phase": "check_rejects", "rejects": rejects, "card": card})
    check(rejects["shape"]["raised"] and rejects["shape"]["label"] == "RandomSignNode",
          f"the shape mismatch was not refused at its node: {rejects['shape']}")
    check(rejects["dtype"]["raised"] and rejects["dtype"]["label"] == "LinearMapper",
          f"the dtype mismatch was not refused at its node: {rejects['dtype']}")
    check(all(r["kernels"] == 0 and r["k1"] == 0 for r in rejects.values()),
          f"a refused composition ran kernels: {rejects}")


def serve_phases(dev, card, scores, X_host, eager) -> dict:
    """``serve_cifar``: the fitted RandomPatchCifarKernel chain ending in
    the scores served by ``ServingEngine(buckets=(1, 8, 32, 64))`` from the
    contract the fit recorded, every one of the ``X_host`` rows a single-row
    request from 16 client threads; each answer within 1e-5 of ``eager``
    (the whole-set apply) and every argmax equal, one capture a bucket and
    none under traffic, K1 launched 10 times a batch, and K1 held against
    its plain version at (b, 800, 5000) for each bucket b. ``serve_swap``:
    a same-contract swap under traffic recaptures every bucket and serves
    on; a replacement of another datum width raises
    ``ContractMismatchError``. Returns the K1 launches of each, and
    ``serve_cifar``'s requests per second, latency and occupancy."""
    import numpy as np

    from keystone_tpu_torch.check import ContractMismatchError
    from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.serving import ServingEngine
    from keystone_tpu_torch.utils import timing
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline, clock

    mapper = next(op for op in scores.graph.operators.values()
                  if isinstance(op, KernelBlockLinearMapper))
    train_X = mapper.train_X
    gen = torch.Generator(device=dev).manual_seed(16)
    # K1 at each bucket's shape, against its plain version, timed beside
    # its bound and the library call (launches here are not the path's)
    kernel_rows = {}
    for b in SERVE_BUCKETS:
        Xq = torch.randn(b, train_X.shape[1], device=dev, generator=gen)
        Xb = train_X[:mapper.block_size]
        got = gk.gaussian_kernel_block(Xq, Xb, mapper.gamma)
        want = gk.gaussian_kernel_block_plain(Xq, Xb, mapper.gamma)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        row = {}
        for _ in range(2):
            row.setdefault("plain_ms", []).append(
                time_ms(lambda: gk.gaussian_kernel_block_plain(Xq, Xb, mapper.gamma), reps=50))
            row.setdefault("ms", []).append(
                time_ms(lambda: gk.gaussian_kernel_block(Xq, Xb, mapper.gamma), reps=50))
            row.setdefault("library_ms", []).append(time_ms(
                lambda: torch.exp(-mapper.gamma * torch.cdist(Xq, Xb).square()), reps=50))
        n, d, bb = b, int(Xq.shape[1]), int(Xb.shape[0])
        kernel_rows[b] = dict({k: min(v) for k, v in row.items()}, **gaussian_bound_ms(n, d, bb),
                              shape=[n, d, bb], max_abs_err=err)
        kernel_rows[b]["share_of_bound"] = kernel_rows[b]["bound_ms"] / kernel_rows[b]["ms"]
        emit(dict({"phase": "kernel_time", "kernel": "gaussian_kernel_block",
                   "main_path_role": f"serve_bucket_{b}", "atol": 1e-5, "rtol": 1e-4,
                   "card": card}, **kernel_rows[b], all_runs=row))
    del Xq, Xb, got, want

    launches = {}
    engine = ServingEngine(scores, buckets=SERVE_BUCKETS)
    try:
        buckets_used = Counter()
        bucket_for = engine.policy.bucket_for

        def counted(n):
            b = bucket_for(n)
            buckets_used[b] += 1
            return b

        engine.policy.bucket_for = counted
        timing.reset()
        t0 = clock()
        engine.start()
        start_seconds = clock() - t0
        compiles_at_start = engine.metrics.count("compiles")
        gk.gaussian_kernel_block.launches = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as pool:
            rows = list(pool.map(lambda r: engine.predict(r, timeout=600.0), X_host))
        wall = time.perf_counter() - t0
        launches["serve_cifar"] = gk.gaussian_kernel_block.launches
        snap = engine.metrics.snapshot()
        served = torch.from_numpy(np.stack(rows))
        dev_max = (served - eager.cpu()).abs().max().item()
        preds_equal = bool(torch.equal(served.argmax(1), eager.cpu().argmax(1)))
        c = snap["counters"]
        emit({"phase": "serve_cifar", "requests": len(X_host), "clients": SERVE_CLIENTS,
              "buckets": list(SERVE_BUCKETS), "answered": len(rows),
              "completed": c.get("completed", 0), "compiles": c.get("compiles", 0),
              "compiles_at_start": compiles_at_start, "start_seconds": start_seconds,
              "batches": c.get("batches", 0), "bucket_histogram": dict(sorted(buckets_used.items())),
              "k1_launches": launches["serve_cifar"], "k1_launches_per_batch": SERVE_BLOCKS,
              "max_abs_dev_from_apply": dev_max, "limit": SERVE_LIMIT,
              "predictions_equal": preds_equal, "wall_seconds": wall,
              "requests_per_second": len(X_host) / wall,
              "latency_s": snap["latency"], "queue_age_s": snap["queue_age"],
              "occupancy": snap["batch_occupancy"]["ratio"],
              # the worker's seconds a batch: the copy in, the replay, the
              # copy out (host clock; the copy out waits for the card)
              "serve_batch_phase": snap["phases"].get("serve.batch"),
              "datum_contract": [list(engine.policy.datum_shape), str(engine.policy.dtype)],
              "kernel_at_buckets": {b: {k: r[k] for k in ("ms", "bound_ms", "share_of_bound",
                                                          "plain_ms", "library_ms", "max_abs_err")}
                                    for b, r in kernel_rows.items()},
              "card": card})
        check(len(rows) == len(X_host) == c.get("completed", 0),
              f"{c.get('completed', 0)} of {len(X_host)} requests answered")
        check(dev_max <= SERVE_LIMIT, f"served scores {dev_max} off the eager apply")
        check(preds_equal, "served predictions differ from the eager apply's")
        check(compiles_at_start == c.get("compiles") == len(SERVE_BUCKETS),
              f"captures {compiles_at_start} at start, {c.get('compiles')} after traffic")
        check(launches["serve_cifar"] == SERVE_BLOCKS * c.get("batches", 0),
              f"K1 launched {launches['serve_cifar']} times in {c.get('batches')} batches")
        engine_ref = {"requests_per_second": len(X_host) / wall, "latency_s": snap["latency"],
                      "occupancy": snap["batch_occupancy"]["ratio"]}

        # -- a same-contract swap under traffic, then another width -------
        gk.gaussian_kernel_block.launches = 0
        stop = threading.Event()
        answers = []

        def hammer():
            while not stop.is_set():
                answers.append(engine.predict(X_host[len(answers) % 64], timeout=600.0))

        t0 = clock()
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
            workers = [pool.submit(hammer) for _ in range(4)]
            replacement = FittedPipeline(scores.graph, scores._source, scores._sink,
                                         datum_shape=scores.datum_shape,
                                         datum_dtype=scores.datum_dtype)
            warmed = engine.swap(replacement)
            after = np.stack([engine.predict(r, timeout=600.0) for r in X_host[:64]])
            stop.set()
            for w in workers:
                w.result(timeout=600)
        swap_seconds = clock() - t0
        launches["serve_swap"] = gk.gaussian_kernel_block.launches
        swap_dev = (torch.from_numpy(after) - eager[:64].cpu()).abs().max().item()
        # the kernel model alone, a valid chain whose datum is the 800-wide
        # features, not the images the engine serves
        head = mapper.to_pipeline()
        narrow = FittedPipeline(head.graph, head.source, head.sink,
                                datum_shape=(int(train_X.shape[1]),), datum_dtype="float32")
        try:
            engine.swap(narrow)
            refused = None
        except ContractMismatchError as e:
            refused = e
        c = engine.metrics.snapshot()["counters"]
        emit({"phase": "serve_swap", "buckets_warmed": warmed, "compiles": c.get("compiles"),
              "swaps": c.get("swaps"), "answers_during_swap": len(answers),
              "max_abs_dev_after_swap": swap_dev, "k1_launches": launches["serve_swap"],
              "seconds": swap_seconds,
              "other_width": {"raised": refused is not None,
                              "label": getattr(refused, "label", None),
                              "message": str(refused)[:300]},
              "card": card})
        check(warmed == len(SERVE_BUCKETS) and c.get("compiles") == 2 * len(SERVE_BUCKETS),
              f"the swap warmed {warmed}, compiles {c.get('compiles')}")
        check(swap_dev <= SERVE_LIMIT, f"after the swap the scores are {swap_dev} off")
        check(refused is not None and refused.label == "source",
              f"a replacement of another width was not refused: {refused}")
    finally:
        engine.shutdown(drain=False)
    return launches, engine_ref


def serve_demo_phase(cli, card) -> None:
    """``serve_demo``: ``--serve-demo`` at the JAX CLI's defaults on the
    card: every answer equal to the pipeline's own apply, and one capture
    for each of its two buckets."""
    import io
    import re

    fresh_env()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--serve-demo"])
    out = buf.getvalue()
    line = next((ln for ln in out.splitlines() if ln.startswith("SERVE ok=")), "")
    ok = re.match(r"SERVE ok=(\d+)/(\d+) compiles=(\d+)", line)
    emit({"phase": "serve_demo", "returncode": rc, "line": line,
          "seconds": time.perf_counter() - t0, "card": card})
    check(rc == 0 and "SERVE PASS" in out and ok is not None and ok[1] == ok[2]
          and int(ok[3]) == 2, f"--serve-demo: {out[-2000:]}")


FLEET_REPLICAS = 4  # co-resident on the one card, each with its own stream and graphs
FLEET_SWAP_CLIENTS = 4
FLEET_FAULT_ROWS = 2000  # single-row requests through the fault plan
FLEET_PLAN = "replica.batch#1=kill@3;replica.batch#2=transient@0,1,2"
FLEET_BAD_SCALE = 1.01  # the rolled-back candidate's KRR weights, scaled
FLEET_FLIGHT_RING = 1 << 14  # flight entries a fleet phase keeps


def _flight_dumps(folder, trigger) -> list:
    import glob

    return sorted(glob.glob(os.path.join(folder, f"keystone-flight-*-{trigger}-*.json")))


def _scaled_scores(scores, scale):
    """``scores`` with its KRR weights scaled by ``scale``: a valid chain of
    the same contract whose answers differ."""
    from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    node, mapper = next((n, op) for n, op in scores.graph.operators.items()
                        if isinstance(op, KernelBlockLinearMapper))
    bad = KernelBlockLinearMapper(mapper.train_X, mapper.W * scale, mapper.gamma,
                                  mapper.block_size)
    return FittedPipeline(scores.graph.set_operator(node, bad), scores._source, scores._sink,
                          datum_shape=scores.datum_shape, datum_dtype=scores.datum_dtype)


def fleet_phases(card, scores, X_host, eager, engine_ref) -> tuple:
    """``fleet_cifar``: the fitted RandomPatchCifarKernel scores chain
    served by ``ServingFleet(replicas=4, buckets=(1, 8, 32, 64))``, the four
    replicas co-resident on the card, every one of the ``X_host`` rows a
    single-row request from 16 client threads: each answer within 1e-5 of
    ``eager`` and every argmax equal, 4 compiles (one a bucket) and 16
    captures (one a bucket and replica), none under traffic, every replica
    busy, no copy of the model (every replica's chain the published chain
    over its own tensors), K1 exactly 10 launches a batch; its rate beside ``serve_cifar``'s.
    ``fleet_swap``: under 4 clients, a canaried swap (a quarter of the
    batches mirrored) to the same chain promotes version 2 with no request
    failed, then a candidate whose KRR weights are scaled by 1.01 raises
    ``CanaryMismatch``; version 2 serves on within 1e-5, and the flight
    dump holds ``serve.canary_rollback``. ``fleet_supervision``: under the
    plan ``replica.batch#1=kill@3;replica.batch#2=transient@0,1,2``,
    replica 1 is killed once and restarted (``fault.replica_restart`` in
    the flight ring), replica 2 fails three batches and is quarantined (its
    dump written), and every admitted request is answered within 1e-5, K1
    10 a batch. Returns the K1 launches of each, and ``fleet_cifar``'s
    requests per second, latency and batches."""
    import numpy as np

    from keystone_tpu_torch import faults
    from keystone_tpu_torch.obs import flight
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.parallel.placement import tensors_of
    from keystone_tpu_torch.serving import CanaryMismatch, ServingFleet
    from keystone_tpu_torch.utils import timing
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline, clock

    eager_host = eager.cpu()
    launches = {}
    flight_dir = tempfile.mkdtemp(prefix="keystone-fleet-flight-")
    prior = {k: os.environ.get(k) for k in ("KEYSTONE_FLIGHT_DIR", "KEYSTONE_FLIGHT_RING")}
    os.environ["KEYSTONE_FLIGHT_DIR"] = flight_dir
    # a ring that holds a whole phase: each batch records a span, and the
    # restart instants must still be there after 2000 requests
    os.environ["KEYSTONE_FLIGHT_RING"] = str(FLEET_FLIGHT_RING)

    def served(rows, idx):
        got = torch.from_numpy(np.stack(rows))
        want = eager_host[idx]
        return ((got - want).abs().max().item(),
                bool(torch.equal(got.argmax(1), want.argmax(1))))

    try:
        # -- fleet_cifar: 4 replicas, the whole test set ------------------
        fleet = ServingFleet(scores, replicas=FLEET_REPLICAS, buckets=SERVE_BUCKETS)
        try:
            timing.reset()
            t0 = clock()
            fleet.start()
            start_seconds = clock() - t0
            compiles_at_start, captures_at_start = fleet.metrics.count("compiles"), fleet.captures
            gk.gaussian_kernel_block.launches = 0
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as pool:
                rows = list(pool.map(lambda r: fleet.predict(r, timeout=600.0), X_host))
            wall = time.perf_counter() - t0
            launches["fleet_cifar"] = gk.gaussian_kernel_block.launches
            snap = fleet.metrics.snapshot()
            captures = fleet.captures
            streams = len({id(r.stream) for r in fleet.replicas if r.stream is not None})
            # one card: no copy, every replica's chain the published chain
            # itself, over its own tensors
            copies = fleet.published.copies
            own = {id(t) for t in tensors_of(scores)}
            shared = all(r.compiled.fitted is scores
                         and {id(t) for t in tensors_of(r.compiled.fitted)} == own
                         for r in fleet.replicas)
        finally:
            fleet.shutdown(drain=False)
        dev_max, preds_equal = served(rows, slice(None))
        c = snap["counters"]
        per_replica = {k: {f: v[f] for f in ("batches", "items", "occupancy")}
                       for k, v in snap["replicas"].items()}
        emit({"phase": "fleet_cifar", "replicas": FLEET_REPLICAS, "streams": streams,
              "requests": len(X_host), "clients": SERVE_CLIENTS, "buckets": list(SERVE_BUCKETS),
              "answered": len(rows), "completed": c.get("completed", 0),
              "compiles": c.get("compiles", 0), "compiles_at_start": compiles_at_start,
              "captures": captures, "captures_at_start": captures_at_start,
              "start_seconds": start_seconds, "batches": c.get("batches", 0),
              "per_replica": per_replica, "steals": c.get("steals", 0),
              "shed": c.get("shed", 0), "k1_launches": launches["fleet_cifar"],
              "k1_launches_per_batch": SERVE_BLOCKS, "max_abs_dev_from_apply": dev_max,
              "limit": SERVE_LIMIT, "predictions_equal": preds_equal, "wall_seconds": wall,
              "requests_per_second": len(X_host) / wall,
              "latency_s": snap["latency"], "queue_age_s": snap["queue_age"],
              "occupancy": snap["batch_occupancy"]["ratio"],
              "serve_batch_phase": snap["phases"].get("serve.batch"),
              "copies": copies, "replicas_share_the_chain": shared,
              "serve_cifar": engine_ref, "card": card})
        fleet_ref = {"requests_per_second": len(X_host) / wall, "latency_s": snap["latency"],
                     "batches": c.get("batches", 0)}
        check(len(rows) == len(X_host) == c.get("completed", 0),
              f"{c.get('completed', 0)} of {len(X_host)} requests answered")
        check(dev_max <= SERVE_LIMIT, f"fleet scores {dev_max} off the eager apply")
        check(preds_equal, "fleet predictions differ from the eager apply's")
        check(compiles_at_start == c.get("compiles") == len(SERVE_BUCKETS),
              f"compiles {compiles_at_start} at start, {c.get('compiles')} after traffic")
        check(captures_at_start == captures == FLEET_REPLICAS * len(SERVE_BUCKETS)
              and streams == FLEET_REPLICAS,
              f"captures {captures_at_start} at start, {captures} after, {streams} streams")
        check(len(per_replica) == FLEET_REPLICAS
              and all(r["batches"] >= 1 for r in per_replica.values()),
              f"an idle replica: {per_replica}")
        check(copies == 0 and shared,
              f"on one card {copies} copies; every replica on the chain's tensors: {shared}")
        check(launches["fleet_cifar"] == SERVE_BLOCKS * c.get("batches", 0),
              f"K1 launched {launches['fleet_cifar']} times in {c.get('batches')} batches")

        # -- fleet_swap: a canary that promotes, then one that rolls back --
        fleet = ServingFleet(scores, replicas=FLEET_REPLICAS, buckets=SERVE_BUCKETS)
        stop = threading.Event()
        answers, errors = [], []

        def hammer(k):
            i = k
            while not stop.is_set():
                try:
                    answers.append((i % 64, fleet.predict(X_host[i % 64], timeout=600.0)))
                except Exception as e:  # counted: the phase fails on any
                    errors.append(repr(e))
                i += FLEET_SWAP_CLIENTS

        try:
            fleet.start()
            flight.reset()
            gk.gaussian_kernel_block.launches = 0
            t0 = clock()
            with concurrent.futures.ThreadPoolExecutor(max_workers=FLEET_SWAP_CLIENTS) as pool:
                workers = [pool.submit(hammer, k) for k in range(FLEET_SWAP_CLIENTS)]
                try:
                    same = FittedPipeline(scores.graph, scores._source, scores._sink,
                                          datum_shape=scores.datum_shape,
                                          datum_dtype=scores.datum_dtype)
                    promoted = fleet.swap(same, canary_fraction=0.25, canary_timeout_s=120.0)
                    try:
                        fleet.swap(_scaled_scores(scores, FLEET_BAD_SCALE),
                                   canary_fraction=0.25, canary_timeout_s=120.0)
                        rollback = None
                    except CanaryMismatch as e:
                        rollback = e.report
                    version = fleet.model_version
                    after = [fleet.predict(r, timeout=600.0) for r in X_host[:64]]
                finally:
                    stop.set()
                    for w in workers:
                        w.result(timeout=600)
            swap_seconds = clock() - t0
            launches["fleet_swap"] = gk.gaussian_kernel_block.launches
            c = fleet.metrics.snapshot()["counters"]
        finally:
            fleet.shutdown(drain=False)
        after_dev, after_equal = served(after, slice(0, 64))
        during = max(((torch.from_numpy(a) - eager_host[i]).abs().max().item()
                      for i, a in answers), default=0.0)
        dumps = _flight_dumps(flight_dir, "canary_rollback")
        dumped = []
        if dumps:
            with open(dumps[-1]) as f:
                dumped = [e["name"] for e in json.load(f)["entries"]]
        emit({"phase": "fleet_swap", "replicas": FLEET_REPLICAS, "clients": FLEET_SWAP_CLIENTS,
              "promoted": {k: promoted[k] for k in ("version", "buckets_warmed", "compiles",
                                                    "replicas_flipped", "canary")},
              "rollback": rollback, "bad_scale": FLEET_BAD_SCALE, "version_after": version,
              "answers_during_swaps": len(answers), "failed": len(errors),
              "errors": errors[:5], "submitted": c.get("submitted"),
              "completed": c.get("completed"), "batches": c.get("batches"),
              "max_abs_dev_during_swaps": during, "max_abs_dev_after": after_dev,
              "canary_pass": c.get("canary_pass", 0), "canary_fail": c.get("canary_fail", 0),
              "swaps": c.get("swaps", 0), "k1_launches": launches["fleet_swap"],
              "flight_dump": dumps[-1] if dumps else None,
              "dump_holds_rollback": "serve.canary_rollback" in dumped,
              "seconds": swap_seconds, "card": card})
        check(not errors and c.get("completed") == c.get("submitted"),
              f"requests failed or dropped across the swaps: {errors[:3]}, "
              f"{c.get('completed')} of {c.get('submitted')}")
        check(promoted["version"] == 2 and promoted["canary"]["mismatches"] == 0
              and promoted["canary"]["batches_compared"] >= 1,
              f"the same chain's canary: {promoted}")
        check(rollback is not None and rollback["mismatches"] >= 1 and version == 2,
              f"the scaled candidate was not rolled back: {rollback}, version {version}")
        check(c.get("canary_pass") == 1 and c.get("canary_fail") == 1 and c.get("swaps") == 1,
              f"canary counters {c}")
        check(during <= SERVE_LIMIT and after_dev <= SERVE_LIMIT and after_equal,
              f"scores {during} off during the swaps, {after_dev} after")
        check(bool(dumps) and "serve.canary_rollback" in dumped,
              f"no rollback dump holding serve.canary_rollback in {flight_dir}")
        check(launches["fleet_swap"] % SERVE_BLOCKS == 0
              and launches["fleet_swap"] >= SERVE_BLOCKS * c.get("batches", 0),
              f"K1 launched {launches['fleet_swap']} times in {c.get('batches')} batches")

        # -- fleet_supervision: a kill and a quarantine under the plan ----
        fleet = ServingFleet(scores, replicas=FLEET_REPLICAS, buckets=SERVE_BUCKETS)
        try:
            fleet.start()
            flight.reset()
            faults.install(faults.parse_plan(FLEET_PLAN))
            gk.gaussian_kernel_block.launches = 0
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as pool:
                rows = list(pool.map(lambda r: fleet.predict(r, timeout=600.0),
                                     X_host[:FLEET_FAULT_ROWS]))
            wall = time.perf_counter() - t0
            launches["fleet_supervision"] = gk.gaussian_kernel_block.launches
            c = fleet.metrics.snapshot()["counters"]
            report = fleet.version_report()
            ring = [e["name"] for e in flight.recorder().entries()]
        finally:
            faults.clear()
            fleet.shutdown(drain=False)
        dev_max, preds_equal = served(rows, slice(0, FLEET_FAULT_ROWS))
        quarantine_dumps = _flight_dumps(flight_dir, "replica_quarantine")
        restarts = {i: r["restarts"] for i, r in report["replicas"].items()}
        emit({"phase": "fleet_supervision", "plan": FLEET_PLAN, "requests": FLEET_FAULT_ROWS,
              "answered": len(rows), "submitted": c.get("submitted"),
              "completed": c.get("completed"), "restarts": c.get("restarts", 0),
              "restarts_by_replica": restarts, "requeues": c.get("requeues", 0),
              "quarantined": c.get("quarantined", 0),
              "batch_transient": c.get("batch_transient", 0),
              "batch_errors": c.get("batch_errors", 0), "batches": c.get("batches"),
              "replica_restart_instants": ring.count("fault.replica_restart"),
              "quarantine_dump": quarantine_dumps[-1] if quarantine_dumps else None,
              "max_abs_dev_from_apply": dev_max, "predictions_equal": preds_equal,
              "k1_launches": launches["fleet_supervision"], "wall_seconds": wall,
              "card": card})
        check(len(rows) == FLEET_FAULT_ROWS == c.get("completed") == c.get("submitted"),
              f"{c.get('completed')} of {FLEET_FAULT_ROWS} admitted requests answered")
        check(dev_max <= SERVE_LIMIT and preds_equal, f"scores {dev_max} off under faults")
        check(restarts.get(1) == 1 and c.get("quarantined") == 1
              and c.get("batch_transient") == 3 and c.get("batch_errors", 0) == 0,
              f"kill and quarantine: restarts {restarts}, counters {c}")
        check(ring.count("fault.replica_restart") >= 2 and bool(quarantine_dumps),
              f"restart instants {ring.count('fault.replica_restart')}, "
              f"quarantine dumps {quarantine_dumps}")
        check(launches["fleet_supervision"] == SERVE_BLOCKS * c.get("batches", 0),
              f"K1 launched {launches['fleet_supervision']} times in {c.get('batches')} "
              "batches")
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        flight.reset()
        shutil.rmtree(flight_dir, ignore_errors=True)
    return launches, fleet_ref


def serve_demo_fleet_phase(cli, card) -> None:
    """``serve_demo_fleet``: ``--serve-demo --replicas 2`` on the card:
    every answer equal to the pipeline's own apply, one compile a bucket,
    and each replica at one batch or more."""
    import io
    import re

    fresh_env()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--serve-demo", "--replicas", "2"])
    out = buf.getvalue()
    line = next((ln for ln in out.splitlines() if ln.startswith("SERVE ok=")), "")
    ok = re.match(r"SERVE ok=(\d+)/(\d+) compiles=(\d+) .* replicas=2 .*"
                  r"per_replica_batches=(\{.*\})", line)
    per_replica = json.loads(ok[4].replace("'", '"')) if ok else {}
    emit({"phase": "serve_demo_fleet", "returncode": rc, "line": line,
          "per_replica_batches": per_replica, "seconds": time.perf_counter() - t0,
          "card": card})
    check(rc == 0 and "SERVE PASS" in out and ok is not None and ok[1] == ok[2]
          and int(ok[3]) == 2 and len(per_replica) == 2
          and all(b >= 1 for b in per_replica.values()),
          f"--serve-demo --replicas 2: {out[-2000:]}")


# the fleet over the card and the host: one replica each, the host's a copy
# of the model; the answers of both against the eager apply on the card,
# relative to its largest score, held as the other fleet phases are
# (SERVE_LIMIT): a host copy built or run in a lower precision fails it
DEVICES_REQUESTS = 2000  # single-row requests from DEVICES_CLIENTS threads
DEVICES_AFTER_KILL = 500  # single-row requests after the host replica's kill
DEVICES_CLIENTS = 8
DEVICES_REL_LIMIT = SERVE_LIMIT
DEVICES_PLAN = "replica.batch#1=kill@0"  # the host replica, at its next batch
DEVICES_AOT_TRAFFIC = 256  # single-row requests through each AOT boot


def _replica_batch_seconds(entries) -> dict:
    """p50 / p99 of each replica's batch seconds in the flight ring."""
    by = {}
    for e in entries:
        if e["kind"] == "span" and e["name"] == "serve.replica":
            by.setdefault(str(e.get("attrs", {}).get("replica")), []).append(e["seconds"])
    return {k: _quantiles(v) for k, v in sorted(by.items())}


def _served_against(rows, idx, eager_host) -> dict:
    """The served rows against the eager apply's: max |Δ| relative to the
    largest eager score, and whether every argmax is equal."""
    import numpy as np

    got = torch.from_numpy(np.stack(rows))
    want = eager_host[idx]
    return {"max_abs_dev": (got - want).abs().max().item(),
            "max_rel_dev": ((got - want).abs().max() / want.abs().max()).item(),
            "predictions_equal": bool(torch.equal(got.argmax(1), want.argmax(1)))}


def _per_replica_batches(fleet) -> dict:
    return {k: v["batches"] for k, v in fleet.metrics.snapshot()["replicas"].items()}


def fleet_devices_phases(card, scores, X_host, eager) -> dict:
    """``fleet_devices``: the fitted full-width scores chain (on the card)
    served by ``ServingFleet(devices=["cuda:0", "cpu"])``: one replica on
    the card serving the chain itself, one on the host serving a copy of it
    (no CUDA tensor at any depth, the card chain's tensors untouched, no
    card byte allocated by the copy, the same fingerprint).
    ``DEVICES_REQUESTS`` single-row requests from ``DEVICES_CLIENTS``
    threads, each answer within ``DEVICES_REL_LIMIT`` of the eager apply
    relative to its largest score and every argmax equal, both replicas
    busy, K1 exactly 10 a card batch and none from the host; a canaried
    swap to the same chain promotes on both devices, a 1.01 × KRR-weights
    candidate rolls back on both, no request failed; then the host replica
    is killed, restarts pinned to the host copy of the published version,
    and ``DEVICES_AFTER_KILL`` rows answer within the same bounds.
    ``fleet_devices_aot``: the same fleet against a fresh AOT cache, cold
    (4 exports a backend) then warm from a clone (8 loads, 0 traces), each
    bucket bit-equal cold against warm on its device, each loaded program's
    constants on its own device. ``fleet_two_cards``: ``fleet_cifar`` over
    ``cuda:0`` and ``cuda:1`` when a second card is visible, and the laned
    fit over the two cards; with one card, one line that says it did not
    run. Returns the K1 launches of each."""
    import numpy as np

    from keystone_tpu_torch import compile as compile_mod
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.obs import flight
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.parallel.placement import copy_to_device, tensors_of
    from keystone_tpu_torch.serving import CanaryMismatch, ServingFleet
    from keystone_tpu_torch.utils import serialization
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline, clock

    cuda0, host = torch.device("cuda", 0), torch.device("cpu")
    eager_host = eager.cpu()
    launches = {}
    flight_dir = tempfile.mkdtemp(prefix="keystone-devices-flight-")
    prior = {k: os.environ.get(k) for k in ("KEYSTONE_FLIGHT_DIR", "KEYSTONE_FLIGHT_RING")}
    os.environ["KEYSTONE_FLIGHT_DIR"] = flight_dir
    os.environ["KEYSTONE_FLIGHT_RING"] = str(FLEET_FLIGHT_RING)
    try:
        # -- the copy alone: its seconds and bytes, nothing on the card -----
        fresh_env()
        card_ids = {id(t) for t in tensors_of(scores)}
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        host_copy = copy_to_device(scores, host)
        copy_seconds = time.perf_counter() - t0
        after = torch.cuda.memory_allocated()
        copy_tensors = tensors_of(host_copy)
        copy_bytes = sum(t.numel() * t.element_size() for t in copy_tensors)
        cuda_in_copy = sum(1 for t in copy_tensors if t.is_cuda)
        host_copy._fingerprint = None
        same_digest = host_copy.fingerprint() == scores.fingerprint()
        del host_copy, copy_tensors

        # -- fleet_devices ------------------------------------------------
        t0 = time.perf_counter()
        fleet = ServingFleet(scores, devices=["cuda:0", "cpu"], buckets=SERVE_BUCKETS)
        construct_seconds = time.perf_counter() - t0
        allocated_after_fleet = torch.cuda.memory_allocated()
        published = fleet.published
        card_chain, host_chain = published.chain_for(cuda0), published.chain_for(host)
        untouched = (card_chain.fitted is scores
                     and {id(t) for t in tensors_of(scores)} == card_ids
                     and all(t.is_cuda for t in tensors_of(scores)))
        host_cuda = sum(1 for t in tensors_of(host_chain.fitted) if t.is_cuda)
        stop = threading.Event()
        answers, errors = [], []

        def hammer(k):
            i = k
            while not stop.is_set():
                try:
                    answers.append((i % 64, fleet.predict(X_host[i % 64], timeout=600.0)))
                except Exception as e:  # counted: the phase fails on any
                    errors.append(repr(e))
                i += FLEET_SWAP_CLIENTS

        try:
            t0 = clock()
            fleet.start()
            start_seconds = clock() - t0
            compiles_at_start = fleet.metrics.count("compiles")
            flight.reset()
            batches0 = _per_replica_batches(fleet)
            gk.gaussian_kernel_block.launches = 0
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(max_workers=DEVICES_CLIENTS) as pool:
                rows = list(pool.map(lambda r: fleet.predict(r, timeout=600.0),
                                     X_host[:DEVICES_REQUESTS]))
            wall = time.perf_counter() - t0
            launches["fleet_devices"] = gk.gaussian_kernel_block.launches
            snap = fleet.metrics.snapshot()
            batches = {k: v - batches0.get(k, 0) for k, v in _per_replica_batches(fleet).items()}
            batch_seconds = _replica_batch_seconds(flight.recorder().entries())
            served = _served_against(rows, slice(0, DEVICES_REQUESTS), eager_host)

            # the canaried swaps, under FLEET_SWAP_CLIENTS clients
            same = FittedPipeline(scores.graph, scores._source, scores._sink,
                                  datum_shape=scores.datum_shape, datum_dtype=scores.datum_dtype)
            with concurrent.futures.ThreadPoolExecutor(max_workers=FLEET_SWAP_CLIENTS) as pool:
                workers = [pool.submit(hammer, k) for k in range(FLEET_SWAP_CLIENTS)]
                try:
                    t0 = clock()
                    promoted = fleet.swap(same, canary_fraction=1.0, canary_batches=16,
                                          canary_timeout_s=120.0)
                    promote_seconds = clock() - t0
                    v2 = fleet.published
                    flipped = [r.compiled for r in fleet.replicas] == [
                        v2.chain_for(cuda0), v2.chain_for(host)]
                    t0 = clock()
                    try:
                        fleet.swap(_scaled_scores(scores, FLEET_BAD_SCALE), canary_fraction=1.0,
                                   canary_batches=16, canary_timeout_s=120.0)
                        rollback = None
                    except CanaryMismatch as e:
                        rollback = e.report
                    rollback_seconds = clock() - t0
                finally:
                    stop.set()
                    for w in workers:
                        w.result(timeout=600)
            kept = (fleet.published is v2 and fleet.model_version == 2
                    and [r.compiled for r in fleet.replicas] == [v2.chain_for(cuda0),
                                                                 v2.chain_for(host)])
            during = max(((torch.from_numpy(a) - eager_host[i]).abs().max().item()
                          for i, a in answers), default=0.0) / eager_host.abs().max().item()
            swap_counters = fleet.metrics.snapshot()["counters"]

            # the host replica killed at its next batch, then restarted
            faults.install(faults.parse_plan(DEVICES_PLAN))
            batches0 = _per_replica_batches(fleet)
            gk.gaussian_kernel_block.launches = 0
            lo, hi = DEVICES_REQUESTS, DEVICES_REQUESTS + DEVICES_AFTER_KILL
            with concurrent.futures.ThreadPoolExecutor(max_workers=DEVICES_CLIENTS) as pool:
                rows_after = list(pool.map(lambda r: fleet.predict(r, timeout=600.0),
                                           X_host[lo:hi]))
            kill_launches = gk.gaussian_kernel_block.launches
            kill_batches = {k: v - batches0.get(k, 0)
                            for k, v in _per_replica_batches(fleet).items()}
            report = fleet.version_report()
            pinned = fleet.replicas[1].compiled is fleet.published.chain_for(host)
            after_kill = _served_against(rows_after, slice(lo, hi), eager_host)
            c = fleet.metrics.snapshot()["counters"]
        finally:
            faults.clear()
            stop.set()
            fleet.shutdown(drain=False)
        launches["fleet_devices"] += kill_launches
        emit({"phase": "fleet_devices", "devices": ["cuda:0", "cpu"], "buckets": list(SERVE_BUCKETS),
              "requests": DEVICES_REQUESTS, "clients": DEVICES_CLIENTS,
              "copy_seconds": copy_seconds, "copy_bytes": copy_bytes,
              "card_allocated_before_copy": before, "card_allocated_after_copy": after,
              "card_allocated_after_fleet": allocated_after_fleet,
              "cuda_tensors_in_host_copy": cuda_in_copy, "host_chain_cuda_tensors": host_cuda,
              "card_chain_untouched": untouched, "same_fingerprint": same_digest,
              "copies": published.copies, "construct_seconds": construct_seconds,
              "start_seconds": start_seconds, "compiles": compiles_at_start,
              "answered": len(rows), "served": served, "rel_limit": DEVICES_REL_LIMIT,
              "batches_by_replica": batches, "replica_batch_seconds": batch_seconds,
              "k1_launches": launches["fleet_devices"] - kill_launches,
              "requests_per_second": len(rows) / wall, "wall_seconds": wall,
              "latency_s": snap["latency"],
              "promoted": {k: promoted[k] for k in ("version", "compiles", "canary")},
              "promote_seconds": promote_seconds, "flipped_to_each_devices_copy": flipped,
              "rollback": rollback, "rollback_seconds": rollback_seconds,
              "kept_version_2_on_both": kept, "answers_during_swaps": len(answers),
              "max_rel_dev_during_swaps": during, "failed_during_swaps": len(errors),
              "errors": errors[:5], "swap_counters": {k: swap_counters.get(k, 0) for k in (
                  "swaps", "canary_pass", "canary_fail", "submitted", "completed")},
              "plan": DEVICES_PLAN, "restarts": report["replicas"], "pinned_to_host_copy": pinned,
              "after_kill": after_kill, "after_kill_batches": kill_batches,
              "after_kill_k1_launches": kill_launches, "card": card})
        check(before == after and cuda_in_copy == 0 and same_digest,
              f"the host copy: card bytes {before} → {after}, {cuda_in_copy} CUDA tensors, "
              f"same fingerprint {same_digest}")
        check(untouched and host_cuda == 0 and published.copies == 1,
              f"the card chain untouched {untouched}, {host_cuda} CUDA tensors on the host "
              f"chain, {published.copies} copies")
        check(compiles_at_start == len(SERVE_BUCKETS), f"compiles {compiles_at_start}")
        check(len(rows) == DEVICES_REQUESTS and served["max_rel_dev"] <= DEVICES_REL_LIMIT
              and served["predictions_equal"], f"fleet_devices answers: {served}")
        check(all(batches.get(k, 0) >= 1 for k in ("0", "1")), f"an idle replica: {batches}")
        check(launches["fleet_devices"] - kill_launches == SERVE_BLOCKS * batches["0"],
              f"K1 launched {launches['fleet_devices'] - kill_launches} times for "
              f"{batches['0']} card batches")
        check(not errors and swap_counters.get("completed") == swap_counters.get("submitted"),
              f"requests failed across the swaps: {errors[:3]}")
        check(promoted["version"] == 2 and promoted["canary"]["mismatches"] == 0
              and promoted["canary"]["batches_compared"] >= 1 and flipped,
              f"the same chain's canary: {promoted}, flipped {flipped}")
        check(rollback is not None and rollback["mismatches"] >= 1 and kept,
              f"the scaled candidate was not rolled back on both devices: {rollback}")
        check(during <= DEVICES_REL_LIMIT, f"answers {during} off during the swaps")
        check(report["replicas"][1]["restarts"] == 1 and pinned
              and c.get("completed") == c.get("submitted"),
              f"the host replica's kill: {report['replicas']}, pinned {pinned}")
        check(len(rows_after) == DEVICES_AFTER_KILL and after_kill["max_rel_dev"] <= DEVICES_REL_LIMIT
              and after_kill["predictions_equal"], f"answers after the kill: {after_kill}")
        check(kill_launches == SERVE_BLOCKS * kill_batches.get("0", 0),
              f"K1 launched {kill_launches} times for {kill_batches} batches after the kill")

        # -- fleet_devices_aot ----------------------------------------------
        root = tempfile.mkdtemp(prefix="keystone-devices-aot-")
        compile_mod.configure(root, max_bytes=8 << 30)
        boots, probes = {}, {}
        try:
            for boot, model in (("cold", scores), ("warm", None)):
                if model is None:
                    t0 = time.perf_counter()
                    model = serialization.loads(serialization.dumps(scores))
                    clone_seconds = time.perf_counter() - t0
                fresh_env()
                t0 = time.perf_counter()
                fleet = ServingFleet(model, devices=["cuda:0", "cpu"], buckets=SERVE_BUCKETS)
                try:
                    fleet.start()
                    boot_seconds = time.perf_counter() - t0
                    chains = fleet.published.chains
                    probes[boot] = {(str(d), b): ch(fleet.policy.pad(X_host[:b], b))[:b]
                                    for d, ch in chains.items() for b in SERVE_BUCKETS}
                    placed = {}
                    for d, ch in chains.items():
                        held = [t for p in ch.dispatcher._by_sig.values()
                                for t in vars(p).values() if isinstance(t, torch.Tensor)]
                        placed[str(d)] = sorted({str(t.device) for t in held})
                    batches0 = _per_replica_batches(fleet)
                    gk.gaussian_kernel_block.launches = 0
                    with concurrent.futures.ThreadPoolExecutor(max_workers=DEVICES_CLIENTS) as pool:
                        rows = list(pool.map(lambda r: fleet.predict(r, timeout=600.0),
                                             X_host[:DEVICES_AOT_TRAFFIC]))
                    k1 = gk.gaussian_kernel_block.launches
                    batches = {k: v - batches0.get(k, 0)
                               for k, v in _per_replica_batches(fleet).items()}
                    c = fleet.metrics.snapshot()["counters"]
                    boots[boot] = {
                        "boot_seconds": boot_seconds, "compiles": c.get("compiles", 0),
                        "aot_loads": c.get("aot_loads", 0),
                        "exported": {str(d): ch.dispatcher.traced_count for d, ch in chains.items()},
                        "loaded": {str(d): ch.dispatcher.loaded_count for d, ch in chains.items()},
                        "constants_on": placed, "k1_launches": k1, "batches_by_replica": batches,
                        "served": _served_against(rows, slice(0, DEVICES_AOT_TRAFFIC),
                                                  eager_host)}
                finally:
                    fleet.shutdown(drain=False)
            launches["fleet_devices_aot"] = boots["cold"]["k1_launches"] + boots["warm"]["k1_launches"]
            bit_equal = {f"{d}/{b}": bool(np.array_equal(v, probes["warm"][(d, b)]))
                         for (d, b), v in probes["cold"].items()}
            entries = compile_mod.get_cache().entries()
            emit({"phase": "fleet_devices_aot", "devices": ["cuda:0", "cpu"],
                  "buckets": list(SERVE_BUCKETS), "cold": boots["cold"], "warm": boots["warm"],
                  "clone_seconds": clone_seconds, "entries": len(entries),
                  "entry_bytes": sorted(n for _, n, _ in entries), "probe_bit_equal": bit_equal,
                  "card": card})
            n = len(SERVE_BUCKETS)
            cold, warm = boots["cold"], boots["warm"]
            check(cold["exported"] == {"cuda:0": n, "cpu": n} and cold["aot_loads"] == 0
                  and cold["compiles"] == n, f"cold boot: {cold}")
            check(warm["loaded"] == {"cuda:0": n, "cpu": n} and warm["aot_loads"] == 2 * n
                  and warm["compiles"] == 0 and warm["exported"] == {"cuda:0": 0, "cpu": 0},
                  f"warm boot: {warm}")
            check(warm["constants_on"] == {"cuda:0": ["cuda:0"], "cpu": ["cpu"]},
                  f"loaded constants on {warm['constants_on']}")
            check(all(bit_equal.values()), f"warm probes differ from cold: {bit_equal}")
            for b in (cold, warm):
                check(b["served"]["max_rel_dev"] <= DEVICES_REL_LIMIT
                      and b["served"]["predictions_equal"], f"AOT answers: {b['served']}")
                check(b["k1_launches"] == SERVE_BLOCKS * b["batches_by_replica"].get("0", 0),
                      f"K1 {b['k1_launches']} for {b['batches_by_replica']} batches")
        finally:
            compile_mod.reset()
            shutil.rmtree(root, ignore_errors=True)
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        flight.reset()
        shutil.rmtree(flight_dir, ignore_errors=True)
    launches.update(fleet_two_cards(card, scores, X_host, eager))
    return launches


def fleet_two_cards(card, scores, X_host, eager) -> dict:
    """``fleet_two_cards``: with a second card, ``fleet_cifar``'s chain and
    traffic over replicas on ``cuda:0`` and ``cuda:1`` (the second serving a
    copy; K1 10 a batch, answers within 1e-5 of the eager apply, argmax
    equal, both busy) and the laned fit of ``lanes_devices`` over the two
    cards. With one card it prints that it did not run and checks nothing:
    that line is no pass."""
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.serving import ServingFleet

    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "fleet_two_cards", "ran": False, "cards": cards})
        return {}
    fresh_env()
    eager_host = eager.cpu()
    fleet = ServingFleet(scores, devices=["cuda:0", "cuda:1"], buckets=SERVE_BUCKETS)
    try:
        fleet.start()
        gk.gaussian_kernel_block.launches = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as pool:
            rows = list(pool.map(lambda r: fleet.predict(r, timeout=600.0),
                                 X_host[:DEVICES_REQUESTS]))
        wall = time.perf_counter() - t0
        k1 = gk.gaussian_kernel_block.launches
        snap = fleet.metrics.snapshot()
        copies = fleet.published.copies
    finally:
        fleet.shutdown(drain=False)
    served = _served_against(rows, slice(0, DEVICES_REQUESTS), eager_host)
    batches = {k: v["batches"] for k, v in snap["replicas"].items()}
    emit({"phase": "fleet_two_cards", "ran": True, "cards": cards, "copies": copies,
          "served": served, "limit": SERVE_LIMIT, "batches_by_replica": batches,
          "k1_launches": k1, "requests_per_second": len(rows) / wall,
          "latency_s": snap["latency"], "card": card})
    check(copies == 1 and served["max_abs_dev"] <= SERVE_LIMIT and served["predictions_equal"],
          f"two cards: {served}, {copies} copies")
    check(all(batches.get(k, 0) >= 1 for k in ("0", "1")), f"an idle card: {batches}")
    check(k1 == SERVE_BLOCKS * sum(batches.values()), f"K1 {k1} for {batches} batches")
    out = {"fleet_two_cards": k1}
    out.update(lanes_devices(card, ["cuda:0", "cuda:1"], "lanes_two_cards"))
    return out


CLUSTER_WORKERS = 2  # worker processes, each one replica, all on the one card
CLUSTER_WARM_ROWS = 512  # single-row requests through the warm router
CLUSTER_FAULT_ROWS = 2000  # single-row requests while worker 1 is killed
CLUSTER_TRACE_ROWS = 64  # traced requests, each stitched across the processes
CLUSTER_SPAWN_S = 300.0  # a cold worker loads the 164 MB chain and exports 4 programs
ROUTER_HOPS = {"rpc.admission", "rpc.send", "rpc.request"}
WORKER_HOPS = {"cluster.handle", "serve.queue", "serve.replica"}


def cluster_chain(path, report, device=None):
    """The cluster phases' model factory, run in each worker process: the
    fitted chain whose bytes ``path`` holds (``cluster.worker.model_bytes``,
    the tensors as host bytes), loaded onto the worker's ``device``. It also
    notes K1's launch count and the fleet's batch count when the worker's
    fleet is ready, and writes them with both counts now, the worker's peak
    allocated bytes and its boot stamps to ``report/k1-<pid>.json`` on
    SIGUSR2 and at exit: K1's launches live in the worker processes, and the
    wire carries no count of them."""
    import atexit
    import signal

    from keystone_tpu_torch.cluster.worker import load_model_bytes
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.serving import fleet as fleet_mod

    marks = {"pid": os.getpid(), "factory_unix": time.time()}
    fleets = []  # the worker's one fleet, once started
    start = fleet_mod.ServingFleet.start

    on_card = torch.cuda.is_available()

    def marked_start(self, *args, **kwargs):
        out = start(self, *args, **kwargs)
        if on_card:
            torch.cuda.synchronize()
        fleets.append(self)
        marks.update(at_ready=gk.gaussian_kernel_block.launches,
                     batches_ready=self.metrics.count("batches"), ready_unix=time.time(),
                     ready_allocated=torch.cuda.memory_allocated() if on_card else 0)
        return out

    fleet_mod.ServingFleet.start = marked_start

    def write(*_):
        row = dict(marks, launches_now=gk.gaussian_kernel_block.launches,
                   batches_now=fleets[0].metrics.count("batches") if fleets else 0,
                   written_unix=time.time(),
                   peak_allocated=torch.cuda.max_memory_allocated() if on_card else 0)
        tmp = os.path.join(report, f".k1-{os.getpid()}.json")
        with open(tmp, "w") as f:
            json.dump(row, f)
        os.replace(tmp, os.path.join(report, f"k1-{os.getpid()}.json"))

    def write_aside(*_):
        # a handler runs on the main thread between two of its bytecodes,
        # maybe while that thread holds the fleet's metrics lock (a plain
        # lock): the counts are read on a thread of their own instead
        threading.Thread(target=write, name="k1-report", daemon=True).start()

    atexit.register(write)
    signal.signal(signal.SIGUSR2, write_aside)  # the factory runs on the main thread
    with open(path, "rb") as f:
        fitted = load_model_bytes(f.read(), device)
    marks["loaded_unix"] = time.time()
    return fitted


def _worker_rows(report) -> dict:
    """pid -> the row each exited worker wrote (``cluster_chain``)."""
    import glob

    rows = {}
    for path in glob.glob(os.path.join(report, "k1-*.json")):
        with open(path) as f:
            row = json.load(f)
        rows[row["pid"]] = row
    return rows


def _worker_batches(snap) -> dict:
    out = {}
    for key, row in snap.get("replicas", {}).items():
        w = key.split("/")[0]
        out[w] = out.get(w, 0) + row.get("batches", 0)
    return out


def _wait_for(cond, timeout: float, what: str) -> float:
    """Poll ``cond`` until it holds; the seconds it took. Fails the phase
    after ``timeout``."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out after {timeout:.0f}s waiting for {what}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def cluster_phases(card, scores, X_host, eager, engine_ref, fleet_ref) -> dict:
    """The fitted RandomPatchCifarKernel scores chain served by a
    ``ClusterRouter`` over worker processes on the card (buckets 1 / 8 / 32 /
    64), shipped to the workers as host bytes and loaded by
    :func:`cluster_chain`. ``cluster_cifar``: 2 workers, one replica each, a
    fresh AOT cache (cold); the ``X_host`` rows as single-row requests from
    16 client threads: each answer within 1e-5 of ``eager``, every argmax
    equal, both workers busy, K1 exactly 10 a batch in each worker and none
    in this process; requests per second and p50 / p99 beside
    ``serve_cifar`` and ``fleet_cifar``. Then, while a second, traced router
    (sample rate 1.0, ``metrics_port=0``) boots over the same cache,
    ``cluster_supervision`` on the first: under 2000 requests worker 1 is
    killed (SIGKILL) once and respawned once, warm (0 compiles); no admitted
    request fails, every answer within 1e-5, a ``worker_down`` flight dump;
    and ``cluster_scale``: ``scale_up_slot()`` (called while worker 1
    respawns) adds a worker that boots warm and serves batches;
    ``begin_drain`` of worker 0 under traffic loses no request; one
    ``Autoscaler`` tick on a hand-made breach row decides ``scale.up`` (its
    half-born slot is then reaped). On the second router, ``cluster_warm``:
    every ``ready`` reports 0 compiles and 4 AOT loads, 512 rows within
    1e-5; ``cluster_trace``: 64 more requests; every traced request's router
    hops (``rpc.admission``, ``rpc.send``, ``rpc.request``) and worker hops
    (``cluster.handle``, ``serve.queue``, ``serve.replica``) under its trace
    id in the stitched trace, on 3 process tracks; one scrape of
    ``/metrics`` whose merged ``completed`` equals the requests answered.
    ``cluster_boots``: each worker's boot seconds (cold; the four warm boots
    side by side), split into the interpreter and handshake, the load and
    the warm-up, and its allocated bytes on the card. Returns the K1
    launches of each router, as the workers counted them."""
    import signal

    import numpy as np
    import urllib.request

    from keystone_tpu_torch.autoscale import Autoscaler, ScalePolicy
    from keystone_tpu_torch.cluster import ClusterRouter
    from keystone_tpu_torch.cluster.worker import model_bytes
    from keystone_tpu_torch.obs import flight
    from keystone_tpu_torch.obs import tracer as trace_mod
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.serving.slo import SloBreach

    eager_host = eager.cpu()
    launches = {}
    work = tempfile.mkdtemp(prefix="keystone-cluster-")
    aot_dir, flight_dir = os.path.join(work, "aot"), os.path.join(work, "flight")
    os.makedirs(flight_dir)
    prior = {k: os.environ.get(k) for k in ("KEYSTONE_FLIGHT_DIR", "KEYSTONE_FLIGHT_RING")}
    os.environ["KEYSTONE_FLIGHT_DIR"] = flight_dir  # the workers inherit it
    os.environ["KEYSTONE_FLIGHT_RING"] = str(FLEET_FLIGHT_RING)

    def serve(router, idx, clients=SERVE_CLIENTS):
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=clients) as pool:
            rows = list(pool.map(lambda i: router.predict(X_host[i], timeout=600.0), idx))
        wall = time.perf_counter() - t0
        got = torch.from_numpy(np.stack(rows))
        want = eager_host[list(idx)]
        return (len(rows), wall, (got - want).abs().max().item(),
                bool(torch.equal(got.argmax(1), want.argmax(1))))

    def new_router(report, **kwargs):
        os.makedirs(report, exist_ok=True)
        return ClusterRouter(("factory", "chip_smoke:cluster_chain",
                              {"path": chain_path, "report": report}),
                             workers=CLUSTER_WORKERS, replicas_per_worker=1,
                             buckets=SERVE_BUCKETS, aot_cache=aot_dir,
                             spawn_timeout_s=CLUSTER_SPAWN_S, health_interval_s=1.0,
                             drain_timeout_s=60.0, join_timeout_s=30.0, **kwargs)

    def k1_pins(rows, since=None, skip=()):
        """pid -> K1's launches and the fleet's batches in each worker since
        its ready, or since its row in ``since``. A row without ``at_ready``
        is a worker reaped before its fleet started, which served nothing."""
        out = {}
        for pid, r in rows.items():
            if pid in skip or "at_ready" not in r:
                continue
            base = (since or {}).get(pid)
            k0, b0 = ((base["launches_now"], base["batches_now"]) if base
                      else (r["at_ready"], r["batches_ready"]))
            out[pid] = {"k1": r["launches_now"] - k0, "batches": r["batches_now"] - b0}
        return out

    def check_pins(pins, what, need):
        """K1 exactly 10 a batch in each worker of ``pins``, and a batch or
        more in each pid of ``need``."""
        check(all(p in pins and pins[p]["batches"] >= 1 for p in need),
              f"{what}: a worker served no batch or wrote no count: {pins}, need {need}")
        check(all(v["k1"] == SERVE_BLOCKS * v["batches"] for v in pins.values()),
              f"{what}: K1 in the workers against 10 × batches {pins}")

    def split(rows, t0_unix, pids):
        """Each worker's boot: to the factory (interpreter, torch, CUDA
        context, handshake), the chain's load, the fleet's warm-up."""
        return {p: {"to_factory": r["factory_unix"] - t0_unix,
                    "load": r["loaded_unix"] - r["factory_unix"],
                    "warm_up": r["ready_unix"] - r["loaded_unix"]}
                for p, r in rows.items() if p in pids}

    def counted_now(report, pids):
        """Each live worker's row, written on SIGUSR2 (``cluster_chain``)."""
        asked = time.time()
        for pid in pids:
            os.kill(pid, signal.SIGUSR2)
        _wait_for(lambda: all(_worker_rows(report).get(p, {}).get("written_unix", 0) >= asked
                              for p in pids), 60.0, "the workers' K1 counts")
        return _worker_rows(report)

    def supervision_phase(router, pids):
        """SIGKILL worker 1 under 2000 requests: one warm respawn, no loss;
        the scale-up boots beside the respawn."""
        restarts0 = router.metrics.count("restarts")
        victim = pids[1]

        def kill_after(delay):
            time.sleep(delay)
            marks["kill_unix"] = time.time()
            os.kill(victim, signal.SIGKILL)

        idx = [i % len(X_host) for i in range(CLUSTER_FAULT_ROWS)]
        killer = threading.Thread(target=kill_after, args=(0.3,))
        killer.start()
        n, wall, dev_max, preds_equal = serve(router, idx)
        killer.join()
        marks["up_unix"] = time.time()
        marks["slot"] = router.scale_up_slot()
        _wait_for(lambda: router.live_workers == CLUSTER_WORKERS + 1
                  and router.worker_pids[1] != victim, 300.0,
                  "worker 1's respawn and the scaled-up worker")
        respawned = router.worker_reports[1]
        marks["respawned_pid"] = router.worker_pids[1]
        dumps = _flight_dumps(flight_dir, "worker_down")
        restarts = router.metrics.count("restarts") - restarts0
        emit({"phase": "cluster_supervision", "requests": CLUSTER_FAULT_ROWS, "answered": n,
              "restarts": restarts, "requeues": router.metrics.count("requeues"),
              "respawned_ready": {k: respawned[k] for k in ("compiles", "aot_loads")},
              "worker_down_dumps": len(dumps), "max_abs_dev_from_apply": dev_max,
              "limit": SERVE_LIMIT, "predictions_equal": preds_equal, "wall_seconds": wall,
              "card": card})
        check(n == CLUSTER_FAULT_ROWS and dev_max <= SERVE_LIMIT and preds_equal,
              f"under the kill {n} answered, {dev_max} off")
        check(restarts == 1 and respawned["compiles"] == 0,
              f"restarts {restarts}, respawned ready {respawned}")
        check(bool(dumps), "no worker_down flight dump")

    def scale_phase(router):
        """The actuator verbs, then one scaler tick on a breach row."""
        slot = marks["slot"]  # scaled up during the supervision phase
        up_ready, marks["up_pid"] = router.worker_reports[slot], router.worker_pids[slot]
        n_up, _, dev_up, eq_up = serve(router, range(CLUSTER_WARM_ROWS))
        batches_up = _worker_batches(router.snapshot(timeout=30.0))

        def drain_after(delay):
            time.sleep(delay)
            router.begin_drain(0)

        drainer = threading.Thread(target=drain_after, args=(0.2,))
        drainer.start()
        n_dr, _, dev_dr, eq_dr = serve(router, range(CLUSTER_WARM_ROWS, 3 * CLUSTER_WARM_ROWS))
        drainer.join()
        drain_seconds = _wait_for(lambda: router.scale_view()["draining"] == 0
                                  and router.live_workers == CLUSTER_WORKERS, 120.0,
                                  "worker 0's drain")
        router.observe_service(0.01)  # a learned estimate: a cold fleet never scales
        scaler = Autoscaler(ScalePolicy(min_workers=1, max_workers=4, up_breaches=1,
                                        up_cooldown_s=0.0), router, metrics=router.metrics)
        decisions = scaler.tick([SloBreach("queue_age_p99_budget_s", 0.9, 0.1, time.time())],
                                row={"gauges": {"queue_depth": 0.0}})
        instants = [e["name"] for e in flight.recorder().entries()]
        for d in decisions:  # the decision is the evidence: its worker is not needed
            router.reap_slot(d.worker)
        emit({"phase": "cluster_scale", "scaled_slot": slot,
              "up_ready": {k: up_ready[k] for k in ("compiles", "aot_loads")},
              "per_worker_batches_after_up": batches_up, "answered_after_up": n_up,
              "answered_during_drain": n_dr, "drain_seconds": drain_seconds,
              "max_abs_dev_from_apply": max(dev_up, dev_dr), "limit": SERVE_LIMIT,
              "decisions": [d.as_row() for d in decisions],
              "scale_up_instants": instants.count("scale.up"), "card": card})
        check(up_ready["compiles"] == 0 and batches_up.get(f"worker-{slot}", 0) >= 1,
              f"the scaled-up worker: ready {up_ready}, batches {batches_up}")
        check(n_up == CLUSTER_WARM_ROWS and n_dr == 2 * CLUSTER_WARM_ROWS
              and max(dev_up, dev_dr) <= SERVE_LIMIT and eq_up and eq_dr,
              f"scale traffic {n_up} / {n_dr} answered, {max(dev_up, dev_dr)} off")
        check([(d.action, d.ok, d.reason) for d in decisions] == [("up", True, "breach")]
              and instants.count("scale.up") >= 1,
              f"the scaler's tick: {[d.as_row() for d in decisions]}")

    def trace_phase(router):
        """64 traced requests stitched across the processes; one scrape."""
        completed0 = router.metrics.count("completed")
        idx = range(CLUSTER_WARM_ROWS, CLUSTER_WARM_ROWS + CLUSTER_TRACE_ROWS)
        n, _, dev_max, preds_equal = serve(router, idx)
        by_trace, deadline = {}, time.monotonic() + 30.0
        while True:
            for spans in router.collect_trace(timeout=10.0):
                for sp in spans:
                    tid = (sp.get("args") or {}).get("trace_id")
                    if tid:
                        by_trace.setdefault(tid, []).append(sp)
            whole = [t for t, sps in by_trace.items()
                     if {x["name"] for x in sps} >= ROUTER_HOPS | WORKER_HOPS]
            if len(whole) >= CLUSTER_WARM_ROWS + CLUSTER_TRACE_ROWS or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        path = router.export_trace(os.path.join(work, "stitched.json"), timeout=10.0)
        with open(path) as f:
            doc = json.load(f)
        tracks = sorted({e["args"]["name"] for e in doc["traceEvents"]
                         if e["name"] == "process_name"})
        host, port = router.metrics_address
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=30) as r:
            scrape = r.read().decode("utf-8")
        scraped = next((float(line.split()[-1]) for line in scrape.splitlines()
                        if line.startswith("keystone_completed_total ")), None)
        answered = router.metrics.count("completed")
        pids_per_trace = sorted({len({x["pid"] for x in by_trace[t]}) for t in whole})
        emit({"phase": "cluster_trace", "requests": CLUSTER_TRACE_ROWS, "answered": n,
              "traced_requests": CLUSTER_WARM_ROWS + CLUSTER_TRACE_ROWS,
              "traces": len(by_trace), "whole_traces": len(whole),
              "pids_per_trace": pids_per_trace, "process_tracks": tracks,
              "trace_events": len(doc["traceEvents"]), "scraped_completed": scraped,
              "router_completed": answered, "scrape_bytes": len(scrape),
              "max_abs_dev_from_apply": dev_max, "limit": SERVE_LIMIT, "card": card})
        check(n == CLUSTER_TRACE_ROWS and answered - completed0 == n and dev_max <= SERVE_LIMIT
              and preds_equal, f"traced answers {n}, {dev_max} off")
        check(len(whole) == CLUSTER_WARM_ROWS + CLUSTER_TRACE_ROWS and pids_per_trace == [2],
              f"{len(whole)} traces stitched whole, pids per trace {pids_per_trace}")
        check(len(tracks) >= 3, f"process tracks {tracks}")
        check(scraped == answered, f"scraped completed {scraped}, answered {answered}")

    marks, warm = {}, {}
    prev_tracer = trace_mod.stop()
    try:
        t0 = time.perf_counter()
        chain_path = os.path.join(work, "chain.bin")
        with open(chain_path, "wb") as f:
            f.write(model_bytes(scores))
        ship_seconds = time.perf_counter() - t0

        # -- cluster_cifar: 2 workers, a fresh cache, the whole test set;
        # untraced (sample rate 0), so the traced router's trace is its own
        cold_report = os.path.join(work, "cold")
        router = new_router(cold_report, trace_sample=0.0)
        t0, cold_unix = time.perf_counter(), time.time()
        router.start()
        boot_seconds = time.perf_counter() - t0
        warm_thread = None
        try:
            cold_reports = router.worker_reports
            pids = router.worker_pids
            router_k1 = gk.gaussian_kernel_block.launches
            n, wall, dev_max, preds_equal = serve(router, range(len(X_host)))
            router_k1 = gk.gaussian_kernel_block.launches - router_k1
            snap = router.snapshot(timeout=30.0)
            # the workers' own batch phases (the merged snapshot's phase
            # table also holds this process's earlier engines and fleets)
            batch_phase = {w["name"]: w["phases"].get("serve.batch")
                           for w in router.worker_snapshots(timeout=30.0)}
            rows = counted_now(cold_report, pids)
            cifar_rows = {p: rows[p] for p in pids}
            per_worker = _worker_batches(snap)
            pins = k1_pins(cifar_rows)
            k1 = {p: v["k1"] for p, v in pins.items()}
            batches_by_pid = {pid: per_worker.get(f"worker-{i}", 0)
                              for i, pid in enumerate(pids)}
            launches["cluster_cifar"] = sum(k1.values())
            cold_boots = [rows[p]["ready_unix"] - cold_unix for p in pids]
            c = snap["counters"]
            emit({"phase": "cluster_cifar", "workers": CLUSTER_WORKERS, "replicas_per_worker": 1,
                  "requests": len(X_host), "clients": SERVE_CLIENTS,
                  "buckets": list(SERVE_BUCKETS), "answered": n,
                  "completed": c.get("completed", 0),
                  "ready": [{k: r[k] for k in ("compiles", "aot_loads", "capacity", "devices",
                                               "shm")} for r in cold_reports],
                  "router_start_seconds": boot_seconds,
                  "chain_bytes": os.path.getsize(chain_path), "ship_seconds": ship_seconds,
                  "worker_boot_seconds": cold_boots, "per_worker_batches": per_worker,
                  "k1_by_worker": k1, "k1_launches_per_batch": SERVE_BLOCKS,
                  "router_k1_launches": router_k1,
                  "worker_peak_allocated_bytes": [rows[p]["peak_allocated"] for p in pids],
                  "worker_ready_allocated_bytes": [rows[p]["ready_allocated"] for p in pids],
                  "coalesce_frames": c.get("coalesce.frames", 0),
                  "coalesce_members": c.get("coalesce.members", 0),
                  "wire_frames": {k: v for k, v in c.items() if k.startswith("wire.frames.")},
                  "max_abs_dev_from_apply": dev_max, "limit": SERVE_LIMIT,
                  "predictions_equal": preds_equal, "wall_seconds": wall,
                  "requests_per_second": n / wall, "latency_s": snap["latency"],
                  "queue_age_s": snap["queue_age"], "serve_batch_phase": batch_phase,
                  "serve_cifar": engine_ref, "fleet_cifar": fleet_ref, "card": card})
            check(n == len(X_host) == c.get("completed", 0),
                  f"{c.get('completed', 0)} of {len(X_host)} requests answered")
            check(dev_max <= SERVE_LIMIT and preds_equal,
                  f"cluster scores {dev_max} off the apply")
            check(all(r["devices"] == ["cuda:0"] for r in cold_reports),
                  f"the workers did not serve on the card: {cold_reports}")
            check(len(per_worker) == CLUSTER_WORKERS
                  and all(b >= 1 for b in per_worker.values()), f"an idle worker: {per_worker}")
            check(all(k1[p] == SERVE_BLOCKS * batches_by_pid[p] for p in pids),
                  f"K1 in the workers {k1} against 10 × batches {batches_by_pid}")
            check({p: v["batches"] for p, v in pins.items()} == batches_by_pid,
                  f"the workers' own batch counts {pins} against the snapshot's")
            check(router_k1 == 0, f"the router process launched K1 {router_k1} times")

            # -- a second, traced router boots over the warm cache while the
            # first is supervised and scaled: four warm boots side by side
            trace_mod.install(trace_mod.Tracer())
            warm_report = os.path.join(work, "warm")

            def boot_warm():
                warm["unix"] = time.time()
                warm["router"] = new_router(warm_report, trace_sample=1.0, metrics_port=0)
                try:
                    warm["router"].start()
                except BaseException as e:  # raised on this thread after the join
                    warm["error"] = e

            warm_thread = threading.Thread(target=boot_warm, name="warm-router-boot")
            warm_thread.start()
            supervision_phase(router, pids)
            scale_phase(router)
        finally:
            router.shutdown(drain=True)
            if warm_thread is not None:
                warm_thread.join()
        if "error" in warm:
            raise warm["error"]
        rows = _worker_rows(cold_report)
        # the first router after cluster_cifar's count: the survivor (then
        # drained), the respawn and the scaled-up worker, each from its exit
        # row; the killed worker wrote none, so what it launched between
        # cluster_cifar's count and the SIGKILL is not counted
        victim = pids[1]
        sup_pins = k1_pins(rows, since=cifar_rows, skip={victim})
        launches["cluster_supervision_scale"] = sum(v["k1"] for v in sup_pins.values())
        # the warm router: cluster_warm, then cluster_trace
        wrouter = warm["router"]
        try:
            warm_reports = wrouter.worker_reports
            wpids = wrouter.worker_pids
            n, wall, dev_max, preds_equal = serve(wrouter, range(CLUSTER_WARM_ROWS))
            warm_rows = counted_now(warm_report, wpids)
            warm_rows = {p: warm_rows[p] for p in wpids}
            warm_pins = k1_pins(warm_rows)
            launches["cluster_warm"] = sum(v["k1"] for v in warm_pins.values())
            emit({"phase": "cluster_warm", "workers": CLUSTER_WORKERS,
                  "ready": [{k: r[k] for k in ("compiles", "aot_loads")} for r in warm_reports],
                  "answered": n, "max_abs_dev_from_apply": dev_max, "limit": SERVE_LIMIT,
                  "k1_by_worker": warm_pins, "k1_launches_per_batch": SERVE_BLOCKS,
                  "predictions_equal": preds_equal, "wall_seconds": wall, "card": card})
            check(all(r["compiles"] == 0 and r["aot_loads"] == len(SERVE_BUCKETS)
                      for r in warm_reports), f"warm boots paid traces: {warm_reports}")
            check_pins(warm_pins, "cluster_warm", need=wpids)
            check(n == CLUSTER_WARM_ROWS and dev_max <= SERVE_LIMIT and preds_equal,
                  f"warm answers {n}, {dev_max} off")
            trace_phase(wrouter)
            trace_pins = k1_pins(counted_now(warm_report, wpids), since=warm_rows)
            launches["cluster_trace"] = sum(v["k1"] for v in trace_pins.values())
        finally:
            wrouter.shutdown(drain=True)
        wrows = _worker_rows(warm_report)
        emit({"phase": "cluster_k1", "k1_launches_per_batch": SERVE_BLOCKS,
              "supervision_scale": sup_pins, "killed_pid_not_counted": victim,
              "respawned_pid": marks["respawned_pid"], "scaled_up_pid": marks["up_pid"],
              "trace": trace_pins, "card": card})
        check_pins(sup_pins, "cluster_supervision / cluster_scale",
                   need=[pids[0], marks["respawned_pid"], marks["up_pid"]])
        check(sum(v["batches"] for v in trace_pins.values()) >= 1
              and set(trace_pins) == set(wpids), f"cluster_trace's counts {trace_pins}")
        check_pins(trace_pins, "cluster_trace", need=[])
        emit({"phase": "cluster_boots", "cold_seconds": cold_boots,
              "cold_split_seconds": split(_worker_rows(cold_report), cold_unix, pids),
              "warm_seconds": [wrows[p]["ready_unix"] - warm["unix"] for p in wpids
                               if p in wrows],
              "warm_split_seconds": split(wrows, warm["unix"], wpids),
              "respawn_seconds": (rows[marks["respawned_pid"]]["ready_unix"] - marks["kill_unix"]
                                  if marks["respawned_pid"] in rows else None),
              "scale_up_seconds": (rows[marks["up_pid"]]["ready_unix"] - marks["up_unix"]
                                   if marks["up_pid"] in rows else None),
              "warm_boots_side_by_side": 4,
              "worker_peak_allocated_bytes": {p: r["peak_allocated"]
                                              for p, r in {**rows, **wrows}.items()},
              "worker_ready_allocated_bytes": {p: r["ready_allocated"]
                                               for p, r in {**rows, **wrows}.items()},
              "card": card})
    finally:
        if warm.get("router") is not None:
            warm["router"].shutdown(drain=False)  # idempotent: stops a failed phase's workers
        trace_mod.stop()
        if prev_tracer is not None:
            trace_mod.install(prev_tracer)
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        flight.reset()
        shutil.rmtree(work, ignore_errors=True)
    return launches


def start_serve_demo_cluster():
    """``python -m keystone_tpu_torch --serve-demo --workers 2``, started in
    a process of its own; :func:`serve_demo_cluster_phase` reads it."""
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "keystone_tpu_torch", "--serve-demo", "--workers", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def serve_demo_cluster_phase(demo, card) -> None:
    """``serve_demo_cluster``: ``--serve-demo --workers 2`` on the card: the
    JAX demo's pass line, every answer equal to the pipeline's own apply,
    and each worker process at one batch or more."""
    import re

    t0, proc = demo
    out, err = proc.communicate(timeout=600)
    line = next((ln for ln in out.splitlines() if ln.startswith("SERVE ok=")), "")
    ok = re.match(r"SERVE ok=(\d+)/(\d+) compiles=(\d+) aot_loads=(\d+) .* workers=2 .*"
                  r"per_worker_batches=(\{.*\})", line)
    per_worker = json.loads(ok[5].replace("'", '"')) if ok else {}
    emit({"phase": "serve_demo_cluster", "returncode": proc.returncode, "line": line,
          "per_worker_batches": per_worker, "seconds": time.perf_counter() - t0,
          "beside": "cuda_card_tests", "card": card})
    check(proc.returncode == 0 and "SERVE PASS" in out and ok is not None and ok[1] == ok[2]
          and len(per_worker) == 2 and all(b >= 1 for b in per_worker.values()),
          f"--serve-demo --workers 2: {out[-2000:]}{err[-2000:]}")


def start_trainer_demo():
    """``python -m keystone_tpu_torch --trainer-demo``, started in a process
    of its own; :func:`trainer_demo_phase` reads it."""
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "keystone_tpu_torch", "--trainer-demo"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def trainer_demo_phase(demo, card) -> None:
    """``trainer_demo``: ``--trainer-demo`` on the card: the JAX demo's
    pass line (every good batch promoted, the poisoned one rolled back and
    parked, no failed request, no version skew)."""
    t0, proc = demo
    out, err = proc.communicate(timeout=600)
    line = next((ln for ln in out.splitlines() if ln.startswith("TRAINER refits=")), "")
    emit({"phase": "trainer_demo", "returncode": proc.returncode, "line": line,
          "seconds": time.perf_counter() - t0, "beside": "cuda_card_tests", "card": card})
    check(proc.returncode == 0 and "TRAINER PASS" in out and "failures=0" in line,
          f"--trainer-demo: {out[-2000:]}{err[-2000:]}")


AOT_PROBE_ROWS = 64  # the rows each boot's bucket programs are held on
AOT_TRAFFIC = 512  # single-row requests through each boot's engine


def _k1_calls(program) -> int:
    """The K1 operator's calls in an exported program's graph."""
    return sum(1 for n in program.graph.nodes
               if "keystone.gaussian_kernel_block" in str(n.target))


def _aot_boot(fitted, X_host, eager):
    """One engine boot against the configured AOT cache: construct, warm
    up, each bucket's program on the first rows of ``X_host`` (padded as
    the replica pads them), then ``AOT_TRAFFIC`` single-row requests from
    16 threads. Returns its numbers and its per-bucket scores."""
    import numpy as np

    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.serving import ServingEngine

    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = ServingEngine(fitted, buckets=SERVE_BUCKETS)
    construct = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        engine.warm_up(required=True)
        torch.cuda.synchronize()
        warmup = time.perf_counter() - t0
        # the programs' constants (a loaded program holds its own copy of
        # the model) and the captured graphs' pool
        boot_bytes = torch.cuda.memory_allocated() - before
        chain_ = engine._compiled
        probes = {b: chain_(engine.policy.pad(X_host[:b], b))[:b] for b in SERVE_BUCKETS}
        engine.start(warmup=False)
        allocated = torch.cuda.memory_allocated()
        gk.gaussian_kernel_block.launches = 0
        with concurrent.futures.ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as pool:
            rows = list(pool.map(lambda r: engine.predict(r, timeout=600.0),
                                 X_host[:AOT_TRAFFIC]))
        launches = gk.gaussian_kernel_block.launches
        grown = torch.cuda.memory_allocated() - allocated
        served = torch.from_numpy(np.stack(rows))
        c = engine.metrics.snapshot()["counters"]
        programs = chain_.dispatcher._by_sig.values() if chain_.dispatcher else ()
        out = {"construct_seconds": construct, "warmup_seconds": warmup,
               "compiles": c.get("compiles", 0), "aot_loads": c.get("aot_loads", 0),
               "captures": chain_.captures, "device": str(chain_.device),
               "k1_per_program": sorted(_k1_calls(p) for p in programs),
               "batches": c.get("batches", 0), "k1_launches": launches,
               "max_abs_dev_from_apply": (served - eager[:AOT_TRAFFIC].cpu()).abs().max().item(),
               "predictions_equal": bool(torch.equal(served.argmax(1),
                                                     eager[:AOT_TRAFFIC].cpu().argmax(1))),
               "boot_allocated_bytes": boot_bytes, "allocated_growth_bytes": grown}
    finally:
        engine.shutdown(drain=False)
    check(out["k1_launches"] == SERVE_BLOCKS * out["batches"],
          f"K1 launched {out['k1_launches']} times in {out['batches']} batches")
    check(out["max_abs_dev_from_apply"] <= SERVE_LIMIT and out["predictions_equal"],
          f"served scores {out['max_abs_dev_from_apply']} off the eager apply")
    return out, probes


def aot_phases(dev, card, scores, X_host, eager) -> dict:
    """``aot_cifar``: the fitted RandomPatchCifarKernel scores chain served
    by ``ServingEngine(buckets=(1, 8, 32, 64))`` against a fresh AOT cache,
    cold (4 exports, each program naming K1 10 times) then warm on a clone
    from ``serialization.loads(dumps(...))`` (4 loads, 4 captures, no call
    of the chain's trace function, K1 10 times a batch); each bucket's
    scores bit-equal cold against warm, and every answer within 1e-5 of the
    eager apply. ``aot_fallback``: one entry overwritten in its middle; the
    next boot exports that bucket alone and answers bit-equal. Returns the
    K1 launches of both boots' traffic."""
    import numpy as np

    from keystone_tpu_torch import compile as compile_mod
    from keystone_tpu_torch.utils import serialization
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    root = tempfile.mkdtemp(prefix="keystone-aot-")
    compile_mod.configure(root)
    build = FittedPipeline._build_trace_fn
    traces = []

    def counted(self):
        fn = build(self)

        def traced(x):
            traces.append(tuple(x.shape))
            return fn(x)

        return traced

    try:
        cache = compile_mod.get_cache()
        FittedPipeline._build_trace_fn = counted
        cold, cold_probes = _aot_boot(scores, X_host, eager)
        cold_traces = len(traces)
        entries = {key: nbytes for key, nbytes, _ in cache.entries()}
        t0 = time.perf_counter()
        clone = serialization.loads(serialization.dumps(scores))
        clone_seconds = time.perf_counter() - t0
        traces.clear()
        warm, warm_probes = _aot_boot(clone, X_host, eager)
        warm_traces = len(traces)
        bit_equal = {b: bool(np.array_equal(cold_probes[b], warm_probes[b]))
                     for b in SERVE_BUCKETS}
        ledger = cache.ledger
        emit({"phase": "aot_cifar", "buckets": list(SERVE_BUCKETS), "cold": cold, "warm": warm,
              "cold_trace_fn_calls": cold_traces, "warm_trace_fn_calls": warm_traces,
              "clone_seconds": clone_seconds, "entry_bytes": sorted(entries.values()),
              "cache_bytes": sum(entries.values()), "cache_bound_bytes": cache.max_bytes,
              "export": [{k: r.get(k) for k in ("shape", "seconds", "save_seconds", "nbytes")}
                         for r in ledger.entries("export")],
              "load": [{k: r.get(k) for k in ("shape", "seconds", "nbytes")}
                       for r in ledger.entries("load")],
              "evictions": len(ledger.entries("evict")),
              "probe_bit_equal": bit_equal, "card": card})
        n = len(SERVE_BUCKETS)
        check((cold["compiles"], cold["aot_loads"], len(entries)) == (n, 0, n),
              f"cold boot: {cold['compiles']} exports, {cold['aot_loads']} loads, "
              f"{len(entries)} entries")
        check(cold["k1_per_program"] == [SERVE_BLOCKS] * n,
              f"K1 calls in the exported programs: {cold['k1_per_program']}")
        check((warm["compiles"], warm["aot_loads"], warm["captures"], warm_traces)
              == (0, n, n, 0), f"warm boot: {warm}, trace function called {warm_traces} times")
        check(warm["device"] == cold["device"], f"devices {cold['device']} / {warm['device']}")
        check(all(bit_equal.values()), f"warm scores differ from cold: {bit_equal}")

        # -- one entry overwritten: that bucket alone is exported again ----
        bad_key = sorted(entries, key=entries.get)[1]
        with open(cache.entry_path(bad_key), "r+b") as f:
            f.seek(entries[bad_key] // 2)
            f.write(b"\0" * 4096)
        traces.clear()
        fallback, fallback_probes = _aot_boot(clone, X_host, eager)
        fb_equal = {b: bool(np.array_equal(warm_probes[b], fallback_probes[b]))
                    for b in SERVE_BUCKETS}
        emit({"phase": "aot_fallback", "overwritten": bad_key, "boot": fallback,
              "trace_fn_calls": len(traces), "probe_bit_equal": fb_equal,
              "entries_after": len(cache.entries()), "card": card})
        check((fallback["compiles"], fallback["aot_loads"]) == (1, n - 1),
              f"after one corrupt entry: {fallback['compiles']} exports, "
              f"{fallback['aot_loads']} loads")
        check(all(fb_equal.values()), f"the re-exported bucket answers differently: {fb_equal}")
        return {"aot_cifar_cold": cold["k1_launches"], "aot_cifar_warm": warm["k1_launches"]}
    finally:
        FittedPipeline._build_trace_fn = build
        compile_mod.reset()
        shutil.rmtree(root, ignore_errors=True)


SEGMENT_SPLIT = 2500  # segment_prewarm's second signature: the first rows of the test set
SEGMENT_LIMIT = 1e-5  # an exported segment's scores against node dispatch's


def _segment_programs():
    """(dispatcher, its programs' callables) of every live segment
    dispatcher."""
    from keystone_tpu_torch.compile import segment

    return [(d, [p.fn for p in d._by_sig.values()]) for d in segment._DISPATCHERS.values()]


def _segment_apply(fitted, X):
    """(scores, K1 launches, exec.segment paths, seconds) of one apply,
    synchronized, under a tracer."""
    from keystone_tpu_torch.obs import tracer as trace_mod
    from keystone_tpu_torch.ops import gaussian_kernel as gk

    tracer = trace_mod.install(trace_mod.Tracer())
    try:
        torch.cuda.synchronize()
        gk.gaussian_kernel_block.launches = 0
        t0 = time.perf_counter()
        out = fitted.apply(X).to_array()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        paths = [sp.attrs.get("path") for sp in tracer.spans() if sp.name == "exec.segment"]
        return out, gk.gaussian_kernel_block.launches, paths, seconds
    finally:
        trace_mod.reset()


def segment_phases(card, scores, Xt, labels) -> dict:
    """Segment dispatch of the fitted full-width RandomPatchCifarKernel
    scores chain (the fused featurizer, the scaler and the K1 mapper, one
    segment that is not row-local, so one program a batch).

    ``segment_cifar``: the 10000 test rows applied three times with
    segments on (each run eager: a whole batch is never captured) and once
    with ``KEYSTONE_SEGMENT_COMPILE=0``: every run bit-equal to node
    dispatch, predictions equal, test error < 0.7, the spans' path
    ``compiled``, K1 10 launches a run. Then against a fresh
    AOT cache directory of its own: a cold executor exports one program a
    signature (the 10000 rows, then the first 2500), each naming K1 10
    times; a warm one loads both, traces 0, and answers bit-equal.
    ``segment_prewarm``: ``prewarm_segment_artifacts`` with a budget of
    2500 rows of elements warms the 2500-row program and skips the other;
    a later executor traces 0. ``flight_fault``: a ``KEYSTONE_FAULTS`` plan
    on ``aot.read`` degrades the first cache read to a miss (one export
    again) and the flight dump holds ``fault.inject`` and
    ``aot.read_degraded``; then the memory watermark after a scan against
    the allocator's peak over the same window. Returns the K1 launches of
    each run."""
    from keystone_tpu_torch import compile as compile_mod
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.compile import segment
    from keystone_tpu_torch.data.chunked import ChunkedDataset
    from keystone_tpu_torch.obs import flight, resource
    from keystone_tpu_torch.obs.flight import SITE_INSTANTS
    from keystone_tpu_torch.obs.ledger import CompileLedger
    from keystone_tpu_torch.ops import gaussian_kernel as gk

    launches = {}
    segment.reset_dispatchers()
    runs = {}
    for run in ("on_first", "on_second", "on_third"):
        runs[run] = _segment_apply(scores, Xt)
    runs["off"] = with_env("KEYSTONE_SEGMENT_COMPILE", "0", lambda: _segment_apply(scores, Xt))
    node = runs["off"][0]
    preds = {k: r[0].argmax(1) for k, r in runs.items()}
    test_error = (preds["on_first"].cpu() != labels).float().mean().item()
    devs = {k: (r[0] - node).abs().max().item() for k, r in runs.items()}
    launches.update({f"segment_cifar_{k}": r[1] for k, r in runs.items()})
    row = {"phase": "segment_cifar", "rows": int(Xt.shape[0]), "test_error": test_error,
           "seconds": {k: r[3] for k, r in runs.items()},
           "k1_launches": {k: r[1] for k, r in runs.items()},
           "paths": {k: r[2] for k, r in runs.items()},
           "max_abs_dev_from_node_dispatch": devs, "limit": SEGMENT_LIMIT,
           "eager_bit_equal_node": bool(torch.equal(runs["on_first"][0], node)),
           "predictions_equal": all(bool(torch.equal(p, preds["off"])) for p in preds.values())}
    check(test_error < 0.7, f"segment_cifar test error {test_error}")
    check(all(runs[k][2] == ["compiled"] for k in ("on_first", "on_second", "on_third"))
          and runs["off"][2] == [], f"exec.segment paths {row['paths']}")
    check(set(row["k1_launches"].values()) == {SERVE_BLOCKS}, f"K1 launches {row['k1_launches']}")
    check(row["eager_bit_equal_node"] and max(devs.values()) == 0.0 and row["predictions_equal"],
          f"segment scores off node dispatch: {devs}")

    root = tempfile.mkdtemp(prefix="keystone-segment-aot-")
    try:
        cache = compile_mod.configure(root)
        segment.reset_dispatchers()
        cold = {"full": _segment_apply(scores, Xt), "split": _segment_apply(scores, Xt[:SEGMENT_SPLIT])}
        ((disp, programs),) = _segment_programs()
        cold_counts = (disp.traced_count, disp.loaded_count)
        k1_per_program = sorted(_k1_calls(p) for p in programs)
        entries = {key: nbytes for key, nbytes, _ in cache.entries()}
        segment.reset_dispatchers()  # a new process's view of the cache
        warm = {"full": _segment_apply(scores, Xt), "split": _segment_apply(scores, Xt[:SEGMENT_SPLIT])}
        ((disp, _),) = _segment_programs()
        warm_counts = (disp.traced_count, disp.loaded_count)
        bit_equal = {k: bool(torch.equal(cold[k][0], warm[k][0])) for k in cold}
        ledger = CompileLedger.for_cache_root(cache.root)
        row["aot"] = {
            "cold_traced_loaded": cold_counts, "warm_traced_loaded": warm_counts,
            "k1_per_program": k1_per_program, "entry_bytes": sorted(entries.values()),
            "cache_bytes": sum(entries.values()), "cache_bound_bytes": cache.max_bytes,
            "evictions": len(ledger.entries("evict")),
            "trace": [{k: r.get(k) for k in ("seconds", "inputs")} for r in ledger.entries("trace")
                      if r.get("kind") == "segment"],
            "export": [{k: r.get(k) for k in ("seconds", "save_seconds", "nbytes")}
                       for r in ledger.entries("export") if r.get("kind") == "segment"],
            "load": [{k: r.get(k) for k in ("seconds", "nbytes")}
                     for r in ledger.entries("load") if r.get("kind") == "segment"],
            "seconds": {f"{w}_{k}": r[3] for w, runs_ in (("cold", cold), ("warm", warm))
                        for k, r in runs_.items()},
            "k1_launches": {f"{w}_{k}": r[1] for w, runs_ in (("cold", cold), ("warm", warm))
                            for k, r in runs_.items()},
            "cold_max_abs_dev_from_node_dispatch": (cold["full"][0] - node).abs().max().item(),
            "warm_bit_equal_cold": bit_equal}
        launches.update({f"segment_cifar_aot_{k}": v for k, v in row["aot"]["k1_launches"].items()})
        row["card"] = card
        emit(row)
        check(cold_counts == (2, 0) and warm_counts == (0, 2),
              f"traced/loaded cold {cold_counts}, warm {warm_counts}")
        check(k1_per_program == [SERVE_BLOCKS, SERVE_BLOCKS],
              f"K1 calls in the exported segment programs: {k1_per_program}")
        check(all(bit_equal.values()), f"warm segment scores differ from cold: {bit_equal}")
        check(row["aot"]["cold_max_abs_dev_from_node_dispatch"] <= SEGMENT_LIMIT,
              f"the exported segment is {row['aot']['cold_max_abs_dev_from_node_dispatch']} off")

        # -- segment_prewarm: the manifest's programs under an element budget
        segment.reset_dispatchers()
        budget = SEGMENT_SPLIT * int(Xt[0].numel())
        gk.gaussian_kernel_block.launches = 0
        t0 = time.perf_counter()
        warmed = segment.prewarm_segment_artifacts(cache, max_elements=budget)
        prewarm_seconds = time.perf_counter() - t0
        launches["segment_prewarm"] = gk.gaussian_kernel_block.launches
        sigs = [s for d in compile_mod.segment_digests(cache)
                for s in compile_mod.segment_signatures(cache, d)]
        over = [s for s in sigs if sum(math.prod(shape) for shape, _ in s) > budget]
        later = {"full": _segment_apply(scores, Xt), "split": _segment_apply(scores, Xt[:SEGMENT_SPLIT])}
        ((disp, _),) = _segment_programs()
        later_counts = (disp.traced_count, disp.loaded_count)
        launches.update({f"segment_prewarm_later_{k}": r[1] for k, r in later.items()})
        emit({"phase": "segment_prewarm", "max_elements": budget,
              "signatures": [[list(sh) for sh, _ in s] for s in sigs],
              "over_budget": len(over), "warmed": warmed, "seconds": prewarm_seconds,
              "later_traced_loaded": later_counts,
              "later_bit_equal_cold": {k: bool(torch.equal(later[k][0], cold[k][0])) for k in later},
              "card": card})
        check(len(sigs) == 2 and len(over) == 1 and warmed == 1,
              f"prewarm warmed {warmed} of {len(sigs)} signatures, {len(over)} over budget")
        check(later_counts == (0, 2), f"after prewarm: traced/loaded {later_counts}")

        # -- flight_fault: an aot.read fault, its instants in the flight dump
        flight_dir = tempfile.mkdtemp(prefix="keystone-flight-")
        segment.reset_dispatchers()
        flight.reset()
        faults.clear()
        plan = "aot.read=transient@0"
        out = with_env("KEYSTONE_FAULTS", plan,
                       lambda: _segment_apply(scores, Xt[:SEGMENT_SPLIT]))
        launches["flight_fault"] = out[1]
        ((disp, _),) = _segment_programs()
        fault_counts = (disp.traced_count, disp.loaded_count)
        path = flight.dump("flight_fault", path=os.path.join(flight_dir, "flight.json"))
        with open(path) as f:
            doc = json.load(f)
        names = [e["name"] for e in doc["entries"]]
        injected = [e for e in doc["entries"] if e["name"] == "fault.inject"]
        # the watermark: a scan of card chunks, sampled at its end, against
        # the allocator's peak over the same window
        resource.reset()
        X = torch.randn(64 * 4096, 1024, device=Xt.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ds = ChunkedDataset.from_chunk_fn(lambda i: X[i * 4096:(i + 1) * 4096], 64, 64 * 4096)
        total = sum(float((c * 2.0).sum()) for c in ds.chunks())
        torch.cuda.synchronize()
        wm_peak = resource.watermark().peak
        peak = torch.cuda.max_memory_allocated()
        del X, ds
        emit({"phase": "flight_fault", "plan": plan, "traced_loaded": fault_counts,
              "dump": path, "entries": len(doc["entries"]), "names": sorted(set(names)),
              "fault_inject": [e.get("attrs") for e in injected],
              "recovery_instant": SITE_INSTANTS["aot.read"],
              "bit_equal_cold": bool(torch.equal(out[0], cold["split"][0])),
              "watermark_peak_bytes": wm_peak, "max_memory_allocated_bytes": peak,
              "watermark_over_peak": wm_peak / peak, "scan_sum": total, "card": card})
        check(fault_counts == (1, 0), f"a degraded read exports again: {fault_counts}")
        check([e["attrs"].get("site") for e in injected] == ["aot.read"],
              f"fault.inject instants {injected}")
        check(SITE_INSTANTS["aot.read"] in names, f"no {SITE_INSTANTS['aot.read']} in {names}")
        check(abs(wm_peak - peak) <= 0.05 * peak,
              f"the watermark's peak {wm_peak} B is more than 5 % off the allocator's {peak} B")
        shutil.rmtree(flight_dir, ignore_errors=True)
    finally:
        faults.clear()
        compile_mod.reset()
        segment.reset_dispatchers()
        shutil.rmtree(root, ignore_errors=True)
    return launches


def segment_apply_cost(name, fitted, X, card) -> None:
    """``segment_apply_<name>``: the first apply of a fitted chain (its
    segment plan dropped) with segments on against the same apply with them
    off, in one run: off, on (the first: it plans and captures its row
    chunks), on (the second: the plan kept, the graphs replayed), off
    again. Beside them the planning alone and the segments' digests alone:
    with no cache and no profile store a plan computes no digest, so what a
    first apply adds is its planning and its captures. The predictions of
    both dispatches equal."""
    from keystone_tpu_torch.compile import segment
    from keystone_tpu_torch.workflow.executor import GraphExecutor
    from keystone_tpu_torch.workflow.pipeline import _bind_source, attach_data

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = run()
        torch.cuda.synchronize()
        return value, time.perf_counter() - t0

    def apply():
        return fitted.apply(X).to_array()

    def node_apply():
        return with_env("KEYSTONE_SEGMENT_COMPILE", "0", apply)

    segment.reset_dispatchers()
    fitted._segment_plan = None
    seconds = {}
    y_off, seconds["off"] = timed(node_apply)
    segment.reset_path_counts()
    y_on, seconds["on_first"] = timed(apply)
    _, seconds["on_second"] = timed(apply)
    paths = segment.path_counts()
    _, seconds["off_again"] = timed(node_apply)
    graph = _bind_source(fitted.graph, fitted._source, attach_data, X)
    plan, plan_seconds = timed(lambda: GraphExecutor(graph, optimize=False)
                               ._plan_segment_bindings())
    bindings = list({id(b): b for b in plan.values()}.values())
    _, digest_seconds = timed(lambda: [b.digest for b in bindings])
    equal = bool(torch.equal(y_on, y_off))
    emit({"phase": f"segment_apply_{name}", "rows": int(X.shape[0]), "seconds": seconds,
          "plan_seconds": plan_seconds, "digest_seconds": digest_seconds,
          "segments": [len(b) for b in bindings], "paths_on": paths,
          "predictions_equal": equal, "card": card})
    check(equal, f"{name}: segment and node dispatch predict differently")
    check(paths.get("compiled", 0) == 2 and set(paths) == {"compiled"},
          f"{name}: segment paths {paths}")
    segment.reset_dispatchers()
    del plan, bindings, graph


def segment_mnist_phase(cli, bcd, card, on, preds_on, Xm) -> None:
    """``segment_mnist``: MnistRandomFFT at 200 FFTs run again through the
    command line with ``KEYSTONE_SEGMENT_COMPILE=0``, against the run with
    segments on (``mnist_full_width``, whose peak is the gated one): test
    errors < 0.35, 50 block steps each, the test predictions equal. First,
    ``segment_apply_mnist`` (:func:`segment_apply_cost`) on the run's
    fitted chain."""
    from keystone_tpu_torch.nodes.util import MaxClassifier

    segment_apply_cost("mnist", on["scorer"].and_then(MaxClassifier()).fit(), Xm, card)

    def node_run():
        out = cli_run(cli, bcd, MNIST_FULL)
        preds = out["scorer"].and_then(MaxClassifier()).fit().apply(Xm).to_array()
        return out, preds

    off, preds_off = with_env("KEYSTONE_SEGMENT_COMPILE", "0", node_run)
    feature_bytes = 60000 * MNIST_FULL_FFTS * 512 * 4
    equal = bool(torch.equal(preds_off.cpu(), preds_on))
    emit({"phase": "segment_mnist", "num_ffts": MNIST_FULL_FFTS,
          "test_error": {"on": on["test_error"], "off": off["test_error"]},
          "block_steps": {"on": on["block_steps"], "off": off["block_steps"]},
          "seconds": {"on": on["seconds"], "off": off["seconds"]},
          "phase_seconds": {"on": on["phases"], "off": off["phases"]},
          "peak_mem_gb": {"on": on["peak_mem_bytes"] / 1e9, "off": off["peak_mem_bytes"] / 1e9},
          "peak_over_features_on": on["peak_mem_bytes"] / feature_bytes,
          "predictions_equal": equal, "card": card})
    check(on["test_error"] < 0.35 and off["test_error"] < 0.35,
          f"test errors {on['test_error']} / {off['test_error']}")
    check(on["block_steps"] == off["block_steps"] == MNIST_FULL_STEPS,
          f"block steps {on['block_steps']} / {off['block_steps']}")
    check(on["peak_mem_bytes"] < 1.5 * feature_bytes, f"peak {on['peak_mem_bytes']} B with segments")
    check(equal, "segment and node dispatch predict differently at 200 FFTs")


def start_aot_coldstart():
    """``python -m keystone_tpu_torch.compile.coldstart`` twice in fresh
    processes on the card against one cache directory, one after the other
    on a thread of their own; :func:`aot_coldstart_phase` reads them."""
    out = {}

    def run():
        root = tempfile.mkdtemp(prefix="keystone-coldstart-")
        here = os.path.dirname(os.path.abspath(__file__))
        try:
            runs = []
            for _ in range(2):
                proc = subprocess.run(
                    [sys.executable, "-m", "keystone_tpu_torch.compile.coldstart",
                     "--cache", root], cwd=here, capture_output=True, text=True, timeout=600)
                check(proc.returncode == 0,
                      f"coldstart: {proc.stdout[-2000:]}{proc.stderr[-3000:]}")
                runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            out["runs"] = runs
        except BaseException as e:  # raised on the main thread by the phase
            out["error"] = e
        finally:
            shutil.rmtree(root, ignore_errors=True)

    thread = threading.Thread(target=run, name="aot-coldstart")
    thread.start()
    return thread, out


def aot_coldstart_phase(started, card) -> None:
    """``aot_coldstart``: the two runs of :func:`start_aot_coldstart`. The
    first exports every bucket, the second loads every one and traces none;
    both answer as the fitted pipeline's own apply."""
    thread, out = started
    thread.join()
    if "error" in out:
        raise out["error"]
    runs = out["runs"]
    for run in runs:
        print(json.dumps(run), flush=True)
    emit({"phase": "aot_coldstart", "cold": runs[0], "warm": runs[1],
          "beside": "cuda_card_tests", "card": card})
    n = len(runs[0]["buckets"])
    check((runs[0]["compiles"], runs[0]["aot_loads"]) == (n, 0), f"cold probe {runs[0]}")
    check((runs[1]["compiles"], runs[1]["aot_loads"], runs[1]["captures"]) == (0, n, n),
          f"warm probe {runs[1]}")
    check(runs[0]["outputs_match"] and runs[1]["outputs_match"], "coldstart answers differ")


def sweep_demo_phase(cli, card) -> None:
    """``sweep_demo``: ``--sweep-demo`` at its defaults on the card: the
    prefix featurized once, every λ from one Gram, absorb, and a hot swap
    with no failed request."""
    import io

    fresh_env()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--sweep-demo"])
    out = buf.getvalue()
    emit({"phase": "sweep_demo", "returncode": rc, "lines": out.strip().splitlines()[-4:],
          "seconds": time.perf_counter() - t0, "card": card})
    check(rc == 0 and "SWEEP PASS" in out, f"--sweep-demo: {out[-2000:]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    started = time.perf_counter()
    import keystone_tpu_torch
    from keystone_tpu_torch import __main__ as cli
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.linalg import bcd
    from keystone_tpu_torch.nodes.learning.kernel import KernelRidgeRegression
    from keystone_tpu_torch.ops import _build
    from keystone_tpu_torch.ops import gaussian_kernel as gk
    from keystone_tpu_torch.loaders.cifar import synthetic_cifar
    from keystone_tpu_torch.pipelines import cifar_extras
    from keystone_tpu_torch.pipelines import mnist_random_fft as mnist
    from keystone_tpu_torch.nodes.images.core import Convolver
    from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.nodes.util import MaxClassifier
    from keystone_tpu_torch import cost
    from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
    from keystone_tpu_torch.nodes.learning.kernel import (
        ExactKernelRidge, KernelBlockLinearMapper, KernelRidgeEstimator,
    )
    from keystone_tpu_torch.workflow.env import PipelineEnv
    from keystone_tpu_torch.workflow.expressions import DatasetExpression
    from keystone_tpu_torch.workflow.fusion import (
        FusedTransformerOperator, forward_in_row_chunks,
    )
    from keystone_tpu_torch.workflow.cuda_graph import GraphCache
    from keystone_tpu_torch.workflow.operators import DatasetOperator
    from keystone_tpu_torch.workflow.pipeline import Pipeline, clock
    from keystone_tpu_torch.workflow.rules import RuleExecutor

    dev = keystone_tpu_torch.device()
    card = card_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if sys.argv[1:] == ["--solve-check-controls"]:
        solve_check_controls(dev, card)
        print(card, flush=True)
        return 0

    t0 = time.perf_counter()
    _build.build("gaussian_kernel")
    gk._lib()
    # registers, shared memory and spills of every kernel function in the file
    emit({"phase": "build", "kernel": "gaussian_kernel",
          "seconds": time.perf_counter() - t0,
          "ptxas": [l.strip() for l in _build.BUILD_INFO["gaussian_kernel"]["log"].splitlines()
                    if l.strip()]})

    # -- each kernel against its plain version, on the card --------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for n, d, b in CHECK_SHAPES + PROFILER_SHAPES:
        X = torch.randn(n, d, device=dev, generator=gen)
        Xb = torch.randn(b, d, device=dev, generator=gen)
        got = gk.gaussian_kernel_block(X, Xb, GAMMA)
        want = gk.gaussian_kernel_block_plain(X, Xb, GAMMA)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        max_err = max(max_err, err)
        emit({"phase": "kernel_check", "kernel": "gaussian_kernel_block",
              "shape": [n, d, b], "max_abs_err": err, "atol": 1e-5, "rtol": 1e-4,
              **({"role": "auto-cache profiler"} if (n, d, b) in PROFILER_SHAPES else {})})
        del X, Xb, got, want
    # rows 132 B apart starting 4 B past a 16-byte edge, as a row slice passes them
    X = torch.randn(2001, 33, device=dev, generator=gen)[1:]
    got = gk.gaussian_kernel_block(X, X[300:700], GAMMA)
    want = gk.gaussian_kernel_block_plain(X, X[300:700], GAMMA)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    max_err = max(max_err, err)
    emit({"phase": "kernel_check", "kernel": "gaussian_kernel_block", "shape": [2000, 33, 400],
          "rows": "X[1:] and X[301:701], unaligned", "max_abs_err": err, "atol": 1e-5, "rtol": 1e-4})
    # a self block at the fit shape, as the KRR fit passes it: each row of
    # the block is a row of X, and its x·x is a sum of d products of one
    # sign, where tensor-core partial sums that are not promoted drift
    n, d, b = FIT_SHAPE
    X = torch.randn(n, d, device=dev, generator=gen)
    got = gk.gaussian_kernel_block(X, X[2 * b:3 * b], SELF_GAMMA)
    want = gk.gaussian_kernel_block_plain(X, X[2 * b:3 * b], SELF_GAMMA)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    diag = got[2 * b:3 * b].diagonal()
    emit({"phase": "kernel_check", "kernel": "gaussian_kernel_block", "shape": [n, d, b],
          "rows": "X against X[2b:3b]", "gamma": SELF_GAMMA, "max_abs_err": err,
          "diagonal_min": diag.min().item(), "diagonal_max": diag.max().item(),
          "atol": 1e-5, "rtol": 1e-4})
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    max_err = max(max_err, err)
    del X, got, want, diag
    # the 3xTF32 cross term against the exact block: one TF32 pass would fail
    n, d, b = F64_SHAPE
    X = torch.randn(n, d, device=dev, generator=gen)
    Xb = torch.randn(b, d, device=dev, generator=gen)
    exact = gk.gaussian_kernel_block_plain(X.double(), Xb.double(), GAMMA)
    f64 = {"kernel": (gk.gaussian_kernel_block(X, Xb, GAMMA).double() - exact).abs().max().item(),
           "plain": (gk.gaussian_kernel_block_plain(X, Xb, GAMMA).double() - exact)
           .abs().max().item()}
    emit({"phase": "kernel_accuracy_f64", "kernel": "gaussian_kernel_block", "shape": [n, d, b],
          "gamma": GAMMA, "max_abs_err_vs_float64": f64, "limit": F64_LIMIT})
    check(f64["kernel"] <= F64_LIMIT, f"K1 is {f64['kernel']} off the float64 block")
    del X, Xb, exact

    # timed at the main path's shapes; the block is a row slice of the
    # data, as the KRR fit passes it
    timings = {}
    for label, (n, d, b) in (("fit", FIT_SHAPE), ("apply", APPLY_SHAPE),
                             ("chunk", CHUNK_SHAPE), ("exact_block", EXACT_SHAPES[0]),
                             ("exact_tail", EXACT_SHAPES[1]),
                             ("profiler_fit", PROFILER_SHAPES[2]),
                             ("profiler_apply", PROFILER_SHAPES[5])):
        X = torch.randn(max(n, FIT_SHAPE[0]), d, device=dev, generator=gen)
        Xq, Xb = X[:n], X[2 * b:3 * b]
        row = {}
        for _ in range(2):  # plain, kernel, library, then again
            row.setdefault("plain_ms", []).append(
                time_ms(lambda: gk.gaussian_kernel_block_plain(Xq, Xb, GAMMA)))
            row.setdefault("ms", []).append(
                time_ms(lambda: gk.gaussian_kernel_block(Xq, Xb, GAMMA)))
            row.setdefault("library_ms", []).append(
                time_ms(lambda: torch.exp(-GAMMA * torch.cdist(Xq, Xb).square())))
        timings[label] = dict({k: min(v) for k, v in row.items()},
                              **gaussian_bound_ms(n, d, b), shape=[n, d, b])
        timings[label]["share_of_bound"] = timings[label]["bound_ms"] / timings[label]["ms"]
        emit(dict({"phase": "kernel_time", "kernel": "gaussian_kernel_block",
                   "main_path_role": label, "card": card}, **timings[label],
                  all_runs=row))
        del X, Xq, Xb

    # -- exact algebra: one KRR block is a dense (K + λI) W = Y solve -----
    n, d, k = 5000, 800, 10
    rng = torch.Generator(device=dev).manual_seed(5)
    protos = 0.6 * torch.randn(k, d, device=dev, generator=rng)
    y = torch.randint(0, k, (n,), device=dev, generator=rng)
    X = protos[y] + torch.randn(n, d, device=dev, generator=rng)
    Y = -torch.ones(n, k, device=dev)
    Y[torch.arange(n, device=dev), y] = 1.0
    # bench.py's λ = 1e-4 per training row, here for the block's n rows
    gamma, lam = 1.0 / (2.0 * d), 1e-4 * n
    model = KernelRidgeRegression(gamma, lam, block_size=n, num_epochs=1,
                                  cache_kernel=False).fit(Dataset.of(X), Dataset.of(Y))
    K = gk.gaussian_kernel_block_plain(X, X, gamma)
    W_direct = torch.linalg.solve(K + lam * torch.eye(n, device=dev), Y)
    exact_dev = (model.W - W_direct).abs().max().item()
    emit({"phase": "exact_algebra", "n": n, "d": d, "lambda": lam,
          "max_abs_dev": exact_dev, "limit": 1e-2})
    if not exact_dev <= 1e-2:
        raise AssertionError(f"single-block KRR is {exact_dev} off the dense solve")
    del X, Y, K, W_direct, model

    # -- the slice on a small input: card (kernel) against CPU (plain) ---
    conf = cifar_extras.KernelCifarConfig(
        num_filters=16, lam=1.0, gamma=1e-3, block_size=64, whitener_size=2000,
        pool_size=8, pool_stride=7)
    train, test = synthetic_cifar(192, seed=7), synthetic_cifar(48, seed=8)
    scores = {}
    for name, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
        fresh_env()
        scorer, _, _, _ = cifar_extras.run_random_patch_cifar_kernel(train, test, conf, where)
        scores[name] = scorer.fit().apply(test.data.to_array().to(where)).to_array().cpu()
    small_dev = (scores["cuda"] - scores["cpu"]).abs().max().item()
    emit({"phase": "small_slice_vs_cpu", "max_abs_dev": small_dev, "limit": 1e-3})
    check(small_dev <= 1e-3, f"the slice on the card is {small_dev} off the CPU run")

    # -- the main path at full width, through the command line's code ----
    fresh_env()
    gk.gaussian_kernel_block.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with Probe() as probe:
        probe.watch_fit(Pipeline)
        for cls in (StandardScaler, KernelRidgeRegression):
            probe.watch(cls, "fit")
        probe.watch(Convolver, "forward")
        probe.watch(GraphCache, "__call__")
        probe.watch(RuleExecutor, "execute")
        out = cli.run(SLICE_ARGS)
        launches = gk.gaussian_kernel_block.launches
        peak = torch.cuda.max_memory_allocated()
        # fit-once: the classifier's fit after the run loads the saved fits
        fitted = out["scorer"].and_then(MaxClassifier()).fit()
    fits = {k: v for k, v in probe.calls.items() if k.split(":")[0].endswith(".fit")}
    emit({"phase": "slice", "app": "RandomPatchCifarKernel", "args": SLICE_ARGS,
          "train_error": out["train_error"], "test_error": out["test_error"],
          "seconds": out["seconds"], "phase_seconds": out["phases"],
          "gaussian_kernel_block_launches": launches, "estimator_fits": fits,
          "rows": dict(probe.rows), "fitted_chain": chain(fitted),
          "fitted_fused_steps": fused_steps(fitted.graph),
          "optimizer_seconds": {k: v for k, v in probe.seconds.items()
                                if k.startswith("RuleExecutor")},
          "peak_mem_gb": peak / 1e9, "card": card})
    check(launches == SLICE_LAUNCHES, f"K1 launched {launches} times, want {SLICE_LAUNCHES}")
    check(out["test_error"] < 0.7, f"test error {out['test_error']} is not below 0.7")
    check(fits == {"StandardScaler.fit:fit": 1, "KernelRidgeRegression.fit:fit": 1},
          f"each estimator must fit once, in fit(): {fits}")
    # the fused featurizer's graph replays see the rows; the Convolver's
    # Python code runs only at a warm-up and a capture
    check(probe.rows["GraphCache.__call__:fit"] == 50000,
          f"the featurizer's graphs saw {probe.rows['GraphCache.__call__:fit']} rows "
          "in fit(), want 50000")
    check(chain(fitted) == ["FusedTransformerOperator", "StandardScalerModel",
                            "KernelBlockLinearMapper", "MaxClassifier"],
          f"fitted chain {chain(fitted)}")
    check(fused_steps(fitted.graph) == [["Convolver", "SymmetricRectifier", "Pooler",
                                         "ImageVectorizer"]],
          f"fused groups {fused_steps(fitted.graph)}")
    del fitted, probe

    # -- one-program apply of the fitted full-width CIFAR chain ----------
    scores = out["scorer"].fit()  # fit-once: the run's fits, no new one
    cifar_test = synthetic_cifar(10000, seed=2)  # the CLI's test set
    Xt_host = cifar_test.data.to_array().numpy()
    Xt = torch.from_numpy(Xt_host).to(dev)
    secs = {}
    t0 = clock()
    eager = scores.apply(Xt).to_array()
    secs["eager_apply"] = clock() - t0
    # the default optimizer's run, for the auto-cached and traced runs
    slice_ref = {"predictions": eager.argmax(dim=1).cpu(), "seconds": out["seconds"]}
    captures = []
    scores.compile(on_trace=captures.append)
    results, k1 = {}, {}
    for name, call in (("whole", lambda: scores.apply_compiled(Xt)),
                       ("chunked", lambda: scores.apply_chunked(Xt_host, chunk_size=CHUNK)
                        .to_array())):
        t0 = clock()
        call()  # the warm-up, the capture and one replay
        secs[f"{name}_first_call"] = clock() - t0
        gk.gaussian_kernel_block.launches = 0
        t0 = clock()
        results[name] = call()
        secs[f"{name}_replay"] = clock() - t0
        k1[name] = gk.gaussian_kernel_block.launches
    devs = {name: (r - eager).abs().max().item() for name, r in results.items()}
    preds_equal = {name: bool(torch.equal(r.argmax(1), eager.argmax(1)))
                   for name, r in results.items()}
    emit({"phase": "compiled_cifar", "rows": Xt.shape[0], "chunk_size": CHUNK,
          "seconds": secs, "max_abs_dev_from_apply": devs, "limit": 1e-5,
          "predictions_equal": preds_equal, "k1_launches_per_call": k1,
          "compiled_signatures": [[list(s), t] for s, t in scores.compiled_signatures],
          "compile_count": scores.compile_count, "captures": len(captures), "card": card})
    check(all(v <= 1e-5 for v in devs.values()), f"compiled outputs off apply: {devs}")
    check(all(preds_equal.values()), f"compiled predictions differ: {preds_equal}")
    check(k1 == {"whole": 10, "chunked": 40}, f"K1 launches per call {k1}, want 10 and 40")
    check(scores.compile_count == len(set(scores.compiled_signatures)) == len(captures) == 2,
          f"signatures {scores.compiled_signatures}")
    compiled_launches = sum(k1.values())

    # -- the serving engine on the fitted chain (slice 15) ---------------
    serve_launches, engine_ref = serve_phases(dev, card, scores, Xt_host, eager)
    # -- the same chain from a fleet of 4 co-resident replicas (slice 18)
    fleet_launches, fleet_ref = fleet_phases(card, scores, Xt_host, eager, engine_ref)
    # -- the same chain on the card and a copy on the host (slice 22)
    devices_launches = fleet_devices_phases(card, scores, Xt_host, eager)
    # -- the same chain from worker processes behind a router (slice 19)
    cluster_launches = cluster_phases(card, scores, Xt_host, eager, engine_ref, fleet_ref)
    # -- the same chain booted cold, then warm, from the AOT cache (slice 16)
    aot_launches = aot_phases(dev, card, scores, Xt_host, eager)
    # -- segment dispatch of the same chain, exported and prewarmed (slice 17)
    segment_launches = segment_phases(card, scores, Xt, cifar_test.labels.to_array())
    del cifar_test

    # -- the KRR family on 8000 of the fit's features: the chooser picks
    # the exact solve, whose kernel is two K1 column blocks ------------
    mapper = next(op for op in scores.graph.operators.values()
                  if isinstance(op, KernelBlockLinearMapper))
    F = mapper.train_X[:KRR_ROWS]
    Y = next(op.dataset.payload for op in out["scorer"].graph.operators.values()
             if isinstance(op, DatasetOperator)
             and tuple(op.dataset.payload.shape) == (50000, 10))[:KRR_ROWS]
    del scores, results, eager, Xt, out
    est = KernelRidgeEstimator(GAMMA, KRR_LAMBDA, 5000, 1)
    fresh_env()
    cost.reset_sampling()
    gk.gaussian_kernel_block.launches = 0
    with Probe() as probe:
        probe.watch_fit(Pipeline)
        for cls in (ExactKernelRidge, KernelRidgeRegression, KernelRidgeEstimator):
            probe.watch(cls, "fit")
        t0 = clock()
        krr = est.with_data(F, Y).fit()
        fit_seconds = clock() - t0
    krr_launches = gk.gaussian_kernel_block.launches
    fits = {k: v for k, v in probe.calls.items() if k.split(":")[0].endswith(".fit")}
    W = next(op.W for op in krr.graph.operators.values()
             if isinstance(op, KernelBlockLinearMapper))
    K = gk.gaussian_kernel_block_plain(F.double(), F.double(), GAMMA)
    residual = (torch.linalg.norm(K @ W.double() + KRR_LAMBDA * W.double() - Y.double())
                / torch.linalg.norm(Y.double())).item()
    choices = {n: est.choose_solver(cost.ShapeSignature(n, F.shape[1], Y.shape[1]))
               for n in (KRR_ROWS, 50000)}
    emit({"phase": "krr_family", "n": KRR_ROWS, "d": F.shape[1], "gamma": GAMMA,
          "lambda": KRR_LAMBDA, "block_size": 5000, "estimator_fits": fits,
          "fit_seconds": fit_seconds, "k1_launches": krr_launches,
          "relative_residual": residual, "residual_limit": 1e-4,
          "choices": {n: {"label": c.label, "units": {k: r["units"] for k, r in c.costs.items()}}
                      for n, c in choices.items()},
          "sampling_executions": cost.sampling_executions(), "card": card})
    check(fits == {"ExactKernelRidge.fit:fit": 1}, f"the exact solve must fit once: {fits}")
    check(krr_launches == 2, f"K1 launched {krr_launches} times in the exact fit, want 2")
    check(residual < 1e-4, f"relative residual {residual} of the exact solve")
    check(choices[KRR_ROWS].label == "ExactKernelRidge"
          and choices[50000].label == "KernelRidgeRegression",
          f"chooser picked {choices[KRR_ROWS].label} and {choices[50000].label}")
    del krr, W, K, F, Y, probe

    # -- MnistRandomFFT small: the card (cuFFT, cuBLAS) against the CPU ---
    mconf = mnist.MnistRandomFFTConfig(num_ffts=2, block_size=512, lam=10.0)
    mtrain, mtest = mnist.synthetic_mnist(4096, 512, seed=7)
    scores, errs = {}, {}
    for name, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
        fresh_env()
        scorer, tr, te, _ = mnist.run(mtrain, mtest, mconf, where)
        scores[name] = scorer.fit().apply(mtest.data.to_array().to(where)).to_array().cpu()
        errs[name] = [tr, te]
    mnist_dev = (scores["cuda"] - scores["cpu"]).abs().max().item()
    emit({"phase": "mnist_small_vs_cpu", "max_abs_dev": mnist_dev, "limit": 1e-3,
          "errors_cuda": errs["cuda"], "errors_cpu": errs["cpu"]})
    check(mnist_dev <= 1e-3, f"MnistRandomFFT on the card is {mnist_dev} off the CPU run")

    # -- MnistRandomFFT at BASELINE's configuration, against Bayes --------
    bayes = mnist.bayes_error_mc(mnist.DATA_SEED)
    out = cli_run(cli, bcd, MNIST_CANONICAL)
    gate = 1.5 * bayes + 0.005
    emit({"phase": "mnist_canonical", "args": MNIST_CANONICAL,
          "train_error": out["train_error"], "test_error": out["test_error"],
          "bayes_error": bayes, "test_error_limit": gate, "seconds": out["seconds"],
          "phase_seconds": out["phases"], "wall_seconds": out["wall_seconds"],
          "block_steps": out["block_steps"], "peak_mem_gb": out["peak_mem_bytes"] / 1e9,
          "card": card})
    check(out["test_error"] <= gate,
          f"test error {out['test_error']} is above 1.5 × Bayes {bayes} + 0.005")

    # -- MnistRandomFFT at the CLI's default width ------------------------
    feature_bytes = 60000 * 200 * 512 * 4
    full_steps = MNIST_FULL_FFTS * 3 + 2  # sign, FFT, rectify per branch; gather; combiner
    with Probe() as probe:
        probe.watch_fit(Pipeline)
        probe.watch(BlockLeastSquaresEstimator, "fit")
        probe.watch(RuleExecutor, "execute")
        out = cli_run(cli, bcd, MNIST_FULL)
        fit_graph = probe.last["RuleExecutor.execute:fit"][0]
        fitted = out["scorer"].and_then(MaxClassifier()).fit()
    fits = {k: v for k, v in probe.calls.items() if k.startswith("BlockLeast")}
    emit({"phase": "mnist_full_width", "args": MNIST_FULL,
          "train_error": out["train_error"], "test_error": out["test_error"],
          "bayes_error": bayes, "seconds": out["seconds"],
          "phase_seconds": out["phases"], "wall_seconds": out["wall_seconds"],
          "block_steps": out["block_steps"], "feature_bytes": feature_bytes,
          "peak_mem_gb": out["peak_mem_bytes"] / 1e9,
          "peak_over_features": out["peak_mem_bytes"] / feature_bytes,
          "estimator_fits": fits, "fitted_chain": chain(fitted),
          "fitted_fused_steps": [len(g) for g in fused_steps(fitted.graph)],
          "fit_graph_nodes": len(fit_graph.nodes),
          "fit_graph_fused_steps": [len(g) for g in fused_steps(fit_graph)],
          "optimize_seconds": out["phases"]["optimize"],
          "executor_seconds": out["phases"]["executor"], "card": card})
    check(out["block_steps"] == MNIST_FULL_STEPS,
          f"{out['block_steps']} BCD block steps, want {MNIST_FULL_STEPS}")
    check(out["test_error"] < 0.35, f"test error {out['test_error']} is not below 0.35")
    check(out["peak_mem_bytes"] < 1.5 * feature_bytes,
          f"peak memory {out['peak_mem_bytes']} B is not below 1.5 × the "
          f"{feature_bytes} B feature matrix")
    check(fits == {"BlockLeastSquaresEstimator.fit:fit": 1},
          f"the BCD estimator must fit once, in fit(): {fits}")
    check(chain(fitted) == ["FusedTransformerOperator", "BlockLinearMapper", "MaxClassifier"],
          f"fitted chain {chain(fitted)}")
    check([len(g) for g in fused_steps(fitted.graph)] == [full_steps],
          f"fitted fused groups {[len(g) for g in fused_steps(fitted.graph)]}")
    check([len(g) for g in fused_steps(fit_graph)] == [full_steps, full_steps],
          f"fit-graph fused groups {[len(g) for g in fused_steps(fit_graph)]}")
    del fit_graph

    # -- one-program apply at 200 FFTs: the test rows through apply_chunked
    mtrain, mtest = mnist.synthetic_mnist(60000, 10000)  # the command line's data
    Xm_host = mtest.data.to_array().numpy()
    Xm = torch.from_numpy(Xm_host).to(dev)
    secs = {}
    t0 = clock()
    eager_m = fitted.apply(Xm)
    secs["eager_apply"] = clock() - t0
    mnist_ref = {"predictions": eager_m.to_array().cpu(), "seconds": out["seconds"]}
    del eager_m
    fitted.compile()
    for name in ("chunked_first_call", "chunked_replay"):
        t0 = clock()
        preds = fitted.apply_chunked(Xm_host, chunk_size=CHUNK).to_array()
        secs[name] = clock() - t0
    compiled_err = MulticlassClassifierEvaluator(mnist.NUM_CLASSES).evaluate(
        preds.cpu().numpy(), mtest.labels).total_error
    peak = torch.cuda.max_memory_allocated()  # since the full-width run began
    # a fused group's replays against its eager run of the same chunks
    (fused,) = [op for op in fitted.graph.operators.values()
                if isinstance(op, FusedTransformerOperator)]
    eager_f = forward_in_row_chunks(fused.forward, [Xm], Xm.shape[0])
    replay_f = fused.batch_transform([DatasetExpression.now(Dataset(Xm))]).to_array()
    bit_equal = bool(torch.equal(eager_f, replay_f))
    del eager_f, replay_f, preds
    # the featurizer over the first training rows, traced both ways
    Xtr = mtrain.data.to_array()[:MNIST_TRACE_ROWS].to(dev)
    traces = {
        "eager": profiled(lambda: forward_in_row_chunks(fused.forward, [Xtr], len(Xtr))),
        "captured": profiled(
            lambda: fused.batch_transform([DatasetExpression.now(Dataset(Xtr))]).to_array()),
    }
    emit({"phase": "compiled_mnist", "num_ffts": MNIST_FULL_FFTS, "rows": Xm.shape[0],
          "chunk_size": CHUNK, "seconds": secs, "test_error": compiled_err,
          "eager_test_error": out["test_error"], "peak_mem_gb": peak / 1e9,
          "peak_over_features": peak / feature_bytes, "fused_bit_equal": bit_equal,
          "compiled_signatures": [[list(s), t] for s, t in fitted.compiled_signatures],
          "featurize_trace": {k: {f: v[f] for f in ("host_seconds", "device_seconds",
                                                    "idle_share", "kernels", "host_launches",
                                                    "graph_launches", "copies")}
                              for k, v in traces.items()},
          "card": card})
    check(compiled_err == out["test_error"],
          f"apply_chunked test error {compiled_err}, eager {out['test_error']}")
    check(peak < 1.5 * feature_bytes, f"peak memory {peak} B with the compiled apply")
    check(bit_equal, "a fused group's replays differ from its eager chunks")
    check(traces["captured"]["host_launches"] * 10 < traces["eager"]["host_launches"],
          f"host launches {traces['captured']['host_launches']} captured, "
          f"{traces['eager']['host_launches']} eager")
    del fitted, Xtr, fused, mtrain, mtest
    # -- the same application with segments off: answers and steps equal
    segment_mnist_phase(cli, bcd, card, out, mnist_ref["predictions"], Xm)
    del out, Xm

    # -- the optimizer at 200 FFTs, cold: composing digests every sign ----
    fresh_env()
    X = torch.randn(2048, mnist.MNIST_IMAGE_SIZE, device=dev, generator=gen)
    Y = torch.randn(2048, 10, device=dev, generator=gen)
    t0 = time.perf_counter()
    pipe = mnist.build_featurizer(mnist.MnistRandomFFTConfig(num_ffts=MNIST_FULL_FFTS, seed=9),
                                  dev).and_then(
        BlockLeastSquaresEstimator(2048, 1, 1000.0), X, Y).and_then(MaxClassifier())
    t1 = time.perf_counter()
    optimizer = PipelineEnv.get_or_create().optimizer
    runs = []
    for _ in range(2):
        t2 = time.perf_counter()
        optimizer.execute(pipe.graph)
        runs.append(time.perf_counter() - t2)
    emit({"phase": "optimizer", "num_ffts": MNIST_FULL_FFTS, "nodes": len(pipe.graph.nodes),
          "compose_seconds": t1 - t0, "optimize_seconds": runs, "card": card})
    del pipe, X, Y

    check_phases(cli, dev, card)
    serve_demo_phase(cli, card)
    serve_demo_fleet_phase(cli, card)
    sweep_demo_phase(cli, card)
    timit_k1 = timit_phases(cli, dev, card)
    ls_family_phase(dev, card)
    cifar_family_k1 = cifar_family_phases(cli, dev, card)
    voc_k1 = voc_phases(cli, dev, card)
    imagenet_k1 = imagenet_phases(cli, dev, card)
    text_k1 = text_phases(cli, dev, card)
    ooc_k1 = out_of_core_phases(dev, card)
    weighted_k1 = weighted_out_of_core_phases(dev, card)
    lanes_k1 = lanes_phases(dev, card)
    resumable_k1 = mnist_device_phases(dev, card)
    observe_k1 = observe_phases(cli, dev, card, slice_ref, mnist_ref)
    # --serve-demo --workers 2 and the coldstart probes check answers and
    # trace counts: they run beside the card tests, which time nothing
    demo = start_serve_demo_cluster()
    coldstart = start_aot_coldstart()
    trainer_demo = start_trainer_demo()
    try:
        card_tests()
        serve_demo_cluster_phase(demo, card)
        trainer_demo_phase(trainer_demo, card)
    finally:
        for proc in (demo[1], trainer_demo[1]):
            if proc.poll() is None:  # a failed phase leaves no process behind
                proc.kill()
                proc.wait()
        coldstart[0].join()
    aot_coldstart_phase(coldstart, card)

    emit({"phase": "total", "seconds": time.perf_counter() - started, "card": card})
    fit = timings["fit"]
    emit({"kernels": [{
        "name": "gaussian_kernel_block", "route": "cuda",
        "source": "keystone_tpu_torch/ops/csrc/gaussian_kernel.cu",
        "replaces": "keystone_tpu/ops/gaussian_kernel.py:64",
        "launches": launches, "max_abs_err": max_err, "ms": fit["ms"],
        "plain_ms": fit["plain_ms"], "bound_ms": fit["bound_ms"],
        "bound_by": fit["bound_by"], "library_ms": fit["library_ms"],
        "launches_by_path": {"slice": launches, "compiled_cifar": compiled_launches,
                             **serve_launches, **fleet_launches, **devices_launches,
                             **cluster_launches,
                             **aot_launches,
                             **segment_launches,
                             "krr_family": krr_launches, "timit_full_width": timit_k1,
                             "cifar_family": cifar_family_k1, "voc": voc_k1, **imagenet_k1,
                             **text_k1, **ooc_k1, **weighted_k1, **lanes_k1, **resumable_k1,
                             **observe_k1},
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
