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
K1's launches per replay), one-program apply at 200 FFTs (with the
featurizer's host launches traced eager against captured), and the KRR
family on 8000 CIFAR features (the cost-model chooser picks the exact
solve, which builds its kernel from K1 blocks). Then TimitPipeline: a small
run on the card against the CPU, and the JAX CLI's defaults (50 cosine
branches of 4096, d = 204,800, five sweeps of 50 blocks over a 40.96 GB
feature matrix of 50000 synthetic frames), which runs no hand-written
kernel, with a traced sweep of its block solve; and the least-squares family on those frames, where the cost model
picks the exact solve for the raw 440-wide frames and the block solver for
one 4096-wide cosine branch, with TSQR and L-BFGS held against the exact
solve and the CPU. Each phase prints one JSON line; any failure raises and
exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero
and prints no result.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
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

# TimitPipeline at the JAX CLI's defaults (50 cosines of 4096, γ 0.05555,
# Gaussian, λ 0, 5 epochs, 147 classes), TIMIT's frames cut to 50000 so
# that the training features are held once on one card
TIMIT_ROWS = 50000
TIMIT_FULL = ["TimitPipeline", "--nTrain", str(TIMIT_ROWS), "--nTest", "10000"]
TIMIT_FULL_STEPS = 250  # 50 blocks × 5 epochs
TIMIT_FALLBACK_LAMBDA = 100.0  # bench.py's λ for the TIMIT block shape
LS_ITERATIONS = 20  # the L-BFGS option of LeastSquaresEstimator


def emit(obj: dict) -> None:
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
    """Reset the port's fit-once state and drop the fused groups' shared
    CUDA graphs, so a phase holds no device memory of the one before it."""
    from keystone_tpu_torch.workflow import fusion
    from keystone_tpu_torch.workflow.env import PipelineEnv

    PipelineEnv.get_or_create().reset()
    fusion.clear_graph_cache()


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
    from keystone_tpu_torch import trace_mnist
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
    del fitted, out, fit_graph, probe

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
               "card": card}, **trace_mnist.trace(sweep)))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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
    from keystone_tpu_torch import cost, trace_mnist
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
    for n, d, b in CHECK_SHAPES:
        X = torch.randn(n, d, device=dev, generator=gen)
        Xb = torch.randn(b, d, device=dev, generator=gen)
        got = gk.gaussian_kernel_block(X, Xb, GAMMA)
        want = gk.gaussian_kernel_block_plain(X, Xb, GAMMA)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        max_err = max(max_err, err)
        emit({"phase": "kernel_check", "kernel": "gaussian_kernel_block",
              "shape": [n, d, b], "max_abs_err": err, "atol": 1e-5, "rtol": 1e-4})
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
                             ("exact_tail", EXACT_SHAPES[1])):
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
    Xt_host = synthetic_cifar(10000, seed=2).data.to_array().numpy()  # the CLI's test set
    Xt = torch.from_numpy(Xt_host).to(dev)
    secs = {}
    t0 = clock()
    eager = scores.apply(Xt).to_array()
    secs["eager_apply"] = clock() - t0
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
    fitted.apply(Xm)
    secs["eager_apply"] = clock() - t0
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
    # the featurizer over the 60000 training rows, traced both ways
    Xtr = mtrain.data.to_array().to(dev)
    traces = {
        "eager": trace_mnist.trace(lambda: forward_in_row_chunks(fused.forward, [Xtr], len(Xtr))),
        "captured": trace_mnist.trace(
            lambda: fused.batch_transform([DatasetExpression.now(Dataset(Xtr))]).to_array()),
    }
    emit({"phase": "compiled_mnist", "num_ffts": MNIST_FULL_FFTS, "rows": Xm.shape[0],
          "chunk_size": CHUNK, "seconds": secs, "test_error": compiled_err,
          "eager_test_error": out["test_error"], "peak_mem_gb": peak / 1e9,
          "peak_over_features": peak / feature_bytes, "fused_bit_equal": bit_equal,
          "compiled_signatures": [[list(s), t] for s, t in fitted.compiled_signatures],
          "featurize_trace": {k: {f: v[f] for f in ("host_seconds", "device_seconds",
                                                    "idle_share", "kernels", "host_launches",
                                                    "graph_launches", "copies",
                                                    "event_seconds")}
                              for k, v in traces.items()},
          "card": card})
    check(compiled_err == out["test_error"],
          f"apply_chunked test error {compiled_err}, eager {out['test_error']}")
    check(peak < 1.5 * feature_bytes, f"peak memory {peak} B with the compiled apply")
    check(bit_equal, "a fused group's replays differ from its eager chunks")
    check(traces["captured"]["host_launches"] * 10 < traces["eager"]["host_launches"],
          f"host launches {traces['captured']['host_launches']} captured, "
          f"{traces['eager']['host_launches']} eager")
    del fitted, out, Xm, Xtr, fused, mtrain, mtest

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

    timit_k1 = timit_phases(cli, dev, card)
    ls_family_phase(dev, card)

    fit = timings["fit"]
    emit({"kernels": [{
        "name": "gaussian_kernel_block", "route": "cuda",
        "source": "keystone_tpu_torch/ops/csrc/gaussian_kernel.cu",
        "replaces": "keystone_tpu/ops/gaussian_kernel.py:64",
        "launches": launches, "max_abs_err": max_err, "ms": fit["ms"],
        "plain_ms": fit["plain_ms"], "bound_ms": fit["bound_ms"],
        "bound_by": fit["bound_by"], "library_ms": fit["library_ms"],
        "launches_by_path": {"slice": launches, "compiled_cifar": compiled_launches,
                             "krr_family": krr_launches, "timit_full_width": timit_k1},
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
