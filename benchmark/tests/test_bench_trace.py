"""The reduction of a profiler trace to busy time, kernel time, gaps and
the K1 roofline, on hand-made events."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.counts import k1
from benchmark.trace import Trace, _innermost, _merge, base_name, kernel_name


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def window(extra, start=1000.0, length=100.0):
    return [ev("user_annotation", "bench.window", start, length)] + extra


@pytest.mark.parametrize("raw, qualified, base", [
    ("void (anonymous namespace)::gaussian_block(CUtensorMap, int)", "gaussian_block",
     "gaussian_block"),
    ("void at::native::elementwise_kernel<128, 2>(int, F)", "at::native::elementwise_kernel",
     "elementwise_kernel"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n", "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n",
     "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD", "Memcpy DtoD"),
])
def test_kernel_names(raw, qualified, base):
    assert kernel_name(raw) == qualified and base_name(raw) == base


def test_merge():
    assert _merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]


def test_innermost():
    segs = _innermost([(0, 10, "outer"), (2, 4, "a"), (6, 8, "b")])
    assert segs == [(0, 2, "outer"), (2, 4, "a"), (4, 6, "outer"), (6, 8, "b"),
                    (8, 10, "outer")]


def test_busy_window_and_clipping():
    t = Trace(window([ev("kernel", "k", 990, 20), ev("kernel", "k", 1050, 10),
                      ev("gpu_memcpy", "Memcpy HtoD", 1055, 10),
                      ev("kernel", "late", 1200, 5)]))
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((10 + 15) * 1e-6)
    assert t.device_seconds({"k"}) == pytest.approx(20e-6)
    assert t.launches({"k"}) == 2


def test_breakdown_by_host_operator():
    t = Trace(window([
        ev("cpu_op", "aten::mm", 1000, 40), ev("cpu_op", "aten::copy_", 1010, 10),
        ev("kernel", "gemm", 1030, 40), ev("cpu_op", "aten::mm", 1080, 10, tid=2),
    ]))
    out = t.breakdown()
    assert out["device_ops"] == [["gemm", pytest.approx(40e-6)]]
    gaps = dict(out["idle_gaps"])
    # 1000–1030 idle: mm 1000–1010 and 1020–1030, copy_ 1010–1020; 1070–1100
    # idle outside any operator of the window's thread
    assert gaps["aten::mm"] == pytest.approx(20e-6)
    assert gaps["aten::copy_"] == pytest.approx(10e-6)
    assert gaps["host outside any torch operator"] == pytest.approx(30e-6)


def test_breakdown_lists_at_most_ten():
    kernels = [ev("kernel", f"k{i}", 1000 + i, 0.5) for i in range(20)]
    assert len(Trace(window(kernels)).breakdown()["device_ops"]) == 10


def read(metric, **ctx):
    return harness.load_module(harness.ROOT / "metrics" / f"{metric}.py").read(
        SimpleNamespace(**ctx))


def test_k1_roofline_run_from_recorded_shapes():
    op = "keystone::gaussian_kernel_block"
    events = [ev("cpu_op", op, 1000, 1, **{"Input Dims": [[50000, 800], [5000, 800], []]}),
              ev("cpu_op", op, 1002, 1, **{"Input Dims": [[10000, 800], [5000, 800], []]}),
              ev("kernel", "void (anonymous namespace)::split_rows(float)", 1004, 1),
              ev("kernel", "void (anonymous namespace)::gaussian_block(int)", 1005, 40),
              ev("kernel", "void (anonymous namespace)::gaussian_block(int)", 1050, 9)]
    t = Trace(window(events, length=1e4))
    least = k1.least_seconds(50000, 5000, 800) + k1.least_seconds(10000, 5000, 800)
    assert read("k1_roofline.run", trace=t) == pytest.approx(100 * least / 50e-6)


def test_k1_roofline_run_reads_nothing_without_a_shape_a_launch():
    events = [ev("kernel", "void (anonymous namespace)::gaussian_block(int)", 1005, 40)]
    assert read("k1_roofline.run", trace=Trace(window(events))) is None
    assert read("k1_roofline.run", trace=None) is None


def test_k1_roofline_apply_from_the_model_blocks():
    events = [ev("kernel", "void (anonymous namespace)::gaussian_block(int)", 1000 + i, 0.5)
              for i in range(20)]
    t = Trace(window(events))
    counts = harness.load_module(harness.ROOT / "counts" / "cifar_random_patch_kernel.py")
    cfg = {"num_train": 10000, "block_size": 5000, "image_side": 32, "patch_size": 6,
           "patch_steps": 1, "channels": 3, "pool_size": 14, "pool_stride": 13,
           "num_filters": 100}
    got = read("k1_roofline.apply", trace=t, batches=10, config=cfg, counts=counts,
               traffic={"rows": 100})
    least = 10 * 2 * k1.least_seconds(100, 5000, 800)
    assert got == pytest.approx(100 * least / 10e-6)


def test_device_idle_and_mfu():
    t = Trace(window([ev("kernel", "k", 1000, 25)]))
    assert read("device_idle.run", trace=t) == pytest.approx(75.0)
    assert read("device_idle.apply", trace=None) is None
    assert read("mfu.run", runs=2, model_flops=495e12, window_s=4.0) == pytest.approx(25.0)
    assert read("mfu.apply", batches=0, model_flops=1.0, window_s=1.0) is None


def test_end_to_end_readers():
    assert read("run_s", runs=4, window_s=10.0) == pytest.approx(2.5)
    assert read("apply_rows_per_s", batches=3, rows=300, window_s=2.0) == pytest.approx(150)
    lat = list(range(1, 101))
    assert read("apply_p95_ms", latencies_ms=lat) == pytest.approx(95.05)
    assert read("setup_s", setup_s=12.5) == 12.5


def test_fit_second_readers():
    fits = [{"optimize": 1.0, "featurize": 2.0, "KernelRidgeRegression": 3.0},
            {"optimize": 3.0, "featurize": 4.0, "KernelRidgeRegression": 5.0}]
    ctx = dict(fit_seconds=fits, runs=2, config={"solver": "KernelRidgeRegression"})
    assert read("optimize_s.run", **ctx) == pytest.approx(2.0)
    assert read("featurize_s.run", **ctx) == pytest.approx(3.0)
    assert read("solve_s.run", **ctx) == pytest.approx(4.0)
    assert read("solve_s.run", **dict(ctx, config={"solver": "Other"})) is None
