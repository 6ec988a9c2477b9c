"""The operation and byte counts against hand-worked numbers."""

import json

import pytest

from benchmark import harness
from benchmark.counts import k1, peaks

CIFAR = json.loads((harness.ROOT / "configs" / "cifar_random_patch_kernel.json").read_text())
TIMIT = json.loads((harness.ROOT / "configs" / "timit_cosine_bcd.json").read_text())
cifar_counts = harness.load_module(harness.ROOT / "counts" / "cifar_random_patch_kernel.py")
timit_counts = harness.load_module(harness.ROOT / "counts" / "timit_cosine_bcd.py")


@pytest.mark.parametrize("shape, flops, nbytes, least_ms", [
    # 2·50000·5000·800; 4·(50000·800 + 5000·800 + 50000·5000)
    ((50000, 5000, 800), 4.0e11, 1.176e9, 4.0e11 / 495e12 * 1e3),
    # 2·10000·5000·800; 4·(10000·800 + 5000·800 + 10000·5000)
    ((10000, 5000, 800), 8.0e10, 2.48e8, 8.0e10 / 495e12 * 1e3),
    # a serving row: bytes bound, 4·(800 + 5000·800 + 5000) / 3.35e12
    ((1, 5000, 800), 8.0e6, 1.60232e7, 1.60232e7 / 3.35e12 * 1e3),
])
def test_k1(shape, flops, nbytes, least_ms):
    assert k1.flops(*shape) == pytest.approx(flops)
    assert k1.bytes_moved(*shape) == pytest.approx(nbytes)
    assert k1.least_seconds(*shape) * 1e3 == pytest.approx(least_ms)


def test_k1_fit_shape_share_of_the_old_chip_time():
    # 0.808 ms of work against the 3.72 ms a launch measured (PERF.md §6)
    assert k1.least_seconds(50000, 5000, 800) * 1e3 == pytest.approx(0.8081, abs=1e-4)
    assert 100 * k1.least_seconds(50000, 5000, 800) / 3.72e-3 == pytest.approx(21.7, abs=0.1)


@pytest.mark.parametrize("rows, train, block, expect", [
    (10000, 50000, 5000, [(10000, 5000, 800)] * 10),
    (7, 12000, 5000, [(7, 5000, 800), (7, 5000, 800), (7, 2000, 800)]),
])
def test_mapper_launches(rows, train, block, expect):
    assert k1.mapper_launches(rows, train, 800, block) == expect


def test_peaks():
    assert peaks.TF32_FLOPS == 495e12 and peaks.HBM_BYTES == 3.35e12


def test_cifar_widths():
    assert cifar_counts.feature_dim(CIFAR) == 800
    # 27 × 27 positions, 100 filters of 6·6·3
    assert cifar_counts.featurize_flops(CIFAR, 1) == 2 * 729 * 100 * 108


def test_cifar_run_flops():
    n, nt, d, k, b = 50000, 10000, 800, 10, 5000
    filters = 2 * 100000 * 108 ** 2 + 2 * 108 ** 3 + 4 * 100 * 108 ** 2
    features = 2 * (n + nt) * 729 * 100 * 108
    krr = n * (n + 1) * d + 10 * (b ** 3 / 3 + 2 * (n - b) * b * k + 2 * b * b * k)
    scores = 2 * n * n * k + 2 * nt * n * d + 2 * nt * n * k
    assert cifar_counts.run_flops(CIFAR) == pytest.approx(filters + features + krr + scores)
    assert cifar_counts.run_flops(CIFAR) == pytest.approx(4.30e12, rel=0.01)


def test_cifar_batch_flops():
    rows = 10000
    expect = 2 * rows * 729 * 100 * 108 + 2 * rows * 50000 * 800 + 2 * rows * 50000 * 10
    assert cifar_counts.batch_flops(CIFAR, rows) == pytest.approx(expect)


def test_timit_run_flops():
    n, nt, D, din, k, b = 50000, 10000, 204800, 440, 147, 4096
    features = 2 * (n + nt) * D * din
    grams = 50 * (n * b * (b + 1) + b ** 3 / 3)
    steps = 5 * 50 * (4 * n * b * k + 4 * b * b * k)
    scores = 2 * (n + nt) * D * k
    assert timit_counts.run_flops(TIMIT) == pytest.approx(features + grams + steps + scores)
    assert timit_counts.run_flops(TIMIT) == pytest.approx(9.1e13, rel=0.02)


def test_timit_batch_flops():
    assert timit_counts.batch_flops(TIMIT, 10) == pytest.approx(
        2 * 10 * 204800 * 440 + 2 * 10 * 204800 * 147)


def test_counts_ignore_the_implementation():
    # a Gram counts its symmetric half: n·b·(b + 1) for b columns, once
    once = TIMIT["num_cosines"] * 50000 * 4096 * 4097
    swept = dict(TIMIT, num_epochs=1)
    assert timit_counts.bcd_flops(TIMIT) - timit_counts.bcd_flops(swept) == pytest.approx(
        4 * 50 * (4 * 50000 * 4096 * 147 + 4 * 4096 * 4096 * 147))
    assert timit_counts.bcd_flops(swept) > once
