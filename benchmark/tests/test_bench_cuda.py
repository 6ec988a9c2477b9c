"""On the card only (marked ``cuda``; each test skips without one):

    python3 -m pytest -p no:cacheprovider -m cuda benchmark/tests/test_bench_cuda.py

* one cell run as the benchmark's command runs it, its result line whole;
* every control of every cell, at the cell's own size on three seeds,
  must come out not correct: the port's float32 products in TF32, and the
  further controls a cell's limits name (K1's cross term in one TF32 pass).
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]
CONTROLS = [(w, "tf32") for w in CELLS] + [
    (w, c) for w in CELLS
    for c in json.loads((harness.ROOT / "limits" / f"{w}.json").read_text()).get("other_controls", {})]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def test_smoke_one_cell(card):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "cifar_kernel.apply",
         "--seed", "2147483901", "--seconds", "3", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = last_json(out.stdout)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"setup_s", "apply_rows_per_s", "apply_p95_ms"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("workload, control", CONTROLS, ids=[f"{w}-{c}" for w, c in CONTROLS])
def test_control_is_not_correct(card, workload, control):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.calibrate", "--workload", workload,
         "--seeds", "2147483911-2147483913", "--control", control, "--seconds", "1"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(s) for s in out.stdout.strip().splitlines() if '"seed"' in s]
    assert len(lines) == 3
    assert not any(line["correct"] for line in lines), lines
