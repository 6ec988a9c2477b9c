"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
and it runs on CUDA unless the caller names the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import keystone_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "keystone_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "keystone_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, keystone_tpu_torch.__main__, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in %r]; "
            "assert not bad, bad" % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        keystone_tpu_torch.device()
    with pytest.raises(RuntimeError):
        keystone_tpu_torch.device("cuda")
    assert keystone_tpu_torch.device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cli_without_device_cpu_does_not_run_on_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "RandomPatchCifarKernel",
         "--nTrain", "16", "--nTest", "8"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "Training error" not in proc.stdout


def test_mnist_cli_without_device_cpu_does_not_run_on_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "MnistRandomFFT",
         "--nTrain", "16", "--nTest", "8", "--numFFTs", "1", "--blockSize", "512"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "Error is" not in proc.stdout


@pytest.mark.parametrize("app", ["RandomPatchCifar", "LinearPixels", "RandomCifar",
                                 "RandomPatchCifarAugmented"])
def test_cifar_family_clis_without_device_cpu_do_not_run_on_the_cpu(app):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", app, "--nTrain", "16", "--nTest", "8"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "error is" not in proc.stdout


def test_imagenet_cli_without_device_cpu_does_not_run_on_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "ImageNetSiftLcsFV", "--nTrain", "8",
         "--nTest", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "TEST Error" not in proc.stdout
