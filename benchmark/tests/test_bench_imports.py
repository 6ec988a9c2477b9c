"""What the benchmark may import: nothing of JAX or the JAX package
anywhere, and nothing of the port in the plain reference (or in the inputs
and counts it shares)."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import harness

FILES = sorted(p for p in Path(harness.ROOT).rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(harness.ROOT).as_posix())
def test_no_jax(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in
                                  ("reference", "inputs", "counts")],
                         ids=lambda p: p.relative_to(harness.ROOT).as_posix())
def test_reference_side_imports_nothing_of_the_port(path):
    assert "keystone_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "numpy", "torch", "benchmark"}


def test_forbidden_modules_compared_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "keystone_tpu_torch_probe", object())
    assert "keystone_tpu_torch_probe" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "keystone_tpu.probe", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"keystone_tpu.probe", "jaxlib"} <= set(harness.forbidden_loaded())


def test_the_port_loads_no_jax_here():
    # the CPU test process may hold JAX for other suites; what the port's
    # applications load is checked in a fresh interpreter
    import subprocess

    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.apps.cifar_random_patch_kernel, benchmark.apps.timit_cosine_bcd; "
            "from benchmark import harness; print(harness.forbidden_loaded())"
            % str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
