"""BENCHMARK.json against the benchmark's contract, and every file it makes
the harness look for."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

MANIFEST = harness.load_manifest()
REPO = harness.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def reports(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (REPO / p).is_dir()
        assert not p.endswith("_torch")
    for word in cmd:
        assert not word.startswith("/") and ".." not in word.split("/")


def test_run_seconds_fits_the_check_with_24_cells():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and one_line(entry["source"]) and one_line(entry["why"])
    assert entry["file"].startswith("benchmark/") and (REPO / entry["file"]).is_file()
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and key in cfg
        assert not key.endswith(("_dim", "_rank", "_size", "_features"))
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])
    for part in ("apps", "inputs", "reference", "counts"):
        assert (harness.ROOT / part / f"{entry['name']}.py").is_file()


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and one_line(cell["why"])
    traffic = json.loads((harness.ROOT / "traffic" / f"{cell['traffic']}.json").read_text())
    loop = harness.load_module(harness.ROOT / "loops" / f"{traffic['kind']}.py")
    for part in ("warm_up", "window", "model_flops", "result_extras"):
        assert callable(getattr(loop, part))
    limits = json.loads((harness.ROOT / "limits" / f"{cell['name']}.json").read_text())
    for name, limit in limits["numbers"].items():
        r = limits["readings"][name]
        assert r["lower"] < limit < r["upper"] and r["upper"] >= 3 * r["lower"]
        assert r["sound_seeds"] >= 12 and r["control_seeds"] >= 3
    # every further control fails at least one of the cell's numbers
    for control, seen in limits.get("other_controls", {}).items():
        assert (harness.ROOT / "controls" / f"{control}.py").is_file()
        assert seen["seeds"] >= 3
        assert any(v > limits["numbers"][n] for n, v in seen["smallest"].items()), control
    e2e = [m for m in MANIFEST["end_to_end"] if reports(cell["name"], m)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(reports(cell["name"], m) for m in MANIFEST["per_layer"])


def test_names_unique_and_cells_once():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in MANIFEST["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert one_line(metric["layer"])
        moved = E2E[metric["moves"]]
        for cell in CELLS:
            if reports(cell, metric):
                assert reports(cell, moved), (metric["name"], cell)
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    assert (harness.ROOT / "metrics" / f"{metric['name']}.py").is_file()
    if metric["name"].endswith("_roofline") or "_roofline." in metric["name"] \
            or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_setup_bound_and_per_layer_layers_named_alike():
    assert E2E["setup_s"]["bound"] <= 0.25
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert all(layer == layer.strip() for layer in layers)


def test_files_under_paths_are_named_from_name_characters():
    for path in Path(harness.ROOT).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
