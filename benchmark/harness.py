"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference that decides ``correct``.

The harness knows no configuration, traffic mix, loop, control or metric
by name. It reads ``BENCHMARK.json`` and loads, by the names there, the
files listed in ``benchmark/__init__.py``: a cell's traffic file names its
``kind``, and ``loops/<kind>.py`` drives the window.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
MANIFEST = REPO / "BENCHMARK.json"

#: top-level module names that may not be loaded in the measuring process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "keystone_tpu")


class BenchmarkError(RuntimeError):
    """The cell cannot be run as asked: a missing file, card or limit."""


# ---- the manifest and the files it names ----------------------------------

def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchmarkError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path) -> ModuleType:
    """A module from its file; names may hold dots (``mfu.run.py``)."""
    if not path.is_file():
        raise BenchmarkError(f"missing {path.relative_to(REPO)}")
    mod_name = "benchmark._loaded." + path.relative_to(ROOT).as_posix()[:-3].replace("/", ".")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(rel: str) -> dict:
    path = REPO / rel
    if not path.is_file():
        raise BenchmarkError(f"missing {rel}")
    with open(path) as f:
        return json.load(f)


def cell_metrics(manifest: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES,
    compared whole (``keystone_tpu_torch`` is not ``keystone_tpu``)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN_MODULES})


# ---- numbers compared with the reference ---------------------------------

def rel_err(got, want) -> float:
    """max |got − want| / max |want|, in float64 on ``want``'s device."""
    import torch

    want = want.double()
    got = got.to(want.device, torch.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    return diff / scale if scale > 0 else diff


def compare(program: Dict[str, Any], reference: Dict[str, Any]) -> Dict[str, float]:
    """One number for each name the program reports. A value is an array,
    a tuple of arrays (the number is their worst), a list of (index, array)
    pairs held against ``reference[name][index]`` (each answer of a batch
    loop against its batch's reference)."""
    out = {}
    for name, got in program.items():
        want = reference[name]
        if isinstance(got, list):
            out[name] = max((rel_err(a, want[k]) for k, a in got), default=float("inf"))
        elif isinstance(got, tuple):
            out[name] = (max(rel_err(a, b) for a, b in zip(got, want))
                         if len(got) == len(want) else float("inf"))
        else:
            out[name] = rel_err(got, want)
    return out


# ---- the run --------------------------------------------------------------

def _now() -> float:
    return time.perf_counter()


class _GcPauses:
    """Seconds the window spends in the interpreter's collections of its
    oldest generation (a diagnostic printed on standard error)."""

    def __init__(self) -> None:
        self.seconds, self.count, self._t0 = 0.0, 0, None
        gc.callbacks.append(self._note)

    def _note(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = _now()
        elif self._t0 is not None:
            self.seconds += _now() - self._t0
            self.count += 1
            self._t0 = None

    def close(self) -> None:
        gc.callbacks.remove(self._note)


def _release(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             started: Optional[float] = None, device: Optional[str] = None,
             control: Optional[str] = None, overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None, warmup: bool = True,
             manifest: Optional[dict] = None,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)) -> dict:
    """Run ``workload`` once and return its result line as a dict.

    ``started`` is the process's first clock reading (``setup_s`` counts
    from it). ``device`` defaults to ``cuda:0``; the CPU is for the tests.
    ``control`` names ``controls/<control>.py``, switched on for set-up and
    the window (the calibration of the limits); ``overrides`` and
    ``traffic_overrides`` replace configuration and traffic keys (tests run
    tiny sizes); ``warmup=False`` skips the warm-up (the calibration)."""
    import torch

    started = _now() if started is None else started
    manifest = load_manifest() if manifest is None else manifest
    wl = _entry(manifest["workloads"], workload, "workload")
    cfg_entry = _entry(manifest["configs"], wl["config"], "config")
    cfg = dict(load_json(cfg_entry["file"]))
    cfg.update(overrides or {})
    traffic = dict(load_json(f"benchmark/traffic/{wl['traffic']}.json"))
    traffic.update(traffic_overrides or {})
    limits = load_json(f"benchmark/limits/{workload}.json")["numbers"]
    dev = torch.device(device or "cuda:0")

    loop = load_module(ROOT / "loops" / f"{traffic['kind']}.py")
    app_mod = load_module(ROOT / "apps" / f"{wl['config']}.py")
    counts = load_module(ROOT / "counts" / f"{wl['config']}.py")
    inputs_mod = load_module(ROOT / "inputs" / f"{wl['config']}.py")
    switch_off = None
    if control is not None:
        control_mod = load_module(ROOT / "controls" / f"{control}.py")
    entry_flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    # the configurations' precision: float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    from .apps.common import CheckSeconds, FitSeconds  # the port's, imported with the app

    app = fits = checks_s = None
    try:
        if control is not None:
            switch_off = control_mod.install()

        # -- set-up: inputs from the seed, then the traffic's own warm-up
        t_inputs = _now()
        inputs = inputs_mod.make(cfg, seed, dev, traffic)
        app = app_mod.App(cfg, inputs, seed, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_warm = _now()
        loop.warm_up(app, inputs, traffic if warmup else _no_warmup(traffic))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = _now() - started
        log(f"set-up {setup_s:.3f} s: start and imports {t_inputs - started:.3f}, inputs "
            f"{t_warm - t_inputs:.3f}, warm-up {started + setup_s - t_warm:.3f}")

        # -- the window
        ctx = SimpleNamespace(config=cfg, traffic=traffic, counts=counts, runs=0, batches=0,
                              rows=0, attempted=0, latencies_ms=[], fit_seconds=[],
                              check_seconds=[], setup_s=setup_s, window_s=0.0, trace=None)
        answers: List[tuple] = []

        def window() -> None:
            answers.extend(loop.window(app, inputs, traffic, ctx, seconds, dev, _now))

        fits, checks_s = FitSeconds(), CheckSeconds()
        pauses = _GcPauses()
        try:
            if trace:
                from . import trace as trace_mod

                ctx.trace = trace_mod.capture(window, dev)
            else:
                window()
        finally:
            fits.close()
            checks_s.close()
            pauses.close()
            app.close()
            if switch_off is not None:
                switch_off()
                switch_off = None
        ctx.fit_seconds = fits.seconds
        ctx.check_seconds = checks_s.seconds
        memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        loaded = forbidden_loaded()
        if loaded:
            raise BenchmarkError("the measuring process loaded " + ", ".join(loaded))
        ctx.model_flops = loop.model_flops(counts, cfg, traffic, ctx)

        # -- metrics
        metrics = {}
        for m in cell_metrics(manifest, workload, "per_layer" if trace else "end_to_end"):
            value = load_module(ROOT / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        # -- correct: the program's outputs against the plain reference
        program = app.outputs(answers)
        app.forget()
        del answers
    finally:
        if app is not None:
            app.close()
        for tap in (fits, checks_s):
            if tap is not None:
                tap.close()
        if switch_off is not None:
            switch_off()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    app = fits = checks_s = None
    _release(dev)
    ref_mod = load_module(ROOT / "reference" / f"{wl['config']}.py")
    t_ref = _now()
    reference = ref_mod.reference(cfg, inputs, seed, dev, set(program))
    ref_s = _now() - t_ref
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = entry_flags
    numbers = compare(program, reference)
    del program, reference, inputs
    _release(dev)
    checks = {}
    for name, value in numbers.items():
        if name not in limits:
            raise BenchmarkError(f"{workload}: no limit for {name!r}")
        checks[name] = {"value": value, "limit": limits[name]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    result = {"correct": correct, "attempted": ctx.attempted, "failed": 0,
              "metrics": metrics, "device": device_info}
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    log(f"window {ctx.window_s:.3f} s, {ctx.attempted} {traffic['kind']}, of it "
        f"{pauses.seconds:.3f} s in {pauses.count} collections of the oldest generation; "
        f"reference {ref_s:.2f} s")
    result.update(loop.result_extras(ctx))
    result["checks"] = checks
    return result


def _no_warmup(traffic: dict) -> dict:
    """The traffic with every ``warmup_*`` count set to 0."""
    return {k: (0 if k.startswith("warmup_") else v) for k, v in traffic.items()}
