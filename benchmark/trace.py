"""The device trace of one window: ``torch.profiler`` (CPU and CUDA
activities, operator shapes recorded) around the window, marked by a
``bench.window`` annotation, read back from its Chrome trace.

What it gives the metric readers: the window's length, the seconds in which
some kernel, copy or fill ran on the card (``busy_s``), device seconds by
kernel name, the host operators with their input shapes, and the breakdown
the result line carries: the device operations that took most time, and
the device's idle gaps by the innermost host operator running meanwhile."""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NO_HOST_OP = "host outside any torch operator"


def kernel_name(name: str) -> str:
    """A kernel's qualified name without its return type, argument list,
    template arguments or anonymous namespaces."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].split("<", 1)[0].strip()


def base_name(name: str) -> str:
    """A kernel's name without its namespaces (``gaussian_block``)."""
    return kernel_name(name).rsplit("::", 1)[-1]


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(events: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """Nested host intervals flattened into segments, each labelled by the
    innermost operator open in it."""
    segs: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []  # (end, name)
    cur = None
    for s, e, name in sorted(events, key=lambda v: (v[0], -v[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            if cur < end:
                segs.append((cur, end, top))
                cur = end
        if stack and cur < s:
            segs.append((cur, s, stack[-1][1]))
        cur = s if cur is None else max(cur, s)
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    while stack:
        end, top = stack.pop()
        if cur < end:
            segs.append((cur, end, top))
            cur = end
    return segs


class Trace:
    """One window's trace; times in microseconds as the profiler gives
    them, results in seconds."""

    def __init__(self, events: List[dict]):
        marks = [e for e in events if e.get("name") == WINDOW and e.get("cat") in HOST_CATS]
        if not marks:
            raise RuntimeError("the trace holds no bench.window annotation")
        mark = marks[0]
        self.start = float(mark["ts"])
        self.end = self.start + float(mark["dur"])
        self.window_s = (self.end - self.start) / 1e6
        tid = mark.get("tid")
        self.device: List[Tuple[float, float, str]] = []
        self.host_ops: List[dict] = []
        host: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"])
            t = s + float(e["dur"])
            if t <= self.start or s >= self.end:
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                self.device.append((max(s, self.start), min(t, self.end), e.get("name", "")))
            elif cat in HOST_CATS and e.get("tid") == tid and e.get("name") != WINDOW:
                host.append((s, t, e.get("name", "")))
                if cat == "cpu_op":
                    self.host_ops.append(e)
        self._busy = _merge([(s, t) for s, t, _ in self.device])
        self.busy_s = sum(t - s for s, t in self._busy) / 1e6
        self._host = host

    def device_seconds(self, names) -> float:
        """Device seconds of the kernels whose base name is in ``names``."""
        return sum(t - s for s, t, n in self.device if base_name(n) in names) / 1e6

    def launches(self, names) -> int:
        return sum(1 for _, _, n in self.device if base_name(n) in names)

    def ops(self, name: str) -> List[dict]:
        """Host operators named ``name``, each with its ``Input Dims``."""
        return [e for e in self.host_ops if e.get("name") == name]

    def breakdown(self) -> Dict[str, list]:
        by_op: Dict[str, float] = defaultdict(float)
        for s, t, n in self.device:
            by_op[kernel_name(n)] += (t - s) / 1e6
        gaps: List[Tuple[float, float]] = []
        cur = self.start
        for s, t in self._busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, t)
        if cur < self.end:
            gaps.append((cur, self.end))
        by_host: Dict[str, float] = defaultdict(float)
        segs = _innermost(self._host)
        i = 0
        for gs, ge in gaps:
            while i < len(segs) and segs[i][1] <= gs:
                i += 1
            covered = 0.0
            j = i
            while j < len(segs) and segs[j][0] < ge:
                lo, hi = max(gs, segs[j][0]), min(ge, segs[j][1])
                if hi > lo:
                    by_host[segs[j][2]] += (hi - lo) / 1e6
                    covered += hi - lo
                j += 1
            by_host[NO_HOST_OP] += (ge - gs - covered) / 1e6

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10] if v > 0]

        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def capture(window: Callable[[], None], device) -> Trace:
    """Run ``window`` under the profiler and return its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        with record_function(WINDOW):
            window()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.unlink(path)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    return Trace(events)
