"""The program's layer spans in a traced window, and the card's idle time
inside and outside them.

The port marks its layer boundaries with ``torch.profiler`` ranges
(``keystone_tpu_torch/obs/tracer.py::layer``) on the thread that calls the
layer, so they reach the window's trace as ``user_annotation`` events on the
kernels' clock. The names are spelled here, not imported from the port: a
checkout whose program records no such span reads ``None`` for every one.

A selection of spans is a tuple of names, each an exact span name or, ending
in ``.``, a prefix (``fit.`` is every ``fit.<EstimatorClass>`` and
``fit.featurize``); ``but`` names spans to leave out. Spans of one selection
that overlap count once. Times are the profiler's microseconds; results are
seconds."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from benchmark.trace import Trace, _merge

Intervals = List[Tuple[float, float]]

#: every layer span of a run; none nests in another, so the idle seconds
#: inside each layer and outside all of them add up to the window's
LAYERS = ("app.", "check.static", "fit.")


def _selected(name: str, names: Sequence[str], but: Sequence[str]) -> bool:
    if name in but:
        return False
    return any(name.startswith(n) if n.endswith(".") else name == n for n in names)


def intervals(trace: Trace, names: Sequence[str], but: Sequence[str] = ()) -> Intervals:
    """The union of the selected spans on the window's thread, clipped to
    the window."""
    lo, hi = trace.start, trace.end
    return _merge([(max(s, lo), min(t, hi)) for s, t, name in trace._host
                   if _selected(name, names, but) and min(t, hi) > max(s, lo)])


def busy(trace: Trace) -> Intervals:
    """The intervals in which some kernel, copy or fill ran on the card."""
    return _merge([(s, t) for s, t, _ in trace.device])


def _length(iv: Intervals) -> float:
    return sum(t - s for s, t in iv)


def _overlap(a: Intervals, b: Intervals) -> float:
    """The length of the intersection of two merged, sorted unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def seconds(trace: Trace, names: Sequence[str], but: Sequence[str] = ()) -> Optional[float]:
    """Seconds inside the selected spans; None where there is none."""
    iv = intervals(trace, names, but)
    return _length(iv) / 1e6 if iv else None


def idle_seconds(trace: Trace, names: Sequence[str],
                 but: Sequence[str] = ()) -> Optional[float]:
    """Seconds inside the selected spans in which the card ran nothing;
    None where there is no such span."""
    iv = intervals(trace, names, but)
    if not iv:
        return None
    return (_length(iv) - _overlap(iv, busy(trace))) / 1e6


def idle_outside_seconds(trace: Trace) -> Optional[float]:
    """Seconds of the window outside every layer span in which the card
    ran nothing; None where the window holds no layer span."""
    iv = intervals(trace, LAYERS)
    if not iv:
        return None
    b = busy(trace)
    idle_window = (trace.end - trace.start) - _length(b)
    return (idle_window - (_length(iv) - _overlap(iv, b))) / 1e6


def per_run(ctx, measure: Callable[..., Optional[float]], *args, **kwargs) -> Optional[float]:
    """``measure(ctx.trace, *args, **kwargs)`` over the window's runs: None
    in an untraced run, a window without runs, or where the measure finds
    no span."""
    if ctx.trace is None or not ctx.runs:
        return None
    value = measure(ctx.trace, *args, **kwargs)
    return None if value is None else value / ctx.runs
