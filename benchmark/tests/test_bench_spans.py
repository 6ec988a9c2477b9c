"""The program's layer spans in a traced window (``benchmark/spans.py``) and
the eight readers of them, on hand-made events."""

import random
from types import SimpleNamespace

import pytest

from benchmark import harness, spans
from benchmark.trace import Trace

IDLE = ["idle_filters_s.run", "idle_check_s.run", "idle_featurize_s.run",
        "idle_solve_s.run", "idle_score_s.run"]
READERS = ["filters_s.run", "score_s.run", *IDLE, "idle_outside_s.run"]


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def span(name, ts, dur, tid=1):
    return ev("user_annotation", name, ts, dur, tid)


def window(extra, start=1000.0, length=100.0):
    return Trace([span("bench.window", start, length)] + extra)


def read(metric, trace, runs=2):
    mod = harness.load_module(harness.ROOT / "metrics" / f"{metric}.py")
    return mod.read(SimpleNamespace(trace=trace, runs=runs))


#: a window of 100 µs from 1000: every layer, the card busy 1010–1015,
#: 1040–1060 and 1095–1097, and spans the readers must not count
RUN = [
    span("app.filters", 1000, 20), ev("kernel", "k", 1010, 5),
    span("check.static", 1020, 10), span("check.static", 1025, 10),
    span("fit.featurize", 1035, 15), ev("kernel", "gemm", 1040, 20),
    span("fit.KernelRidgeRegression", 1050, 20), span("fit.StandardScaler", 1070, 5),
    span("app.score", 1080, 10), ev("cpu_op", "aten::mm", 1082, 3),
    span("app.score", 1090, 20), ev("gpu_memcpy", "Memcpy DtoH", 1095, 2),
    span("app.score", 1000, 100, tid=2),
]


def test_known_intervals_give_known_seconds():
    t = window(RUN)
    # µs a run (two runs)
    want = {"filters_s.run": 20, "score_s.run": 20, "idle_filters_s.run": 15,
            "idle_check_s.run": 15, "idle_featurize_s.run": 5, "idle_solve_s.run": 15,
            "idle_score_s.run": 18, "idle_outside_s.run": 5}
    got = {m: read(m, t) for m in READERS}
    assert got == {m: pytest.approx(v * 1e-6 / 2) for m, v in want.items()}


def test_overlapping_spans_of_one_name_count_once():
    t = window(RUN)
    assert spans.intervals(t, ("check.static",)) == [(1020, 1035)]
    assert spans.seconds(t, ("check.static",)) == pytest.approx(15e-6)
    # a prefix, less the spans named in ``but``; clipped to the window
    assert spans.intervals(t, ("fit.",), but=("fit.featurize",)) == [(1050, 1075)]
    assert spans.intervals(t, ("app.score",)) == [(1080, 1100)]


def test_spans_of_another_thread_are_ignored():
    t = window([span("app.score", 1000, 100, tid=2), ev("kernel", "k", 1000, 10)])
    assert read("score_s.run", t) is None and read("idle_outside_s.run", t) is None
    t = window([span("app.score", 1000, 100, tid=2), span("app.score", 1050, 10)])
    assert read("score_s.run", t, runs=1) == pytest.approx(10e-6)


@pytest.mark.parametrize("metric", READERS)
def test_a_missing_span_reads_none(metric):
    bare = window([ev("kernel", "k", 1000, 10), ev("cpu_op", "aten::mm", 1000, 50)])
    assert read(metric, bare) is None
    assert read(metric, None) is None
    assert read(metric, window(RUN), runs=0) is None


def test_a_span_that_does_not_match_is_not_read():
    # a name is exact unless it ends in "."; "app.filtersX" is not "app.filters"
    t = window([span("app.filtersX", 1000, 10), span("fitting", 1010, 10)])
    assert read("filters_s.run", t) is None and read("idle_solve_s.run", t) is None


def test_breakdown_names_the_layer_spans_in_idle_gaps():
    gaps = dict(window(RUN).breakdown()["idle_gaps"])
    assert gaps["app.filters"] == pytest.approx(15e-6)
    # inside app.score, the innermost host event open names the gap
    assert gaps["app.score"] == pytest.approx(15e-6)
    assert gaps["aten::mm"] == pytest.approx(3e-6)


def random_run(rng: random.Random, start: float, length: float) -> list:
    """Layer spans one after another with gaps, none nesting in another,
    and kernels anywhere, some past the window's ends."""
    names = ["app.filters", "check.static", "fit.featurize", "fit.StandardScaler",
             "fit.BlockLeastSquaresEstimator", "app.score"]
    events, t = [], start - 5
    while t < start + length:
        t += rng.uniform(0, 4)
        dur = rng.uniform(0.5, 12)
        events.append(span(rng.choice(names), t, dur))
        t += dur
    for _ in range(rng.randint(0, 40)):
        events.append(ev("kernel", "k", rng.uniform(start - 10, start + length), rng.uniform(0, 8)))
    return events


@pytest.mark.parametrize("seed", range(8))
def test_the_idle_readers_add_up_to_the_window_idle(seed):
    rng = random.Random(seed)
    runs = rng.randint(1, 5)
    t = window(random_run(rng, 1000.0, 300.0), length=300.0)
    parts = [read(m, t, runs) or 0.0 for m in IDLE] + [read("idle_outside_s.run", t, runs)]
    assert sum(parts) == pytest.approx((t.window_s - t.busy_s) / runs, abs=1e-9)
