"""Layer workflow (the static checker, ``check/``): the mean a run of the
host seconds of every call of the checker that ``Pipeline.and_then`` and
``Pipeline.fit`` make (``workflow/pipeline.py::_static_check``; it runs on
fake tensors and launches nothing), timed by the benchmark's tap
(``benchmark/apps/common.py::CheckSeconds``). ``FittedPipeline.seconds``
does not hold them: the fit's checker runs before its optimizer."""


def read(ctx):
    if not ctx.runs or not ctx.check_seconds:
        return None
    return sum(ctx.check_seconds) / ctx.runs
