"""Layer workflow (the static checker): the mean a run of the seconds inside
the port's ``check.static`` spans (every checker call at ``and_then`` and at
fit entry) in which no kernel, copy or fill ran on the card, in a traced
window (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_run(ctx, spans.idle_seconds, ("check.static",))
