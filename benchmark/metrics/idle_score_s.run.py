"""Layer application (scoring): the mean a run of the seconds inside the
port's ``app.score`` spans in which no kernel, copy or fill ran on the card,
in a traced window (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_run(ctx, spans.idle_seconds, ("app.score",))
