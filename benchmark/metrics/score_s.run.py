"""Layer application (scoring): the mean a run of the seconds inside the
port's ``app.score`` spans, one each for the train and the test set, in a
traced window (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_run(ctx, spans.seconds, ("app.score",))
