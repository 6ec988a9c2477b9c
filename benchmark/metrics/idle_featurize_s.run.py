"""Layer featurizer: the mean a run of the seconds inside the port's
``fit.featurize`` spans (the interval of ``FittedPipeline.seconds
["featurize"]``) in which no kernel, copy or fill ran on the card, in a
traced window (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_run(ctx, spans.idle_seconds, ("fit.featurize",))
