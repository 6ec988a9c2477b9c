"""Layer solver: the mean a run of the seconds inside the port's estimator
spans (every ``fit.<EstimatorClass>``: the configuration's solver and, in
CIFAR, ``fit.StandardScaler``; each the interval of ``FittedPipeline.seconds
[<class>]``) in which no kernel, copy or fill ran on the card, in a traced
window (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_run(ctx, spans.idle_seconds, ("fit.",), but=("fit.featurize",))
