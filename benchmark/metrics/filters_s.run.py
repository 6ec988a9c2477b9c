"""Layer application (filter learning): the mean a run of the seconds inside
the port's ``app.filters`` span (``pipelines/random_patch_cifar.py::
learn_filters``: the patch draw, the ZCA fit, the filter pick), in a traced
window (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_run(ctx, spans.seconds, ("app.filters",))
