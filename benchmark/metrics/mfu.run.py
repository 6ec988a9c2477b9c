"""The whole run's share of the card's peak, in %: the operations the
application needs (``benchmark/counts/<config>.py``) of every run in the
window, over the window, against the TF32 tensor-core peak."""

from benchmark.counts import peaks


def read(ctx):
    if not ctx.runs:
        return None
    return 100.0 * ctx.model_flops / (ctx.window_s * peaks.TF32_FLOPS)
