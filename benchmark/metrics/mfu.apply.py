"""The batch loop's share of the card's peak, in %: the operations scoring
needs (``benchmark/counts/<config>.py``) of every batch in the window, over
the window, against the TF32 tensor-core peak."""

from benchmark.counts import peaks


def read(ctx):
    if not ctx.batches:
        return None
    return 100.0 * ctx.model_flops / (ctx.window_s * peaks.TF32_FLOPS)
