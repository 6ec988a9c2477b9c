"""Seconds of one whole application run (compose, fit, score the train and
test sets), runs back to back: the window, which closes at the end of the
first run that ends past its length, divided by the runs in it."""


def read(ctx):
    return ctx.window_s / ctx.runs if ctx.runs else None
