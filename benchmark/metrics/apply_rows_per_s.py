"""Rows scored a second: every row of every batch in the window, over the
whole window."""


def read(ctx):
    return ctx.rows / ctx.window_s if ctx.batches else None
