"""Layer workflow (the optimizer and its rule stack): the mean a run of
``FittedPipeline.seconds["optimize"]``, the port's host seconds of
``optimizer.execute`` at each fit. The static checker runs before it and is
not in it (``check_s.run`` reads the checker)."""


def read(ctx):
    if not ctx.fit_seconds or not ctx.runs:
        return None
    return sum(f.get("optimize", 0.0) for f in ctx.fit_seconds) / ctx.runs
