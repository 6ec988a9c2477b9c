"""Layer solver: the mean a run of ``FittedPipeline.seconds[<solver>]``,
the port's host seconds (the card synchronized) of the estimator that the
configuration names as its solver."""


def read(ctx):
    solver = ctx.config["solver"]
    if not ctx.runs or not any(solver in f for f in ctx.fit_seconds):
        return None
    return sum(f.get(solver, 0.0) for f in ctx.fit_seconds) / ctx.runs
