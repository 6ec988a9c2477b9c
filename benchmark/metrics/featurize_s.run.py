"""Layer featurizer: the mean a run of ``FittedPipeline.seconds["featurize"]``,
the port's host seconds (the card synchronized) of forcing the estimators'
training features."""


def read(ctx):
    if not ctx.fit_seconds or not ctx.runs:
        return None
    return sum(f.get("featurize", 0.0) for f in ctx.fit_seconds) / ctx.runs
