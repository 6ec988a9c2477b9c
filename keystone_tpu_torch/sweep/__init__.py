"""Multi-query optimization: hyperparameter sweeps fit as one merged DAG
(port of ``keystone_tpu/sweep/``).

:class:`GridSweep` is a pipeline template and a parameter grid fit as one
graph: the shared featurize prefix runs once, solver structure is shared
across members (one Gram accumulation prices every λ; BCD members may
warm-start from their nearest-λ neighbour), and the fitted members come
back as ordinary ``FittedPipeline``\\ s. ``sweep/demo.py`` (the CLI's
``--sweep-demo``) fits a grid, absorbs appended rows into one member and
hot-swaps it into a live serving engine.
"""

from .grid import GridSweep, SweepMember, SweepResult, expand_grid

__all__ = ["GridSweep", "SweepMember", "SweepResult", "expand_grid"]
