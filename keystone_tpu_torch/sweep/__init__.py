"""Multi-query optimization: hyperparameter sweeps fit as one merged DAG
(port of ``keystone_tpu/sweep/``).

:class:`GridSweep` is a pipeline template and a parameter grid fit as one
graph: the shared featurize prefix runs once, solver structure is shared
across members (one Gram accumulation prices every λ; BCD members may
warm-start from their nearest-λ neighbour), and the fitted members come
back as ordinary ``FittedPipeline``\\ s. The JAX package's sweep demo
(``sweep/demo.py``) serves its members and comes with the serving tier.
"""

from .grid import GridSweep, SweepMember, SweepResult, expand_grid

__all__ = ["GridSweep", "SweepMember", "SweepResult", "expand_grid"]
