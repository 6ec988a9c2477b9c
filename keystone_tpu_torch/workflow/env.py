"""Process-global pipeline environment (port of
``keystone_tpu/workflow/env.py``; parity: ``workflow/PipelineEnv.scala``).

It is the port's own: resetting the JAX package's ``PipelineEnv`` leaves
this one as it is, and the other way round. It holds (a) the prefix → saved
expression table giving fit-once semantics across pipeline executions, and
(b) the optimizer used to rewrite graphs before execution. Tests reset it
between cases exactly like the reference's ``PipelineContext.afterEach``.
"""

from __future__ import annotations

from typing import Dict, Optional, TYPE_CHECKING

from .expressions import Expression
from .prefix import Prefix

if TYPE_CHECKING:  # pragma: no cover
    from .optimizers import Optimizer


class VersionedState(Dict[Prefix, Expression]):
    """The prefix → saved-expression table, with a mutation counter.

    ``SavedStateLoadRule`` bakes state values into optimized graphs, so
    the optimize memo (``optimizers.py``) keys on this version: any
    mutation here — a fit saving a prefix, a test clearing the table —
    invalidates every plan."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.version = 0

    def _bump(self) -> None:
        self.version += 1

    def __setitem__(self, key, value) -> None:
        self._bump()
        super().__setitem__(key, value)

    def __delitem__(self, key) -> None:
        self._bump()
        super().__delitem__(key)

    def clear(self) -> None:
        self._bump()
        super().clear()

    def pop(self, *args):
        self._bump()
        return super().pop(*args)

    def popitem(self):
        self._bump()
        return super().popitem()

    def setdefault(self, key, default=None):
        self._bump()
        return super().setdefault(key, default)

    def update(self, *args, **kwargs) -> None:
        self._bump()
        super().update(*args, **kwargs)


class PipelineEnv:
    _instance: Optional["PipelineEnv"] = None

    def __init__(self) -> None:
        self.state: VersionedState = VersionedState()
        self._optimizer: Optional["Optimizer"] = None

    @classmethod
    def get_or_create(cls) -> "PipelineEnv":
        if cls._instance is None:
            cls._instance = PipelineEnv()
        return cls._instance

    @property
    def optimizer(self) -> "Optimizer":
        if self._optimizer is None:
            from .optimizers import DefaultOptimizer

            self._optimizer = DefaultOptimizer()
        return self._optimizer

    def set_optimizer(self, optimizer: "Optimizer") -> None:
        """Use ``optimizer`` (such as ``AutoCachingOptimizer``) for every
        graph optimized from now on, until ``reset``."""
        self._optimizer = optimizer

    def reset(self) -> None:
        self.state.clear()
        self._optimizer = None
