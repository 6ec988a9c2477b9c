"""Lazy, memoized execution results (port of
``keystone_tpu/workflow/expressions.py``; parity: ``workflow/Expression.scala``).

An ``Expression`` wraps a thunk evaluated at most once: laziness lets the
optimizer rewrite the graph before anything runs, and memoization makes
the pull executor cheap to re-enter. The once-latch keeps the thunk to one
run when two threads force the same expression.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from ..data.dataset import Dataset
    from .operators import TransformerOperator

_UNSET = object()


class Expression:
    """A call-by-name, memoized value with a thread-safe once-latch."""

    def __init__(self, thunk: Callable[[], Any]):
        self._thunk = thunk
        self._value: Any = _UNSET
        self._latch = threading.Lock()

    @property
    def computed(self) -> bool:
        return self._value is not _UNSET

    def get(self) -> Any:
        if self._value is _UNSET:
            with self._latch:
                if self._value is _UNSET:
                    self._value = self._thunk()
                    self._thunk = None  # release captured state
        return self._value

    def map_thunk(self, wrap: Callable[[Callable[[], Any]], Callable[[], Any]]) -> None:
        """Replace the pending thunk with ``wrap(thunk)``; nothing once
        computed (how the concurrent scheduler arms a pull's root)."""
        with self._latch:
            if self._value is _UNSET:
                self._thunk = wrap(self._thunk)

    @staticmethod
    def now(value: Any) -> "Expression":
        e = Expression(lambda: value)
        e.get()
        return e

    # locks don't pickle; only computed expressions are serializable anyway
    # (pending thunks are closures), so drop and rebuild the latch
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_latch"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._latch = threading.Lock()


class DatasetExpression(Expression):
    """Evaluates to a :class:`Dataset`."""

    def get(self) -> "Dataset":
        return super().get()

    @staticmethod
    def now(value: "Dataset") -> "DatasetExpression":
        e = DatasetExpression(lambda: value)
        e.get()
        return e


class DatumExpression(Expression):
    """Evaluates to a single datum."""

    @staticmethod
    def now(value: Any) -> "DatumExpression":
        e = DatumExpression(lambda: value)
        e.get()
        return e


class TransformerExpression(Expression):
    """Evaluates to a fitted :class:`TransformerOperator`."""

    def get(self) -> "TransformerOperator":
        return super().get()

    @staticmethod
    def now(value: "TransformerOperator") -> "TransformerExpression":
        e = TransformerExpression(lambda: value)
        e.get()
        return e
