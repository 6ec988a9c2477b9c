"""Typed errors of the static pipeline checker (port of
``keystone_tpu/check/errors.py``)."""

from __future__ import annotations

from typing import Any, Optional


class PipelineCheckError(ValueError):
    """A defect of a pipeline proven without running it: a shape, dtype or
    rank mismatch, a declared spec's refusal, or a composition a chunked
    scan cannot run. Raised at ``and_then``, ``fit()`` or ``check()``
    before any chunk is produced or sample executed.

    Carries the offending node's id and label. Subclasses
    :class:`ValueError` so broad callers keep working.
    """

    def __init__(self, message: str, *, node: Any = None,
                 label: Optional[str] = None):
        self.node = node
        self.label = label
        parts = [str(p) for p in (node, label) if p is not None]
        where = f" [at {' '.join(parts)}]" if parts else ""
        super().__init__(message + where)
        self._message = message

    def __reduce__(self):
        # the default reduction would call __init__ with the decorated
        # message and double the node suffix
        return (_rebuild_check_error,
                (type(self), self._message, self.node, self.label))


def _rebuild_check_error(cls, message, node, label):
    return cls(message, node=node, label=label)


class ContractMismatchError(PipelineCheckError):
    """A pipeline's serving contract (datum shape, dtype, batch coupling)
    does not match what a live engine requires; raised by the swap
    validation of :meth:`CheckReport.require_contract`."""


class CheckOnlyExit(Exception):
    """Raised by ``Pipeline.fit()`` in ``--check`` mode after the static
    check ran, so the application unwinds without executing anything; the
    command line catches it and reports. Not a ``ValueError``, so nothing
    swallows it by accident."""

    def __init__(self, report):
        self.report = report
        super().__init__("static check complete (check-only mode)")
