"""Bounded-backoff retry of transient failures, with a budget per scan
(port of ``keystone_tpu/faults/retry.py``).

A scan owns one :class:`RetryBudget`: the ``scan.chunk`` seam of its
source and its staging copies draw from it (the scan adopts the seam's
budget), and a re-callable source (``ChunkedDataset.from_chunk_fn``)
draws its own for the regeneration of a chunk by index. A scan whose
source is broken cannot retry forever: when the budget is spent, the
original exception propagates with its original traceback.

Off by default: ``KEYSTONE_SCAN_RETRIES`` (default 0) is the number of
retries a scan may take; ``KEYSTONE_SCAN_RETRY_BACKOFF`` the base backoff
in seconds (default 0.05), doubled each attempt up to
:data:`MAX_BACKOFF_S`. Only errors classified transient retry: the typed
:class:`TransientError` and the standard library's ``ConnectionError``
and ``TimeoutError`` (``faults.plan.is_transient``). Each retry records
a ``retry.attempt`` instant when tracing.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

from ..utils import env_float, env_int
from .plan import SCAN_CHUNK, SCAN_STAGE, TransientError, fault_point, is_transient

logger = logging.getLogger(__name__)

MAX_BACKOFF_S = 2.0

__all__ = ["MAX_BACKOFF_S", "SCAN_CHUNK", "SCAN_STAGE", "RetryBudget", "TransientError",
           "is_transient", "retry_call"]


class RetryBudget:
    """A thread-safe bounded pool of retries shared by the stages of one
    scan."""

    def __init__(self, budget: Optional[int] = None,
                 backoff_s: Optional[float] = None, label: str = "scan"):
        self.budget = env_int("KEYSTONE_SCAN_RETRIES", 0, minimum=0) if budget is None else budget
        self.backoff_s = (env_float("KEYSTONE_SCAN_RETRY_BACKOFF", 0.05)
                          if backoff_s is None else backoff_s)
        self.label = label
        self.attempts = 0  # retries taken
        self._lock = threading.Lock()

    def consume(self, exc: BaseException, site: str) -> Optional[float]:
        """One retry decision: the backoff in seconds when ``exc`` is
        transient and the budget is not spent, else None (the caller
        re-raises the original)."""
        if not is_transient(exc):
            return None
        with self._lock:
            if self.attempts >= self.budget:
                return None
            self.attempts += 1
            attempt = self.attempts
        delay = min(self.backoff_s * (2 ** (attempt - 1)), MAX_BACKOFF_S)
        logger.warning("%s: transient failure at %s, retry %d/%d in %.3f s (%s)",
                       self.label, site, attempt, self.budget, delay, exc)
        try:
            from ..obs.tracer import current as _trace_current

            # the recovery instant of the scan seams (``obs.flight.SITE_INSTANTS``)
            tracer = _trace_current()
            if tracer is not None:
                tracer.instant("retry.attempt", op_type="RetryBudget", site=site,
                               attempt=attempt, budget=self.budget, delay_s=round(delay, 4),
                               label=self.label)
        except Exception:
            # recording must never change what the retry does
            logger.debug("retry.attempt instant not recorded", exc_info=True)
        return delay


def retry_call(fn: Callable[[], Any], budget: RetryBudget, site: str, inject: bool = True,
               **attrs) -> Any:
    """``fn()``, run again after a transient error while ``budget`` lasts;
    any other error, and the last transient one, propagates as raised.
    With ``inject``, ``fault_point(site, **attrs)`` fires before each
    attempt, so a fault plan's transient faults at ``site`` retry the same
    way. ``fn`` must be safe to run again (a chunk regenerated by index, a
    copy)."""
    while True:
        try:
            if inject:
                fault_point(site, **attrs)
            return fn()
        except StopIteration:
            raise
        except Exception as e:
            delay = budget.consume(e, site)
            if delay is None:
                raise
            if delay:
                time.sleep(delay)
