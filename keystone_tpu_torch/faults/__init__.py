"""Recovery of transient failures in out-of-core scans (port of
``keystone_tpu/faults/retry.py`` and the error classification of
``keystone_tpu/faults/plan.py``). The fault-injection plan and the fit
checkpoints are not ported."""

from .retry import (
    SCAN_CHUNK,
    SCAN_STAGE,
    RetryBudget,
    TransientError,
    is_transient,
    retry_call,
)

__all__ = ["SCAN_CHUNK", "SCAN_STAGE", "RetryBudget", "TransientError",
           "is_transient", "retry_call"]
