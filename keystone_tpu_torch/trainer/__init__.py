"""Closed-loop continual learning: the supervised trainer daemon (port of
``keystone_tpu/trainer``).

``FittedPipeline.absorb`` folds appended chunks in O(new), the fleet does
canaried zero-downtime swaps, and ``faults/`` provides seeded faults and
checkpoint/resume; this package joins them into one hands-free loop that
keeps serving correctly while everything around it churns or fails.

* :class:`ChunkLog` (:mod:`.source`): the append-only chunk feed the
  daemon tails;
* :class:`DriftMonitor` (:mod:`.drift`): moment-shift and residual
  triggers against the fitted solver state's own moments;
* :class:`TrainerDaemon` (:mod:`.daemon`): the supervised loop: tail →
  decide (cadence or drift) → checkpointed absorb → canary swap → promote
  or roll back, with batch quarantine and explicit restart budgets. The
  fault sites ``trainer.ingest`` / ``trainer.absorb`` / ``trainer.canary``
  ride the ``KEYSTONE_FAULTS`` plan, so every failure path is testable.

``python -m keystone_tpu_torch --trainer-demo [--device cpu]`` runs the
whole loop against a live fleet with synthetic appends, a poisoned batch
among them that must roll back.
"""

from .daemon import TrainerDaemon, TrainerStopped
from .drift import DriftMonitor
from .source import AppendedChunk, ChunkLog

__all__ = [
    "AppendedChunk",
    "ChunkLog",
    "DriftMonitor",
    "TrainerDaemon",
    "TrainerStopped",
]
