"""What every application module shares: a fresh pipeline environment for
each run, taps on the port's entry points (the per-fit seconds it records,
the static checker's seconds), and a walk over the operators of a fitted
graph."""

from __future__ import annotations

import time
from typing import Callable, Iterator, List

import keystone_tpu_torch.workflow.pipeline as pipeline_mod
from keystone_tpu_torch.compile.segment import reset_dispatchers
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.fusion import FusedTransformerOperator, clear_graph_cache
from keystone_tpu_torch.workflow.optimizers import clear_memo
from keystone_tpu_torch.workflow.pipeline import Pipeline


def fresh_environment() -> None:
    """Forget every earlier fit, as a new process of the application would:
    the saved prefixes (and the features and models they hold), the
    optimizer's memo of plans, and the CUDA graphs the process keeps for
    later fits (the fused groups' and the segment dispatchers', up to 64
    and 128 of them, each with its memory pool: a run's fill the card
    within four TIMIT runs)."""
    PipelineEnv.get_or_create().reset()
    clear_memo()
    clear_graph_cache()
    reset_dispatchers()


class Patch:
    """While open, ``owner.name`` is ``wrap(original)``; ``close`` puts the
    original back."""

    def __init__(self, owner, name: str, wrap: Callable) -> None:
        self.owner, self.name = owner, name
        self.original = getattr(owner, name)
        setattr(owner, name, wrap(self.original))

    def close(self) -> None:
        setattr(self.owner, self.name, self.original)


class FitSeconds(Patch):
    """While open, keeps a copy of ``FittedPipeline.seconds`` of every
    ``Pipeline.fit``: optimize (the rule stack), featurize, each
    estimator's fit, executor (the port's host seconds, the card
    synchronized at each boundary). It keeps no reference to the fitted
    pipeline."""

    def __init__(self) -> None:
        self.seconds: List[dict] = []

        def wrap(fit):
            def kept(pipeline):
                fitted = fit(pipeline)
                self.seconds.append(dict(fitted.seconds))
                return fitted
            return kept

        super().__init__(Pipeline, "fit", wrap)


class CheckSeconds(Patch):
    """While open, the host seconds of every call of the static checker that
    ``Pipeline.and_then`` and ``Pipeline.fit`` run (``workflow/pipeline.py::
    _static_check``; it runs on fake tensors and launches nothing on the
    card), outside ``FittedPipeline.seconds``."""

    def __init__(self) -> None:
        self.seconds: List[float] = []

        def wrap(check):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return check(*args, **kwargs)
                finally:
                    self.seconds.append(time.perf_counter() - t0)
            return timed

        super().__init__(pipeline_mod, "_static_check", wrap)


def operators(graph) -> Iterator[object]:
    """Every operator of ``graph``, the steps of fused groups included."""
    for node in graph.nodes:
        op = graph.get_operator(node)
        if isinstance(op, FusedTransformerOperator):
            yield from (step for step, _ in op.steps)
        else:
            yield op


def only(graph, cls) -> object:
    """The one operator of type ``cls`` in ``graph``."""
    found = [op for op in operators(graph) if isinstance(op, cls)]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} operators of type {cls.__name__} in the fitted graph")
    return found[0]
