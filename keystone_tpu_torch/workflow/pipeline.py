"""A lean, eager counterpart of ``keystone_tpu/workflow/pipeline.py``.

A pipeline is a tuple of stages: fitted transformers, and estimators
with the data they are fitted on. What the JAX package does through its
graph, optimizer and executor is done here in order, eagerly:

* ``and_then(est, data[, labels])`` fits ``est`` on ``self(data)``, once:
  the fitted model is kept on the stage, which every pipeline composed
  from the same prefix shares (the fit-once semantics of the reference).
* ``Pipeline.fit()`` fits every estimator in order and returns a
  :class:`FittedPipeline` of transformers only. Fit data fed to several
  estimators is featurized once and carried forward from stage to stage.
* Runs of ``row_local`` transformers are applied in row chunks, so the
  large intermediates of an image featurizer (a conv output of 14.6 GB
  for 50000 CIFAR images) never exist for the whole batch at once. Each
  chunk's output is copied into one output allocated up front, so the
  peak is one copy of the output plus one chunk's intermediates.
* ``Pipeline.gather(branches)`` fans the input through each branch and
  gives the tuple of their outputs; it is row-local when every branch
  stage is, so a gathered featurizer runs in row chunks too.

The graph optimizer, executor, auto-caching and segment compilation of
the JAX package are not ported.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..data.dataset import Dataset, Payload

#: rows per chunk when applying a run of row-local transformers
ROW_CHUNK = 2500


def _parts(X: Payload) -> Tuple[torch.Tensor, ...]:
    return X if isinstance(X, tuple) else (X,)


def clock(t: Payload) -> float:
    """Host time after the device has finished the work queued on ``t``'s
    device (a plain host clock measures only the enqueue on CUDA)."""
    t = _parts(t)[0]
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def _apply_run(stages: Sequence[Any], X: Payload) -> Payload:
    for st in stages:
        X = st.forward(X)
    return X


def _apply_chunked(stages: Sequence[Any], X: Payload) -> Payload:
    """Apply row-local ``stages`` over row chunks of :data:`ROW_CHUNK`,
    writing each chunk's output into one output allocated at the first
    chunk (never a list of chunk outputs joined at the end, which would
    hold the output twice)."""
    n = len(Dataset(X))
    out: Tuple[torch.Tensor, ...] = ()
    tuple_out = False
    for s in range(0, n, ROW_CHUNK):
        chunk = _rows(X, s, s + ROW_CHUNK)
        part = _apply_run(stages, chunk)
        if not out:
            tuple_out = isinstance(part, tuple)
            out = tuple(torch.empty((n,) + p.shape[1:], dtype=p.dtype, device=p.device)
                        for p in _parts(part))
        for o, p in zip(out, _parts(part)):
            o[s:s + p.shape[0]].copy_(p)
        del chunk, part
    return out if tuple_out else out[0]


def _rows(X: Payload, start: int, end: int) -> Payload:
    return tuple(p[start:end] for p in X) if isinstance(X, tuple) else X[start:end]


def apply_stages(stages: Sequence[Any], data: Any) -> Dataset:
    """Apply fitted transformers in order; consecutive row-local ones run
    together over row chunks of :data:`ROW_CHUNK`."""
    X = Dataset.of(data).to_array()
    i = 0
    while i < len(stages):
        j = i
        while j < len(stages) and stages[j].row_local:
            j += 1
        if j > i:
            run = stages[i:j]
            if len(Dataset(X)) <= ROW_CHUNK:
                X = _apply_run(run, X)
            else:
                X = _apply_chunked(run, X)
            i = j
        else:
            X = stages[i].forward(X)
            i += 1
    return Dataset(X)


class FitStage:
    """An estimator with the data (and labels) it is fitted on, fed at the
    source of the pipeline it ends; ``model`` is set by the first fit."""

    def __init__(self, estimator: Any, data: Any, labels: Any = None):
        self.estimator = estimator
        self.data = data
        self.labels = labels
        self.model: Any = None

    def fit(self, features: Dataset) -> Any:
        if self.labels is None:
            return self.estimator.fit(features)
        return self.estimator.fit(features, Dataset.of(self.labels))


class GatherStage:
    """The stage ``Pipeline.gather`` makes: each branch's transformers
    applied in order to the same input, giving one output per branch."""

    def __init__(self, branches: Sequence[Tuple[Any, ...]]):
        self.branches = tuple(tuple(b) for b in branches)
        self.row_local = all(st.row_local for b in self.branches for st in b)

    def forward(self, X: Payload) -> Tuple[torch.Tensor, ...]:
        return tuple(_apply_run(b, X) for b in self.branches)


class Chainable:
    """Anything composable with ``and_then`` (parity: ``Chainable``)."""

    def to_pipeline(self) -> "Pipeline":
        raise NotImplementedError

    def and_then(self, nxt: Any, *fit_data: Any) -> "Pipeline":
        """``self`` then ``nxt``; with an estimator, ``fit_data`` is the
        data (and labels) fed to ``self`` to fit it on."""
        from .transformer import Estimator, LabelEstimator

        stages = self.to_pipeline().stages
        if isinstance(nxt, (Estimator, LabelEstimator)):
            if not fit_data:
                raise ValueError(
                    "and_then(estimator) needs training data: "
                    "and_then(est, data[, labels])"
                )
            if isinstance(nxt, LabelEstimator) and len(fit_data) != 2:
                raise ValueError("a LabelEstimator needs data and labels")
            return Pipeline(stages + (FitStage(nxt, *fit_data),))
        if fit_data:
            raise ValueError("fit data only applies when chaining an estimator")
        return Pipeline(stages + nxt.to_pipeline().stages)

    def __call__(self, data: Any) -> "PipelineResult":
        return PipelineResult(self.to_pipeline(), data)


class PipelineResult:
    """A lazy handle on a pipeline applied to data; ``get`` fits what is
    not fitted yet and applies."""

    def __init__(self, pipeline: "Pipeline", data: Any):
        self._pipeline = pipeline
        self._data = data

    def get(self) -> Dataset:
        return self._pipeline.fit().apply(self._data)


class Pipeline(Chainable):
    """A chain of transformers and estimator stages."""

    def __init__(self, stages: Tuple[Any, ...]):
        self.stages = tuple(stages)

    def to_pipeline(self) -> "Pipeline":
        return self

    @staticmethod
    def gather(branches: Sequence[Chainable]) -> "Pipeline":
        """Fan one input through every branch and give the tuple of their
        outputs (parity: ``Pipeline.gather``). Branches hold transformers
        only: an estimator inside a branch is not supported here."""
        if not branches:
            raise ValueError("gather of zero branches")
        stages = [b.to_pipeline().stages for b in branches]
        if any(isinstance(st, FitStage) for b in stages for st in b):
            raise ValueError("gather branches must hold transformers only")
        return Pipeline((GatherStage(stages),))

    def fit(self) -> "FittedPipeline":
        """Fit every estimator not fitted yet, in order. The returned
        pipeline's ``seconds`` holds the time spent featurizing fit data
        ("featurize") and in each estimator's fit (by class name)."""
        fitted: List[Any] = []
        seconds: Dict[str, float] = {}
        # id(fit data) -> (fit data, stages applied so far, features)
        carried: Dict[int, Tuple[Any, int, Dataset]] = {}
        for st in self.stages:
            if not isinstance(st, FitStage):
                fitted.append(st)
                continue
            if st.model is None:
                _, done, feats = carried.get(
                    id(st.data), (st.data, 0, Dataset.of(st.data))
                )
                t0 = clock(feats.to_array())
                feats = apply_stages(fitted[done:], feats)
                t1 = clock(feats.to_array())
                carried[id(st.data)] = (st.data, len(fitted), feats)
                st.model = st.fit(feats)
                t2 = clock(feats.to_array())
                seconds["featurize"] = seconds.get("featurize", 0.0) + t1 - t0
                name = type(st.estimator).__name__
                seconds[name] = seconds.get(name, 0.0) + t2 - t1
            fitted.append(st.model)
        return FittedPipeline(fitted, seconds)


class FittedPipeline(Chainable):
    """An estimator-free pipeline: transformers applied in order."""

    def __init__(self, stages: Sequence[Any],
                 seconds: Optional[Dict[str, float]] = None):
        self.stages = tuple(stages)
        self.seconds = dict(seconds or {})

    def to_pipeline(self) -> Pipeline:
        return Pipeline(self.stages)

    def apply(self, data: Any) -> Dataset:
        return apply_stages(self.stages, data)
