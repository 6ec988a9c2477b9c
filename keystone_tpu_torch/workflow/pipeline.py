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
  for 50000 CIFAR images) never exist for the whole batch at once.

The graph optimizer, executor, auto-caching and segment compilation of
the JAX package are not ported.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..data.dataset import Dataset

#: rows per chunk when applying a run of row-local transformers
ROW_CHUNK = 2500


def clock(t: torch.Tensor) -> float:
    """Host time after the device has finished the work queued on ``t``'s
    device (a plain host clock measures only the enqueue on CUDA)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def _apply_run(stages: Sequence[Any], X: torch.Tensor) -> torch.Tensor:
    for st in stages:
        X = st.forward(X)
    return X


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
            if X.shape[0] <= ROW_CHUNK:
                X = _apply_run(run, X)
            else:
                X = torch.cat([
                    _apply_run(run, X[s:s + ROW_CHUNK])
                    for s in range(0, X.shape[0], ROW_CHUNK)
                ])
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
