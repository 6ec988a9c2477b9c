"""RandomPatchCifarKernel through the port's own entry points:
``pipelines/cifar_extras.py::run_random_patch_cifar_kernel`` for a whole
application run (filters, compose, fit, score the train and test sets), and
``FittedPipeline.apply_compiled`` of the fitted scorer for batch scoring."""

from __future__ import annotations

import torch

from torch._subclasses.fake_tensor import is_fake

from benchmark.apps.common import Patch, fresh_environment, only
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.nodes.images.core import Convolver
from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
from keystone_tpu_torch.nodes.stats import StandardScalerModel
from keystone_tpu_torch.pipelines.cifar_extras import (
    KernelCifarConfig,
    run_random_patch_cifar_kernel,
)


def program_config(cfg: dict, seed: int) -> KernelCifarConfig:
    return KernelCifarConfig(
        num_filters=cfg["num_filters"], whitening_epsilon=cfg["whitening_epsilon"],
        patch_size=cfg["patch_size"], patch_steps=cfg["patch_steps"],
        pool_size=cfg["pool_size"], pool_stride=cfg["pool_stride"], alpha=cfg["alpha"],
        lam=cfg["lambda"], whitener_size=cfg["whitener_size"], seed=seed,
        gamma=cfg["gamma"], cache_kernel=cfg["cache_kernel"],
        block_size=cfg["block_size"], num_epochs=cfg["num_epochs"])


class App:
    def __init__(self, cfg: dict, inputs: dict, seed: int, device: torch.device):
        self.inputs = inputs
        self.device = device
        self.conf = program_config(cfg, seed)
        self.train = LabeledData(inputs["y_train"], inputs["X_train"])
        self.test = LabeledData(inputs["y_test"], inputs["X_test"])
        self.scorer = None
        self.fitted = None
        #: the kernel model's last two eager answers: a run's scores of its
        #: train and its test set
        self.scores: list = []
        self.taps = [Patch(KernelBlockLinearMapper, "forward", self._keep_scores)]

    def _keep_scores(self, forward):
        """The mapper's ``forward``, keeping what it answers eagerly (not
        the static checker's fake tensors, nor a CUDA graph's capture)."""
        def kept(mapper, X):
            out = forward(mapper, X)
            if not is_fake(out) and not (out.is_cuda and torch.cuda.is_current_stream_capturing()):
                self.scores[:] = self.scores[-1:] + [out]
            return out
        return kept

    def forget(self) -> None:
        self.scorer = self.fitted = None
        self.scores.clear()
        fresh_environment()

    def close(self) -> None:
        for tap in self.taps:
            tap.close()

    def run(self) -> None:
        """One application run, as its CLI makes it."""
        self.scorer = run_random_patch_cifar_kernel(
            self.train, self.test, self.conf, self.device)[0]

    def fit(self) -> None:
        """The scorer of one run, fitted, for batch scoring."""
        self.run()
        self.fitted = self.scorer.fit()

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        return self.fitted.apply_compiled(X)

    def outputs(self, answers: list) -> dict:
        """What the window produced. A batch loop: every batch's scores.
        Runs: the last run's fitted model (the objects its fit left: the
        scorer's fit is memoized) and its own scores of the train and the
        test set, as its kernel model answered them (it runs eagerly: it
        is not row-local, so no CUDA graph holds it)."""
        if answers:
            return {"scores": answers}
        fitted = self.scorer.fit()
        conv = only(fitted.graph, Convolver)
        scaler = only(fitted.graph, StandardScalerModel)
        model = only(fitted.graph, KernelBlockLinearMapper)
        return {
            "filters": conv.filters,
            "whitener": (conv.whitener.whitener, conv.whitener.means),
            "scaler": (scaler.mean, scaler.std),
            "features": model.train_X,
            "weights": model.W,
            "scores": tuple(self.scores),
        }
