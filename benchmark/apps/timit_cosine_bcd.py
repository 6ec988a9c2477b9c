"""TimitPipeline through the port's own entry point,
``pipelines/timit.py::run`` (compose, fit, score the train and test sets),
handed the cosine branches' weights drawn in set-up (``params=``)."""

from __future__ import annotations

import torch

from benchmark.apps.common import Patch, fresh_environment, only
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator, BlockLinearMapper
from keystone_tpu_torch.pipelines import timit


def program_config(cfg: dict, seed: int) -> timit.TimitConfig:
    return timit.TimitConfig(
        num_cosines=cfg["num_cosines"], gamma=cfg["gamma"], rf_type=cfg["rf_type"],
        lam=cfg["lambda"], num_epochs=cfg["num_epochs"], num_classes=cfg["num_classes"],
        input_dim=cfg["input_dim"], cosine_features=cfg["cosine_features"], seed=seed)


def feature_rows(data, rows: torch.Tensor) -> torch.Tensor:
    """The rows ``rows`` of the features an estimator is fitted on: a
    Dataset of an (n, d) matrix, or of column blocks side by side."""
    payload = data if isinstance(data, (list, tuple)) else Dataset.of(data).payload
    if isinstance(payload, (list, tuple)):
        return torch.cat([Dataset.of(b).to_array()[rows.to(b.device)] for b in payload], dim=1)
    return payload[rows.to(payload.device)]


class App:
    def __init__(self, cfg: dict, inputs: dict, seed: int, device: torch.device):
        self.inputs = inputs
        self.device = device
        self.conf = program_config(cfg, seed)
        self.train = LabeledData(inputs["y_train"], inputs["X_train"])
        self.test = LabeledData(inputs["y_test"], inputs["X_test"])
        # the run takes its branches' weights as host arrays, one (W, b) a
        # branch: copied off the card once
        W = inputs["cos_W"].cpu().numpy()
        b = inputs["cos_b"].cpu().numpy()
        self.params = [(W[i], b[i]) for i in range(W.shape[0])]
        self.scorer = None
        #: the sampled rows of the features the last run's solver was fed
        self.features = None
        self.taps = [Patch(BlockLeastSquaresEstimator, "fit", self._sample_features)]

    def _sample_features(self, fit):
        def sampled(estimator, data, labels):
            self.features = feature_rows(data, self.inputs["feature_rows"])
            return fit(estimator, data, labels)
        return sampled

    def forget(self) -> None:
        self.scorer = self.features = None
        fresh_environment()

    def close(self) -> None:
        for tap in self.taps:
            tap.close()

    def run(self) -> None:
        """One application run, as its CLI makes it."""
        self.scorer = timit.run(self.train, self.test, self.conf, self.device,
                                params=self.params)[0]

    def outputs(self, answers: list) -> dict:
        """The last run's fitted model, a seeded sample of the rows of the
        features its solver was fed (every branch), and the test set's
        scores. The run's own scores never leave the card's CUDA graphs
        (its linear model and classifier are row-local and run as one
        captured graph a row chunk, handing on labels only), so the test set
        is scored once more through that run's fitted scorer, at the run's
        size."""
        fitted = self.scorer.fit()
        model = only(fitted.graph, BlockLinearMapper)
        return {
            "means": torch.cat(model.feature_means),
            "weights": torch.cat(model.xs),
            "features": self.features,
            "scores": fitted.apply(self.inputs["X_test"]).to_array(),
        }
