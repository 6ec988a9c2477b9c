from .core import (
    LinearRectifier,
    PaddedFFT,
    RandomSignNode,
    Sampler,
    StandardScaler,
    StandardScalerModel,
)

__all__ = ["LinearRectifier", "PaddedFFT", "RandomSignNode", "Sampler",
           "StandardScaler", "StandardScalerModel"]
