from .core import (
    ColumnSampler,
    CosineRandomFeatures,
    LinearRectifier,
    NormalizeRows,
    PaddedFFT,
    RandomSignNode,
    Sampler,
    SignedHellingerMapper,
    StandardScaler,
    StandardScalerModel,
    TermFrequency,
)

__all__ = ["ColumnSampler", "CosineRandomFeatures", "LinearRectifier", "NormalizeRows",
           "PaddedFFT", "RandomSignNode", "Sampler", "SignedHellingerMapper",
           "StandardScaler", "StandardScalerModel", "TermFrequency"]
