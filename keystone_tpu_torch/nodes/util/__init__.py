from .core import (
    Cacher,
    ClassLabelIndicators,
    MatrixVectorizer,
    MaxClassifier,
    MultiClassLabelIndicators,
    VectorCombiner,
    VectorSplitter,
)

__all__ = ["Cacher", "ClassLabelIndicators", "MatrixVectorizer", "MaxClassifier",
           "MultiClassLabelIndicators", "VectorCombiner", "VectorSplitter"]
