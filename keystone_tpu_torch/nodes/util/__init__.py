from .core import (
    Cacher,
    ClassLabelIndicators,
    DoubleToFloat,
    FloatToDouble,
    MatrixVectorizer,
    MaxClassifier,
    MultiClassLabelIndicators,
    Shuffler,
    TopKClassifier,
    VectorCombiner,
    VectorSplitter,
)

__all__ = ["Cacher", "ClassLabelIndicators", "DoubleToFloat", "FloatToDouble",
           "MatrixVectorizer", "MaxClassifier", "MultiClassLabelIndicators", "Shuffler",
           "TopKClassifier", "VectorCombiner", "VectorSplitter"]
