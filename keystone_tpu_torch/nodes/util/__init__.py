from .sparse_features import AllSparseFeatures, CommonSparseFeatures, SparseFeatureVectorizer
from .core import (
    Cacher,
    ClassLabelIndicators,
    Densify,
    DoubleToFloat,
    FloatToDouble,
    MatrixVectorizer,
    MaxClassifier,
    MultiClassLabelIndicators,
    Shuffler,
    Sparsify,
    TopKClassifier,
    VectorCombiner,
    VectorSplitter,
)

__all__ = ["AllSparseFeatures", "Cacher", "ClassLabelIndicators", "CommonSparseFeatures",
           "Densify", "DoubleToFloat", "FloatToDouble", "MatrixVectorizer", "MaxClassifier",
           "MultiClassLabelIndicators", "Shuffler", "SparseFeatureVectorizer", "Sparsify",
           "TopKClassifier", "VectorCombiner", "VectorSplitter"]
