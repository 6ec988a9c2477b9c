from .core import ClassLabelIndicators, MaxClassifier, VectorCombiner, VectorSplitter

__all__ = ["ClassLabelIndicators", "MaxClassifier", "VectorCombiner", "VectorSplitter"]
