from .core import ClassLabelIndicators, MaxClassifier

__all__ = ["ClassLabelIndicators", "MaxClassifier"]
