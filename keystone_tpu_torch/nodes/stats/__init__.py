from .core import Sampler, StandardScaler, StandardScalerModel

__all__ = ["Sampler", "StandardScaler", "StandardScalerModel"]
