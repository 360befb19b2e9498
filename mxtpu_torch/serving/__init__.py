"""Inference serving of the port (counterpart of ``mxtpu/serving``)."""
from .engine import BucketSpec, Predictor

__all__ = ["BucketSpec", "Predictor"]
