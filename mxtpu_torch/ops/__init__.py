"""Operators of the port; this module is the ``F`` namespace that
``HybridBlock.hybrid_forward`` receives."""
from .nn import Activation, BatchNorm, Convolution, FullyConnected, Pooling

__all__ = ["Activation", "BatchNorm", "Convolution", "FullyConnected",
           "Pooling"]
