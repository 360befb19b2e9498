"""Operators of the port; this module is the ``F`` namespace that
``HybridBlock.hybrid_forward`` receives. Importing it registers every op
module with the registry, from which ``mx.nd`` is built."""
from . import elemwise, reduce  # noqa: F401  (registration)
from .init_ops import arange
from .matrix import Embedding, reshape, transpose
from .nn import (Activation, BatchNorm, Convolution, FullyConnected,
                 LayerNorm, Pooling)

__all__ = ["Activation", "BatchNorm", "Convolution", "FullyConnected",
           "LayerNorm", "Pooling", "Embedding", "reshape", "transpose",
           "arange"]
