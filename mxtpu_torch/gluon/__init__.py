"""Gluon API of the port (counterpart of ``mxtpu/gluon``)."""
from . import model_zoo, nn
from .block import Block, HybridBlock
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "nn", "model_zoo"]
