"""Gluon API of the port (counterpart of ``mxtpu/gluon``)."""
from . import loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from .utils import clip_global_norm, split_and_load, split_data
from . import data  # noqa: E402
from . import contrib  # noqa: E402

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Trainer", "loss", "nn",
           "model_zoo", "utils", "data", "rnn", "contrib",
           "split_and_load", "split_data", "clip_global_norm"]
