"""Gluon contrib (counterpart of ``mxtpu/gluon/contrib``)."""
from . import nn
from . import rnn

__all__ = ["nn", "rnn"]
