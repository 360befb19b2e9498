"""Recurrent cells and fused layers (counterpart of ``mxtpu/gluon/rnn``)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
