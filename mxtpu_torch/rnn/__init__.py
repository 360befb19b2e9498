"""``mx.rnn``: the symbolic RNN cells, their checkpoint helpers and the
bucketed sentence iterator (counterpart of ``mxtpu/rnn``). The cells
compose Symbol graphs; Gluon's cells are ``gluon.rnn``."""
from .io import BucketSentenceIter, encode_sentences
from .rnn import (do_rnn_checkpoint, load_rnn_checkpoint, rnn_unroll,
                  save_rnn_checkpoint)
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       ResidualCell, RNNCell, RNNParams, SequentialRNNCell,
                       ZoneoutCell)

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell", "ModifierCell",
           "BucketSentenceIter", "encode_sentences", "rnn_unroll",
           "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]
