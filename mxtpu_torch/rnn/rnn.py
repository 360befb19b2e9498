"""RNN checkpoint helpers (counterpart of ``mxtpu/rnn/rnn.py``): save and
load with ``FusedRNNCell``'s weight unpack/pack, so fused-blob checkpoints
round-trip through the reference's prefix-epoch files.
"""
from __future__ import annotations

import warnings

from ..model import load_checkpoint, save_checkpoint
from .rnn_cell import BaseRNNCell

__all__ = ["rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def rnn_unroll(cell, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC"):
    """Deprecated alias of cell.unroll (ref: rnn.py:26)."""
    warnings.warn("rnn_unroll is deprecated. Please call cell.unroll "
                  "directly.")
    if input_prefix:
        # the reference forwards this to name auto-created inputs; this
        # unroll names inputs explicitly — refuse rather than silently
        # produce differently-named variables
        raise ValueError("input_prefix is not supported: pass inputs= "
                         "explicitly (cell.unroll names them)")
    return cell.unroll(length=length, inputs=inputs, begin_state=begin_state,
                       layout=layout)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save with fused weights UNPACKED (ref: rnn.py:32) — the on-disk
    format holds per-gate arrays; the fused blob is a runtime layout."""
    if isinstance(cells, BaseRNNCell):
        cells = [cells]
    for cell in cells:
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load and re-PACK weights for the given cells (ref: rnn.py:62)."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    if isinstance(cells, BaseRNNCell):
        cells = [cells]
    for cell in cells:
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback checkpointing with unpacked weights
    (ref: rnn.py:97; the RNN twin of mx.callback.do_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
