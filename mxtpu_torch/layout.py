"""Global convolution-layout scope (counterpart of ``mxtpu/layout.py``).

``with layout("NHWC"): net = vision.resnet50_v1()`` makes channels-last the
default of every Conv/Pool/BatchNorm layer built in the scope. Explicit
``layout=``/``axis=`` arguments win over the scope, and the scope affects
construction only. Channels-last convs store HWIO weights, the layout the
port's conv kernel reads as a row-major ``[K, C_out]`` matrix.
"""
from __future__ import annotations

import threading

from .base import MXNetError

__all__ = ["layout", "current_layout", "conv_layout", "channel_axis",
           "is_channels_last"]

_state = threading.local()

_CHANNELS_LAST = {1: "NWC", 2: "NHWC", 3: "NDHWC"}
_CHANNELS_FIRST = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


class layout:
    """Context manager / global setter for the default conv-family layout.

    A bare ``layout("NHWC")`` call sets the default globally; used as a
    context manager it restores the previous default on exit.
    """

    def __init__(self, name):
        name = str(name)
        if name == "channels_last" or name in _CHANNELS_LAST.values():
            last = True
        elif name == "channels_first" or name in _CHANNELS_FIRST.values():
            last = False
        else:
            raise MXNetError(
                "unknown layout %r; expected one of %s / %s or "
                "channels_first / channels_last"
                % (name, sorted(_CHANNELS_FIRST.values()),
                   sorted(_CHANNELS_LAST.values())))
        self._prev = getattr(_state, "channels_last", False)
        _state.channels_last = last

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _state.channels_last = self._prev
        return False


def is_channels_last():
    return getattr(_state, "channels_last", False)


def current_layout(ndim=2):
    table = _CHANNELS_LAST if is_channels_last() else _CHANNELS_FIRST
    if ndim not in table:
        raise MXNetError("unsupported spatial ndim %d" % ndim)
    return table[ndim]


def conv_layout(explicit, ndim):
    """A layer's layout argument: the explicit value wins, else the scope."""
    return explicit if explicit is not None else current_layout(ndim)


def channel_axis(layout_str):
    """Channel axis of a layout string ('NCHW' -> 1, 'NHWC' -> -1)."""
    if layout_str is None:
        return -1 if is_channels_last() else 1
    return -1 if layout_str.endswith("C") and layout_str[1] != "C" else 1
