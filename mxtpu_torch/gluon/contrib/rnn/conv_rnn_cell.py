"""Convolutional recurrent cells (counterpart of
``mxtpu/gluon/contrib/rnn/conv_rnn_cell.py``).

The input and the state are feature maps (channels first) and the i2h and
h2h projections are convolutions; the h2h convolution pads to keep the
state's shape, so its kernel must be odd. Gates are packed as in the
dense cells (LSTM i, f, g, o; GRU r, z, n).
"""
from __future__ import annotations

from ....base import MXNetError
from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tuplify(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _BaseConvRNNCell(HybridRecurrentCell):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)
        self._conv_layout = conv_layout
        self._activation = activation
        self._dims = dims
        self._i2h_kernel = _tuplify(i2h_kernel, dims)
        self._h2h_kernel = _tuplify(h2h_kernel, dims)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise MXNetError(
                    "h2h_kernel must be odd so the state shape is "
                    "preserved; got %s" % (self._h2h_kernel,))
        self._i2h_pad = _tuplify(i2h_pad, dims)
        self._i2h_dilate = _tuplify(i2h_dilate, dims)
        self._h2h_dilate = _tuplify(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        in_channels = self._input_shape[0]
        gates = self._num_gates
        self._state_shape = self._compute_state_shape()
        self.i2h_weight = self.params.get(
            "i2h_weight",
            shape=(hidden_channels * gates, in_channels) + self._i2h_kernel,
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(hidden_channels * gates, hidden_channels)
            + self._h2h_kernel,
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_channels * gates,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_channels * gates,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def _compute_state_shape(self):
        out_spatial = [s + 2 * p - d * (k - 1)
                       for s, k, p, d in zip(self._input_shape[1:],
                                             self._i2h_kernel, self._i2h_pad,
                                             self._i2h_dilate)]
        return (self._hidden_channels,) + tuple(out_spatial)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": self._conv_layout}] * self._num_states

    def infer_shape(self, inputs, states):
        pass   # every shape is given by input_shape

    def _conv(self, F, x, weight, bias, pad, dilate):
        return F.Convolution(
            x, weight, bias, kernel=tuple(weight.shape[2:]),
            stride=(1,) * self._dims, dilate=dilate, pad=pad,
            num_filter=weight.shape[0])

    def _gates(self, F, inputs, states, i2h_weight, h2h_weight, i2h_bias,
               h2h_bias):
        i2h = self._conv(F, inputs, i2h_weight, i2h_bias, self._i2h_pad,
                         self._i2h_dilate)
        h2h = self._conv(F, states[0], h2h_weight, h2h_bias, self._h2h_pad,
                         self._h2h_dilate)
        return i2h, h2h


class _ConvRNNCell(_BaseConvRNNCell):
    _num_gates = 1
    _num_states = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._gates(F, inputs, states, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    _num_gates = 4
    _num_states = 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._gates(F, inputs, states, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        slices = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = self._get_activation(F, slices[2], self._activation)
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    _num_gates = 3
    _num_states = 1

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._gates(F, inputs, states, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        i2h_s = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_s = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset_gate = F.sigmoid(i2h_s[0] + h2h_s[0])
        update_gate = F.sigmoid(i2h_s[1] + h2h_s[1])
        next_h_tmp = self._get_activation(
            F, i2h_s[2] + reset_gate * h2h_s[2], self._activation)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * states[0]
        return next_h, [next_h]


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _make(base, dims, name):
    def __init__(self, input_shape, hidden_channels, i2h_kernel=3,
                 h2h_kernel=3, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout=None, activation="tanh", prefix=None,
                 params=None):
        if activation == "leaky":
            from ...nn import LeakyReLU
            activation = LeakyReLU(alpha=0.01)
        base.__init__(self, input_shape, hidden_channels, i2h_kernel,
                      h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                      i2h_weight_initializer, h2h_weight_initializer,
                      i2h_bias_initializer, h2h_bias_initializer, dims,
                      conv_layout or _LAYOUTS[dims], activation,
                      prefix=prefix, params=params)
    cls = type(name, (base,), {"__init__": __init__})
    cls.__doc__ = "%s (ref: contrib/rnn/conv_rnn_cell.py:%s)" % (name, name)
    return cls


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell")
