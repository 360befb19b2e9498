"""Fused recurrent layers ``RNN``, ``LSTM``, ``GRU`` (counterpart of
``mxtpu/gluon/rnn/rnn_layer.py``).

Each layer holds its weights under the reference's names
(``{l,r}{i}_{i2h,h2h}_{weight,bias}``, deferred until the first input
gives ``input_size``) and packs them at every forward into the one
parameter vector of the fused ``RNN`` op (ops/rnn_ops.py). Called as
``layer(x)`` it returns the outputs; as ``layer(x, states)`` the pair
``(outputs, states)``, which a hybridized layer captures as it is (the
nested inputs and outputs go through ``CachedOp``). Without states the
begin state is zeros on the input's device, float32 as the reference's
``nd.zeros`` makes them (bfloat16 weights then run float32 products,
ops/rnn_ops.py). ``dropout`` is passed to the op as ``p``, which ignores
it, as the JAX package does.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError("Invalid layout %s; must be TNC or NTC"
                             % layout)
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param("{}{}_i2h_weight".format(j, i),
                                     (ng * nh, ni), i2h_weight_initializer)
                self._register_param("{}{}_h2h_weight".format(j, i),
                                     (ng * nh, nh), h2h_weight_initializer)
                self._register_param("{}{}_i2h_bias".format(j, i),
                                     (ng * nh,), i2h_bias_initializer)
                self._register_param("{}{}_h2h_bias".format(j, i),
                                     (ng * nh,), h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        setattr(self, name, self.params.get(name, shape=shape, init=init,
                                            allow_deferred_init=True))

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(shape[1] if shape[1] else None,
                                      shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def infer_shape(self, inputs, *args):
        ni = inputs.shape[2]
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                getattr(self, "{}{}_i2h_weight".format(j, i))._shape_resolved(
                    (ng * nh, ni))
            ni = nh * self._dir

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, ``func(name=, shape=, **kwargs)`` each
        (default ``mx.nd.zeros``) (ref: rnn_layer.py:begin_state)."""
        if func is None:
            from ... import ndarray
            func = ndarray.zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            kw = dict(kwargs)
            if info is not None:
                kw.update(info)
            states.append(func(name="%sh0_%d" % (self.prefix, i), **kw))
        return states

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, 0, 1)
        batch_size = inputs.shape[1]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, func=F.zeros,
                                      ctx=inputs.device)
        if not isinstance(states, (list, tuple)):
            states = [states]
        # the fused op's layout: weights (layer-, then direction-major,
        # i2h then h2h), then the biases in the same order
        flat = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                flat.append(params["{}{}_i2h_weight".format(j, i)]
                            .reshape(-1))
                flat.append(params["{}{}_h2h_weight".format(j, i)]
                            .reshape(-1))
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                flat.append(params["{}{}_i2h_bias".format(j, i)])
                flat.append(params["{}{}_h2h_bias".format(j, i)])
        packed = F.concat(*flat, dim=0)
        rnn_args = dict(state_size=self._hidden_size,
                        num_layers=self._num_layers,
                        bidirectional=self._dir == 2, p=self._dropout,
                        state_outputs=True, mode=self._mode)
        if self._mode == "lstm":
            out = F.RNN(inputs, packed, states[0], states[1], **rnn_args)
            outputs, states = out[0], [out[1], out[2]]
        else:
            out = F.RNN(inputs, packed, states[0], **rnn_args)
            outputs, states = out[0], [out[1]]
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, 0, 1)
        if skip_states:
            return outputs
        return outputs, states

    def forward(self, inputs, states=None):
        if states is None:
            return super().forward(inputs)
        return super().forward(inputs, states)


class RNN(_RNNLayer):
    """Elman RNN, tanh or relu (ref: rnn_layer.py:RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """LSTM (ref: rnn_layer.py:LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """GRU (ref: rnn_layer.py:GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
