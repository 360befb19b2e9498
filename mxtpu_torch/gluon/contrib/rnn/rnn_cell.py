"""Contrib recurrent cells (counterpart of
``mxtpu/gluon/contrib/rnn/rnn_cell.py``): ``VariationalDropoutCell`` and
``LSTMPCell``."""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell, ModifierCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """One dropout mask per unroll for the inputs, the first state and the
    outputs, reused at every step (Gal and Ghahramani; ref:
    contrib/rnn/rnn_cell.py:VariationalDropoutCell). The masks are drawn
    from the port's generator at the first step after ``reset()``."""

    _draws = True

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _initialize_mask(self, F, name, data, p):
        mask = getattr(self, name)
        if mask is None and p:
            mask = F.Dropout(F.ones_like(data), p=p)
            setattr(self, name, mask)
        return mask

    def hybrid_forward(self, F, inputs, states):
        from .... import autograd
        if autograd.is_training():
            if self.drop_inputs:
                mask = self._initialize_mask(F, "drop_inputs_mask", inputs,
                                             self.drop_inputs)
                inputs = inputs * mask
            if self.drop_states:
                mask = self._initialize_mask(F, "drop_states_mask",
                                             states[0], self.drop_states)
                states = [states[0] * mask] + list(states[1:])
        output, states = self.base_cell(inputs, states)
        if autograd.is_training() and self.drop_outputs:
            mask = self._initialize_mask(F, "drop_outputs_mask", output,
                                         self.drop_outputs)
            output = output * mask
        return output, states


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a projection of the hidden state (Sak et al. 2014; ref:
    contrib/rnn/rnn_cell.py:LSTMPCell): the states are the projection r
    and the cell c."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def infer_shape(self, inputs, states):
        self.i2h_weight._shape_resolved(
            (4 * self._hidden_size, inputs.shape[-1]))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        slices = F.SliceChannel(i2h + h2h, num_outputs=4, axis=-1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        hidden = out_gate * F.tanh(next_c)
        next_r = F.FullyConnected(hidden, h2r_weight, None, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]
