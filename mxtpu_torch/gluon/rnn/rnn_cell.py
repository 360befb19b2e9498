"""Recurrent cells (counterpart of ``mxtpu/gluon/rnn/rnn_cell.py``).

A cell is a per-step HybridBlock, ``cell(inputs, states) -> (output,
states)``, on tensors or NDArrays (``states`` a list); ``unroll`` steps it
over time in Python. Inside a hybridized parent the whole unrolled loop is
captured into the parent's graph; a hybridized cell called alone captures
its step, its ``(inputs, states)`` flattened into the key (``CachedOp``).
``unroll`` works on the inputs' kind: NDArrays through ``mx.nd``, tensors
through the tensor ops, and its default begin state is float32 zeros (the
reference's ``nd.zeros``) on the inputs' device.

``unroll(valid_length=)`` zeroes each sample's outputs past its length row
by row, as MXNet's ``where`` does for a one-dimensional condition (the JAX
package's ``jnp.where`` broadcasts that condition over the last axis,
ROADMAP C), and gives each sample's states at its last valid step; a
``BidirectionalCell`` reverses each sample within its length, as MXNet's
does (the JAX package reverses the whole padded sequence).
``DropoutCell`` and ``ZoneoutCell`` draw from the port's generator, which a
capture registers (``_draws``).
"""
from __future__ import annotations

from ...base import MXNetError
from ...ndarray import NDArray
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _ns(x):
    """``mx.nd`` for an NDArray, the tensor ops for a tensor."""
    from ... import ndarray, ops
    return ndarray if isinstance(x, NDArray) else ops


def _device(x):
    return (x._data if isinstance(x, NDArray) else x).device


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """(per-step list or merged array, the time axis, the batch size)
    (ref: rnn_cell.py:_format_sequence)."""
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, (list, tuple)):
        batch_size = inputs[0].shape[
            batch_axis - (1 if batch_axis > axis else 0)] \
            if inputs[0].ndim >= 2 else inputs[0].shape[0]
        if merge:
            return _ns(inputs[0]).stack(*inputs, axis=axis), axis, \
                batch_size
        return list(inputs), axis, batch_size
    batch_size = inputs.shape[batch_axis]
    if merge is False:
        F = _ns(inputs)
        parts = F.SliceChannel(inputs, num_outputs=inputs.shape[axis],
                               axis=axis, squeeze_axis=False)
        if not isinstance(parts, (list, tuple)):
            parts = [parts]
        return [F.squeeze(s, axis=axis) for s in parts], axis, batch_size
    return inputs, axis, batch_size


def _default_begin_state(cell, inputs, batch_size):
    """float32 zeros on the inputs' device, NDArrays for NDArray inputs."""
    from ... import ndarray, ops
    func = ndarray.zeros if isinstance(inputs, NDArray) else ops.zeros
    return cell.begin_state(batch_size=batch_size, func=func,
                            ctx=_device(inputs))


def _valid_mask(F, like, step, valid_length, batch_size):
    """Rows of ``like`` whose sample is longer than ``step``."""
    keep = F.broadcast_lesser(
        F.full((batch_size,), step, ctx=_device(like), dtype="float32"),
        valid_length)
    return F.reshape(keep, shape=(batch_size,) + (1,) * (like.ndim - 1))


class RecurrentCell(HybridBlock):
    """Abstract cell (ref: rnn_cell.py:RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters before a new unroll."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._modules.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: ``func(name=, shape=, **kwargs)`` per state
        (default ``mx.nd.zeros``, float32 on the current context)."""
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly. Call the modifier "
                             "cell instead.")
        if func is None:
            from ... import ndarray
            func = ndarray.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            kw = dict(kwargs)
            if info is not None:
                kw.update(info)
            states.append(func(name="%sbegin_state_%d" % (
                self._prefix, self._init_counter), **kw))
        return states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step over ``length`` steps of ``inputs`` (a merged array with
        time on ``layout``'s T, or a list per step); returns (outputs,
        states), the outputs merged along T when ``merge_outputs``."""
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        if begin_state is None:
            begin_state = _default_begin_state(self, inputs[0], batch_size)
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        F = _ns(inputs[0])
        if valid_length is not None:
            states = [F.SequenceLast(F.stack(*ele_list, axis=0),
                                     sequence_length=valid_length,
                                     use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            outputs = [F.where(_valid_mask(F, o, i, valid_length,
                                           batch_size), o, F.zeros_like(o))
                       for i, o in enumerate(outputs)]
        if merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs)

    def forward(self, inputs, states):
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell):
    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _dense_params(cell, gates, hidden_size, input_size, inits):
    """i2h/h2h weights and biases of a cell with ``gates`` gates."""
    i2h_w, h2h_w, i2h_b, h2h_b = inits
    n = gates * hidden_size
    cell.i2h_weight = cell.params.get("i2h_weight", shape=(n, input_size),
                                      init=i2h_w, allow_deferred_init=True)
    cell.h2h_weight = cell.params.get("h2h_weight",
                                      shape=(n, hidden_size), init=h2h_w,
                                      allow_deferred_init=True)
    cell.i2h_bias = cell.params.get("i2h_bias", shape=(n,), init=i2h_b,
                                    allow_deferred_init=True)
    cell.h2h_bias = cell.params.get("h2h_bias", shape=(n,), init=h2h_b,
                                    allow_deferred_init=True)


class RNNCell(HybridRecurrentCell):
    """Elman cell (ref: rnn_cell.py:RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        _dense_params(self, 1, hidden_size, input_size,
                      (i2h_weight_initializer, h2h_weight_initializer,
                       i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def infer_shape(self, inputs, states):
        self.i2h_weight._shape_resolved((self._hidden_size,
                                         inputs.shape[-1]))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gates i, f, g, o as the fused op packs them (ref:
    rnn_cell.py:LSTMCell)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        _dense_params(self, 4, hidden_size, input_size,
                      (i2h_weight_initializer, h2h_weight_initializer,
                       i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def infer_shape(self, inputs, states):
        self.i2h_weight._shape_resolved((4 * self._hidden_size,
                                         inputs.shape[-1]))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
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
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell, gates r, z, n as the fused op packs them (ref:
    rnn_cell.py:GRUCell)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        _dense_params(self, 3, hidden_size, input_size,
                      (i2h_weight_initializer, h2h_weight_initializer,
                       i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def infer_shape(self, inputs, states):
        self.i2h_weight._shape_resolved((3 * self._hidden_size,
                                         inputs.shape[-1]))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.SliceChannel(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h_n = F.SliceChannel(h2h, num_outputs=3, axis=-1)
        reset_gate = F.sigmoid(i2h_r + h2h_r)
        update_gate = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h_n + reset_gate * h2h_n)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked, each step through all of them (ref:
    rnn_cell.py:SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def _cells(self):
        return list(self._modules.values())

    def state_info(self, batch_size=0):
        return _cells_state_info(self._cells(), batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self._cells(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return self._cells()[i]

    def forward(self, *args):
        raise NotImplementedError

    def hybrid_forward(self, F, *args):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout on the step's input, stateless (ref: DropoutCell)."""

    _draws = True

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """A cell wrapping another and sharing its parameters (ref:
    rnn_cell.py:ModifierCell)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout (ref: rnn_cell.py:ZoneoutCell): each output and state
    element keeps its previous value with probability ``zoneout_*``."""

    _draws = True

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. Apply ZoneoutCell " \
            "to the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = self.base_cell, self.zoneout_outputs, \
            self.zoneout_states
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)
        prev_output = self._prev_output if self._prev_output is not None \
            else F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0.0 else next_output
        new_states = [F.where(mask(p_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0.0 else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The input added to the base cell's output (ref: ResidualCell)."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


def _reverse(F, steps, valid_length):
    """The steps in reverse order; with ``valid_length`` each sample's own
    valid steps reversed in place (MXNet's SequenceReverse)."""
    if valid_length is None:
        return list(reversed(steps))
    rev = F.SequenceReverse(F.stack(*steps, axis=0),
                            sequence_length=valid_length,
                            use_sequence_length=True)
    return [rev[t] for t in range(len(steps))]


class BidirectionalCell(HybridRecurrentCell):
    """Two cells over the sequence, one reversed, outputs concatenated;
    only ``unroll`` runs it (ref: rnn_cell.py:BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._modules.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._modules.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        if begin_state is None:
            begin_state = _default_begin_state(self, inputs[0], batch_size)
        states = begin_state
        l_cell, r_cell = self._modules.values()
        n_l = len(l_cell.state_info(batch_size))
        F = _ns(inputs[0])
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=_reverse(F, inputs, valid_length),
            begin_state=states[n_l:], layout=layout, merge_outputs=False,
            valid_length=valid_length)
        outputs = [F.concat(l_o, r_o, dim=1) for l_o, r_o in
                   zip(l_outputs, _reverse(F, r_outputs, valid_length))]
        if merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, list(l_states) + list(r_states)
