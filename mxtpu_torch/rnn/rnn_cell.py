"""The symbolic RNN cells of ``mx.rnn`` (counterpart of
``mxtpu/rnn/rnn_cell.py``).

Cells compose Symbol graphs, FullyConnected and activations per step, and
``unroll`` builds the time-unrolled graph in Python; the executor that
binds it captures one graph per bucket on the card. ``FusedRNNCell``
unrolls to the one fused ``RNN`` op over its packed ``<prefix>parameters``
variable, in the reference's layout (``unpack_weights``/``pack_weights``
convert, ``unfuse`` gives the stack of plain cells).

As in the JAX package, ``begin_state`` with no ``func`` needs an explicit
``batch_size`` (zeros of a known shape; the executor binds concrete
arrays) and ``unroll`` needs ``begin_state``. An ``LSTMCell`` adds its
``forget_bias`` to the forget gate's input at every step.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import symbol as sym

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
           "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


class RNNParams(object):
    """Container for holding variables shared between cells
    (ref: rnn_cell.py:RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **_kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.var(name)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract symbolic RNN cell (ref: rnn_cell.py:BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        if hasattr(self, "_cells"):
            for cell in self._cells:
                cell.reset()

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    def begin_state(self, func=None, batch_size=0, **kwargs):
        """Initial states. With no ``func``, concrete zeros of shape
        (batch_size, num_hidden) — ``batch_size`` is REQUIRED then (see
        module docstring); with ``func`` (e.g. ``mx.sym.var``) the shapes
        are the caller's problem, as in the reference."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if func is None:
                if not batch_size:
                    raise MXNetError(
                        "begin_state needs batch_size (no deferred "
                        "whole-graph shape inference in this engine)")
                shape = (batch_size,) + tuple(info["shape"][1:])
                states.append(sym.zeros(shape=shape, name=name))
            else:
                states.append(func(name=name, **kwargs))
        return states

    def unpack_weights(self, args):
        """Unpack fused weights to unfused (ref: BaseRNNCell.unpack_weights);
        plain cells keep per-gate layout already — identity."""
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll for ``length`` steps (ref: BaseRNNCell.unroll). Returns
        (outputs, states); outputs merged along time when
        merge_outputs=True."""
        self.reset()
        inputs, batch_like = _normalize_sequence(length, inputs, layout,
                                                 merge=False)
        if begin_state is None:
            raise MXNetError(
                "unroll needs begin_state (build with cell.begin_state("
                "batch_size=N)); this engine binds concrete state arrays")
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return sym.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Split a merged NTC/TNC symbol into per-step symbols, or merge a
    list back (ref: rnn_cell.py:_normalize_sequence)."""
    assert layout in ("NTC", "TNC"), "unsupported layout %s" % layout
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, (list, tuple)):
        assert len(inputs) == length
        if merge is True:
            stacked = sym.Concat(*[sym.expand_dims(x, axis=axis)
                                   for x in inputs], dim=axis)
            return stacked, axis
        return list(inputs), axis
    # merged symbol in
    if merge is False or merge is None:
        outputs = sym.SliceChannel(inputs, num_outputs=length, axis=in_axis,
                                   squeeze_axis=True)
        return [outputs[i] for i in range(length)], axis
    if in_axis != axis:
        inputs = sym.swapaxes(inputs, dim1=0, dim2=1)
    return inputs, axis


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell: out = act(W_i x + b_i + W_h h + b_h)
    (ref: rnn_cell.py:RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=self._num_hidden,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=self._num_hidden,
                                 name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (ref: rnn_cell.py:LSTMCell; gate order i, f, c, o)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=self._num_hidden * 4,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=self._num_hidden * 4,
                                 name="%sh2h" % name)
        gates = i2h + h2h
        g = sym.SliceChannel(gates, num_outputs=4, name="%sslice" % name)
        in_gate = sym.Activation(g[0], act_type="sigmoid", name="%si" % name)
        # forget_bias folds into the gate pre-activation (the reference
        # bakes it into i2h_bias via init.LSTMBias; numerically identical)
        forget_gate = sym.Activation(g[1] + self._forget_bias,
                                     act_type="sigmoid", name="%sf" % name)
        in_trans = sym.Activation(g[2], act_type="tanh", name="%sc" % name)
        out_gate = sym.Activation(g[3], act_type="sigmoid",
                                  name="%so" % name)
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * sym.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (ref: rnn_cell.py:GRUCell; gate order r, z, o)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev = states[0]
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=self._num_hidden * 3,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(prev, self._hW, self._hB,
                                 num_hidden=self._num_hidden * 3,
                                 name="%sh2h" % name)
        ii = sym.SliceChannel(i2h, num_outputs=3, name="%si2h_slice" % name)
        hh = sym.SliceChannel(h2h, num_outputs=3, name="%sh2h_slice" % name)
        reset = sym.Activation(ii[0] + hh[0], act_type="sigmoid",
                               name="%sr_act" % name)
        update = sym.Activation(ii[1] + hh[1], act_type="sigmoid",
                                name="%sz_act" % name)
        next_h_tmp = sym.Activation(ii[2] + reset * hh[2], act_type="tanh",
                                    name="%sh_act" % name)
        next_h = (1.0 - update) * next_h_tmp + update * prev
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Multi-layer fused cell lowering to the single ``RNN`` op (ref:
    rnn_cell.py:FusedRNNCell over src/operator/rnn.cc; here
    ops/rnn_ops.py). Parameters live in ONE packed '%sparameters'
    variable, same layout as the reference."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._parameter = self.params.get("parameters")
        self._directions = ["l", "r"] if bidirectional else ["l"]

    @property
    def state_info(self):
        b = self._num_layers * (2 if self._bidirectional else 1)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped one t at a time; "
                         "use unroll (ref: rnn_cell.py:641)")

    def begin_state(self, func=None, batch_size=0, **kwargs):
        assert not self._modified
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if func is None:
                if not batch_size:
                    raise MXNetError("begin_state needs batch_size")
                shape = (info["shape"][0], batch_size, info["shape"][2])
                states.append(sym.zeros(shape=shape, name=name))
            else:
                states.append(func(name=name, **kwargs))
        return states

    def _blob_layout(self, total_size):
        """(input_size, dirs) recovered from the packed blob length
        (ref: rnn_cell.py FusedRNNCell infers I the same way)."""
        ng = len(self._gate_names)
        dirs = len(self._directions)
        H, L = self._num_hidden, self._num_layers
        rest = (L - 1) * dirs * ng * H * (H * dirs + H + 2)
        input_size = (total_size - rest) // (dirs * ng * H) - H - 2
        return int(input_size), dirs

    def unpack_weights(self, args):
        """Split the packed '%sparameters' blob into the per-gate unfused
        names unfuse()'s stack binds, on the blob's context (ref:
        FusedRNNCell.unpack_weights; layout rnn-inl.h GetParamSize, see
        ops/rnn_ops._unpack_params)."""
        import numpy as np
        from ..ndarray import array as nd_array
        from ..ops.rnn_ops import _unpack_params

        args = dict(args)
        blob = args.pop(self._prefix + "parameters")
        ctx = getattr(blob, "context", None)
        arr = blob.asnumpy() if hasattr(blob, "asnumpy") else \
            np.asarray(blob)
        input_size, dirs = self._blob_layout(arr.size)
        ws = _unpack_params(arr, self._mode, self._num_layers, input_size,
                            self._num_hidden, dirs == 2)
        for layer in range(self._num_layers):
            for d, dname in enumerate(self._directions):
                w_ih, w_hh, b_ih, b_hh = ws[layer * dirs + d]
                p = "%s%s%d_" % (self._prefix, dname, layer)
                args[p + "i2h_weight"] = nd_array(np.asarray(w_ih), ctx=ctx)
                args[p + "h2h_weight"] = nd_array(np.asarray(w_hh), ctx=ctx)
                args[p + "i2h_bias"] = nd_array(np.asarray(b_ih), ctx=ctx)
                args[p + "h2h_bias"] = nd_array(np.asarray(b_hh), ctx=ctx)
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights: gather unfused names back into the
        packed blob (weights layer/direction-major, then all biases), on
        the first weight's context."""
        import numpy as np
        from ..ndarray import array as nd_array

        args = dict(args)
        parts_w, parts_b = [], []
        ctx = getattr(args.get("%sl0_i2h_weight" % self._prefix), "context",
                      None)
        for layer in range(self._num_layers):
            for dname in self._directions:
                p = "%s%s%d_" % (self._prefix, dname, layer)
                for suffix, dest in (("i2h_weight", parts_w),
                                     ("h2h_weight", parts_w)):
                    a = args.pop(p + suffix)
                    dest.append(np.asarray(
                        a.asnumpy() if hasattr(a, "asnumpy") else a).ravel())
        for layer in range(self._num_layers):
            for dname in self._directions:
                p = "%s%s%d_" % (self._prefix, dname, layer)
                for suffix in ("i2h_bias", "h2h_bias"):
                    a = args.pop(p + suffix)
                    parts_b.append(np.asarray(
                        a.asnumpy() if hasattr(a, "asnumpy") else a).ravel())
        args[self._prefix + "parameters"] = nd_array(
            np.concatenate(parts_w + parts_b), ctx=ctx)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, "TNC", merge=True,
                                        in_layout=layout)
        if begin_state is None:
            raise MXNetError("unroll needs begin_state "
                             "(cell.begin_state(batch_size=N))")
        states = begin_state
        kw = {"state_size": self._num_hidden,
              "num_layers": self._num_layers, "mode": self._mode,
              "bidirectional": self._bidirectional, "p": self._dropout,
              "state_outputs": self._get_next_state}
        if self._mode == "lstm":
            rnn = sym.RNN(inputs, self._parameter, states[0], states[1],
                          name="%srnn" % self._prefix, **kw)
        else:
            rnn = sym.RNN(inputs, self._parameter, states[0],
                          name="%srnn" % self._prefix, **kw)
        if self._get_next_state:
            n_states = 2 if self._mode == "lstm" else 1
            outputs = rnn[0]
            final = [rnn[1 + i] for i in range(n_states)]
        else:
            outputs = rnn
            final = []
        if layout == "NTC":
            outputs = sym.swapaxes(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs, _ = _normalize_sequence(length, outputs, layout, False,
                                             in_layout=layout)
        return outputs, final

    def unfuse(self):
        """Equivalent SequentialRNNCell of unfused cells (ref:
        rnn_cell.py:FusedRNNCell.unfuse)."""
        stack = SequentialRNNCell()
        make = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            # forget_bias 0: the fused blob's biases already carry any
            # initial forget bias (LSTMCell applies forget_bias at
            # runtime, where the reference's LSTMBias initializer puts
            # it into the bias, so a non-zero value here would
            # double-bias weights unpacked from a trained blob)
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p,
                                       forget_bias=0.0),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make("%sl%d_" % (self._prefix, i)),
                    make("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(make("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_"
                                      % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order per step (ref: SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            # share the container both ways (ref: SequentialRNNCell.add)
            assert cell._own_params, \
                "Either specify params for SequentialRNNCell or child " \
                "cells, not both."
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            cell_states = states[p:p + n]
            p += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if begin_state is None:
            raise MXNetError("unroll needs begin_state")
        num_cells = len(self._cells)
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout on the outputs (ref: DropoutCell); stateless."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = sym.Dropout(inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Base for cells that wrap another cell (ref: ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def __call__(self, inputs, states):
        raise NotImplementedError()


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (ref: ZoneoutCell; Krueger et al. 2016):
    each state element keeps its previous value with probability p."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell does not support zoneout; unfuse() first"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return sym.Dropout(sym.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else sym.zeros_like(next_output)
        if self.zoneout_outputs > 0:
            m = mask(self.zoneout_outputs, next_output)
            next_output = sym.where(m, next_output, prev_output)
        if self.zoneout_states > 0:
            next_states = [sym.where(mask(self.zoneout_states, ns), ns, s)
                           for ns, s in zip(next_states, states)]
        self.prev_output = next_output
        return next_output, next_states


class ResidualCell(ModifierCell):
    """Adds the input to the output (ref: ResidualCell; He 2015)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=False)
        self.base_cell._modified = True
        ins, _ = _normalize_sequence(length, inputs, layout, False)
        outputs = [o + i for o, i in zip(outputs, ins)]
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cells over the sequence (ref: BidirectionalCell);
    only unrollable — a single step has no backward context."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            raise MXNetError("unroll needs begin_state")
        states = begin_state
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False)
        outputs = [sym.Concat(l_o, r_o, dim=1,
                              name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, l_states + r_states
