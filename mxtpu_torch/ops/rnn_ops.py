"""The fused multi-layer, optionally bidirectional RNN/LSTM/GRU op
(counterpart of ``mxtpu/ops/rnn_ops.py``).

The JAX package runs the recurrence as one ``lax.scan`` per layer and
direction, in no Pallas kernel; here it is a Python loop over time on
tensors, with the same arithmetic:

* the input projection of every step hoisted into one
  ``[T*N, in] x [in, G*H]`` product (``_precompute_xi``), and one
  recurrent product per step;
* the gates of ``_cell_step``: LSTM i, f, g, o; GRU r, z, n with
  ``n = tanh(xn + r * hn)`` and ``b_hh`` inside ``hn``; relu and tanh;
* the reverse direction on flipped time, its outputs flipped back.

Products take the operands' promoted type (``precision_util.promote``):
bfloat16 weights with float32 states run in float32, and bfloat16
products accumulate in float32 (``apply_policy``). Nothing reads a tensor
on the host, so a hybridized block captures the whole loop into one graph;
torch autograd through the loop gives the gradients. The packed parameter
vector is the reference's (rnn-inl.h GetParamSize): every weight, layer-
and direction-major, i2h then h2h, then every bias in the same order.
``p`` (dropout between layers), ``projection_size`` and the
``lstm_state_clip_*`` options are accepted and ignored, as the JAX
package ignores them.
"""
from __future__ import annotations

import torch

from .precision_util import promote
from .registry import register, register_num_outputs, register_param_shapes

__all__ = ["RNN", "rnn_param_size"]


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def _gdot(x, w):
    """``x @ w.T`` in the operands' promoted type (``.to`` is no copy
    where an operand has it already)."""
    dt = promote(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt).t())


def _precompute_xi(xs, w_ih, b_ih):
    """The input projection of all T steps in one product."""
    t, n, f = xs.shape
    xi = _gdot(xs.reshape(t * n, f), w_ih) + b_ih
    return xi.reshape(t, n, -1)


def _cell_step(mode, w_hh, b_hh):
    """``step(carry, xi_t) -> (carry, h_t)`` for one direction of one
    layer, ``xi_t`` the step's precomputed input projection."""
    if mode == "lstm":
        def step(carry, xi):
            h, c = carry
            z = xi + _gdot(h, w_hh) + b_hh
            i, f, g, o = torch.chunk(z, 4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c_new = f * c + i * torch.tanh(g)
            h_new = o * torch.tanh(c_new)
            return (h_new, c_new), h_new
        return step
    if mode == "gru":
        def step(h, xi):
            hh = _gdot(h, w_hh) + b_hh
            xr, xz, xn = torch.chunk(xi, 3, dim=-1)
            hr, hz, hn = torch.chunk(hh, 3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h_new = (1 - z) * n + z * h
            return h_new, h_new
        return step
    act = torch.tanh if mode == "rnn_tanh" else torch.relu

    def step(h, xi):
        h_new = act(xi + _gdot(h, w_hh) + b_hh)
        return h_new, h_new
    return step


def _scan(step, carry, xs):
    """``lax.scan`` over axis 0 of ``xs``: (final carry, stacked outputs)."""
    ys = []
    for t in range(xs.shape[0]):
        carry, y = step(carry, xs[t])
        ys.append(y)
    return carry, torch.stack(ys)


def _unpack_params(params, mode, num_layers, input_size, state_size,
                   bidirectional):
    """``[[W_ih, W_hh, b_ih, b_hh]]`` per layer and direction, views of the
    packed vector (rnn-inl.h GetParamSize)."""
    ng = _gates(mode)
    dirs = 2 if bidirectional else 1
    idx = 0
    weights = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        for _ in range(dirs):
            wi_sz = ng * state_size * in_sz
            wh_sz = ng * state_size * state_size
            w_ih = params[idx:idx + wi_sz].reshape(ng * state_size, in_sz)
            idx += wi_sz
            w_hh = params[idx:idx + wh_sz].reshape(ng * state_size,
                                                   state_size)
            idx += wh_sz
            weights.append([w_ih, w_hh])
    for layer in range(num_layers):
        for d in range(dirs):
            b_sz = ng * state_size
            b_ih = params[idx:idx + b_sz]
            idx += b_sz
            b_hh = params[idx:idx + b_sz]
            idx += b_sz
            weights[layer * dirs + d].extend([b_ih, b_hh])
    return weights


def rnn_param_size(mode, num_layers, input_size, state_size,
                   bidirectional=False):
    """Elements of the packed parameter vector."""
    ng = _gates(mode)
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * ng * state_size * (in_sz + state_size + 2)
    return size


@register_num_outputs("RNN")
def _rnn_num_outputs(attrs):
    """The output, then the final h (and c for LSTM) with
    ``state_outputs`` (ref: rnn.cc FNumOutputs)."""
    if not attrs.get("state_outputs"):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


@register("RNN")
def RNN(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False, **_ig):
    """Fused RNN (ref: rnn.cc). ``data`` (T, N, input_size), TNC;
    ``state`` and ``state_cell`` (layers * directions, N, H). Returns the
    output (T, N, H * directions), and with ``state_outputs`` the list
    [output, final h, (final c)]."""
    input_size = data.shape[2]
    dirs = 2 if bidirectional else 1
    weights = _unpack_params(parameters, mode, int(num_layers), input_size,
                             int(state_size), bidirectional)
    x = data
    h_finals, c_finals = [], []
    for layer in range(int(num_layers)):
        outs = []
        for d in range(dirs):
            k = layer * dirs + d
            w_ih, w_hh, b_ih, b_hh = weights[k]
            xs = x if d == 0 else torch.flip(x, dims=(0,))
            # the loop-invariant W_hh and b_hh cast once to the steps'
            # type, not once a step (bfloat16 weights under a float32
            # state): their gradients sum over the steps in that type
            w_hh = w_hh.to(promote(state[k].dtype, w_hh.dtype))
            b_hh = b_hh.to(promote(w_hh.dtype, b_hh.dtype))
            step = _cell_step(mode, w_hh, b_hh)
            xi = _precompute_xi(xs, w_ih, b_ih)
            if mode == "lstm":
                (h_t, c_t), ys = _scan(step, (state[k], state_cell[k]), xi)
                c_finals.append(c_t)
            else:
                h_t, ys = _scan(step, state[k], xi)
            h_finals.append(h_t)
            outs.append(ys if d == 0 else torch.flip(ys, dims=(0,)))
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
    if state_outputs:
        res = [x, torch.stack(h_finals)]
        if mode == "lstm":
            res.append(torch.stack(c_finals))
        return res
    return x


@register_param_shapes("RNN")
def _rnn_param_shapes(shapes, attrs):
    """parameters = (total,) and state[/state_cell] = (layers * dirs, N,
    H) from the TNC data shape (ref: rnn-inl.h GetParamSize and
    FInferShape)."""
    data = shapes[0]
    if data is None:
        return {}
    _, n, input_size = data
    mode = attrs.get("mode", "lstm")
    state_size = int(attrs["state_size"])
    num_layers = int(attrs.get("num_layers", 1))
    bidirectional = bool(attrs.get("bidirectional", False))
    dirs = 2 if bidirectional else 1
    out = {1: (rnn_param_size(mode, num_layers, input_size, state_size,
                              bidirectional),),
           2: (num_layers * dirs, n, state_size)}
    if len(shapes) > 3 and mode == "lstm":
        out[3] = (num_layers * dirs, n, state_size)
    return out
