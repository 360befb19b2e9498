"""Executor: a Symbol bound to arrays, run forward and backward
(counterpart of ``mxtpu/symbol/executor.py``; ref: include/mxnet/
executor.h:56-152, src/executor/graph_executor.cc).

The arrays of ``arg_dict``, ``aux_dict`` and ``grad_dict`` live on the
executor's device (``ctx``; default the CUDA device, or raise) and are its
static storage: ``forward(**kwargs)``, ``copy_params_from``,
``Module.set_params`` and an optimizer step write into them in place. The
graph runs on tensors through each op's tensor function.

On a CUDA device each (train mode, feed signature) is captured once, the
counterpart of the reference's one jit per (symbol, is_train, feed
signature, policy, device), kept in the executor: a predict-mode forward
is one ``graphs.CapturedGraph``; a training-mode forward replays the
forward of a ``graphs.CapturedPair`` and ``backward`` its backward (the
reference's companion vjp), the gradients then copied into ``grad_dict``
(``grad_req="write"``) or added to it (``"add"``). Training-mode
BatchNorm writes its moving statistics into ``aux_dict`` inside the
forward graph. Before each replay an array whose tensor was replaced since
the capture (an NDArray write such as ``arr[:] = v``) is copied into the
captured storage, which the array then holds again. A capture that fails
raises; nothing falls back to eager.

Bound to a ``parallel.Mesh`` (the reference's ``_place_on_mesh``), the
executor runs on this rank's device. Every rank binds the global shapes
and passes the same global batch; a feed input whose dim 0 divides the
mesh's ``data`` axis is cut to this rank's rows, which the graph runs on
(the parameters stay replicated), the outputs of those rows are
all-gathered back to the global batch, and ``backward`` sums the
parameters' gradients over the data axis (the rows' input gradients are
gathered). A feed whose batch does not divide the axis runs whole on every
rank, with the reference's one warning per (input, shape); where no feed
is cut, nothing is summed.

On the CPU the same forward runs eagerly, with torch autograd as the vjp.
``backward`` differentiates the last forward (its activations), as the
reference's recomputes it: two training forwards before one backward give
the second's gradients. With a monitor callback installed every forward
runs uncaptured, node by node, and the callback sees each node's output
(ref: graph_executor.cc:104).

The captures resolve through the compile service at site ``executor``
(a pair's backward graph keeps its ledger entry at
``executor.backward``): the key is the symbol's JSON digest, the
signature with the pair bit, ``compile_service.forward_policy()``, the
device and this executor's nonce; ``_entries`` is a view over the
service's store.
"""
from __future__ import annotations

import logging
import threading

import torch

from .. import autograd, compile_service, graphs
from ..base import MXNetError, torch_dtype
from ..context import Context, resolve_device
from ..ndarray import NDArray
from .symbol import draws

__all__ = ["Executor"]


def executor_device(ctx):
    """The one device an executor (or a Module) runs on: ``None`` is the
    current context (the CUDA device, or raise); a list or tuple of
    contexts its first (module docstring); a ``parallel.Mesh`` this rank's
    device, the current context; a CUDA device with no card raises."""
    from ..parallel.mesh import Mesh
    if isinstance(ctx, Mesh):
        ctx = None
    if isinstance(ctx, (list, tuple)):
        if not ctx:
            raise MXNetError("an empty context list")
        ctx = ctx[0]
    if ctx is not None and not isinstance(ctx, (Context, str, torch.device)):
        raise MXNetError("context %r is neither a device, a list of "
                         "devices nor a parallel.Mesh" % (ctx,))
    device = resolve_device(ctx)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("executor bound to %s, but no CUDA device is "
                         "available: bind with ctx=mx.cpu()" % device)
    return device


def _zeros(shape, dtype, device):
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=device))


class _Entry:
    """One captured (train mode, feed signature): a CapturedGraph
    (``pair`` None) or a CapturedPair, and the tensors it reads by
    name."""

    def __init__(self, graph, pair, tensors, diff):
        self.graph = graph
        self.pair = pair
        self.tensors = tensors
        self.diff = diff


class Executor:
    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = symbol
        self._ctx = ctx
        self._device = executor_device(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        if isinstance(args, dict):
            missing = [n for n in arg_names if n not in args]
            if missing:
                raise MXNetError("bind: missing arguments %s" % missing)
            self.arg_dict = {n: self._own(args[n]) for n in arg_names}
        else:
            if args is None or len(args) != len(arg_names):
                raise MXNetError("bind needs one array per argument %s"
                                 % arg_names)
            self.arg_dict = {n: self._own(a) for n, a in zip(arg_names, args)}

        if aux_states is None:
            aux_states = {}
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        for n in aux_names:
            if aux_states.get(n) is None:
                raise MXNetError("bind: missing aux state %s" % n)
        self.aux_dict = {n: self._own(aux_states[n]) for n in aux_names}

        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(arg_names, grad_req))
        self._grad_req = grad_req
        if args_grad is None:
            args_grad = {n: _zeros(self.arg_dict[n].shape,
                                   self.arg_dict[n]._data.dtype, self._device)
                         for n in arg_names
                         if grad_req.get(n, "null") != "null"}
        elif not isinstance(args_grad, dict):
            args_grad = dict(zip(arg_names, args_grad))
        self.grad_dict = {n: self._own(g) for n, g in args_grad.items()
                          if g is not None}

        self._arg_names = arg_names
        self._aux_names = aux_names
        self._diff_names = [n for n in arg_names
                            if grad_req.get(n, "null") != "null"]
        self.outputs = []
        self._monitor = None
        self._nonce = nonce = compile_service.release_on_collect(self)
        self._entries = compile_service.SiteTable(
            lambda k: k.nonce == nonce)
        self._fn_tok = None
        self._last = None   # (is_train, entry or None, eager state)
        self._lock = threading.RLock()
        self._draws = draws(symbol)
        # names bound as feed inputs (data, label); set by simple_bind
        self._input_names = set()
        from ..parallel.mesh import Mesh
        self._data_axis = None   # the mesh's data axis, when it splits
        if isinstance(ctx, Mesh) and ctx.shape.get("data", 1) > 1:
            self._data_axis = ctx.axis("data")
        self._rows = {}          # feed name -> this rank's rows (kept)
        self._cut = {}           # feed name -> its rows, this forward
        self._gathered = []      # outputs all-gathered, this forward
        self._replicate_warned = set()

    def _own(self, arr):
        """``arr`` as an NDArray on this executor's device (the same array
        where it is there already)."""
        if not isinstance(arr, NDArray):
            arr = NDArray(arr) if isinstance(arr, torch.Tensor) \
                else NDArray(arr, ctx=self._device)
        if arr._data.device != self._device:
            arr = NDArray(arr._data.to(self._device))
        return arr

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    # ------------------------------------------------------------- factory
    @staticmethod
    def simple_bind(symbol, ctx=None, grad_req="write", type_dict=None,
                    **shapes):
        """Infer shapes from the given input shapes and allocate everything
        on ``ctx`` (ref: MXExecutorSimpleBind, c_api_executor.cc:224)."""
        device = executor_device(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        if arg_shapes is None or any(s is None for s in arg_shapes):
            raise MXNetError("simple_bind: cannot infer all shapes from %s"
                             % shapes)
        type_dict = type_dict or {}
        args = {n: _zeros(s, type_dict.get(n, "float32"), device)
                for n, s in zip(arg_names, arg_shapes)}
        aux = {n: _zeros(s, type_dict.get(n, "float32"), device)
               for n, s in zip(aux_names, aux_shapes)}
        exe = Executor(symbol, ctx=ctx, args=args, grad_req=grad_req,
                       aux_states=aux)
        exe._input_names = set(shapes)
        return exe

    # ------------------------------------------------------------- running
    def _feed_names(self):
        return self._arg_names + self._aux_names

    def _array(self, name):
        arr = self._cut.get(name)
        if arr is not None:
            return arr
        arr = self.arg_dict.get(name)
        return arr if arr is not None else self.aux_dict[name]

    def _cut_feed(self):
        """On a mesh: this rank's rows of each feed input whose dim 0
        divides the data axis, in storage kept across forwards (a
        captured graph reads it); the rest run whole, warned once per
        (input, shape), as the reference warns."""
        data = self._data_axis
        self._cut = {}
        for name in sorted(self._input_names):
            arr = self.arg_dict.get(name)
            if arr is None or not arr.shape:
                continue
            b = arr.shape[0]
            if b % data.size:
                key = (name, tuple(arr.shape))
                if key not in self._replicate_warned:
                    self._replicate_warned.add(key)
                    logging.getLogger(__name__).warning(
                        "Executor on mesh: input %r batch dim %d does not "
                        "divide the 'data' axis (%d devices) — replicating "
                        "it, LOSING data parallelism for this input. Pad "
                        "the batch or resize the mesh.", name, b, data.size)
                continue
            k = b // data.size
            rows = arr._data.narrow(0, data.index * k, k)
            held = self._rows.get(name)
            with torch.no_grad():
                if held is not None and held.shape == rows.shape \
                        and held._data.dtype == rows.dtype:
                    held._data.copy_(rows)
                else:
                    held = self._rows[name] = NDArray(rows.clone())
            self._cut[name] = held

    def _gather_outputs(self, outs):
        """The global batch's outputs: each output whose dim 0 is the cut
        rows' all-gathered over the data axis."""
        from ..parallel.collectives import _gather
        self._gathered = []
        if not self._cut:
            return outs
        k = next(iter(self._cut.values())).shape[0]
        got = []
        for o in outs:
            cut = o.ndim > 0 and o.shape[0] == k
            self._gathered.append(cut)
            got.append(_gather(o.contiguous(), self._data_axis, 0)
                       if cut else o)
        return got

    def forward(self, is_train=False, **kwargs):
        """Run forward; inputs may be given as kwargs, written into the
        bound arrays (ref: Executor::Forward, graph_executor.cc:64)."""
        with self._lock:
            for k, v in kwargs.items():
                if k not in self.arg_dict:
                    raise MXNetError("unknown input %s" % k)
                self._write_input(self.arg_dict[k], v)
            if self._data_axis is not None:
                self._cut_feed()
            if self._monitor is not None or \
                    not graphs.captures(self._device):
                outs = self._run_eager(bool(is_train))
            else:
                outs = self._run_captured(bool(is_train))
            if self._data_axis is not None:
                outs = self._gather_outputs(outs)
            self.outputs = [NDArray(o) for o in outs]
        return self.outputs

    def _write_input(self, arr, v):
        src = v._data if isinstance(v, NDArray) else v
        if not isinstance(src, torch.Tensor):
            src = NDArray(src, ctx=torch.device("cpu"))._data
        dst = arr._data
        with torch.no_grad():
            if tuple(src.shape) == tuple(dst.shape):
                dst.copy_(src)
            else:   # a new signature: new storage, captured anew
                arr._set_data(src.to(device=self._device, dtype=dst.dtype,
                                     copy=True))

    def _signature(self, is_train):
        return (is_train,) + tuple(
            (n, tuple(self._array(n).shape), self._array(n)._data.dtype)
            for n in self._feed_names())

    def _program(self, is_train, tensors):
        """fn(*tensors in feed order) -> outputs: the graph in ``is_train``
        mode, training-mode BatchNorm writing its moving statistics into
        the aux tensors in place (the capture sets the grad mode)."""
        names = self._feed_names()
        sym = self._symbol

        def fn(*xs):
            feed = dict(zip(names, xs))
            aux = {} if is_train else None
            prev = autograd.set_training(is_train)
            try:
                outs = sym._execute(feed, is_train=is_train, collect_aux=aux)
            finally:
                autograd.set_training(prev)
            with torch.no_grad():
                for k, v in (aux or {}).items():
                    tensors[k].copy_(v)
            return outs
        return fn

    def _generators(self):
        if not self._draws:
            return ()
        from .. import random
        return (random.generator(self._device),)

    def _capture(self, key, is_train, with_pair):
        tensors = {n: self._array(n)._data for n in self._feed_names()}
        diff = [n for n in self._diff_names if n in tensors
                and tensors[n].is_floating_point()] if with_pair else []
        statics = [tensors[n].detach().requires_grad_(True) if n in diff
                   else tensors[n] for n in self._feed_names()]
        fn = self._program(is_train, tensors)
        keep = [tensors[n] for n in self._aux_names]
        gens = self._generators()
        if with_pair:
            with graphs.ledger_site("executor"):
                pair = graphs.CapturedPair(fn, statics, [], keep,
                                           generators=gens)
            entry = _Entry(pair.forward, pair, tensors, diff)
        else:
            with torch.no_grad(), graphs.keeping(keep), \
                    graphs.ledger_site("executor"):
                graph = graphs.CapturedGraph(fn, statics, generators=gens)
            entry = _Entry(graph, None, tensors, diff)
        return entry

    def _refresh(self, entry):
        """Put any array replaced since the capture back into the captured
        storage."""
        for n, t in entry.tensors.items():
            arr = self._array(n)
            if arr._data.data_ptr() != t.data_ptr():
                with torch.no_grad():
                    t.copy_(arr._data)
                arr._set_data(t)

    def _entry(self, is_train, with_pair):
        key = self._signature(is_train) + (with_pair,)
        if self._fn_tok is None:
            import hashlib
            self._fn_tok = "executor:" + hashlib.sha256(
                self._symbol.tojson().encode()).hexdigest()[:24]
        skey = compile_service.canonical_key(
            site="executor", fn_id=self._fn_tok, signature=key,
            policy=compile_service.forward_policy(),
            device=compile_service.device_token(self._device),
            nonce=self._nonce)
        hit = compile_service.get(skey)
        if hit is not None:
            self._refresh(hit.fn)
            return hit.fn
        return compile_service.get_or_build(
            skey, lambda: self._capture(key, is_train, with_pair),
            provenance=lambda: {
                "is_train": is_train, "pair": with_pair,
                "inputs": [(n, tuple(self._array(n).shape))
                           for n in sorted(self._input_names)]}).fn

    def _run_captured(self, is_train):
        with_pair = is_train and bool(self._diff_names)
        entry = self._entry(is_train, with_pair)
        if entry.pair is not None:
            outs = entry.pair.forward.replay()
        else:
            outs = entry.graph.replay()
        self._last = (is_train, entry, None)
        return [o.detach().clone() for o in outs]

    def _run_eager(self, is_train):
        names = self._feed_names()
        feed = {n: self._array(n)._data for n in names}
        leaves = {n: feed[n].detach().requires_grad_(True)
                  for n in self._diff_names if feed[n].is_floating_point()}
        feed.update(leaves)
        aux = {} if is_train else None
        prev = autograd.set_training(is_train)
        try:
            with torch.set_grad_enabled(bool(leaves)):
                outs = self._symbol._execute(feed, is_train=is_train,
                                             collect_aux=aux,
                                             node_hook=self._monitor)
        finally:
            autograd.set_training(prev)
        with torch.no_grad():
            for k, v in (aux or {}).items():
                self.aux_dict[k]._data.copy_(v)
        self._last = (is_train, None, (outs, leaves))
        return [o.detach() for o in outs]

    def backward(self, out_grads=None):
        """Gradients of the last forward into grad_dict, honoring grad_req
        write/add (ref: Executor::Backward, graph_executor.cc:77)."""
        if self._last is None:
            raise MXNetError("call forward before backward")
        if not self._diff_names:
            return
        if out_grads is not None and not isinstance(out_grads, (list,
                                                                tuple)):
            out_grads = [out_grads]
        if out_grads is not None and any(self._gathered):
            data = self._data_axis
            out_grads = [g if g is None or not cut else _rows_of(
                _tensor(g), data) for g, cut in zip(out_grads,
                                                     self._gathered)]
        with self._lock:
            is_train, entry, eager = self._last
            if eager is not None:
                outs, leaves = eager
                names = list(leaves)
                grads = self._eager_grads(outs, leaves, out_grads)
            else:
                if entry.pair is None:   # a predict forward: recompute
                    entry = self._entry(is_train, True)
                    entry.pair.forward.replay()
                    self._last = (is_train, entry, None)
                names = entry.diff
                grads = self._replay_backward(entry.pair, out_grads)
            if self._cut:
                grads = self._sum_grads(names, list(grads))
            self._write_grads(names, grads)

    def _sum_grads(self, names, grads):
        """On a mesh with a cut feed: the parameters' gradients summed
        over the data axis (one flat all-reduce a dtype), the cut inputs'
        gathered to the global batch."""
        from ..optimizer_fused import _bucket_all_reduce
        from ..parallel.collectives import _gather
        data = self._data_axis
        params = [k for k, (n, g) in enumerate(zip(names, grads))
                  if g is not None and n not in self._input_names]
        summed = [grads[k].contiguous() for k in params]
        with torch.no_grad():
            _bucket_all_reduce(summed, data)
            for k, g in zip(params, summed):
                grads[k] = g
            for k, n in enumerate(names):
                if n in self._cut and grads[k] is not None:
                    grads[k] = _gather(grads[k].contiguous(), data, 0)
        return grads

    def _eager_grads(self, outs, leaves, out_grads):
        heads, cots = [], []
        for i, o in enumerate(outs):
            if not o.requires_grad:
                continue
            heads.append(o)
            g = None if out_grads is None else out_grads[i]
            cots.append(torch.ones_like(o) if g is None else
                        _tensor(g).to(device=o.device, dtype=o.dtype))
        if not heads:
            return [None] * len(leaves)
        return torch.autograd.grad(heads, list(leaves.values()), cots,
                                   retain_graph=True, allow_unused=True)

    @staticmethod
    def _replay_backward(pair, out_grads):
        with torch.no_grad():
            for static, k in zip(pair.cotangents, pair.diff_outputs):
                g = None if out_grads is None else out_grads[k]
                if g is None:
                    static.fill_(1)
                else:
                    static.copy_(_tensor(g))
        return pair.backward.replay()

    def _write_grads(self, names, grads):
        w_dst, w_src, a_dst, a_src = [], [], [], []
        with torch.no_grad():
            for n, g in zip(names, grads):
                tgt = self.grad_dict.get(n)
                if tgt is None:
                    continue
                add = self._grad_req.get(n) == "add"
                if g is None:
                    if not add:
                        tgt._data.zero_()
                    continue
                g = g.to(tgt._data.dtype)
                if add:
                    a_dst.append(tgt._data)
                    a_src.append(g)
                else:
                    w_dst.append(tgt._data)
                    w_src.append(g)
            if w_dst:
                torch._foreach_copy_(w_dst, w_src)
            if a_dst:
                torch._foreach_add_(a_dst, a_src)

    # --------------------------------------------------------------- misc
    def set_monitor_callback(self, callback, monitor_all=False):
        """``callback(name, NDArray)`` for every node output; forwards then
        run uncaptured, node by node."""
        self._monitor = callback

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Write ``arg_params``/``aux_params`` into the bound arrays in
        place (cast to their dtypes)."""
        for table, params, what in ((self.arg_dict, arg_params, "arguments"),
                                    (self.aux_dict, aux_params or {}, "aux")):
            for k, v in params.items():
                if k in table:
                    with torch.no_grad():
                        table[k]._data.copy_(_tensor(v))
                elif not allow_extra_params:
                    raise MXNetError("Found name \"%s\" not in %s"
                                     % (k, what))

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor for new input shapes (ref: Executor::Reshape),
        sharing every array whose shape is unchanged."""
        arg_shapes, _, _ = self._symbol.infer_shape(**kwargs)
        args = {}
        for n, s in zip(self._arg_names, arg_shapes):
            cur = self.arg_dict[n]
            args[n] = cur if tuple(cur.shape) == tuple(s) else \
                _zeros(s, cur._data.dtype, self._device)
        exe = Executor(self._symbol, ctx=self._ctx, args=args,
                       grad_req=self._grad_req, aux_states=dict(self.aux_dict))
        exe._input_names = set(self._input_names)
        return exe

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))


def _rows_of(t, data):
    k = t.shape[0] // data.size
    return t.narrow(0, data.index * k, k)


def _tensor(v):
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return NDArray(v, ctx=torch.device("cpu"))._data

