"""Symbol: the deferred-composition graph (counterpart of
``mxtpu/symbol/symbol.py``; ref: python/mxnet/symbol/symbol.py).

A Symbol is a DAG over the op registry: each node keeps the registered op
name, its static attrs and its input edges. The graph runs on tensors
through each op's tensor function (``Op.fn``), so what a CUDA-graph capture
of it records is the kernels alone. ``infer_shape``/``infer_type`` run the
graph on ``torch.device("meta")`` tensors node by node (nothing is
computed and no kernel is launched), the registry's parameter-shape rules
filling the weights the caller did not give. ``bind``/``simple_bind``
make an ``Executor`` (symbol/executor.py).

The JSON is the reference's own text: the node list with each attr as its
``repr``, ``pos_template``, ``kw_arrays`` and ``json.dumps(indent=2)``;
``load_json`` reads either package's files.

``trace_block`` turns a Gluon block's forward into a Symbol. While it runs
on a thread, ``HybridBlock._forward_eager`` hands ``hybrid_forward`` a
recording ``F`` (each registry function wrapped so that it appends a node
under the op's canonical name, keyed on the ids of the tensors it took and
gave) and a torch function mode records the tensor arithmetic the layers
do outside ``F`` (``x + residual``) under the reference's NDArray names.
``ndarray._apply`` records too, for ``mx.nd`` calls inside a block.
"""
from __future__ import annotations

import ast
import json
import threading

import numpy as _np
import torch
from torch.overrides import TorchFunctionMode

from .. import autograd
from ..base import MXNetError, numpy_dtype, torch_dtype
from ..ndarray import NDArray
from ..ops import registry as _reg

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "trace_block"]

# marker for "an array flows here" inside serialized positional templates
_ARG = "__arg__"

_AUX_SUFFIXES = ("running_mean", "running_var", "moving_mean", "moving_var")


class _Counter:
    """Node-name counters per op (lower case), process-wide, as the
    reference's."""

    _lock = threading.Lock()
    _counts = {}

    @classmethod
    def next(cls, hint):
        with cls._lock:
            c = cls._counts.get(hint, 0)
            cls._counts[hint] = c + 1
            return c


def dtype_name(dtype):
    """The reference's name for a dtype (``'float32'``, ``'bfloat16'``)."""
    if isinstance(dtype, torch.dtype):
        dtype = numpy_dtype(dtype)
        if dtype == torch.bfloat16:
            return "bfloat16"
    return str(_np.dtype(dtype)) if not isinstance(dtype, str) else dtype


def _attr(v):
    """An attr value as the reference's graph holds it: torch dtypes and
    sizes as the numpy-style names and tuples its ``repr`` writes."""
    if isinstance(v, torch.dtype):
        return dtype_name(v)
    if isinstance(v, torch.Size):
        return tuple(v)
    return v


class _Node:
    """One graph node. op None => variable (a free input)."""

    __slots__ = ("op", "name", "attrs", "inputs", "pos_template",
                 "kw_arrays", "num_outputs")

    def __init__(self, op, name, attrs=None, inputs=(), pos_template=None,
                 kw_arrays=(), num_outputs=1):
        self.op = op
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs)          # [(node, out_index)]
        # how to rebuild the positional call: _ARG (an array slot, taken
        # from self.inputs in order) or a literal static value
        self.pos_template = (list(pos_template) if pos_template is not None
                             else [_ARG] * len(self.inputs))
        self.kw_arrays = list(kw_arrays)    # kwarg names that are array slots
        self.num_outputs = num_outputs

    def is_var(self):
        return self.op is None

    def call(self, arrays):
        """(positional args, kwargs) of this node's op for its input
        ``arrays``; dunder attrs (``__ctx_group__``, ``__lr_mult__`` from
        an AttrScope) are graph annotations, not op kwargs."""
        it = iter(arrays)
        pos = [next(it) if a is _ARG else a for a in self.pos_template]
        kwargs = {k: v for k, v in self.attrs.items()
                  if not (k.startswith("__") and k.endswith("__"))}
        for k in self.kw_arrays:
            kwargs[k] = next(it)
        return pos, kwargs


def _topo(heads):
    """Post-order DFS over nodes reachable from heads (stable input order)."""
    seen = {}
    order = []

    def visit(node):
        if id(node) in seen:
            return
        seen[id(node)] = node
        for inp, _ in node.inputs:
            visit(inp)
        order.append(node)

    for node, _ in heads:
        visit(node)
    return order


# ops whose forward draws from the device's generator: a graph that runs
# them registers it, so each replay draws afresh
_DRAWS = ("Dropout", "_rrelu_train", "LeakyReLU", "uniform", "normal",
          "_random_gamma", "exponential", "poisson", "negative_binomial",
          "generalized_negative_binomial", "randint", "multinomial",
          "_sample_unique_zipfian", "shuffle", "uniform_like", "normal_like")


def draws(symbol):
    """Whether a node of ``symbol`` may draw from a random generator."""
    return any(n.op in _DRAWS for n in _topo(symbol._heads))


# ops that make an array from nothing: a node of one gets the device its
# graph runs on (``begin_state``'s zeros in an unrolled RNN, a draw whose
# parameters are numbers)
_CREATION = ("zeros", "ones", "full", "empty", "arange", "linspace", "eye",
             "uniform", "normal", "_random_gamma", "exponential", "poisson",
             "negative_binomial", "generalized_negative_binomial", "randint",
             "_sample_unique_zipfian")
# ops whose output lands on the current context whatever their input's
# device: in a graph, the graph's device
_ON_CONTEXT = ("arange_like", "_contrib_arange_like")


def _on_device(node, kwargs, device):
    if device is not None and kwargs.get("ctx") is None and (
            (not node.inputs and node.op in _CREATION)
            or node.op in _ON_CONTEXT):
        kwargs["ctx"] = device
    return kwargs


def _output_name(node, idx, n):
    return "%s_output%d" % (node.name, idx) if n > 1 \
        else "%s_output" % node.name


class Symbol:
    """A (possibly multi-output) symbolic expression (ref: symbol.py:Symbol)."""

    def __init__(self, heads):
        self._heads = list(heads)  # [(node, out_index)]

    # ------------------------------------------------------------- structure
    @property
    def name(self):
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def __repr__(self):
        names = ", ".join(n.name for n, _ in self._heads)
        return "<Symbol %s>" % names

    def __iter__(self):
        return (self[i] for i in range(len(self.list_outputs())))

    def __getitem__(self, index):
        outs = self._expand_heads()
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("Cannot find output %s" % index)
            index = names.index(index)
        return Symbol([outs[index]])

    def _expand_heads(self):
        outs = []
        for node, idx in self._heads:
            if idx is None and node.num_outputs > 1:
                outs.extend((node, i) for i in range(node.num_outputs))
            else:
                outs.append((node, 0 if idx is None else idx))
        return outs

    def list_outputs(self):
        return [_output_name(node, idx, node.num_outputs)
                for node, idx in self._expand_heads()]

    def list_inputs(self):
        return [n.name for n in _topo(self._heads) if n.is_var()]

    def list_arguments(self):
        return [name for name in self.list_inputs()
                if not name.endswith(_AUX_SUFFIXES)]

    def list_auxiliary_states(self):
        return [name for name in self.list_inputs()
                if name.endswith(_AUX_SUFFIXES)]

    def get_internals(self):
        """All intermediate outputs as a grouped symbol (ref: get_internals)."""
        return Symbol([(n, 0) for n in _topo(self._heads)])

    def attr(self, key):
        if len(self._heads) == 1:
            v = self._heads[0][0].attrs.get(key)
            return None if v is None else str(v)
        return None

    def list_attr(self):
        if len(self._heads) == 1:
            return {k: str(v) for k, v in self._heads[0][0].attrs.items()}
        return {}

    # ------------------------------------------------------------- compose
    def __call__(self, *args, **kwargs):
        """Compose: replace free variables with other symbols
        (ref: symbol.py Symbol.__call__/_compose)."""
        self._compose(*args, **kwargs)
        return self

    def _compose(self, *args, **kwargs):
        if args:
            # positional: substitute variables in list_inputs order
            names = self.list_inputs()
            if len(args) > len(names):
                raise MXNetError("too many positional composition args")
            kwargs = dict(zip(names, args), **kwargs)
        mapping = {}
        for node in _topo(self._heads):
            if node.is_var() and node.name in kwargs:
                repl = kwargs[node.name]
                if not isinstance(repl, Symbol):
                    raise TypeError("compose expects Symbols")
                if len(repl._heads) != 1:
                    raise MXNetError("cannot compose with multi-output symbol")
                mapping[id(node)] = repl._heads[0]
        if not mapping:
            return
        for node in _topo(self._heads):
            node.inputs = [mapping.get(id(inp), (inp, idx))
                           for inp, idx in node.inputs]
        self._heads = [mapping.get(id(n), (n, i)) for n, i in self._heads]

    # ------------------------------------------------------------- execution
    def _execute(self, feed, is_train=False, collect_aux=None,
                 node_hook=None):
        """Run the graph on tensors. feed: name -> tensor. Returns the
        output tensors per head. When ``collect_aux`` is a dict,
        training-mode BatchNorm nodes deposit their new moving mean and
        variance there by variable name (the in-kernel aux write of the
        reference's batch_norm.cc, done functionally); the caller writes
        them. ``node_hook(name, NDArray)`` sees every node output (the
        monitor callback, ref: graph_executor.cc:104). The ops read
        ``autograd.is_training()``: the caller sets it."""
        values = {}  # id(node) -> list of output tensors
        device = next((t.device for t in feed.values()
                       if isinstance(t, torch.Tensor)), None)
        for node in _topo(self._heads):
            if node.is_var():
                if node.name not in feed:
                    raise MXNetError("variable %s is not bound" % node.name)
                values[id(node)] = [feed[node.name]]
                continue
            pos, kwargs = node.call([values[id(inp)][idx]
                                     for inp, idx in node.inputs])
            kwargs = _on_device(node, kwargs, device)
            fn = _reg.get_op(node.op).fn
            if collect_aux is not None and node.op == "BatchNorm" \
                    and is_train and not kwargs.get("use_global_stats"):
                kwargs["output_mean_var"] = True
                out, mean, var = fn(*pos, **kwargs)
                self._bn_stats(node, pos, kwargs, mean, var, collect_aux)
                res = out
            else:
                res = fn(*pos, **kwargs)
            outs = list(res) if isinstance(res, (list, tuple)) else [res]
            node.num_outputs = len(outs)
            values[id(node)] = outs
            if node_hook is not None:
                for i, o in enumerate(outs):
                    node_hook(_output_name(node, i, len(outs)), NDArray(o))
        return [values[id(n)][i] for n, i in self._expand_heads()]

    @staticmethod
    def _bn_stats(node, pos, kwargs, mean, var, collect_aux):
        """The moving statistics' new values, under their variables' names:
        moving_mean/var arrive positionally (a five-input compose) or as
        kw_arrays (a keyword compose, in any order); value and name come
        from the same slot."""
        momentum = float(kwargs.get("momentum", 0.9))
        npos = sum(1 for a in node.pos_template if a is _ARG)

        def slot(kw_name, pos_idx):
            if kw_name in node.kw_arrays:
                return kwargs[kw_name], npos + node.kw_arrays.index(kw_name)
            return pos[pos_idx], pos_idx

        with torch.no_grad():
            for kw_name, pos_idx, new in (("moving_mean", 3, mean),
                                          ("moving_var", 4, var)):
                old, i = slot(kw_name, pos_idx)
                collect_aux[node.inputs[i][0].name] = \
                    old * momentum + new.detach() * (1 - momentum)

    def eval(self, ctx=None, **kwargs):
        """Evaluate with NDArray (or tensor) bindings (ref: symbol.py:eval).
        Returns a list of NDArrays."""
        feed = {k: v._data if isinstance(v, NDArray) else v
                for k, v in kwargs.items()}
        with torch.set_grad_enabled(autograd.is_recording()):
            return [NDArray(o) for o in self._execute(feed)]

    # ------------------------------------------------------------ inference
    def infer_shape(self, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes): the graph run on meta
        tensors, parameters completed by the registry's rules (the
        InferShape pass, src/executor/infer_graph_attr_pass.cc)."""
        return self._infer(kwargs, want="shape")

    def infer_type(self, **kwargs):
        """(arg_types, out_types, aux_types) as numpy dtypes
        (``torch.bfloat16`` for bfloat16)."""
        return self._infer(kwargs, want="dtype")

    def _infer(self, hints, want="shape"):
        """Forward propagation of (shape, dtype) specs, node by node on meta
        tensors. Unknown parameter inputs (weights, biases, statistics) are
        filled by the op's parameter-shape rule (ops/registry.py
        PARAM_SHAPE_RULES), as each reference op's FInferShape fills its
        unknowns."""
        nodes = _topo(self._heads)
        specs = {}  # var name -> (shape, torch dtype) | None
        for n in nodes:
            if not n.is_var():
                continue
            if want == "dtype" and n.name in hints:
                shape = n.attrs.get("__shape__")
                dtype = hints[n.name]
            else:
                shape = hints.get(n.name, n.attrs.get("__shape__"))
                dtype = n.attrs.get("__dtype__", "float32")
            specs[n.name] = (None if shape is None
                             else (tuple(shape), torch_dtype(dtype)))

        values = {}  # id(node) -> list of specs | None
        for node in nodes:
            if node.is_var():
                values[id(node)] = ([specs[node.name]]
                                    if specs[node.name] is not None else None)
                continue
            in_specs = [values[id(inp)][idx]
                        if values[id(inp)] is not None else None
                        for inp, idx in node.inputs]
            rule = _reg.get_param_shape_rule(node.op)
            if rule is not None and any(s is None for s in in_specs):
                filled = rule([None if s is None else s[0]
                               for s in in_specs], node.attrs)
                for i, shape in (filled or {}).items():
                    inp, _ = node.inputs[i]
                    if inp.is_var() and specs.get(inp.name) is None \
                            and shape is not None:
                        spec = (tuple(shape), torch_dtype(
                            inp.attrs.get("__dtype__", "float32")))
                        specs[inp.name] = spec
                        values[id(inp)] = [spec]
                        in_specs[i] = spec
            if any(s is None for s in in_specs):
                values[id(node)] = None
                continue
            values[id(node)] = self._abstract_node(node, in_specs)

        if want == "shape":
            def get(s):
                return None if s is None else s[0]
        else:
            def get(s):
                return None if s is None else numpy_dtype(s[1])
        outs = []
        for n, i in self._expand_heads():
            v = values[id(n)]
            outs.append(None if v is None else get(v[i]))
        return ([get(specs[n]) for n in self.list_arguments()], outs,
                [get(specs[n]) for n in self.list_auxiliary_states()])

    @staticmethod
    def _abstract_node(node, in_specs):
        """One node on meta tensors: its outputs' (shape, dtype), nothing
        computed and no kernel launched (each kernel wrapper gives a meta
        tensor for a meta input)."""
        arrays = [torch.empty(shape, dtype=dt, device="meta")
                  for shape, dt in in_specs]
        pos, kwargs = node.call(arrays)
        kwargs = _on_device(node, kwargs, torch.device("meta"))
        prev = autograd.set_training(False)
        try:
            with torch.no_grad():
                res = _reg.get_op(node.op).fn(*pos, **kwargs)
        finally:
            autograd.set_training(prev)
        outs = list(res) if isinstance(res, (list, tuple)) else [res]
        node.num_outputs = len(outs)
        return [(tuple(o.shape), o.dtype) for o in outs]

    # ---------------------------------------------------------------- bind
    def simple_bind(self, ctx=None, grad_req="write", **kwargs):
        from .executor import Executor
        return Executor.simple_bind(self, ctx=ctx, grad_req=grad_req, **kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **_ignored):
        from .executor import Executor
        return Executor(self, ctx=ctx, args=args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states)

    # ------------------------------------------------------------ serialize
    def tojson(self):
        nodes = _topo(self._heads)
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": "null" if n.is_var() else n.op,
                "name": n.name,
                "attrs": {k: repr(v) for k, v in n.attrs.items()},
                "inputs": [[nid[id(inp)], idx, 0] for inp, idx in n.inputs],
                "pos_template": [x if x is _ARG else repr(x)
                                 for x in n.pos_template],
                "kw_arrays": list(n.kw_arrays),
                "num_outputs": n.num_outputs,
            })
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_var()],
            "heads": [[nid[id(n)], 0 if i is None else i, 0]
                      for n, i in self._heads],
            "attrs": {"mxtpu_version": 1},
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # ----------------------------------------------------------- operators
    def __add__(self, other):
        return _binary("broadcast_add", "_plus_scalar", self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return _binary("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _binary("broadcast_sub", "_rminus_scalar", self, other, rev=True)

    def __mul__(self, other):
        return _binary("broadcast_mul", "_mul_scalar", self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return _binary("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _binary("broadcast_div", "_rdiv_scalar", self, other, rev=True)

    def __pow__(self, other):
        return _binary("broadcast_power", "_power_scalar", self, other)

    def __neg__(self):
        return self.__mul__(-1.0)

    def __getattr__(self, name):
        # generated method surface: sym.reshape(...) -> symbolic op
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            _reg.get_op(name)
        except KeyError:
            raise AttributeError(name)
        from . import _symbolic_call
        return lambda *a, **kw: _symbolic_call(name, self, *a, **kw)


def _binary(op_name, scalar_op, lhs, rhs, rev=False):
    # scalar variants are registered as (x, scalar) positional aliases of
    # the broadcast ops (ops/elemwise.py; the _r* variants reversed)
    from . import _symbolic_call
    if isinstance(rhs, Symbol):
        return _symbolic_call(op_name, lhs, rhs)
    try:
        _reg.get_op(scalar_op)
    except KeyError:
        raise MXNetError("scalar op %s not registered" % scalar_op)
    return _symbolic_call(scalar_op, lhs, float(rhs))


def var(name, attr=None, shape=None, dtype=None, init=None, **kwargs):
    """Create a variable symbol (ref: symbol.py:var). Active AttrScope
    attributes (mx.AttrScope) apply as defaults, like the reference."""
    from ..attribute import current_attrs
    attrs = current_attrs()
    attrs.update(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    attrs.update(kwargs)
    return Symbol([(_Node(None, name, attrs), None)])


Variable = var


def Group(symbols):
    heads = []
    for s in symbols:
        heads.extend(s._expand_heads())
    return Symbol(heads)


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        attrs = {k: _literal(v) for k, v in jn.get("attrs", {}).items()}
        op = None if jn["op"] == "null" else jn["op"]
        node = _Node(op, jn["name"], attrs,
                     num_outputs=jn.get("num_outputs", 1))
        node.pos_template = [_ARG if x == _ARG else _literal(x)
                             for x in jn.get("pos_template", [])]
        node.kw_arrays = list(jn.get("kw_arrays", []))
        nodes.append(node)
    for node, jn in zip(nodes, data["nodes"]):
        node.inputs = [(nodes[i], idx) for i, idx, _ in jn.get("inputs", [])]
        if not jn.get("pos_template"):
            node.pos_template = [_ARG] * len(node.inputs)
    heads = [(nodes[i], idx) for i, idx, _ in data["heads"]]
    return Symbol(heads)


def _literal(s):
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# --------------------------------------------------------------- block trace
class _SymTape(threading.local):
    def __init__(self):
        self.active = None   # dict: id(tensor) -> (node, out_idx, tensor)
        self.depth = 0       # > 0 inside a recorded op: nothing records


_SYM_TAPE = _SymTape()


def _hook_ndarray():
    from ..ndarray import ndarray
    ndarray._TRACE = _SYM_TAPE


_hook_ndarray()


def _record(op_name, args, kwargs, outputs):
    """Append one op call to the graph under construction (the analog of
    autograd's RecordOp for graph export). The tape holds every tensor it
    keys, so no id is reused while it is active."""
    tape = _SYM_TAPE.active
    inputs = [a for a in args if isinstance(a, torch.Tensor)] + \
        [v for v in kwargs.values() if isinstance(v, torch.Tensor)]
    in_edges = []
    for x in inputs:
        if id(x) not in tape:
            # unseen tensor entering the graph: promote to a variable
            name = "extra%d" % _Counter.next("extra")
            tape[id(x)] = (_Node(None, name, {}), 0, x)
        in_edges.append(tape[id(x)][:2])
    pos_template = [_ARG if isinstance(a, torch.Tensor) else _attr(a)
                    for a in args]
    kw_arrays = [k for k, v in kwargs.items() if isinstance(v, torch.Tensor)]
    attrs = {k: _attr(v) for k, v in kwargs.items()
             if not isinstance(v, torch.Tensor)}
    name = "%s%d" % (op_name.lower(), _Counter.next(op_name.lower()))
    node = _Node(op_name, name, attrs, in_edges, pos_template, kw_arrays,
                 num_outputs=len(outputs))
    for i, o in enumerate(outputs):
        tape[id(o)] = (node, i, o)


def record_apply(op_name, args, kwargs, outputs):
    """``ndarray._apply``'s hook: an ``mx.nd`` call made while a block is
    traced (on this thread, outside a recorded op) records its node."""
    if _SYM_TAPE.active is None or _SYM_TAPE.depth or not op_name:
        return
    op = _reg.REGISTRY.get(op_name)
    _record(op.name if op is not None else op_name, args, kwargs, outputs)


class _RecordingF:
    """The ``F`` a block's ``hybrid_forward`` gets during a trace: the op
    namespace with each registered function wrapped to record its call."""

    def __init__(self):
        from .. import ops
        self._ops = ops
        self._by_fn = {id(op.fn): op for op in _reg.REGISTRY.values()}
        self._cache = {}

    def __getattr__(self, name):
        hit = self._cache.get(name)
        if hit is not None:
            return hit
        fn = getattr(self._ops, name)
        op = self._by_fn.get(id(fn))
        if op is None:
            return fn

        def recorded(*args, **kwargs):
            _SYM_TAPE.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _SYM_TAPE.depth -= 1
            if _SYM_TAPE.depth == 0:
                _record(op.name, args, kwargs,
                        list(out) if isinstance(out, (list, tuple))
                        else [out])
            return out

        self._cache[name] = recorded
        return recorded


_RECORDING_F = [None]


def recording_f():
    if _RECORDING_F[0] is None:
        _RECORDING_F[0] = _RecordingF()
    return _RECORDING_F[0]


# tensor arithmetic a layer does outside F, by the name the reference's
# NDArray operator records (ndarray.py _binop/_rbinop): (name, reversed)
_TENSOR_OPS = {
    torch.Tensor.add: ("broadcast_add", False),      # x + y, 2 + x
    torch.Tensor.sub: ("broadcast_sub", False),
    torch.Tensor.__rsub__: ("broadcast_sub", True),  # 2 - x
    torch.Tensor.mul: ("broadcast_mul", False),      # x * y, 2 * x
    torch.Tensor.div: ("broadcast_div", False),
    torch.Tensor.__rdiv__: ("broadcast_div", True),  # 2 / x
    torch.Tensor.neg: ("negative", False),
}


class _TraceMode(TorchFunctionMode):
    """Records the tensor operators of ``_TENSOR_OPS`` applied to traced
    tensors outside a recorded op."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        hit = _TENSOR_OPS.get(func)
        tape = _SYM_TAPE.active
        if hit is not None and tape is not None and not _SYM_TAPE.depth \
                and any(isinstance(a, torch.Tensor) and id(a) in tape
                        for a in args):
            name, rev = hit
            _record(name, tuple(args[::-1]) if rev else tuple(args), {},
                    [out])
        return out


def trace_block(block, *example_inputs):
    """Trace a HybridBlock's forward into a Symbol (used by Block.export
    and SymbolBlock; ref: gluon exports hybridized CachedOp graphs,
    python/mxnet/gluon/block.py:870).

    Traces in inference mode (BatchNorm uses the global statistics and
    Dropout is the identity), as the reference's deploy export, running the
    block eagerly (a hybridized block's graphs are not used). Without
    ``example_inputs`` it takes zeros of the shapes and dtypes of the
    block's last eager call, on its parameters' device. Returns
    ``(symbol, arg_names)``."""
    if not example_inputs:
        specs = getattr(block, "_in_specs", None)
        if not specs:
            raise MXNetError(
                "export/trace requires the block to have run at least once "
                "(or pass example inputs)")
        params = list(block.collect_params().values())
        device = params[0]._tensor().device if params else None
        example_inputs = [torch.zeros(s, dtype=d, device=device)
                          for s, d in specs]
    example_inputs = [x._data if isinstance(x, NDArray) else x
                      for x in example_inputs]

    tape = {}
    for i, x in enumerate(example_inputs):
        name = "data" if i == 0 else "data%d" % i
        tape[id(x)] = (_Node(None, name, {"__shape__": tuple(x.shape),
                                          "__dtype__": dtype_name(x.dtype)}),
                       0, x)
    # parameters become named variables
    for pname, p in block.collect_params().items():
        if p.initialized:
            t = p._tensor()
            tape[id(t)] = (_Node(None, pname, {}), 0, t)

    prev = autograd.set_training(False)
    prev_rec = autograd.set_recording(False)
    _SYM_TAPE.active = tape
    try:
        with torch.no_grad(), _TraceMode():
            out = block(*example_inputs)
    finally:
        _SYM_TAPE.active = None
        autograd.set_recording(prev_rec)
        autograd.set_training(prev)

    outs = out if isinstance(out, (list, tuple)) else [out]
    heads = []
    for o in outs:
        if id(o) not in tape:
            raise MXNetError("block output was not produced by registered ops")
        heads.append(tape[id(o)][:2])
    sym = Symbol(heads)
    return sym, sym.list_arguments()
