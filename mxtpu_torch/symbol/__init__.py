"""mx.sym namespace: symbolic op functions generated from the op registry
(counterpart of ``mxtpu/symbol/__init__.py``).

Reference: ``python/mxnet/symbol/register.py`` codegen — every registered op
gets a symbol-level function that composes graph nodes instead of executing.
"""
from __future__ import annotations

from ..base import MXNetError
from ..ops import registry as _reg
from .symbol import (Group, Symbol, Variable, load, load_json, trace_block,
                     var, _ARG, _Node, _Counter, _attr)
from .subgraph import (SubgraphProperty, SubgraphSelector,  # noqa: F401
                       get_subgraph_property, partition,
                       register_subgraph_property)

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "trace_block", "zeros", "ones", "partition",
           "SubgraphProperty", "SubgraphSelector",
           "register_subgraph_property", "get_subgraph_property"]


# Tensor-parameter inputs auto-created as Variables when not supplied —
# reference behavior (python/mxnet/symbol/register.py codegen +
# nnvm ListInputNames): ``sym.Convolution(data, num_filter=k)`` creates
# ``<name>_weight``/``<name>_bias``; output ops create ``<name>_label``
# (which is how the conventional ``softmax_label`` arises).
_AUTO_PARAMS = {
    "Convolution": ("weight", "bias"),
    "Deconvolution": ("weight", "bias"),
    "FullyConnected": ("weight", "bias"),
    "Embedding": ("weight",),
    "BatchNorm": ("gamma", "beta", "moving_mean", "moving_var"),
    "InstanceNorm": ("gamma", "beta"),
    "LayerNorm": ("gamma", "beta"),
    "SoftmaxOutput": ("label",),
    "LinearRegressionOutput": ("label",),
    "LogisticRegressionOutput": ("label",),
    "MAERegressionOutput": ("label",),
    "SVMOutput": ("label",),
}
_PARAM_ORDER_CACHE = {}  # op name -> positional parameter order of op.fn


def _symbolic_call(op_name, *args, name=None, **kwargs):
    """Build a graph node for a registered op (the symbolic twin of
    ndarray._apply)."""
    op = _reg.get_op(op_name)
    in_edges = []
    pos_template = []
    for a in args:
        if isinstance(a, Symbol):
            if len(a._heads) != 1:
                raise MXNetError(
                    "op %s cannot take a multi-output symbol; slice it first"
                    % op_name)
            node, idx = a._heads[0]
            in_edges.append((node, 0 if idx is None else idx))
            pos_template.append(_ARG)
        else:
            pos_template.append(_attr(a))
    kw_arrays = []
    attrs = {}
    for k, v in kwargs.items():
        if isinstance(v, Symbol):
            node, idx = v._heads[0]
            in_edges.append((node, 0 if idx is None else idx))
            kw_arrays.append(k)
        else:
            attrs[k] = _attr(v)
    from ..attribute import current_attrs
    from ..name import current as _current_nm
    nm = _current_nm()
    hint = op.name.lower().lstrip("_")
    if nm is not None:
        name = nm.get(name, hint)
    elif name is None:
        name = "%s%d" % (hint, _Counter.next(op.name.lower()))
    scope_attrs = current_attrs()
    if scope_attrs:
        # scope attrs are defaults; explicit kwargs-derived attrs win
        merged = dict(scope_attrs)
        merged.update(attrs)
        attrs = merged
    auto = _AUTO_PARAMS.get(op.name)
    if auto:
        fn_params = _PARAM_ORDER_CACHE.get(op.name)
        if fn_params is None:
            import inspect as _inspect
            fn_params = list(_inspect.signature(op.fn).parameters)
            _PARAM_ORDER_CACHE[op.name] = fn_params
        supplied = set(fn_params[:len(args)]) | set(kwargs)
        for pname in auto:
            if pname in supplied:
                continue
            if pname == "bias" and attrs.get("no_bias"):
                continue
            vname = (name + "_label" if pname == "label"
                     else "%s_%s" % (name, pname))
            vnode, _ = var(vname)._heads[0]
            in_edges.append((vnode, 0))
            kw_arrays.append(pname)
    # static output count, so sym[i] works BEFORE execution (nnvm knows
    # this statically via FNumOutputs; here: the registry count, overridden
    # by a num_outputs attr for split-style ops)
    rule = _reg.NUM_OUTPUT_RULES.get(op.name)
    n_out = int(rule(attrs) if rule is not None
                else attrs.get("num_outputs", op.num_outputs))
    node = _Node(op.name, name, attrs, in_edges, pos_template, kw_arrays,
                 num_outputs=n_out)
    return Symbol([(node, None)])


def _make_sym_fn(op_name):
    def sym_fn(*args, **kwargs):
        return _symbolic_call(op_name, *args, **kwargs)
    sym_fn.__name__ = op_name
    sym_fn.__doc__ = "Symbolic %s (composes a graph node; see mx.nd.%s)" % (
        op_name, op_name)
    return sym_fn


# generate the namespace (ref: symbol/register.py:143 codegen at import)
for _name in _reg.list_ops():
    if _name not in globals():
        globals()[_name] = _make_sym_fn(_name)
del _name

def __getattr__(name):
    """Ops registered AFTER import (CustomOp, contrib.external_kernel)
    resolve lazily from the registry — the reference regenerates its
    namespace on registration callbacks; a module __getattr__ is the
    python-native equivalent."""
    if name in _reg.REGISTRY:
        fn = _make_sym_fn(name)
        globals()[name] = fn
        return fn
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))


# mx.sym.contrib.* — symbolic twin of mx.nd.contrib (ref: symbol/contrib.py)
import sys as _sys  # noqa: E402
import types as _types  # noqa: E402

contrib = _types.ModuleType(__name__ + ".contrib")
for _name in _reg.list_ops():
    if _name.startswith("_contrib_"):
        setattr(contrib, _name[len("_contrib_"):], _make_sym_fn(_name))
_sys.modules[contrib.__name__] = contrib
del _name


def _contrib_getattr(name):
    # late-registered contrib ops (PEP 562 on the synthetic module)
    full = "_contrib_" + name
    if full in _reg.REGISTRY:
        fn = _make_sym_fn(full)
        setattr(contrib, name, fn)
        return fn
    raise AttributeError("module %r has no attribute %r"
                         % (contrib.__name__, name))


contrib.__getattr__ = _contrib_getattr


def _prefixed_sym_module(mod_name, prefix):
    """Synthetic mx.sym.<mod_name> exposing registry ops whose names start
    with ``prefix``, unprefixed — the reference's gen_linalg/gen_image
    codegen modules (python/mxnet/symbol/linalg.py etc.)."""
    m = _types.ModuleType(__name__ + "." + mod_name)
    for nm in _reg.list_ops():
        if nm.startswith(prefix):
            setattr(m, nm[len(prefix):], _make_sym_fn(nm))

    def _getattr(name, _p=prefix, _m=m):
        if _p + name in _reg.REGISTRY:
            fn = _make_sym_fn(_p + name)
            setattr(_m, name, fn)
            return fn
        raise AttributeError("module %r has no attribute %r"
                             % (_m.__name__, name))

    m.__getattr__ = _getattr
    _sys.modules[m.__name__] = m
    return m


linalg = _prefixed_sym_module("linalg", "linalg_")
image = _prefixed_sym_module("image", "_image_")

# mx.sym.random — symbolic sampling twins (ref: python/mxnet/symbol/
# random.py). Conventions mirror mx.nd.random: exponential takes
# mean=scale (the registry op is rate-parameterized).
random = _types.ModuleType(__name__ + ".random")
for _rn in ("uniform", "normal", "poisson", "negative_binomial",
            "generalized_negative_binomial", "multinomial", "randint",
            "shuffle"):
    setattr(random, _rn, _make_sym_fn(_rn))
random.gamma = _make_sym_fn("_random_gamma")


def _sym_random_exponential(scale=1.0, **kwargs):
    return _make_sym_fn("exponential")(lam=1.0 / scale, **kwargs)


def _sym_random_randn(*shape, **kwargs):
    # ref: symbol/random.py randn — normal with *shape positional dims
    return _make_sym_fn("normal")(shape=shape or None, **kwargs)


random.exponential = _sym_random_exponential
random.randn = _sym_random_randn
_sys.modules[random.__name__] = random
del _rn

# mx.sym.sparse — symbolic spellings of the sparse-aware op set (ref:
# python/mxnet/symbol/sparse.py re-exports the gen_sparse ops). The graph
# here executes with dense storage (sparse STORAGE lives on NDArray /
# kvstore row_sparse paths); these spellings keep reference code
# composing, with dense-lowered semantics.
sparse = _types.ModuleType(__name__ + ".sparse")
for _sn in ("dot", "add_n", "elemwise_add", "elemwise_sub", "elemwise_mul",
            "elemwise_div", "zeros_like", "ones_like", "where", "Embedding",
            "LinearRegressionOutput", "make_loss", "relu", "sigmoid",
            "square", "sqrt", "abs", "sum", "mean", "broadcast_add",
            "broadcast_sub", "broadcast_mul", "broadcast_div", "clip",
            "negative"):
    if _sn in _reg.REGISTRY:
        setattr(sparse, _sn, _make_sym_fn(_sn))
# sparse retain/cast_storage live on NDArray (RowSparseNDArray.retain,
# .tostype) — no graph-op twin exists, so mx.sym.sparse has no `retain`
_sys.modules[sparse.__name__] = sparse
del _sn
