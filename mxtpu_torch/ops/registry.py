"""Operator registry (counterpart of ``mxtpu/ops/registry.py``).

An op is a tensor-level function; registering it stores an NDArray-level
wrapper beside it, which unwraps NDArrays, runs the function through
``ndarray._apply`` (taped only under ``autograd.record()``) and wraps the
result. The registry builds the ``mx.nd`` namespace and the NDArray
methods, as the reference's frontend codegen does.

Unlike the JAX package's ``register``, the decorator returns the tensor
function unchanged: the op modules stay the tensor-level ``F`` namespace
that the Gluon layers call, and the NDArray-level callable is
``get_op(name).wrapper`` (also ``mx.nd.<name>``).
"""
from __future__ import annotations

import functools
import inspect
from typing import Callable, Dict, List, Optional

__all__ = ["Op", "register", "get_op", "list_ops", "invoke", "REGISTRY",
           "attach_methods", "describe", "NUM_OUTPUT_RULES",
           "register_num_outputs", "PARAM_SHAPE_RULES",
           "register_param_shapes", "get_param_shape_rule"]


class Op:
    """A registered operator: ``fn`` works on tensors, ``wrapper`` on
    NDArrays."""

    __slots__ = ("name", "fn", "wrapper", "aliases", "as_method", "doc",
                 "num_outputs")

    def __init__(self, name: str, fn: Callable, wrapper: Callable,
                 aliases=(), as_method: bool = False, num_outputs: int = 1):
        self.name = name
        self.fn = fn
        self.wrapper = wrapper
        self.aliases = tuple(aliases)
        self.as_method = as_method
        self.doc = fn.__doc__
        self.num_outputs = num_outputs


REGISTRY: Dict[str, Op] = {}


def _ndarray():
    # late: the ndarray package imports the op modules to build mx.nd
    from ..ndarray import ndarray
    return ndarray


def register(name: Optional[str] = None, aliases=(), as_method: bool = False,
             wrap: bool = True, num_outputs: int = 1):
    """Register a tensor-level op under ``name`` and ``aliases``; returns
    the function unchanged. With ``wrap=False`` the function already takes
    and returns NDArrays and is its own wrapper."""

    def deco(fn: Callable):
        op_name = name or fn.__name__
        if wrap:
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                out = kwargs.pop("out", None)
                res = _ndarray()._apply(fn, args, kwargs, name=op_name)
                if out is None:
                    return res
                if isinstance(res, list):
                    outs = out if isinstance(out, (list, tuple)) else [out]
                    for o, r in zip(outs, res):
                        o._set_data(r._data)
                    return out
                out._set_data(res._data)
                return out
        else:
            wrapper = fn
        op = Op(op_name, fn, wrapper, aliases=aliases, as_method=as_method,
                num_outputs=num_outputs)
        REGISTRY[op_name] = op
        for al in aliases:
            REGISTRY[al] = op
        return fn

    return deco


# canonical op name -> fn(attrs) -> number of outputs, for ops whose count
# depends on their attrs (the reference's FNumOutputs); the symbol
# composer reads it so that sym[i] works before execution
NUM_OUTPUT_RULES: Dict[str, Callable] = {}


def register_num_outputs(name: str):
    def deco(fn: Callable):
        NUM_OUTPUT_RULES[name] = fn
        return fn
    return deco


# canonical op name -> fn(input_shapes, attrs) -> {input_index: shape}: the
# backward fill of the reference's FInferShape (fully_connected.cc derives
# weight = (num_hidden, in_units) from the data shape). Given the known
# input shapes (None for unknown), a rule gives the shapes of the op's
# parameter inputs, so Symbol.infer_shape completes symbols whose
# parameters were never declared (BucketingModule on an unseen bucket).
PARAM_SHAPE_RULES: Dict[str, Callable] = {}


def register_param_shapes(name: str):
    """Attach a parameter-shape rule to a registered op."""

    def deco(fn: Callable):
        PARAM_SHAPE_RULES[name] = fn
        return fn

    return deco


def get_param_shape_rule(name: str) -> Optional[Callable]:
    op = REGISTRY.get(name)
    return PARAM_SHAPE_RULES.get(op.name if op is not None else name)


def get_op(name: str) -> Op:
    if name not in REGISTRY:
        raise KeyError("Operator %s is not registered" % name)
    return REGISTRY[name]


def list_ops() -> List[str]:
    return sorted(REGISTRY)


def invoke(name: str, *args, **kwargs):
    """Invoke a registered op by name on NDArrays."""
    return get_op(name).wrapper(*args, **kwargs)


def attach_methods(cls=None):
    """Attach registered ops marked ``as_method`` as NDArray methods (ref:
    python/mxnet/ndarray/register.py), never over a hand-written one."""
    cls = cls or _ndarray().NDArray
    for key, op in list(REGISTRY.items()):
        if not op.as_method or getattr(cls, key, None) is not None:
            continue

        def make(opw):
            def method(self, *args, **kwargs):
                return opw(self, *args, **kwargs)
            return method

        setattr(cls, key, make(op.wrapper))


def describe(name: str) -> dict:
    """Parameter reflection for a registered op (the dmlc::Parameter
    analog): the function's signature is the declaration. Returns
    {"name", "aliases", "doc", "arguments": [...], "attributes":
    [{"name", "default"}...]}."""
    op = get_op(name)
    arguments, attributes = [], []
    for pname, p in inspect.signature(op.fn).parameters.items():
        if p.kind in (inspect.Parameter.VAR_POSITIONAL,
                      inspect.Parameter.VAR_KEYWORD):
            arguments.append({"name": pname, "variadic": True})
        elif p.default is inspect.Parameter.empty:
            arguments.append({"name": pname})
        else:
            attributes.append({"name": pname, "default": p.default})
    return {"name": op.name, "aliases": list(op.aliases), "doc": op.doc,
            "arguments": arguments, "attributes": attributes}
