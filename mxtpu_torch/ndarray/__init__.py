"""The ``mx.nd`` namespace (counterpart of ``mxtpu/ndarray/__init__.py``):
NDArray and every registered op's NDArray-level wrapper, the ``contrib``
and ``_internal`` sub-namespaces, and ``random``. Ops registered later
(``contrib.external_kernel``) resolve through the module ``__getattr__``s.
"""
import sys as _sys
import types as _types

from .ndarray import NDArray, _apply, array, from_torch, waitall  # noqa: F401
# importing the ops package registers every op module
from ..ops.registry import REGISTRY as _REGISTRY, attach_methods

attach_methods(NDArray)

_this = _sys.modules[__name__]
for _name, _op in _REGISTRY.items():
    if not hasattr(_this, _name):
        setattr(_this, _name, _op.wrapper)

# mx.nd.contrib.*: every `_contrib_X` op as contrib.X (plus its aliases)
contrib = _types.ModuleType(__name__ + ".contrib")
for _name, _op in _REGISTRY.items():
    if _op.name.startswith("_contrib_"):
        short = _name[len("_contrib_"):] if _name.startswith("_contrib_") \
            else _name
        setattr(contrib, short, _op.wrapper)
_sys.modules[contrib.__name__] = contrib

# mx.nd._internal.*: every `_`-prefixed registry name (op or alias)
_internal = _types.ModuleType(__name__ + "._internal")
for _name, _op in _REGISTRY.items():
    if _name.startswith("_"):
        setattr(_internal, _name, _op.wrapper)
_sys.modules[_internal.__name__] = _internal


def _contrib_getattr(name):
    op = _REGISTRY.get("_contrib_" + name) or _REGISTRY.get(name)
    if op is not None and op.name.startswith("_contrib_"):
        setattr(contrib, name, op.wrapper)
        return op.wrapper
    raise AttributeError("module %r has no attribute %r"
                         % (contrib.__name__, name))


def _internal_getattr(name):
    op = _REGISTRY.get(name)
    if op is not None and name.startswith("_"):
        setattr(_internal, name, op.wrapper)
        return op.wrapper
    raise AttributeError("module %r has no attribute %r"
                         % (_internal.__name__, name))


contrib.__getattr__ = _contrib_getattr
_internal.__getattr__ = _internal_getattr

from . import random  # noqa: E402,F401
from . import linalg  # noqa: E402,F401
from . import image  # noqa: E402,F401
from . import sparse  # noqa: E402,F401
from .sparse import CSRNDArray  # noqa: E402,F401
from .utils import load, save  # noqa: E402,F401


def __getattr__(name):
    """Ops registered after import resolve lazily from the registry."""
    op = _REGISTRY.get(name)
    if op is not None:
        setattr(_this, name, op.wrapper)
        return op.wrapper
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


def imdecode(buf, **kwargs):
    """``mx.image.imdecode`` (ref: ndarray/__init__.py:imdecode)."""
    from ..image import imdecode as _imdecode
    return _imdecode(buf, **kwargs)


def concatenate(arrays, axis=0, always_copy=True):
    """Ref: mx.nd.concatenate (concat with an axis keyword)."""
    return _REGISTRY["Concat"].wrapper(*arrays, dim=axis)
