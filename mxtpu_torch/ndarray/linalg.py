"""``mx.nd.linalg`` (counterpart of ``mxtpu/ndarray/linalg.py``): the
``linalg_*`` registry ops without their prefix (``gemm2``, ``potrf``,
``syrk``, ...), generated from the registry as the reference's codegen
does. Ops registered later resolve through the module ``__getattr__``."""
import sys as _sys

from ..ops import registry as _reg

_PREFIX = "linalg_"
_mod = _sys.modules[__name__]
for _name, _op in list(_reg.REGISTRY.items()):
    if _name.startswith(_PREFIX):
        setattr(_mod, _name[len(_PREFIX):], _op.wrapper)
del _name, _op


def __getattr__(name):
    op = _reg.REGISTRY.get(_PREFIX + name)
    if op is not None:
        setattr(_mod, name, op.wrapper)
        return op.wrapper
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
