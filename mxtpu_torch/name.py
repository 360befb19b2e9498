"""Name scoping for symbol composition (counterpart of
``mxtpu/name.py``; ref: python/mxnet/name.py).

``NameManager`` auto-names anonymous symbols per op-type counter;
``Prefix`` prepends a fixed prefix — the mechanism behind
``with mx.name.Prefix("stage1_"): ...`` in reference model code. The
active manager is consulted by ``mx.sym`` op calls
(``symbol/__init__.py:_symbolic_call``) when no ``name=`` is given.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    """Thread-local stack of naming scopes (ref: name.py:NameManager)."""

    _state = threading.local()

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        """Return ``name`` if given, else generate ``<hint><n>``."""
        if name:
            return name
        c = self._counter.get(hint, 0)
        self._counter[hint] = c + 1
        return "%s%d" % (hint, c)

    def __enter__(self):
        stack = _stack()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


class Prefix(NameManager):
    """Prepend a prefix to every auto-generated name (ref: name.py:Prefix)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def _stack():
    st = getattr(NameManager._state, "stack", None)
    if st is None:
        st = NameManager._state.stack = []
    return st


def current():
    """The innermost active NameManager, or None (module-global counters
    then name the symbol, preserving pre-scope behavior)."""
    st = _stack()
    return st[-1] if st else None
