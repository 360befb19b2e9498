"""Attribute scoping for symbol composition (counterpart of
``mxtpu/attribute.py``; ref: python/mxnet/attribute.py).

``AttrScope`` attaches attributes to every symbol created inside the scope —
the reference's mechanism for ``__ctx_group__`` model-parallel placement,
``__lr_mult__`` etc.:

    with mx.AttrScope(ctx_group="dev1"):
        net = mx.sym.FullyConnected(net, num_hidden=128)

Scopes nest; inner values win. Consulted by mx.sym op calls
(``symbol/__init__.py``). Keys are stored with the reference's
``__key__`` dunder convention so symbol JSON round-trips match.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]


class AttrScope:
    _state = threading.local()

    def __init__(self, **attrs):
        # own attrs only — merging happens at lookup (current_attrs walks
        # the stack), so a scope object can be reused without leaking the
        # first enclosing scope's attrs into later uses
        self._attrs = {"__%s__" % k if not k.startswith("__") else k: str(v)
                       for k, v in attrs.items()}

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


def _stack():
    st = getattr(AttrScope._state, "stack", None)
    if st is None:
        st = AttrScope._state.stack = []
    return st


def current_attrs():
    """Merged attributes of the active scopes, innermost winning, or {}."""
    merged = {}
    for scope in _stack():
        merged.update(scope._attrs)
    return merged
